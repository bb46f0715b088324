"""The `intervals` query: proximity rules over term positions.

This package's copy of the JAX package's `query/intervals.py` (reference
behavior: index/query/IntervalQueryBuilder.java, Lucene intervals: `match`
ordered or unordered with `max_gaps`, and the `all_of` / `any_of`
combinators). A rule is evaluated on the host at prepare, per candidate
doc, over the positions of the pack's blocked keys (`pos_keys`, docid *
POS_L + position, the arrays the phrase query reads on the device; on
several shards each shard's own), decoded with numpy; the matched docids
feed the device as an id set (`nodes.id_set_match`), so the clause
composes like any other. The score is the constant boost (the reference
scores by the interval's width: the JAX package's simplification).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..index.pack import POS_L
from ..utils.errors import QueryParsingError
from .nodes import QueryNode, id_set_match


def _term_positions(pack, fld: str, term: str) -> tuple[np.ndarray, np.ndarray]:
    """One term's (docids, positions), sorted by (doc, position)."""
    s, nb, npos = pack.term_pos_blocks(fld, term)
    keys = pack.pos_keys
    if nb == 0 or keys is None:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    k = np.asarray(keys[s: s + nb]).reshape(-1)[:npos]
    return k // POS_L, k % POS_L


def _match_windows(pos_lists: list[list[int]], ordered: bool, max_gaps: int) -> bool:
    """Does some choice of one position per term fit a window of at most
    n + max_gaps positions (ordered: in term order)?"""
    n = len(pos_lists)
    if any(not p for p in pos_lists):
        return False
    if n == 1:
        return True
    width_limit = n + max_gaps if max_gaps >= 0 else 1 << 30
    if ordered:
        return any(_ordered_fits(pos_lists, start, width_limit) for start in pos_lists[0])
    # unordered: a sliding window over the merged positions
    events = sorted((p, i) for i, plist in enumerate(pos_lists) for p in plist)
    have: dict[int, int] = {}
    j = 0
    for i in range(len(events)):
        have[events[i][1]] = have.get(events[i][1], 0) + 1
        while events[i][0] - events[j][0] + 1 > width_limit:
            have[events[j][1]] -= 1
            if have[events[j][1]] == 0:
                del have[events[j][1]]
            j += 1
        if len(have) == n:
            return True
    return False


def _ordered_fits(pos_lists, start: int, width_limit: int) -> bool:
    prev = start
    for plist in pos_lists[1:]:
        nxt = next((p for p in plist if p > prev), None)
        if nxt is None:
            return False
        prev = nxt
    return prev - start + 1 <= width_limit


@dataclass
class IntervalsNode(QueryNode):
    fld: str = ""
    rule: dict = dc_field(default_factory=dict)
    mappings: object = None
    boost: float = 1.0

    def _eval_rule(self, pack, rule: dict) -> set[int]:
        (kind, spec), = rule.items()
        if kind == "match":
            ft = self.mappings.fields.get(self.fld)
            text = str(spec.get("query", ""))
            terms = ([t.term for t in ft.get_search_analyzer().analyze(text)] if ft
                     else text.split())
            if not terms:
                return set()
            per_term = [_term_positions(pack, self.fld, t) for t in terms]
            docs = np.unique(per_term[0][0])
            for d, _p in per_term[1:]:
                docs = np.intersect1d(docs, d, assume_unique=False)
            ordered = bool(spec.get("ordered", False))
            max_gaps = int(spec.get("max_gaps", -1))
            spans = [(np.searchsorted(d, docs, "left"), np.searchsorted(d, docs, "right"))
                     for d, _p in per_term]
            out = set()
            for i, doc in enumerate(docs.tolist()):
                lists = [p[lo[i]: hi[i]].tolist()
                         for (_d, p), (lo, hi) in zip(per_term, spans)]
                if _match_windows(lists, ordered, max_gaps):
                    out.add(doc)
            return out
        if kind == "any_of":
            out: set[int] = set()
            for sub in spec.get("intervals", []):
                out |= self._eval_rule(pack, sub)
            return out
        if kind == "all_of":
            subs = spec.get("intervals", [])
            if not subs:
                return set()
            out = self._eval_rule(pack, subs[0])
            for sub in subs[1:]:
                out &= self._eval_rule(pack, sub)
            return out
        raise QueryParsingError(f"unsupported intervals rule [{kind}]")

    def prepare(self, pack):
        real = getattr(pack, "pack", pack)  # a shard view's own positions
        return np.asarray(sorted(self._eval_rule(real, self.rule)), np.int64)

    def device_eval(self, dev, params, ctx):
        return id_set_match(params, self.boost, ctx)


def parse_intervals(body, mappings) -> IntervalsNode:
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError("[intervals] expects {field: {rule}}")
    (fld, spec), = body.items()
    spec = dict(spec)
    boost = float(spec.pop("boost", 1.0))
    if len(spec) != 1:
        raise QueryParsingError("[intervals] expects exactly one rule")
    return IntervalsNode(fld=fld, rule=spec, mappings=mappings, boost=boost)
