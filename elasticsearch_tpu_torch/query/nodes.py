"""Query plan nodes: host-side prepare + device-side evaluation.

The reference compiles its Query DSL into Lucene Query/Weight/Scorer trees
pulled doc-at-a-time (reference: server/.../index/query/
AbstractQueryBuilder.java, BoolQueryBuilder.java). As in the JAX package's
`query/nodes.py`, every node instead evaluates to a pair of dense tensors

    (scores[N+1] float32, match[N+1] bool)

over the whole shard, and boolean composition is elementwise arithmetic.

Protocol:
  prepare(pack)              -> params: host work (term-dict lookups, idf)
  device_eval(dev, params, ctx) -> (scores, match) on ctx.device

Term scoring is exact BM25 from the postings or the dense tier; the JAX
package's quantized impact tier is not ported (it runs what the JAX package
runs with ES_TPU_IMPACT=0). PyTorch runs eagerly, so there is no plan cache
and block-row lists are not padded to shape buckets: a term's rows are one
contiguous slice of the postings.
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np
import torch

from ..index.pack import ShardPack
from ..ops.scoring import DEAD_SLOT_PAD, bm25_idf, dense_term_scores, term_score_blocks

_DV_STORES = {"int": "dv_int", "float": "dv_float", "ord": "dv_ord"}


@dataclass
class ExecContext:
    """Per-pack constants of evaluation. `avgdl` maps each normed field to
    a 0-dim f32 tensor on `device`. k1/b apply to the postings path only;
    dense-tier rows bake the BM25 defaults at pack build."""

    num_docs: int
    avgdl: dict[str, torch.Tensor]
    has_norms: frozenset[str]
    device: torch.device
    k1: float = 1.2
    b: float = 0.75


def _empty(ctx: ExecContext):
    n1 = ctx.num_docs + DEAD_SLOT_PAD
    return (torch.zeros(n1, dtype=torch.float32, device=ctx.device),
            torch.zeros(n1, dtype=torch.bool, device=ctx.device))


def _doc_match(m: torch.Tensor, ctx: ExecContext) -> torch.Tensor:
    """[N] doc mask -> [N+1] match with the dead slot False."""
    match = torch.zeros(ctx.num_docs + DEAD_SLOT_PAD, dtype=torch.bool, device=ctx.device)
    match[: ctx.num_docs] = m
    return match


class QueryNode:
    boost: float = 1.0

    def prepare(self, pack: ShardPack) -> Any:
        raise NotImplementedError

    def device_eval(self, dev: dict, params: Any, ctx: ExecContext):
        raise NotImplementedError


@dataclass
class TermNode(QueryNode):
    """Exact term match with BM25 scoring (reference behavior:
    index/query/TermQueryBuilder.java -> Lucene TermQuery)."""

    fld: str
    term: str
    boost: float = 1.0

    def prepare(self, pack):
        start, count, df = pack.term_blocks(self.fld, self.term)
        weight = 0.0
        if df > 0:
            doc_count = pack.field_stats.get(self.fld, {}).get("doc_count") or pack.num_docs
            weight = float(np.float32(self.boost * bm25_idf(doc_count, df)))
        dr = pack.dense_row_of(self.fld, self.term)
        if dr is not None:
            return ("dense", dr, weight)
        return ("postings", slice(start, start + count), weight)

    def device_eval(self, dev, params, ctx):
        kind, where, weight = params
        if kind == "dense":
            return dense_term_scores(dev["dense_tfn"][where], weight, ctx.num_docs)
        has_norms = self.fld in ctx.has_norms
        return term_score_blocks(
            dev["post_docids"], dev["post_tfs"], dev["post_dls"], where, weight,
            ctx.avgdl[self.fld] if has_norms else None, ctx.num_docs,
            ctx.k1, ctx.b, has_norms=has_norms,
        )


@dataclass
class MatchAllNode(QueryNode):
    boost: float = 1.0

    def prepare(self, pack):
        return float(np.float32(self.boost))

    def device_eval(self, dev, params, ctx):
        n1 = ctx.num_docs + DEAD_SLOT_PAD
        return (torch.full((n1,), params, dtype=torch.float32, device=ctx.device),
                torch.ones(n1, dtype=torch.bool, device=ctx.device))


@dataclass
class MatchNoneNode(QueryNode):
    boost: float = 1.0

    def prepare(self, pack):
        return None

    def device_eval(self, dev, params, ctx):
        return _empty(ctx)


@dataclass
class RangeNode(QueryNode):
    """Range over numeric docvalues; constant score = boost (reference
    behavior: index/query/RangeQueryBuilder.java)."""

    fld: str
    lo: float | int | None
    hi: float | int | None
    include_lo: bool = True
    include_hi: bool = True
    boost: float = 1.0
    kind: str = "int"  # int | float

    def _bound(self, v):
        if v is None:
            return None
        # int columns compare as int64, float columns as f32 (the reference's
        # np.asarray(v, dtype) params)
        return int(v) if self.kind == "int" else float(np.float32(v))

    def prepare(self, pack):
        return (self._bound(self.lo), self._bound(self.hi),
                float(np.float32(self.boost)))

    def device_eval(self, dev, params, ctx):
        lo, hi, boost = params
        store = dev[_DV_STORES[self.kind]]
        if self.fld not in store:
            return _empty(ctx)
        vals, m = store[self.fld]
        if lo is not None:
            m = m & (vals >= lo if self.include_lo else vals > lo)
        if hi is not None:
            m = m & (vals <= hi if self.include_hi else vals < hi)
        match = _doc_match(m, ctx)
        return boost * match.to(torch.float32), match


@dataclass
class TermsNode(QueryNode):
    """`terms` query: the doc matches any of the values; constant score =
    boost (reference behavior: index/query/TermsQueryBuilder.java ->
    Lucene TermInSetQuery under ConstantScore)."""

    fld: str
    values: list
    boost: float = 1.0
    kind: str = "ord"  # ord | int | float

    def prepare(self, pack):
        col = pack.docvalues.get(self.fld)
        if self.kind == "ord":
            terms = col.ord_terms if col is not None else []
            ids = []
            for v in map(str, self.values):
                i = bisect_left(terms, v)
                if i < len(terms) and terms[i] == v:
                    ids.append(i)
            arr = np.asarray(ids, np.int64)
        elif self.kind == "int":
            arr = np.asarray(self.values, np.int64)
        else:
            arr = np.asarray(self.values, np.float32)
        return arr, float(np.float32(self.boost))

    def device_eval(self, dev, params, ctx):
        arr, boost = params
        store = dev[_DV_STORES[self.kind]]
        if self.fld not in store:
            return _empty(ctx)
        vals, has = store[self.fld]
        m = has & torch.isin(vals, torch.from_numpy(arr).to(ctx.device))
        match = _doc_match(m, ctx)
        return boost * match.to(torch.float32), match


@dataclass
class ConstantScoreNode(QueryNode):
    child: QueryNode = None
    boost: float = 1.0

    def prepare(self, pack):
        return self.child.prepare(pack), float(np.float32(self.boost))

    def device_eval(self, dev, params, ctx):
        cp, boost = params
        _, m = self.child.device_eval(dev, cp, ctx)
        return boost * m.to(torch.float32), m


@dataclass
class BoolNode(QueryNode):
    """Boolean composition (reference behavior:
    index/query/BoolQueryBuilder.java — must/filter/should/must_not with
    minimum_should_match; should is optional when must/filter present).
    Scores sum in clause order: must, then should."""

    must: list = dc_field(default_factory=list)
    filter: list = dc_field(default_factory=list)
    should: list = dc_field(default_factory=list)
    must_not: list = dc_field(default_factory=list)
    minimum_should_match: int | None = None
    boost: float = 1.0

    def _msm(self) -> int:
        if self.minimum_should_match is not None:
            return self.minimum_should_match
        if self.should and not (self.must or self.filter):
            return 1
        return 0

    def prepare(self, pack):
        groups = tuple(
            tuple(c.prepare(pack) for c in grp)
            for grp in (self.must, self.filter, self.should, self.must_not)
        )
        return groups, float(np.float32(self.boost))

    def device_eval(self, dev, params, ctx):
        (must_p, filter_p, should_p, not_p), boost = params
        n1 = ctx.num_docs + DEAD_SLOT_PAD
        score = torch.zeros(n1, dtype=torch.float32, device=ctx.device)
        ok = torch.ones(n1, dtype=torch.bool, device=ctx.device)
        for c, p in zip(self.must, must_p):
            s, m = c.device_eval(dev, p, ctx)
            score = score + s
            ok = ok & m
        for c, p in zip(self.filter, filter_p):
            _, m = c.device_eval(dev, p, ctx)
            ok = ok & m
        msm = self._msm()
        if self.should:
            cnt = torch.zeros(n1, dtype=torch.int32, device=ctx.device)
            for c, p in zip(self.should, should_p):
                s, m = c.device_eval(dev, p, ctx)
                score = score + s
                cnt = cnt + m.to(torch.int32)
            if msm > 0:
                ok = ok & (cnt >= msm)
        for c, p in zip(self.must_not, not_p):
            _, m = c.device_eval(dev, p, ctx)
            ok = ok & ~m
        zero = torch.zeros((), dtype=torch.float32, device=ctx.device)
        return torch.where(ok, boost * score, zero), ok
