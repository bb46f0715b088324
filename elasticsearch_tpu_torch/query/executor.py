"""Shard-level query execution over a device-resident pack.

The analog of the reference's per-shard query phase (reference behavior:
search/query/QueryPhase.java — run the searcher, emit the top-k docids and
scores plus the total). One `ShardSearcher` owns the uploaded pack; each
`search` parses and prepares the query on the host, evaluates its
(scores, match) on the device, and selects through
`ops/scoring.top_k_with_total`. One device-to-host copy per request.
`msearch` runs a batch of term disjunctions through the batched arms of
`ops/batched.BatchTermSearcher`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.pack import ShardPack
from ..ops.batched import BatchTermSearcher, pack_outputs, unpack_outputs
from ..ops.scoring import top_k_with_total
from ..utils.torch_env import resolve_device
from .dsl import parse_query
from .nodes import ExecContext, QueryNode


def pack_to_device(pack: ShardPack, device) -> dict:
    """Upload a host ShardPack as a flat dict of tensors, with the leaf
    names of the JAX package's `query/executor.pack_to_device` for the
    ported leaves: postings, norms, text presence, docvalues, live docs,
    the dense tier, the impact codes (kept at their storage dtype) and the
    vector fields (values, presence, squared norms summed on the host as
    there, and the ANN index through `ann.ann_to_device`). Keyword ordinals
    widen to int64, as there."""
    device = torch.device(device)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dev = {
        "post_docids": put(pack.post_docids),
        "post_tfs": put(pack.post_tfs),
        "post_dls": put(pack.post_dls),
        "norms": {f: put(a) for f, a in pack.norms.items()},
        "text_has": {f: put(a) for f, a in pack.text_present.items()},
        "dv_int": {},
        "dv_float": {},
        "dv_ord": {},
        "live": put(pack.live),
        "vec": {},
        "vec_has": {},
        "vec_sq": {},
        "vec_ann": {},
    }
    for f, col in pack.docvalues.items():
        key = {"int": "dv_int", "float": "dv_float", "ord": "dv_ord"}[col.kind]
        vals = col.values if col.kind != "ord" else col.values.astype(np.int64)
        dev[key][f] = (put(vals), put(col.has_value))
    for f, vc in pack.vectors.items():
        dev["vec"][f] = put(vc.values)
        dev["vec_has"][f] = put(vc.has_value)
        dev["vec_sq"][f] = put((vc.values * vc.values).sum(axis=-1).astype(np.float32))
        if vc.ann is not None:
            from ..ann import ann_to_device

            dev["vec_ann"][f] = ann_to_device(vc.ann, dev["vec"][f], device)
    if pack.dense_tfn is not None:
        dev["dense_tfn"] = put(pack.dense_tfn)
    if pack.impact_codes is not None:
        dev["impact_codes"] = put(pack.impact_codes)
    return dev


@dataclass
class ShardResult:
    doc_ids: np.ndarray  # [<=size] int32 local docids
    scores: np.ndarray  # [<=size] float32
    total: int
    max_score: float | None


class ShardSearcher:
    def __init__(self, pack: ShardPack, device=None, mappings=None):
        self.device = resolve_device(device)
        self.pack = pack
        self.mappings = mappings
        self.dev = pack_to_device(pack, self.device)
        self.ctx = ExecContext(
            num_docs=pack.num_docs,
            avgdl={f: torch.tensor(np.float32(pack.avgdl(f)), device=self.device)
                   for f in pack.norms},
            has_norms=frozenset(pack.norms),
            device=self.device,
        )
        self._batched: BatchTermSearcher | None = None

    def batched(self) -> BatchTermSearcher:
        """The BatchTermSearcher over this shard's device pack, made at
        first use (its split-bf16 tier copies live as long as it does)."""
        if self._batched is None:
            self._batched = BatchTermSearcher(self)
        return self._batched

    def msearch(self, fld: str, queries, k: int = 10, **kw):
        """Batched term-disjunction `_msearch` -> (scores [Q, k], docids
        [Q, k], totals [Q], first_pass_exact [Q]) numpy; queries are lists
        of (term, boost) on `fld` (see BatchTermSearcher.msearch for the
        keywords and the totals contract)."""
        return self.batched().msearch(fld, queries, k, **kw)

    def search(self, query: dict | QueryNode | None, size: int = 10,
               from_: int = 0) -> ShardResult:
        state = self.search_many_begin([dict(query=query, size=size, from_=from_)])
        self.search_many_fetch(state)
        return self.search_many_finish(state)[0]

    def search_many_begin(self, requests: list[dict]) -> dict:
        """Plan and launch every request (dicts of query, size, from_)
        without copying anything back: the serving wave's generic lane.
        -> a state whose outputs `search_many_fetch` copies to the host in
        one copy and `search_many_finish` turns into ShardResults."""
        outs = []
        for r in requests:
            node = r["query"]
            if not isinstance(node, QueryNode):
                node = parse_query(node, self.mappings)
            n = self.pack.num_docs
            if n == 0:
                outs.append(None)
                continue
            k = min(max(r["size"] + r["from_"], 1), n)
            scores, match = node.device_eval(self.dev, node.prepare(self.pack), self.ctx)
            top_v, top_i, total = top_k_with_total(scores, match, self.dev["live"], k)
            outs.append((top_v, top_i, total.reshape(1)))
        words, layout = pack_outputs([[o] for o in outs if o is not None])
        return {"requests": requests, "outs": outs, "words": words, "layout": layout,
                "host": None}

    @staticmethod
    def search_many_fetch(state: dict) -> None:
        """The one device-to-host copy of a begun batch (no tensor work)."""
        if state["words"] is not None:
            state["host"] = state["words"].cpu().numpy()

    @staticmethod
    def search_many_finish(state: dict) -> list[ShardResult]:
        host = iter(unpack_outputs(state["host"], state["layout"]))
        out = []
        for r, o in zip(state["requests"], state["outs"]):
            if o is None:
                out.append(ShardResult(np.array([], np.int32), np.array([], np.float32), 0, None))
                continue
            top_scores, top_ids, total = next(host)
            valid = np.isfinite(top_scores)
            max_score = float(top_scores[0]) if valid.any() else None
            size, from_ = r["size"], r["from_"]
            end = max(size + from_, 0)
            out.append(ShardResult(top_ids[valid][from_:end].astype(np.int32),
                                   top_scores[valid][from_:end].astype(np.float32),
                                   int(total[0]), max_score))
        return out
