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

`KnnNode` scores a dense_vector field exactly, or, when the field carries
the ANN index, through the `ann_gather_scan` kernel's candidates (the JAX
package runs the same probe and scan as traced jnp inside its compiled
plan; the port evaluates eagerly, so it calls the kernel at B = 1).
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np
import torch

from ..index.pack import ShardPack
from ..ops.kernels import MAX_FUSED_K, scan_topk
from ..ops.scoring import DEAD_SLOT_PAD, bm25_idf, dense_term_scores, term_score_blocks
from ..utils.errors import IllegalArgumentError

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


def _kth_value(masked: torch.Tensor, ok: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest of `masked` (-inf when fewer than k lanes are ok),
    through the streamed `scan_topk` for k <= MAX_FUSED_K, else a sort."""
    if k <= MAX_FUSED_K:
        return scan_topk(None, masked[None, :], ok, k, count_positive=False)[0][0, k - 1]
    return torch.sort(masked, descending=True)[0][k - 1]


@dataclass
class KnnNode(QueryNode):
    """k-nearest-neighbor retrieval (reference behavior:
    search/vectors/KnnVectorQueryBuilder.java + KnnSearchBuilder.java:
    per-shard top num_candidates, then global k). On a field without the
    ANN index the scan is exact; with it, the probed tiles' candidates are
    rescored in f32. An optional filter applies before neighbor selection
    (ES pre-filtering); with a filter or a similarity threshold the ANN path
    retrieves FILTER_OVERSAMPLE times the candidates, and the engine
    re-prepares with force_exact when the filtered result cannot reach k."""

    fld: str = ""
    qvec: list | None = None
    k: int = 10
    num_candidates: int | None = None
    filter_node: QueryNode | None = None
    boost: float = 1.0
    similarity_threshold: float | None = None
    nprobe: int | None = None  # None: the index setting or the coverage heuristic
    force_exact: bool = False  # the engine's starved-filter escalation
    _sim: str = "cosine"

    FILTER_OVERSAMPLE = 4

    def prepare(self, pack):
        vc = pack.vectors.get(self.fld)
        fp = self.filter_node.prepare(pack) if self.filter_node is not None else None
        qv = np.zeros(vc.dims if vc else 1, np.float32)
        if vc is not None:
            if len(self.qvec) != vc.dims:
                raise IllegalArgumentError(
                    f"knn query vector has {len(self.qvec)} dims, field [{self.fld}] has {vc.dims}")
            qv = np.asarray(self.qvec, np.float32)
            self._sim = vc.similarity
        self._kk = min(self.num_candidates or self.k, max(pack.num_docs, 1))
        self._ann = None
        if vc is not None and vc.ann is not None and not self.force_exact:
            from ..ann.search import default_nprobe

            C, L = int(vc.ann["nlist"]), int(vc.ann["tile"])
            oversample = (self.FILTER_OVERSAMPLE
                          if self.filter_node is not None or self.similarity_threshold is not None
                          else 1)
            # no execution planner in the port: the probe count is the
            # coverage heuristic, which is what the JAX package's planner
            # returns while it has no measurements (a cold planner)
            nprobe = self.nprobe or default_nprobe(C, L, self._kk * oversample)
            nprobe = max(1, min(int(nprobe), C))
            kcand = min(nprobe * L, max(self._kk * oversample, self._kk))
            self._ann = (nprobe, kcand, vc.ann_quant)
        return qv, float(np.float32(self.boost)), fp

    def _score_threshold(self) -> float:
        """ES expresses `similarity` in the raw metric space; convert it to
        the _score space (reference behavior: VectorSimilarityQuery)."""
        t = self.similarity_threshold
        if self._sim in ("cosine", "dot_product"):
            return (1.0 + t) / 2.0
        if self._sim == "l2_norm":
            return 1.0 / (1.0 + t * t)
        if self._sim == "max_inner_product":
            return 1.0 / (1.0 - t) if t < 0 else t + 1.0
        return t

    def device_eval(self, dev, params, ctx):
        from ..ops.vector import knn_scores

        qv, boost, fp = params
        n = ctx.num_docs
        if self.fld not in dev["vec"]:
            return _empty(ctx)
        vecs, has, sq = dev["vec"][self.fld], dev["vec_has"][self.fld], dev["vec_sq"][self.fld]
        q = torch.from_numpy(qv).to(ctx.device)
        if self._ann is not None and self.fld in dev["vec_ann"]:
            # the quantized scan of the probed tiles selects candidates;
            # only they are rescored in f32 and scattered into the row
            from ..ann.kernels import ann_candidates

            nprobe, kcand, tier = self._ann
            cand, sel_v, _ = ann_candidates(dev["vec_ann"][self.fld], q, dev["live"], kcand,
                                            nprobe=nprobe, tier=tier, similarity=self._sim)
            ok_cand = torch.isfinite(sel_v)
            safe = torch.clamp(cand, min=0).long()
            sub = knn_scores(vecs[safe], sq[safe], q, self._sim)
            tgt = torch.where(ok_cand, cand, n).long()
            scores_n1 = torch.zeros(n + DEAD_SLOT_PAD, dtype=torch.float32, device=ctx.device)
            scores_n1[tgt] = torch.where(ok_cand, sub, torch.zeros_like(sub))
            in_cand = torch.zeros(n + DEAD_SLOT_PAD, dtype=torch.bool, device=ctx.device)
            in_cand[tgt] = ok_cand
            scores = scores_n1[:n]
            ok = in_cand[:n] & has & dev["live"]
        else:
            scores = knn_scores(vecs, sq, q, self._sim)
            ok = has & dev["live"]
        if self.filter_node is not None:
            _, fm = self.filter_node.device_eval(dev, fp, ctx)
            ok = ok & fm[:n]
        if self.similarity_threshold is not None:
            ok = ok & (scores >= self._score_threshold())
        neg_inf = torch.full_like(scores, float("-inf"))
        masked = torch.where(ok, scores, neg_inf)
        kth = _kth_value(masked, ok, self._kk)
        match_n = ok & (masked >= kth) & torch.isfinite(masked)
        score = torch.zeros(n + DEAD_SLOT_PAD, dtype=torch.float32, device=ctx.device)
        score[:n] = torch.where(match_n, boost * scores, torch.zeros_like(scores))
        return score, _doc_match(match_n, ctx)
