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

Term scoring reads the dense tier for a dense-tier term, and otherwise the
quantized impact tier (`ops.scoring.impact_term_scores`) wherever the JAX
package reads it on its accelerator: the pack resolves the term's
`impact_wscale`, the codes are resident and (k1, b) are the defaults;
else exact BM25 from the raw postings. `mark_exact` forces exact BM25 on a
plan tree. PyTorch runs eagerly, so there is no plan cache and block-row
lists are not padded to shape buckets: a term's rows are one contiguous
slice of the postings.

`KnnNode` scores a dense_vector field exactly, or, when the field carries
the ANN index, through the `ann_gather_scan` kernel's candidates (the JAX
package runs the same probe and scan as traced jnp inside its compiled
plan; the port evaluates eagerly, so it calls the kernel at B = 1, once per
shard on a stacked pack). `PinnedScoresNode` carries a knn section's global
top k into a hybrid search; `ExistsNode` is the `exists` query.

The text DSL's nodes: `DisMaxNode` (max of the children plus tie_breaker
times the rest); `PhraseNode`, an exact phrase as a sorted-set intersection
of the terms' position keys (`torch.searchsorted`, rarest term first), its
phrase frequency counted in int32 and scored by BM25 with the summed idf;
`ExpandedTermsNode`, a prefix / wildcard / regexp / fuzzy query expanded
over the field's host dictionary, the union of the expanded postings (a
fuzzy query sums its per-term BM25 lanes per doc in f64, rounded once:
no float atomics, so the card and the CPU give the same bits); and
`KeywordRangeNode`, a range of strings resolved to keyword ordinals. A
match set is only ever written with True, on the lanes that match.
"""

from __future__ import annotations

import itertools
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np
import torch

from ..index.mappings import ip_keys, ip_sort_key
from ..index.pack import BM25_B, BM25_K1, POS_INF, POS_L, ShardPack
from ..ops.kernels import MAX_FUSED_K, scan_topk
from ..ops.scoring import (DEAD_SLOT_PAD, bm25_idf, dense_term_scores, impact_term_scores,
                           segment_sum_f32, term_score_blocks)
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
    # True when per-shard partials merge on the host: agg nodes then emit
    # mergeable forms (bitmaps, sorted arrays) instead of final values
    sharded: bool = False


def _empty(ctx: ExecContext):
    n1 = ctx.num_docs + DEAD_SLOT_PAD
    return (torch.zeros(n1, dtype=torch.float32, device=ctx.device),
            torch.zeros(n1, dtype=torch.bool, device=ctx.device))


def _doc_match(m: torch.Tensor, ctx: ExecContext) -> torch.Tensor:
    """[N] doc mask -> [N+1] match with the dead slot False."""
    match = torch.zeros(ctx.num_docs + DEAD_SLOT_PAD, dtype=torch.bool, device=ctx.device)
    match[: ctx.num_docs] = m
    return match


def id_set_match(ids: np.ndarray, boost: float, ctx: ExecContext):
    """A host id set (docids) -> (scores, match) on the device: the ids
    scattered into an [N+1] bool (only True is written, so the order of the
    writes does not matter), scored at a constant `boost`. The host matchers
    (`intervals`, `nested`, `percolate`) answer through it."""
    match = torch.zeros(ctx.num_docs + DEAD_SLOT_PAD, dtype=torch.bool, device=ctx.device)
    if len(ids):
        match[torch.from_numpy(np.asarray(ids, np.int64)).to(ctx.device)] = True
    return float(np.float32(boost)) * match.to(torch.float32), match


class QueryNode:
    boost: float = 1.0

    def prepare(self, pack: ShardPack) -> Any:
        raise NotImplementedError

    def device_eval(self, dev: dict, params: Any, ctx: ExecContext):
        raise NotImplementedError


@dataclass
class TermNode(QueryNode):
    """Exact term match with BM25 scoring (reference behavior:
    index/query/TermQueryBuilder.java -> Lucene TermQuery). A sparse term
    scores from the impact tier when the pack serves it (its
    `impact_wscale` resolves) and `exact_scores` is off (`mark_exact`)."""

    fld: str
    term: str
    boost: float = 1.0
    exact_scores: bool = False
    # the last prepare's dense-tier membership (a profile tree shows it)
    _dense: bool = False

    def prepare(self, pack):
        start, count, df = pack.term_blocks(self.fld, self.term)
        weight = np.float32(0.0)
        if df > 0:
            doc_count = pack.field_stats.get(self.fld, {}).get("doc_count") or pack.num_docs
            weight = np.float32(self.boost * bm25_idf(doc_count, df))
        dr = pack.dense_row_of(self.fld, self.term)
        self._dense = dr is not None
        if dr is not None:
            return ("dense", dr, float(weight))
        rows = slice(start, start + count)
        if not self.exact_scores:
            isc = pack.impact_wscale(self.fld, self.term)
            if isc is not None:
                # wscale = boost·idf·ubf/qmax in the reference's f32 product
                return ("impact", rows, float(weight), float(np.float32(weight * isc)))
        return ("postings", rows, float(weight))

    def device_eval(self, dev, params, ctx):
        kind, where, weight = params[:3]
        if kind == "dense":
            return dense_term_scores(dev["dense_tfn"][where], weight, ctx.num_docs)
        if kind == "impact" and "impact_codes" in dev and (ctx.k1, ctx.b) == (BM25_K1, BM25_B):
            return impact_term_scores(dev["impact_codes"], dev["post_docids"], where,
                                      params[3], ctx.num_docs)
        # exact BM25 from the raw postings (also the impact plan's escalation:
        # custom k1/b, or a searcher without resident codes)
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
class ExistsNode(QueryNode):
    """The doc has a value in the field (reference behavior:
    index/query/ExistsQueryBuilder.java); constant score = boost. The field
    is looked up in the JAX package's order: docvalues, then vectors, then
    text presence (a text value that analyzes to no token still counts: the
    field was indexed, with length 0). On several shards each shard's slice
    carries its own presence column."""

    fld: str
    boost: float = 1.0

    def prepare(self, pack):
        return float(np.float32(self.boost))

    def device_eval(self, dev, params, ctx):
        m = next((dev[key][self.fld][1] for key in _DV_STORES.values()
                  if self.fld in dev[key]), None)
        for key in ("vec_has", "text_has"):
            if m is None and self.fld in dev[key]:
                m = dev[key][self.fld]
        if m is None:
            return _empty(ctx)
        match = _doc_match(m, ctx)
        return params * match.to(torch.float32), match


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


@dataclass
class PinnedScoresNode(QueryNode):
    """Matches a fixed (shard, docid) -> score set: the engine rewrites each
    knn section of a hybrid search to one of these, holding the section's
    GLOBAL top k (reference behavior: KnnScoreDocQueryBuilder, the ScoreDocs
    of the knn phase joined to the user query). `per_shard[s]` is (ids i32,
    scores f32) of shard s; a ShardPack reads shard 0. Every shard takes the
    width of the widest list; padding ids point at the dead slot, which
    never matches."""

    per_shard: list = dc_field(default_factory=list)

    def prepare(self, pack):
        n = pack.num_docs
        width = max(max((len(ids) for ids, _ in self.per_shard), default=0), 1)
        ids = np.full(width, n, np.int64)
        scs = np.zeros(width, np.float32)
        if self.per_shard:
            sids, sscs = self.per_shard[getattr(pack, "shard_index", 0)]
            ids[: len(sids)] = sids
            scs[: len(sscs)] = sscs
        return ids, scs

    def device_eval(self, dev, params, ctx):
        ids, scs = (torch.from_numpy(a).to(ctx.device) for a in params)
        n1 = ctx.num_docs + DEAD_SLOT_PAD
        scores = torch.zeros(n1, dtype=torch.float32, device=ctx.device)
        scores[ids] = scs
        match = torch.zeros(n1, dtype=torch.bool, device=ctx.device)
        match[ids] = True
        match[ctx.num_docs] = False
        return scores, match


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
    # the stacked pack whose shard 0 planned this request (see prepare)
    _planned_on: Any = dc_field(default=None, repr=False, compare=False)

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
        # on several shards the request is planned once, on shard 0's view:
        # every view reports the stacked vectors and the padded width, so
        # each shard takes the same (nprobe, kcand), and the execution
        # planner sees one decision per request, not one per shard
        stacked = getattr(pack, "stacked", None)
        if stacked is not None and pack.shard_index > 0 and self._planned_on is stacked:
            return qv, float(np.float32(self.boost)), fp
        self._planned_on = stacked
        self._kk = min(self.num_candidates or self.k, max(pack.num_docs, 1))
        self._ann = None
        if vc is not None and vc.ann is not None and not self.force_exact:
            from ..ann.search import default_nprobe

            C, L = int(vc.ann["nlist"]), int(vc.ann["tile"])
            oversample = (self.FILTER_OVERSAMPLE
                          if self.filter_node is not None or self.similarity_threshold is not None
                          else 1)
            nprobe = self.nprobe or default_nprobe(C, L, self._kk * oversample)
            nprobe = max(1, min(int(nprobe), C))
            if not self.nprobe:
                # with planner.knn.target_ms set and the scan's efficiency
                # EMA warm, the largest probe count whose predicted
                # gather-scan wall meets the target replaces the coverage
                # heuristic; an explicit nprobe is always respected
                from ..planner import execution_planner

                nprobe = execution_planner().advise_nprobe(
                    nprobe, C, {"queries": 1, "dims": int(vc.dims), "tile": L,
                                "scan_tier": vc.ann_quant})
            kcand = min(nprobe * L, max(self._kk * oversample, self._kk))
            self._ann = (nprobe, kcand, vc.ann_quant)
            from ..telemetry import profile_event

            profile_event("tier", tier=f"ann_{vc.ann_quant}", queries=1, nprobe=nprobe,
                          kcand=kcand)
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


@dataclass
class KeywordRangeNode(RangeNode):
    """`range` on a keyword field: the string bounds resolve to ordinals of
    the field's sorted dictionary at prepare (reference `dsl.py:616-666`);
    on several shards the view's dictionary is the global one."""

    lo_s: str | None = None
    hi_s: str | None = None
    kind: str = "ord"

    @staticmethod
    def _key(s: str):
        return s

    def _keys(self, col) -> list:
        return col.ord_terms if col is not None and col.ord_terms else []

    def prepare(self, pack):
        keys = self._keys(pack.docvalues.get(self.fld))
        lo_ord, hi_ord = 0, len(keys) - 1
        if self.lo_s is not None:
            k = self._key(str(self.lo_s))
            lo_ord = bisect_left(keys, k) if self.include_lo else bisect_right(keys, k)
        if self.hi_s is not None:
            k = self._key(str(self.hi_s))
            hi_ord = (bisect_right(keys, k) - 1 if self.include_hi
                      else bisect_left(keys, k) - 1)
        return lo_ord, hi_ord, float(np.float32(self.boost))


    def device_eval(self, dev, params, ctx):
        lo, hi, boost = params
        if self.fld not in dev["dv_ord"]:
            return _empty(ctx)
        vals, m = dev["dv_ord"][self.fld]
        match = _doc_match(m & (vals >= lo) & (vals <= hi), ctx)
        return boost * match.to(torch.float32), match


@dataclass
class IpRangeNode(KeywordRangeNode):
    """`range` or a CIDR block on an ip field (reference `dsl.py:_IpRangeNode`;
    behavior: IpFieldMapper -> InetAddressPoint ranges): the dictionary sorts
    by address (`ip_sort_key`), so the bounds bisect the address keys, kept
    on the column once computed."""

    @staticmethod
    def _key(s: str):
        return ip_sort_key(s)

    def _keys(self, col) -> list:
        return ip_keys(col)


@dataclass
class DisMaxNode(QueryNode):
    """Max over the children plus tie_breaker times the sum of the rest
    (reference behavior: index/query/DisMaxQueryBuilder.java)."""

    children: list = dc_field(default_factory=list)
    tie_breaker: float = 0.0
    boost: float = 1.0

    def prepare(self, pack):
        return (tuple(c.prepare(pack) for c in self.children),
                float(np.float32(self.tie_breaker)), float(np.float32(self.boost)))

    def device_eval(self, dev, params, ctx):
        child_params, tie, boost = params
        best, match = _empty(ctx)
        total = torch.zeros_like(best)
        for c, p in zip(self.children, child_params):
            s, m = c.device_eval(dev, p, ctx)
            best = torch.maximum(best, s)
            total = total + s
            match = match | m
        score = boost * (best + tie * (total - best))
        return torch.where(match, score, torch.zeros((), device=ctx.device)), match


MAX_CLAUSE_COUNT = 4096  # reference behavior: indices.query.bool.max_clause_count


@dataclass
class PhraseNode(QueryNode):
    """Exact phrase (reference behavior: MatchPhraseQueryBuilder -> Lucene
    PhraseQuery, slop 0). The rarest term's position keys probe each other
    term's sorted keys by `torch.searchsorted`, shifted by the phrase
    offsets; the survivors count per doc (the phrase frequency, in int32),
    scored by BM25 with the summed idf of the terms."""

    fld: str = ""
    terms: list = dc_field(default_factory=list)  # [(term, relative position)]
    boost: float = 1.0
    slop: int = 0
    # the last prepare found no positions (a profile tree shows it)
    _no_pos: bool = False

    def prepare(self, pack):
        if self.slop != 0:
            raise IllegalArgumentError("[match_phrase] slop > 0 is not supported yet")
        stacked = getattr(pack, "stacked", None)
        pos = stacked.pos_keys if stacked is not None else getattr(pack, "pos_keys", None)
        self._no_pos = pos is None
        if pos is None:
            return None  # no text token indexed anywhere: nothing matches
        doc_count = pack.field_stats.get(self.fld, {}).get("doc_count") or pack.num_docs
        idf_sum = 0.0
        infos = []
        for term, off in self.terms:
            ps, nb, cnt = pack.term_pos_blocks(self.fld, term)
            df = pack.term_blocks(self.fld, term)[2]
            if df > 0:
                idf_sum += bm25_idf(doc_count, df)
            infos.append((ps, nb, cnt, off))
        infos.sort(key=lambda x: x[2])  # rarest term first: the probe set
        rows = tuple(slice(ps, ps + nb) for ps, nb, _c, _o in infos)
        offsets = tuple(int(o) for _s, _n, _c, o in infos)
        return rows, offsets, float(np.float32(self.boost * idf_sum))

    def device_eval(self, dev, params, ctx):
        if params is None:
            return _empty(ctx)
        rows, offsets, weight = params
        n = ctx.num_docs
        pos_keys = dev["pos_keys"]
        probe = pos_keys[rows[0]].reshape(-1)  # sorted, POS_INF padding
        if probe.numel() == 0:
            return _empty(ctx)
        base = probe - offsets[0]
        alive = probe < POS_INF
        for r, off in zip(rows[1:], offsets[1:]):
            table = pos_keys[r].reshape(-1)
            want = base + off
            idx = torch.searchsorted(table, want).clamp_(max=table.numel() - 1)
            alive = alive & (table[idx] == want)
        ids = torch.where(alive, torch.div(base, POS_L, rounding_mode="floor"), n)
        counts = torch.zeros(n + DEAD_SLOT_PAD, dtype=torch.int32, device=ctx.device)
        counts.index_add_(0, ids, alive.to(torch.int32))
        tf = counts[:n].to(torch.float32)
        if self.fld in ctx.has_norms:
            dl = dev["norms"][self.fld]
            denom = tf + ctx.k1 * (1.0 - ctx.b + ctx.b * dl / ctx.avgdl[self.fld])
        else:
            denom = tf + ctx.k1
        hit = tf > 0
        scores = torch.zeros(n + DEAD_SLOT_PAD, dtype=torch.float32, device=ctx.device)
        scores[:n] = torch.where(hit, weight * tf / denom, torch.zeros((), device=ctx.device))
        return scores, _doc_match(hit, ctx)


@dataclass
class ExpandedTermsNode(QueryNode):
    """A multi-term query expanded over the field's host dictionary
    (reference behavior: {Prefix,Wildcard,Regexp,Fuzzy}QueryBuilder ->
    Lucene MultiTermQuery): the dictionary walk runs on the host, the union
    of the expanded terms' postings on the device.

    scored=False (prefix, wildcard, regexp): the constant-score rewrite,
    every matching doc scores `boost`. scored=True (fuzzy): each expanded
    term scores BM25 with its own idf times its multiplier, summed per doc
    (bool-should semantics, as the JAX package). More than MAX_CLAUSE_COUNT
    terms raise; `max_expansions` keeps the terms of highest df. A query
    whose matches share a literal prefix (a prefix, the text before a
    wildcard's or a regexp's first operator, a fuzzy prefix_length) walks
    only the dictionary's run of terms with that prefix, as Lucene
    intersects the query's automaton with the terms dictionary; the
    expansion is the full walk's."""

    kind: str = ""  # prefix | wildcard | regexp | fuzzy
    fld: str = ""
    # term -> False | True | a score multiplier; fuzzy: a `FuzzyMatcher`
    matcher: Any = None
    boost: float = 1.0
    scored: bool = False
    max_expansions: int | None = None
    # every matching term starts with this: the walk covers only that run
    # of the sorted dictionary (the terms the full walk would match)
    literal_prefix: str = ""

    def prepare(self, pack):
        terms = pack.terms_for_field(self.fld)
        lp = self.literal_prefix
        lo, hi = 0, len(terms)
        if lp:
            lo = bisect_left(terms, lp)
            hi = lo
            while hi < len(terms) and terms[hi].startswith(lp):
                hi += 1
        if self.kind == "fuzzy":
            # the run tested at once (`FuzzyMatcher`'s edit table)
            expanded = [(terms[lo + i], 1.0) for i in
                        np.nonzero(self.matcher.match_run(pack, self.fld, lo, hi))[0].tolist()]
        else:
            expanded = []  # (term, multiplier)
            for t in itertools.islice(terms, lo, hi):
                m = self.matcher(t)
                if m:
                    expanded.append((t, 1.0 if m is True else float(m)))
        if self.max_expansions is not None and len(expanded) > self.max_expansions:
            expanded.sort(key=lambda tm: -pack.term_blocks(self.fld, tm[0])[2])
            expanded = expanded[: self.max_expansions]
        if len(expanded) > MAX_CLAUSE_COUNT:
            raise IllegalArgumentError(
                f"[{self.kind}] on [{self.fld}] expands to {len(expanded)} terms, "
                f"more than max_clause_count [{MAX_CLAUSE_COUNT}]")
        doc_count = pack.field_stats.get(self.fld, {}).get("doc_count") or pack.num_docs
        rows, ws = [], []
        for t, mult in expanded:
            s0, nb, df = pack.term_blocks(self.fld, t)
            if nb == 0:
                continue
            rows.extend(range(s0, s0 + nb))
            ws.extend([self.boost * mult * bm25_idf(doc_count, df) if self.scored else 1.0] * nb)
        return (np.asarray(rows, np.int64), np.asarray(ws, np.float32),
                float(np.float32(self.boost)))

    def device_eval(self, dev, params, ctx):
        rows, ws, boost = params
        if len(rows) == 0:
            return _empty(ctx)
        n1 = ctx.num_docs + DEAD_SLOT_PAD
        rows_t = torch.from_numpy(rows).to(ctx.device)
        tfs = dev["post_tfs"][rows_t]
        flat_ids = dev["post_docids"][rows_t].reshape(-1).long()
        match = torch.zeros(n1, dtype=torch.bool, device=ctx.device)
        match[flat_ids[(tfs > 0).reshape(-1)]] = True
        match[ctx.num_docs] = False
        if not self.scored:
            return torch.where(match, boost, 0.0).to(torch.float32), match
        if self.fld in ctx.has_norms:
            dls = dev["post_dls"][rows_t]
            denom = tfs + ctx.k1 * (1.0 - ctx.b + ctx.b * dls / ctx.avgdl[self.fld])
        else:
            denom = tfs + ctx.k1
        lane_scores = torch.from_numpy(ws).to(ctx.device)[:, None] * tfs / denom
        return segment_sum_f32(flat_ids, lane_scores.reshape(-1), n1), match


def mark_exact(node: QueryNode) -> QueryNode:
    """Force exact BM25 scoring on every term of a plan tree (the impact
    tier's escalation for what a quantized score cannot serve: explain,
    scripted similarity, rescore windows). -> the node."""
    if isinstance(node, TermNode):
        node.exact_scores = True
    elif isinstance(node, BoolNode):
        for grp in (node.must, node.filter, node.should, node.must_not):
            for c in grp:
                mark_exact(c)
    elif isinstance(node, DisMaxNode):
        for c in node.children:
            mark_exact(c)
    else:
        for attr in ("inner", "child", "filter_node"):
            c = getattr(node, attr, None)
            if isinstance(c, QueryNode):
                mark_exact(c)
    return node
