"""Batched multi-query BM25 execution: the `_msearch` arms.

The counterpart of the JAX package's `ops/batched.py`. A batch of term
disjunctions on one field runs as a few large tensor programs with no
scatter:

  dense tier:  scores[Q, N] = W[Q, V_dense] @ dense_tfn[V_dense, N]
  sparse tail: gather CSR rows -> per-posting partial scores -> sort by
               docid -> run sums (cummax segmented-scan trick) -> explicit
               (docid, score) candidates
  merge:       dense top-k (candidates masked out) ++ candidates -> top-k

Arms, as `BatchTermSearcher.msearch` routes them: the execution planner
(`planner/`, site "batched.msearch") picks one of the batch arms fused,
impact and exact among those that serve (a cold planner takes the first,
the static order), then each shape group of the batch runs:
  - fused:  the whole batch when `FusedTermSearcher.usable` holds (a dense
    tier, 0 < k <= 16, at least 4,096 docs): the `fused_tile_candidates`
    kernel, an f32 rescore of 64 candidates and escalation of flagged
    queries to the exact arm (`ops/fused.py`);
  - impact: the sparse tail from the quantized impact tier through the
    `impact_gather` kernel, then the candidate cut of the fast arm;
  - fast:   the same from the raw postings (the planner's "exact" arm, or a
    group the impact tier cannot serve);
  - tiered: dense-only groups (no sparse term) with k <= KB_TIERED, through
    the `tiered_candidates` kernel and an f32 rescore with a margin test;
  - dense:  dense-only groups with a larger k, through `scan_topk` in
    matmul mode;
  - exact:  `fast=False`, and the escalation target of flagged dense-only
    queries.
Every dense top-k inside an arm is `scan_topk` in streamed mode with
count_positive: exactly `lax.top_k(where(live & s > 0, s, -inf), k)` with
its positive count, ties by docid.

Exactness: every sparse candidate's full score = its run sum + the dense
score gathered at its docid; a doc with only dense contributions is exact
in the matmul; duplicates between the two lists are removed by masking the
dense top-k entries that appear among the candidates. Totals are exact:
|{dense match}| + |{candidates with zero dense score}|, or, after a
candidate cut, a lower bound with the dropped count beside it.

Constraint: all term weights must be > 0 (true for BM25: idf > 0, boost >
0), so "matches" == "score > 0".

Prefix sums are f64 in every arm (the JAX package uses f64 in its exact arm
and f32 in the fast arms): an f32 cumsum over a whole candidate row carries
noise that grows with the prefix and depends on the scan's association,
which differs between the card and the host.

PyTorch runs eagerly: query chunks are not padded to a shape family, and no
device-to-host copy happens inside the chunk or group loops. `msearch`
copies every group's outputs to the host at once, one copy per round.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.pack import BLOCK
from .fused import FusedTermSearcher, rank_topk
from .kernels import (
    EPS_TIERED,
    KB_TIERED,
    MAX_FUSED_K,
    _select_topk,
    impact_gather,
    scan_topk,
    split_bf16,
    tiered_candidates,
)
from .scoring import bm25_idf

NEG_INF = float("-inf")


@dataclass
class BatchPlan:
    """Host-side per-batch inputs (numpy, one row per query)."""

    W: np.ndarray  # [Q, V_dense] f32 dense-tier weights (0 = term unused)
    sparse_rows: np.ndarray  # [Q, Ts, B] int32 CSR block rows (0-padded)
    sparse_weights: np.ndarray  # [Q, Ts] f32
    k: int
    dense_only: bool = False  # no sparse terms anywhere
    # per-query dense (tier row, weight) pairs [Q, Td] (0-padded): the
    # sparse view of W, for the tiered arm's f32 rescore
    dense_rows: np.ndarray | None = None
    dense_w: np.ndarray | None = None
    # impact tier: per-sparse-term dequant weights boost·idf·ubf/qmax
    # [Q, Ts]; None when the pack carries no impact tier
    impact_w: np.ndarray | None = None


def _dense_topk(scores_d: torch.Tensor, live: torch.Tensor, k: int):
    """-> (dv [Q, k], di [Q, k] i32, count [Q] i32): the top k of
    where(live & s > 0, s, -inf) by (score desc, docid asc) and the count
    of its positive lanes. `scan_topk` up to its k; a stable sort above."""
    if k <= MAX_FUSED_K:
        return scan_topk(None, scores_d, live, k, count_positive=True)
    masked = torch.where(live[None, :] & (scores_d > 0), scores_d, NEG_INF)
    dv, di = _select_topk(masked, k)
    return dv, di, (masked > 0).sum(dim=1, dtype=torch.int32)


def bf16_product(W: torch.Tensor, dense_bf16: torch.Tensor) -> torch.Tensor:
    """[Q, V] f32 weights cut to bf16 @ the [V, N] bf16 tier -> [Q, N] f32:
    exact bf16 products summed in f32, with no rounding of the output to
    bf16 (a plain bf16 matmul would round each score to 2^-8 and break the
    cut's proof bound). On the card cuBLAS's bf16 tensor-core product with
    f32 output (`torch.mm(..., out_dtype=torch.float32)`); on the CPU,
    which has no kernel for it, the operands widened to f32."""
    Wb = W.to(torch.bfloat16)
    if W.device.type == "cuda":
        return torch.mm(Wb, dense_bf16, out_dtype=torch.float32)
    return torch.matmul(Wb.float(), dense_bf16.float())


def _dense_scores(dev: dict, W: torch.Tensor, num_docs: int,
                  dense_bf16: torch.Tensor | None = None) -> torch.Tensor:
    """[Q, N] f32 dense-tier scores, 0 on dead lanes: a full-f32 matmul
    (TF32 is off, utils/torch_env.py), or `bf16_product` on the tier's
    bf16 copy when one is given."""
    dense = dev.get("dense_tfn")
    if dense_bf16 is not None and W.shape[1] > 0:
        scores_d = bf16_product(W, dense_bf16)
    elif dense is not None and W.shape[1] > 0:
        scores_d = torch.matmul(W, dense)
    else:
        scores_d = torch.zeros((W.shape[0], num_docs), dtype=torch.float32,
                               device=W.device)
    return scores_d.masked_fill_(~dev["live"][None, :], 0.0)


def _posting_parts(dev, sparse_rows, sparse_weights, avgdl, k1, b, has_norms):
    """Raw-postings BM25 of every gathered lane -> (cd [Q, C] i32 docids,
    cs [Q, C] f32 partial scores); padding lanes give docid num_docs at 0."""
    rows = sparse_rows.long()
    docids = dev["post_docids"][rows]  # [Q, Ts, B, 128]
    tfs = dev["post_tfs"][rows]
    if has_norms:
        dls = dev["post_dls"][rows]
        denom = tfs + k1 * (1.0 - b + b * dls / avgdl)
    else:
        denom = tfs + k1
    part = sparse_weights[:, :, None, None] * tfs / denom  # pad -> 0
    Q = docids.shape[0]
    return docids.reshape(Q, -1), part.reshape(Q, -1)


def _run_sums(cd: torch.Tensor, cs: torch.Tensor):
    """Sort candidate lanes by docid and sum each docid's run.
    -> (sd [Q, C] sorted docids, run_sum [Q, C] f32, is_end [Q, C]): a
    run's sum is valid at its last lane (is_end)."""
    sd, order = torch.sort(cd, dim=1, stable=True)
    sv = cs.gather(1, order).double()
    csum = torch.cumsum(sv, dim=1)
    starts = torch.ones_like(sd, dtype=torch.bool)
    starts[:, 1:] = sd[:, 1:] != sd[:, :-1]
    # the run's base propagated forward by cummax (csum - sv is
    # non-decreasing: sv >= 0)
    base = torch.where(starts, csum - sv, NEG_INF)
    run_base = torch.cummax(base, dim=1).values
    run_sum = (csum - run_base).float()
    is_end = torch.ones_like(starts)
    is_end[:, :-1] = sd[:, :-1] != sd[:, 1:]
    return sd, run_sum, is_end


def _merge(cand, cand_ids, cand_ok, dv, di, k):
    """Dense top-k (entries also among the valid candidates masked out) ++
    candidates -> the top k by (score desc, docid asc)."""
    dup = (di[:, :, None] == cand_ids[:, None, :]) & cand_ok[:, None, :]
    dv = torch.where(dup.any(-1), NEG_INF, dv)
    return rank_topk(torch.cat([cand, dv], dim=1),
                     torch.cat([cand_ids, di], dim=1), k)


def batch_term_disjunction(dev, k, W, sparse_rows, sparse_weights, avgdl,
                           num_docs, k1=1.2, b=0.75, has_norms=True, impact_w=None):
    """The exact arm -> (scores [Q, k], docids [Q, k], totals [Q]): every
    candidate kept, the dense score gathered at each. With `impact_w`
    ([Q, Ts] dequant weights, the JAX package's impact_w mode, which its
    sharded impact arm runs) the sparse lanes come from the quantized impact
    tier through the `impact_gather` kernel, each lane impact_w · code in
    one rounding as there, instead of BM25 over the raw postings."""
    n = num_docs
    live = dev["live"]
    scores_d = _dense_scores(dev, W, n)
    if impact_w is None:
        cd, cs = _posting_parts(dev, sparse_rows, sparse_weights, avgdl, k1, b,
                                has_norms)
    else:
        Q, Ts, B = sparse_rows.shape
        cd, cs = impact_gather(dev["impact_codes"], dev["post_docids"],
                               sparse_rows.reshape(Q, Ts * B).contiguous(),
                               impact_w.repeat_interleave(B, dim=1).contiguous())
    sd, run_sum, is_end = _run_sums(cd, cs)
    at = sd.clamp(max=n - 1).long()
    valid_end = is_end & live[at] & (sd < n)
    dg = scores_d.gather(1, at)
    cand = torch.where(valid_end, run_sum + dg, NEG_INF)
    dv, di, dense_count = _dense_topk(scores_d, live, k)
    fv, fids = _merge(cand, sd, valid_end, dv, di, k)
    totals = dense_count + (valid_end & (dg <= 0) & (run_sum > 0)).sum(
        dim=1, dtype=torch.int32)
    return fv, fids, totals


def fast_topk_from_candidates(dev, extras, k, M, W, cd, cs, num_docs, bf16=False):
    """The dense tier + candidate sort/run-sum/cut/merge machinery of the
    fast and impact arms, on explicit per-lane candidates (cd [Q, C] i32,
    pad num_docs; cs [Q, C] f32, pad 0).

    With bf16=True (extras of `_fast_extras(True)`) the dense product takes
    bf16 operands with f32 output (`bf16_product`); the proof below then
    holds for the bf16 score function, with the bound W @ rowmax_bf16 ·
    (1 + 2^-7) covering both operands' rounding.

    The candidates are cut to the per-query top M by run sum before the
    dense gather, with a proof that the cut did not change the top k:
    dropped_best + ub_dense < kth_score, where ub_dense bounds the query's
    dense score. `exact` reports the proof; callers re-run the failing
    queries with a wider M. totals_lb counts dense matches plus kept
    sparse-only candidates; the true total lies in [totals_lb, totals_lb +
    dropped].

    -> (scores [Q, k], docids [Q, k], totals_lb [Q], exact [Q], dropped [Q])."""
    n = num_docs
    live = dev["live"]
    Q, C = cd.shape
    scores_d = _dense_scores(dev, W, n, extras.get("dense_bf16") if bf16 else None)
    if bf16 and "rowmax_bf16" in extras and W.shape[1] > 0:
        ub_dense = torch.matmul(W, extras["rowmax_bf16"]) * (1.0 + 2.0**-7)
    elif not bf16 and "rowmax" in extras and W.shape[1] > 0:
        # the bound must not round below the true sum: full f32, inflated
        ub_dense = torch.matmul(W, extras["rowmax"]) * (1.0 + 2.0**-18)
    else:
        ub_dense = torch.zeros(Q, dtype=torch.float32, device=W.device)
    dv, di, dense_count = _dense_topk(scores_d, live, k)

    sd, run_sum, is_end = _run_sums(cd, cs)
    valid_end = is_end & (sd < n)
    if M < C:
        # keep the top M by run sum: an ascending stable sort on the negated
        # key carries the docids along
        neg = torch.where(valid_end, -run_sum, float("inf"))
        order = torch.sort(neg, dim=1, stable=True).indices
        cd_all, rs_all, ve_all = sd.gather(1, order), run_sum.gather(1, order), \
            valid_end.gather(1, order)
        cd_m, rs_m, ve_m = cd_all[:, :M], rs_all[:, :M], ve_all[:, :M]
        dropped_best = torch.where(ve_all[:, M], rs_all[:, M], NEG_INF)
        dropped = (ve_all[:, M:] & (rs_all[:, M:] > 0)).sum(dim=1, dtype=torch.int32)
    else:
        cd_m, rs_m, ve_m = sd, run_sum, valid_end
        dropped_best = torch.full((Q,), NEG_INF, device=W.device)
        dropped = torch.zeros(Q, dtype=torch.int32, device=W.device)

    # the live check runs on the kept set: the cut may keep deleted docs
    # over live ones, and dropped_best bounds the dropped live ones too
    at = cd_m.clamp(max=n - 1).long()
    live_m = live[at] & ve_m
    dg = scores_d.gather(1, at)
    cand = torch.where(live_m, rs_m + dg, NEG_INF)
    fv, fids = _merge(cand, cd_m, live_m, dv, di, k)
    totals_lb = dense_count + (live_m & (dg <= 0) & (rs_m > 0)).sum(
        dim=1, dtype=torch.int32)
    kth = fv[:, k - 1]
    exact = (dropped_best + ub_dense < kth) | torch.isneginf(dropped_best)
    return fv, fids, totals_lb, exact, dropped


def batch_term_disjunction_fast(dev, extras, k, M, W, sparse_rows, sparse_weights,
                                avgdl, num_docs, k1=1.2, b=0.75, has_norms=True, bf16=False):
    """The fast arm over the raw postings: their BM25 lanes through
    `fast_topk_from_candidates` (its output contract)."""
    cd, cs = _posting_parts(dev, sparse_rows, sparse_weights, avgdl, k1, b,
                            has_norms)
    return fast_topk_from_candidates(dev, extras, k, M, W, cd, cs, num_docs, bf16=bf16)


def tiered_dense_topk(dev, extras, k, kb, W, dense_rows, dense_w):
    """The dense-only tiered arm: split-bf16 selection of kb candidates by
    the `tiered_candidates` kernel, their f32 rescore against the f32 tier,
    and the margin test. -> (scores [Q, k'], docids, totals, safe [Q],
    dropped = 0), k' = min(k, kb). A query is safe when its kth rescored
    score clears the kb-th selection score by the selection's error, or ties
    the lowest rescored candidate; unsafe queries escalate to the exact
    scan."""
    sel_v, sel_i, totals = tiered_candidates(
        W, extras["dense_hi"], extras["dense_lo"], dev["live"], kb,
        transform="identity", count_positive=True)
    cand_ok = torch.isfinite(sel_v)
    dg = dev["dense_tfn"][dense_rows.long()[:, :, None],
                          sel_i.long()[:, None, :]]  # [Q, Td, kb]
    resc = torch.sum(dense_w[:, :, None] * dg, dim=1)
    resc = torch.where(cand_ok & (resc > 0), resc, NEG_INF)
    v, i_ = rank_topk(resc, sel_i, min(k, kb))
    am_kernel = sel_v[:, -1]
    am_resc = torch.where(cand_ok, resc, float("inf")).min(dim=1).values
    rk = v[:, -1]
    bound = am_kernel + EPS_TIERED * torch.abs(am_kernel)
    safe = torch.isneginf(am_kernel) | (rk > bound) | (rk == am_resc)
    return v, i_, totals, safe, torch.zeros(v.shape[0], dtype=torch.int32,
                                            device=v.device)


def _dense_scan(dev, k, W):
    """Dense-only rows through `scan_topk` in matmul mode (a full-f32
    matmul and the stable sort beyond the kernel's k).
    -> (scores [Q, k], docids [Q, k], totals [Q])."""
    if k <= MAX_FUSED_K:
        return scan_topk(W, dev["dense_tfn"], dev["live"], k)
    return _dense_topk(_dense_scores(dev, W, dev["live"].shape[0]), dev["live"], k)


def fetch(parts: list) -> list[tuple]:
    """Copy every group's outputs to the host in ONE device-to-host copy.

    parts: per group, a list of chunk outputs (tuples of tensors on one
    device, the query axis first). -> per group, a tuple of numpy arrays,
    its chunks concatenated."""
    words, layout = pack_outputs(parts)
    return unpack_outputs(None if words is None else words.cpu().numpy(), layout)


def pack_outputs(parts: list):
    """The device half of `fetch`: every tensor of `parts` as 32-bit words
    of ONE device tensor (None when there is none). -> (words, layout);
    copying `words` to the host is the only step left, and
    `unpack_outputs` rebuilds the arrays from it. 32-bit tensors are their
    words, 64-bit ones two words per element, bools one word each."""
    flat = [t for chunks in parts for chunk in chunks for t in chunk]
    layout = ([[len(chunk) for chunk in chunks] for chunks in parts],
              [(t.dtype, tuple(t.shape)) for t in flat])
    if not flat:
        return None, layout
    odd = {t.dtype for t in flat} - set(_WORDS)
    if odd:
        raise TypeError(f"fetch carries 32-bit, 64-bit and bool tensors, "
                        f"got {sorted(map(str, odd))}")
    words = torch.cat([
        (t.to(torch.int32) if t.dtype == torch.bool else t.contiguous().reshape(-1)
         .view(torch.int32)).reshape(-1) for t in flat])
    return words, layout


# words per element and the host dtype of each dtype `pack_outputs` carries
_WORDS = {torch.float32: (1, np.float32), torch.int32: (1, np.int32), torch.bool: (1, bool),
          torch.int64: (2, np.int64), torch.float64: (2, np.float64)}


def unpack_outputs(words: np.ndarray | None, layout) -> list[tuple]:
    """The host half of `fetch`: the copied words -> per group, a tuple of
    numpy arrays, its chunks concatenated."""
    groups, specs = layout
    arrays, pos = [], 0
    for dtype, shape in specs:
        per, host = _WORDS[dtype]
        n = int(np.prod(shape)) * per
        a = words[pos: pos + n]
        pos += n
        if host is bool:
            a = a.astype(bool)
        elif host is not np.int32:
            a = a.view(host)
        arrays.append(a.reshape(shape))
    it = iter(arrays)
    out = []
    for sizes in groups:
        per_chunk = [tuple(next(it) for _ in range(n)) for n in sizes]
        out.append(tuple(np.concatenate(col) for col in zip(*per_chunk)))
    return out


class BatchTermSearcher:
    """Batched term-disjunction queries against one ShardSearcher's device
    pack."""

    # fast-arm candidate budget: 2048 covers the full candidate set of most
    # real queries (sum of sparse-term dfs), making the cut a no-op, and a
    # no-op cut is provably exact, which keeps the rerun rate low
    FAST_M = 2048
    # query-chunk budget: caps the materialized [Qc, N] f32 score matrix
    # (2 GB => 512-query chunks on a 1M-doc shard)
    SCORE_BYTES_BUDGET = 1 << 31

    def __init__(self, searcher):
        self.searcher = searcher
        self.device = searcher.device
        self._extras_fast: dict[bool, dict] = {}
        self._extras_tiered: dict | None = None
        self._fused = None
        # per-arm query and chunk counts and escalation rounds of the last
        # msearch call
        self.last_stats: dict = {}
        # device windows of launched stages, accounted after a copy back
        self._windows: list = []

    def plan(self, fld: str, queries: list[list[tuple[str, float]]], k: int, *,
             pad_ts: int | None = None, pad_b: int | None = None) -> BatchPlan:
        """queries: per query a list of (term, boost) on field `fld`.
        pad_ts/pad_b force the padded (sparse-term, block) shape of a
        bucket."""
        pack = self.searcher.pack
        k = min(max(k, 1), max(pack.num_docs, 1))
        V = pack.dense_tfn.shape[0] if pack.dense_tfn is not None else 0
        Q = len(queries)
        doc_count = pack.field_stats.get(fld, {}).get("doc_count") or pack.num_docs
        max_ts, max_b = 1, 1
        has_impact = True
        parsed = []
        for terms in queries:
            dense, sparse = [], []
            for term, boost in terms:
                w = 0.0
                s0, nb, df = pack.term_blocks(fld, term)
                if df > 0:
                    w = boost * bm25_idf(doc_count, df)
                dr = pack.dense_row_of(fld, term)
                if dr is not None:
                    dense.append((dr, w))
                elif nb > 0:
                    isc = pack.impact_wscale(fld, term)
                    if isc is None:
                        has_impact = False
                    sparse.append((s0, nb, w, w * (isc or 0.0)))
                    max_b = max(max_b, nb)
            max_ts = max(max_ts, len(sparse))
            parsed.append((dense, sparse))
        B = pad_b or (1 << (max_b - 1).bit_length())
        if pad_ts:
            max_ts = max(max_ts, pad_ts)
        W = np.zeros((Q, V), np.float32)
        rows = np.zeros((Q, max_ts, B), np.int32)
        ws = np.zeros((Q, max_ts), np.float32)
        iws = np.zeros((Q, max_ts), np.float32)
        td_max = max((len(d) for d, _ in parsed), default=1) or 1
        Td = 1 << (max(td_max, 4) - 1).bit_length()
        dense_rows = np.zeros((Q, Td), np.int32)
        dense_w = np.zeros((Q, Td), np.float32)
        for qi, (dense, sparse) in enumerate(parsed):
            for ti, (dr, w) in enumerate(dense):
                W[qi, dr] += w
                dense_rows[qi, ti] = dr
                dense_w[qi, ti] = w
            for ti, (s0, nb, w, iw) in enumerate(sparse):
                rows[qi, ti, :nb] = np.arange(s0, s0 + nb)
                ws[qi, ti] = w
                iws[qi, ti] = iw
        dense_only = V > 0 and all(not sparse for _, sparse in parsed)
        return BatchPlan(W, rows, ws, k, dense_only,
                         dense_rows=dense_rows, dense_w=dense_w,
                         impact_w=iws if has_impact else None)

    @staticmethod
    def wave_q_tier(q: int) -> int:
        """The batch tier a q-query serving wave pads to: the next power of
        two (reference `ops/batched.py:849-856`). q / wave_q_tier(q) is the
        wave's occupancy. The pad queries are empty: they plan to zero
        weights and score nothing on every arm."""
        return 1 << max(q - 1, 0).bit_length() if q > 1 else 1

    def _chunk_q(self, Q: int) -> int:
        """Chunk width: the largest power of two whose [Qc, N] f32 score
        matrix stays under SCORE_BYTES_BUDGET, or Q rounded up to a power of
        two when the whole batch fits (chunks are not padded to it)."""
        n = max(self.searcher.pack.num_docs, 1)
        budget = max(1, self.SCORE_BYTES_BUDGET // (4 * n))
        pow2_floor = 1 << (budget.bit_length() - 1)
        if Q >= pow2_floor:
            return pow2_floor
        return 1 << max(Q - 1, 0).bit_length() if Q > 1 else 1

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor. On the card through pinned memory
        and a non-blocking copy: a copy from pageable memory would wait for
        the stream, serializing the host's planning with the device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _chunks(self, *arrays: np.ndarray):
        """Per query chunk, the arrays' rows of that chunk on the device."""
        Q = arrays[0].shape[0]
        qc = self._chunk_q(Q)
        for i in range(0, Q, qc):
            yield tuple(self._put(a[i: i + qc]) for a in arrays)

    def n_chunks(self, Q: int) -> int:
        return -(-Q // self._chunk_q(Q)) if Q else 0

    def _scoring(self, fld: str) -> dict:
        pack = self.searcher.pack
        ctx = self.searcher.ctx
        has_norms = fld in ctx.has_norms
        return {"avgdl": ctx.avgdl[fld] if has_norms else None, "k1": ctx.k1,
                "b": ctx.b, "has_norms": has_norms, "num_docs": pack.num_docs}

    def run(self, fld: str, plan: BatchPlan) -> list[tuple]:
        """The exact arm -> chunk outputs (scores [Qc, k], docids [Qc, k],
        totals [Qc]) on the device. A dense-only plan runs as one
        `scan_topk` matmul scan (no [Q, N] score matrix)."""
        dev = self.searcher.dev
        if plan.dense_only:
            return [_dense_scan(dev, plan.k, self._put(plan.W))]
        sc = self._scoring(fld)
        return [batch_term_disjunction(dev, plan.k, W, sr, sw, **sc)
                for W, sr, sw in self._chunks(plan.W, plan.sparse_rows,
                                              plan.sparse_weights)]

    def _fast_extras(self, bf16: bool = False) -> dict:
        """The fast arm's device arrays for one precision, made at first
        use: the dense tier's per-row maxima (the cut proof's dense bound);
        with bf16, the tier's bf16 copy and the maxima of that copy."""
        extras = self._extras_fast.get(bf16)
        if extras is None:
            dense = self.searcher.dev.get("dense_tfn")
            extras = {}
            if dense is not None and bf16:
                extras["dense_bf16"] = dense.to(torch.bfloat16)
                extras["rowmax_bf16"] = extras["dense_bf16"].float().max(dim=1).values
            elif dense is not None:
                extras["rowmax"] = dense.max(dim=1).values
            self._extras_fast[bf16] = extras
        return extras

    def _tiered_extras(self) -> dict:
        """Split-bf16 (hi, lo) copies of the dense tier for the tiered
        selection kernel, made at first use."""
        if self._extras_tiered is None:
            hi, lo = split_bf16(self.searcher.dev["dense_tfn"])
            self._extras_tiered = {"dense_hi": hi, "dense_lo": lo}
        return self._extras_tiered

    def run_fast(self, fld: str, plan: BatchPlan, *, M: int | None = None,
                 bf16: bool = False) -> list[tuple]:
        """The fast arm -> chunk outputs (scores [Qc, k], docids [Qc, k],
        totals_lb [Qc], exact [Qc], dropped [Qc]) on the device. Dense-only
        plans take the tiered arm for k <= KB_TIERED and the `scan_topk`
        matmul scan above (both ignore bf16); the sparse tail scores the raw
        postings, and bf16 runs the dense product on the tier's bf16 copy."""
        dev = self.searcher.dev
        k = plan.k
        if plan.dense_only:
            if k <= KB_TIERED:
                kb = min(max(KB_TIERED, k), self.searcher.pack.num_docs)
                extras = self._tiered_extras()
                return [tiered_dense_topk(dev, extras, k, kb, W, dr, dw)
                        for W, dr, dw in self._chunks(plan.W, plan.dense_rows,
                                                      plan.dense_w)]
            outs = []
            for (W,) in self._chunks(plan.W):
                v, i_, t = _dense_scan(dev, k, W)
                ones = torch.ones(v.shape[0], dtype=torch.bool, device=v.device)
                outs.append((v, i_, t, ones, torch.zeros_like(t)))
            return outs
        Ts, B = plan.sparse_rows.shape[1], plan.sparse_rows.shape[2]
        M = min(M or self.FAST_M, Ts * B * BLOCK)
        sc = self._scoring(fld)
        extras = self._fast_extras(bf16)
        return [batch_term_disjunction_fast(dev, extras, k, M, W, sr, sw, **sc, bf16=bf16)
                for W, sr, sw in self._chunks(plan.W, plan.sparse_rows,
                                              plan.sparse_weights)]

    def impact_usable(self) -> bool:
        """The pack's impact tier is resident on the device."""
        return "impact_codes" in self.searcher.dev

    def run_impact(self, fld: str, plan: BatchPlan, *, M: int | None = None) -> list[tuple]:
        """The impact arm (BM25S) -> the run_fast output contract. Per chunk:
        the `impact_gather` kernel fetches the query terms' code blocks and
        their docids and dequantizes each row with one per-term weight, then
        the fast arm's candidate machinery runs on those lanes ('exact' =
        exact for the impact score function). Plans the tier cannot serve
        go to run_fast. The gathers of every chunk launch first, timed as
        `sparse.impact_gather` (a `device_window`, closed by `msearch`
        after its copy back: no synchronization), then the candidate
        tails."""
        from ..telemetry import device_window

        dev = self.searcher.dev
        if plan.dense_only or plan.impact_w is None or not self.impact_usable():
            return self.run_fast(fld, plan, M=M)
        Q, Ts, B = plan.sparse_rows.shape
        M = min(M or self.FAST_M, Ts * B * BLOCK)
        n = self.searcher.pack.num_docs
        rows_flat = plan.sparse_rows.reshape(Q, Ts * B)
        w_flat = np.repeat(plan.impact_w, B, axis=1)  # [Q, Ts*B]
        extras = self._fast_extras()
        chunks = list(self._chunks(plan.W, rows_flat, w_flat))
        codes = dev["impact_codes"]
        window = device_window("sparse.impact_gather", self.device, tier="impact", queries=Q,
                               rows=Q * Ts * B, code_bytes=codes.element_size())
        with window:
            cands = [impact_gather(codes, dev["post_docids"], rows, w) for _W, rows, w in chunks]
        self._windows.append(window)
        return [fast_topk_from_candidates(dev, extras, plan.k, M, W, cd, cs, n)
                for (W, _rows, _w), (cd, cs) in zip(chunks, cands)]

    def search(self, fld: str, queries: list[list[tuple[str, float]]], k: int = 10):
        """The exact arm over one plan -> (scores, docids, totals) numpy."""
        return fetch([self.run(fld, self.plan(fld, queries, k))])[0]

    def plan_bucketed(self, fld: str, queries: list[list[tuple[str, float]]],
                      k: int) -> list[tuple[np.ndarray, BatchPlan]]:
        """Split a batch into shape-homogeneous groups before padding: by
        power-of-two sparse-term count and block count in 4x steps from 8,
        so no query pays a heavier query's candidate width.

        -> list of (original query indices, BatchPlan)."""
        pack = self.searcher.pack
        shapes = []
        for terms in queries:
            ts, maxb = 0, 0
            for term, _ in terms:
                if pack.dense_row_of(fld, term) is not None:
                    continue
                _, nb, df = pack.term_blocks(fld, term)
                if nb > 0:
                    ts += 1
                    maxb = max(maxb, nb)
            bb = 8
            while bb < maxb:
                bb *= 4
            shapes.append(
                ((1 << max(ts - 1, 0).bit_length()) if ts else 0,
                 bb if maxb else 0))
        groups: dict[tuple, list[int]] = {}
        for qi, sh in enumerate(shapes):
            groups.setdefault(sh, []).append(qi)
        out = []
        for (ts_b, b_b), idxs in sorted(groups.items()):
            sub = [queries[i] for i in idxs]
            out.append((np.asarray(idxs, np.int64),
                        self.plan(fld, sub, k, pad_ts=ts_b or None,
                                  pad_b=b_b or None)))
        return out

    def _fused_searcher(self, k: int):
        """The FusedTermSearcher of this pack, made at first use, when the
        pack and k qualify; else None."""
        if not FusedTermSearcher.usable(self.searcher.pack, k):
            return None
        if self._fused is None:
            self._fused = FusedTermSearcher(self)
        return self._fused

    def arm_of(self, plan: BatchPlan, fast: bool, impact: bool = True) -> str:
        """The first-pass arm of one shape group of a batch that did not
        take the fused arm: exact when fast=False; tiered (k <= KB_TIERED)
        or dense for dense-only groups; impact when the batch rides the
        impact tier (`impact`) and the tier serves the group; else fast."""
        if not fast:
            return "exact"
        if plan.dense_only:
            return "tiered" if plan.k <= KB_TIERED else "dense"
        if impact and plan.impact_w is not None and self.impact_usable():
            return "impact"
        return "fast"

    def _run_arm(self, arm: str, fld: str, plan: BatchPlan, *, M: int | None = None,
                 bf16: bool = False) -> list[tuple]:
        if arm == "exact":
            return self.run(fld, plan)
        if arm == "impact":
            return self.run_impact(fld, plan, M=M)
        return self.run_fast(fld, plan, M=M, bf16=bf16)

    def _close_windows(self) -> None:
        """Account the device windows of the stages a copy back has waited
        for."""
        for w in self._windows:
            w.close()
        self._windows.clear()

    def choose_batch_arm(self, n_queries: int, k: int, fast: bool = True) -> str:
        """The execution planner's arm for a batch (site "batched.msearch"),
        from the arms that serve it in the static order: fused when
        `_fused_searcher(k)` is usable, impact when `impact_usable()`, and
        exact (the fast arm with its rerun loop) last. A cold planner takes
        the first. fast=False -> "exact" without asking."""
        if not fast:
            return "exact"
        from ..planner import execution_planner

        fs = self._fused_searcher(k)
        n_docs = self.searcher.pack.num_docs
        cands = []
        if fs is not None:
            cands.append(("fused", "fused.pallas_scan", {"k": k, **fs._cost_fields(n_queries)}))
        if self.impact_usable():
            cands.append(("impact", "sparse.impact_sum",
                          {"queries": n_queries, "k": k, "num_docs": n_docs}))
        cands.append(("exact", "batched.disjunction",
                      {"queries": n_queries, "k": k, "num_docs": n_docs}))
        return execution_planner().choose_arm("batched.msearch", cands)

    def msearch_many(self, fld: str, batches: list, k: int = 10) -> list[tuple]:
        """Several batches -> one msearch tuple each. On the fused arm every
        batch is launched before any result is copied back; otherwise the
        batches run one msearch each (the planner decides inside each, as in
        the reference)."""
        fs = self._fused_searcher(k)
        if fs is None:
            return [self.msearch(fld, qs, k) for qs in batches]
        out = fs.msearch_many(fld, batches, k)
        self.last_stats = fs.last_stats
        return out

    def msearch_coalesced(self, fld: str, groups: list, k: int = 10, **kw) -> list[tuple]:
        """Several callers' query lists as ONE msearch, the rows split back
        per group -> one msearch tuple per group, in group order. On the
        fused arm a first-pass row does not depend on the batch around it
        (per-row plans, kernel blocks and selections; the rescore's sums are
        exact per term), so there each group's rows are byte-identical to
        running that group alone."""
        flat = [q for g in groups for q in g]
        if not flat:
            return [(np.zeros((0, k), np.float32), np.zeros((0, k), np.int64),
                     np.zeros((0,), np.int64), np.ones((0,), bool)) for _ in groups]
        scores, ids, totals, exact = self.msearch(fld, flat, k, **kw)
        out, pos = [], 0
        for g in groups:
            n = len(g)
            out.append((scores[pos: pos + n], ids[pos: pos + n], totals[pos: pos + n],
                        exact[pos: pos + n]))
            pos += n
        return out

    def msearch(self, fld: str, queries: list[list[tuple[str, float]]], k: int = 10, *,
                fast: bool = True, bf16: bool = False, track_total_hits: int = 10_000):
        """Bucketed batch search -> (scores [Q, k], docids [Q, k], totals
        [Q], first_pass_exact [Q]) as numpy, in input order.

        fast=True hands the whole batch to the fused arm when it is usable
        (its totals are exact at any count). Otherwise it runs the impact /
        fast / tiered arms and re-runs any query whose top-k proof failed
        OR whose total-hits bracket straddles
        track_total_hits, widening the candidate budget 4x per round up to
        no cut at all (flagged dense-only queries go straight to the exact
        scan). So top-k docs are ALWAYS exact for the arm's score function,
        and totals are exact below track_total_hits and a lower bound at or
        above it (the reference's TotalHits.Relation contract).
        first_pass_exact reports which queries were proven without a
        rerun. Missing-hit columns carry -inf scores.

        The batch arm comes from `choose_batch_arm` (the execution planner;
        a cold planner routes fused > impact > exact). bf16=True runs the
        fast arm's dense product on bf16 operands with f32 output: its top k
        is exact for the bf16 score function (the fused arm, the impact arm
        and the dense-only tiered route ignore it, as in the reference).
        `last_stats["queries"]` reports the arm each shape group took."""
        from ..telemetry import profile_event, time_kernel

        Q = len(queries)
        arm = self.choose_batch_arm(Q, k, fast)
        if arm == "fused":
            fs = self._fused_searcher(k)
            profile_event("tier", tier="fused", queries=Q)
            with time_kernel("fused.msearch", self.device, tier="fused", queries=Q, k=k):
                out = fs.msearch(fld, queries, k)
            self.last_stats = fs.last_stats
            return out
        use_impact = arm == "impact"
        scores = np.full((Q, k), -np.inf, np.float32)
        ids = np.zeros((Q, k), np.int64)
        totals = np.zeros((Q,), np.int64)
        exact = np.ones((Q,), bool)
        # first-pass queries and chunks per arm, escalation rounds and reruns
        stats = {"queries": {}, "chunks": {}, "rounds": 0, "escalated": 0}
        tier = ("impact" if use_impact else "fast") if fast else "exact"
        profile_event("tier", tier=tier, queries=Q)
        plans = self.plan_bucketed(fld, queries, k)
        # the window covers the launches and the one copy back of every group
        with time_kernel("sparse.impact_sum" if use_impact else "batched.disjunction",
                         self.device, tier=tier, queries=Q, k=k,
                         num_docs=self.searcher.pack.num_docs):
            groups = []
            for idxs, plan in plans:
                garm = self.arm_of(plan, fast, use_impact)
                stats["queries"][garm] = stats["queries"].get(garm, 0) + len(idxs)
                stats["chunks"][garm] = stats["chunks"].get(garm, 0) + self.n_chunks(len(idxs))
                groups.append((idxs, self._run_arm(garm, fld, plan, bf16=bf16)))
            host = fetch([g for _, g in groups])
        self._close_windows()
        pending: list[np.ndarray] = []
        for (idxs, _), out in zip(groups, host):
            kk = out[0].shape[1]
            scores[idxs, :kk] = out[0]
            ids[idxs, :kk] = out[1]
            totals[idxs] = out[2]
            if len(out) > 3:
                ok = out[3] & ((out[4] == 0) | (out[2] >= track_total_hits))
                exact[idxs] = ok
                if not ok.all():
                    pending.append(idxs[~ok])
        rerun_m = 4 * self.FAST_M
        while pending:
            redo = np.concatenate(pending)
            pending = []
            stats["rounds"] += 1
            stats["escalated"] += len(redo)
            profile_event("tier", tier="exact_escalation", queries=int(redo.shape[0]))
            reruns = []
            for idxs, plan in self.plan_bucketed(fld, [queries[i] for i in redo], k):
                if plan.dense_only:
                    # a tiered flag has no candidate budget to widen
                    reruns.append((idxs, True, self.run(fld, plan)))
                    continue
                C = plan.sparse_rows.shape[1] * plan.sparse_rows.shape[2] * BLOCK
                M = min(rerun_m, C)
                reruns.append((idxs, M >= C, self._run_arm(
                    self.arm_of(plan, fast, use_impact), fld, plan, M=M, bf16=bf16)))
            rerun_host = fetch([r for _, _, r in reruns])
            self._close_windows()
            for (idxs, uncut, _), out in zip(reruns, rerun_host):
                ok = np.ones(len(idxs), bool)
                if len(out) > 3 and not uncut:
                    ok = out[3] & ((out[4] == 0) | (out[2] >= track_total_hits))
                done = redo[idxs[ok]]
                kk = out[0].shape[1]
                scores[done, :kk] = out[0][ok]
                ids[done, :kk] = out[1][ok]
                totals[done] = out[2][ok]
                if not ok.all():
                    pending.append(redo[idxs[~ok]])
            rerun_m *= 4
        self.last_stats = stats
        return scores, ids, totals, exact


def impact_tie_class(pack, fld: str, terms) -> float:
    """The impact arm's quantization tie class of a term disjunction on a
    ShardPack or a StackedPack: 2 · Σ boost·idf·ubf / QMAX over the terms
    the impact tier serves (df > 0, not in the dense tier; on a stacked pack
    each term's largest per-shard bound ubf) + 1e-7. The impact arm's scores
    lie within it of exact BM25, and its ids may swap within it."""
    doc_count = pack.field_stats[fld]["doc_count"]
    shards = getattr(pack, "shards", [pack])
    bound = 0.0
    for term, boost in terms:
        key = (fld, term)
        df = (pack.global_df.get(key, 0) if hasattr(pack, "global_df")
              else pack.term_blocks(fld, term)[2])
        if df <= 0 or key in pack.dense_dict:
            continue
        ubf = max(float(p.impact_ubf[p.term_dict[key]]) for p in shards if key in p.term_dict)
        bound += boost * bm25_idf(doc_count, df) * ubf / pack.impact_meta["qmax"]
    return 2 * bound + 1e-7
