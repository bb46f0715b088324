"""The fused batched BM25 arm (the JAX package's `ops/fused.py`).

Per query chunk, one kernel scores every (query, doc) lane with the dense
tier in split-bf16 and the sparse CSR tail in exact f32, masks to live
lanes with score > 0, counts them exactly and keeps each 4,096-doc tile's
top t candidates (`fused_tile_candidates`, csrc/fused_tile_candidates.cu).
No [Qc, N] score array exists on this path. The tiles' candidates are then
merged to the top KB, rescored in f32 by `canonical_rescore`, ranked by
(score desc, docid asc), and a query whose ranking the split-bf16
selection cannot prove is flagged and re-run on the exact arm.

Totals are exact: a live lane matches iff its score is > 0 (every BM25
term weight is > 0), and rounding keeps the sign.

Sort key of the window entries: (q << db) | docid, one query row per kernel
block (the JAX package packs a 256-row query subtile into the key's high
bits and the row's low bits below the docid, for its [256, tile] blocks).
`torch.sort(stable=True)` keeps duplicate (query, doc) entries, one per
sparse term, in plan order, so the kernel's run sums and the rescore add
the same values in the same order.

The JAX package's environment switches (`ES_TPU_FUSED*`) are not carried
over, and there is no out-of-kernel mode: the arm is used wherever
`FusedTermSearcher.usable` holds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .kernels import _check, _launcher, _mask_hi, _ptr, _stream, launch_counts
from .scoring import bm25_idf

KB = 64  # rescored candidate set size (top-K'); the final k must be <= 16
TILE_N = 4096  # docs per kernel tile (CHUNK in csrc/topk_select.cuh)
FINE_N = 1024  # the JAX package's window granularity; sizes `usable`
TILE_T = 5  # least per-tile candidate count
QC = 512  # query rows per chunk
# the JAX package's docid budget of the window key (its 8,192-doc tile)
MAX_DOCS_FUSED = (1 << 21) - 2 * 8192
# relative error bound of the split-bf16 selection against the f32
# rescore: the query weights are cut to bf16 (~2^-9 relative), the tier
# carries ~15 mantissa bits
EPS_SPLIT = 8e-3
SENTINEL = 2**31 - 1  # window key of a padding posting lane


def _key_bits(n_pad: int, qsub: int, nsub: int):
    """-> (qb, db, sb): bits of the query's low part, the docid and their
    sum in the window key. Raises when the key does not fit 31 bits."""
    qb = int(np.log2(qsub))
    db = max(1, int(np.ceil(np.log2(max(n_pad + 1, 2)))))
    sb = qb + db
    nsb = max(1, int(np.ceil(np.log2(max(nsub, 2)))))
    if sb + nsb > 31:
        raise ValueError("fused window key overflow: shard too large")
    return qb, db, sb


def tile_t_for(njc: int) -> int:
    """Per-tile candidate count. A tile's share of the top-K' is
    ~Binomial(KB, 1/njc) under exchangeable doc placement, so t is sized
    mean + 5 sigma + 4 to keep the saturation flag rare. t = KB + 1 can
    never flag or lose."""
    if njc <= 1:
        return KB + 1
    mu = KB / njc
    return max(TILE_T, min(KB + 1, math.ceil(mu + 5 * math.sqrt(mu) + 4)))


# ---------------------------------------------------------------------------
# the kernel and its twin
# ---------------------------------------------------------------------------


def fused_tile_candidates_reference(hi, lo, live, drows, dwh, keys, vals, ptr, *, t, db):
    """Plain PyTorch version of the kernel, on any device: the dense half
    as Td sequential multiply-adds into a hi sum and a lo sum, added; the
    sparse runs summed from 0.0 in sorted order, one position of a run per
    step; the per-tile top t by a stable descending sort; integer counts."""
    Qc, Td = drows.shape
    N = hi.shape[1]
    njc = -(-N // TILE_N)
    n_pad = njc * TILE_N
    dev = hi.device
    hs = torch.zeros((Qc, N), dtype=torch.float32, device=dev)
    ls = torch.zeros_like(hs)
    for i in range(Td):
        r = drows[:, i].long()
        w = dwh[:, i: i + 1]
        hs.add_(w * hi[r].float())
        ls.add_(w * lo[r].float())
    score = hs.add_(ls)
    del ls

    # every window lies in [0, ptr[-1, -1]): the keys are sorted and each
    # real docid is below n_pad
    E = int(ptr[-1, -1])
    sacc = torch.zeros(Qc * n_pad, dtype=torch.float32, device=dev)
    if E:
        k = keys[:E]
        starts = torch.ones(E, dtype=torch.bool, device=dev)
        starts[1:] = k[1:] != k[:-1]
        first = torch.nonzero(starts).squeeze(1)
        length = torch.diff(first, append=torch.tensor([E], device=dev))
        run = torch.zeros(first.shape[0], dtype=torch.float32, device=dev)
        for pos in range(int(length.max())):
            at = (first + pos).clamp(max=E - 1)
            run = torch.where(pos < length, run + vals[at], run)
        key = k[first].long()
        sacc[(key >> db) * n_pad + (key & ((1 << db) - 1))] = run
    score.add_(sacc.view(Qc, n_pad)[:, :N])
    del sacc

    padded = torch.full((Qc, n_pad), float("-inf"), dtype=torch.float32, device=dev)
    padded[:, :N] = torch.where(live[None, :] & (score > 0), score, float("-inf"))
    del score
    counts = (padded > 0).view(Qc, njc, TILE_N).sum(dim=2, dtype=torch.int32)
    sv, si = torch.sort(padded.view(Qc * njc, TILE_N), dim=1, descending=True, stable=True)
    sv, si = sv[:, :t], si[:, :t]
    tile0 = (torch.arange(Qc * njc, device=dev) % njc) * TILE_N
    ids = si + tile0[:, None]
    ids = torch.where(ids < N, ids, -1).to(torch.int32)  # lanes past the last doc
    return (sv.reshape(Qc, njc * t).contiguous(), ids.reshape(Qc, njc * t),
            counts.sum(dim=1, dtype=torch.int32),
            torch.zeros(Qc, dtype=torch.bool, device=dev))


# the kernel's routes (csrc/fused_tile_candidates.cu): a warp per row with a
# threshold-filtered selection for t <= SELECT_MAX_T, else a block per
# (row, tile) with a bitonic sort of the tile
FUSED_ROUTES = ("sort", "select")
SELECT_MAX_T = 128  # MAX_K in csrc/topk_select.cuh


def fused_route(t: int) -> str:
    """The kernel route for t candidates per tile, decided before the
    launch: "select" while the warp's selection holds t, else "sort"."""
    return "select" if t <= SELECT_MAX_T else "sort"


def _fused_tile_candidates_cuda(hi, lo, live, drows, dwh, keys, vals, ptr, t, db, route=None):
    dev = hi.device
    name = "fused_tile_candidates"
    V, N = hi.shape
    Qc, Td = drows.shape
    E = keys.shape[0]
    njc = -(-N // TILE_N)
    if N >= 2**31 or E >= 2**31 or njc > 65535:
        raise ValueError(f"{name}: {N} docs and {E} window entries exceed the kernel's grid")
    if not 1 <= t <= TILE_N or not 1 <= db <= 30:
        raise ValueError(f"{name}: t={t} or db={db} out of range")
    route = fused_route(t) if route is None else route
    if route not in FUSED_ROUTES or (route == "select" and t > SELECT_MAX_T):
        raise ValueError(f"{name}: route {route!r} does not take t={t}")
    _check(name, "hi", hi, torch.bfloat16, (V, N), dev)
    _check(name, "lo", lo, torch.bfloat16, (V, N), dev)
    _check(name, "live", live, torch.bool, (N,), dev)
    _check(name, "drows", drows, torch.int32, (Qc, Td), dev)
    _check(name, "dwh", dwh, torch.float32, (Qc, Td), dev)
    _check(name, "keys", keys, torch.int32, (E,), dev)
    _check(name, "vals", vals, torch.float32, (E,), dev)
    _check(name, "ptr", ptr, torch.int32, (Qc, njc + 1), dev)
    fn, width = _launcher(name)
    if width != TILE_N:
        raise ValueError(f"{name}: the kernel's tile is {width} docs, the pipeline's {TILE_N}")
    cand_v = torch.empty((Qc, njc * t), dtype=torch.float32, device=dev)
    cand_i = torch.empty((Qc, njc * t), dtype=torch.int32, device=dev)
    counts = torch.empty((Qc, njc), dtype=torch.int32, device=dev)
    if Qc:
        with torch.cuda.device(dev):
            rc = fn(_ptr(hi), _ptr(lo), N, _ptr(drows), _ptr(dwh), Td, _ptr(keys),
                    _ptr(vals), _ptr(ptr), _ptr(live), Qc, njc, t, db,
                    FUSED_ROUTES.index(route), _ptr(cand_v),
                    _ptr(cand_i), _ptr(counts), _stream(dev))
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
        launch_counts[name] += 1
    return (cand_v, cand_i, counts.sum(dim=1, dtype=torch.int32),
            torch.zeros(Qc, dtype=torch.bool, device=dev))


def fused_tile_candidates(
    hi: torch.Tensor,  # [V, N] bf16 hi tier (kernels.split_bf16)
    lo: torch.Tensor,  # [V, N] bf16 lo tier
    live: torch.Tensor,  # [N] bool
    drows: torch.Tensor,  # [Qc, Td] i32 distinct dense tier rows, ascending
    dwh: torch.Tensor,  # [Qc, Td] f32 their bf16-cut weights (0 = unused)
    keys: torch.Tensor,  # [E] i32 sorted window keys (q << db) | docid
    vals: torch.Tensor,  # [E] f32 the entries' BM25 parts
    ptr: torch.Tensor,  # [Qc, njc + 1] i32 first entry of each (q, tile) window
    *,
    t: int,
    db: int,
):
    """-> (cand_v [Qc, njc·t] f32, cand_i [Qc, njc·t] i32, totals [Qc] i32,
    window_lost [Qc] bool): each 4,096-doc tile's t best lanes by
    (selection score desc, docid asc), tile-major per row, -inf with id -1
    where a tile has fewer than t lanes; exact counts of live lanes with
    score > 0. The windows are read whole, so window_lost is always False
    (it keeps the JAX package's output shape)."""
    if hi.device.type != "cpu":
        return _fused_tile_candidates_cuda(hi, lo, live, drows, dwh, keys, vals, ptr, t, db)
    return fused_tile_candidates_reference(hi, lo, live, drows, dwh, keys, vals, ptr,
                                           t=t, db=db)


# ---------------------------------------------------------------------------
# canonical rescore: the score function the final ranking uses
# ---------------------------------------------------------------------------


def canonical_rescore(
    tier,  # [V, N] f32 dense tier (or None)
    dense_rows,  # [Q, Td] i32 (pad row 0 with weight 0)
    dense_w,  # [Q, Td] f32
    row_q,  # [R] i32 owner query of each CSR block row
    row_t,  # [R] i32 ordinal of the row's term among its query's sparse terms
    docids,  # [R, BLOCK] i32 gathered postings (pad: docid >= n)
    parts,  # [R, BLOCK] f32 per-posting partial scores
    cand_i,  # [Q, KB] i32 winners (any value where not cand_ok)
    cand_ok,  # [Q, KB] bool valid lanes
    ts: int,  # number of sparse term ordinals
):
    """Exact f32 score of each candidate: the dense part by per-(query,
    dense term, winner) tier lookups summed in plan order; the sparse part
    by comparison-reduce over the gathered posting rows, then one one-hot
    [Q, R] @ [R, KB] f32 product per term ordinal, added in term order. A
    term holds at most one posting of a doc, so each product has at most one
    nonzero addend and is exact whatever its summation order; the result
    does not depend on padding or on the chunk's other queries."""
    Q, kb = cand_i.shape
    at = cand_i.clamp(min=0).long()
    dsum = torch.zeros((Q, kb), dtype=torch.float32, device=cand_i.device)
    if tier is not None:
        for i in range(dense_rows.shape[1]):
            dsum = dsum + dense_w[:, i: i + 1] * tier[dense_rows[:, i].long()[:, None], at]
    ssum = torch.zeros_like(dsum)
    if ts:
        win_row = cand_i[row_q.long()]  # [R, KB] winners of each row's owner query
        eq = docids[:, :, None] == win_row[:, None, :]
        row_sum = torch.where(eq, parts[:, :, None], 0.0).sum(dim=1)  # [R, KB]
        del eq
        owner = torch.arange(Q, device=cand_i.device)[:, None] == row_q[None, :]
        for p in range(ts):
            onehot = (owner & (row_t[None, :] == p)).to(torch.float32)
            ssum = ssum + onehot @ row_sum
    return torch.where(cand_ok, dsum + ssum, float("-inf"))


# ---------------------------------------------------------------------------
# host planning + device pipeline
# ---------------------------------------------------------------------------


@dataclass
class FusedPlan:
    """Host-side per-chunk inputs. Block-row-major: the sparse side is one
    flat list of real CSR block rows with an owner query, a term weight and
    the term's ordinal among the query's sparse terms per row; R pads to a
    power of two of at least 64 with row 0, the all-padding block."""

    rows: np.ndarray  # [R] i32 CSR block rows
    row_q: np.ndarray  # [R] i32 owner query
    row_w: np.ndarray  # [R] f32 boost · idf
    row_t: np.ndarray  # [R] i32 term ordinal within the owner query
    dense_rows: np.ndarray  # [qc, Td] i32 dense tier rows (0-padded)
    dense_w: np.ndarray  # [qc, Td] f32 their weights
    k: int
    ts: int  # most sparse terms of one query


def plan_fused(pack, fld, queries, k, qc=QC) -> FusedPlan:
    """queries: per query a list of (term, boost) -> FusedPlan with qc
    query rows (the JAX package pads every chunk to QC; the port passes
    the chunk's own length)."""
    doc_count = pack.field_stats.get(fld, {}).get("doc_count") or pack.num_docs
    rows_l, rowq_l, roww_l, rowt_l = [], [], [], []
    dense_l = []
    td_max, ts = 1, 0
    for qi, terms in enumerate(queries):
        dlist = []
        nsparse = 0
        for term, boost in terms:
            s0, nb, df = pack.term_blocks(fld, term)
            if df <= 0:
                continue
            w = boost * bm25_idf(doc_count, df)
            dr = pack.dense_row_of(fld, term)
            if dr is not None:
                dlist.append((dr, w))
            elif nb > 0:
                rows_l.append(np.arange(s0, s0 + nb, dtype=np.int32))
                rowq_l.append(np.full(nb, qi, np.int32))
                roww_l.append(np.full(nb, w, np.float32))
                rowt_l.append(np.full(nb, nsparse, np.int32))
                nsparse += 1
        dense_l.append(dlist)
        td_max = max(td_max, len(dlist))
        ts = max(ts, nsparse)
    nreal = sum(len(r) for r in rows_l)
    R = 64
    while R < nreal:
        R *= 2
    rows = np.zeros(R, np.int32)  # row 0 of the pack = all-padding block
    row_q = np.zeros(R, np.int32)
    row_w = np.zeros(R, np.float32)
    row_t = np.zeros(R, np.int32)
    if nreal:
        rows[:nreal] = np.concatenate(rows_l)
        row_q[:nreal] = np.concatenate(rowq_l)
        row_w[:nreal] = np.concatenate(roww_l)
        row_t[:nreal] = np.concatenate(rowt_l)
    Td = 1 << (max(td_max, 4) - 1).bit_length()
    dense_rows = np.zeros((qc, Td), np.int32)
    dense_w = np.zeros((qc, Td), np.float32)
    for qi, dlist in enumerate(dense_l):
        for ti, (dr, w) in enumerate(dlist):
            dense_rows[qi, ti] = dr
            dense_w[qi, ti] = w
    return FusedPlan(rows, row_q, row_w, row_t, dense_rows, dense_w, k, ts)


def _fused_pipeline(
    fa,  # device dict: tier32 [V, N] f32, hi/lo [V, N] bf16, live [N], post_*
    avgdl,  # 0-dim f32 tensor on the device (None without norms)
    rows, row_q, row_w, row_t, dense_rows, dense_w,
    *,
    k, ts, n, has_norms, k1, b, t,
):
    """One fused chunk on the device -> (scores [Qc, k] f32, docids [Qc, k]
    i32, totals [Qc] i32, flagged [Qc] bool)."""
    qc = dense_rows.shape[0]
    tier = fa["tier32"]
    V = tier.shape[0]
    njc = -(-n // TILE_N)
    _, db, _ = _key_bits(njc * TILE_N, 1, qc)

    # phase A: gather CSR block rows, per-posting partial scores
    rl = rows.long()
    docids = fa["post_docids"][rl]  # [R, BLOCK]
    tfs = fa["post_tfs"][rl]
    if has_norms:
        dls = fa["post_dls"][rl]
        denom = tfs + k1 * (1.0 - b + b * dls / avgdl)
    else:
        denom = tfs + k1
    parts = row_w[:, None] * tfs / denom  # [R, BLOCK]; pad lanes -> 0

    # window entries sorted by (query, docid); padding lanes (docid >= n)
    # take the sentinel and fall outside every window
    key = torch.where(docids >= n, SENTINEL, (row_q[:, None] << db) | docids)
    skey, order = torch.sort(key.reshape(-1), stable=True)
    sval = parts.reshape(-1)[order]
    bounds = ((torch.arange(qc, dtype=torch.int32, device=skey.device)[:, None] << db)
              | (torch.arange(njc + 1, dtype=torch.int32, device=skey.device)[None, :]
                 * TILE_N))
    ptr = torch.searchsorted(skey, bounds.reshape(-1)).to(torch.int32).reshape(qc, njc + 1)

    # dense query weights as the JAX package builds W (a query's duplicate
    # dense terms add up), cut to bf16, then one entry per distinct row
    W = (torch.nn.functional.one_hot(dense_rows.long(), V).to(torch.float32)
         * dense_w[:, :, None]).sum(dim=1)
    Wh = _mask_hi(W)
    drows = torch.sort(dense_rows, dim=1).values
    first = torch.ones_like(drows, dtype=torch.bool)
    first[:, 1:] = drows[:, 1:] != drows[:, :-1]
    dwh = torch.where(first, Wh.gather(1, drows.long()), 0.0)

    cv, ci, totals, wlost = fused_tile_candidates(
        fa["hi"], fa["lo"], fa["live"], drows.contiguous(), dwh.contiguous(),
        skey.contiguous(), sval.contiguous(), ptr, t=t, db=db)

    # global top-K' over the per-tile candidates: a value top-k with a
    # 16-deep margin, then the exact (score desc, docid asc) order within
    # it. torch.topk orders ties arbitrarily, which is harmless: unless
    # tie_clip is set, every candidate at or above the K'-th value lies
    # inside the margin, so the exact order within the margin is the exact
    # order of all candidates; tie_clip (a tie cluster at the K'-th value
    # running past the margin) flags the query.
    kb_eff = min(KB, cv.shape[1])
    m_eff = min(kb_eff + 16, cv.shape[1])
    mv, sel = torch.topk(cv, m_eff, dim=1)
    mi = ci.gather(1, sel)
    kv, ki = rank_topk(mv, mi, kb_eff)
    cand_ok = kv > float("-inf")
    vstar = kv[:, kb_eff - 1: kb_eff]
    n_at_vstar = (cv == vstar).sum(dim=1)
    n_in_margin = (mv == vstar).sum(dim=1)
    tie_clip = torch.isfinite(vstar[:, 0]) & (n_at_vstar > n_in_margin)

    # saturation: a tile that holds >= t of the K' winners may have dropped
    # entries that also belonged among them
    tiles = torch.div(ki, TILE_N, rounding_mode="floor")
    same_tile = ((tiles[:, :, None] == tiles[:, None, :])
                 & cand_ok[:, :, None] & cand_ok[:, None, :])
    sat = (cand_ok & (same_tile.sum(dim=2) >= t)).any(dim=1) | tie_clip

    # canonical rescore, final ranking, safety test
    resc = canonical_rescore(tier, dense_rows, dense_w, row_q, row_t, docids, parts,
                             ki, cand_ok, ts)
    v, i = rank_topk(resc, ki, k)
    am_kernel = kv[:, -1]
    am_resc = torch.where(cand_ok, resc, float("inf")).min(dim=1).values
    rk = v[:, k - 1]
    bound = am_kernel + EPS_SPLIT * torch.abs(am_kernel)
    safe = torch.isneginf(am_kernel) | (rk > bound) | (rk == am_resc)
    return v, i, totals, wlost | sat | ~safe


class FusedTermSearcher:
    """Batched `_msearch` over one shard pack through the fused kernel.

    Wraps a BatchTermSearcher for its scoring settings, its split-bf16 tier
    copies and as the escalation target: chunks query batches to QC rows;
    flagged queries re-run on the exact arm. Every chunk of a call comes
    back in one device-to-host copy (`ops/batched.fetch`)."""

    def __init__(self, bts):
        self.bts = bts
        self.searcher = bts.searcher
        # fused queries and chunks, escalation rounds and reruns of the
        # last call
        self.last_stats: dict = {}

    @staticmethod
    def usable(pack, k) -> bool:
        """A dense tier, 0 < k <= 16, and a pack between 4,096 docs and the
        window key's docid budget."""
        return (pack.dense_tfn is not None and 0 < k <= 16
                and 4 * FINE_N <= pack.num_docs <= MAX_DOCS_FUSED)

    def _arrays(self) -> dict:
        """The device arrays of the pipeline: the f32 tier, the split-bf16
        copies the tiered arm already holds, live docs and the postings."""
        dev = self.searcher.dev
        tiers = self.bts._tiered_extras()
        return {"tier32": dev["dense_tfn"], "hi": tiers["dense_hi"], "lo": tiers["dense_lo"],
                "live": dev["live"], "post_docids": dev["post_docids"],
                "post_tfs": dev["post_tfs"], "post_dls": dev["post_dls"]}

    def _dispatch_batch(self, fld, queries, k) -> list[tuple]:
        """Plan and launch every chunk of a batch without copying anything
        back -> per chunk the device outputs of `_fused_pipeline`. A chunk is
        planned while the previous one runs on the card."""
        pack = self.searcher.pack
        n = pack.num_docs
        sc = self.bts._scoring(fld)
        fa = self._arrays()
        put = self.bts._put
        t = tile_t_for(-(-n // TILE_N))
        outs = []
        for s in range(0, len(queries), QC):
            chunk = queries[s: s + QC]
            p = plan_fused(pack, fld, chunk, k, qc=len(chunk))
            outs.append(_fused_pipeline(
                fa, sc["avgdl"], put(p.rows), put(p.row_q), put(p.row_w), put(p.row_t),
                put(p.dense_rows), put(p.dense_w), k=k, ts=p.ts, n=n,
                has_norms=sc["has_norms"], k1=sc["k1"], b=sc["b"], t=t))
        return outs

    def _cost_fields(self, queries_n: int) -> dict:
        """Shape fields of one fused pass for the cost model
        (`monitoring.costmodel`): the dense tier's rows, the docs padded to
        whole tiles and the queries padded to whole chunks."""
        pack = self.searcher.pack
        V = pack.dense_tfn.shape[0] if pack.dense_tfn is not None else 0
        n_pad = -(-pack.num_docs // TILE_N) * TILE_N
        return {"v": V, "num_docs": n_pad, "queries": -(-queries_n // QC) * QC}

    def msearch_many(self, fld, batches, k=10) -> list[tuple]:
        """Every batch's chunks are launched before any result is copied
        back, then all come back in one copy. -> per batch the msearch
        tuple, escalation included. The launches and the copy are timed as
        `fused.pallas_scan`."""
        from ..telemetry import time_kernel
        from .batched import fetch

        with time_kernel("fused.pallas_scan", self.searcher.device, tier="fused", k=k,
                         **self._cost_fields(sum(map(len, batches)))):
            outs = [self._dispatch_batch(fld, qs, k) for qs in batches]
            hosts = fetch(outs)
        stats = {"queries": {"fused": sum(map(len, batches))},
                 "chunks": {"fused": sum(map(len, outs))}, "rounds": 0, "escalated": 0}
        results = [self._finish(fld, qs, k, host, stats)
                   for qs, host in zip(batches, hosts)]
        self.last_stats = stats
        return results

    def msearch(self, fld, queries, k=10):
        """-> (scores [Q, k], docids [Q, k], totals [Q] exact, first_pass_ok
        [Q]) numpy, in input order. The top k is always the canonical f32
        ranking: flagged queries re-run on the exact arm."""
        return self.msearch_many(fld, [queries], k)[0]

    def _finish(self, fld, queries, k, host, stats):
        """One batch's host rows, its flagged queries escalated (timed as
        `batched.escalation`)."""
        from ..telemetry import profile_event, time_kernel
        from .batched import fetch

        Q = len(queries)
        if not Q:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int64),
                    np.zeros((0,), np.int64), np.ones((0,), bool))
        scores, ids, totals, flagged = host
        ids, totals = ids.astype(np.int64), totals.astype(np.int64)
        if flagged.any():
            still = np.nonzero(flagged)[0]
            flagged_qs = [queries[i] for i in still]
            pack = self.searcher.pack
            sparse = [[t for t, _ in q if pack.dense_row_of(fld, t) is None]
                      for q in flagged_qs]
            max_ts = max(map(len, sparse), default=1)
            max_b = max((pack.term_blocks(fld, t)[1] for q in sparse for t in q), default=1)
            plan = self.bts.plan(fld, flagged_qs, k,
                                 pad_ts=1 << (max(max_ts, 4) - 1).bit_length(),
                                 pad_b=max(32, 1 << (max(max_b, 1) - 1).bit_length()))
            profile_event("tier", tier="exact_escalation", queries=len(still))
            with time_kernel("batched.escalation", self.searcher.device,
                             tier="exact_escalation", queries=len(still), k=k,
                             num_docs=pack.num_docs):
                sv, si, st = fetch([self.bts.run(fld, plan)])[0]
            scores[still, : sv.shape[1]] = sv
            ids[still, : sv.shape[1]] = si
            totals[still] = st
            stats["rounds"] = 1
            stats["escalated"] += len(still)
        return scores, ids, totals, ~flagged


def rank_topk(values: torch.Tensor, ids: torch.Tensor, k: int):
    """(score desc, docid asc) exact order via one int64 rank-key top-k.
    values must be >= 0 or -inf: non-negative IEEE f32 bit patterns order
    like their values as int32, and -inf sorts below them all. Equal keys
    are equal (value, id) pairs, so the order among them is immaterial.
    -> (values [Q, k], ids [Q, k])."""
    score_bits = values.contiguous().view(torch.int32).to(torch.int64)
    rank = (score_bits << 32) + (0xFFFFFFFF - ids.to(torch.int64))
    _, sel = torch.topk(rank, k, dim=1)
    return values.gather(1, sel), ids.gather(1, sel)
