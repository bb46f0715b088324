"""Dense-vector similarity scoring, exact kNN scans and the IVF k-means.

The counterpart of the JAX package's `ops/vector.py` (reference behavior:
index/mapper/vectors/DenseVectorFieldMapper.java similarity functions;
search/vectors/KnnVectorQueryBuilder.java). Score functions follow the
reference's `_score` conventions:

    cosine:             (1 + cos(q, d)) / 2
    dot_product:        (1 + q . d) / 2
    l2_norm:            1 / (1 + ||q - d||^2)
    max_inner_product:  d<0 -> 1/(1-d), else d+1

`TieredKnnScanner` is bench.py config C4's exact arm: a split-bf16 selection
scan through the `tiered_candidates` kernel, an f32 rescore of the survivors
and a margin test whose flagged queries rerun on the `scan_topk` kernel in
matmul mode; given an ANN index it promotes to `ann.AnnSearcher`.
`kmeans_ivf` trains the IVF partitions of the ANN index on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..telemetry import time_kernel
from ..utils.torch_env import host_tensor, resolve_device
from .kernels import (
    EPS_TIERED,
    KB_TIERED,
    _apply_transform,
    _select_topk_by_id,
    scan_topk,
    split_bf16,
    tiered_candidates,
)

_KNN_EPS = EPS_TIERED  # selection-vs-rescore relative margin
_ASSIGN_ROWS = 1 << 16  # rows per k-means assignment / sum step
KMEANS_ITERS = 8


def _aux_for(similarity: str, sq_norms: torch.Tensor, qvecs: torch.Tensor):
    """(aux_doc [N], aux_q [B]) per the kernels' transform contract."""
    if similarity == "cosine":
        aux_doc = 1.0 / torch.clamp(torch.sqrt(sq_norms), min=1e-30)
        aux_q = 1.0 / torch.clamp(torch.sqrt(torch.sum(qvecs * qvecs, dim=1)), min=1e-30)
        return aux_doc, aux_q
    if similarity == "l2_norm":
        return sq_norms, torch.sum(qvecs * qvecs, dim=1)
    return None, None


def _rescore_knn(qvecs, vectors, cand_i, cand_ok, aux_doc, aux_q, similarity: str):
    """Exact f32 scores of the selection candidates [B, KB]: a row gather
    of the candidate vectors and one batched f32 product (the JAX package
    leaves this einsum to XLA), then the shared transform; -inf where
    cand_ok is False."""
    safe = torch.clamp(cand_i.long(), min=0)
    dots = torch.bmm(vectors[safe], qvecs[:, :, None])[:, :, 0]  # [B, KB]
    scores = _apply_transform(dots, similarity,
                              None if aux_doc is None else aux_doc[safe],
                              None if aux_q is None else aux_q[:, None])
    return torch.where(cand_ok, scores, torch.full_like(scores, float("-inf")))


def _exact_rows(resc, ids, ok, k: int):
    """The rows in exact (score desc, docid asc) order over the ok lanes."""
    return _select_topk_by_id(torch.where(ok, resc, torch.full_like(resc, float("-inf"))),
                              ids, k)


def _fetch_rows(v: torch.Tensor, i: torch.Tensor, *ints: torch.Tensor):
    """One device-to-host copy of a batch's rows: values [B, k] f32, ids
    [B, k] and per-row integers, packed as int32 words. -> numpy (v, i,
    *ints), writable."""
    B, k = v.shape
    host = torch.cat([v.reshape(-1).view(torch.int32), i.reshape(-1).to(torch.int32),
                      *(x.to(torch.int32) for x in ints)]).cpu().numpy()
    n = B * k
    out = [host[:n].view(np.float32).reshape(B, k), host[n: 2 * n].reshape(B, k)]
    out += [host[2 * n + j * B: 2 * n + (j + 1) * B] for j in range(len(ints))]
    return out


class TieredKnnScanner:
    """Exact kNN through the split-bf16 `tiered_candidates` kernel: a
    top-KB selection per query, an f32 rescore of the survivors, a
    (score desc, docid asc) re-rank, and a margin test; queries whose top k
    cannot be separated from anything the selection could have dropped rerun
    on the f32 `scan_topk` matmul scan, so results are always exact. Given
    an ANN index (`ann.build_ann` output) the scan promotes to
    `ann.AnnSearcher`."""

    def __init__(self, vectors, sq_norms, similarity: str, live=None,
                 kb: int | None = None, ann: dict | None = None, device=None):
        self.device = resolve_device(device)
        self.similarity = similarity
        self.vectors = host_tensor(vectors, np.float32, self.device)
        self.sq_norms = host_tensor(sq_norms, np.float32, self.device)
        N = self.vectors.shape[0]
        self.live = (torch.ones(N, dtype=torch.bool, device=self.device) if live is None
                     else host_tensor(live, np.bool_, self.device))
        self.kb = kb or KB_TIERED
        self.mat_t = self.vectors.T.contiguous()  # [D, N], the exact rerun's operand
        self.mat_hi, self.mat_lo = split_bf16(self.mat_t)
        self.ann = None
        if ann is not None:
            from ..ann import AnnSearcher

            self.ann = AnnSearcher(ann, self.vectors, self.sq_norms, similarity,
                                   live=self.live, device=self.device)

    def search(self, qvecs, k: int, *, nprobe: int | None = None,
               num_candidates: int | None = None):
        """-> (scores [B, k], ids [B, k], totals [B], first_pass_ok [B])
        numpy; exact (flagged queries rerun on the f32 scan). With an ANN
        index the candidate SET is approximate and first_pass_ok all True."""
        if self.ann is not None:
            v, i, t = self.ann.search(qvecs, k, nprobe=nprobe, num_candidates=num_candidates)
            return v, i, t, np.ones(v.shape[0], bool)
        q = host_tensor(qvecs, np.float32, self.device)
        B, D = q.shape
        N = self.vectors.shape[0]
        kb = max(self.kb, k)
        # the window spans the launches through the copy back
        with time_kernel("vector.knn_tiered", self.device, tier="fused", queries=B, dims=D,
                         num_docs=N, kb=kb, k=k):
            aux_doc, aux_q = _aux_for(self.similarity, self.sq_norms, q)
            sel_v, sel_i, totals = tiered_candidates(
                q, self.mat_hi, self.mat_lo, self.live, kb, transform=self.similarity,
                aux_doc=aux_doc, aux_q=aux_q, count_positive=False)
            cand_ok = torch.isfinite(sel_v)
            resc = _rescore_knn(q, self.vectors, sel_i, cand_ok, aux_doc, aux_q, self.similarity)
            v, i = _exact_rows(resc, sel_i, cand_ok, k)
            # margin: the k-th rescored score must clear everything the
            # selection could have dropped (the kb-th selection score inflated
            # by the split error), or the selection kept every candidate
            # (empty kb-th lane, or the k-th score is the rescored minimum)
            sel_kb = sel_v[:, -1]
            am_resc = torch.min(torch.where(cand_ok, resc, torch.full_like(resc, float("inf"))),
                                dim=1)[0]
            rk = v[:, k - 1]
            bound = sel_kb + _KNN_EPS * torch.abs(sel_kb) + 1e-6
            safe = torch.isneginf(sel_kb) | (rk > bound) | (rk == am_resc)
            v, i, totals, safe = _fetch_rows(v, i, totals, safe)
        safe = safe.astype(bool)
        if not safe.all():
            rows = np.nonzero(~safe)[0]
            flagged = torch.from_numpy(rows).to(self.device)
            with time_kernel("vector.knn_scan", self.device, tier="exact_escalation",
                             queries=len(rows), dims=D, num_docs=N, k=k):
                fv, fi, _ = scan_topk(
                    q[flagged], self.mat_t, self.live, k, transform=self.similarity,
                    aux_doc=aux_doc, aux_q=None if aux_q is None else aux_q[flagged],
                    count_positive=False)
                v[rows] = fv.cpu().numpy()
                i[rows] = fi.cpu().numpy()
        return v, i, totals, safe


def knn_scores(vectors: torch.Tensor, sq_norms: torch.Tensor, qvec: torch.Tensor,
               similarity: str) -> torch.Tensor:
    """-> [N] f32 similarity scores of every row against one query."""
    dots = vectors @ qvec
    if similarity == "cosine":
        qn = torch.sqrt(torch.sum(qvec * qvec))
        dn = torch.sqrt(sq_norms)
        cos = dots / torch.clamp(dn * qn, min=1e-30)
        return (1.0 + cos) / 2.0
    if similarity == "dot_product":
        return (1.0 + dots) / 2.0
    if similarity == "l2_norm":
        qsq = torch.sum(qvec * qvec)
        l2sq = torch.clamp(sq_norms - 2.0 * dots + qsq, min=0.0)
        return 1.0 / (1.0 + l2sq)
    if similarity == "max_inner_product":
        return torch.where(dots < 0, 1.0 / (1.0 - dots), dots + 1.0)
    raise ValueError(f"unknown similarity [{similarity}]")


def _assign(vecs: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """argmin ||v - c||^2 == argmax v.c - ||c||^2 / 2, the first index on
    ties; in row steps so the [rows, C] logits stay bounded."""
    half = 0.5 * torch.sum(cents * cents, dim=1)[None, :]
    return torch.cat([torch.argmax(vecs[s: s + _ASSIGN_ROWS] @ cents.T - half, dim=1)
                      for s in range(0, vecs.shape[0], _ASSIGN_ROWS)])


def _cluster_sums(vecs: torch.Tensor, assign: torch.Tensor, C: int) -> torch.Tensor:
    """Per-cluster f32 sums of the rows, in a fixed order on every run: one
    one-hot [C, rows] @ [rows, D] product per row step, the steps added in
    order. (`index_add_` on CUDA floats adds with atomics, whose order, and
    so whose rounding, changes from run to run.)"""
    sums = torch.zeros((C, vecs.shape[1]), dtype=torch.float32, device=vecs.device)
    for s in range(0, vecs.shape[0], _ASSIGN_ROWS):
        a = assign[s: s + _ASSIGN_ROWS]
        onehot = torch.zeros((C, a.shape[0]), dtype=torch.float32, device=vecs.device)
        onehot[a, torch.arange(a.shape[0], device=vecs.device)] = 1.0
        sums += onehot @ vecs[s: s + _ASSIGN_ROWS]
    return sums


def kmeans_ivf(vectors, nlist: int, device=None):
    """Lloyd k-means for the IVF partition index, on `device` (None: the
    CUDA card, raising without one) as one eager
    loop: the JAX package's `index/device_build.kmeans_device` at its
    defaults. Strided init `arange(C) * (N // C)`; assignment by
    argmax(v.c - ||c||^2/2) with the first index on ties; empty clusters
    keep their centroid; the loop stops after KMEANS_ITERS iterations or at
    an exact fixed point (largest squared centroid shift 0). Deterministic:
    two runs on the same card give the same bytes.

    -> (centroids [C, D] f32, assign [N] int32) numpy."""
    vecs = host_tensor(vectors, np.float32, resolve_device(device))
    N = vecs.shape[0]
    C = max(1, min(nlist, N))
    cents = vecs[torch.arange(C, device=vecs.device) * (N // C)].clone()
    for _ in range(KMEANS_ITERS):
        assign = _assign(vecs, cents)
        sums = _cluster_sums(vecs, assign, C)
        counts = torch.bincount(assign, minlength=C).to(torch.float32)[:, None]
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), cents)
        shift = float(torch.max(torch.sum((new - cents) ** 2, dim=1)))
        cents = new
        if shift <= 0.0:
            break
    assign = _assign(vecs, cents)
    return cents.cpu().numpy(), assign.to(torch.int32).cpu().numpy()
