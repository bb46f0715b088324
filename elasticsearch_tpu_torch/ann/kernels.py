"""The batched ANN gather-scan, with its twin, and the centroid probe.

Counterpart of the JAX package's `ann/kernels.py`. Query time is two
stages, both on the device:

  1. `centroid_topk`: the [B, D] @ [D, C] logits and the top nprobe
     partitions per query (lowest centroid index on ties);
  2. `ann_gather_scan`: for every (query, probed cluster) pair, score the
     cluster's [L, D] quantized tile (int8 codes with per-slot scale/offset,
     or the split-bf16 hi/lo pair), transform, mask pad slots and dead docs,
     and keep the top kb by (score desc, docid asc) with exact candidate
     counts. On a CUDA tensor it launches `csrc/ann_gather_scan.cu` (the
     Pallas `_ann_scan_kernel`), on a CPU tensor its twin
     `ann_gather_scan_reference`, which spells out the kernel's operations.

The route is decided by shape before any launch, as the JAX dispatcher's
`pallas_ok` decides it: kb <= MAX_FUSED_K goes to the kernel (or its twin
on the CPU); a larger kb, which the kernel's selection does not take, goes
to `_ann_scan_chunked`, the composition the JAX package's XLA arm computes
(gathered tiles, a batched f32 product, the transform and masks, a sort),
on either device. Nothing catches a failure.

Scores out of the scan are SELECTION scores: callers rescore the surviving
ids in f32 (`ann/search.py`, `query/nodes.py` KnnNode). `ann_candidates` is
the per-request form (the JAX package's `ann_candidates_traced`): probe and
scan at B = 1.
"""

from __future__ import annotations

import torch

from ..ops.kernels import (
    MAX_FUSED_K,
    TRANSFORMS,
    _apply_transform,
    _check,
    _launcher,
    _mask_hi,
    _ptr,
    _select_topk_by_id,
    _sequential_dots,
    _stream,
    launch_counts,
)

SCAN_TIERS = ("int8", "bf16")
_CHUNKED_BYTES = 128 * 1024 * 1024  # bound on one step's gathered f32 tiles


def slot_aux(sq_slots: torch.Tensor, similarity: str) -> torch.Tensor:
    """Per-slot transform aux from the packed squared norms (zeros when the
    transform needs none)."""
    if similarity == "cosine":
        return 1.0 / torch.clamp(torch.sqrt(sq_slots), min=1e-30)
    if similarity == "l2_norm":
        return sq_slots
    return torch.zeros_like(sq_slots)


def query_aux(qvecs: torch.Tensor, similarity: str) -> torch.Tensor:
    """Per-query transform aux [B] (ops/vector._aux_for's)."""
    qsq = torch.sum(qvecs * qvecs, dim=-1)
    if similarity == "cosine":
        return 1.0 / torch.clamp(torch.sqrt(qsq), min=1e-30)
    if similarity == "l2_norm":
        return qsq
    return torch.zeros_like(qsq)


def slot_live(order: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """[C, L] uint8: the slot holds a doc and the doc is live."""
    return ((order >= 0) & live[torch.clamp(order, min=0).long()]).to(torch.uint8)


def centroid_topk(centroids: torch.Tensor, qvecs: torch.Tensor, *, nprobe: int) -> torch.Tensor:
    """-> probe ids [B, nprobe] int32: the nprobe nearest partitions per
    query (argmin ||q - c||^2 == argmax q.c - ||c||^2/2, the k-means
    metric), by logit descending with the lowest index on ties (a stable
    sort; torch.topk documents no order among ties)."""
    logits = qvecs @ centroids.T - 0.5 * torch.sum(centroids * centroids, dim=-1)[None, :]
    order = torch.sort(logits, dim=1, descending=True, stable=True)[1]
    return order[:, : min(nprobe, centroids.shape[0])].to(torch.int32).contiguous()


def _prepare(qvecs, ann_dev, tier, similarity):
    """The inputs kernel and twin share, computed once on the query's
    device: the scan's query rows (q for int8, q cut to bf16 for bf16) and
    the transform aux."""
    if tier not in SCAN_TIERS:
        raise ValueError(f"unknown ANN scan tier [{tier}]")
    if similarity not in TRANSFORMS:
        raise ValueError(f"unknown transform [{similarity}]")
    q = qvecs.to(torch.float32).contiguous()
    q_in = q if tier == "int8" else _mask_hi(q)
    return (q_in, slot_aux(ann_dev["sq"], similarity).contiguous(),
            query_aux(q, similarity).contiguous())


def _twin(q_in, probes, ann_dev, live_slots, auxd, auxq, kb, tier, similarity):
    B, D = q_in.shape
    P = probes.shape[1]
    order = ann_dev["order"]
    L = order.shape[1]
    pl = probes.long()
    dots = torch.zeros((B, P, L), dtype=torch.float32, device=q_in.device)
    prod = torch.empty_like(dots)
    if tier == "int8":
        codes = ann_dev["codes"]
        # sum_d q, d = 0 .. D-1 from 0.0, as each kernel block sums it
        qsum = _sequential_dots(q_in, torch.ones((D, 1), dtype=torch.float32,
                                                 device=q_in.device))[:, 0]
        for d in range(D):  # d = 0 .. D-1 from 0.0, a rounding per op
            torch.mul(q_in[:, d, None, None], codes[:, :, d][pl].to(torch.float32), out=prod)
            dots.add_(prod)
        dots = ann_dev["scale"][pl] * dots + ann_dev["offset"][pl] * qsum[:, None, None]
    else:
        lo_dots = torch.zeros_like(dots)
        for d in range(D):  # hi/lo x qh products are exact in f32
            torch.mul(q_in[:, d, None, None], ann_dev["hi"][:, :, d][pl].to(torch.float32),
                      out=prod)
            dots.add_(prod)
            torch.mul(q_in[:, d, None, None], ann_dev["lo"][:, :, d][pl].to(torch.float32),
                      out=prod)
            lo_dots.add_(prod)
        dots = dots + lo_dots
    return _finish(dots.reshape(B, P * L), pl, order, live_slots, auxd, auxq, kb, similarity)


def _finish(dots, pl, order, live_slots, auxd, auxq, kb, similarity):
    """Transform, masks, counts and the (score desc, docid asc) top kb of
    the [B, P*L] slot dots of the probed tiles pl [B, P]."""
    B = dots.shape[0]
    ids = order[pl].reshape(B, -1)
    scores = _apply_transform(dots, similarity, auxd[pl].reshape(B, -1), auxq[:, None])
    ok = (ids >= 0) & (live_slots[pl].reshape(B, -1) != 0)
    scores = torch.where(ok, scores, torch.full_like(scores, float("-inf")))
    totals = ok.sum(dim=1, dtype=torch.int32)
    v, i = _select_topk_by_id(scores, ids, kb)
    return v, i, totals


def ann_gather_scan_reference(qvecs, probes, ann_dev, live_slots, kb: int, *,
                              tier: str = "int8", similarity: str = "cosine"):
    """Plain PyTorch version of the kernel, on any device: the same
    arguments and outputs as `ann_gather_scan`, with the int8 dot summed
    d = 0 .. D-1 from 0.0 (a rounding per multiply and per add), the bf16
    hi and lo dots each summed so and added, then the kernel's transform,
    masks and order."""
    kb = max(1, min(kb, probes.shape[1] * ann_dev["order"].shape[1]))
    q_in, auxd, auxq = _prepare(qvecs, ann_dev, tier, similarity)
    return _twin(q_in, probes, ann_dev, live_slots, auxd, auxq, kb, tier, similarity)


def _ann_scan_chunked(q_in, probes, ann_dev, live_slots, auxd, auxq, kb, tier, similarity):
    """kb > MAX_FUSED_K: the composition of the JAX package's XLA arm
    (`_ann_scan_chunked`), in query steps that bound the gathered [b, P, L,
    D] f32 tiles: a batched f32 product per tier, sum(q) by torch.sum, then
    the kernel's transform, masks and (score desc, docid asc) order."""
    B, D = q_in.shape
    P, L = probes.shape[1], ann_dev["order"].shape[1]
    step = max(1, min(B, _CHUNKED_BYTES // max(P * L * D * 4, 1)))
    outs = []
    for s in range(0, B, step):
        qc, pl = q_in[s: s + step], probes[s: s + step].long()
        b = qc.shape[0]
        if tier == "int8":
            dots = torch.einsum("bpld,bd->bpl", ann_dev["codes"][pl].to(torch.float32), qc)
            dots = (ann_dev["scale"][pl] * dots
                    + ann_dev["offset"][pl] * torch.sum(qc, dim=1)[:, None, None])
        else:
            dots = (torch.einsum("bpld,bd->bpl", ann_dev["hi"][pl].to(torch.float32), qc)
                    + torch.einsum("bpld,bd->bpl", ann_dev["lo"][pl].to(torch.float32), qc))
        outs.append(_finish(dots.reshape(b, P * L), pl, ann_dev["order"], live_slots, auxd,
                            auxq[s: s + step], kb, similarity))
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))


def _ann_gather_scan_cuda(q_in, probes, ann_dev, live_slots, auxd, auxq, kb, tier,
                          similarity):
    dev = q_in.device
    B, D = q_in.shape
    P = probes.shape[1]
    order = ann_dev["order"]
    C, L = order.shape
    if kb > MAX_FUSED_K:
        raise ValueError(f"ann_gather_scan: kb={kb} exceeds the kernel's {MAX_FUSED_K}")
    if B * P >= 2**31 or C * L >= 2**31:
        raise ValueError("ann_gather_scan: rows and slots must fit int32")
    _check("ann_gather_scan", "q", q_in, torch.float32, (B, D), dev)
    _check("ann_gather_scan", "probes", probes, torch.int32, (B, P), dev)
    _check("ann_gather_scan", "order", order, torch.int32, (C, L), dev)
    _check("ann_gather_scan", "live_slots", live_slots, torch.uint8, (C, L), dev)
    _check("ann_gather_scan", "auxd", auxd, torch.float32, (C, L), dev)
    _check("ann_gather_scan", "auxq", auxq, torch.float32, (B,), dev)
    if tier == "int8":
        ta, tb = ann_dev["codes"], None
        _check("ann_gather_scan", "codes", ta, torch.int8, (C, L, D), dev)
        for name in ("scale", "offset"):
            _check("ann_gather_scan", name, ann_dev[name], torch.float32, (C, L), dev)
        scale, offset = ann_dev["scale"], ann_dev["offset"]
    else:
        ta, tb = ann_dev["hi"], ann_dev["lo"]
        _check("ann_gather_scan", "hi", ta, torch.bfloat16, (C, L, D), dev)
        _check("ann_gather_scan", "lo", tb, torch.bfloat16, (C, L, D), dev)
        scale = offset = None
    fn, scratch_words = _launcher("ann_gather_scan")
    words = scratch_words(B, P, C, L, kb)
    if words < 0:
        raise ValueError(f"ann_gather_scan: B={B}, P={P}, L={L} exceed the kernel's scratch")
    scratch = torch.empty((max(words, 1),), dtype=torch.int64, device=dev)
    out_v = torch.empty((B, kb), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, kb), dtype=torch.int32, device=dev)
    out_t = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(_ptr(q_in), _ptr(probes), _ptr(ta), _ptr(tb), _ptr(scale),
                _ptr(offset), _ptr(auxd), _ptr(auxq), _ptr(order), _ptr(live_slots),
                B, D, P, C, L, kb, SCAN_TIERS.index(tier), TRANSFORMS.index(similarity),
                _ptr(scratch), _ptr(out_v), _ptr(out_i), _ptr(out_t), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"ann_gather_scan kernel launch failed: CUDA error {rc}")
    launch_counts["ann_gather_scan"] += 1
    return out_v, out_i, out_t


def ann_gather_scan(
    qvecs: torch.Tensor,  # [B, D] f32
    probes: torch.Tensor,  # [B, P] i32 (centroid_topk output), each in [0, C)
    ann_dev: dict,  # ann_to_device output
    live_slots: torch.Tensor,  # [C, L] uint8 (slot_live): holds a live doc
    kb: int,
    *,
    tier: str = "int8",
    similarity: str = "cosine",
):
    """-> (sel_v [B, kb] selection scores, sel_i [B, kb] docids, totals [B]
    live slots scanned). Ids on non-finite lanes are unspecified: callers
    mask with isfinite(sel_v). The kernel does not bound-check probe ids."""
    order = ann_dev["order"]
    kb = max(1, min(kb, probes.shape[1] * order.shape[1]))
    q_in, auxd, auxq = _prepare(qvecs, ann_dev, tier, similarity)
    if kb > MAX_FUSED_K:
        return _ann_scan_chunked(q_in, probes, ann_dev, live_slots, auxd, auxq, kb, tier,
                                 similarity)
    if qvecs.device.type == "cpu" and order.device.type == "cpu":
        return _twin(q_in, probes, ann_dev, live_slots, auxd, auxq, kb, tier, similarity)
    return _ann_gather_scan_cuda(q_in, probes, ann_dev, live_slots, auxd, auxq, kb, tier,
                                 similarity)


def ann_candidates(ann_dev: dict, qvec: torch.Tensor, live: torch.Tensor, kcand: int, *,
                   nprobe: int, tier: str, similarity: str):
    """Probe and scan for one query (the JAX package's
    `ann_candidates_traced`): centroid_topk at B = 1, then ann_gather_scan
    over the probed tiles with the live docs' slots. -> (cand_ids [kcand]
    i32, sel_scores [kcand], total i32). Among candidates tied at the kcand
    boundary the scan keeps the lower docid, the traced form the earlier
    slot."""
    probes = centroid_topk(ann_dev["centroids"], qvec[None, :], nprobe=nprobe)
    v, i, t = ann_gather_scan(qvec[None, :], probes, ann_dev,
                              slot_live(ann_dev["order"], live), kcand,
                              tier=tier, similarity=similarity)
    return i[0], v[0], t[0]
