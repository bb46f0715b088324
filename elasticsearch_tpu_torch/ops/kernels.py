"""The scan + top-k kernel of the scoring hot loop.

`scan_topk` is the counterpart of the JAX package's `ops/kernels.scan_topk`
(Pallas `_scan_topk_kernel`). Per query row it scores every doc lane, in
one of two modes, and keeps the top k by (score desc, docid asc) together
with an exact match count:

  - matmul mode: q [B, D] against mat_t [D, N] — dense-tier BM25 rows and
    exact kNN scans;
  - streamed mode: precomputed scores [B, N] — the selection behind every
    per-query search (`ops/scoring.top_k_with_total`).

On a CUDA tensor it launches the hand-written kernel of
`csrc/scan_topk.cu`, or raises. On a CPU tensor it runs the PyTorch twin
`scan_topk_reference`, which spells out the kernel's arithmetic operation
for operation: dot products summed d = 0 .. D-1 from 0.0 with separate
multiplies and adds, then `_apply_transform` in the JAX package's order, so
kernel and twin agree bit for bit on the same card.

`launch_counts["scan_topk"]` counts kernel launches, so a run can show
which work went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

MAX_FUSED_K = 128  # the kernel's largest k; larger k selects by sort
TRANSFORMS = ("identity", "cosine", "dot_product", "l2_norm", "max_inner_product")

launch_counts = {"scan_topk": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _apply_transform(dots, transform, auxd_row, auxq_col):
    """Map raw dots to _score space (the JAX package's ops/vector.py
    conventions), operation for operation as the reference orders them."""
    if transform == "identity":
        return dots
    if transform == "cosine":
        # auxd = 1/||d||, auxq = 1/||q||
        return (1.0 + dots * auxd_row[None, :] * auxq_col) / 2.0
    if transform == "dot_product":
        return (1.0 + dots) / 2.0
    if transform == "l2_norm":
        # auxd = ||d||^2, auxq = ||q||^2
        l2 = torch.clamp(auxd_row[None, :] - 2.0 * dots + auxq_col, min=0.0)
        return 1.0 / (1.0 + l2)
    if transform == "max_inner_product":
        return torch.where(dots < 0, 1.0 / (1.0 - dots), dots + 1.0)
    raise ValueError(f"unknown transform [{transform}]")


def _sequential_dots(q: torch.Tensor, mat_t: torch.Tensor) -> torch.Tensor:
    """q @ mat_t in full f32, summed d = 0 .. D-1 from 0.0 with a separate
    rounding per multiply and per add — the kernel's order."""
    B, N = q.shape[0], mat_t.shape[1]
    dots = torch.zeros((B, N), dtype=torch.float32, device=mat_t.device)
    prod = torch.empty_like(dots)
    for d in range(q.shape[1]):
        torch.mul(q[:, d: d + 1], mat_t[d: d + 1, :], out=prod)
        dots.add_(prod)
    return dots


def _select_topk(scores: torch.Tensor, k: int):
    """Top k of each row by (score desc, docid asc): a stable descending
    sort keeps the lower docid first among equal scores (Lucene's
    TopScoreDocCollector order, `_merge_topk` of the JAX package)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def scan_topk_reference(
    q: torch.Tensor | None,
    mat_t: torch.Tensor,
    live: torch.Tensor,
    k: int,
    *,
    transform: str = "identity",
    aux_doc: torch.Tensor,
    aux_q: torch.Tensor,
    count_positive: bool = True,
):
    """Plain PyTorch version of the kernel, on any device."""
    dots = mat_t if q is None else _sequential_dots(q, mat_t)
    scores = _apply_transform(dots, transform, aux_doc, aux_q[:, None])
    ok = live > 0
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=mat_t.device)
    scores = torch.where(ok[None, :] & ~torch.isnan(scores), scores, neg_inf)
    if count_positive:
        # BM25 match semantics: score <= 0 means no matching term
        scores = torch.where(scores > 0, scores, neg_inf)
        totals = (scores > 0).sum(dim=1, dtype=torch.int32)
    else:
        totals = ok.sum(dtype=torch.int32).expand(scores.shape[0]).contiguous()
    top_v, top_i = _select_topk(scores, k)
    return top_v, top_i, totals


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"scan_topk: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"scan_topk: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"scan_topk: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"scan_topk: {name} must be contiguous")


def _ptr(t: torch.Tensor | None):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launcher():
    """-> (the C launch function with its ctypes signature, CHUNK)."""
    from ._build import load

    lib = load("scan_topk")
    fn = lib.scan_topk_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)
        lib.scan_topk_chunk.restype = ctypes.c_int
        lib.scan_topk_chunk.argtypes = []
    return fn, lib.scan_topk_chunk()


def _scan_topk_cuda(q, mat_t, live, k, transform, aux_doc, aux_q, count_positive):
    dev = mat_t.device
    B = q.shape[0] if q is not None else mat_t.shape[0]
    N = mat_t.shape[1]
    D = q.shape[1] if q is not None else 0
    if k > MAX_FUSED_K:
        raise ValueError(f"scan_topk: k={k} exceeds the kernel's {MAX_FUSED_K}")
    if N >= 2**31 or B >= 2**31:
        raise ValueError("scan_topk: docids and rows must fit int32")
    if live.dtype != torch.bool:
        raise ValueError(f"scan_topk: live must be bool on CUDA, got {live.dtype}")
    if q is not None:
        _check("q", q, torch.float32, (B, D), dev)
        _check("mat_t", mat_t, torch.float32, (D, N), dev)
    else:
        _check("scores", mat_t, torch.float32, (B, N), dev)
    _check("live", live, torch.bool, (N,), dev)
    if aux_doc is not None:
        _check("aux_doc", aux_doc, torch.float32, (N,), dev)
    if aux_q is not None:
        _check("aux_q", aux_q, torch.float32, (B,), dev)

    fn, chunk = _launcher()
    nchunks = -(-N // chunk)
    cand = torch.empty((B, nchunks, k), dtype=torch.int64, device=dev)
    partial = torch.empty((B, nchunks), dtype=torch.int32, device=dev)
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_t = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_ptr(q), _ptr(mat_t), _ptr(live), _ptr(aux_doc), _ptr(aux_q),
                B, D, N, k, TRANSFORMS.index(transform), int(count_positive),
                _ptr(cand), _ptr(partial), _ptr(out_v), _ptr(out_i), _ptr(out_t),
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"scan_topk kernel launch failed: CUDA error {rc}")
    launch_counts["scan_topk"] += 1
    return out_v, out_i, out_t


def scan_topk(
    q: torch.Tensor | None,  # [B, D] f32, or None (streamed mode)
    mat_t: torch.Tensor,  # [D, N] f32 (matmul mode) | [B, N] scores (streamed)
    live: torch.Tensor,  # [N] bool mask
    k: int,
    *,
    transform: str = "identity",
    aux_doc: torch.Tensor | None = None,  # [N] per-doc transform input
    aux_q: torch.Tensor | None = None,  # [B] per-query transform input
    count_positive: bool = True,
):
    """-> (top_v [B, k] f32, top_i [B, k] i32, totals [B] i32).

    totals counts `score > 0 & live` when count_positive (BM25 match
    semantics: all term weights > 0), else live lanes (kNN candidate
    counts). Dead lanes carry -inf; their ids are those of the lowest
    dead docids."""
    if transform not in TRANSFORMS:
        raise ValueError(f"unknown transform [{transform}]")
    B = q.shape[0] if q is not None else mat_t.shape[0]
    N = mat_t.shape[1]
    k = max(1, min(k, N))
    dev = mat_t.device
    if dev.type != "cpu":
        # the kernel reads a missing aux input as zeros
        return _scan_topk_cuda(q, mat_t, live, k, transform, aux_doc, aux_q,
                               count_positive)
    if aux_doc is None:
        aux_doc = torch.zeros(N, dtype=torch.float32)
    if aux_q is None:
        aux_q = torch.zeros(B, dtype=torch.float32)
    return scan_topk_reference(
            q, mat_t, live, k, transform=transform, aux_doc=aux_doc,
            aux_q=aux_q, count_positive=count_positive)
