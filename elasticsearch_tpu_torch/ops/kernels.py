"""The hand-written CUDA kernels of the scoring hot loops, with their twins.

Each public function is the counterpart of the JAX package's function of the
same name in `ops/kernels.py` (a Pallas kernel there). On a CUDA tensor it
launches the kernel of `csrc/<name>.cu`, or raises; on a CPU tensor it runs
its plain PyTorch twin `<name>_reference`, which spells out the kernel's
arithmetic operation for operation, so kernel and twin agree bit for bit on
the same card, with one exception: `tiered_candidates` computes its dots on
the tensor cores, which add in their own order, and is held to its twin by
`check_tiered_selection` within the f32 summation bound of its 2D terms.

  - `scan_topk` (Pallas `_scan_topk_kernel`): per query row, score every doc
    lane, in matmul mode (q [B, D] against mat_t [D, N]: dense-tier BM25 rows
    and exact kNN scans) or streamed mode (precomputed scores [B, N]: the
    selection behind every per-query search and the dense top-k of the
    batched arms), and keep the top k by (score desc, docid asc) with an
    exact match count. Dot products are one correctly rounded f32 fma per
    (lane, d), d = 0 .. D-1 from +0.0 (`_fma_dots`), then `_apply_transform`
    in the JAX package's order.
  - `tiered_candidates` (Pallas `_tiered_scan_kernel`): the same selection
    over split-bf16 scores, q cut to bf16 against the (hi, lo) halves of
    `split_bf16`, summed in f32, for the dense-only `_msearch` arm and the
    exact kNN arm; callers rescore its kb candidates in f32.
  - `impact_gather` (Pallas `_impact_gather_kernel`): gather impact-code
    block rows and their docids and scale each row by its dequant weight,
    for the impact arm of `_msearch`.

The fourth kernel, `fused_tile_candidates` (Pallas `_fused_kernel`), lives
beside its pipeline in `ops/fused.py`, and the fifth, `ann_gather_scan`
(Pallas `_ann_scan_kernel`), in `ann/kernels.py`, as in the JAX package;
they count their launches here and bind through `_launcher` like the others.

`launch_counts[name]` counts kernel launches, so a run can show which work
went through each kernel. While a `profile: true` request's collector is
active (`telemetry.collect_profile_events`), each `scan_topk` call, kernel
or twin, is one `kernel` event named `scan_topk`, shaped as
`telemetry.time_kernel` records its events.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from ..telemetry import profile_event, profiling_active

MAX_FUSED_K = 128  # the kernel's largest k; larger k selects by sort
TRANSFORMS = ("identity", "cosine", "dot_product", "l2_norm", "max_inner_product")

# tiered selection: the relative slack of split-bf16 selection scores
# against the f32 rescore (the query side is bf16-truncated, ~2^-9 per
# element, the matrix side carries ~15 mantissa bits), and the selection
# width carried to the rescore
EPS_TIERED = 2e-2
KB_TIERED = 64

launch_counts = {"scan_topk": 0, "tiered_candidates": 0, "impact_gather": 0,
                 "fused_tile_candidates": 0, "ann_gather_scan": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _apply_transform(dots, transform, auxd, auxq):
    """Map raw dots [B, M] to _score space (the JAX package's ops/vector.py
    conventions), operation for operation as the reference orders them.
    auxd broadcasts against dots ([M] per doc, or [B, M] per probed slot),
    auxq is [B, 1]."""
    if transform == "identity":
        return dots
    if transform == "cosine":
        # auxd = 1/||d||, auxq = 1/||q||
        return (1.0 + dots * auxd * auxq) / 2.0
    if transform == "dot_product":
        return (1.0 + dots) / 2.0
    if transform == "l2_norm":
        # auxd = ||d||^2, auxq = ||q||^2
        l2 = torch.clamp(auxd - 2.0 * dots + auxq, min=0.0)
        return 1.0 / (1.0 + l2)
    if transform == "max_inner_product":
        return torch.where(dots < 0, 1.0 / (1.0 - dots), dots + 1.0)
    raise ValueError(f"unknown transform [{transform}]")


def _sequential_dots(q: torch.Tensor, mat_t: torch.Tensor) -> torch.Tensor:
    """q @ mat_t in full f32, summed d = 0 .. D-1 from 0.0 with a separate
    rounding per multiply and per add — the kernel's order. A bf16 mat_t is
    widened exactly to f32 lane by lane."""
    B, N = q.shape[0], mat_t.shape[1]
    dots = torch.zeros((B, N), dtype=torch.float32, device=mat_t.device)
    prod = torch.empty_like(dots)
    for d in range(q.shape[1]):
        torch.mul(q[:, d: d + 1], mat_t[d: d + 1, :], out=prod)
        dots.add_(prod)
    return dots


# lanes of one column step of `_fma_dots` (its f64 temporaries are a few
# of [B, step])
_FMA_LANES = 1 << 24
# an f64 sum lies exactly halfway between two f32 values (in f32's normal
# range) when its 29 significand bits below f32's precision are 1, then 0s
_LOW29, _HALF29 = (1 << 29) - 1, 1 << 28
_F32_TINY = 2.0 ** -126  # f32's smallest normal


def _fma_dots(q: torch.Tensor, mat_t: torch.Tensor) -> torch.Tensor:
    """q @ mat_t as the matmul kernel computes it: per lane acc =
    fma(q[r, d], m[d, n], acc) for d = 0 .. D-1 from +0.0, each fma rounded
    once to f32 (round to nearest even). Each fma is computed in f64: the
    f32 x f32 product is exact there, and the sum s = p + acc rounds once.
    Cast to f32, s rounds as the exact sum does, unless s lies exactly
    halfway between two f32 values, or in f32's subnormal range; on those
    few lanes TwoSum gives the addition's error, and a sum with an error
    and an even last bit steps one ulp toward the error (round to odd,
    53 >= 24 + 2 bits) before the cast. q [B, D] f32, mat_t [D, N] f32 ->
    [B, N] f32, on the tensors' device, in column steps of `_FMA_LANES`
    lanes."""
    B, D = q.shape
    N = mat_t.shape[1]
    dev = mat_t.device
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    q64 = q.double()
    step = max(1, _FMA_LANES // max(B, 1))
    for c0 in range(0, N, step):
        m64 = mat_t[:, c0: c0 + step].double()
        a = torch.zeros((B, m64.shape[1]), dtype=torch.float32, device=dev)
        p = torch.empty(a.shape, dtype=torch.float64, device=dev)
        s = torch.empty_like(p)
        bits = s.view(torch.int64)
        for d in range(D):
            torch.mul(q64[:, d: d + 1], m64[d: d + 1, :], out=p)  # exact
            torch.add(p, a, out=s)
            near = ((bits & _LOW29) == _HALF29) | (s.abs() < _F32_TINY)
            if near.any():
                i = near.nonzero(as_tuple=True)
                pi, ai, si = p[i], a[i].double(), s[i]
                t = si - pi
                e = (pi - (si - t)) + (ai - t)  # TwoSum: si + e == pi + ai
                # an inexact finite sum whose last bit is even steps one ulp
                # toward its error (magnitude up where the error has the
                # sum's sign); a NaN error marks an infinite sum
                odd = (e != 0) & (e == e) & ((si.view(torch.int64) & 1) == 0)
                si.view(torch.int64).add_(odd * torch.where((e > 0) == (si > 0), 1, -1))
                s[i] = si
            a.copy_(s)
        out[:, c0: c0 + step] = a
    return out


def _select_topk(scores: torch.Tensor, k: int):
    """Top k of each row by (score desc, docid asc): a stable descending
    sort keeps the lower docid first among equal scores (Lucene's
    TopScoreDocCollector order, `_merge_topk` of the JAX package)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def _select_topk_by_id(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top k of each row by (score desc, id asc) where the lanes carry ids
    of their own: a stable sort by id, then a stable descending sort by
    score. NaN ranks as -inf, as in the kernels' order key. -> (values
    [B, k], ids [B, k] i32)."""
    scores = torch.where(torch.isnan(scores), torch.full_like(scores, float("-inf")), scores)
    by_id = torch.argsort(ids, dim=1, stable=True)
    scores, ids = scores.gather(1, by_id), ids.gather(1, by_id)
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), ids.gather(1, pos)[:, :k].to(torch.int32).contiguous()


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
    dots = mat_t if q is None else _fma_dots(q, mat_t)
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


def _check(kernel: str, name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _ptr(t: torch.Tensor | None):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check_selection(kernel, live, aux_doc, aux_q, B, N, dev) -> None:
    """The inputs a two-pass selection kernel shares: mask and aux rows."""
    if live.dtype != torch.bool:
        raise ValueError(f"{kernel}: live must be bool on CUDA, got {live.dtype}")
    _check(kernel, "live", live, torch.bool, (N,), dev)
    if aux_doc is not None:
        _check(kernel, "aux_doc", aux_doc, torch.float32, (N,), dev)
    if aux_q is not None:
        _check(kernel, "aux_q", aux_q, torch.float32, (B,), dev)


# C signatures of the launch functions: (argtypes, name of the kernel's
# geometry query, the query's argtypes)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "scan_topk": ([_P] * 5 + [_I, _I, _LL] + [_I] * 3 + [_P] * 6, "scan_topk_spans",
                  [_I, _LL, _I]),
    "tiered_candidates": ([_P] * 6 + [_I, _I, _I, _LL] + [_I] * 3 + [_P] * 6,
                          "tiered_candidates_spans", [_I, _LL]),
    "impact_gather": ([_P, _I, _P, _P, _P, _I, _I, _P, _P, _P], "impact_gather_block", []),
    "fused_tile_candidates": ([_P, _P, _LL, _P, _P, _I] + [_P] * 4 + [_I] * 5 + [_P] * 4,
                              "fused_tile_candidates_tile", []),
    "ann_gather_scan": ([_P] * 10 + [_I] * 8 + [_P] * 5, "ann_gather_scan_scratch", [_I] * 5),
}


def _launcher(name: str):
    """-> (the C launch function of csrc/<name>.cu with its ctypes
    signature, the kernel's geometry: its tile width, or for a query that
    takes the shape (the pass-1 spans per row, the scratch words) the bound
    query itself)."""
    from ._build import load

    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    argtypes, query_name, query_args = _SIGNATURES[name]
    query = getattr(lib, query_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        query.restype = ctypes.c_int
        query.argtypes = query_args
    return fn, (query if query_args else query())


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _scan_topk_cuda(q, mat_t, live, k, transform, aux_doc, aux_q, count_positive):
    dev = mat_t.device
    B = q.shape[0] if q is not None else mat_t.shape[0]
    N = mat_t.shape[1]
    D = q.shape[1] if q is not None else 0
    if k > MAX_FUSED_K:
        raise ValueError(f"scan_topk: k={k} exceeds the kernel's {MAX_FUSED_K}")
    if N >= 2**31 or B >= 2**31:
        raise ValueError("scan_topk: docids and rows must fit int32")
    if q is not None:
        _check("scan_topk", "q", q, torch.float32, (B, D), dev)
        _check("scan_topk", "mat_t", mat_t, torch.float32, (D, N), dev)
        if D == 0:
            raise ValueError("scan_topk: q has no columns")
    else:
        _check("scan_topk", "scores", mat_t, torch.float32, (B, N), dev)
    _check_selection("scan_topk", live, aux_doc, aux_q, B, N, dev)
    from ._build import load

    fn, spans = _launcher("scan_topk")
    qt = None
    if q is not None:
        # the kernel's query tiles: q transposed, zero-padded to whole tiles
        lib = load("scan_topk")
        depth, rows = lib.scan_topk_depth(), lib.scan_topk_rows()
        qt = torch.zeros((-(-D // depth) * depth, -(-B // rows) * rows),
                         dtype=torch.float32, device=dev)
        qt[:D, :B] = q.t()
    with torch.cuda.device(dev):  # the matmul spans follow the card's SM count
        nspans = spans(B, N, int(q is not None))
    cand = torch.empty((B, nspans, k), dtype=torch.int64, device=dev)
    partial = torch.empty((B, nspans), dtype=torch.int32, device=dev)
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_t = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(_ptr(qt), _ptr(mat_t), _ptr(live), _ptr(aux_doc), _ptr(aux_q),
                B, D, N, k, TRANSFORMS.index(transform), int(count_positive),
                _ptr(cand), _ptr(partial), _ptr(out_v), _ptr(out_i), _ptr(out_t),
                _stream(dev))
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
    dead docids. On zero docs (an empty tier) or zero rows the route is
    chosen by shape before any launch: no lanes and totals of 0."""
    if transform not in TRANSFORMS:
        raise ValueError(f"unknown transform [{transform}]")
    B = q.shape[0] if q is not None else mat_t.shape[0]
    N = mat_t.shape[1]
    dev = mat_t.device
    if N == 0 or B == 0:  # no lanes, no launch
        return (torch.empty((B, 0), dtype=torch.float32, device=dev),
                torch.empty((B, 0), dtype=torch.int32, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev))
    k = max(1, min(k, N))
    if not profiling_active():
        return _scan_topk_route(q, mat_t, live, k, transform, aux_doc, aux_q, count_positive)
    # a `profile: true` request: one kernel event per selection, timed to
    # the card's completion (not a `time_kernel` window: those feed the
    # cost model and the planner, whose names are the reference's)
    t0 = time.perf_counter()
    out = _scan_topk_route(q, mat_t, live, k, transform, aux_doc, aux_q, count_positive)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    profile_event("kernel", kernel="scan_topk", ms=round((time.perf_counter() - t0) * 1e3, 4),
                  queries=B, k=k, num_docs=N)
    return out


def _scan_topk_route(q, mat_t, live, k, transform, aux_doc, aux_q, count_positive):
    """`scan_topk` past its shape checks: the kernel on a CUDA tensor, the
    twin on the CPU."""
    if mat_t.device.type != "cpu":
        # the kernel reads a missing aux input as zeros
        return _scan_topk_cuda(q, mat_t, live, k, transform, aux_doc, aux_q, count_positive)
    B = q.shape[0] if q is not None else mat_t.shape[0]
    return scan_topk_reference(
        q, mat_t, live, k, transform=transform,
        aux_doc=torch.zeros(mat_t.shape[1], dtype=torch.float32) if aux_doc is None else aux_doc,
        aux_q=torch.zeros(B, dtype=torch.float32) if aux_q is None else aux_q,
        count_positive=count_positive)


# ---------------------------------------------------------------------------
# tiered selection: split-bf16 scores, for the dense-only `_msearch` arm
# ---------------------------------------------------------------------------


def _mask_hi(t: torch.Tensor) -> torch.Tensor:
    """Truncate f32 to its top 16 bits (exactly bf16-representable) by
    integer masking: the JAX package's `_mask_hi`, whose reason is that a
    cast round-trip may be folded away by a compiler."""
    return (t.contiguous().view(torch.int32) & -65536).view(torch.float32)


def split_bf16(mat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 matrix -> (hi, lo) bf16 pair carrying ~15 mantissa bits: hi =
    the masked top 16 bits, lo = the exact residual rounded to bf16 (round
    to nearest even, as XLA's convert)."""
    hif = _mask_hi(mat)
    return hif.to(torch.bfloat16), (mat - hif).to(torch.bfloat16)


def tiered_candidates_reference(
    q: torch.Tensor,
    mat_hi: torch.Tensor,
    mat_lo: torch.Tensor,
    live: torch.Tensor,
    kb: int,
    *,
    transform: str = "identity",
    aux_doc: torch.Tensor,
    aux_q: torch.Tensor,
    count_positive: bool = True,
):
    """Plain PyTorch version of the tiered kernel, on any device: q cut to
    bf16, the hi and lo dots each summed d = 0 .. D-1 from 0.0, added, then
    the transform, the masks and the (score desc, docid asc) top kb."""
    qh = _mask_hi(q)
    dots = _sequential_dots(qh, mat_hi)
    dots.add_(_sequential_dots(qh, mat_lo))
    return scan_topk_reference(None, dots, live, kb, transform=transform,
                               aux_doc=aux_doc, aux_q=aux_q,
                               count_positive=count_positive)


def _tiered_candidates_cuda(q, mat_hi, mat_lo, live, kb, transform, aux_doc,
                            aux_q, count_positive):
    dev = mat_hi.device
    B, D = q.shape
    N = mat_hi.shape[1]
    if kb > MAX_FUSED_K:
        raise ValueError(f"tiered_candidates: kb={kb} exceeds the kernel's {MAX_FUSED_K}")
    if N >= 2**31 or B >= 2**31:
        raise ValueError("tiered_candidates: docids and rows must fit int32")
    _check("tiered_candidates", "q", q, torch.float32, (B, D), dev)
    _check("tiered_candidates", "mat_hi", mat_hi, torch.bfloat16, (D, N), dev)
    _check("tiered_candidates", "mat_lo", mat_lo, torch.bfloat16, (D, N), dev)
    _check_selection("tiered_candidates", live, aux_doc, aux_q, B, N, dev)
    from ._build import load

    fn, spans = _launcher("tiered_candidates")
    depth = load("tiered_candidates").tiered_candidates_depth()
    # the query cut to bf16 (exact: _mask_hi leaves bf16 values), its
    # columns zero-padded to the kernel's depth step
    qh = torch.zeros((B, -(-D // depth) * depth), dtype=torch.bfloat16, device=dev)
    qh[:, :D] = _mask_hi(q)
    with torch.cuda.device(dev):  # the spans follow the card's SM count
        nspans = spans(B, N)
    cand = torch.empty((B, nspans, kb), dtype=torch.int64, device=dev)
    partial = torch.empty((B, nspans), dtype=torch.int32, device=dev)
    out_v = torch.empty((B, kb), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, kb), dtype=torch.int32, device=dev)
    out_t = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(_ptr(qh), _ptr(mat_hi), _ptr(mat_lo), _ptr(live), _ptr(aux_doc),
                _ptr(aux_q), B, D, qh.shape[1], N, kb, TRANSFORMS.index(transform),
                int(count_positive), _ptr(cand), _ptr(partial), _ptr(out_v),
                _ptr(out_i), _ptr(out_t), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"tiered_candidates kernel launch failed: CUDA error {rc}")
    launch_counts["tiered_candidates"] += 1
    return out_v, out_i, out_t


def tiered_candidates(
    q: torch.Tensor,  # [B, D] f32 query rows (weights / query vectors)
    mat_hi: torch.Tensor,  # [D, N] bf16 hi tier (split_bf16)
    mat_lo: torch.Tensor,  # [D, N] bf16 lo tier
    live: torch.Tensor,  # [N] bool mask
    kb: int,
    *,
    transform: str = "identity",
    aux_doc: torch.Tensor | None = None,  # [N] per-doc transform input
    aux_q: torch.Tensor | None = None,  # [B] per-query transform input
    count_positive: bool = True,
):
    """Tiered selection pass -> (sel_v [B, kb], sel_i [B, kb] i32,
    totals [B] i32).

    sel_v are SELECTION scores (split-bf16, within ~EPS_TIERED of f32):
    callers rescore the sel_i candidates in f32 and apply the margin test
    before treating the ranking as exact. totals are exact (live counts, or
    positive counts: every BM25 product is >= 0, so the sign survives the
    split)."""
    if transform not in TRANSFORMS:
        raise ValueError(f"unknown transform [{transform}]")
    B, N = q.shape[0], mat_hi.shape[1]
    kb = max(1, min(kb, N))
    if mat_hi.device.type != "cpu":
        return _tiered_candidates_cuda(q, mat_hi, mat_lo, live, kb, transform,
                                       aux_doc, aux_q, count_positive)
    if aux_doc is None:
        aux_doc = torch.zeros(N, dtype=torch.float32)
    if aux_q is None:
        aux_q = torch.zeros(B, dtype=torch.float32)
    return tiered_candidates_reference(
        q, mat_hi, mat_lo, live, kb, transform=transform, aux_doc=aux_doc,
        aux_q=aux_q, count_positive=count_positive)


# the tensor cores' summation bound: 2D f32 additions of exact products,
# doubled because they align addends by truncation
_TC_ULPS_PER_D = 4.0 * 2.0 ** -24
# the transform's own rounding when its input moves: a few ulps of the score
_TRANSFORM_REL = 2.0 ** -22


def tiered_lanes(q, mat_hi, mat_lo, ids, *, transform="identity", aux_doc=None,
                 aux_q=None, live=None, count_positive=False):
    """The twin's selection scores at given lanes, and the tensor-core
    tolerance of each. ids [B, m] -> (scores [B, m] f32, bit for bit what
    `tiered_candidates_reference` gives those lanes; bound [B, m] f64 in
    score space: 4·D·2^-24·Σ_d |qh_d|·(|hi_dn| + |lo_dn|) times the
    transform's slope, plus 2^-22·|score| for its rounding)."""
    B, D = q.shape
    N = mat_hi.shape[1]
    dev = mat_hi.device
    idx = ids.long().clamp(0, N - 1)
    qh = _mask_hi(q)
    hq, lq = (torch.zeros(idx.shape, dtype=torch.float32, device=dev) for _ in range(2))
    sig = torch.zeros(idx.shape, dtype=torch.float64, device=dev)
    prod = torch.empty_like(hq)
    for d in range(D):
        h, l_ = mat_hi[d][idx], mat_lo[d][idx]
        qd = qh[:, d: d + 1]
        torch.mul(qd, h, out=prod)
        hq.add_(prod)
        torch.mul(qd, l_, out=prod)
        lq.add_(prod)
        sig.add_(qd.double().abs() * (h.double().abs() + l_.double().abs()))
    dots = hq.add_(lq)
    auxd = (torch.zeros(idx.shape, device=dev) if aux_doc is None else aux_doc[idx])
    auxq = (torch.zeros((B, 1), device=dev) if aux_q is None else aux_q[:, None])
    scores = _apply_transform(dots, transform, auxd, auxq)
    slope = {"identity": 1.0, "dot_product": 0.5, "l2_norm": 2.0,
             "max_inner_product": 1.0}.get(transform)
    if slope is None:  # cosine
        slope = (auxd.double() * auxq.double()).abs() / 2.0
    bound = slope * (_TC_ULPS_PER_D * D) * sig
    bound = bound + _TRANSFORM_REL * scores.double().abs().nan_to_num(0.0, 0.0, 0.0)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    ok = torch.ones(idx.shape, dtype=torch.bool, device=dev) if live is None else live[idx]
    scores = torch.where(ok & ~torch.isnan(scores), scores, neg_inf)
    if count_positive:
        scores = torch.where(scores > 0, scores, neg_inf)
    return scores, bound


def check_tiered_selection(got, want, q, mat_hi, mat_lo, live, *, transform="identity",
                           aux_doc=None, aux_q=None, count_positive=True) -> float:
    """Hold a `tiered_candidates` result (the tensor-core kernel's) to its
    twin's (`want`, from `tiered_candidates_reference` on the same inputs)
    within the tensor cores' summation bound (`tiered_lanes`). Raises
    AssertionError unless:
      - totals are equal;
      - the same positions are finite (the finite lanes of a row are as
        many; their set is exact: the live mask and the sign of a
        non-negative product do not depend on the summation order);
      - each finite returned score is within the bound of the twin's score
        for that id, and ids are distinct within a row;
      - the returned ids are the twin's, except lanes whose twin score lies
        within the bound of the twin's kb-th score (their own bound plus
        the row's largest, since either side of a swap may err);
      - each row is ordered by (returned score desc, id asc).
    -> (the largest |err| / bound, the largest |err|) over the finite
    returned lanes."""
    gv, gi, gt = got
    wv, wi, wt = want
    kw = {"transform": transform, "aux_doc": aux_doc, "aux_q": aux_q, "live": live,
          "count_positive": count_positive}
    tg, bg = tiered_lanes(q, mat_hi, mat_lo, gi, **kw)
    tw, bw = tiered_lanes(q, mat_hi, mat_lo, wi, **kw)
    gv, gi, gt, wv, wi, wt, tg, bg, tw, bw = (
        x.cpu().numpy() for x in (gv, gi, gt, wv, wi, wt, tg, bg, tw, bw))
    if not np.array_equal(gt, wt):
        raise AssertionError(f"tiered: totals differ {gt[:4]} vs {wt[:4]}")
    fin = np.isfinite(wv)
    if not np.array_equal(np.isfinite(gv), fin):
        raise AssertionError("tiered: finite lanes differ")
    if not np.isfinite(tg[fin]).all():
        raise AssertionError("tiered: a returned finite lane is masked in the twin")
    err = np.abs(gv[fin].astype(np.float64) - tg[fin])
    bnd = bg[fin]
    if (err > bnd).any():
        j = int(np.argmax(err - bnd))
        raise AssertionError(f"tiered: a score is {err[j]:.3g} from the twin's, bound {bnd[j]:.3g}")
    worst = float(np.max(np.where(bnd > 0, err / np.where(bnd > 0, bnd, 1.0), 0.0), initial=0.0))
    max_abs = float(np.max(err, initial=0.0))
    for r in range(gv.shape[0]):
        f = fin[r]
        n = int(f.sum())
        if len(set(gi[r].tolist())) != gi.shape[1]:
            raise AssertionError(f"tiered: row {r} repeats an id")
        if n == 0:
            continue
        gs, ws = set(gi[r, f].tolist()), set(wi[r, f].tolist())
        kth = float(tw[r, n - 1])
        row_tol = max(float(bg[r, f].max()), float(bw[r, f].max()))
        lanes = {int(i): (float(t), float(b)) for i, t, b in zip(gi[r, f], tg[r, f], bg[r, f])}
        lanes.update({int(i): (float(t), float(b)) for i, t, b in zip(wi[r, f], tw[r, f], bw[r, f])})
        for i in gs ^ ws:
            t, b = lanes[i]
            if abs(t - kth) > b + row_tol:
                raise AssertionError(f"tiered: row {r} swaps id {i} (twin score {t}) at the "
                                     f"kb-th score {kth} beyond the bound {b + row_tol:.3g}")
        v, i_ = gv[r, f], gi[r, f]
        if not ((v[:-1] > v[1:]) | ((v[:-1] == v[1:]) & (i_[:-1] < i_[1:]))).all():
            raise AssertionError(f"tiered: row {r} is not ordered by (score desc, id asc)")
    return worst, max_abs


# ---------------------------------------------------------------------------
# impact-tier gather: the sparse arm of the batched disjunction
# ---------------------------------------------------------------------------


def impact_gather_reference(codes, docids, rows, row_w):
    """Plain PyTorch version of the impact gather, on any device. uint16
    codes are read through an int16 view (few uint16 ops exist on CUDA)."""
    Q, R = rows.shape
    block = codes.shape[1]
    r = rows.long()
    if codes.dtype == torch.uint16:
        lanes = (codes.view(torch.int16)[r].to(torch.int32) & 0xFFFF).to(torch.float32)
    else:
        lanes = codes[r].to(torch.float32)
    scores = row_w[:, :, None] * lanes
    return docids[r].reshape(Q, R * block), scores.reshape(Q, R * block)


_CODE_BYTES = {torch.uint16: 2, torch.int8: 1}


def _impact_gather_cuda(codes, docids, rows, row_w):
    dev = codes.device
    Q, R = rows.shape
    nb, block = codes.shape
    if codes.dtype not in _CODE_BYTES:
        raise ValueError(f"impact_gather: codes must be uint16 or int8, got {codes.dtype}")
    _check("impact_gather", "codes", codes, codes.dtype, (nb, block), dev)
    _check("impact_gather", "docids", docids, torch.int32, (nb, block), dev)
    _check("impact_gather", "rows", rows, torch.int32, (Q, R), dev)
    _check("impact_gather", "row_w", row_w, torch.float32, (Q, R), dev)
    if Q > 65535:
        raise ValueError(f"impact_gather: Q={Q} exceeds the kernel's 65535 rows")
    fn, width = _launcher("impact_gather")
    if block != width:
        raise ValueError(f"impact_gather: blocks of {block} lanes, the kernel takes {width}")
    ids = torch.empty((Q, R * block), dtype=torch.int32, device=dev)
    scores = torch.empty((Q, R * block), dtype=torch.float32, device=dev)
    if Q * R == 0:
        return ids, scores
    with torch.cuda.device(dev):
        rc = fn(_ptr(codes), _CODE_BYTES[codes.dtype], _ptr(docids), _ptr(rows),
                _ptr(row_w), Q, R, _ptr(ids), _ptr(scores), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"impact_gather kernel launch failed: CUDA error {rc}")
    launch_counts["impact_gather"] += 1
    return ids, scores


def impact_gather(
    codes: torch.Tensor,  # [num_blocks, BLOCK] uint16 | int8 impact codes
    docids: torch.Tensor,  # [num_blocks, BLOCK] i32 (pad: num_docs)
    rows: torch.Tensor,  # [Q, R] i32 flat block rows (0-padded, row 0 dead)
    row_w: torch.Tensor,  # [Q, R] f32 dequant weight (boost·idf·ubf/qmax)
):
    """-> (ids [Q, R·BLOCK] i32, scores [Q, R·BLOCK] f32): the flattened
    per-lane candidates of a batch of impact-tier disjunctions. Padding rows
    (row 0, weight 0) give docid num_docs at score 0. Every row id must lie
    in [0, num_blocks): the kernel does not bound-check it."""
    if codes.device.type != "cpu":
        return _impact_gather_cuda(codes, docids, rows, row_w)
    return impact_gather_reference(codes, docids, rows, row_w)
