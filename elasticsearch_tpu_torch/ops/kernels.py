"""The hand-written CUDA kernels of the scoring hot loops, with their twins.

Each public function is the counterpart of the JAX package's function of the
same name in `ops/kernels.py` (a Pallas kernel there). On a CUDA tensor it
launches the kernel of `csrc/<name>.cu`, or raises; on a CPU tensor it runs
its plain PyTorch twin `<name>_reference`, which spells out the kernel's
arithmetic operation for operation, so kernel and twin agree bit for bit on
the same card.

  - `scan_topk` (Pallas `_scan_topk_kernel`): per query row, score every doc
    lane, in matmul mode (q [B, D] against mat_t [D, N]: dense-tier BM25 rows
    and exact kNN scans) or streamed mode (precomputed scores [B, N]: the
    selection behind every per-query search and the dense top-k of the
    batched arms), and keep the top k by (score desc, docid asc) with an
    exact match count. Dot products sum d = 0 .. D-1 from 0.0 with separate
    multiplies and adds, then `_apply_transform` in the JAX package's order.
  - `tiered_candidates` (Pallas `_tiered_scan_kernel`): the same selection
    over split-bf16 scores, q cut to bf16 against the (hi, lo) halves of
    `split_bf16`, each half summed in f32, for the dense-only `_msearch` arm.
  - `impact_gather` (Pallas `_impact_gather_kernel`): gather impact-code
    block rows and their docids and scale each row by its dequant weight,
    for the impact arm of `_msearch`.

The fourth kernel, `fused_tile_candidates` (Pallas `_fused_kernel`), lives
beside its pipeline in `ops/fused.py`, and the fifth, `ann_gather_scan`
(Pallas `_ann_scan_kernel`), in `ann/kernels.py`, as in the JAX package;
they count their launches here and bind through `_launcher` like the others.

`launch_counts[name]` counts kernel launches, so a run can show which work
went through each kernel.
"""

from __future__ import annotations

import ctypes

import torch

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


# C signatures of the launch functions: (argtypes, name of the int() query
# of the kernel's tile width)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "scan_topk": ([_P] * 5 + [_I, _I, _LL] + [_I] * 3 + [_P] * 6, "scan_topk_chunk"),
    "tiered_candidates": ([_P] * 6 + [_I, _I, _LL] + [_I] * 3 + [_P] * 6,
                          "tiered_candidates_chunk"),
    "impact_gather": ([_P, _I, _P, _P, _P, _I, _I, _P, _P, _P], "impact_gather_block"),
    "fused_tile_candidates": ([_P, _P, _LL, _P, _P, _I] + [_P] * 4 + [_I] * 4 + [_P] * 4,
                              "fused_tile_candidates_tile"),
    "ann_gather_scan": ([_P] * 10 + [_I] * 7 + [_P] * 6, "ann_gather_scan_chunk"),
}


def _launcher(name: str):
    """-> (the C launch function of csrc/<name>.cu with its ctypes
    signature, the kernel's tile width)."""
    from ._build import load

    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    argtypes, width_fn = _SIGNATURES[name]
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        getattr(lib, width_fn).restype = ctypes.c_int
        getattr(lib, width_fn).argtypes = []
    return fn, getattr(lib, width_fn)()


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
    else:
        _check("scan_topk", "scores", mat_t, torch.float32, (B, N), dev)
    _check_selection("scan_topk", live, aux_doc, aux_q, B, N, dev)

    fn, chunk = _launcher("scan_topk")
    nchunks = -(-N // chunk)
    cand = torch.empty((B, nchunks, k), dtype=torch.int64, device=dev)
    partial = torch.empty((B, nchunks), dtype=torch.int32, device=dev)
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_t = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(_ptr(q), _ptr(mat_t), _ptr(live), _ptr(aux_doc), _ptr(aux_q),
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
    qh = _mask_hi(q)
    fn, chunk = _launcher("tiered_candidates")
    nchunks = -(-N // chunk)
    cand = torch.empty((B, nchunks, kb), dtype=torch.int64, device=dev)
    partial = torch.empty((B, nchunks), dtype=torch.int32, device=dev)
    out_v = torch.empty((B, kb), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, kb), dtype=torch.int32, device=dev)
    out_t = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(_ptr(qh), _ptr(mat_hi), _ptr(mat_lo), _ptr(live), _ptr(aux_doc),
                _ptr(aux_q), B, D, N, kb, TRANSFORMS.index(transform),
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
