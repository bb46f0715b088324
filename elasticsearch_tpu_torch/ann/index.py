"""Refresh-time ANN build: IVF partitions packed into padded cluster tiles.

Counterpart of the JAX package's `ann/index.py`. The k-means
(`ops/vector.kmeans_ivf`, on the device) assigns every present vector to a
partition; the ragged partitions then become the static-shape layout the
gather-scan reads:

    order     [C, L] int32   docids, cluster-major, -1 padding
    codes     [C, L, D] int8 scalar-quantized tier (per-slot scale/offset)
    scale     [C, L] float32
    offset    [C, L] float32
    centroids [C, D] float32

L (the tile length) is the largest partition rounded up to TILE_LANES = 128,
so every cluster is one [L, D] tile. The split-bf16 hi/lo tier and the
per-slot squared norms are derived from the f32 vectors at upload
(`ann_to_device`), so the host index stays int8-sized.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.torch_env import host_tensor, resolve_device
from .quantize import _QLEVELS, _QMAX

TILE_LANES = 128
_UPLOAD_BYTES = 1 << 30  # f32 tiles gathered per step of ann_to_device


class AnnBuildError(ValueError):
    pass


def _round_up(n: int, mult: int) -> int:
    return ((max(n, 1) + mult - 1) // mult) * mult


def ann_tiles(vectors, docids, assign, C: int, L: int, device=None):
    """Pack the partitions into tiles on `device` (None: the CUDA card,
    raising without one) -> (order [C, L] i32,
    codes [C, L, D] i8, scale [C, L] f32, offset [C, L] f32) numpy,
    byte-equal to the JAX package's host loop and `ann_tiles_device`: a
    stable sort by cluster gives each doc its rank in its tile, and each
    vector is quantized as `scalar_quantize_int8` does. The scale divides by
    254 as a tensor, so that no device folds it into a reciprocal multiply
    (one ulp off the host quantizer)."""
    dev = resolve_device(device)
    vec = host_tensor(vectors, np.float32, dev)
    ids = host_tensor(docids, np.int64, dev)
    a = host_tensor(assign, np.int64, dev)
    M = a.shape[0]
    by_cluster = torch.argsort(a, stable=True)
    a_sorted, ids_sorted = a[by_cluster], ids[by_cluster]
    sizes = torch.bincount(a, minlength=C)
    starts = torch.cumsum(sizes, 0) - sizes
    rank = torch.arange(M, device=dev) - starts[a_sorted]
    order = torch.full((C, L), -1, dtype=torch.int32, device=dev)
    order[a_sorted, rank] = ids_sorted.to(torch.int32)
    v = vec[ids_sorted]
    del vec
    vmin, vmax = v.amin(dim=-1), v.amax(dim=-1)
    offset = (vmin + vmax) / 2.0
    scale = (vmax - vmin) / torch.tensor(_QLEVELS, dtype=torch.float32, device=dev)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    v.sub_(offset[:, None]).div_(safe[:, None])
    codes = torch.clamp(torch.round(v), -_QMAX, _QMAX).to(torch.int8)
    del v
    codes_t = torch.zeros((C, L, codes.shape[1]), dtype=torch.int8, device=dev)
    codes_t[a_sorted, rank] = codes
    scale_t = torch.zeros((C, L), dtype=torch.float32, device=dev)
    scale_t[a_sorted, rank] = scale
    offset_t = torch.zeros((C, L), dtype=torch.float32, device=dev)
    offset_t[a_sorted, rank] = offset
    return tuple(t.cpu().numpy() for t in (order, codes_t, scale_t, offset_t))


def build_ann(vectors, has_value, nlist: int, device=None, timings: dict | None = None):
    """-> dict(centroids, order, codes, scale, offset, nlist, tile,
    built_n) of numpy arrays and ints, or None when the corpus is too
    small for partitioning to help (fewer than 4 * nlist vectors, or
    nlist <= 1). The k-means and the tile packing run on `device` (None:
    the CUDA card, raising without one);
    `timings`, when given, receives their seconds ("kmeans_s", "tiles_s")."""
    from ..ops.vector import kmeans_ivf

    vectors = np.asarray(vectors, np.float32)
    present = np.flatnonzero(has_value)
    if len(present) < 4 * max(nlist, 1) or nlist <= 1:
        return None
    from ..monitoring.refresh_profile import build_stage

    device = resolve_device(device)
    D = vectors.shape[1]
    t0 = time.perf_counter()
    with build_stage("build.kmeans", device, n=len(present), dims=D, nlist=max(nlist, 1),
                     iters=8, basis="device"):
        centroids, assign = kmeans_ivf(vectors[present], nlist, device=device)
    t1 = time.perf_counter()
    C = centroids.shape[0]
    L = _round_up(int(np.bincount(assign, minlength=C).max()), TILE_LANES)
    with build_stage("build.ann_tiles", device, nlist=C, tile=L, dims=D, basis="device"):
        order, codes, scale, offset = ann_tiles(vectors, present, assign, C, L, device=device)
    if timings is not None:
        timings.update(kmeans_s=t1 - t0, tiles_s=time.perf_counter() - t1)
    return {
        "centroids": centroids.astype(np.float32),
        "order": order,
        "codes": codes,
        "scale": scale,
        "offset": offset,
        "nlist": int(C),
        "tile": int(L),
        "built_n": int(vectors.shape[0]),
    }


def ann_to_device(ann: dict, values, device) -> dict:
    """Upload one ANN index. The split-bf16 hi/lo pair and the per-slot
    squared norms come from the f32 vectors `values` [N, D] (numpy, or a
    tensor already on `device`), gathered into [C, L, D] tiles with zeros in
    the pad slots, a few clusters at a time so that no f32 copy of all the
    tiles is ever held; they are stored nowhere on the host."""
    from ..ops.kernels import split_bf16

    dev = torch.device(device)

    def put(a, dtype):
        return host_tensor(a, dtype, dev)

    order = put(ann["order"], np.int32)
    vals = values.to(dev) if isinstance(values, torch.Tensor) else put(values, np.float32)
    C, L = order.shape
    D = vals.shape[1]
    hi = torch.empty((C, L, D), dtype=torch.bfloat16, device=dev)
    lo = torch.empty_like(hi)
    sq = torch.empty((C, L), dtype=torch.float32, device=dev)
    step = max(1, _UPLOAD_BYTES // max(L * D * 4, 1))
    for c in range(0, C, step):
        o = order[c: c + step]
        packed = vals[torch.clamp(o, min=0).long()]  # [step, L, D]
        packed[o < 0] = 0.0
        hi[c: c + step], lo[c: c + step] = split_bf16(packed)
        sq[c: c + step] = torch.sum(packed * packed, dim=-1)
    return {
        "centroids": put(ann["centroids"], np.float32),
        "order": order,
        "codes": put(ann["codes"], np.int8),
        "scale": put(ann["scale"], np.float32),
        "offset": put(ann["offset"], np.float32),
        "hi": hi,
        "lo": lo,
        "sq": sq,
    }
