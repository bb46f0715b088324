"""int8 scalar quantization: per-vector scale/offset.

The JAX package's `ann/quantize.py`, kept here as the port's own copy (the
port imports nothing of that package). Each vector v stores codes c in
[-127, 127] with

    v ~= scale * c + offset,   offset = (min(v) + max(v)) / 2,
                               scale  = (max(v) - min(v)) / 254

so the worst per-component error is scale/2, bounded by the vector's own
range. The dot product against a query q dequantizes as

    q . v ~= scale * (q . c) + offset * sum(q)

which is the int8 tier of the ANN gather-scan. The f32 rescore of the
survivors removes this error from every returned score; it only decides
which candidates survive selection (recall, not precision).
"""

from __future__ import annotations

import numpy as np

_QMAX = 127.0
_QLEVELS = 254.0


def scalar_quantize_int8(vecs: np.ndarray):
    """[M, D] f32 -> (codes int8 [M, D], scale f32 [M], offset f32 [M]).
    All-constant vectors (max == min) get scale 0 and an exact offset."""
    vecs = np.asarray(vecs, np.float32)
    vmin = vecs.min(axis=-1)
    vmax = vecs.max(axis=-1)
    offset = (vmin + vmax) / 2.0
    scale = (vmax - vmin) / _QLEVELS
    safe = np.where(scale > 0, scale, 1.0)
    codes = np.rint((vecs - offset[..., None]) / safe[..., None])
    codes = np.clip(codes, -_QMAX, _QMAX).astype(np.int8)
    return codes, scale.astype(np.float32), offset.astype(np.float32)


def dequantize_int8(codes: np.ndarray, scale: np.ndarray,
                    offset: np.ndarray) -> np.ndarray:
    """Inverse of scalar_quantize_int8 (lossy): [M, D] f32."""
    return (codes.astype(np.float32) * np.asarray(scale)[..., None]
            + np.asarray(offset)[..., None])


def quantization_error_bound(scale: np.ndarray, qvec: np.ndarray) -> float:
    """Worst-case |q.v - q.v~| over vectors with the given scales."""
    return float(np.max(scale) / 2.0 * np.abs(np.asarray(qvec)).sum())
