"""Lucene SmallFloat norm quantization (exact re-implementation).

BM25 parity requires reproducing how Lucene stores document length in a
single byte: values < 24 are exact, larger values keep a 4-bit mantissa
(reference behavior: Lucene 9 `SmallFloat.intToByte4`/`byte4ToInt`, used by
`BM25Similarity` — ES wires BM25 as the default at
server/.../index/similarity/SimilarityService.java:43-58). The scoring kernel
uses the *dequantized* length, so quantization here is what makes scores
bit-match a CPU Elasticsearch (SURVEY.md hard part #5).
"""

from __future__ import annotations

import numpy as np

# longToInt4(Integer.MAX_VALUE): numBits=31, shift=27, mantissa=(2^31-1)>>>27 & 7 = 7,
# encoded = 7 | (28<<3) = 231 -> NUM_FREE_VALUES = 255 - 231 = 24.
NUM_FREE_VALUES = 24


def long_to_int4(i: int) -> int:
    if i < 0:
        raise ValueError("only supports positive values")
    num_bits = i.bit_length()
    if num_bits < 4:
        return i
    shift = num_bits - 4
    encoded = (i >> shift) & 0x07
    encoded |= (shift + 1) << 3
    return encoded


def int4_to_long(i: int) -> int:
    bits = i & 0x07
    shift = (i >> 3) - 1
    if shift == -1:
        return bits
    return (bits | 0x08) << shift


def int_to_byte4(i: int) -> int:
    """Encode doc length -> unsigned byte (0..255)."""
    if i < 0:
        raise ValueError("only supports positive values")
    if i < NUM_FREE_VALUES:
        return i
    return NUM_FREE_VALUES + long_to_int4(i - NUM_FREE_VALUES)


def byte4_to_int(b: int) -> int:
    """Decode unsigned byte -> effective doc length used in scoring."""
    if b < NUM_FREE_VALUES:
        return b
    return NUM_FREE_VALUES + int4_to_long(b - NUM_FREE_VALUES)


# Decode table for all 256 byte values; device-side norm arrays store the
# already-dequantized float so kernels never branch.
DECODE_TABLE = np.array([byte4_to_int(b) for b in range(256)], dtype=np.float32)


def quantize_lengths(lengths: np.ndarray) -> np.ndarray:
    """Vectorized encode->decode: effective lengths after the 1-byte round
    trip. Encoding truncates, so the round trip maps x to the largest
    representable value <= x; DECODE_TABLE is monotone, so a searchsorted
    against it is exact."""
    idx = np.searchsorted(DECODE_TABLE, np.asarray(lengths, dtype=np.int64), side="right") - 1
    idx = np.clip(idx, 0, 255)
    return DECODE_TABLE[idx].astype(np.float32)
