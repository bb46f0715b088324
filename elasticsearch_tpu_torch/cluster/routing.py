"""Document -> shard routing: this package's copy of the JAX package's
`cluster/routing.py`, so that both place every id on the same shard.

The reference routes by Murmur3(routing_key) mod shards (reference
behavior: cluster/routing/IndexRouting.java:132, Murmur3HashFunction):
murmur3 x86 32-bit over the id's UTF-16-LE code units, floor-mod the
routing shard count, divided by the routing factor.
"""

from __future__ import annotations

import numpy as np


def _rotl32(x: int, r: int) -> int:
    x &= 0xFFFFFFFF
    return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86 32-bit, returns signed 32-bit int."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data)
    rounded = n - (n % 4)
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i: i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = _rotl32(k, 15)
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = _rotl32(k, 15)
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h - (1 << 32) if h >= (1 << 31) else h


def default_routing_num_shards(num_shards: int) -> int:
    """Routing shards default to num_shards * 2^k, the largest <= 1024, so
    an index can later be split (reference behavior:
    cluster/metadata/MetadataCreateIndexService routing-shard calculation)."""
    if num_shards >= 1024:
        return num_shards
    r = num_shards
    while r * 2 <= 1024:
        r *= 2
    return r


def shard_for_id(doc_id: str, num_shards: int, routing_num_shards: int | None = None) -> int:
    """The shard of `doc_id`: the hash of its UTF-16 code units, little
    endian (Murmur3HashFunction.hash(String)), then floorMod(hash,
    routing_num_shards) / routing_factor (IndexRouting.java:132)."""
    if routing_num_shards is None:
        routing_num_shards = default_routing_num_shards(num_shards)
    if routing_num_shards < num_shards or routing_num_shards % num_shards != 0:
        raise ValueError(
            f"routing_num_shards [{routing_num_shards}] must be a multiple of "
            f"num_shards [{num_shards}]"
        )
    routing_factor = routing_num_shards // num_shards
    h = murmur3_32(doc_id.encode("utf-16-le"))
    return (h % routing_num_shards) // routing_factor


_M32 = np.uint64(0xFFFFFFFF)


def _rotl32_np(x: np.ndarray, r: int) -> np.ndarray:
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _M32


def _murmur3_rows(data: np.ndarray) -> np.ndarray:
    """`murmur3_32` (seed 0, unsigned) of each row of a [n, L] uint8 array,
    in uint64 lanes masked to 32 bits (a product of two 32-bit values fits)."""
    c1, c2 = np.uint64(0xCC9E2D51), np.uint64(0x1B873593)
    n, L = data.shape
    h = np.zeros(n, np.uint64)
    rounded = L - L % 4
    if rounded:
        blocks = np.ascontiguousarray(data[:, :rounded]).view("<u4").astype(np.uint64)
        for j in range(blocks.shape[1]):
            k = (blocks[:, j] * c1) & _M32
            k = (_rotl32_np(k, 15) * c2) & _M32
            h = _rotl32_np(h ^ k, 13)
            h = (h * np.uint64(5) + np.uint64(0xE6546B64)) & _M32
    tail = data[:, rounded:].astype(np.uint64)
    if tail.shape[1]:
        k = np.zeros(n, np.uint64)
        for j in range(tail.shape[1] - 1, -1, -1):
            k ^= tail[:, j] << np.uint64(8 * j)
        k = (k * c1) & _M32
        k = (_rotl32_np(k, 15) * c2) & _M32
        h ^= k
    h ^= np.uint64(L)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & _M32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & _M32
    h ^= h >> np.uint64(16)
    return h


def shards_for_ids(doc_ids: list[str], num_shards: int) -> np.ndarray:
    """`shard_for_id` of many ids at once (int64 [n]): the ids grouped by
    their UTF-16 length, each group hashed as one [n, L] array."""
    routing_num_shards = default_routing_num_shards(num_shards)
    factor = routing_num_shards // num_shards
    enc = [d.encode("utf-16-le") for d in doc_ids]
    lens = np.fromiter(map(len, enc), np.int64, count=len(enc))
    out = np.empty(len(enc), np.int64)
    for L in np.unique(lens).tolist():
        sel = np.flatnonzero(lens == L)
        rows = np.frombuffer(b"".join([enc[i] for i in sel.tolist()]), np.uint8)
        h = _murmur3_rows(rows.reshape(len(sel), L)).astype(np.int64)
        h = np.where(h >= 1 << 31, h - (1 << 32), h)  # the signed value
        out[sel] = (h % routing_num_shards) // factor
    return out
