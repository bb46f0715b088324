"""Document -> shard routing: this package's copy of the JAX package's
`cluster/routing.py`, so that both place every id on the same shard.

The reference routes by Murmur3(routing_key) mod shards (reference
behavior: cluster/routing/IndexRouting.java:132, Murmur3HashFunction):
murmur3 x86 32-bit over the id's UTF-16-LE code units, floor-mod the
routing shard count, divided by the routing factor.
"""

from __future__ import annotations


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
