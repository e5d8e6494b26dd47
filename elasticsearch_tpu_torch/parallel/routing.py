"""Document routing: hash(_id) -> shard.

Ports the reference's routing scheme (ref: cluster/routing/OperationRouting.java:248,
IndexRouting — murmur3_x86_32 of the routing string modulo shard count). The
hash is reimplemented from the public MurmurHash3 spec so routing stays stable
across processes and languages.

The port's copy of elasticsearch_tpu/parallel/routing.py, as it is
(`CardinalityAgg` hashes with `murmur3_hash`).
"""

from __future__ import annotations


def murmur3_hash(data: str, seed: int = 0) -> int:
    """MurmurHash3 x86_32 over the UTF-8 bytes (public-domain algorithm)."""
    key = data.encode("utf-8")
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    length = len(key)
    rounded = length & ~3
    for i in range(0, rounded, 4):
        k = key[i] | (key[i + 1] << 8) | (key[i + 2] << 16) | (key[i + 3] << 24)
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = length & 3
    if tail >= 3:
        k ^= key[rounded + 2] << 16
    if tail >= 2:
        k ^= key[rounded + 1] << 8
    if tail >= 1:
        k ^= key[rounded]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def shard_for_id(doc_id: str, num_shards: int, routing: str | None = None) -> int:
    """Ref: IndexRouting.shardId — murmur3(routing or _id) % num_shards
    (the reference floor-mods the signed value; we hash to u32 so plain
    modulo is equivalent for distribution)."""
    return murmur3_hash(routing if routing is not None else doc_id) % num_shards
