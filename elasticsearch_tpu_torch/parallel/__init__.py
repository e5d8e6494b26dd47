"""Device serving engines and their Hopper kernels.

Exports the counterparts of the reference package's `__all__` but for
`make_mesh`: the port has no device mesh (partitions stack on one card).
The spmd names load on first use, so importing a kernel module does not
import the engines (ops/scoring.py imports `parallel.kernels`).
"""
from elasticsearch_tpu_torch.parallel.routing import murmur3_hash, shard_for_id

_SPMD = ("StackedBM25", "StackedKnn", "build_stacked_bm25",
         "build_stacked_knn", "sharded_bm25_topk", "sharded_knn_topk",
         "prepare_query_blocks")

__all__ = ["shard_for_id", "murmur3_hash", *_SPMD]


def __getattr__(name):
    if name in _SPMD:
        from elasticsearch_tpu_torch.parallel import spmd

        return getattr(spmd, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
