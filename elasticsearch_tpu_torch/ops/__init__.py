"""Scoring and kNN ops (the port of elasticsearch_tpu/ops): the block
scatter, masked top-k and the BM25 helpers in ops/scoring.py, brute-force
kNN in ops/knn.py."""

from elasticsearch_tpu_torch.ops.scoring import (
    BLOCK,
    bm25_idf,
    bm25_scatter_scores,
    constant_scatter_mask,
    masked_top_k,
    next_bucket,
    pad_block_ids,
    total_hits,
)
from elasticsearch_tpu_torch.ops.knn import knn_scores, knn_top_k

__all__ = [
    "BLOCK",
    "bm25_idf",
    "bm25_scatter_scores",
    "constant_scatter_mask",
    "masked_top_k",
    "next_bucket",
    "pad_block_ids",
    "total_hits",
    "knn_scores",
    "knn_top_k",
]
