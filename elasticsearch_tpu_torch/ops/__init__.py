"""Scoring helpers copied from elasticsearch_tpu/ops/scoring.py:34-45."""

from __future__ import annotations

import math

BLOCK = 128


def bm25_idf(doc_count: int, doc_freq: int) -> float:
    """Lucene BM25 idf: ln(1 + (N - df + 0.5) / (df + 0.5))."""
    return math.log(1.0 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5))


def next_bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two."""
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()
