"""Device scoring ops: blocked BM25 scatter-scoring and masked top-k (the
port of elasticsearch_tpu/ops/scoring.py).

The dense executor's hot loop, in place of Lucene's per-segment postings
decode + BM25 + heap collection:

    gather selected blocks  ->  BM25 over [B, 128] lanes
    ->  scatter into a dense per-doc score vector  ->  top-k

Conventions (as in the reference): every segment reserves block row 0 as an
all-zero block (doc 0, tf 0), so padding a block-id list with 0 scores
nothing; block-id lists are padded to power-of-two buckets (the reference's
jit cache key; kept so both packages see the same lists); tf == 0 lanes
contribute nothing.

`bm25_scatter_scores` and `constant_scatter_mask` keep the reference's
signatures and run the hand kernel `parallel/csrc/block_scatter.cu` on a
CUDA tensor, its plain torch version on a CPU tensor
(`kernels.bm25_block_scatter`, `kernels.block_presence`). `masked_top_k`
keeps `lax.top_k`'s order, ties to the lower ordinal, through
`ops.knn.topk_lowest_index`; slots past the masked count are (-inf, 0) with
`valid` False.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from elasticsearch_tpu_torch.ops.knn import topk_lowest_index
from elasticsearch_tpu_torch.parallel import kernels

BLOCK = 128


def bm25_idf(doc_count: int, doc_freq: int) -> float:
    """Lucene BM25 idf: ln(1 + (N - df + 0.5) / (df + 0.5))."""
    return math.log(1.0 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5))


def next_bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two."""
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


def pad_block_ids(block_ids: np.ndarray, bucket: int | None = None) -> np.ndarray:
    """Pad a host block-id list with the reserved zero block (row 0)."""
    n = len(block_ids)
    b = bucket or next_bucket(n)
    out = np.zeros(b, dtype=np.int32)
    out[:n] = block_ids
    return out


def bm25_scatter_scores(
    block_docs: torch.Tensor,   # [T, 128] i32 — all postings blocks of the field
    block_tfs: torch.Tensor,    # [T, 128] f32
    doc_len: torch.Tensor,      # [n_docs] f32 — field length norms
    block_ids: torch.Tensor,    # [B] i32 — selected block rows (padded with 0)
    idf: torch.Tensor,          # [B] f32 — per-block idf weight of the owning term
    avgdl: float,               # rounded to f32
    *,
    n_docs: int,
    k1: float = 1.2,
    b: float = 0.75,
) -> torch.Tensor:
    """Score selected postings blocks into a dense [n_docs] f32.

    BM25: idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl))
    (ref: Lucene 8 BM25Similarity with norms; boost folded into idf
    upstream). The blocks are one term's (each doc once): see
    `kernels.bm25_block_scatter`."""
    if int(doc_len.shape[0]) != n_docs:
        raise ValueError(f"doc_len has {int(doc_len.shape[0])} docs, "
                         f"n_docs is {n_docs}")
    return kernels.bm25_block_scatter(block_ids, idf, block_docs, block_tfs,
                                      doc_len, avgdl=float(avgdl), k1=k1,
                                      b=b)


def constant_scatter_mask(
    block_docs: torch.Tensor,   # [T, 128] i32
    block_tfs: torch.Tensor,    # [T, 128] f32 (tf>0 marks real postings)
    block_ids: torch.Tensor,    # [B] i32 (padded with 0)
    *,
    n_docs: int,
) -> torch.Tensor:
    """Boolean [n_docs] mask of docs present in the selected blocks (the
    lane is real iff its tf > 0, which also neutralizes both zero-block
    padding and in-block tail padding)."""
    return kernels.block_presence(block_ids, block_docs, block_tfs,
                                  n_docs=n_docs)


def masked_top_k(scores: torch.Tensor, mask: torch.Tensor, *, k: int):
    """Top-k by score over docs where mask is true; ties break by ascending
    doc ordinal (Lucene's collector order, and lax.top_k's).

    Returns (scores [k] f32, ords [k] i64, valid [k] bool); slots past the
    number of masked docs hold (-inf, 0, False)."""
    masked = torch.where(mask, scores,
                         torch.full_like(scores, float("-inf")))
    top_scores, top_ords = topk_lowest_index(masked[None, :], k)
    return top_scores[0], top_ords[0], top_scores[0] > float("-inf")


def total_hits(mask: torch.Tensor) -> torch.Tensor:
    """The number of set docs, a 0-dim i32 tensor on the mask's device."""
    return torch.sum(mask, dtype=torch.int32)
