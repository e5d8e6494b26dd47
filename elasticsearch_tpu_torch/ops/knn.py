"""Brute-force dense-vector kNN scores (the port of
elasticsearch_tpu/ops/knn.py `knn_scores` and `knn_top_k`).

Score conventions (Elasticsearch's `_score` for a top-level knn):
  cosine:       (1 + cos(q, d)) / 2     rows are unit vectors (normalized
                                        once on the host at upload)
  dot_product:  (1 + dot(q, d)) / 2     vectors assumed unit-normalized
  l2_norm:      1 / (1 + l2(q, d))      `norms` are the RAW row norms

The product rounds rows and queries to bf16 and multiplies them as f32 with
f32 accumulation, as the reference's `preferred_element_type=f32` does: a
bf16 value is exact in f32 and the product of two is exact, so only the
summation order differs from the reference (ROADMAP W1, W2). A torch
matmul of bf16 tensors would round every result to bf16, hence the casts
back to f32. bf16 values are exact in TF32 too, but TF32 stays off here.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False

_ROW_CHUNK = 1 << 18   # rows cast to f32 at a time


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root. torch's vectorized CPU sqrt is
    not (measured: 0.6% of uniform f32 inputs one ulp off, AVX-512 build);
    the float64 root rounded once to f32 is, on every device."""
    return torch.sqrt(x.double()).float()


def bf16_dots(queries: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """[Q, n] f32 dot products of bf16-rounded queries [Q, dims] and rows
    [n, dims] (any float dtype), f32 accumulation. Rows are cast to f32 a
    chunk at a time, so a bf16 matrix never doubles in memory."""
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off"
    q = queries.to(torch.bfloat16).float()
    n = vectors.shape[0]
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=q.device)
    for o in range(0, n, _ROW_CHUNK):
        v = vectors[o:o + _ROW_CHUNK].to(torch.bfloat16).float()
        torch.matmul(q, v.T, out=out[:, o:o + v.shape[0]])
    return out


def similarity_scores(dots: torch.Tensor, queries: torch.Tensor,
                      norms, similarity: str) -> torch.Tensor:
    """The similarity transform of `dots` [Q, n], in the reference's f32
    operation order. `norms` broadcasts against dots (l2_norm only)."""
    if similarity == "cosine":
        qn = sqrt_rn(torch.sum(queries * queries, dim=-1, keepdim=True))
        return (1.0 + dots / torch.clamp(qn, min=1e-20)) / 2.0
    if similarity == "dot_product":
        return (1.0 + dots) / 2.0
    if similarity == "l2_norm":
        qq = torch.sum(queries * queries, dim=-1, keepdim=True)
        d2 = torch.clamp(qq + norms * norms - 2.0 * dots, min=0.0)
        return 1.0 / (1.0 + sqrt_rn(d2))
    raise ValueError(f"unknown similarity [{similarity}]")


def knn_scores(queries: torch.Tensor, vectors: torch.Tensor,
               norms: torch.Tensor, exists: torch.Tensor, *,
               similarity: str = "cosine") -> torch.Tensor:
    """Dense [Q, n_docs] similarity scores; missing docs score -inf.

    queries [Q, dims] f32; vectors [n_docs, dims] bf16 or f32 (unit rows
    for cosine); norms [n_docs] f32 RAW row norms; exists [n_docs] bool."""
    dots = bf16_dots(queries, vectors)
    scores = similarity_scores(dots, queries, norms[None, :], similarity)
    return torch.where(exists[None, :], scores,
                       torch.full_like(scores, float("-inf")))


def topk_lowest_index(scores: torch.Tensor, k: int):
    """Per row the k largest values, ties broken by the lower column — the
    order of `lax.top_k`, which `torch.topk` does not promise on CUDA.
    Returns (values [Q, k], indices [Q, k] i64). A row with fewer than k
    values above -inf pads with (-inf, 0), where lax.top_k gives its
    lowest -inf columns; every caller masks those slots to (0, 0)."""
    Q, n = scores.shape
    k_eff = min(k, n)
    kth = torch.topk(scores, k_eff, dim=1).values[:, k_eff - 1:k_eff]
    # every value above the k-th and the finite ties at it; the row-major
    # nonzero lists each row's columns in ascending order
    cand = (scores > kth) | ((scores == kth) & (kth > float("-inf")))
    rows, cols = cand.nonzero(as_tuple=True)
    vals = scores[rows, cols]
    order = torch.sort(vals, descending=True, stable=True).indices
    order = order[torch.sort(rows[order], stable=True).indices]
    rows, cols, vals = rows[order], cols[order], vals[order]
    first = torch.zeros(Q + 1, dtype=torch.int64, device=scores.device)
    first[1:] = torch.cumsum(torch.bincount(rows, minlength=Q), 0)
    rank = torch.arange(rows.numel(), device=scores.device) - first[rows]
    keep = rank < k
    out_v = torch.full((Q, k), float("-inf"), dtype=scores.dtype,
                       device=scores.device)
    out_i = torch.zeros((Q, k), dtype=torch.int64, device=scores.device)
    out_v[rows[keep], rank[keep]] = vals[keep]
    out_i[rows[keep], rank[keep]] = cols[keep]
    return out_v, out_i


def knn_top_k(queries, vectors, norms, exists, mask, *,
              similarity: str = "cosine", k: int = 10):
    """(top scores [Q, k], top ords [Q, k], valid [Q, k]) over the docs
    where `mask` [n_docs] (or [Q, n_docs]) is set."""
    scores = knn_scores(queries, vectors, norms, exists,
                        similarity=similarity)
    m = mask if mask.dim() == 2 else mask[None, :]
    scores = torch.where(m, scores, torch.full_like(scores, float("-inf")))
    ts, to = topk_lowest_index(scores, k)
    return ts, to, ts > float("-inf")
