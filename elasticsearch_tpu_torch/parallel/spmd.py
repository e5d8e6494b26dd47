"""Stacked per-partition BM25 index state (the port of `StackedBM25` and
`build_stacked_bm25(device_arrays=False)` from
elasticsearch_tpu/parallel/spmd.py:68, :114), and the device partition merge
(`merge_partition_topk`, spmd.py:509) for partitions stacked on one card.

TurboBM25 builds its own device copies of what it serves from, so the
port keeps only the host metadata it reads: the per-partition postings,
live masks and the index-global scoring stats. The reference's padded
[S, T, 128] stacks (block docs, tfs, lane scores, doc lengths) feed its
SPMD programs, which are not ported yet (ROADMAP.md, queue 1, item 8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from elasticsearch_tpu_torch.index.segment import FieldPostings
from elasticsearch_tpu_torch.ops import BLOCK

K1 = 1.2
B = 0.75


@dataclass
class StackedBM25:
    """One text field's postings for all partitions (host metadata)."""

    field: str
    n_shards: int
    max_docs: int                   # D (padded)
    doc_counts: List[int]           # real docs per partition
    avgdl: float                    # global average doc length
    total_docs: int                 # global doc count (idf denominator)
    postings: List[FieldPostings]   # host metadata per partition
    live_host: List[np.ndarray] | None = None


def _empty_postings(field: str, n_docs: int) -> FieldPostings:
    return FieldPostings(
        field=field, term_to_ord={}, terms=[],
        doc_freq=np.zeros(0, np.int32),
        total_term_freq=np.zeros(0, np.int64),
        block_start=np.zeros(0, np.int32),
        block_count=np.zeros(0, np.int32),
        block_docs=np.zeros((1, BLOCK), np.int32),
        block_tfs=np.zeros((1, BLOCK), np.float32),
        block_max_tf=np.zeros(1, np.float32),
        post_start=np.zeros(1, np.int64),
        post_doc=np.zeros(0, np.int32),
        pos_start=np.zeros(1, np.int64),
        pos_data=np.zeros(0, np.int32),
        doc_len=np.zeros(max(n_docs, 1), np.float32),
        sum_doc_len=0.0)


def build_stacked_bm25(segments: Sequence, field: str,
                       live_masks: Sequence[np.ndarray] | None = None
                       ) -> StackedBM25:
    """Stack per-partition single segments (objects with `n_docs` and a
    `postings` dict of FieldPostings)."""
    fps = [seg.postings.get(field) or _empty_postings(field, seg.n_docs)
           for seg in segments]
    D = max(max(seg.n_docs, 1) for seg in segments)
    if D >= (1 << 24):
        raise ValueError(
            f"partition has {D} docs; row ids travel as exact f32 values "
            "(24-bit ordinals) — split corpora beyond 16.7M docs into more "
            "partitions")
    if live_masks is None:
        live_np = [np.ones(seg.n_docs, bool) for seg in segments]
    else:
        live_np = list(live_masks)
    n_field = sum(int(np.count_nonzero(fp.doc_len)) for fp in fps)
    sum_dl = sum(fp.sum_doc_len for fp in fps)
    return StackedBM25(
        field=field,
        n_shards=len(segments),
        max_docs=D,
        doc_counts=[seg.n_docs for seg in segments],
        avgdl=float(sum_dl / n_field) if n_field else 1.0,
        total_docs=sum(seg.n_docs for seg in segments),
        postings=fps,
        live_host=live_np,
    )


def merge_partition_topk(scores, ords, k: int, *, device=None):
    """Merge per-partition top-k results on the device with the
    deterministic (score desc, partition asc, ord asc) tie-break, through
    the K4 `merge_topk` kernel — the device twin of the host merge, equal to
    it bit for bit (merging permutes exact f32 values).

    scores [S, Q, k] f32, ords [S, Q, k] i32: host arrays, merged on
    `device`; a score <= 0 marks an empty slot. Lanes are laid
    partition-major (lane = partition * k + slot), as the reference's
    `_partition_merge_program` lays them after its all-gather; stacked
    partitions share one card, so there is no gather and no f32 packing of
    ids.

    Returns host (scores [Q, k] f32, parts [Q, k] i32, ords [Q, k] i32);
    empty output slots are (0, 0, 0)."""
    from elasticsearch_tpu_torch import device as _device
    from elasticsearch_tpu_torch.parallel.kernels import merge_topk

    dev = _device.resolve(device)
    s = torch.as_tensor(scores, dtype=torch.float32, device=dev)
    o = torch.as_tensor(ords, device=dev).to(torch.int32)
    S, Q, kk = s.shape
    if kk != k:
        raise ValueError(f"per-partition results hold {kk} slots, not k={k}")
    flat_s = s.permute(1, 0, 2).reshape(Q, S * k).contiguous()
    flat_o = o.permute(1, 0, 2).reshape(Q, S * k).contiguous()
    top_s, top_p, top_o = merge_topk(flat_s, flat_o, k=k)
    return top_s.cpu().numpy(), top_p.cpu().numpy(), top_o.cpu().numpy()
