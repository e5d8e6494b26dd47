"""Stacked per-partition index state and the SPMD programs, for partitions
stacked on one card (the port of elasticsearch_tpu/parallel/spmd.py).

The reference runs one compiled program over a (dp, shard) device mesh:
score each shard, local top-k, all_gather over 'shard', a vectorized merge.
The port has no mesh (ROADMAP W16): the S partitions stack on the one card
as a leading [S, ...] dimension, the "gather" is that dimension, and the
merge is the K4 `merge_topk` kernel. The `mesh` parameter drops out of
every signature and `make_mesh` has no counterpart.

* `StackedBM25` / `build_stacked_bm25` (reference :68, :114): the host
  metadata always; the padded [S, T, 128] block arrays, live masks and doc
  lengths on the caller's device only when asked (`device_arrays=True`;
  TurboBM25 builds its own device copies, so its callers leave them off).
* `prepare_query_blocks` (:262), host code as the reference's.
* `sharded_bm25_topk` (:537): lane scores from tfs, doc lengths and avgdl
  as `_local_bm25_topk` (:335) computes them, with its denominator's fused
  multiply-add (ROADMAP W6), then the K10 `lane_topk` kernel per
  (partition, query) and K4.
* `build_stacked_knn` (:201), `sharded_knn_topk` (:616): bf16 products in
  f32 (`ops.knn.bf16_dots`), the similarity, `topk_lowest_index` and K4.
* `Bm25ColumnCache` (:724): the LRU of impact columns; a term's column is
  built by the K11 `weighted_block_scatter` kernel into its zeroed slot,
  and a batch scores as `W @ cache` in full f32, then masking,
  `topk_lowest_index` and K4.
* `merge_partition_topk` (:509): K4 over host per-partition results.

Empty result slots are (0, 0, 0), K4's, where the reference's `_merge_
gathered` leaves -inf scores.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common import hbm_ledger, integrity
from elasticsearch_tpu_torch.index.segment import FieldPostings
from elasticsearch_tpu_torch.ops import BLOCK, bm25_idf, next_bucket

K1 = 1.2
B = 0.75


# --------------------------------------------------------------------------
# Stacked index state
# --------------------------------------------------------------------------


@dataclass
class StackedBM25:
    """One text field's postings for all partitions: host metadata, and
    the stacked device arrays when built with device_arrays=True."""

    field: str
    n_shards: int
    max_docs: int                   # D (padded)
    doc_counts: List[int]           # real docs per partition
    avgdl: float                    # global average doc length
    total_docs: int                 # global doc count (idf denominator)
    postings: List[FieldPostings]   # host metadata per partition
    live_host: List[np.ndarray] | None = None
    block_docs: torch.Tensor | None = None     # [S, T, 128] i32
    block_tfs: torch.Tensor | None = None      # [S, T, 128] f32 (not serve_only)
    block_scores: torch.Tensor | None = None   # [S, T, 128] f32 idf-free
    doc_len: torch.Tensor | None = None        # [S, D] f32 (not serve_only)
    live: torch.Tensor | None = None           # [S, D] bool
    block_max_scores: List[np.ndarray] | None = None  # host [T_s] per partition
    host_block_scores: List[np.ndarray] | None = None  # host [T_s, 128]
    device: torch.device | None = None
    spmd_lanes: torch.Tensor | None = None  # sharded_bm25_topk's lane
    #   scores from tfs (built on its first call)


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


def _put_stack(arrays: Sequence[np.ndarray], shape, dtype, dev) -> torch.Tensor:
    """[S, *shape] zero-padded stack of host arrays, built on `dev`."""
    out = torch.zeros((len(arrays),) + tuple(shape), dtype=dtype, device=dev)
    for i, a in enumerate(arrays):
        sl = tuple(slice(0, n) for n in a.shape)
        out[i][sl] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out


def build_stacked_bm25(segments: Sequence, field: str,
                       live_masks: Sequence[np.ndarray] | None = None, *,
                       device=None, serve_only: bool = False,
                       device_arrays: bool = False) -> StackedBM25:
    """Stack per-partition single segments (objects with `n_docs` and a
    `postings` dict of FieldPostings).

    device_arrays=True also builds the padded [S, T, 128] block arrays
    (docs; tfs unless serve_only; idf-free lane scores, computed on the
    host with the reference's numpy formula, spmd.py:172-177), the doc
    lengths (unless serve_only) and live masks on `device` (None: the
    card), and the host block-max scores BlockMax culls with."""
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
    avgdl = float(sum_dl / n_field) if n_field else 1.0
    st = StackedBM25(
        field=field,
        n_shards=len(segments),
        max_docs=D,
        doc_counts=[seg.n_docs for seg in segments],
        avgdl=avgdl,
        total_docs=sum(seg.n_docs for seg in segments),
        postings=fps,
        live_host=live_np,
    )
    if not device_arrays:
        return st
    from elasticsearch_tpu_torch import device as _device
    from elasticsearch_tpu_torch.parallel.blockmax import _host_block_scores

    dev = _device.resolve(device)
    T = max(fp.block_docs.shape[0] for fp in fps)
    # idf-free lane scores tf(k1+1)/(tf + k1(1-b+b*dl/avgdl)), per partition
    # from its own doc lengths: the reference's formula, element for element
    st.host_block_scores = [_host_block_scores(fp, avgdl) for fp in fps]
    st.block_max_scores = [bs.max(axis=1) for bs in st.host_block_scores]
    st.block_docs = _put_stack([fp.block_docs for fp in fps], (T, BLOCK),
                               torch.int32, dev)
    st.block_scores = _put_stack(st.host_block_scores, (T, BLOCK),
                                 torch.float32, dev)
    if not serve_only:
        st.block_tfs = _put_stack([fp.block_tfs for fp in fps], (T, BLOCK),
                                  torch.float32, dev)
        st.doc_len = _put_stack([fp.doc_len for fp in fps], (D,),
                                torch.float32, dev)
    st.live = _put_stack(live_np, (D,), torch.bool, dev)
    st.device = dev
    return st


@dataclass
class StackedKnn:
    field: str
    vectors: torch.Tensor       # [S, D, dims] bf16
    norms: torch.Tensor         # [S, D] f32
    exists: torch.Tensor        # [S, D] bool
    live: torch.Tensor          # [S, D] bool
    n_shards: int
    max_docs: int
    similarity: str


def build_stacked_knn(segments: Sequence, field: str,
                      live_masks: Sequence[np.ndarray] | None = None, *,
                      device=None) -> StackedKnn:
    """Stack per-partition vector columns (objects with `n_docs` and a
    `vectors` dict of VectorColumn) on `device` (None: the card); cosine
    rows are normalized at upload, as the reference does."""
    from elasticsearch_tpu_torch import device as _device

    dev = _device.resolve(device)
    dims = 1
    sim = "cosine"
    for seg in segments:
        vc = seg.vectors.get(field)
        if vc is not None and vc.dims:
            dims = vc.dims
            sim = vc.similarity
            break
    D = max(max(seg.n_docs, 1) for seg in segments)
    vecs, norms, exists = [], [], []
    for seg in segments:
        vc = seg.vectors.get(field)
        if vc is None:
            vecs.append(np.zeros((max(seg.n_docs, 1), dims), np.float32))
            norms.append(np.zeros(max(seg.n_docs, 1), np.float32))
            exists.append(np.zeros(max(seg.n_docs, 1), bool))
        else:
            v = vc.vectors.astype(np.float32)
            if sim == "cosine":
                # upload-time row normalization (ops/knn.py convention):
                # cosine scoring divides by the query norm only
                v = v / np.maximum(vc.norms, 1e-20)[:, None]
            vecs.append(v)
            norms.append(vc.norms)
            exists.append(vc.exists)
    if live_masks is None:
        live_np = [np.ones(seg.n_docs, bool) for seg in segments]
    else:
        live_np = list(live_masks)
    return StackedKnn(
        field=field,
        vectors=_put_stack(vecs, (D, dims), torch.float32, dev).to(
            torch.bfloat16),
        norms=_put_stack(norms, (D,), torch.float32, dev),
        exists=_put_stack(exists, (D,), torch.bool, dev),
        live=_put_stack(live_np, (D,), torch.bool, dev),
        n_shards=len(segments),
        max_docs=D,
        similarity=sim,
    )


# --------------------------------------------------------------------------
# Host-side query preparation
# --------------------------------------------------------------------------


def prepare_query_blocks(
    stacked: StackedBM25,
    queries: List[List[str]],
    bucket: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Map term lists to per-(query, partition) padded block ids + idf
    weights.

    Returns (qblocks [Q, S, Bq] i32, qidf [Q, S, Bq] f32). Padding rows use
    block 0 (all-zero) with idf 0. idf is computed from GLOBAL stats so every
    partition scores consistently."""
    S = stacked.n_shards
    Q = len(queries)
    per_qs: List[List[Tuple[str, float]]] = []
    max_blocks = 1
    for terms in queries:
        rows: List[Tuple[str, float]] = []
        for term in terms:
            df = sum(int(fp.doc_freq[fp.term_to_ord[term]])
                     if term in fp.term_to_ord else 0
                     for fp in stacked.postings)
            if df == 0:
                continue
            idf = bm25_idf(stacked.total_docs, df)
            rows.append((term, idf))
        per_qs.append(rows)
        for s in range(S):
            nb = sum(len(stacked.postings[s].term_block_ids(t))
                     for t, _ in rows)
            max_blocks = max(max_blocks, nb)
    Bq = bucket or next_bucket(max_blocks)
    qblocks = np.zeros((Q, S, Bq), np.int32)
    qidf = np.zeros((Q, S, Bq), np.float32)
    for qi, rows in enumerate(per_qs):
        for s in range(S):
            fp = stacked.postings[s]
            off = 0
            for term, idf in rows:
                ids = fp.term_block_ids(term)
                n = len(ids)
                if n == 0:
                    continue
                qblocks[qi, s, off: off + n] = ids
                qidf[qi, s, off: off + n] = idf
                off += n
    return qblocks, qidf


def term_runs(stacked: StackedBM25, qblocks: np.ndarray) -> np.ndarray:
    """K10's runs of each (query, partition) row of `qblocks` [Q, S, B]: a
    run starts at a term's first block or wherever ids stop being
    consecutive, and the row ends at its first pad (block 0). Returns
    tstart [Q, S, R + 1] i32 (R >= 1; unused runs empty)."""
    Q, S, Bq = qblocks.shape
    starts = []
    for s in range(S):
        fp = stacked.postings[s]
        first = np.zeros(fp.block_docs.shape[0] + 1, bool)
        first[fp.block_start[fp.block_count > 0]] = True
        qb = qblocks[:, s, :]
        real = qb > 0
        nb = np.where(real.all(axis=1), Bq, np.argmin(real, axis=1))
        prev = np.concatenate([np.full((Q, 1), -2, np.int64),
                               qb[:, :-1].astype(np.int64)], axis=1)
        st = first[np.clip(qb, 0, len(first) - 1)] | (qb != prev + 1)
        st &= np.arange(Bq)[None, :] < nb[:, None]
        starts.append((st, nb))
    R = max(1, max(int(st.sum(axis=1).max(initial=0)) for st, _ in starts))
    tstart = np.zeros((Q, S, R + 1), np.int32)
    for s, (st, nb) in enumerate(starts):
        for qi in range(Q):
            pos = np.nonzero(st[qi])[0]
            tstart[qi, s, : len(pos)] = pos
            tstart[qi, s, len(pos):] = nb[qi]
    return tstart


# --------------------------------------------------------------------------
# The programs
# --------------------------------------------------------------------------


def merge_parts(part_s: torch.Tensor, part_d: torch.Tensor, k: int):
    """[S, Q, k] per-partition (score, ord) top-k -> the K4 merge, (score
    desc, partition asc, ord asc), as device tensors (scores [Q, k] f32,
    parts [Q, k] i32, ords [Q, k] i32); empty slots (0, 0, 0)."""
    from elasticsearch_tpu_torch.parallel.kernels import merge_topk

    S, Q, kk = part_s.shape
    flat_s = part_s.permute(1, 0, 2).reshape(Q, S * kk).contiguous()
    flat_o = part_d.permute(1, 0, 2).reshape(Q, S * kk).to(
        torch.int32).contiguous()
    return merge_topk(flat_s, flat_o, k=kk)


def _host3(t3) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return tuple(t.cpu().numpy() for t in t3)


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

    dev = _device.resolve(device)
    s = torch.as_tensor(scores, dtype=torch.float32, device=dev)
    o = torch.as_tensor(ords, device=dev).to(torch.int32)
    if s.shape[2] != k:
        raise ValueError(f"per-partition results hold {s.shape[2]} slots, "
                         f"not k={k}")
    return _host3(merge_parts(s, o, k))


def _spmd_lane_scores(stacked: StackedBM25) -> torch.Tensor:
    """Idf-free lane scores from tfs, doc lengths and avgdl in
    `_local_bm25_topk`'s order, with the fused multiply-add XLA on the CPU
    forms in its denominator (W6, as ops/scoring.py):
    (tf * (k1 + 1)) / fmaf(k1, (1 - b) + (b * dl) / avgdl, tf); 0 where
    tf = 0. Cached on the stacked state."""
    from elasticsearch_tpu_torch.parallel.kernels import _f32, _fma

    if stacked.spmd_lanes is not None:
        return stacked.spmd_lanes
    if stacked.block_tfs is None or stacked.doc_len is None:
        raise ValueError("sharded_bm25_topk needs a StackedBM25 built with "
                         "device_arrays=True and serve_only=False")
    out = torch.zeros_like(stacked.block_tfs)
    avgdl = _f32(max(stacked.avgdl, 1e-9))
    for s in range(stacked.n_shards):
        tf = stacked.block_tfs[s]
        dl = stacked.doc_len[s][stacked.block_docs[s].long()]
        t = _f32(1.0 - B) + (_f32(B) * dl) / avgdl
        denom = _fma(torch.full_like(t, _f32(K1)), t, tf)
        sc = (tf * _f32(K1 + 1.0)) / denom
        out[s] = torch.where(tf > 0, sc, torch.zeros_like(sc))
    stacked.spmd_lanes = out
    return out


def sharded_bm25_topk(stacked: StackedBM25, qblocks: np.ndarray,
                      qidf: np.ndarray, k: int = 10):
    """Batched BM25 over the stacked partitions: each (query, partition)
    row's blocks scored and ranked by the K10 lane top-k kernel, then the
    K4 merge. Queries go in power-of-two block buckets as the reference
    dispatches them. Returns host (scores [Q, k], partition [Q, k],
    ord [Q, k])."""
    from elasticsearch_tpu_torch.parallel.kernels import lane_topk

    Q = qblocks.shape[0]
    dev = stacked.device
    lanes = _spmd_lane_scores(stacked)
    nblocks = np.maximum((qblocks > 0).sum(axis=2).max(axis=1), 1)   # [Q]
    buckets = np.asarray([next_bucket(int(n)) for n in nblocks])
    out_s = np.zeros((Q, k), np.float32)
    out_shard = np.zeros((Q, k), np.int32)
    out_ord = np.zeros((Q, k), np.int32)
    for bucket in np.unique(buckets):
        rows = np.nonzero(buckets == bucket)[0]
        qb = np.ascontiguousarray(qblocks[rows][:, :, :bucket])
        qi = np.ascontiguousarray(qidf[rows][:, :, :bucket])
        ts = term_runs(stacked, qb)
        ps, pd = lane_topk(
            stacked.block_docs, lanes, stacked.live,
            torch.from_numpy(qb).to(dev), torch.from_numpy(qi).to(dev),
            torch.from_numpy(ts).to(dev), k=k)
        top_s, shard_of, ord_of = _host3(merge_parts(ps, pd, k))
        out_s[rows] = top_s
        out_shard[rows] = shard_of
        out_ord[rows] = ord_of
    return out_s, out_shard, out_ord


def sharded_knn_topk(stacked: StackedKnn, queries: np.ndarray, k: int = 10):
    """Brute-force kNN over the stacked partitions: bf16 products with f32
    accumulation, the similarity, a per-partition top-k (ties to the lower
    ord), the K4 merge. Returns host (scores, partition, ord) [Q, k]."""
    from elasticsearch_tpu_torch.ops.knn import (
        bf16_dots, similarity_scores, topk_lowest_index,
    )

    dev = stacked.vectors.device
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    ps, pd = [], []
    for s in range(stacked.n_shards):
        dots = bf16_dots(q, stacked.vectors[s])
        sc = similarity_scores(dots, q, stacked.norms[s][None, :],
                               stacked.similarity)
        ok = (stacked.exists[s] & stacked.live[s])[None, :]
        sc = torch.where(ok, sc, torch.full_like(sc, float("-inf")))
        ts, to = topk_lowest_index(sc, k)
        ps.append(ts)
        pd.append(to)
    return _host3(merge_parts(torch.stack(ps), torch.stack(pd), k))


# --------------------------------------------------------------------------
# Impact-column cache: BM25 as a matmul
# --------------------------------------------------------------------------


class Bm25ColumnCache:
    """Device-resident LRU of per-term impact columns over a StackedBM25
    (built with device_arrays=True): terms used by recent query batches
    keep dense [D] impact columns, and a batch scores as one W @ cache
    matmul + top-k."""

    def __init__(self, stacked: StackedBM25, capacity: int = 2048):
        self.stacked = stacked
        self.capacity = capacity
        S, D = stacked.n_shards, stacked.max_docs
        self.device = stacked.device
        self.cache = torch.zeros((S, capacity + 1, D), dtype=torch.float32,
                                 device=self.device)
        # slot-pool state shared between concurrent ensure_terms callers:
        # the protect-set read in _evict and the churn accounting must see
        # a consistent pool, or an in-flight batch's slots can be freed
        # under it
        self._lock = threading.Lock()
        self.term_slot: Dict[str, int] = {}   # guarded by: _lock
        self.term_idf: Dict[str, float] = {}  # guarded by: _lock
        self._lru: Dict[str, int] = {}        # guarded by: _lock (term -> tick)
        self._tick = 0                        # guarded by: _lock
        self._free = list(range(capacity))    # guarded by: _lock
        self._slot_bytes = self.hbm_bytes() // (capacity + 1)
        self._hbm = hbm_ledger.register_engine(self, "spmd_cache")
        self._hbm.set_region("cache", self.hbm_bytes())
        # the slot cache is device-built: it scrubs against a per-epoch
        # baseline (a legitimate insert changes the epoch) and repairs by
        # dropping to empty; the callable hands the scrubber a host copy
        self._epoch = 0     # bumped by every write: the cache is updated
        #                     in place, so its identity does not change
        integrity.register_scrub_region(
            self, "cache", lambda o: o.cache.cpu().numpy(),
            epoch=lambda o: o._epoch, repair=lambda o: o.reset_cache())

    def reset_cache(self) -> None:
        """Drop every cached column (scrub repair / corruption recovery):
        the device cache re-zeroes and the slot pool restarts empty."""
        from elasticsearch_tpu_torch.common import faults

        with self._lock:
            freed = len(self.term_slot)
            with faults.device_errors("column_upload"):
                self.cache.zero_()
                self._epoch += 1
            if freed:
                self._hbm.note_eviction(
                    count=freed, freed_bytes=self._slot_bytes * freed)
            self.term_slot.clear()
            self.term_idf.clear()
            self._lru.clear()
            self._free = list(range(self.capacity))

    def hbm_bytes(self) -> int:
        return self.cache.numel() * self.cache.element_size()

    def _evict(self, n: int, protect: set) -> List[int]:  # tpulint: holds=_lock
        """Free the n least-recently-used slots, never evicting `protect`.
        Caller holds _lock."""
        victims = [t for t in sorted(self._lru, key=self._lru.get)
                   if t not in protect][:n]
        if len(victims) < n:
            raise ValueError(
                f"query batch references {len(protect)} terms > capacity "
                f"{self.capacity}")
        slots = []
        for t in victims:
            slots.append(self.term_slot.pop(t))
            del self.term_idf[t]
            del self._lru[t]
        self._hbm.note_eviction(count=len(victims),
                                freed_bytes=self._slot_bytes * len(victims))
        return slots

    def ensure_terms(self, terms: Sequence[str]) -> None:
        """Build + insert impact columns for terms not yet cached."""
        with self._lock:
            self._ensure_terms_locked(terms)

    def _ensure_terms_locked(self, terms: Sequence[str]) -> None:  # tpulint: holds=_lock
        from elasticsearch_tpu_torch.parallel.kernels import (
            weighted_block_scatter,
        )

        batch_terms = set(terms)
        missing = [t for t in dict.fromkeys(terms) if t not in self.term_slot]
        self._tick += 1
        for t in terms:
            if t in self._lru:
                self._lru[t] = self._tick
        if not missing:
            return
        if len(missing) > self.capacity:
            raise ValueError(f"query batch needs {len(missing)} terms > "
                             f"capacity {self.capacity}")
        self._hbm.note_protect_pressure(
            len(batch_terms & set(self.term_slot)) + len(missing),
            self.capacity)
        if len(missing) > len(self._free):
            self._free.extend(self._evict(len(missing) - len(self._free),
                                          batch_terms))
        S = self.stacked.n_shards
        dev = self.device
        # terms grouped by block-count size class, 64 a launch, as the
        # reference batches its insert program
        nblocks = {
            t: max((len(fp.term_block_ids(t))
                    for fp in self.stacked.postings), default=0)
            for t in missing
        }
        groups: Dict[int, List[str]] = {}
        for t in missing:
            groups.setdefault(next_bucket(max(nblocks[t], 1), minimum=4),
                              []).append(t)
        for maxB, terms_g in sorted(groups.items()):
            for off in range(0, len(terms_g), 64):
                chunk = terms_g[off: off + 64]
                blks = np.zeros((S, len(chunk), maxB), np.int32)
                slots = np.zeros(len(chunk), np.int32)
                for j, t in enumerate(chunk):
                    slot = self._free.pop()
                    slots[j] = slot
                    self.term_slot[t] = slot
                    self._lru[t] = self._tick
                    df = 0
                    for s in range(S):
                        fp = self.stacked.postings[s]
                        ids = fp.term_block_ids(t)
                        blks[s, j, : len(ids)] = ids
                        if t in fp.term_to_ord:
                            df += int(fp.doc_freq[fp.term_to_ord[t]])
                    self.term_idf[t] = (bm25_idf(self.stacked.total_docs, df)
                                        if df else 0.0)
                sl = torch.from_numpy(slots).to(dev).long()
                self.cache[:, sl, :] = 0.0
                # one term a slot: the group is one K11 run (no (slot, doc)
                # written twice), a launch a group as the reference's
                rows = np.broadcast_to(slots[None, :, None], blks.shape)
                weighted_block_scatter(
                    self.cache,
                    torch.from_numpy(blks.reshape(S, -1)).to(dev),
                    torch.ones((S, blks[0].size), dtype=torch.float32,
                               device=dev),
                    self.stacked.block_docs, self.stacked.block_scores,
                    rows=torch.from_numpy(
                        np.ascontiguousarray(rows).reshape(S, -1)).to(dev))
                self._epoch += 1

    def search(self, queries: List[List[str]], k: int = 10):
        """Batched match-query search. Returns host (scores, partition,
        ord) [Q, k]."""
        from elasticsearch_tpu_torch.ops.knn import topk_lowest_index

        self.ensure_terms([t for q in queries for t in q])
        Q = len(queries)
        C1 = self.capacity + 1
        W = np.zeros((Q, C1), np.float32)
        assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off"
        with self._lock:   # slots must not be evicted while being packed
            for qi, q in enumerate(queries):
                for t in q:
                    idf = self.term_idf.get(t, 0.0)
                    if idf == 0.0:
                        continue
                    W[qi, self.term_slot[t]] += np.float32(idf)
            Wt = torch.from_numpy(W).to(self.device)
            ps, pd = [], []
            for s in range(self.stacked.n_shards):
                scores = torch.matmul(Wt, self.cache[s])          # [Q, D]
                ok = self.stacked.live[s][None, :] & (scores > 0)
                scores = torch.where(ok, scores,
                                     torch.full_like(scores, float("-inf")))
                ts, to = topk_lowest_index(scores, k)
                ps.append(ts)
                pd.append(to)
        return _host3(merge_parts(torch.stack(ps), torch.stack(pd), k))
