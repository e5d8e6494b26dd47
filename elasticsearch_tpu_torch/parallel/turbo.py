"""TurboBM25: the BM25 serving engine on an int8 column cache (the port of
elasticsearch_tpu/parallel/turbo.py at S = 1: the disjunction, bool
queries and slop-0 phrases).

Per query the terms split three ways, as in the reference:

* **colized** (df >= cold_df): the term owns a dense int8 hi/lo impact
  column in the device cache, built on the card by kernels.build_columns
  (K1). One sweep (kernels.sweep_rowmax, K2) scores a batch of queries and
  keeps per-superwindow candidate rows; `_pick_rows` keeps each query's
  global best rows, so only ~n_rows row ids per query reach the host.
* **cold** (df < cold_df): the term keeps an eager sparse slice, packed
  ``doc << 8 | impact`` granules in a device pool, scored by
  kernels.sparse_gather (K3) in one launch for a sweep chunk's queries
  (`_sparse_contrib_many`); the host bound-prunes and rescores exactly.
* the host rescores every doc of the collected rows in exact f32 (term
  order identical to the reference scorer) and checks a per-query
  certificate bounding what the quantized sweep could have hidden in rows
  it did not collect; a failing certificate falls back to the exact merge.

Bool queries (`search_bool`) and slop-0 phrases (`search_phrase`, whose
adjacency columns are built by K1 like term columns) take the same shape:
a device sweep gated to the docs that satisfy the required clauses — by
packed presence bitsets intersected on the card (K5 intersect_bitset, K6
sweep_rowmax_bitset; ES_TPU_BITSET=1, the default) or by a coverage
product (K7 sweep_rowmax_conj; ES_TPU_BITSET=0) — then the exact host
rescore of every collected doc and a certificate. Queries the device
cannot serve, or whose rarest required clause is below
ES_TPU_BITSET_HOST_DF, take the exact host intersection.

Final scores therefore come from the host, and top-k (scores, ords) are
bitwise the reference's. Device state is torch tensors on `self.device`;
the column cache and the slice pool are updated in place where the
reference donated its buffers. What touches that state holds the
engine's lock: `ensure_columns`, `ensure_phrases`, `prebuild_columns`,
the cold side, and the device passes of `search_many` and `search_bool`
(column warm-up, sweeps, read-backs, and the column split each query's
certificate is taken against). The scheduler's lanes of different k, or
a direct dispatch beside a lane, call one engine from several threads,
and a sweep must not read a column another thread is still building
(the reference leaves these calls unserialized). The exact host rescore
and the certificate run after the lock is released, on host data and
that split only, so one caller's rescore overlaps another's sweep. The
scheduler's width hook is `extend_qc_sizes`.

Not ported yet (ROADMAP.md): ShardedTurbo (S > 1) and its fused bool
sweeps, the HBM scrub regions (the bitsets' included) and the relocation
warm handoff.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch import device as _device
from elasticsearch_tpu_torch.common import faults, hbm_ledger, metrics
from elasticsearch_tpu_torch.common.errors import DeviceFaultError
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.index.positions import phrase_freqs
from elasticsearch_tpu_torch.index.segment import tf_at
from elasticsearch_tpu_torch.ops import bm25_idf
from elasticsearch_tpu_torch.parallel import kernels
from elasticsearch_tpu_torch.parallel.blockmax import _host_block_scores
from elasticsearch_tpu_torch.parallel.kernels import (
    BITSET_CLAUSES, BITSET_NEGS, COLSCALE2, MAX_GROUP_ROWS, N_CHUNKS, NCAND,
    ROWS_PER_STEP, SPARSE_GRAN, SPARSE_IMP_MAX, SW, TILE,
)
from elasticsearch_tpu_torch.parallel.spmd import StackedBM25

COLD_DF = 16384        # below this, terms are cold
K1_PLUS1 = 2.2         # BM25 idf-free impact upper bound
_K1 = 1.2              # BM25 k1
_B = 0.75              # BM25 b
_GLOBAL_ROWS = 33      # candidate posting rows collected per query
_MAX_REQ = 126         # coverage counts fit int8 with the must_not weight

_LANE128 = np.arange(128, dtype=np.int64)


def _pick_rows(rm: torch.Tensor, rr: torch.Tensor, *, n_rows: int):
    """Global candidate-row pick on the device (reference turbo.py:83):
    from the sweep's per-superwindow top-NCAND (rowmax, row) pairs, keep
    each query's global top n_rows rows.

    Returns one [QC, n_rows + 1] f32 tensor: row ids as exact floats (-1
    marks empty slots) and, in the last column, the max approximate score
    any uncollected row could hold. `lax.top_k` returns the smallest index
    among equal values; a stable descending sort does the same."""
    qc = rm.shape[1]
    m = rm[:, :, :NCAND].permute(1, 0, 2).reshape(qc, -1)
    r = rr[:, :, :NCAND].permute(1, 0, 2).reshape(qc, -1)
    if m.shape[1] < n_rows + 1:
        pad = n_rows + 1 - m.shape[1]
        m = torch.cat([m, torch.full((qc, pad), float("-inf"),
                                     dtype=m.dtype, device=m.device)], 1)
        r = torch.cat([r, torch.zeros((qc, pad), dtype=r.dtype,
                                      device=r.device)], 1)
    top_m, idx = torch.sort(m, dim=1, descending=True, stable=True)
    top_m, idx = top_m[:, :n_rows + 1], idx[:, :n_rows + 1]
    valid = top_m[:, :n_rows] > float("-inf")
    rows = torch.where(valid, torch.gather(r, 1, idx[:, :n_rows]),
                       torch.full_like(r[:, :n_rows], -1))
    beyond = top_m[:, n_rows]
    beyond = torch.where(torch.isfinite(beyond), beyond,
                         torch.zeros_like(beyond))
    sw_last = rm[:, :, NCAND - 1]                          # [nsw, QC]
    sw_bound = torch.where(sw_last > float("-inf"), sw_last,
                           torch.zeros_like(sw_last)).amax(dim=0)
    return torch.cat([rows.float(),
                      torch.maximum(beyond, sw_bound)[:, None]], dim=1)


def _flatten_queries(batches: Sequence[List]):
    """Flatten batches of term/(term, boost) query lists into (flat
    [(term, boost)] lists with duplicate terms summed, spans [(offset,
    count)] per batch)."""
    flat: List[List[Tuple[str, float]]] = []
    spans = []
    for queries in batches:
        spans.append((len(flat), len(queries)))
        for q in queries:
            agg: Dict[str, float] = {}
            for t in q:
                t, b = (t, 1.0) if isinstance(t, str) else t
                agg[t] = agg.get(t, 0.0) + b
            flat.append(list(agg.items()))
    return flat, spans


_ROW_BUCKETS = (256, 2048, 16384)   # phrase lane arrays are padded to one
#   of a few row counts, so their device buffers recur at few sizes


def _row_bucket(n: int) -> int:
    for b in _ROW_BUCKETS:
        if n <= b:
            return b
    return -(-n // _ROW_BUCKETS[-1]) * _ROW_BUCKETS[-1]


def _tile_groups(lo: np.ndarray, hi: np.ndarray, row0: int, slot: int):
    """(rows, nrows, bases, slots) K1 build groups over consecutive posting
    rows starting at row `row0`, whose first and last docs are lo and hi
    (ascending): one group per touched 16384-doc tile."""
    t0, t1 = int(lo[0]) // TILE, int(hi[-1]) // TILE
    tiles = np.arange(t0, t1 + 1, dtype=np.int64)
    starts = np.searchsorted(hi, tiles * TILE, side="left")
    ends = np.searchsorted(lo, (tiles + 1) * TILE, side="left")
    n = (ends - starts).astype(np.int32)
    keep = n > 0
    return (row0 + starts[keep].astype(np.int32),
            n[keep],
            (tiles[keep] * TILE).astype(np.int32),
            np.full(int(keep.sum()), slot, np.int32))


def _quantize_weights(ws: Sequence[float]):
    """(qs, qs2, [(wh, wl)]): one query's scoring weights as int8 hi/lo
    pairs on the steps qs = max|w| / 127 and qs2 = qs / 128, as the sweep
    dispatches them."""
    wmax = max(abs(w) for w in ws)
    qs = max(wmax / 127.0, 1e-9)
    qs2 = qs / 128.0
    q = []
    for w in ws:
        wh = max(-127, min(127, round(w / qs)))
        wl = max(-127, min(127, round((w - qs * wh) / qs2)))
        q.append((wh, wl))
    return qs, qs2, q


def _quant_error(ws: Sequence[float]) -> float:
    """e_q: the most the quantized sweep can misstate a doc's score with
    these scoring weights (the certificate's margin)."""
    e_q = 1e-7
    if ws:
        qs, qs2, q = _quantize_weights(ws)
        for w, (wh, wl) in zip(ws, q):
            w_approx = qs * wh + qs2 * wl
            # a full lo step: the build kernel forces lo >= 1 on
            # presence-only cells
            e_q += (abs(w - w_approx) * K1_PLUS1
                    + abs(w_approx) * COLSCALE2)
        # f32 rounding of the in-kernel integer combine
        e_q += 3e-7 * sum(abs(w) for w in ws) * K1_PLUS1
    return float(e_q)


@dataclass
class _TermInfo:
    ord: int
    df: int
    idf: float
    row_start: int          # first block row
    n_rows: int             # block rows
    smax: float             # max idf-free lane score


@dataclass
class _PhraseInfo:
    """A slop-0 phrase treated as a synthetic term: its matching docs and
    per-doc phrase freqs (one positions scan, index/positions.phrase_freqs)
    back both the int8 adjacency column build and the exact host rescore."""
    key: str                # column-cache key ("\x00p:" + joined terms)
    terms: Tuple[str, ...]
    docs: np.ndarray        # i32 ascending, live-unfiltered
    pf: np.ndarray          # f32 phrase freqs aligned with docs
    idf_sum: float          # sum of member-term idfs, in term order
    smax: float             # max idf-free phrase lane score


def _pkey(terms: Sequence[str]) -> str:
    return "\x00p:" + "\x00".join(terms)


def _intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted-unique intersection with a galloping gear: when one side is
    tiny relative to the other, binary-searching the small side's members
    in the large one (s * log2(b) work) beats np.isin's linear merge."""
    if len(a) > len(b):
        a, b = b, a
    if not len(a):
        return a
    if len(a) * max(np.log2(len(b)), 1.0) < len(b):
        j = np.searchsorted(b, a)
        jc = np.minimum(j, len(b) - 1)
        return a[(j < len(b)) & (b[jc] == a)]
    return a[np.isin(a, b, assume_unique=True)]


@dataclass
class _BoolQuery:
    """One resolved bool query (TurboBM25.search_bool). Clause lists keep
    the original spec order: the exact rescore iterates them verbatim, so
    its f64 accumulation is the reference's bit for bit."""
    conj: list        # [(term, boost, _TermInfo)] — required, scoring
    should: list      # [(term, boost, _TermInfo)] — optional, scoring
    filters: list     # [(term, _TermInfo)] — required, non-scoring
    must_not: list    # [(term, _TermInfo)] — prohibited
    phrases: list     # [(terms, slop, boost, _PhraseInfo | None, idf_sum)]
    dev_candidate: bool


# node-wide bitset counters mirrored from every engine's stats;
# bitset_bytes is a running total of currently packed bytes (repacks add
# the delta), the rest are cumulative
_NODE_BITSET_STATS = {"bitset_packs": 0, "bitset_bytes": 0,
                      "bitset_blocks_skipped": 0,
                      "bitset_gallop": 0}  # guarded by: _NODE_BITSET_LOCK
_NODE_BITSET_LOCK = threading.Lock()


def _node_bitset_add(key: str, n: int) -> None:
    if n == 0:
        return
    with _NODE_BITSET_LOCK:
        _NODE_BITSET_STATS[key] += n


def node_bitset_stats() -> dict:
    with _NODE_BITSET_LOCK:
        return dict(_NODE_BITSET_STATS)


# ---- eager sparse impact tier (ES_TPU_SPARSE) ----

_SPARSE_DOC_LIMIT = 1 << 23          # packed doc-id headroom in an int32
_SPARSE_MAX_CHUNKS = 256   # the reference's largest dispatch bucket: a
#   query whose cold side needs more chunks is scored on the host


class _SparseGroup:
    """The K3 dispatches of one sweep chunk's queries that wait for one
    batched launch (`_sp_flush`), and the slice granules packed on the host
    mirror since the last upload."""

    def __init__(self, n_queries: int):
        self.res: List[Optional[tuple]] = [None] * n_queries
        self.members: List[tuple] = []   # (query index, cold terms, prep)
        self.terms: set = set()          # every member's cold terms
        self.dirty: List[np.ndarray] = []   # granule ids to upload


def _group_views(m: torch.Tensor, n_rc: int, n_q: int):
    """(coff, cw, ct0, ct1, qoff) views of a group's packed K3 inputs
    (TurboBM25._sparse_group_args' layout)."""
    return (m[:n_rc], m[3 * n_rc + n_q + 1:].view(torch.float32),
            m[n_rc: 2 * n_rc], m[2 * n_rc: 3 * n_rc],
            m[3 * n_rc: 3 * n_rc + n_q + 1])


def _sparse_widths() -> Tuple[int, ...]:
    """Slice-width ladder (ES_TPU_SPARSE_WIDTHS), each rung rounded up to
    a granule multiple, ascending."""
    raw = knob("ES_TPU_SPARSE_WIDTHS") or ""
    ws = set()
    for tok in str(raw).split(","):
        tok = tok.strip()
        if tok:
            ws.add(max(SPARSE_GRAN,
                       -(-int(tok) // SPARSE_GRAN) * SPARSE_GRAN))
    return tuple(sorted(ws)) or (1024, 4096, 16384)


def _serialized(fn):
    """Run a TurboBM25 method under the engine's `_serve_lock`."""
    @functools.wraps(fn)
    def locked(self, *args, **kwargs):
        with self._serve_lock:
            return fn(self, *args, **kwargs)
    return locked


class TurboBM25:
    """Single-partition serving engine over a StackedBM25 (S == 1).

    qc_sizes: dispatch widths (queries per sweep launch).
    hbm_budget_bytes: device memory reserved for the int8 column cache.
    device: where the engine's tensors live and its kernels run; None
        means CUDA (device.resolve).
    """

    def __init__(self, stacked: StackedBM25, *,
                 hbm_budget_bytes: int = 10 << 30,
                 qc_sizes: Tuple[int, ...] = (8, 256),
                 cold_df: int = COLD_DF,
                 total_docs: Optional[int] = None,
                 avgdl: Optional[float] = None,
                 df_of: Optional[Callable[[str], int]] = None,
                 device=None):
        if stacked.n_shards != 1:
            raise ValueError("TurboBM25 serves one partition")
        self.device = _device.resolve(device)
        if self.device.type == "cuda":
            from elasticsearch_tpu_torch.parallel.cuda_build import build_all

            build_all()          # a build failure surfaces here, not mid-query
        dev = self.device
        self.fp = stacked.postings[0]
        self.cold_df = int(cold_df)
        self._total_docs = int(total_docs) if total_docs else stacked.total_docs
        self._avgdl = float(avgdl) if avgdl else stacked.avgdl
        self._df_of = df_of
        self.D = stacked.doc_counts[0]
        self.Dp = -(-self.D // SW) * SW
        self.nsw = self.Dp // SW
        self.dp_rows = self.Dp // 128
        self.qc_sizes = tuple(sorted(
            {max(ROWS_PER_STEP,
                 -(-int(s) // ROWS_PER_STEP) * ROWS_PER_STEP)
             for s in qc_sizes}))

        fp = self.fp
        pad = np.zeros((MAX_GROUP_ROWS, 128), np.int32)
        self._lane_docs_host = np.concatenate([fp.block_docs, pad], axis=0)
        self.lane_docs = torch.from_numpy(self._lane_docs_host).to(dev)
        bs = _host_block_scores(fp, self._avgdl)
        self._lane_scores_host = np.concatenate(
            [bs, pad.astype(np.float32)], axis=0)
        self.lane_scores = torch.from_numpy(self._lane_scores_host).to(dev)
        self._host_scores = bs       # [T, 128] idf-free lane scores
        # per-block doc ranges for group building (pad lanes are 0 so the
        # row max is the true last doc; row 0 is the reserved zero block)
        self._blo = fp.block_docs[:, 0].astype(np.int64)
        self._bhi = fp.block_docs.max(axis=1).astype(np.int64)

        lh = stacked.live_host[0] if stacked.live_host is not None else None
        lv = np.zeros(self.Dp, np.float32)
        if lh is None:
            lv[: self.D] = 1.0
        else:
            lv[: self.D] = lh[: self.D].astype(np.float32)
        self.live = torch.from_numpy(lv.reshape(self.dp_rows, 128)).to(dev)
        self._live_host = lv

        # column cache: slots + 1 scratch slot (2 bytes per doc per slot)
        slots = max(int(hbm_budget_bytes // (2 * self.Dp)), 32)
        n_colizable = int((fp.doc_freq >= self.cold_df).sum())
        slots = min(slots, max(n_colizable, 1) + 8)
        self.Hp = ((slots + 31) // 32) * 32
        self.cols_hi, self.cols_lo = self._zero_columns()
        self._slot_of: Dict[str, int] = {}
        self._lru: Dict[str, int] = {}
        self._free = list(range(self.Hp))
        self._pending_zero: List[tuple] = []
        self._tick = 0
        self._terms: Dict[str, Optional[_TermInfo]] = {}
        self._phrases: Dict[str, Optional[_PhraseInfo]] = {}
        # per-cache-key tile bases touched by the key's build groups, so
        # eviction zeroes exactly those tiles, phrases' included
        self._tile_bases: Dict[str, np.ndarray] = {}
        self.part_id = 0
        # bumped whenever the column cache changes; the bitsets are
        # re-packed from it when they are older
        self.cols_epoch = 0
        # packed per-slot presence bitsets (ES_TPU_BITSET), [Hp+2, rows,
        # 128] i32: packed on the first bitset dispatch
        self.bits: Optional[torch.Tensor] = None
        self._bits_epoch = -1
        # eager sparse slices: a lazily grown device pool of packed granules
        # with an authoritative host mirror
        self._sp_pool: Optional[torch.Tensor] = None    # [G, 8, 128] i32
        self._sp_host: Optional[np.ndarray] = None
        self._sp_of: Dict[str, Tuple[int, int, int, float]] = {}
        #   term -> (granule start, n granules, padded width, quant scale)
        self._sp_lru: Dict[str, int] = {}
        self._sp_free: Dict[int, List[int]] = {}
        self._sp_next = 1                     # granule 0 reserved all-zero
        self._sp_cap = max(2, min(int(hbm_budget_bytes) // 4, 64 << 20)
                           // (SPARSE_GRAN * 4))
        self._sp_ok = self.Dp <= _SPARSE_DOC_LIMIT
        # the pending K3 group while _sparse_contrib_many runs
        self._sp_group: Optional[_SparseGroup] = None
        # serializes what reads or updates the cache state
        self._serve_lock = threading.RLock()
        # guards the counters bumped outside _serve_lock (_bump)
        self._stats_lock = threading.Lock()
        self.stats = {"builds": 0, "build_s": 0.0, "fallbacks": 0,
                      "cold_queries": 0, "dispatches": 0, "degraded": 0,
                      "phrase_builds": 0, "bool_host": 0, "bool_device": 0,
                      "bitset_packs": 0, "bitset_gallop": 0,
                      "bitset_blocks_skipped": 0, "bitset_bytes": 0,
                      "sparse_queries": 0, "sparse_slices": 0,
                      "sparse_bytes": 0, "sparse_fallbacks": 0}
        self._hbm = hbm_ledger.register_engine(self, "turbo")
        self._register_hbm_regions()

    def _zero_columns(self):
        shape = (self.dp_rows // 16, self.Hp + 1, 16, 128)
        return (torch.zeros(shape, dtype=torch.int8, device=self.device),
                torch.zeros(shape, dtype=torch.int8, device=self.device))

    def _register_hbm_regions(self) -> None:
        self._hbm.set_region("cols_hi", self.cols_hi.nbytes)
        self._hbm.set_region("cols_lo", self.cols_lo.nbytes)
        self._hbm.set_region("cols_bits",
                             0 if self.bits is None else self.bits.nbytes)
        self._hbm.set_region(
            "sparse_pool",
            0 if self._sp_pool is None else self._sp_pool.nbytes)
        self._hbm.set_region("lane_docs", self.lane_docs.nbytes)
        self._hbm.set_region("lane_scores", self.lane_scores.nbytes)
        self._hbm.set_region("live", self.live.nbytes)

    def hbm_bytes(self) -> int:
        return (self.cols_hi.nbytes + self.cols_lo.nbytes
                + (0 if self.bits is None else self.bits.nbytes)
                + (0 if self._sp_pool is None else self._sp_pool.nbytes)
                + self.lane_docs.nbytes + self.lane_scores.nbytes
                + self.live.nbytes)

    # ---------------- term metadata ----------------

    def _term(self, term: str) -> Optional[_TermInfo]:
        if term in self._terms:
            return self._terms[term]
        fp = self.fp
        o = fp.ord(term)
        if o < 0:
            self._terms[term] = None
            return None
        df = int(fp.doc_freq[o])
        start, cnt = int(fp.block_start[o]), int(fp.block_count[o])
        smax = float(self._host_scores[start: start + cnt].max()) if cnt else 0.0
        # df for cache/cold decisions is partition-local; idf uses the
        # global df when an override is installed
        df_g = self._df_of(term) if self._df_of is not None else df
        info = _TermInfo(ord=o, df=df,
                         idf=bm25_idf(self._total_docs, df_g),
                         row_start=start, n_rows=cnt, smax=smax)
        self._terms[term] = info
        return info

    def _bump(self, key: str, n: int = 1) -> None:
        """stats[key] += n for the counters the host rescore bumps outside
        _serve_lock (fallbacks, bool_host)."""
        with self._stats_lock:
            self.stats[key] += n

    def extend_qc_sizes(self, sizes) -> None:
        """Widen the dispatch-width ladder (the adaptive scheduler's bucket
        hook), with the same ROWS_PER_STEP rounding as the constructor:
        each width is one more sweep launch shape. Monotonic and
        idempotent."""
        merged = set(self.qc_sizes)
        merged.update(
            max(ROWS_PER_STEP, -(-int(s) // ROWS_PER_STEP) * ROWS_PER_STEP)
            for s in sizes)
        self.qc_sizes = tuple(sorted(merged))
        hbm_ledger.note_primed("turbo", self.qc_sizes)
        hbm_ledger.note_primed("turbo_bitset", self.qc_sizes)

    # ---------------- column cache ----------------

    def _term_groups(self, info: _TermInfo, slot: int):
        """(rows, nrows, bases, slots) arrays for one term's build groups."""
        rows = slice(info.row_start, info.row_start + info.n_rows)
        return _tile_groups(self._blo[rows], self._bhi[rows], info.row_start,
                            slot)

    def _evict(self, key: str) -> None:
        slot = self._slot_of.pop(key)
        del self._lru[key]
        self._free.append(slot)
        # zero the evicted key's touched tiles so the reused slot carries
        # no phantom scores (nrows = 0 groups write zero tiles)
        bases = self._tile_bases.pop(key, None)
        if bases is not None and len(bases):
            z = np.zeros(len(bases), np.int32)
            self._pending_zero.append(
                (z, z, bases, np.full(len(bases), slot, np.int32)))
        self._hbm.note_eviction(freed_bytes=2 * self.Dp)
        self._hbm.note_zeroed_tiles(0 if bases is None else len(bases))
        if key.startswith("\x00p:"):
            # a phrase's (docs, pf) arrays go with its column
            self._phrases.pop(key, None)

    def _reset_columns(self) -> None:
        """Drop the whole column cache: after a failed build the slot
        contents are unknown, so the cache restarts empty."""
        self.cols_hi, self.cols_lo = self._zero_columns()
        self._hbm.note_eviction(count=len(self._slot_of),
                                freed_bytes=2 * self.Dp * len(self._slot_of))
        self._slot_of.clear()
        self._lru.clear()
        self._free = list(range(self.Hp))
        self._pending_zero = []
        self._tile_bases.clear()
        self.cols_epoch += 1
        self._register_hbm_regions()

    def _build_groups(self, parts, lane_docs=None, lane_scores=None) -> None:
        """One K1 launch over the concatenated (rows, nrows, bases, slots)
        group arrays, reading the engine's posting lanes unless others are
        given."""
        if not parts:
            return
        arrs = [torch.from_numpy(np.concatenate([p[i] for p in parts]))
                .to(self.device) for i in range(4)]
        kernels.build_columns(
            *arrs, self.lane_docs if lane_docs is None else lane_docs,
            self.lane_scores if lane_scores is None else lane_scores,
            self.cols_hi, self.cols_lo)

    @_serialized
    def ensure_columns(self, terms: Sequence[str],
                       protect_extra: Sequence[str] = ()) -> None:
        # injected faults fire before any slot-pool mutation
        faults.fault_point("column_upload", self.part_id)
        self._tick += 1
        need: List[Tuple[str, _TermInfo]] = []
        sparse_need: List[Tuple[str, _TermInfo]] = []
        for t in dict.fromkeys(terms):
            info = self._term(t)
            if info is None or info.df < self.cold_df:
                if info is not None and info.df:
                    sparse_need.append((t, info))
                continue
            if t in self._slot_of:
                self._lru[t] = self._tick
                continue
            need.append((t, info))
        # eager sparse slices ride the same upload pass as the columns
        if sparse_need and self._sp_ok and bool(knob("ES_TPU_SPARSE")):
            try:
                self._ensure_sparse(sparse_need)
            except DeviceFaultError:
                pass   # query-time gather retries, then host-falls-back
        if not need:
            return
        protect = set(t for t, _ in need) | set(terms) | set(protect_extra)
        self._hbm.note_protect_pressure(
            sum(1 for t in self._slot_of if t in protect) + len(need),
            self.Hp)
        deficit = len(need) - len(self._free)
        if deficit > 0:
            victims = [t for t in sorted(self._lru, key=self._lru.get)
                       if t not in protect][:deficit]
            if len(victims) < deficit:
                # capacity overflow: colize the highest-df terms and leave
                # the rest cold for this batch (scored exactly on the host)
                capacity = len(self._free) + len(victims)
                need.sort(key=lambda ti: -ti[1].df)
                self.stats["degraded"] += len(need) - capacity
                need = need[:capacity]
            for v in victims:
                self._evict(v)
        zero_parts, self._pending_zero = self._pending_zero, []
        if not need and not zero_parts:
            return
        build_parts = []
        for t, info in need:
            slot = self._free.pop()
            self._slot_of[t] = slot
            self._lru[t] = self._tick
            groups = self._term_groups(info, slot)
            self._tile_bases[t] = groups[2]
            build_parts.append(groups)
        t0 = time.monotonic()
        try:
            with faults.device_errors("column_upload", self.part_id):
                # the zeroing of evicted tiles launches first, on its own:
                # a reused slot's new tiles may coincide with them, and on
                # the card the blocks of one launch run in no order (the
                # reference's sequential grid put them first in one launch)
                self._build_groups(zero_parts)
                self._build_groups(build_parts)
        except DeviceFaultError:
            self._reset_columns()
            raise
        self.cols_epoch += 1
        self.stats["builds"] += len(need)
        self.stats["build_s"] += time.monotonic() - t0
        self._register_hbm_regions()

    # ---------------- phrase columns ----------------

    def _phrase(self, terms: Sequence[str]) -> Optional[_PhraseInfo]:
        """Metadata for a slop-0 phrase (cached; None if a member term is
        missing from this partition). The full-corpus positions scan runs
        once per phrase; its (docs, pf) arrays then back both the
        adjacency-column build and the exact host rescore."""
        terms = tuple(terms)
        key = _pkey(terms)
        if key in self._phrases:
            return self._phrases[key]
        infos = [self._term(t) for t in terms]
        if any(i is None for i in infos):
            self._phrases[key] = None
            return None
        docs, pf = phrase_freqs(self.fp, list(terms), slop=0)
        docs = np.asarray(docs, np.int32)
        pf = np.asarray(pf, np.float32)
        # idf-free phrase lane scores: a term's BM25 lane score with tf :=
        # phrase freq, so the K1_PLUS1 bound and the quantization hold
        smax = 0.0
        if len(docs):
            dl = self.fp.doc_len[docs]
            denom = pf + _K1 * (1.0 - _B + _B * dl / max(self._avgdl, 1e-9))
            smax = float((pf * (_K1 + 1.0) / denom).max())
        info = _PhraseInfo(
            key=key, terms=terms, docs=docs, pf=pf,
            idf_sum=float(sum(i.idf for i in infos)), smax=smax)
        self._phrases[key] = info
        return info

    def _phrase_lane(self, info: _PhraseInfo) -> np.ndarray:
        """f32 idf-free lane scores aligned with info.docs."""
        dl = self.fp.doc_len[info.docs]
        denom = info.pf + _K1 * (1.0 - _B + _B * dl
                                 / max(self._avgdl, 1e-9))
        return (info.pf * (_K1 + 1.0) / denom).astype(np.float32)

    @_serialized
    def ensure_phrases(self, phrase_lists: Sequence[Sequence[str]],
                       protect_extra: Sequence[str] = ()) -> None:
        """Colize slop-0 phrases: pack each phrase's (docs, lane score)
        pairs into synthetic 128-wide lane arrays and run them through the
        same K1 build and LRU slot pool as term columns (eviction and
        zeroing shared through _evict)."""
        faults.fault_point("column_upload", self.part_id)
        self._tick += 1
        need: List[_PhraseInfo] = []
        for terms in dict.fromkeys(tuple(p) for p in phrase_lists):
            info = self._phrase(terms)
            if info is None or not len(info.docs):
                continue
            if info.key in self._slot_of:
                self._lru[info.key] = self._tick
                continue
            need.append(info)
        if not need:
            return
        protect = {i.key for i in need} | set(protect_extra)
        deficit = len(need) - len(self._free)
        if deficit > 0:
            victims = [t for t in sorted(self._lru, key=self._lru.get)
                       if t not in protect][:deficit]
            if len(victims) < deficit:
                # capacity overflow: grant the phrases with the most docs
                # and leave the rest to the exact host path this batch
                capacity = len(self._free) + len(victims)
                need.sort(key=lambda pi: -len(pi.docs))
                self.stats["degraded"] += len(need) - capacity
                need = need[:capacity]
            for v in victims:
                self._evict(v)
        zero_parts, self._pending_zero = self._pending_zero, []
        if not need and not zero_parts:
            return
        build_parts, drows, dvals = [], [], []
        cursor = 0
        for info in need:
            slot = self._free.pop()
            self._slot_of[info.key] = slot
            self._lru[info.key] = self._tick
            lane = self._phrase_lane(info)
            nr = -(-len(info.docs) // 128)
            d2 = np.zeros((nr, 128), np.int32)
            v2 = np.zeros((nr, 128), np.float32)
            d2.ravel()[: len(info.docs)] = info.docs
            v2.ravel()[: len(info.docs)] = lane
            # docs ascend, and the zero pad lanes keep each row's max its
            # true last doc
            groups = _tile_groups(d2[:, 0].astype(np.int64),
                                  d2.max(axis=1).astype(np.int64), cursor,
                                  slot)
            build_parts.append(groups)
            self._tile_bases[info.key] = groups[2]
            drows.append(d2)
            dvals.append(v2)
            cursor += nr
        pad_rows = _row_bucket(cursor) + MAX_GROUP_ROWS - cursor
        drows.append(np.zeros((pad_rows, 128), np.int32))
        dvals.append(np.zeros((pad_rows, 128), np.float32))
        t0 = time.monotonic()
        try:
            with faults.device_errors("column_upload", self.part_id):
                self._build_groups(zero_parts)
                if build_parts:
                    self._build_groups(
                        build_parts,
                        torch.from_numpy(np.concatenate(drows)).to(
                            self.device),
                        torch.from_numpy(np.concatenate(dvals)).to(
                            self.device))
        except DeviceFaultError:
            self._reset_columns()
            raise
        self.cols_epoch += 1
        self.stats["builds"] += len(need)
        self.stats["phrase_builds"] += len(need)
        self.stats["build_s"] += time.monotonic() - t0

    @_serialized
    def prebuild_columns(self) -> int:
        """Build every colizable term's column now (capacity-capped, by df
        desc), so no timed query pays a build."""
        fp = self.fp
        terms = [fp.terms[o] for o in
                 np.nonzero(np.asarray(fp.doc_freq) >= self.cold_df)[0]]
        terms.sort(key=lambda t: -int(fp.doc_freq[fp.term_to_ord[t]]))
        terms = terms[: self.Hp]
        self.ensure_columns(terms)
        return len(terms)

    # ---------------- cold tier ----------------

    def _cold_contrib(self, cold_terms):
        """(docs i64 unique-sorted, contrib f64) — the cold terms' summed
        contributions at their own postings (exact host enumeration)."""
        fp = self.fp
        arrs, vals = [], []
        for _, b, info in cold_terms:
            lo, hi = (int(fp.post_start[info.ord]),
                      int(fp.post_start[info.ord + 1]))
            arrs.append(np.asarray(fp.post_doc[lo:hi], np.int64))
            lanes = self._host_scores[
                info.row_start: info.row_start + info.n_rows
            ].ravel()[: hi - lo]
            vals.append(float(info.idf * b) * lanes.astype(np.float64))
        docs = np.concatenate(arrs)
        u, inv = np.unique(docs, return_inverse=True)
        acc = np.zeros(len(u), np.float64)
        np.add.at(acc, inv, np.concatenate(vals))
        return u, acc

    def _sp_grow(self, new_g: int) -> None:
        """Grow (or first-allocate) the granule pool; the host mirror is
        authoritative and growth re-uploads it whole. The device pool is a
        copy on the CPU too, so the mirror never stands in for a missed
        upload."""
        old = self._sp_host
        host = np.zeros((new_g, SPARSE_GRAN // 128, 128), np.int32)
        if old is not None:
            host[: old.shape[0]] = old
        self._sp_host = host
        with faults.device_errors("sparse_gather", self.part_id):
            self._sp_pool = torch.tensor(host, device=self.device)
        self._hbm.set_region("sparse_pool", self._sp_pool.nbytes)

    def _sp_evict(self, term: str) -> None:
        g0, n_g, w, _ = self._sp_of.pop(term)
        self._sp_lru.pop(term, None)
        self._sp_free.setdefault(n_g, []).append(g0)
        self.stats["sparse_bytes"] -= w * 4

    def _reset_sparse(self) -> None:
        """Drop every slice (fault containment): zero both sides of the
        pool so mirror and device agree, and rebuild lazily. A pending K3
        group is launched first, while its granules are still there."""
        self._sp_flush()
        if self._sp_group is not None:
            self._sp_group.dirty = []
        self.stats["sparse_bytes"] = 0
        self._sp_of.clear()
        self._sp_lru.clear()
        self._sp_free.clear()
        self._sp_next = 1
        if self._sp_host is not None:
            self._sp_host[:] = 0
            self._sp_pool = torch.tensor(self._sp_host, device=self.device)

    def _sp_alloc(self, n_g: int, protect: set) -> int:
        """One granule run for an `n_g`-granule slice, or -1: the width's
        free list, then the bump pointer (growing the pool toward its cap),
        then LRU eviction."""
        free = self._sp_free.get(n_g)
        if free:
            return free.pop()
        cur = 0 if self._sp_pool is None else self._sp_pool.shape[0]
        if self._sp_next + n_g > cur and cur < self._sp_cap:
            self._sp_grow(min(self._sp_cap,
                              max(cur * 2, self._sp_next + n_g, 64)))
            cur = self._sp_pool.shape[0]
        if self._sp_next + n_g <= cur:
            g0 = self._sp_next
            self._sp_next += n_g
            return g0
        for t in sorted(self._sp_lru, key=self._sp_lru.get):
            if t in protect or t not in self._sp_of:
                continue
            if self._sp_group is not None and t in self._sp_group.terms:
                # flush-before-evict: the pending group reads t's granules,
                # which the caller may overwrite once t is gone
                self._sp_flush()
            self._sp_evict(t)
            free = self._sp_free.get(n_g)
            if free:
                return free.pop()
        return -1

    def _ensure_sparse(self, pairs: Sequence[Tuple[str, _TermInfo]]) -> bool:
        """Build device slices for cold (term, info) pairs: pack granules
        on the host mirror, then write them into the device pool in place
        (index_copy_, where the reference donated the pool); while a K3
        group is pending the upload waits for its launch, one for the
        group. Impacts are uint8 on a per-term scale smax/255, rounded to
        >= 1 so a real posting never vanishes: a granule holds its term's
        docs in ascending order, then zero lanes, as K3 requires. False
        when any term cannot be sliced."""
        if not self._sp_ok:
            return False
        widths = _sparse_widths()
        self._tick += 1
        need: List[Tuple[str, _TermInfo, int]] = []
        protect = set()
        for t, info in pairs:
            protect.add(t)
            if t in self._sp_of:
                self._sp_lru[t] = self._tick
                continue
            w = next((w for w in widths if w >= info.df), None)
            if w is None:
                return False
            need.append((t, info, w))
        if not need:
            return True
        fp = self.fp
        idx_l = []
        complete = True
        try:
            for t, info, w in need:
                n_g = w // SPARSE_GRAN
                g0 = self._sp_alloc(n_g, protect)
                if g0 < 0:
                    # pool full: the slices packed so far are still
                    # uploaded below — they are marked resident, and the
                    # reference (turbo.py:945) returned here before its
                    # upload, leaving them stale on the device
                    complete = False
                    break
                lo = int(fp.post_start[info.ord])
                hi = int(fp.post_start[info.ord + 1])
                docs = np.asarray(fp.post_doc[lo:hi], np.int64)
                lanes = self._host_scores[
                    info.row_start: info.row_start + info.n_rows
                ].ravel()[: hi - lo].astype(np.float64)
                sscale = max(float(info.smax), 1e-9) / SPARSE_IMP_MAX
                q = np.clip(np.rint(lanes / sscale),
                            1, SPARSE_IMP_MAX).astype(np.int64)
                buf = np.zeros(w, np.int64)
                buf[: hi - lo] = (docs << 8) | q
                gran = buf.astype(np.int32).reshape(
                    n_g, SPARSE_GRAN // 128, 128)
                self._sp_host[g0: g0 + n_g] = gran
                self._sp_of[t] = (g0, n_g, w, sscale)
                self._sp_lru[t] = self._tick
                idx_l.append(np.arange(g0, g0 + n_g, dtype=np.int64))
                self.stats["sparse_slices"] += 1
                self.stats["sparse_bytes"] += w * 4
                metrics.observe("sparse_slice_width", w)
            if idx_l and self._sp_group is not None:
                self._sp_group.dirty += idx_l
            elif idx_l:
                self._sp_upload(np.concatenate(idx_l))
        except DeviceFaultError:
            # a half-written pool would break mirror == device: drop it all
            self._reset_sparse()
            raise
        self._hbm.set_region("sparse_pool", self._sp_pool.nbytes)
        return complete

    def _sp_upload(self, idx: np.ndarray) -> None:
        """Copy granules `idx` of the host mirror into the device pool."""
        dev = self.device
        with faults.device_errors("sparse_gather", self.part_id):
            self._sp_pool.index_copy_(
                0, torch.from_numpy(idx).to(dev),
                torch.from_numpy(self._sp_host[idx]).to(dev))

    def _sparse_dispatch_args(self, cold_terms):
        """The K3 chunk dispatch for one query's cold terms, or None above
        _SPARSE_MAX_CHUNKS chunks: (coff, cw, ct0, ct1) numpy arrays,
        spans [(first chunk, df, post offset)] per term, and the slack
        bounding |contrib - exact|."""
        fp = self.fp
        coff: List[int] = []
        cw: List[float] = []
        ct0: List[int] = []
        ct1: List[int] = []
        spans: List[Tuple[int, int, int]] = []
        slack = 1e-7
        for t, b, info in cold_terms:
            g0, n_g, _w, sscale = self._sp_of[t]
            wt = float(info.idf * b)
            lo = int(fp.post_start[info.ord])
            c0 = len(coff)
            n_used = -(-info.df // SPARSE_GRAN)
            for j in range(n_used):
                s = lo + j * SPARSE_GRAN
                e = min(lo + (j + 1) * SPARSE_GRAN, lo + info.df)
                coff.append(g0 + j)
                cw.append(wt * sscale)
                ct0.append(int(fp.post_doc[s]) // TILE)
                ct1.append(int(fp.post_doc[e - 1]) // TILE)
            spans.append((c0, info.df, lo))
            # one posting per (term, doc): quantization error <= one full
            # step per term, plus a generous f32-accumulation margin
            slack += abs(wt) * (sscale
                                + 3e-6 * max(float(info.smax), sscale))
        if len(coff) > _SPARSE_MAX_CHUNKS:
            return None
        args = (np.asarray(coff, np.int32), np.asarray(cw, np.float32),
                np.asarray(ct0, np.int32), np.asarray(ct1, np.int32))
        return args, spans, float(slack)

    def _sparse_group_args(self, preps):
        """One launch's K3 inputs for a group's dispatches, as one int32
        array [coff | ct0 | ct1 | qoff | cw's bits], and n_rc."""
        n = [len(p[0][0]) for p in preps]
        qoff = np.zeros(len(preps) + 1, np.int32)
        np.cumsum(n, out=qoff[1:])
        coff, cw, ct0, ct1 = (np.concatenate([p[0][i] for p in preps])
                              for i in range(4))
        n_gran = int(self._sp_pool.shape[0])
        # the wrapper's range check, here on the host (no read-back)
        if ((coff < 0) | (coff >= n_gran)).any():
            raise ValueError(f"K3 dispatch names a granule outside the "
                             f"pool [0, {n_gran})")
        return np.concatenate([coff, ct0, ct1, qoff, cw.view(np.int32)]), \
            int(qoff[-1])

    def _sparse_launch(self, preps):
        """One K3 launch for a group's dispatches (prep = _sparse_dispatch_
        args' triple): one upload, one read-back through pinned memory.
        Per dispatch (docs, contrib, slack), mirroring _cold_contrib's
        unique-doc enumeration; raises DeviceFaultError on device faults."""
        meta, n_rc = self._sparse_group_args(preps)
        n_q = len(preps)
        dev = self.device
        cuda = dev.type == "cuda"
        first = hbm_ledger.note_dispatch("turbo_sparse", "batched")
        t0 = time.monotonic()
        with faults.device_errors("sparse_gather", self.part_id):
            m = torch.from_numpy(meta)
            m = m.pin_memory().to(dev, non_blocking=True) if cuda \
                else m.to(dev)
            coff, cw, ct0, ct1, qoff = _group_views(m, n_rc, n_q)
            out = kernels.sparse_gather(
                coff, cw, ct0, ct1, self._sp_pool, n_tiles=self.Dp // TILE,
                qoff=qoff, host_checked=True)
            if cuda:
                host = torch.empty(out.shape, dtype=torch.float32,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                torch.cuda.current_stream(dev).synchronize()
                out = host
            flat = out.numpy().reshape(n_rc * SPARSE_GRAN)
        if first:
            hbm_ledger.note_compile_done("turbo_sparse", "batched",
                                         time.monotonic() - t0)
        fp = self.fp
        res = []
        q0 = 0
        for (args, spans, slack) in preps:
            docs_l, vals_l = [], []
            for c0, df, lo in spans:
                docs_l.append(np.asarray(fp.post_doc[lo: lo + df], np.int64))
                base = (q0 + c0) * SPARSE_GRAN
                vals_l.append(flat[base: base + df])
            q0 += len(args[0])
            docs = np.concatenate(docs_l)
            vals = np.concatenate(vals_l).astype(np.float64)
            # a doc shared by several slices reads the same total at every
            # occurrence — first occurrence wins
            u, fidx = np.unique(docs, return_index=True)
            res.append((u, vals[fidx], slack))
        return res

    def _sparse_fallback(self, cold_terms):
        """A query's cold side scored exactly on the host, with slack 0."""
        self.stats["sparse_fallbacks"] += 1
        u, acc = self._cold_contrib(cold_terms)
        return u, acc, 0.0

    def _sp_flush(self) -> None:
        """Launch the pending K3 group: upload the granules packed since
        the last upload, then one K3 launch for every member. A device
        fault falls the members back to the host one by one (the pool is
        kept unless its upload failed)."""
        grp = self._sp_group
        if grp is None:
            return
        members, grp.members, grp.terms = grp.members, [], set()
        try:
            if grp.dirty:
                idx = np.unique(np.concatenate(grp.dirty))
                grp.dirty = []
                try:
                    self._sp_upload(idx)
                except DeviceFaultError:
                    self._reset_sparse()
                    raise
            outs = self._sparse_launch([p for _, _, p in members]) \
                if members else []
        except DeviceFaultError:
            outs = [None] * len(members)
        for (qi, cold, _), o in zip(members, outs):
            grp.res[qi] = o if o is not None else self._sparse_fallback(cold)

    def _sparse_contrib_many(self, sides):
        """Device cold sides of a sweep chunk's queries: per query
        (docs, contrib, slack), or None where its side is empty.

        Queries are taken in order, as the reference takes them one at a
        time: the fault point, then `_ensure_sparse` with the query's own
        terms protected (so slices and evictions match), then its dispatch
        joins the pending group. The group launches once at the end, or
        earlier when a slice it reads is about to be evicted. A fault, an
        unsliceable side or one above _SPARSE_MAX_CHUNKS chunks falls back
        to the exact host enumeration with slack 0, alone."""
        grp = _SparseGroup(len(sides))
        self._sp_group = grp
        try:
            for qi, cold in enumerate(sides):
                if not cold:
                    continue
                prep = None
                try:
                    faults.fault_point("sparse_gather", self.part_id)
                    if self._sp_ok and self._ensure_sparse(
                            [(t, i) for t, _b, i in cold]):
                        prep = self._sparse_dispatch_args(cold)
                except DeviceFaultError:
                    prep = None
                if prep is None:
                    grp.res[qi] = self._sparse_fallback(cold)
                    continue
                grp.members.append((qi, cold, prep))
                grp.terms.update(t for t, _b, _i in cold)
            self._sp_flush()
        finally:
            self._sp_group = None
            if grp.dirty:     # an error left uploads out: mirror != device
                self._reset_sparse()
        return grp.res

    def _cold_sides(self, sides):
        """Per query (docs, contrib, slack) of its cold terms, or None
        where it has none: through K3 (ES_TPU_SPARSE) or on the host."""
        if self._sp_ok and bool(knob("ES_TPU_SPARSE")):
            self.stats["sparse_queries"] += sum(1 for c in sides if c)
            return self._sparse_contrib_many(sides)
        out = []
        for cold in sides:
            if cold:
                self.stats["cold_queries"] += 1
                out.append(self._cold_contrib(cold) + (0.0,))
            else:
                out.append(None)
        return out

    # ---------------- host exact scoring helpers ----------------

    def _impacts_at(self, info: _TermInfo, docs: np.ndarray) -> np.ndarray:
        """Exact idf-free impact of a term at the given doc ids (0 where
        the term does not occur)."""
        fp = self.fp
        lo, hi = int(fp.post_start[info.ord]), int(fp.post_start[info.ord + 1])
        tdocs = fp.post_doc[lo:hi]
        out = np.zeros(len(docs), np.float32)
        if not len(tdocs):
            return out
        # needles match the postings dtype, or numpy copies the postings
        docs = docs.astype(np.int32, copy=False) \
            if docs.dtype != tdocs.dtype else docs
        j = np.searchsorted(tdocs, docs)
        j_c = np.minimum(j, len(tdocs) - 1)
        present = (j < len(tdocs))
        present &= tdocs[j_c] == docs
        jp = j_c[present]
        out[present] = self._host_scores[info.row_start + (jp >> 7),
                                         jp & 127]
        return out

    def _exact_merge(self, qterms, k: int):
        """Full host posting merge (exact, any df) — the fallback when a
        certificate fails. Term-at-a-time f32 accumulation in query order,
        (score desc, doc asc) rank over live docs."""
        all_docs = []
        for _, _, info in qterms:
            fp = self.fp
            lo, hi = (int(fp.post_start[info.ord]),
                      int(fp.post_start[info.ord + 1]))
            all_docs.append(fp.post_doc[lo:hi])
        if not all_docs:
            return np.empty(0, np.float32), np.empty(0, np.int32)
        docs = np.unique(np.concatenate(all_docs))
        docs = docs[self._live_host[docs] > 0]
        totals = self._exact_scores(qterms, docs)
        pos = totals > 0
        docs, totals = docs[pos], totals[pos]
        sel = np.lexsort((docs, -totals))[:k]
        return totals[sel], docs[sel].astype(np.int32)

    def _exact_scores(self, qterms: List[Tuple[str, float, _TermInfo]],
                      docs: np.ndarray) -> np.ndarray:
        """Exact f32 totals at docs, term-at-a-time in query order."""
        total = np.zeros(len(docs), np.float32)
        for _, boost, info in qterms:
            w = np.float32(info.idf * boost)
            total = total + w * self._impacts_at(info, docs)
        return total

    # ---------------- search ----------------

    def search_many(self, batches: Sequence[List], k: int = 10, check=None):
        """Pipeline batches of queries; returns per batch (scores [Q, k]
        f32, ords [Q, k] i32). Queries are term lists or (term, boost)
        lists. check: optional cooperative-cancellation callable invoked
        between dispatches (tasks/task_manager)."""
        flat, spans = _flatten_queries(batches)
        if not flat:
            return [(np.zeros((n, k), np.float32), np.zeros((n, k), np.int32))
                    for _, n in spans]
        # exact host rescore of every doc in the collected rows, merged
        # with the cold side, outside the engine's lock
        out_s = np.zeros((len(flat), k), np.float32)
        out_d = np.zeros((len(flat), k), np.int32)
        for off, rows_all, bounds, splits, colds in self._dispatch_many(
                flat, k, check):
            for qi, split in enumerate(splits):
                docs = self._collect_docs(rows_all[qi])
                s, d = self._finish_query(
                    split, docs, float(bounds[qi]), k, colds[qi])
                out_s[off + qi, : len(s)] = s
                out_d[off + qi, : len(d)] = d
        return [(out_s[o: o + n], out_d[o: o + n]) for o, n in spans]

    @_serialized
    def _dispatch_many(self, flat, k: int, check):
        """The device passes of search_many under the engine's lock: per
        chunk (offset, picked rows [QC, n_rows] i64, row bounds [QC], each
        query's _split_terms, its cold side)."""
        self.ensure_columns(
            [t for q in flat for t, _ in q
             if self._term(t) is not None])

        # pass 1: sweep -> row pick, both on the device, launched for every
        # chunk before the host reads any of them back
        n_rows = max(_GLOBAL_ROWS, k + 5)
        pending = []
        off = 0
        while off < len(flat):
            rem = len(flat) - off
            take = next((s for s in self.qc_sizes if s >= rem),
                        self.qc_sizes[-1])
            chunk = flat[off: off + take]
            if check is not None:
                check()
            first = hbm_ledger.note_dispatch("turbo", take)
            tc0 = time.monotonic()
            rm, rr = self._sweep(chunk, take)
            with faults.device_errors("turbo_sweep", self.part_id):
                picked = _pick_rows(rm, rr, n_rows=n_rows)
            if first:
                hbm_ledger.note_compile_done(
                    "turbo", take, time.monotonic() - tc0)
            pending.append((off, len(chunk), picked))
            off += len(chunk)
        self.stats["dispatches"] += len(pending)

        # pass 2: read the small row sets back; the column split and the
        # cold side of each query while the columns are the ones swept
        out = []
        for off, n, packed_dev in pending:
            if check is not None:
                check()
            with faults.device_errors("turbo_sweep", self.part_id):
                packed = packed_dev.cpu().numpy()     # [QC, n_rows + 1]
            splits = [self._split_terms(flat[off + qi]) for qi in range(n)]
            colds = self._cold_sides([sp[2] for sp in splits])
            out.append((off, packed[:, :n_rows].astype(np.int64),
                        packed[:, n_rows], splits, colds))
        return out

    def _collect_docs(self, rw: np.ndarray) -> np.ndarray:
        """Live doc ids in one query's picked rows ([n_rows] i64, -1 =
        empty slot)."""
        rw = rw[rw >= 0]
        docs = (rw[:, None] * 128 + _LANE128[None, :]).ravel()
        if len(docs):
            docs = docs[self._live_host[docs] > 0]
        return docs

    def _sweep_weights(self, chunk, QC: int):
        """Quantized disjunctive sweep inputs for one dispatch chunk:
        (wq [2, QC, Hp+1] i8, qscale [QC, 1] f32). A None entry leaves an
        all-zero weight row."""
        wq = np.zeros((2, QC, self.Hp + 1), np.int8)
        qscale = np.ones((QC, 1), np.float32)
        for qi, terms in enumerate(chunk):
            if terms is None:
                continue
            ws = []
            for t, b in terms:
                slot = self._slot_of.get(t)
                if slot is not None:
                    ws.append((slot, self._term(t).idf * b))
            if not ws:
                continue
            _, qs2, q = _quantize_weights([w for _, w in ws])
            qscale[qi, 0] = qs2 * COLSCALE2
            for (slot, _), (wh, wl) in zip(ws, q):
                wq[0, qi, slot] = np.int8(wh)
                wq[1, qi, slot] = np.int8(wl)
        return wq, qscale

    def _sweep(self, chunk, QC):
        wq, qscale = self._sweep_weights(chunk, QC)
        with faults.device_dispatch("turbo_sweep", self.part_id):
            return kernels.sweep_rowmax(
                torch.from_numpy(qscale).to(self.device), self.cols_hi,
                self.cols_lo, torch.from_numpy(wq).to(self.device),
                self.live, nsw=self.nsw)

    def _split_terms(self, terms):
        """(qterms, col_terms, cold_terms) of one query's known terms, each
        [(term, boost, info)]: colized = owns a column now. Neither the
        sweep nor the cold tier changes the columns, so the split mirrors
        what _sweep dispatched and the certificate stays sound."""
        qterms, col_terms, cold_terms = [], [], []
        for t, b in terms:
            info = self._term(t)
            if info is None:
                continue
            qterms.append((t, b, info))
            (col_terms if t in self._slot_of else cold_terms).append(
                (t, b, info))
        return qterms, col_terms, cold_terms

    def _finish_query(self, split, cand_docs, bound, k, cold):
        """Merge device-collected candidates + the cold side into an exact
        top-k.

        split — _split_terms of the query; cand_docs [C] live doc ids from
        the collected rows — every one is rescored exactly here; bound —
        the max approximate score any uncollected row could hold (the row
        pick's last column); cold — the cold side's (docs, contrib, slack)
        from _cold_sides, None without cold terms."""
        qterms, col_terms, cold_terms = split
        if not qterms:
            return np.empty(0, np.float32), np.empty(0, np.int32)

        # quantization error bound for the device side (the weights
        # _sweep_weights dispatched)
        e_q = _quant_error([info.idf * b for _, b, info in col_terms])

        cand_s = np.empty(0, np.float32)
        if len(cand_docs):
            cand_docs = np.asarray(cand_docs, np.int64)
            cand_s = self._exact_scores(qterms, cand_docs)
            keep = cand_s > 0
            cand_docs, cand_s = cand_docs[keep], cand_s[keep]

        # cold side, bound-pruned: a doc whose cold contribution plus the
        # colized terms' maximum addend cannot reach the candidate k-th
        # score needs no exact lookup
        cold_docs = np.empty(0, np.int64)
        cold_s = np.empty(0, np.float32)
        if cold_terms:
            docs_c, contrib, slack = cold
            lv = self._live_host[docs_c] > 0
            docs_c, contrib = docs_c[lv], contrib[lv]
            if col_terms:
                kth_0 = 0.0
                if len(cand_s) >= k:
                    kth_0 = float(np.partition(cand_s, len(cand_s) - k)[
                        len(cand_s) - k])
                col_const = sum(info.idf * b * info.smax
                                for _, b, info in col_terms)
                # slack keeps the survivor set a superset of the host
                # path's; extras are rescored exactly and rank below k
                survivors = docs_c[contrib + slack + col_const + 1e-5
                                   >= kth_0]
                if len(survivors):
                    cold_docs = survivors
                    cold_s = self._exact_scores(qterms, cold_docs)
            else:
                # cold-only query: the exact path is the full merge
                cold_docs = docs_c
                cold_s = self._exact_scores(qterms, cold_docs)

        if not len(cand_docs) and not len(cold_docs):
            return np.empty(0, np.float32), np.empty(0, np.int32)
        docs = np.concatenate([cand_docs, cold_docs])
        totals = np.concatenate([cand_s, cold_s])
        docs, first = np.unique(docs, return_index=True)
        totals = totals[first]
        pos = totals > 0
        docs, totals = docs[pos], totals[pos]
        if not len(docs):
            return np.empty(0, np.float32), np.empty(0, np.int32)
        sel = np.lexsort((docs, -totals))[:k]
        out_s, out_d = totals[sel], docs[sel].astype(np.int32)

        # ---- certificate ----
        if col_terms:
            uncollected = float(bound)
            limit = uncollected + e_q
            kth = float(out_s[k - 1]) if len(out_s) >= k else 0.0
            short = len(out_s) < k and uncollected > 0
            if short or (len(out_s) >= k and kth < limit and uncollected > 0):
                self._bump("fallbacks")
                return self._exact_merge(qterms, k)
        return out_s, out_d

    # ---------------- bool queries and phrases ----------------

    def _resolve_bool(self, spec: dict) -> Optional[_BoolQuery]:
        """Resolve one bool spec; None means provably zero matches.

        spec keys (all optional): "must"/"should" [(term, boost)],
        "filter"/"must_not" [term], "phrases" [(terms, slop, boost)]."""
        conj, should, filters, must_not, phrases = [], [], [], [], []
        for t, b in spec.get("must", ()):
            info = self._term(t)
            if info is None:
                return None
            conj.append((t, float(b), info))
        for t in spec.get("filter", ()):
            info = self._term(t)
            if info is None:
                return None
            filters.append((t, info))
        for t, b in spec.get("should", ()):
            info = self._term(t)
            if info is not None:
                should.append((t, float(b), info))
        req_names = {t for t, _, _ in conj} | {t for t, _ in filters}
        for t in spec.get("must_not", ()):
            if t in req_names:
                return None          # required AND prohibited
            info = self._term(t)
            if info is not None:
                must_not.append((t, info))
        phrase_specs = [(tuple(p[0]), int(p[1]), float(p[2]))
                        for p in spec.get("phrases", ())]
        req_infos = [i for _, _, i in conj] + [i for _, i in filters]
        dev = (all(i.df >= self.cold_df for i in req_infos)
               and all(s == 0 for _, s, _ in phrase_specs)
               and len(req_infos) + len(phrase_specs) <= _MAX_REQ
               and bool(any(b != 0.0 for _, b, _ in conj) or should
                        or any(b != 0.0 for _, _, b in phrase_specs)))
        for terms, slop, boost in phrase_specs:
            infos = [self._term(t) for t in terms]
            if any(i is None for i in infos):
                return None          # phrase term absent: no phrase match
            idf_sum = float(sum(i.idf for i in infos))
            pinfo = None
            if slop == 0 and (dev or
                              self._phrases.get(_pkey(terms)) is not None):
                # the full-corpus phrase scan only for queries headed to the
                # device (host-routed ones verify positions filtered to the
                # term intersection instead)
                pinfo = self._phrase(terms)
                if pinfo is None or not len(pinfo.docs):
                    return None      # required phrase matches nothing
            phrases.append((terms, slop, boost, pinfo, idf_sum))
        return _BoolQuery(conj=conj, should=should, filters=filters,
                          must_not=must_not, phrases=phrases,
                          dev_candidate=dev)

    def _bool_resident(self, r: _BoolQuery) -> bool:
        for t, _, _ in r.conj:
            if t not in self._slot_of:
                return False
        for t, _ in r.filters:
            if t not in self._slot_of:
                return False
        for terms, _, _, pinfo, _ in r.phrases:
            if pinfo is None or pinfo.key not in self._slot_of:
                return False
        return True

    def _ensure_bool(self, resolved: Sequence[Optional[_BoolQuery]]):
        """Warm term and adjacency columns for the device-candidate queries
        of a resolved batch."""
        ens_terms: List[str] = []
        ens_phr: List[Tuple[str, ...]] = []
        pkeys = set()
        for r in resolved:
            if r is None or not r.dev_candidate:
                continue
            ens_terms += [t for t, _, _ in r.conj]
            ens_terms += [t for t, _ in r.filters]
            # cold SHOULD terms ride along: ensure_columns skips them for
            # the column cache but slices them for K3
            ens_terms += [t for t, _, _ in r.should]
            ens_terms += [t for t, i in r.must_not
                          if i.df >= self.cold_df]
            for terms, _, _, pinfo, _ in r.phrases:
                if pinfo is not None:
                    ens_phr.append(pinfo.terms)
                    pkeys.add(pinfo.key)
        if ens_terms:
            self.ensure_columns(ens_terms, protect_extra=pkeys)
        if ens_phr:
            self.ensure_phrases(ens_phr,
                                protect_extra=set(ens_terms) | pkeys)

    def _bool_routes(self, resolved: Sequence[Optional[_BoolQuery]]):
        """(device_idx, host_idx) after columns are ensured: device iff the
        query is a device candidate and every required column is resident
        now."""
        device_idx: List[int] = []
        host_idx: List[int] = []
        for qi, r in enumerate(resolved):
            if r is None:
                continue
            if r.dev_candidate and self._bool_resident(r):
                device_idx.append(qi)
            else:
                host_idx.append(qi)
        return device_idx, host_idx

    def _bool_slots(self, r: _BoolQuery):
        """(scoring [(slot, w, smax)], required slots, must_not slots) over
        columns resident now — what the sweep quantizes, handed to
        _finish_bool so the certificate's e_q mirrors the dispatch."""
        ws: Dict[int, float] = {}
        smax: Dict[int, float] = {}
        req = set()
        for t, b, info in r.conj:
            slot = self._slot_of.get(t)
            if slot is None:
                continue
            ws[slot] = ws.get(slot, 0.0) + info.idf * b
            smax[slot] = info.smax
            req.add(slot)
        for t, info in r.filters:
            slot = self._slot_of.get(t)
            if slot is not None:
                req.add(slot)
        for t, b, info in r.should:
            slot = self._slot_of.get(t)
            if slot is not None:
                ws[slot] = ws.get(slot, 0.0) + info.idf * b
                smax[slot] = info.smax
        for terms, _, boost, pinfo, idf_sum in r.phrases:
            if pinfo is None:
                continue
            slot = self._slot_of.get(pinfo.key)
            if slot is not None:
                ws[slot] = ws.get(slot, 0.0) + idf_sum * boost
                smax[slot] = pinfo.smax
                req.add(slot)
        mn = set()
        for t, info in r.must_not:
            slot = self._slot_of.get(t)
            if slot is not None and slot not in req:
                mn.add(slot)
        scoring = [(s, w, smax[s]) for s, w in ws.items() if w != 0.0]
        return scoring, req, mn

    def _bool_weights(self, chunk, QC: int):
        """Quantized conjunctive sweep inputs for one dispatch chunk:
        (wq [2, QC, Hp+1] i8, wp [QC, Hp+1] i8, nreq [QC, 1] i32,
        qscale [QC, 1] f32). Padding rows stay all zero: nreq 0 keeps the
        coverage test vacuous and zero weights score 0, so they never
        surface."""
        wq = np.zeros((2, QC, self.Hp + 1), np.int8)
        wp = np.zeros((QC, self.Hp + 1), np.int8)
        nreq = np.zeros((QC, 1), np.int32)
        qscale = np.ones((QC, 1), np.float32)
        for qi, r in enumerate(chunk):
            if r is None:
                continue
            scoring, req, mn = self._bool_slots(r)
            nreq[qi, 0] = len(req)
            for s in req:
                wp[qi, s] = 1
            for s in mn:
                # one prohibited presence pushes coverage below 0, which
                # no subset of +1 weights reaches (n_req <= 126 fits int8)
                wp[qi, s] = np.int8(-(len(req) + 1))
            if not scoring:
                continue
            _, qs2, q = _quantize_weights([w for _, w, _ in scoring])
            qscale[qi, 0] = qs2 * COLSCALE2
            for (slot, _, _), (wh, wl) in zip(scoring, q):
                wq[0, qi, slot] = np.int8(wh)
                wq[1, qi, slot] = np.int8(wl)
        return wq, wp, nreq, qscale

    def _sweep_bool(self, chunk: Sequence[_BoolQuery], QC: int):
        wq, wp, nreq, qscale = self._bool_weights(chunk, QC)
        dev = self.device
        with faults.device_dispatch("turbo_sweep", self.part_id):
            return kernels.sweep_rowmax_conj(
                torch.from_numpy(qscale).to(dev),
                torch.from_numpy(nreq).to(dev), self.cols_hi, self.cols_lo,
                torch.from_numpy(wq).to(dev), torch.from_numpy(wp).to(dev),
                self.live, nsw=self.nsw)

    # ---- packed bitsets (ES_TPU_BITSET) ----

    def _repack_bits(self) -> None:
        """Derive the per-slot presence bitsets from the column cache
        (presence is exact there: the build forces lo >= 1)."""
        with faults.device_errors("bitset_intersect", self.part_id):
            self.bits = None          # the old bitsets' memory first
            self.bits = kernels.pack_presence_bits(self.cols_hi,
                                                   self.cols_lo)
        self._bits_epoch = self.cols_epoch
        self.stats["bitset_packs"] += 1
        _node_bitset_add("bitset_packs", 1)
        _node_bitset_add("bitset_bytes",
                         self.bits.nbytes - self.stats["bitset_bytes"])
        self.stats["bitset_bytes"] = self.bits.nbytes
        self._register_hbm_regions()

    def _ensure_bits(self) -> None:
        """Pack (or re-pack after a cols_epoch move) the bitsets before a
        bitset dispatch."""
        if self.bits is not None and self._bits_epoch == self.cols_epoch:
            return
        faults.fault_point("bitset_intersect", self.part_id)
        self._repack_bits()

    def _bitset_slots(self, r: _BoolQuery):
        """(required slots rarest-first, must_not slots largest-first) for
        the intersect kernel. Clauses beyond the BITSET_CLAUSES /
        BITSET_NEGS fan-in are dropped from the mask only, which leaves it
        a superset of the match set; the exact rescore re-tests every
        clause, so top-k is unchanged."""
        req: Dict[int, int] = {}
        for t, _, info in r.conj:
            slot = self._slot_of.get(t)
            if slot is not None:
                req[slot] = min(req.get(slot, 1 << 60), info.df)
        for t, info in r.filters:
            slot = self._slot_of.get(t)
            if slot is not None:
                req[slot] = min(req.get(slot, 1 << 60), info.df)
        for terms, _, _, pinfo, _ in r.phrases:
            if pinfo is None:
                continue
            slot = self._slot_of.get(pinfo.key)
            if slot is not None:
                req[slot] = min(req.get(slot, 1 << 60), len(pinfo.docs))
        ordered = sorted(req, key=lambda s: (req[s], s))[:BITSET_CLAUSES]
        mn = []
        for t, info in r.must_not:
            slot = self._slot_of.get(t)
            if slot is not None and slot not in req:
                mn.append((info.df, slot))
        mn = [s for _, s in sorted(mn, reverse=True)[:BITSET_NEGS]]
        return ordered, mn

    def _bitset_prefetch(self, chunk, QC: int):
        """(q_slots [QC, BITSET_CLAUSES], q_neg [QC, BITSET_NEGS]) i32 for
        the intersect kernel. Slot Hp (the scratch slot, always zero) is
        the AND-NOT identity and the empty mask; slot Hp + 1 is all ones.
        A padding row points every clause at the zero sentinel, so its
        mask is empty; an active query with no resident required clause
        pads with the ones sentinel; extra clauses repeat the first."""
        zero_s, ones_s = self.Hp, self.Hp + 1
        q_slots = np.full((QC, BITSET_CLAUSES), zero_s, np.int32)
        q_neg = np.full((QC, BITSET_NEGS), zero_s, np.int32)
        for qi, r in enumerate(chunk):
            if r is None:
                continue
            req, mn = self._bitset_slots(r)
            if not req:
                q_slots[qi, :] = ones_s
            else:
                for j in range(BITSET_CLAUSES):
                    q_slots[qi, j] = req[j] if j < len(req) else req[0]
            q_neg[qi, : len(mn)] = mn
        return q_slots, q_neg

    def _sweep_bool_bits(self, chunk: Sequence[_BoolQuery], QC: int):
        """The bitset twin of _sweep_bool: K5 intersects the clauses'
        packed match sets and counts each query's nonzero chunks in the
        same pass, K6 sweeps only the surviving docs. Returns (rm, rr,
        counts), counts being the per-query nonzero-chunk tally. The clause
        slots go to K5 from the host, where it checks them without reading
        back from the card."""
        wq, _, _, qscale = self._bool_weights(chunk, QC)
        q_slots, q_neg = self._bitset_prefetch(chunk, QC)
        dev = self.device
        with faults.device_dispatch("bitset_intersect", self.part_id):
            mask, counts = kernels.intersect_bitset_counts(
                torch.from_numpy(q_slots), torch.from_numpy(q_neg),
                self.bits, nsw=self.nsw)
        with faults.device_dispatch("turbo_sweep", self.part_id):
            rm, rr = kernels.sweep_rowmax_bitset(
                torch.from_numpy(qscale).to(dev), self.cols_hi,
                self.cols_lo, torch.from_numpy(wq).to(dev), mask, self.live,
                nsw=self.nsw)
        return rm, rr, counts

    def _gallop_routes(self, resolved, device_idx, host_idx):
        """Queries whose rarest required clause has df below
        ES_TPU_BITSET_HOST_DF skip the device sweep: the galloping host
        intersection finishes them sooner."""
        thr = int(knob("ES_TPU_BITSET_HOST_DF") or 0)
        if thr <= 0:
            return device_idx, host_idx
        keep: List[int] = []
        moved: List[int] = []
        for qi in device_idx:
            r = resolved[qi]
            dfs = ([i.df for _, _, i in r.conj]
                   + [i.df for _, i in r.filters]
                   + [len(p.docs) for _, _, _, p, _ in r.phrases
                      if p is not None])
            (moved if dfs and min(dfs) < thr else keep).append(qi)
        if moved:
            self.stats["bitset_gallop"] += len(moved)
            _node_bitset_add("bitset_gallop", len(moved))
        return keep, sorted(host_idx + moved)

    def _note_bitset_counts(self, cnt) -> None:
        """Fold one dispatch's nonzero-chunk tallies into the skip
        counter and the two histograms."""
        total = self.nsw * N_CHUNKS
        for c in cnt:
            skipped = max(total - int(c), 0)
            self.stats["bitset_blocks_skipped"] += skipped
            _node_bitset_add("bitset_blocks_skipped", skipped)
            metrics.observe("bitset_blocks_skipped", skipped)
            metrics.observe("bitset_block_occupancy",
                            int(c) / max(total, 1))

    # ---- exact host side ----

    def _phrase_pf(self, terms, slop, pinfo, docs: np.ndarray):
        """(pf f32[n], present bool[n]) of a phrase at candidate docs."""
        if pinfo is not None:
            pdocs, ppf = pinfo.docs, pinfo.pf
        else:
            flt = np.unique(np.asarray(docs, np.int64)).astype(np.int32)
            pdocs, ppf = phrase_freqs(self.fp, list(terms), slop=slop,
                                      docs_filter=flt)
        pf = np.zeros(len(docs), np.float32)
        if len(pdocs):
            d = docs.astype(pdocs.dtype, copy=False) \
                if docs.dtype != pdocs.dtype else docs
            j = np.searchsorted(pdocs, d)
            jc = np.minimum(j, len(pdocs) - 1)
            hit = (j < len(pdocs)) & (pdocs[jc] == d)
            pf[hit] = ppf[jc[hit]]
        return pf, pf > 0

    def _exact_bool(self, r: _BoolQuery, docs: np.ndarray):
        """(scores f32[n], match bool[n]) at docs, expression for
        expression the reference's (f64 accumulation, clause order conj ->
        should -> phrases, one f32 downcast at the end)."""
        fp = self.fp
        n = len(docs)
        match = np.ones(n, bool)
        dl = fp.doc_len[docs]
        norm = _K1 * (1.0 - _B + _B * dl / max(self._avgdl, 1e-9))
        scores = np.zeros(n, np.float64)
        for t, w, info in r.conj:
            tf, present = tf_at(fp, t, docs)
            match &= present
            scores += w * info.idf * tf * (_K1 + 1.0) / (tf + norm)
        for t, _ in r.filters:
            _, present = tf_at(fp, t, docs)
            match &= present
        for t, w, info in r.should:
            tf, present = tf_at(fp, t, docs)
            contrib = (w * info.idf * tf * (_K1 + 1.0)
                       / np.maximum(tf + norm, 1e-9))
            scores += np.where(present, contrib, 0.0)
        for terms, slop, boost, pinfo, idf_sum in r.phrases:
            pf, present = self._phrase_pf(terms, slop, pinfo, docs)
            match &= present
            if boost == 0.0:
                continue
            scores += boost * idf_sum * pf * (_K1 + 1.0) / (pf + norm)
        for t, _ in r.must_not:
            _, present = tf_at(fp, t, docs)
            match &= ~present
        return scores.astype(np.float32), match

    def _bool_host_exact(self, r: _BoolQuery, k: int):
        """Exact host bool top-k: sorted-array intersection of the required
        clauses, then the shared exact rescore. Serves host-routed queries
        and the device path's certificate fallback."""
        self._bump("bool_host")
        fp = self.fp
        empty = (np.empty(0, np.float32), np.empty(0, np.int32))
        req: List[np.ndarray] = []
        for _, _, info in r.conj:
            lo, hi = (int(fp.post_start[info.ord]),
                      int(fp.post_start[info.ord + 1]))
            req.append(fp.post_doc[lo:hi])
        for _, info in r.filters:
            lo, hi = (int(fp.post_start[info.ord]),
                      int(fp.post_start[info.ord + 1]))
            req.append(fp.post_doc[lo:hi])
        for _, _, _, pinfo, _ in r.phrases:
            if pinfo is not None:
                req.append(pinfo.docs)
        cand: Optional[np.ndarray] = None
        if req:
            req.sort(key=len)
            cand = req[0]
            for s in req[1:]:
                cand = _intersect_sorted(cand, s)
                if not len(cand):
                    return empty
        for terms, slop, _, pinfo, _ in r.phrases:
            if pinfo is not None:
                continue
            cand, _ = phrase_freqs(fp, list(terms), slop=slop,
                                   docs_filter=cand)
            if not len(cand):
                return empty
        if cand is None:
            # no required clauses: candidates are the should-term union
            arrs = []
            for _, _, info in r.should:
                lo, hi = (int(fp.post_start[info.ord]),
                          int(fp.post_start[info.ord + 1]))
                arrs.append(fp.post_doc[lo:hi])
            if not arrs:
                return empty
            cand = np.unique(np.concatenate(arrs))
        cand = cand[self._live_host[cand] > 0]
        if not len(cand):
            return empty
        s, m = self._exact_bool(r, cand)
        keep = m & (s > 0)
        cand, s = cand[keep], s[keep]
        sel = np.lexsort((cand, -s))[:k]
        return s[sel], cand[sel].astype(np.int32)

    def _cold_should(self, r: _BoolQuery):
        """The cold SHOULD terms of a bool query, [(term, boost, info)]."""
        return [(t, b, i) for t, b, i in r.should if t not in self._slot_of]

    def _finish_bool(self, r: _BoolQuery, cand_docs, bound: float, k: int,
                     cold, slots):
        """Device-path merge: exact rescore of the collected docs, the cold
        SHOULD terms' side from K3 (`cold`, _cold_sides' triple, None
        without cold SHOULD terms; bound-pruned), and the certificate, as
        in _finish_query. `slots` is _bool_slots(r) as the sweep
        quantized it."""
        scoring = slots[0]
        e_q = _quant_error([w for _, w, _ in scoring])

        cand_s = np.empty(0, np.float32)
        if len(cand_docs):
            cand_docs = np.asarray(cand_docs, np.int64)
            s, m = self._exact_bool(r, cand_docs)
            keep = m & (s > 0)
            cand_docs, cand_s = cand_docs[keep], s[keep]
        else:
            cand_docs = np.empty(0, np.int64)

        # cold SHOULD terms: a match the sweep scored without them (or
        # never surfaced, when every scoring clause is cold) gets its exact
        # total here; bound-pruned like the disjunctive path
        cold_docs = np.empty(0, np.int64)
        cold_s = np.empty(0, np.float32)
        if cold is not None:
            docs_c, contrib, slack = cold
            lv = self._live_host[docs_c] > 0
            docs_c, contrib = docs_c[lv], contrib[lv]
            kth_0 = 0.0
            if len(cand_s) >= k:
                kth_0 = float(np.partition(cand_s, len(cand_s) - k)[
                    len(cand_s) - k])
            col_const = sum(abs(w) * sm for _, w, sm in scoring)
            # slack widens the bound for the slices' quantization: a
            # superset of the exact path's survivors, all rescored below
            survivors = docs_c[contrib + slack + col_const + 1e-5 >= kth_0]
            if len(survivors):
                s, m = self._exact_bool(r, survivors)
                keep = m & (s > 0)
                cold_docs, cold_s = survivors[keep], s[keep]

        docs = np.concatenate([cand_docs, cold_docs])
        totals = np.concatenate([cand_s, cold_s])
        if len(docs):
            docs, first = np.unique(docs, return_index=True)
            totals = totals[first]
        sel = np.lexsort((docs, -totals))[:k]
        out_s, out_d = totals[sel], docs[sel].astype(np.int32)

        # certificate: collected docs are exact; a doc in an uncollected
        # row passed the same exact clause gate, so its colized score is
        # bounded by the row bound + e_q, and its cold-should addend was
        # enumerated above
        uncollected = float(bound)
        limit = uncollected + e_q
        kth = float(out_s[k - 1]) if len(out_s) >= k else 0.0
        short = len(out_s) < k and uncollected > 0
        if short or (len(out_s) >= k and kth < limit and uncollected > 0):
            self._bump("fallbacks")
            return self._bool_host_exact(r, k)
        return out_s, out_d

    def search_bool(self, queries: Sequence[dict], k: int = 10,
                    check=None):
        """(scores [Q, k] f32, ords [Q, k] i32) for bool query specs (see
        _resolve_bool). Matches with non-positive scores are dropped. The
        device and host routes are bitwise equal: both rescore through
        _exact_bool."""
        Q = len(queries)
        out_s = np.zeros((Q, k), np.float32)
        out_d = np.zeros((Q, k), np.int32)
        resolved, swept, host_idx = self._dispatch_bool(queries, k, check)
        # exact host rescore and certificate, outside the engine's lock
        for sel, rows_all, bounds, colds, slots in swept:
            for j, qi in enumerate(sel):
                docs = self._collect_docs(rows_all[j])
                s, d = self._finish_bool(resolved[qi], docs,
                                         float(bounds[j]), k, colds[j],
                                         slots[j])
                out_s[qi, : len(s)] = s
                out_d[qi, : len(d)] = d
        for qi in host_idx:
            if check is not None:
                check()
            s, d = self._bool_host_exact(resolved[qi], k)
            out_s[qi, : len(s)] = s
            out_d[qi, : len(d)] = d
        return out_s, out_d

    @_serialized
    def _dispatch_bool(self, queries, k: int, check):
        """The device passes of search_bool under the engine's lock:
        (resolved queries, per chunk (query indices, picked rows [QC,
        n_rows] i64, row bounds [QC], cold sides, each query's _bool_slots
        as swept), the host-routed query indices)."""
        resolved = [self._resolve_bool(spec) for spec in queries]
        self._ensure_bool(resolved)
        device_idx, host_idx = self._bool_routes(resolved)
        use_bits = bool(knob("ES_TPU_BITSET"))
        if use_bits:
            device_idx, host_idx = self._gallop_routes(
                resolved, device_idx, host_idx)
            if device_idx:
                self._ensure_bits()
        self.stats["bool_device"] += len(device_idx)

        # device pipeline, the two passes of search_many: every chunk is
        # launched before the host reads any back
        n_rows = max(_GLOBAL_ROWS, k + 5)
        pending = []
        off = 0
        while off < len(device_idx):
            rem = len(device_idx) - off
            take = next((s for s in self.qc_sizes if s >= rem),
                        self.qc_sizes[-1])
            sel = device_idx[off: off + take]
            chunk = [resolved[i] for i in sel]
            if check is not None:
                check()
            counts = None
            if use_bits:
                first = hbm_ledger.note_dispatch("turbo_bitset", take)
                tc0 = time.monotonic()
                rm, rr, counts = self._sweep_bool_bits(chunk, take)
            else:
                rm, rr = self._sweep_bool(chunk, take)
            with faults.device_errors("turbo_sweep", self.part_id):
                picked = _pick_rows(rm, rr, n_rows=n_rows)
            if use_bits and first:
                hbm_ledger.note_compile_done("turbo_bitset", take,
                                             time.monotonic() - tc0)
            pending.append((sel, picked, counts))
            off += len(sel)
        self.stats["dispatches"] += len(pending)

        swept = []
        for sel, packed_dev, counts in pending:
            if check is not None:
                check()
            with faults.device_errors("turbo_sweep", self.part_id):
                packed = packed_dev.cpu().numpy()
            if counts is not None:
                with faults.device_errors("bitset_intersect", self.part_id):
                    self._note_bitset_counts(counts.cpu().numpy()[: len(sel)])
            colds = self._cold_sides(
                [self._cold_should(resolved[qi]) for qi in sel])
            swept.append((sel, packed[:, :n_rows].astype(np.int64),
                          packed[:, n_rows], colds,
                          [self._bool_slots(resolved[qi]) for qi in sel]))
        return resolved, swept, host_idx

    def search_phrase(self, phrases: Sequence[Sequence[str]], k: int = 10,
                      slop: int = 0, check=None):
        """(scores [Q, k], ords [Q, k]) for bare phrase queries: sugar over
        search_bool; slop-0 phrases ride the adjacency columns."""
        specs = [{"phrases": [(list(p), slop, 1.0)]} for p in phrases]
        return self.search_bool(specs, k=k, check=check)

    # ---------------- host tier (no device dispatch) ----------------

    def _exact_query(self, terms, k: int):
        """Exact host top-k for one flat [(term, boost)] query."""
        qterms = []
        for t, b in terms:
            info = self._term(t)
            if info is not None:
                qterms.append((t, b, info))
        if not qterms:
            return np.empty(0, np.float32), np.empty(0, np.int32)
        return self._exact_merge(qterms, k)

    def search_many_host(self, batches: Sequence[List], k: int = 10,
                         check=None):
        """search_many semantics served entirely on the host — the
        circuit-open fallback tier (no device dispatch, no cache
        mutation)."""
        flat, spans = _flatten_queries(batches)
        out_s = np.zeros((len(flat), k), np.float32)
        out_d = np.zeros((len(flat), k), np.int32)
        for qi, terms in enumerate(flat):
            if check is not None:
                check()
            s, d = self._exact_query(terms, k)
            out_s[qi, : len(s)] = s
            out_d[qi, : len(d)] = d
        return [(out_s[o: o + n], out_d[o: o + n]) for o, n in spans]

    def search_bool_host(self, queries: Sequence[dict], k: int = 10,
                         check=None):
        """search_bool semantics served entirely on the host (the
        _bool_host_exact route every device bool result is bitwise equal
        to)."""
        Q = len(queries)
        out_s = np.zeros((Q, k), np.float32)
        out_d = np.zeros((Q, k), np.int32)
        for qi, spec in enumerate(queries):
            if check is not None:
                check()
            r = self._resolve_bool(spec)
            if r is None:
                continue
            s, d = self._bool_host_exact(r, k)
            out_s[qi, : len(s)] = s
            out_d[qi, : len(d)] = d
        return out_s, out_d
