"""The serving path's device kernels: hand-written CUDA for Hopper, each with
its plain torch version beside it.

Port of the Pallas kernels of elasticsearch_tpu/parallel/kernels.py that the
ported paths run:

* K1 `build_columns` (reference :730) -> csrc/build_columns.cu
* K2 `sweep_rowmax`  (reference :148) -> csrc/sweep_rowmax.cu
* K3 `sparse_gather` (reference :876, two pallas_calls) -> csrc/sparse_gather.cu
* K5 `intersect_bitset` (reference :398) -> csrc/intersect_bitset.cu, which
  also computes the reference's XLA program `mask_chunk_counts` (:445) in
  the same pass (`intersect_bitset_counts`)
* K6 `sweep_rowmax_bitset` (reference :534) -> csrc/sweep_rowmax.cu
* K7 `sweep_rowmax_conj` (reference :270) -> csrc/sweep_rowmax.cu
* F1-F3, the fused S > 1 sweeps of elasticsearch_tpu/parallel/turbo.py
  (`_fused_sweep_disj` :2099, `_fused_sweep_bool` :2128,
  `_fused_sweep_bitset` :2148, which ran K2, K7 and K5 + K6 once per
  partition under one shard_map) -> the same two sources, the partition
  a third grid axis (`fused_sweep_rowmax`, `fused_sweep_rowmax_conj`,
  `fused_sweep_rowmax_bitset`), each with the row pick (`pick_rows`)
* K4 `merge_topk` (reference :633) -> csrc/merge_topk.cu
* K9 `knn_int8_window_topc` (reference :1153) -> csrc/knn_window_topc.cu
* K8 `_agg_counts` (reference :996, behind `agg_segment_counts` :1037 and
  `agg_two_level_counts` :1057) -> csrc/agg_counts.cu

and, beside them, the dense executor's block scatter, the XLA programs
`bm25_scatter_scores` and `constant_scatter_mask` of
elasticsearch_tpu/ops/scoring.py (:56, :83) -> csrc/block_scatter.cu
(`bm25_block_scatter`, `block_presence`), and two kernels of BlockMax and
spmd, whose XLA programs no single torch call replaces:

* K10 `lane_topk`, the lane half of elasticsearch_tpu/parallel/blockmax.py
  `_lane_candidates` (:911), `_one_query_topk` (:931),
  `_one_query_topk_bool` (:1014) and of spmd.py `_local_bm25_topk` (:335)
  -> csrc/lane_topk.cu
* K11 `weighted_block_scatter`, blockmax.py `_scatter_chunk` (:963) and
  spmd.py `_column_insert_program` (:650) -> csrc/block_scatter.cu

Each wrapper checks device, dtype, shape and contiguity (raising TypeError
or ValueError), then: for tensors on the CPU it runs the plain version
(`*_plain`, the role Pallas interpret mode plays for the reference); for
tensors on a CUDA device it launches the kernel on the current stream,
checks the launch, and adds one to `LAUNCHES[name]`. It never falls back
from the kernel to the plain version. The plain versions are torch on any
device, so `chip_smoke.py` holds each kernel against its plain version on
the card. Both are bitwise equal to the reference (tests/test_torch_kernels.py);
K9's float epilogue follows the order in which XLA on the CPU compiles the
reference kernel, fused multiply-adds included (ROADMAP W11).

`build_columns` updates the column cache in place, where the reference
donated it; the others allocate their outputs with torch.

The reference's packed bitsets are uint32; here they are int32 tensors
holding the same bit patterns (torch's uint32 lacks shifts and bitwise ops
on some devices). `pack_presence_bits` is an XLA program in the reference
(:358), not a Pallas kernel; no one torch call packs 32 presence rows into a
word, so it is a kernel here too (csrc/pack_bits.cu), with its torch code as
the plain version.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import KernelLaunchError
from elasticsearch_tpu_torch.ops.knn import sqrt_rn

SW = 65536            # docs per superwindow (candidate granularity)
TILE = 16384          # docs per build tile
SW_ROWS = SW // 128   # 512
CHUNK_ROWS = 16       # 2048 docs per chunk-major of the column cache
N_CHUNKS = SW_ROWS // CHUNK_ROWS   # 32 chunks per superwindow
CHUNK = CHUNK_ROWS * 128           # 2048
NCAND = 17            # candidates kept per (query, superwindow)
# The sweeps' block (K2, K6, K7) takes SWEEP_GROUP consecutive queries of
# one superwindow and holds their nonzero (slot, wh, wl[, wp]) lists,
# sweep_list_cap(hpt) entries, in batches of queries when they do not fit
# (sweep_rowmax.cu's G and list_cap, which the card tests hold these to; G
# measured by tools/k2_ab.py)
SWEEP_GROUP = 16
SWEEP_LIST_MIN = 256
CAND_PAD = 32         # padded candidate lane width
K1 = 1.2
COLSCALE = (K1 + 1.0) / 127.0       # hi-layer int8 step
COLSCALE2 = COLSCALE / 128.0        # lo-layer step (~14-bit combined)
MAX_GROUP_ROWS = 144  # trailing padding rows of the lane arrays
ROWS_PER_STEP = 8     # dispatch widths are multiples of this
SPARSE_GRAN = 1024    # packed (doc, impact) lanes per slice-pool granule
SPARSE_IMP_MAX = 255  # uint8 impact quantization ceiling (doc << 8 | imp)
SW_WORD_ROWS = SW_ROWS // 32   # 16 packed word rows per superwindow
BITSET_CLAUSES = 8    # AND fan-in of the intersect kernel (rarest clauses)
BITSET_NEGS = 4       # AND-NOT fan-in (largest-df prohibitions)
# queries whose clause slots one K5 launch carries in its parameters
# (intersect_bitset.cu's TABLE_Q; the card test holds this mirror to the
# built es_intersect_table_q)
INTERSECT_TABLE_Q = 256
# partitions one fused sweep launch takes (sweep_rowmax.cu's and
# intersect_bitset.cu's MAX_PARTS; the card test holds this mirror to the
# built es_fused_max_parts): more take a launch per MAX_FUSED_PARTS
MAX_FUSED_PARTS = 64

# the reference multiplies f32 tiles by these Python constants, which JAX
# rounds to f32; the same f32 values here, and passed to the CUDA kernel
_INV_CS = float(np.float32(1.0 / COLSCALE))
_CS = float(np.float32(COLSCALE))
_INV_CS2 = float(np.float32(1.0 / COLSCALE2))

KNN_W = 2048          # docs per kNN window (candidate granularity)
KNN_CANDW = 32        # candidates kept per (query, window)
KNN_SIMILARITIES = ("cosine", "dot_product", "l2_norm")
# K9's epilogue constants: Python floats rounded to f32 as JAX and torch
# round them (float(np.float32(x)) is exactly the f32 value). XLA folds the
# dot_product transform's (x + 1e-6) + 1 into x + (1 + 1e-6) in f32.
_KNN_C0079 = float(np.float32(0.0079))
_KNN_C105 = float(np.float32(1.05))
_KNN_C1EM6 = float(np.float32(1e-6))
_KNN_C1P1EM6 = float(np.float32(1.0) + np.float32(1e-6))

AGG_PAIR_GRAN = 1024  # (doc, bucket) pairs per K8 chunk
AGG_SEG_TILE = 16384  # bucket ids per K8 tile (a chunk's [ct0, ct1] unit)

# launches of each CUDA kernel since the last reset (plain runs not counted)
LAUNCHES: Dict[str, int] = {"build_columns": 0, "sweep_rowmax": 0,
                            "sparse_gather": 0, "intersect_bitset": 0,
                            "sweep_rowmax_bitset": 0, "sweep_rowmax_conj": 0,
                            "fused_sweep_rowmax": 0,
                            "fused_sweep_rowmax_conj": 0,
                            "fused_intersect_bitset": 0,
                            "fused_sweep_rowmax_bitset": 0,
                            "merge_topk": 0, "knn_int8_window_topc": 0,
                            "agg_counts": 0, "pack_presence_bits": 0,
                            "bm25_block_scatter": 0, "block_presence": 0,
                            "lane_topk": 0, "weighted_block_scatter": 0}


_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _check(t, name: str, dtype: torch.dtype, ndim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_POISON = False   # set by poisoned(): _out fills what it allocates


@contextlib.contextmanager
def poisoned():
    """Within it, every output and scratch tensor a kernel wrapper
    allocates (`_out`) is filled first with NaN (floats) or all one bits
    (integers), so a kernel that leaves an entry unwritten cannot pass a
    check on memory an earlier, right call left behind. For checks only:
    it is process-wide and adds a fill to every launch while on."""
    global _POISON
    prev, _POISON = _POISON, True
    try:
        yield
    finally:
        _POISON = prev


def _out(shape, dtype: torch.dtype, dev) -> torch.Tensor:
    """An output or scratch tensor of a kernel launch (see `poisoned`)."""
    t = torch.empty(shape, dtype=dtype, device=dev)
    if _POISON:
        t.fill_(float("nan") if dtype.is_floating_point else -1)
    return t


def _route(device: torch.device) -> bool:
    """True for the CUDA kernel, False for the plain version (CPU)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise TypeError(f"no kernel for device {device}")


def _raw_stream(index: int) -> int:
    """The current stream of device `index` as a cudaStream_t value."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:       # skips building a torch.cuda.Stream object
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _launch(name: str, device: torch.device, *args) -> None:
    from elasticsearch_tpu_torch.parallel.cuda_build import kernel

    fn = kernel(name)
    cur = torch.cuda.current_device()
    if device.index is None or device.index == cur:
        rc = fn(*args, _raw_stream(cur))
    else:                 # the C entry launches on the current device
        with torch.cuda.device(device):
            rc = fn(*args, _raw_stream(device.index))
    if rc != 0:
        raise KernelLaunchError(f"{name} launch failed: cudaError {rc}")
    with _LAUNCH_LOCK:        # the scheduler launches from several threads
        LAUNCHES[name] += 1


# --------------------------------------------------------------------------
# K1 column builder
# --------------------------------------------------------------------------


def _quantize(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 (hi, lo) layers of f32 impacts, as the reference's build kernel:
    hi = clip(round(t / COLSCALE)), lo = clip(round(fma(-hi, COLSCALE, t) /
    COLSCALE2)) with both divisions as multiplies by f32 constants, and
    lo = 1 on present cells whose (hi, lo) would be (0, 0).

    XLA on the CPU contracts `t - hi * COLSCALE` into a fused multiply-add
    (measured: 24 of 98,304 cells differ without it). The fma is computed
    exactly here: hi * COLSCALE is exact in float64, and t lies within a
    factor of two of it whenever hi != 0, so the float64 difference is exact
    and one rounding to f32 gives the correctly rounded fma."""
    hi = torch.clamp(torch.round(t * _INV_CS), -127.0, 127.0)
    r = (t.double() - hi.double() * _CS).float()
    lo = torch.clamp(torch.round(r * _INV_CS2), -127.0, 127.0)
    lo = torch.where((t > 0) & (hi == 0) & (lo == 0),
                     torch.ones_like(lo), lo)
    return hi.to(torch.int8), lo.to(torch.int8)


def build_columns_plain(g_rows, g_nrows, g_base, g_slot, lane_docs,
                        lane_scores, cols_hi, cols_lo) -> None:
    """Plain torch K1, in place. Groups are taken in launch order, a chunk
    of groups at a time; within a chunk each (slot, tile) is written once,
    which is the kernel's precondition too."""
    dev = cols_hi.device
    ng = int(g_rows.shape[0])
    if ng == 0:
        return
    dpc, hpt = cols_hi.shape[0], cols_hi.shape[1]
    ch = cols_hi.view(dpc, hpt, CHUNK)
    cl = cols_lo.view(dpc, hpt, CHUNK)
    flat_docs = lane_docs.reshape(-1)
    flat_sc = lane_scores.reshape(-1)
    u8 = torch.arange(TILE // CHUNK, device=dev)
    group_chunk = 1024            # bounds the [groups, lanes] temporaries
    for s in range(0, ng, group_chunk):
        e = min(ng, s + group_chunk)
        r0 = g_rows[s:e].long()
        n = g_nrows[s:e].long()
        base = g_base[s:e].long()
        slot = g_slot[s:e].long()
        g = e - s
        width = int(n.max()) * 128
        tile = torch.zeros(g * TILE, dtype=torch.float32, device=dev)
        if width:
            j = torch.arange(width, device=dev)
            valid = j[None, :] < n[:, None] * 128
            lid = torch.where(valid, r0[:, None] * 128 + j[None, :], 0)
            d = flat_docs[lid].long()
            v = flat_sc[lid]
            rel = d - base[:, None]
            # one lane per (term, doc) and score-0 padding lanes: storing the
            # nonzero lanes equals the reference's one-hot matmul sum
            ok = valid & (rel >= 0) & (rel < TILE) & (v != 0)
            cell = torch.arange(g, device=dev)[:, None] * TILE + rel
            tile[cell[ok]] = v[ok]
        hi, lo = _quantize(tile)
        dst_chunk = (base // CHUNK)[:, None] + u8[None, :]          # [g, 8]
        dst_slot = slot[:, None].expand(g, TILE // CHUNK)
        ch[dst_chunk.reshape(-1), dst_slot.reshape(-1)] = hi.view(-1, CHUNK)
        cl[dst_chunk.reshape(-1), dst_slot.reshape(-1)] = lo.view(-1, CHUNK)


def build_columns(g_rows, g_nrows, g_base, g_slot, lane_docs, lane_scores,
                  cols_hi, cols_lo) -> None:
    """Fill int8 hi/lo column tiles from posting lanes, in place.

    One group = one (column slot, 16384-doc tile): it writes the whole tile
    from its lanes rows [g_rows, g_rows + g_nrows) masked to the tile
    (nrows = 0 writes zeros: eviction and scratch groups).

    g_rows/g_nrows/g_base/g_slot [NG] i32 — g_base a multiple of TILE
    lane_docs [T, 128] i32, lane_scores [T, 128] f32
    cols_hi/cols_lo [dp_chunks, Hpt, 16, 128] i8, updated in place
    Groups of one call must write distinct (slot, tile) pairs, except
    zero groups (their blocks run in no order on the card).
    """
    dev = cols_hi.device
    _check(cols_hi, "cols_hi", torch.int8, 4, dev)
    _check(cols_lo, "cols_lo", torch.int8, 4, dev)
    if cols_lo.shape != cols_hi.shape or tuple(cols_hi.shape[2:]) != (16, 128):
        raise ValueError(f"cols shapes {tuple(cols_hi.shape)} / "
                         f"{tuple(cols_lo.shape)} are not [dpc, Hpt, 16, 128]")
    if cols_hi.shape[0] % (TILE // CHUNK):
        raise ValueError("cols dp_chunks must cover whole 16384-doc tiles")
    for nm, t in (("g_rows", g_rows), ("g_nrows", g_nrows),
                  ("g_base", g_base), ("g_slot", g_slot)):
        _check(t, nm, torch.int32, 1, dev)
        if t.shape != g_rows.shape:
            raise ValueError(f"{nm} has {t.shape[0]} groups, "
                             f"g_rows {g_rows.shape[0]}")
    _check(lane_docs, "lane_docs", torch.int32, 2, dev)
    _check(lane_scores, "lane_scores", torch.float32, 2, dev)
    if lane_docs.shape != lane_scores.shape or lane_docs.shape[1] != 128:
        raise ValueError("lane arrays must both be [T, 128]")
    if not _route(dev):
        build_columns_plain(g_rows, g_nrows, g_base, g_slot, lane_docs,
                            lane_scores, cols_hi, cols_lo)
        return
    _launch("build_columns", dev,
            g_rows.data_ptr(), g_nrows.data_ptr(), g_base.data_ptr(),
            g_slot.data_ptr(), int(g_rows.shape[0]), lane_docs.data_ptr(),
            lane_scores.data_ptr(), int(lane_docs.shape[0]),
            cols_hi.data_ptr(), cols_lo.data_ptr(), int(cols_hi.shape[0]),
            int(cols_hi.shape[1]), _INV_CS, _CS, _INV_CS2)


# --------------------------------------------------------------------------
# K2 query sweep
# --------------------------------------------------------------------------


def _sweep_plain(qscale, cols_hi, cols_lo, wq, live, nsw: int, *,
                 wp=None, nreq=None, mask=None):
    """The plain sweep behind K2, K6 (`mask`) and K7 (`wp`, `nreq`). The
    int8 products are taken in float64 over the slots any query weights
    (exact: every partial sum is an integer below 2^53), so they equal the
    reference's int32 products; the combine, masks, row max and (rowmax
    desc, row asc) top-NCAND follow it step by step. A stable descending
    sort gives the ascending-row tie order."""
    dev = cols_hi.device
    qc = wq.shape[1]
    rm = torch.full((nsw, qc, CAND_PAD), float("-inf"), dtype=torch.float32,
                    device=dev)
    rr = torch.zeros((nsw, qc, CAND_PAD), dtype=torch.int32, device=dev)
    used = (wq != 0).any(dim=0).any(dim=0)
    if wp is not None:
        used = used | (wp != 0).any(dim=0)
    slots = torch.nonzero(used).flatten()
    if slots.numel() == 0:
        return rm, rr
    wh = wq[0][:, slots].double()
    wl = wq[1][:, slots].double()
    bit = torch.arange(32, dtype=torch.int32, device=dev)
    sw_chunk = 4                  # bounds the [QC, docs] temporaries
    for s0 in range(0, nsw, sw_chunk):
        s1 = min(nsw, s0 + sw_chunk)
        ns = s1 - s0
        c = slice(s0 * N_CHUNKS, s1 * N_CHUNKS)
        h = cols_hi[c][:, slots].permute(1, 0, 2, 3).reshape(len(slots), -1)
        lo = cols_lo[c][:, slots].permute(1, 0, 2, 3).reshape(len(slots), -1)
        if wp is not None:
            present = ((h != 0) | (lo != 0)).double()
        h, lo = h.double(), lo.double()
        m_hh = (wh @ h).to(torch.int32)
        m_hl = (wh @ lo).to(torch.int32)
        m_lh = (wl @ h).to(torch.int32)
        m_ll = (wl @ lo).to(torch.int32)
        val = (16384.0 * m_hh.float() + 128.0 * (m_hl + m_lh).float()
               + m_ll.float())
        val = val * qscale
        lv = live[s0 * SW_ROWS: s1 * SW_ROWS].reshape(1, -1)
        ok = (lv > 0) & (val > 0)
        if wp is not None:
            # coverage == n_req iff every required slot is present and no
            # must_not slot is (its weight -(n_req + 1) is unreachable)
            cov = (wp[:, slots].double() @ present).to(torch.int32)
            ok = ok & (cov == nreq)
        if mask is not None:
            # bit j of word [q, g, l] is posting row 32g + j, lane l
            words = mask[:, s0 * SW_WORD_ROWS: s1 * SW_WORD_ROWS]
            alive = ((words[:, :, None, :] >> bit[None, None, :, None])
                     & 1) != 0
            ok = ok & alive.reshape(qc, -1)
        val = torch.where(ok, val, torch.full_like(val, float("-inf")))
        rowmax = val.view(qc, ns, SW_ROWS, 128).amax(dim=3)
        top_m, idx = torch.sort(rowmax, dim=2, descending=True, stable=True)
        top_m = top_m[:, :, :NCAND]
        rows = idx[:, :, :NCAND].to(torch.int32) + (
            torch.arange(s0, s1, device=dev, dtype=torch.int32)
            * SW_ROWS)[None, :, None]
        keep = top_m > float("-inf")
        rm[s0:s1, :, :NCAND] = top_m.permute(1, 0, 2)
        rr[s0:s1, :, :NCAND] = torch.where(
            keep, rows, torch.zeros_like(rows)).permute(1, 0, 2)
    return rm, rr


def sweep_rowmax_plain(qscale, cols_hi, cols_lo, wq, live, *, nsw: int):
    """Plain torch K2."""
    return _sweep_plain(qscale, cols_hi, cols_lo, wq, live, nsw)


def _check_cols(cols_hi, cols_lo, live, nsw: int, dev) -> int:
    """Checks of one partition's columns and live mask against its nsw;
    returns Hpt."""
    _check(cols_hi, "cols_hi", torch.int8, 4, dev)
    _check(cols_lo, "cols_lo", torch.int8, 4, dev)
    _check(live, "live", torch.float32, 2, dev)
    if cols_lo.shape != cols_hi.shape or tuple(cols_hi.shape[2:]) != (16, 128):
        raise ValueError("cols must both be [dp_chunks, Hpt, 16, 128]")
    if nsw < 1 or cols_hi.shape[0] < nsw * N_CHUNKS \
            or live.shape[1] != 128 or live.shape[0] < nsw * SW_ROWS:
        raise ValueError(f"nsw={nsw} exceeds the cols/live extent")
    return int(cols_hi.shape[1])


def _check_sweep(qscale, cols_hi, cols_lo, wq, live, nsw: int) -> int:
    """Checks shared by the three sweeps; returns QC."""
    dev = cols_hi.device
    hpt = _check_cols(cols_hi, cols_lo, live, nsw, dev)
    _check(wq, "wq", torch.int8, 3, dev)
    _check(qscale, "qscale", torch.float32, 2, dev)
    qc = int(wq.shape[1])
    if wq.shape[0] != 2 or wq.shape[2] != hpt or qc < 1:
        raise ValueError(f"wq shape {tuple(wq.shape)} is not [2, QC, {hpt}]")
    if tuple(qscale.shape) != (qc, 1):
        raise ValueError(f"qscale shape {tuple(qscale.shape)} is not [{qc}, 1]")
    return qc


def sweep_list_cap(hpt: int) -> int:
    """The list entries the sweeps' block holds at once: a whole group's
    slots where they fit in SWEEP_LIST_MIN, else at least one query's."""
    return min(SWEEP_GROUP * hpt, max(hpt, SWEEP_LIST_MIN))


def _check_aligned(*tensors) -> None:
    """The group kernel's 16-byte loads of the columns, live and K6's
    mask."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("live, cols and mask must be 16-byte aligned "
                         "(16-byte loads)")


def _sweep_out(nsw: int, qc: int, dev):
    return (_out((nsw, qc, CAND_PAD), torch.float32, dev),
            _out((nsw, qc, CAND_PAD), torch.int32, dev))


def sweep_rowmax(qscale, cols_hi, cols_lo, wq, live, *, nsw: int):
    """Pass 1: sweep the column cache for QC queries.

    qscale [QC, 1] f32 — per-query descale factor (qs2 * COLSCALE2)
    cols_hi/cols_lo [dp_chunks, Hpt, 16, 128] i8 — chunk-major columns
    wq [2, QC, Hpt] i8 — hi/lo quantized query weights over slots
    live [dp_rows, 128] f32

    Returns (rowmax [nsw, QC, CAND_PAD] f32, rows [nsw, QC, CAND_PAD] i32):
    per superwindow the top NCAND rows by (rowmax desc, row asc), global row
    ids, padded with (-inf, 0).
    """
    dev = cols_hi.device
    qc = _check_sweep(qscale, cols_hi, cols_lo, wq, live, nsw)
    if not _route(dev):
        return sweep_rowmax_plain(qscale, cols_hi, cols_lo, wq, live, nsw=nsw)
    _check_aligned(cols_hi, cols_lo, live)
    rm, rr = _sweep_out(nsw, qc, dev)
    _launch("sweep_rowmax", dev, qscale.data_ptr(), cols_hi.data_ptr(),
            cols_lo.data_ptr(), wq.data_ptr(), live.data_ptr(),
            rm.data_ptr(), rr.data_ptr(), qc, int(cols_hi.shape[1]), int(nsw))
    return rm, rr


# --------------------------------------------------------------------------
# K7 conjunctive sweep (coverage product; ES_TPU_BITSET=0)
# --------------------------------------------------------------------------


def sweep_rowmax_conj_plain(qscale, nreq, cols_hi, cols_lo, wq, wp, live, *,
                            nsw: int):
    """Plain torch K7: K2 plus the coverage product in float64 (exact)."""
    return _sweep_plain(qscale, cols_hi, cols_lo, wq, live, nsw, wp=wp,
                        nreq=nreq)


def sweep_rowmax_conj(qscale, nreq, cols_hi, cols_lo, wq, wp, live, *,
                      nsw: int):
    """Conjunctive sweep: K2, keeping only docs that satisfy each query's
    required clauses.

    nreq [QC, 1] i32 — required-clause count per query
    wp [QC, Hpt] i8 — +1 on each required slot, -(n_req + 1) on each
        must_not slot, 0 elsewhere

    A doc survives iff sum(wp[slot] * present[slot, doc]) == n_req, with
    present = (hi != 0) | (lo != 0). Returns the same (rowmax, rows) pair
    as sweep_rowmax.
    """
    dev = cols_hi.device
    qc = _check_sweep(qscale, cols_hi, cols_lo, wq, live, nsw)
    _check(nreq, "nreq", torch.int32, 2, dev)
    _check(wp, "wp", torch.int8, 2, dev)
    if tuple(nreq.shape) != (qc, 1):
        raise ValueError(f"nreq shape {tuple(nreq.shape)} is not [{qc}, 1]")
    if tuple(wp.shape) != (qc, int(cols_hi.shape[1])):
        raise ValueError(f"wp shape {tuple(wp.shape)} is not "
                         f"[{qc}, {int(cols_hi.shape[1])}]")
    if not _route(dev):
        return sweep_rowmax_conj_plain(qscale, nreq, cols_hi, cols_lo, wq,
                                       wp, live, nsw=nsw)
    _check_aligned(cols_hi, cols_lo, live)
    rm, rr = _sweep_out(nsw, qc, dev)
    _launch("sweep_rowmax_conj", dev, qscale.data_ptr(), nreq.data_ptr(),
            cols_hi.data_ptr(), cols_lo.data_ptr(), wq.data_ptr(),
            wp.data_ptr(), live.data_ptr(), rm.data_ptr(), rr.data_ptr(),
            qc, int(cols_hi.shape[1]), int(nsw))
    return rm, rr


# --------------------------------------------------------------------------
# packed bitsets: pack, K5 intersect, chunk counts, K6 gated sweep
# --------------------------------------------------------------------------

_PACK_SLOTS = 4       # slots packed per step: bounds the int64 temporaries


def pack_presence_bits_plain(cols_hi, cols_lo):
    """Plain torch pack (the reference's XLA program, kernels.py:358): a few
    slots at a time into the preallocated result, so the temporaries stay a
    few hundred MB at 8M docs."""
    dev = cols_hi.device
    dpc, hp1 = int(cols_hi.shape[0]), int(cols_hi.shape[1])
    wgr = dpc // 2
    bits = torch.empty((hp1 + 1, wgr, 128), dtype=torch.int32, device=dev)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)[None, None, :,
                                                             None]
    for s0 in range(0, hp1, _PACK_SLOTS):
        s1 = min(hp1, s0 + _PACK_SLOTS)
        p = (cols_hi[:, s0:s1] != 0) | (cols_lo[:, s0:s1] != 0)
        p = p.view(wgr, 2, s1 - s0, 16, 128).permute(2, 0, 1, 3, 4)
        w = (p.reshape(s1 - s0, wgr, 32, 128).to(torch.int64)
             << shifts).sum(dim=2)
        bits[s0:s1] = torch.where(w >= 1 << 31, w - (1 << 32), w).to(
            torch.int32)
    bits[hp1] = -1
    return bits


def pack_presence_bits(cols_hi, cols_lo):
    """Pack the column cache's presence into per-slot doc bitsets.

    cols_hi/cols_lo [dp_chunks, Hp+1, 16, 128] i8. Presence is exact
    ((hi | lo) != 0: the build forces lo >= 1 on present cells).

    Returns bits [Hp+2, dp_chunks // 2, 128] i32 (uint32 bit patterns):
    bit j of word [s, g, l] is slot s's presence at posting row 32g + j,
    lane l, so a word row holds two sweep chunks. Slot Hp (the scratch
    slot, always zero) is the AND-NOT identity and the empty mask; the
    appended slot Hp+1 is all ones, the AND identity. On the card one
    launch of csrc/pack_bits.cu writes the whole result."""
    dev = cols_hi.device
    _check(cols_hi, "cols_hi", torch.int8, 4, dev)
    _check(cols_lo, "cols_lo", torch.int8, 4, dev)
    if (cols_lo.shape != cols_hi.shape or cols_hi.shape[0] % 2
            or tuple(cols_hi.shape[2:]) != (16, 128)):
        raise ValueError("cols must both be [dp_chunks, Hp+1, 16, 128] with "
                         "an even dp_chunks")
    if not _route(dev):
        return pack_presence_bits_plain(cols_hi, cols_lo)
    if cols_hi.data_ptr() % 4 or cols_lo.data_ptr() % 4:
        raise ValueError("cols must be 4-byte aligned (4-byte loads)")
    dpc, hp1 = int(cols_hi.shape[0]), int(cols_hi.shape[1])
    bits = _out((hp1 + 1, dpc // 2, 128), torch.int32, dev)
    _launch("pack_presence_bits", dev, cols_hi.data_ptr(),
            cols_lo.data_ptr(), bits.data_ptr(), dpc, hp1)
    return bits


def mask_chunk_counts(mask):
    """Per-query count of 2048-doc chunks with any surviving bit (torch
    code; an XLA program in the reference, kernels.py:445; on the card K5
    computes it in its own pass, intersect_bitset_counts).

    mask [QC, wgr, 128] i32; word row g holds chunks 2g (low 16 bits) and
    2g + 1 (high 16; the shift is arithmetic, hence the mask after it).
    Returns [QC] i32."""
    lo = ((mask & 0xFFFF) != 0).any(dim=-1)
    hi = (((mask >> 16) & 0xFFFF) != 0).any(dim=-1)
    return (lo.sum(dim=-1) + hi.sum(dim=-1)).to(torch.int32)


def intersect_bitset_plain(q_slots, q_neg, bits, *, nsw: int):
    """Plain torch K5: gather and AND the clause blocks, AND-NOT the
    prohibited ones."""
    b = bits[:, : nsw * SW_WORD_ROWS]
    acc = b[q_slots[:, 0].long()]
    for c in range(1, BITSET_CLAUSES):
        acc = acc & b[q_slots[:, c].long()]
    for n in range(BITSET_NEGS):
        acc = acc & ~b[q_neg[:, n].long()]
    return acc


def intersect_bitset_counts_plain(q_slots, q_neg, bits, *, nsw: int):
    """Plain torch K5 with its counts: the mask, then mask_chunk_counts."""
    mask = intersect_bitset_plain(q_slots, q_neg, bits, nsw=nsw)
    return mask, mask_chunk_counts(mask)


def _host_slots(q_slots, q_neg, bits, nsw: int):
    """K5's input checks; returns the clause slots on the host. They lie
    on bits' device, or on the CPU when bits is on the card (slots on the
    card are read back); a slot outside [0, Hp+2) raises ValueError."""
    dev = bits.device
    _check(bits, "bits", torch.int32, 3, dev)
    qdev = q_slots.device if isinstance(q_slots, torch.Tensor) else dev
    if qdev != dev and not (qdev.type == "cpu" and _route(dev)):
        raise ValueError(f"q_slots is on {qdev}, expected {dev} or the CPU")
    _check(q_slots, "q_slots", torch.int32, 2, qdev)
    _check(q_neg, "q_neg", torch.int32, 2, qdev)
    qc = int(q_slots.shape[0])
    n_slots = int(bits.shape[0])
    if qc < 1 or q_slots.shape[1] != BITSET_CLAUSES \
            or tuple(q_neg.shape) != (qc, BITSET_NEGS):
        raise ValueError(f"q_slots {tuple(q_slots.shape)} / q_neg "
                         f"{tuple(q_neg.shape)} are not [QC, "
                         f"{BITSET_CLAUSES}] / [QC, {BITSET_NEGS}]")
    if n_slots < 2 or bits.shape[2] != 128 or nsw < 1 \
            or bits.shape[1] < nsw * SW_WORD_ROWS:
        raise ValueError(f"bits shape {tuple(bits.shape)} does not cover "
                         f"nsw={nsw}")
    if qdev.type != "cpu":
        q_slots, q_neg = q_slots.cpu(), q_neg.cpu()
    a, b = q_slots.numpy(), q_neg.numpy()
    if (a.min() < 0 or a.max() >= n_slots or b.min() < 0
            or b.max() >= n_slots):
        raise ValueError(f"a clause slot lies outside the bitsets "
                         f"[0, {n_slots})")
    return q_slots, q_neg


def intersect_bitset_counts(q_slots, q_neg, bits, *, nsw: int):
    """Blockwise clause intersection over the packed bitsets, with each
    query's count of 2048-doc chunks that keep a bit.

    q_slots [QC, BITSET_CLAUSES] i32 — bits slot per required clause (pad
        with a repeated clause or the all-ones sentinel; an inactive row
        points every clause at the all-zero sentinel)
    q_neg [QC, BITSET_NEGS] i32 — slot per must_not clause (pad with the
        all-zero sentinel)
    bits [Hp+2, rows, 128] i32 — pack_presence_bits output, rows >=
        nsw * SW_WORD_ROWS. The kernel relies on what pack_presence_bits
        guarantees: slot Hp is all zeros and slot Hp+1 all ones.

    q_slots and q_neg lie on bits' device, or on the CPU when bits is on
    the card. On the card the kernel takes them from the host, in its
    launch's parameters (one launch per INTERSECT_TABLE_Q queries): slots
    given on the host (the engine's way) are checked there and nothing is
    copied to the card first; slots given on the card are read back once.
    A slot outside [0, Hp+2) raises ValueError on every route.

    Returns (mask [QC, nsw * SW_WORD_ROWS, 128] i32, counts [QC] i32),
    counts equal to mask_chunk_counts(mask); on the card one launch
    computes both.
    """
    return _intersect(q_slots, q_neg, bits, nsw, True)


def intersect_bitset(q_slots, q_neg, bits, *, nsw: int):
    """intersect_bitset_counts without the counts: the mask alone."""
    return _intersect(q_slots, q_neg, bits, nsw, False)


def _intersect(q_slots, q_neg, bits, nsw: int, with_counts: bool):
    dev = bits.device
    q_slots, q_neg = _host_slots(q_slots, q_neg, bits, nsw)
    if not _route(dev):
        if with_counts:
            return intersect_bitset_counts_plain(q_slots, q_neg, bits,
                                                 nsw=nsw)
        return intersect_bitset_plain(q_slots, q_neg, bits, nsw=nsw)
    qc = int(q_slots.shape[0])
    mask = _out((qc, nsw * SW_WORD_ROWS, 128), torch.int32, dev)
    counts = _out((qc,), torch.int32, dev)
    # the slots ride in the launch's parameters, 256 queries a launch
    ptrs = (q_slots.data_ptr(), q_neg.data_ptr(), mask.data_ptr(),
            counts.data_ptr())
    for q0 in range(0, qc, INTERSECT_TABLE_Q):
        _launch("intersect_bitset", dev, ptrs[0] + q0 * BITSET_CLAUSES * 4,
                ptrs[1] + q0 * BITSET_NEGS * 4, bits.data_ptr(),
                ptrs[2] + q0 * mask.stride(0) * 4, ptrs[3] + q0 * 4,
                min(INTERSECT_TABLE_Q, qc - q0), int(nsw),
                int(bits.shape[1]), int(bits.shape[0]))
    return (mask, counts) if with_counts else mask


def sweep_rowmax_bitset_plain(qscale, cols_hi, cols_lo, wq, mask, live, *,
                              nsw: int):
    """Plain torch K6: K2 with each doc gated by its mask bit."""
    return _sweep_plain(qscale, cols_hi, cols_lo, wq, live, nsw, mask=mask)


def sweep_rowmax_bitset(qscale, cols_hi, cols_lo, wq, mask, live, *,
                        nsw: int):
    """Bitset-gated sweep: K2 over the docs whose bit is set in the
    intersected mask (intersect_bitset output).

    mask [QC, nsw * SW_WORD_ROWS, 128] i32 — chunk c of superwindow sw
    reads word row sw * SW_WORD_ROWS + c // 2, bit half c % 2. Rows with
    no surviving bit read no columns and come out -inf. Returns the same
    (rowmax, rows) pair as sweep_rowmax.
    """
    dev = cols_hi.device
    qc = _check_sweep(qscale, cols_hi, cols_lo, wq, live, nsw)
    _check(mask, "mask", torch.int32, 3, dev)
    if tuple(mask.shape) != (qc, nsw * SW_WORD_ROWS, 128):
        raise ValueError(f"mask shape {tuple(mask.shape)} is not "
                         f"[{qc}, {nsw * SW_WORD_ROWS}, 128]")
    if not _route(dev):
        return sweep_rowmax_bitset_plain(qscale, cols_hi, cols_lo, wq, mask,
                                         live, nsw=nsw)
    _check_aligned(cols_hi, cols_lo, live, mask)
    rm, rr = _sweep_out(nsw, qc, dev)
    _launch("sweep_rowmax_bitset", dev, qscale.data_ptr(),
            cols_hi.data_ptr(), cols_lo.data_ptr(), wq.data_ptr(),
            mask.data_ptr(), live.data_ptr(), rm.data_ptr(), rr.data_ptr(),
            qc, int(cols_hi.shape[1]), int(nsw))
    return rm, rr


# --------------------------------------------------------------------------
# the row pick, and F1-F3: the fused S > 1 sweeps
# --------------------------------------------------------------------------


def pick_rows(rm: torch.Tensor, rr: torch.Tensor, *, n_rows: int):
    """Global candidate-row pick on the device (reference turbo.py:83):
    from a sweep's per-superwindow top-NCAND (rowmax, row) pairs,
    [..., nsw, QC, CAND_PAD] (any leading partition axes), keep each
    query's global top n_rows rows.

    Returns [..., QC, n_rows + 1] f32: row ids as exact floats (-1 marks
    empty slots) and, in the last column, the max approximate score any
    uncollected row could hold. `lax.top_k` returns the smallest index
    among equal values; a stable descending sort does the same. Dead
    superwindows (every rowmax -inf) change nothing, so a partition padded
    to a longer nsw picks what it picks alone."""
    lead = tuple(rm.shape[:-3])
    nsw, qc = rm.shape[-3], rm.shape[-2]
    m = rm[..., :NCAND].movedim(-3, -2).reshape(*lead, qc, nsw * NCAND)
    r = rr[..., :NCAND].movedim(-3, -2).reshape(*lead, qc, nsw * NCAND)
    if m.shape[-1] < n_rows + 1:
        pad = n_rows + 1 - m.shape[-1]
        m = torch.cat([m, torch.full((*lead, qc, pad), float("-inf"),
                                     dtype=m.dtype, device=m.device)], -1)
        r = torch.cat([r, torch.zeros((*lead, qc, pad), dtype=r.dtype,
                                      device=r.device)], -1)
    top_m, idx = torch.sort(m, dim=-1, descending=True, stable=True)
    top_m, idx = top_m[..., :n_rows + 1], idx[..., :n_rows + 1]
    valid = top_m[..., :n_rows] > float("-inf")
    rows = torch.where(valid, torch.gather(r, -1, idx[..., :n_rows]),
                       torch.full_like(r[..., :n_rows], -1))
    beyond = top_m[..., n_rows]
    beyond = torch.where(torch.isfinite(beyond), beyond,
                         torch.zeros_like(beyond))
    sw_last = rm[..., NCAND - 1]                      # [..., nsw, QC]
    sw_bound = torch.where(sw_last > float("-inf"), sw_last,
                           torch.zeros_like(sw_last)).amax(dim=-2)
    return torch.cat([rows.float(),
                      torch.maximum(beyond, sw_bound)[..., None]], dim=-1)


def _check_fused(qscale, cols_hi, cols_lo, wq, live, nsw):
    """Checks shared by F1-F3: the stacked query inputs, and each
    partition's columns and live mask against its nsw as _check_sweep
    takes them. Returns (S, QC, [Hpt per partition])."""
    n = len(cols_hi)
    if n < 1 or not (len(cols_lo) == len(live) == len(nsw) == n):
        raise ValueError(f"{len(cols_hi)} cols_hi, {len(cols_lo)} cols_lo, "
                         f"{len(live)} live and {len(nsw)} nsw: one per "
                         f"partition")
    dev = cols_hi[0].device
    hpts = [_check_cols(cols_hi[i], cols_lo[i], live[i], int(nsw[i]), dev)
            for i in range(n)]
    _check(wq, "wq", torch.int8, 4, dev)
    _check(qscale, "qscale", torch.float32, 3, dev)
    qc = int(wq.shape[2])
    if wq.shape[0] != n or wq.shape[1] != 2 or qc < 1 \
            or wq.shape[3] < max(hpts):
        raise ValueError(f"wq shape {tuple(wq.shape)} is not [{n}, 2, QC, "
                         f">= {max(hpts)}]")
    if tuple(qscale.shape) != (n, qc, 1):
        raise ValueError(f"qscale shape {tuple(qscale.shape)} is not "
                         f"[{n}, {qc}, 1]")
    return n, qc, hpts


def _part_wq(wq, i: int, hpt: int):
    """Partition i's weights over its own slots, [2, QC, hpt]."""
    return wq[i, :, :, :hpt].contiguous()


def _sweep_table(cols_hi, cols_lo, live, nsw, hpts) -> np.ndarray:
    """The fused sweeps' partition table: a row (cols_hi, cols_lo, live,
    nsw, hpt) of int64 a partition, as the C entries read it."""
    _check_aligned(*cols_hi, *cols_lo, *live)
    return np.asarray([[cols_hi[i].data_ptr(), cols_lo[i].data_ptr(),
                        live[i].data_ptr(), int(nsw[i]), hpts[i]]
                       for i in range(len(cols_hi))], np.int64)


def _fused_launch(name, table, n, qc, nsw_max, stacked, outs, ints):
    """One launch of a fused C entry per MAX_FUSED_PARTS partitions: each
    stacked input (tensor, per-partition element count) and output is
    offset to the launch's first partition."""
    for p0 in range(0, n, MAX_FUSED_PARTS):
        p1 = min(n, p0 + MAX_FUSED_PARTS)
        ptrs = [t.data_ptr() + p0 * per * t.element_size()
                for t, per in stacked + outs]
        _launch(name, outs[0][0].device, table[p0:p1].ctypes.data, p1 - p0,
                *ptrs, qc, *ints, nsw_max)


def _fused_sweep_out(n: int, nsw_max: int, qc: int, dev):
    rm = _out((n, nsw_max, qc, CAND_PAD), torch.float32, dev)
    rr = _out((n, nsw_max, qc, CAND_PAD), torch.int32, dev)
    per = nsw_max * qc * CAND_PAD
    return rm, rr, [(rm, per), (rr, per)]


def fused_sweep_rowmax_plain(qscale, cols_hi, cols_lo, wq, live, *, nsw,
                             n_rows: int):
    """Plain F1: each partition's plain K2 and row pick, stacked."""
    return torch.stack([
        pick_rows(*sweep_rowmax_plain(
            qscale[i], cols_hi[i], cols_lo[i],
            _part_wq(wq, i, int(cols_hi[i].shape[1])), live[i],
            nsw=int(nsw[i])), n_rows=n_rows)
        for i in range(len(cols_hi))])


def fused_sweep_rowmax(qscale, cols_hi, cols_lo, wq, live, *, nsw,
                       n_rows: int):
    """F1: every partition's disjunctive sweep and row pick, one launch
    for all (reference turbo.py:2099).

    qscale [S, QC, 1] f32; cols_hi, cols_lo, live: sequences of S tensors,
    each partition's own as sweep_rowmax takes them; wq [S, 2, QC, Hw] i8
    with Hw >= every partition's Hpt (partition i reads its first Hpt_i
    slots); nsw: S ints. Returns [S, QC, n_rows + 1] f32, each partition's
    pick_rows of its sweep_rowmax. On the card the kernel reads the
    partitions' tensors through a table of their pointers (no stacked
    copy) and sweeps every superwindow up to the largest nsw, the ones
    past a partition's own as dead padding."""
    n, qc, hpts = _check_fused(qscale, cols_hi, cols_lo, wq, live, nsw)
    dev = wq.device
    if not _route(dev):
        return fused_sweep_rowmax_plain(qscale, cols_hi, cols_lo, wq, live,
                                        nsw=nsw, n_rows=n_rows)
    table = _sweep_table(cols_hi, cols_lo, live, nsw, hpts)
    nsw_max = max(int(x) for x in nsw)
    ws = int(wq.shape[3])
    rm, rr, outs = _fused_sweep_out(n, nsw_max, qc, dev)
    _fused_launch("fused_sweep_rowmax", table, n, qc, nsw_max,
                  [(qscale, qc), (wq, 2 * qc * ws)], outs, [ws])
    return pick_rows(rm, rr, n_rows=n_rows)


def fused_sweep_rowmax_conj_plain(qscale, nreq, cols_hi, cols_lo, wq, wp,
                                  live, *, nsw, n_rows: int):
    """Plain F2: each partition's plain K7 and row pick, stacked."""
    out = []
    for i in range(len(cols_hi)):
        hpt = int(cols_hi[i].shape[1])
        out.append(pick_rows(*sweep_rowmax_conj_plain(
            qscale[i], nreq[i], cols_hi[i], cols_lo[i],
            _part_wq(wq, i, hpt), wp[i, :, :hpt].contiguous(), live[i],
            nsw=int(nsw[i])), n_rows=n_rows))
    return torch.stack(out)


def fused_sweep_rowmax_conj(qscale, nreq, cols_hi, cols_lo, wq, wp, live, *,
                            nsw, n_rows: int):
    """F2: F1 with K7's coverage gate (reference turbo.py:2128). Adds nreq
    [S, QC, 1] i32 and wp [S, QC, Hw] i8 (sweep_rowmax_conj's, stacked);
    returns [S, QC, n_rows + 1] f32."""
    n, qc, hpts = _check_fused(qscale, cols_hi, cols_lo, wq, live, nsw)
    dev = wq.device
    ws = int(wq.shape[3])
    _check(nreq, "nreq", torch.int32, 3, dev)
    _check(wp, "wp", torch.int8, 3, dev)
    if tuple(nreq.shape) != (n, qc, 1):
        raise ValueError(f"nreq shape {tuple(nreq.shape)} is not "
                         f"[{n}, {qc}, 1]")
    if tuple(wp.shape) != (n, qc, ws):
        raise ValueError(f"wp shape {tuple(wp.shape)} is not [{n}, {qc}, "
                         f"{ws}]")
    if not _route(dev):
        return fused_sweep_rowmax_conj_plain(qscale, nreq, cols_hi, cols_lo,
                                             wq, wp, live, nsw=nsw,
                                             n_rows=n_rows)
    table = _sweep_table(cols_hi, cols_lo, live, nsw, hpts)
    nsw_max = max(int(x) for x in nsw)
    rm, rr, outs = _fused_sweep_out(n, nsw_max, qc, dev)
    _fused_launch("fused_sweep_rowmax_conj", table, n, qc, nsw_max,
                  [(qscale, qc), (nreq, qc), (wq, 2 * qc * ws),
                   (wp, qc * ws)], outs, [ws])
    return pick_rows(rm, rr, n_rows=n_rows)


def fused_sweep_rowmax_bitset_plain(qscale, q_slots, q_neg, bits, cols_hi,
                                    cols_lo, wq, live, *, nsw, n_rows: int):
    """Plain F3: each partition's plain K5 with its chunk counts, plain K6
    and row pick, stacked: (picked, counts)."""
    picked, counts = [], []
    for i in range(len(cols_hi)):
        mask, cnt = intersect_bitset_counts_plain(
            q_slots[i].to(bits[i].device), q_neg[i].to(bits[i].device),
            bits[i], nsw=int(nsw[i]))
        picked.append(pick_rows(*sweep_rowmax_bitset_plain(
            qscale[i], cols_hi[i], cols_lo[i],
            _part_wq(wq, i, int(cols_hi[i].shape[1])), mask, live[i],
            nsw=int(nsw[i])), n_rows=n_rows))
        counts.append(cnt)
    return torch.stack(picked), torch.stack(counts)


def fused_sweep_rowmax_bitset(qscale, q_slots, q_neg, bits, cols_hi, cols_lo,
                              wq, live, *, nsw, n_rows: int):
    """F3: per partition K5's clause intersection (with its chunk counts)
    feeding K6's mask-gated sweep and the row pick (reference
    turbo.py:2148): two launches for every partition, the stacked K5 then
    the stacked K6, on one stream.

    q_slots [S, QC, BITSET_CLAUSES], q_neg [S, QC, BITSET_NEGS] i32 on the
    CPU or on the card, slots of each partition's own bitsets; bits: S
    tensors, pack_presence_bits of each partition's columns. Returns
    (picked [S, QC, n_rows + 1] f32, counts [S, QC] i32). A slot outside
    its partition's bitsets raises ValueError (checked on the host)."""
    n, qc, hpts = _check_fused(qscale, cols_hi, cols_lo, wq, live, nsw)
    dev = wq.device
    if len(bits) != n:
        raise ValueError(f"{len(bits)} bits for {n} partitions")
    qdev = q_slots.device if isinstance(q_slots, torch.Tensor) else dev
    _check(q_slots, "q_slots", torch.int32, 3, qdev)
    _check(q_neg, "q_neg", torch.int32, 3, qdev)
    if tuple(q_slots.shape) != (n, qc, BITSET_CLAUSES) \
            or tuple(q_neg.shape) != (n, qc, BITSET_NEGS):
        raise ValueError(f"q_slots {tuple(q_slots.shape)} / q_neg "
                         f"{tuple(q_neg.shape)} are not [{n}, {qc}, "
                         f"{BITSET_CLAUSES}] / [{n}, {qc}, {BITSET_NEGS}]")
    for i in range(n):           # each partition's slots, on the host
        _host_slots(q_slots[i], q_neg[i], bits[i], int(nsw[i]))
    if not _route(dev):
        return fused_sweep_rowmax_bitset_plain(
            qscale, q_slots, q_neg, bits, cols_hi, cols_lo, wq, live,
            nsw=nsw, n_rows=n_rows)
    if any(b.data_ptr() % 16 for b in bits):
        raise ValueError("bits must be 16-byte aligned (16-byte loads)")
    if qdev.type == "cpu":
        q_slots = q_slots.to(dev)
        q_neg = q_neg.to(dev)
    return _fused_bitset_launches(qscale, q_slots, q_neg, bits, cols_hi,
                                  cols_lo, wq, live, nsw, n_rows, hpts)


def _fused_bitset_launches(qscale, q_slots, q_neg, bits, cols_hi, cols_lo,
                           wq, live, nsw, n_rows: int, hpts):
    """F3's two launches and the row pick on inputs fused_sweep_rowmax_
    bitset has checked, the clause slots already on the card: no copy
    and no read-back, so a CUDA graph can capture it."""
    n, qc = len(cols_hi), int(wq.shape[2])
    nsw_max = max(int(x) for x in nsw)
    ws = int(wq.shape[3])
    mask, counts = _fused_intersect(q_slots, q_neg, bits, nsw)
    table = _sweep_table(cols_hi, cols_lo, live, nsw, hpts)
    rm, rr, outs = _fused_sweep_out(n, nsw_max, qc, wq.device)
    _fused_launch("fused_sweep_rowmax_bitset", table, n, qc, nsw_max,
                  [(qscale, qc), (wq, 2 * qc * ws),
                   (mask, qc * nsw_max * SW_WORD_ROWS * 128)], outs, [ws])
    return pick_rows(rm, rr, n_rows=n_rows), counts


def _fused_intersect(q_slots, q_neg, bits, nsw):
    """F3's first launch: every partition's K5 with its chunk counts,
    the slots [S, QC, 8] / [S, QC, 4] already checked and on the card.
    Returns (mask [S, QC, nsw_max * 16, 128], counts [S, QC]); a
    partition's mask past its own nsw is not written (K6 reads none of
    it)."""
    dev = bits[0].device
    n, qc = int(q_slots.shape[0]), int(q_slots.shape[1])
    nsw_max = max(int(x) for x in nsw)
    btab = np.asarray([[bits[i].data_ptr(), int(nsw[i]), int(bits[i].shape[1]),
                        int(bits[i].shape[0])] for i in range(n)], np.int64)
    mask = _out((n, qc, nsw_max * SW_WORD_ROWS, 128), torch.int32, dev)
    counts = _out((n, qc), torch.int32, dev)
    m_per = qc * nsw_max * SW_WORD_ROWS * 128
    for p0 in range(0, n, MAX_FUSED_PARTS):
        p1 = min(n, p0 + MAX_FUSED_PARTS)
        _launch("fused_intersect_bitset", dev, btab[p0:p1].ctypes.data,
                p1 - p0, q_slots.data_ptr() + p0 * qc * BITSET_CLAUSES * 4,
                q_neg.data_ptr() + p0 * qc * BITSET_NEGS * 4,
                mask.data_ptr() + p0 * m_per * 4,
                counts.data_ptr() + p0 * qc * 4, qc, nsw_max)
    return mask, counts


# --------------------------------------------------------------------------
# K3 eager sparse gather (cold tier)
# --------------------------------------------------------------------------


def _sparse_gather_one(coff, cw, ct0, ct1, pool, n_tiles: int):
    """One query's chunks: added into per-doc f32 totals one at a time in rc
    order (a chunk's docs are distinct), each addend f32(imp) * cw rounded
    on its own, then every lane reads its doc's total back. Lanes with
    imp = 0, or whose tile lies outside the chunk's [ct0, ct1] or the grid,
    read 0."""
    dev = pool.device
    n_rc = int(coff.shape[0])
    v = pool[coff.long()].reshape(n_rc, SPARSE_GRAN)
    doc = (v >> 8) & 0xFFFFFF
    imp = v & SPARSE_IMP_MAX
    tile = doc // TILE
    ok = ((imp > 0) & (tile >= ct0[:, None]) & (tile <= ct1[:, None])
          & (tile < n_tiles))
    val = imp.float() * cw[:, None]
    acc = torch.zeros(n_tiles * TILE, dtype=torch.float32, device=dev)
    doc = doc.long()
    for rc in range(n_rc):
        m = ok[rc]
        acc.index_add_(0, doc[rc][m], val[rc][m])
    out = torch.where(ok, acc[torch.where(ok, doc, 0)],
                      torch.zeros((), dtype=torch.float32, device=dev))
    return out.view(n_rc, SPARSE_GRAN // 128, 128)


def sparse_gather_plain(coff, cw, ct0, ct1, pool, *, n_tiles: int,
                        qoff=None):
    """Plain torch K3: each query's chunk range [qoff[q], qoff[q + 1]) is
    gathered on its own (qoff None: one query over every chunk)."""
    if qoff is None:
        return _sparse_gather_one(coff, cw, ct0, ct1, pool, n_tiles)
    qo = [int(x) for x in qoff.cpu()]
    outs = [_sparse_gather_one(coff[a:b], cw[a:b], ct0[a:b], ct1[a:b], pool,
                               n_tiles)
            for a, b in zip(qo[:-1], qo[1:])]
    if not outs:
        return torch.zeros((0, SPARSE_GRAN // 128, 128), dtype=torch.float32,
                           device=pool.device)
    return torch.cat(outs)


def sparse_gather(coff, cw, ct0, ct1, pool, *, n_tiles: int, qoff=None,
                  host_checked: bool = False):
    """Cold-term eager sparse scoring, for one query or a batch of them.

    coff [n_rc] i32 — pool granule per 1024-lane chunk (granule 0 is the
        reserved all-zero granule padding chunks point at); an offset
        outside [0, G) raises ValueError
    cw [n_rc] f32 — per-chunk dequant weight (idf * boost * slice scale)
    ct0/ct1 [n_rc] i32 — inclusive 16384-doc tile range of the chunk's
        sorted docs; (1, 0) skips a chunk
    pool [G, 8, 128] i32 — packed granules, doc << 8 | impact. Each
        chunk's live lanes (impact > 0) come first, with distinct docs in
        ascending order, then zero lanes only: the kernel finds a doc in a
        granule by binary search (TurboBM25._ensure_sparse packs slices so)
    qoff [Q + 1] i32 — query q owns chunks [qoff[q], qoff[q + 1]): qoff[0]
        is 0, qoff[Q] is n_rc, and it never descends (empty queries are
        allowed); None means one query over every chunk
    host_checked — the caller has already held coff against the pool and
        qoff to the rules above on the host; the wrapper then skips its own
        check (one read-back on the card)

    Returns [n_rc, 8, 128] f32: at each chunk lane, the total over its
    query's chunks of its doc's contributions.
    """
    dev = pool.device
    _check(pool, "pool", torch.int32, 3, dev)
    if tuple(pool.shape[1:]) != (SPARSE_GRAN // 128, 128):
        raise ValueError(f"pool shape {tuple(pool.shape)} is not [G, 8, 128]")
    _check(coff, "coff", torch.int32, 1, dev)
    _check(cw, "cw", torch.float32, 1, dev)
    _check(ct0, "ct0", torch.int32, 1, dev)
    _check(ct1, "ct1", torch.int32, 1, dev)
    n_rc = int(coff.shape[0])
    if not (cw.shape[0] == ct0.shape[0] == ct1.shape[0] == n_rc):
        raise ValueError("coff, cw, ct0 and ct1 must have one entry per chunk")
    if n_tiles < 1:
        raise ValueError(f"n_tiles={n_tiles}")
    if qoff is not None:
        _check(qoff, "qoff", torch.int32, 1, dev)
        if qoff.shape[0] < 1:
            raise ValueError("qoff needs at least one entry")
    if not host_checked:
        # a granule offset outside the pool or a malformed qoff is a caller
        # bug: both routes refuse it here, rather than the kernel reading
        # zeros and the plain version raising an IndexError (one read-back
        # on the card)
        bad = [((coff < 0) | (coff >= pool.shape[0])).any()]
        if qoff is not None:
            bad.append((qoff[0] != 0) | (qoff[-1] != n_rc)
                       | (qoff[1:] < qoff[:-1]).any())
        bad = torch.stack(bad).tolist()
        if bad[0]:
            raise ValueError(f"coff holds a granule outside the pool "
                             f"[0, {int(pool.shape[0])})")
        if bad[1:] and bad[1]:
            raise ValueError(f"qoff must ascend from 0 to n_rc={n_rc}")
    if not _route(dev):
        return sparse_gather_plain(coff, cw, ct0, ct1, pool, n_tiles=n_tiles,
                                   qoff=qoff)
    out = _out((n_rc, SPARSE_GRAN // 128, 128), torch.float32, dev)
    if n_rc == 0:
        return out
    n_q = 1 if qoff is None else int(qoff.shape[0]) - 1
    _launch("sparse_gather", dev, coff.data_ptr(), cw.data_ptr(),
            ct0.data_ptr(), ct1.data_ptr(), n_rc,
            0 if qoff is None else qoff.data_ptr(), n_q, pool.data_ptr(),
            int(pool.shape[0]), out.data_ptr(), int(n_tiles))
    return out


# --------------------------------------------------------------------------
# K4 partition merge
# --------------------------------------------------------------------------


def merge_topk_plain(scores, ords, *, k: int):
    """Plain torch K4: the reference's k-step max cascade. Each step takes
    the largest score, the lowest partition among its lanes, then the
    lowest ord among those, and clears every lane holding that triple."""
    dev = scores.device
    Q, L = scores.shape
    p = (torch.arange(L, device=dev, dtype=torch.int32) // k)[None, :]
    s = torch.where(scores > 0, scores, torch.zeros_like(scores))
    o = ords
    big = torch.full((), 1 << 30, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out_s = torch.zeros((Q, k), dtype=torch.float32, device=dev)
    out_p = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    out_o = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    if L == 0:
        return out_s, out_p, out_o
    for j in range(k):
        m = s.amax(dim=1, keepdim=True)
        at = (s == m) & (m > 0)
        pmin = torch.where(at, p, big).amin(dim=1, keepdim=True)
        at2 = at & (p == pmin)
        omin = torch.where(at2, o, big).amin(dim=1, keepdim=True)
        sel = at2 & (o == omin)
        keep = (m > 0)[:, 0]
        out_s[:, j] = torch.where(keep, m[:, 0], zero)
        out_p[:, j] = torch.where(keep, pmin[:, 0], 0)
        out_o[:, j] = torch.where(keep, omin[:, 0], 0)
        s = torch.where(sel, zero, s)
    return out_s, out_p, out_o


def merge_topk(scores, ords, *, k: int):
    """Deterministic merge of per-partition top-k candidate lanes.

    scores [Q, S*k] f32 — lane = partition * k + slot; non-positive lanes
        are empty and never selected
    ords   [Q, S*k] i32 — per-partition doc ordinals aligned with scores

    Returns (scores [Q, k] f32, parts [Q, k] i32, ords [Q, k] i32) in
    (score desc, partition asc, ord asc) order; empty slots are (0, 0, 0).
    """
    dev = scores.device
    _check(scores, "scores", torch.float32, 2, dev)
    _check(ords, "ords", torch.int32, 2, dev)
    if ords.shape != scores.shape:
        raise ValueError(f"ords {tuple(ords.shape)} and scores "
                         f"{tuple(scores.shape)} differ")
    Q, L = int(scores.shape[0]), int(scores.shape[1])
    if k < 1 or L % k:
        raise ValueError(f"{L} lanes are not whole partitions of k={k}")
    if not _route(dev):
        return merge_topk_plain(scores, ords, k=k)
    if L * 8 > _MERGE_SMEM_MAX:
        raise ValueError(f"{L} lanes exceed the merge kernel's shared memory")
    out_s = _out((Q, k), torch.float32, dev)
    out_p = _out((Q, k), torch.int32, dev)
    out_o = _out((Q, k), torch.int32, dev)
    if Q == 0:
        return out_s, out_p, out_o
    _launch("merge_topk", dev, scores.data_ptr(), ords.data_ptr(),
            out_s.data_ptr(), out_p.data_ptr(), out_o.data_ptr(), Q, L, k)
    return out_s, out_p, out_o


_MERGE_SMEM_MAX = 227 * 1024   # a block's shared memory: L scores + L ords


# --------------------------------------------------------------------------
# K9 quantized kNN first pass
# --------------------------------------------------------------------------

_KNN_WIN_CHUNK = 32   # windows per step of the plain version
# K9 keeps a chunk of windows' f32 scores in a scratch tensor between its
# score pass and its selection pass. Chunks that fit the H100's 50 MB L2
# lost on the card to larger ones: the selection is bound by its own
# instructions, not by reading the scores back, and each chunk pays two
# launch tails (measured by elasticsearch_tpu_torch/tools/k9_ab.py; PERF.md).
# The budget caps the scratch's device memory instead.
KNN_SCRATCH_BYTES = 512 << 20
_KNN_MAX_CHUNK = 65535 // (KNN_W // 128)   # the score pass's grid y limit


def knn_chunk_windows(nw: int, qc: int, n_parts: int = 1,
                      budget: int | None = None) -> int:
    """Windows per K9 chunk: as many as keep the chunk's [n_parts, cw, qc,
    KNN_W] f32 scratch within `budget` bytes (KNN_SCRATCH_BYTES by
    default), at least one and at most nw."""
    budget = KNN_SCRATCH_BYTES if budget is None else budget
    per_window = n_parts * qc * KNN_W * 4
    return max(1, min(nw, _KNN_MAX_CHUNK, budget // per_window))


def knn_chunks(nw: int, cw: int):
    """The [w0, w1) window ranges K9 takes cw at a time (the C entry's
    loop); the last may be short."""
    return [(w0, min(nw, w0 + cw)) for w0 in range(0, nw, cw)]


def _fma(a, b, c):
    """fmaf(a, b, c) of f32 tensors, correctly rounded: the product is exact
    in float64, the sum is rounded to odd there (TwoSum gives its error; an
    inexact even result moves one ulp toward it), and rounding to odd at 53
    bits then to nearest at 24 is the correct rounding of a*b + c."""
    p = a.double() * b.double()
    c = c.double() if isinstance(c, torch.Tensor) else c
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _knn_opt(dot, qmeta, scale, row_l1, nrm, similarity: str):
    """K9's epilogue in f32, in the order XLA on the CPU compiles the
    reference kernel (its optimized HLO, then LLVM contracting each multiply
    that feeds an add into a fused multiply-add; ROADMAP W11):

        slack    = fma(q5, row_l1, q1*scale); slack = fma(q2*0.0079, nrm, slack)
        e        = fma(dot, scale*sq, slack*1.05)
        cosine   = fma(e + 1e-6, q4, 1) * 0.5
        dot_prod = (e + (1 + 1e-6)) * 0.5
        l2_norm  = 1 / (1 + sqrt(max(fma(nrm, nrm, q3) - 2*(e + 1e-6), 0)))

    The CUDA kernel computes the same with __fmaf_rn / __fmul_rn /
    __fadd_rn. dot [QC, ..., W] holds exact integers as f32; the meta rows
    broadcast against it."""
    sq, q1, q2, q3, q4, q5 = (qmeta[:, i].view(-1, 1, 1) for i in range(6))
    slack = _fma(q5, row_l1, q1 * scale)
    slack = _fma(q2 * _KNN_C0079, nrm, slack)
    e = _fma(dot, scale * sq, slack * _KNN_C105)
    if similarity == "cosine":
        return _fma(e + _KNN_C1EM6, q4, 1.0) * 0.5
    if similarity == "dot_product":
        return (e + _KNN_C1P1EM6) * 0.5
    d2 = torch.clamp(_fma(nrm, nrm, q3) - 2.0 * (e + _KNN_C1EM6), min=0.0)
    return 1.0 / (1.0 + sqrt_rn(d2))


def knn_int8_window_topc_plain(qi8, qmeta, q8, meta, act, fmask=None, *,
                               similarity: str = "cosine"):
    """Plain torch K9. The int8 products are summed in float64 (exact: every
    partial sum is an integer below 2^53), then rounded to f32 as the
    reference converts its int32 sums; the epilogue is `_knn_opt`, and a
    stable descending sort per (query, window) keeps the (opt desc, row asc)
    top KNN_CANDW. A few windows at a time bound the temporaries."""
    stacked = q8.dim() == 4
    if not stacked:
        q8, meta, act = q8[None], meta[None], act[None]
        fmask = None if fmask is None else fmask[None]
    dev = q8.device
    S, nw = int(q8.shape[0]), int(q8.shape[1])
    qc = int(qi8.shape[0])
    out_s = torch.empty((S, nw, qc, KNN_CANDW), dtype=torch.float32,
                        device=dev)
    out_r = torch.empty((S, nw, qc, KNN_CANDW), dtype=torch.int32,
                        device=dev)
    qd = qi8.double()
    ninf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    for p in range(S):
        for w0 in range(0, nw, _KNN_WIN_CHUNK):
            w1 = min(nw, w0 + _KNN_WIN_CHUNK)
            rows = q8[p, w0:w1].reshape(-1, q8.shape[-1]).double()
            dot = (qd @ rows.T).float().view(qc, w1 - w0, KNN_W)
            m = meta[p, :, w0:w1]                       # [4, nwc, W]
            opt = _knn_opt(dot, qmeta, m[0][None], m[1][None], m[2][None],
                           similarity)
            ok = (m[3][None] > 0) & (act[p, :, w0:w1, None] > 0)
            if fmask is not None:
                ok = ok & (fmask[p, :, w0:w1] > 0)
            opt = torch.where(ok, opt, ninf)
            top, idx = torch.sort(opt, dim=2, descending=True, stable=True)
            top = top[:, :, :KNN_CANDW]
            keep = top > float("-inf")
            wins = torch.arange(w0, w1, dtype=torch.int32, device=dev)
            r = idx[:, :, :KNN_CANDW].to(torch.int32) + (
                wins * KNN_W)[None, :, None]
            out_s[p, w0:w1] = top.permute(1, 0, 2)
            out_r[p, w0:w1] = torch.where(keep, r, 0).permute(1, 0, 2)
    if not stacked:
        return out_s[0], out_r[0]
    return out_s, out_r


def knn_int8_window_topc(qi8, qmeta, q8, meta, act, fmask=None, *,
                         similarity: str = "cosine"):
    """kNN first pass over int8-quantized partitions: per 2048-doc window,
    every doc's OPTIMISTIC score (the exact int8 dot, descaled, plus the
    tracked quantization slack, pushed through the similarity transform —
    all three are monotone in the dot) and the window's top KNN_CANDW by
    (score desc, row asc).

    qi8   [QC, dimsP] i8 — quantized queries, dims zero-padded (dimsP a
          multiple of 64)
    qmeta [QC, 8] f32 — 0 sq, 1 0.5*ql1 + dims*sq/4, 2 |q|, 3 |q|^2,
          4 1/max(|q|, 1e-20), 5 sq/2, rest zero
    q8    [nw, KNN_W, dimsP] i8 — stored rows DOC-major (the reference
          keeps [nw, dimsP, KNN_W]; each row's dims are contiguous here,
          the layout of an int8 tensor-core product)
    meta  [4, nw, KNN_W] f32 — (scale, row_l1, nrm, okf) per stored row
    act   [QC, nw] f32 — per-query window activity (IVF probe)
    fmask [QC, nw, KNN_W] i8 or None — per-query doc filter, stored order
    Stacked partitions add a leading S axis to q8, meta, act and fmask and
    to the outputs; qi8 and qmeta are shared.

    Returns (scores [nw, QC, KNN_CANDW] f32, rows [nw, QC, KNN_CANDW] i32):
    rows are stored-row ids w * KNN_W + lane; empty slots are (-inf, 0).
    On the card the kernel takes the windows knn_chunk_windows at a time,
    through one scratch tensor of a chunk's f32 scores.
    """
    if similarity not in KNN_SIMILARITIES:
        raise ValueError(f"unknown similarity [{similarity}]")
    dev = q8.device
    stacked = q8.dim() == 4
    lead = 1 if stacked else 0
    _check(q8, "q8", torch.int8, 3 + lead, dev)
    _check(qi8, "qi8", torch.int8, 2, dev)
    _check(qmeta, "qmeta", torch.float32, 2, dev)
    _check(meta, "meta", torch.float32, 3 + lead, dev)
    _check(act, "act", torch.float32, 2 + lead, dev)
    S = int(q8.shape[0]) if stacked else 1
    nw, W, dims_p = (int(x) for x in q8.shape[lead:])
    qc = int(qi8.shape[0])
    pre = (S,) if stacked else ()
    if W != KNN_W or dims_p % 64 or dims_p < 64 or nw < 1:
        raise ValueError(f"q8 shape {tuple(q8.shape)} is not "
                         f"[..., nw, {KNN_W}, dimsP % 64 == 0]")
    if qc < 1 or tuple(qi8.shape) != (qc, dims_p):
        raise ValueError(f"qi8 shape {tuple(qi8.shape)} is not "
                         f"[QC, {dims_p}]")
    if tuple(qmeta.shape) != (qc, 8):
        raise ValueError(f"qmeta shape {tuple(qmeta.shape)} is not [{qc}, 8]")
    if tuple(meta.shape) != pre + (4, nw, KNN_W):
        raise ValueError(f"meta shape {tuple(meta.shape)} is not "
                         f"{pre + (4, nw, KNN_W)}")
    if tuple(act.shape) != pre + (qc, nw):
        raise ValueError(f"act shape {tuple(act.shape)} is not "
                         f"{pre + (qc, nw)}")
    if fmask is not None:
        _check(fmask, "fmask", torch.int8, 3 + lead, dev)
        if tuple(fmask.shape) != pre + (qc, nw, KNN_W):
            raise ValueError(f"fmask shape {tuple(fmask.shape)} is not "
                             f"{pre + (qc, nw, KNN_W)}")
    if not _route(dev):
        return knn_int8_window_topc_plain(qi8, qmeta, q8, meta, act, fmask,
                                          similarity=similarity)
    out_s = _out(pre + (nw, qc, KNN_CANDW), torch.float32, dev)
    out_r = _out(pre + (nw, qc, KNN_CANDW), torch.int32, dev)
    cw = knn_chunk_windows(nw, qc, S)
    scratch = _out((S, cw, qc, KNN_W), torch.float32, dev)
    _launch("knn_int8_window_topc", dev, qi8.data_ptr(), qmeta.data_ptr(),
            q8.data_ptr(), meta.data_ptr(), act.data_ptr(),
            0 if fmask is None else fmask.data_ptr(), out_s.data_ptr(),
            out_r.data_ptr(), scratch.data_ptr(), qc, dims_p, nw, S,
            KNN_SIMILARITIES.index(similarity), cw)
    return out_s, out_r


# --------------------------------------------------------------------------
# K8 masked segment counts (the analytics tier, search/agg_device.py)
# --------------------------------------------------------------------------


def _agg_section_len(p: int) -> int:
    """i32 length of one [doc(p) | seg(p) | ct0 | ct1] blob section."""
    return 2 * p + 2 * (p // AGG_PAIR_GRAN)


def agg_counted_pairs(blob, ps, n_segments: int, n_docs: int):
    """Per blob section (pair counts `ps`, in blob order), the pairs that
    K8 counts, as int64 (doc, seg): a pair in chunk c counts iff
    0 <= seg < n_segments, the bucket's tile seg // AGG_SEG_TILE lies in
    [ct0[c], ct1[c]] and 0 <= doc < n_docs (a doc outside the mask never
    counts; layouts never hold one). Pad pairs (bucket -1) and pad chunks
    (ct0 > ct1) never count."""
    out, off = [], 0
    for p in ps:
        nc = p // AGG_PAIR_GRAN
        doc, seg = blob[off:off + p], blob[off + p:off + 2 * p].long()
        ct0 = blob[off + 2 * p:off + 2 * p + nc]
        ct1 = blob[off + 2 * p + nc:off + 2 * p + 2 * nc]
        off += _agg_section_len(p)
        c = torch.arange(p, device=blob.device) // AGG_PAIR_GRAN
        tile = torch.div(seg, AGG_SEG_TILE, rounding_mode="floor")
        ok = ((seg >= 0) & (seg < n_segments) & (tile >= ct0[c])
              & (tile <= ct1[c]) & (doc >= 0) & (doc < n_docs))
        out.append((doc[ok].long(), seg[ok]))
    return out


def _agg_counts_plain(mask, blob, ps, n_segments: int):
    """Plain torch K8 over each section: the gather of the mask at the
    counted pairs' docs (`agg_counted_pairs`), then one bincount per
    query."""
    q, n_docs = int(mask.shape[0]), int(mask.shape[1])
    outs = []
    for d, s in agg_counted_pairs(blob, ps, n_segments, n_docs):
        out = torch.zeros((q, n_segments), dtype=torch.int32,
                          device=mask.device)
        for i in range(q):
            out[i] = torch.bincount(s[mask[i][d]], minlength=n_segments)
        outs.append(out)
    return outs


def agg_segment_counts_plain(mask, blob, *, p: int, n_segments: int):
    """Plain torch `agg_segment_counts`."""
    return _agg_counts_plain(mask, blob, (p,), n_segments)[0]


def agg_two_level_counts_plain(mask, blob, *, pd: int, pm: int,
                               n_segments: int):
    """Plain torch `agg_two_level_counts`."""
    return tuple(_agg_counts_plain(mask, blob, (pd, pm), n_segments))


def _check_agg(mask, blob, ps, n_segments: int):
    """Checks shared by the two K8 wrappers; `ps` are the sections' pair
    counts. Docs are not range-checked here (that would read the blob back
    at every dispatch): agg_device checks them once when it builds a
    layout, and both routes skip a pair whose doc lies outside the mask."""
    dev = blob.device
    _check(mask, "mask", torch.bool, 2, dev)
    _check(blob, "blob", torch.int32, 1, dev)
    for p in ps:
        if p < AGG_PAIR_GRAN or p % AGG_PAIR_GRAN:
            raise ValueError(f"a section of {p} pairs is not a positive "
                             f"multiple of {AGG_PAIR_GRAN}")
    want = sum(_agg_section_len(p) for p in ps)
    if blob.shape[0] != want:
        raise ValueError(f"blob holds {int(blob.shape[0])} i32, the "
                         f"sections {list(ps)} need {want}")
    if mask.shape[0] < 1 or n_segments < 0:
        raise ValueError(f"mask shape {tuple(mask.shape)}, n_segments "
                         f"{n_segments}")


AGG_WORD_GROUP = 32   # queries per packed mask word group (agg_counts.cu)


def agg_word_bytes(q: int, n_docs: int) -> int:
    """Bytes of the packed-mask scratch K8 takes for q queries: at q = 1
    one bit per doc in 32-bit words; else one word per doc, 8 bits for
    q <= 8, 16 for q <= 16, else 32 bits in ceil(q / 32) groups, docs
    padded to a multiple of 4. agg_counts.cu's es_agg_word_bytes computes
    the same (the card tests hold them equal)."""
    if q <= 1:
        return -(-n_docs // 32) * 4
    width = 1 if q <= 8 else 2 if q <= 16 else 4
    groups = -(-q // AGG_WORD_GROUP) if width == 4 else 1
    return groups * (-(-n_docs // 4) * 4) * width


def _agg_launch(mask, blob, ps, n_segments: int):
    """One K8 C entry call over one or two blob sections: it zeroes the
    outputs and packs the mask into words, then counts both sections of
    the two-level form in one persistent grid per group of 32 queries.
    The outputs ([sections, Q, n_segments]) and the word scratch (after
    them, 16-byte aligned) are one allocation. Returns the outputs."""
    dev = blob.device
    q, n_docs = int(mask.shape[0]), int(mask.shape[1])
    shape = (len(ps), q, n_segments)
    if n_segments == 0 or n_docs == 0:    # no bucket or no doc can count
        return torch.zeros(shape, dtype=torch.int32, device=dev)
    n_out = len(ps) * q * n_segments
    at = -(-n_out // 4) * 4               # i32 offset of the words
    nbytes = agg_word_bytes(q, n_docs)    # a multiple of 4
    buf = _out((at + nbytes // 4,), torch.int32, dev)
    ptr = buf.data_ptr()
    _launch("agg_counts", dev, mask.data_ptr(), n_docs, q, ptr + 4 * at,
            nbytes, blob.data_ptr(), 0, ps[0], _agg_section_len(ps[0]),
            ps[1] if len(ps) > 1 else 0, len(ps), int(n_segments), ptr)
    return buf.as_strided(shape, (q * n_segments, n_segments, 1))


def agg_segment_counts(mask, blob, *, p: int, n_segments: int):
    """Batched bucket counting for one agg layout: Q queries' doc counts
    over the layout's static (doc, bucket) pairs, in one C entry call.

    mask [Q, n_docs] bool — one query mask per batched agg work
    blob [2p + 2(p / 1024)] i32 — the layout's device column, sections
        [doc(p) | bucket(p) | ct0 | ct1]: p a positive multiple of
        AGG_PAIR_GRAN; per 1024-pair chunk the inclusive bucket-tile range
        [ct0, ct1] (a pad chunk carries (1, 0)); pad pairs carry doc 0 /
        bucket -1

    Returns [Q, n_segments] i32: counts[q, s] = #{pairs (d, s) in range:
    mask[q, d]} (see `agg_counted_pairs` for which pairs count).
    """
    _check_agg(mask, blob, (p,), n_segments)
    if not _route(blob.device):
        return agg_segment_counts_plain(mask, blob, p=p,
                                        n_segments=n_segments)
    return _agg_launch(mask, blob, (p,), n_segments)[0]


def agg_two_level_counts(mask, blob, *, pd: int, pm: int, n_segments: int):
    """The two-level form for metric-under-bucket sub-aggs: the bucket doc
    counts over the (doc, bucket) pairs and the bucket value counts over
    the bucket x metric-value cross pairs, in one C entry call.

    blob sections: [doc(pd) | seg(pd) | dct0 | dct1 | mdoc(pm) | mseg(pm)
    | mct0 | mct1], all i32, pair sections multiples of AGG_PAIR_GRAN.

    Returns ([Q, n_segments] i32 doc counts, [Q, n_segments] i32 value
    counts).
    """
    _check_agg(mask, blob, (pd, pm), n_segments)
    if not _route(blob.device):
        return agg_two_level_counts_plain(mask, blob, pd=pd, pm=pm,
                                          n_segments=n_segments)
    dc, vc = _agg_launch(mask, blob, (pd, pm), n_segments).unbind(0)
    return dc, vc


# --------------------------------------------------------------------------
# block scatter (the dense executor's BM25 / presence scatter)
# --------------------------------------------------------------------------


def _f32(x: float) -> float:
    """A Python float rounded to f32, as JAX rounds a weak-typed constant
    that meets an f32 array (and exactly representable as a double)."""
    return float(np.float32(x))


def bm25_constants(k1: float, b: float):
    """(k1, b, 1 - b, k1 + 1) as the f32 values the reference's program
    multiplies by: each formed from the Python floats, then rounded."""
    return _f32(k1), _f32(b), _f32(1.0 - b), _f32(k1 + 1.0)


def _gather_live(block_ids, block_docs, block_tfs):
    """The selected rows' lanes with tf > 0: (flat lane index into the
    [B, 128] gather, their docs i64, their tfs)."""
    rows = block_ids.long()
    tfs = block_tfs[rows].reshape(-1)
    live = torch.nonzero(tfs > 0).reshape(-1)
    docs = block_docs[rows].reshape(-1)[live].long()
    return live, docs, tfs[live]


def bm25_block_scatter_plain(block_ids, idf, block_docs, block_tfs, doc_len,
                             *, avgdl: float, k1: float, b: float):
    """Plain torch `bm25_block_scatter`: the reference's arithmetic, with
    the fused multiply-add XLA on the CPU forms (`_fma`), stored at the
    live lanes' docs (each doc once, as one term's blocks hold it)."""
    k1f, bf, omb, k1p1 = bm25_constants(k1, b)
    live, docs, tf = _gather_live(block_ids, block_docs, block_tfs)
    dl = doc_len[docs]
    t = omb + (bf * dl) / torch.full_like(dl, _f32(avgdl))
    denom = _fma(torch.full_like(t, k1f), t, tf)
    w = idf[live // 128]
    out = torch.zeros(doc_len.shape[0], dtype=torch.float32,
                      device=doc_len.device)
    out[docs] = ((w * tf) * k1p1) / denom
    return out


def block_presence_plain(block_ids, block_docs, block_tfs, *, n_docs: int):
    """Plain torch `block_presence`."""
    _, docs, _ = _gather_live(block_ids, block_docs, block_tfs)
    out = torch.zeros(n_docs, dtype=torch.bool, device=block_docs.device)
    out[docs] = True
    return out


def _check_blocks(block_ids, block_docs, block_tfs):
    dev = block_docs.device
    _check(block_ids, "block_ids", torch.int32, 1, dev)
    _check(block_docs, "block_docs", torch.int32, 2, dev)
    _check(block_tfs, "block_tfs", torch.float32, 2, dev)
    if block_docs.shape[1] != 128 or block_tfs.shape != block_docs.shape:
        raise ValueError(f"block_docs {tuple(block_docs.shape)} and "
                         f"block_tfs {tuple(block_tfs.shape)} must be the "
                         f"same [T, 128]")
    return dev


def bm25_block_scatter(block_ids, idf, block_docs, block_tfs, doc_len, *,
                       avgdl: float, k1: float, b: float):
    """BM25 of the selected postings blocks into a dense [n_docs] f32.

    block_ids [B] i32 — rows of the field's block arrays, in [0, T)
    idf [B] f32 — per-row idf of the owning term (boost folded in)
    block_docs [T, 128] i32, block_tfs [T, 128] f32 — the field's blocks
    doc_len [n_docs] f32 — field lengths

    Score of a lane with tf > 0: idf * tf * (k1 + 1) / (tf + k1 * (1 - b
    + b * dl / avgdl)); other docs 0. The rows must hold each doc at most
    once among their tf > 0 lanes (one term's blocks): a doc is stored,
    not summed. Any order of rows; rows outside [0, T) write nothing.
    """
    dev = _check_blocks(block_ids, block_docs, block_tfs)
    _check(idf, "idf", torch.float32, 1, dev)
    _check(doc_len, "doc_len", torch.float32, 1, dev)
    if idf.shape != block_ids.shape:
        raise ValueError(f"idf {tuple(idf.shape)} must match block_ids "
                         f"{tuple(block_ids.shape)}")
    if not _route(dev):
        return bm25_block_scatter_plain(block_ids, idf, block_docs,
                                        block_tfs, doc_len, avgdl=avgdl,
                                        k1=k1, b=b)
    n_docs = int(doc_len.shape[0])
    out = _out((n_docs,), torch.float32, dev)
    _launch("bm25_block_scatter", dev, block_ids.data_ptr(), idf.data_ptr(),
            block_docs.data_ptr(), block_tfs.data_ptr(), doc_len.data_ptr(),
            int(block_ids.shape[0]), int(block_docs.shape[0]), n_docs,
            _f32(avgdl), *bm25_constants(k1, b), out.data_ptr())
    return out


def block_presence(block_ids, block_docs, block_tfs, *, n_docs: int):
    """[n_docs] bool: docs of a lane with tf > 0 in any selected row (the
    rows may belong to several terms, in any order)."""
    dev = _check_blocks(block_ids, block_docs, block_tfs)
    if not _route(dev):
        return block_presence_plain(block_ids, block_docs, block_tfs,
                                    n_docs=n_docs)
    out = _out((n_docs,), torch.bool, dev)
    _launch("block_presence", dev, block_ids.data_ptr(),
            block_docs.data_ptr(), block_tfs.data_ptr(),
            int(block_ids.shape[0]), int(block_docs.shape[0]), int(n_docs),
            out.data_ptr())
    return out


# --------------------------------------------------------------------------
# K10 lane top-k and K11 weighted block scatter (BlockMax, spmd)
# --------------------------------------------------------------------------

# lane_topk.cu's constants, which the card tests hold these mirrors to:
# THREADS (a block's threads, the big-k buffer's headroom), SMALL_K (k up
# to it keeps per-warp lists, no buffer) and BUF_MAX (the big-k buffer's
# bytes)
LANE_TOPK_THREADS = 512
LANE_TOPK_SMALL_K = 32
_LANE_TOPK_BUF_MAX = 128 * 1024
# K10's tiling, which lane_topk_plan alone decides and the kernel takes as
# arguments: C starts at 64 blocks of the longest run (a tile's fixed cost,
# its searches, copies and merge, is what 16 lost to 64 on the large
# buckets of the BlockMax phase), and the tiles' pairs of a launch stay
# within 64 MB
LANE_TOPK_TILE_BLOCKS = 64
_LANE_TOPK_SCRATCH_MAX = 64 << 20


def lane_topk_cap(k: int) -> int:
    """K10's big-k shared-memory buffer for a k (lane_topk.cu's
    es_lane_topk_cap): a power of two >= k + LANE_TOPK_THREADS."""
    cap = 512
    while cap < k + LANE_TOPK_THREADS:
        cap <<= 1
    return cap


def lane_topk_plan(S: int, Q: int, B: int, k: int) -> Tuple[int, int]:
    """K10's tiling for S x Q rows of a B-position bucket and a k, which
    the wrapper passes to the kernel: (C, tiles). A tile takes C blocks of
    its row's longest run (rows of more than 64 runs: C / 2 of the row's
    positions, cut evenly over the docs). C starts at
    LANE_TOPK_TILE_BLOCKS and doubles while a tile's lanes (C x 128) are
    under 4k, then while the tiles' [S, Q, tiles, k] pairs exceed
    _LANE_TOPK_SCRATCH_MAX bytes or the grid 2^31 - 1 blocks. tiles =
    ceil(B / C), at least 1, bounds every row's tiles; one tile writes the
    rows itself, more need the scratch and a merge launch."""
    c = LANE_TOPK_TILE_BLOCKS
    while c * 128 < 4 * k:
        c <<= 1
    while True:
        tiles = -(-B // c)
        if tiles <= 1 or (S * Q * tiles * k * 8 <= _LANE_TOPK_SCRATCH_MAX
                          and S * Q * tiles <= 0x7FFFFFFF):
            break
        c <<= 1
    return c, max(tiles, 1)


def lane_topk_plain(block_docs, block_scores, live, qblocks, qw, tstart, *,
                    k: int, addend=None, qf=None, hp=None, nm=None):
    """Plain torch K10: every row's real lanes stably sorted by doc (so a
    doc's lanes stay in run order), laid out as a zero-padded [docs, runs]
    matrix and summed column by column from the left, the addend added
    last; then each row ranked by (score desc, doc asc)."""
    dev = block_docs.device
    S, T, _ = block_docs.shape
    Q, _, B = qblocks.shape
    R = tstart.shape[2] - 1
    D = live.shape[1]
    out_s = torch.full((S, Q, k), float("-inf"), dtype=torch.float32,
                       device=dev)
    out_d = torch.zeros((S, Q, k), dtype=torch.int32, device=dev)
    nb = tstart[:, :, R].long()                                # [Q, S]
    pos = torch.arange(B, device=dev)
    used = pos[None, None, :] < nb[:, :, None]                 # [Q, S, B]
    q_i, s_i, p_i = torch.nonzero(used, as_tuple=True)
    if q_i.numel() == 0:
        return out_s, out_d
    blk = qblocks[q_i, s_i, p_i].long()
    docs = block_docs[s_i, blk]                                # [N, 128]
    sc = block_scores[s_i, blk]
    run = (tstart[q_i, s_i, 1:R + 1] <= p_i[:, None]).sum(dim=1)
    val = qw[q_i, s_i, p_i][:, None] * sc
    real = (sc > 0) & (docs >= 0) & (docs < D)
    lane_row = (q_i * S + s_i)[:, None].expand_as(docs)[real]
    d = docs[real].long()
    v = val[real]
    r = run[:, None].expand_as(docs)[real]
    key = lane_row * D + d
    order = torch.sort(key, stable=True).indices
    key, v, r = key[order], v[order], r[order]
    gkey, grp = torch.unique_consecutive(key, return_inverse=True)
    G = gkey.numel()
    mat = torch.zeros((G, R), dtype=torch.float32, device=dev)
    mat[grp, r] = v
    tot = mat[:, 0]
    for c in range(1, R):
        tot = tot + mat[:, c]
    row = gkey // D
    gd = gkey % D
    gq, gs = row // S, row % S
    lv = live[gs, gd]
    if qf is not None:
        fl = qf[q_i, s_i, p_i][:, None].expand_as(docs)[real][order]
        cmat = torch.zeros((G, R), dtype=torch.float32, device=dev)
        cmat[grp, r] = fl
        cnt = cmat[:, 0]
        for c in range(1, R):
            cnt = cnt + cmat[:, c]
        value = tot + addend[gs, gq, gd]
        cov = cnt + hp[gs, gq, gd]
        ok = lv & ((cov - nm[gq]).abs() < 0.5) & (value > 0)
    else:
        ok = (tot > 0) & lv
        value = tot if addend is None else tot + addend[gs, gq, gd]
    row, gd, value = row[ok], gd[ok], value[ok]
    # groups come by (row, doc): stable sorts by score desc, then by row,
    # give (row asc, score desc, doc asc)
    o = torch.sort(value, descending=True, stable=True).indices
    row, gd, value = row[o], gd[o], value[o]
    o = torch.sort(row, stable=True).indices
    row, gd, value = row[o], gd[o], value[o]
    first = torch.zeros(Q * S + 1, dtype=torch.int64, device=dev)
    first[1:] = torch.cumsum(torch.bincount(row, minlength=Q * S), 0)
    rank = torch.arange(row.numel(), device=dev) - first[row]
    keep = rank < k
    row, rank = row[keep], rank[keep]
    out_s[row % S, row // S, rank] = value[keep]
    out_d[row % S, row // S, rank] = gd[keep].to(torch.int32)
    return out_s, out_d


def lane_topk(block_docs, block_scores, live, qblocks, qw, tstart, *,
              k: int, addend=None, qf=None, hp=None, nm=None):
    """Exact top-k of each (partition, query) row over the lanes of its
    selected postings blocks.

    block_docs [S, T, 128] i32, block_scores [S, T, 128] f32 — a
        partition's blocks; a lane with score > 0 is a posting
    live [S, D] bool
    qblocks [Q, S, B] i32, qw [Q, S, B] f32 — each row's block rows and
        their weights
    tstart [Q, S, R + 1] i32 — the row's runs: positions [tstart[r],
        tstart[r + 1]) hold one term's blocks in doc order (a doc at most
        once a run); positions from tstart[R] on are not read
    addend [S, Q, D] f32 — added to a doc's lane total (hybrid and bool)
    qf [Q, S, B] f32, hp [S, Q, D] f32, nm [Q] f32 — bool mode: a doc
        qualifies when its runs' flags plus hp equal nm

    A doc's total sums w * score over the runs that hold it, in run order.
    Lane and hybrid mode keep docs with total > 0 (then adds the addend);
    bool mode keeps docs whose total plus addend is > 0 and whose
    coverage matches. Returns (scores [S, Q, k] f32, docs [S, Q, k] i32)
    ranked by (score desc, doc asc), padded with (-inf, 0).

    On the card: block_docs and block_scores 16-byte aligned, and k's
    big-k buffer within _LANE_TOPK_BUF_MAX (k <= 15,872); any number of
    runs. One launch, or two when lane_topk_plan gives a row more than one
    tile (their ranked pairs in a [S, Q, tiles, k] scratch, merged).
    """
    dev = block_docs.device
    _check(block_docs, "block_docs", torch.int32, 3, dev)
    _check(block_scores, "block_scores", torch.float32, 3, dev)
    _check(live, "live", torch.bool, 2, dev)
    _check(qblocks, "qblocks", torch.int32, 3, dev)
    _check(qw, "qw", torch.float32, 3, dev)
    _check(tstart, "tstart", torch.int32, 3, dev)
    S, T, lanes = block_docs.shape
    Q, S2, B = qblocks.shape
    R = int(tstart.shape[2]) - 1
    D = int(live.shape[1])
    if (lanes != 128 or block_scores.shape != block_docs.shape
            or S2 != S or live.shape[0] != S or qw.shape != qblocks.shape
            or tuple(tstart.shape[:2]) != (Q, S) or R < 1):
        raise ValueError(
            f"shapes do not agree: block_docs {tuple(block_docs.shape)}, "
            f"block_scores {tuple(block_scores.shape)}, live "
            f"{tuple(live.shape)}, qblocks {tuple(qblocks.shape)}, qw "
            f"{tuple(qw.shape)}, tstart {tuple(tstart.shape)}")
    if qf is not None:
        if addend is None or hp is None or nm is None:
            raise ValueError("bool mode needs addend, qf, hp and nm")
        _check(qf, "qf", torch.float32, 3, dev)
        _check(hp, "hp", torch.float32, 3, dev)
        _check(nm, "nm", torch.float32, 1, dev)
        if qf.shape != qblocks.shape or hp.shape != (S, Q, D) \
                or nm.shape != (Q,):
            raise ValueError(f"qf {tuple(qf.shape)}, hp {tuple(hp.shape)} "
                             f"or nm {tuple(nm.shape)} do not fit")
        mode = 2
    elif hp is not None or nm is not None:
        raise ValueError("hp and nm belong to bool mode (give qf)")
    else:
        mode = 1 if addend is not None else 0
    if addend is not None:
        _check(addend, "addend", torch.float32, 3, dev)
        if addend.shape != (S, Q, D):
            raise ValueError(f"addend {tuple(addend.shape)} is not "
                             f"{(S, Q, D)}")
    if k < 1:
        raise ValueError(f"k={k}")
    if not _route(dev):
        return lane_topk_plain(block_docs, block_scores, live, qblocks, qw,
                               tstart, k=k, addend=addend, qf=qf, hp=hp,
                               nm=nm)
    if k > LANE_TOPK_SMALL_K and lane_topk_cap(k) * 8 > _LANE_TOPK_BUF_MAX:
        raise ValueError(f"k={k} exceeds the lane top-k's shared memory")
    if block_docs.data_ptr() % 16 or block_scores.data_ptr() % 16:
        raise ValueError("block_docs and block_scores must be 16-byte "
                         "aligned (their block rows are bulk copies)")
    out_s = _out((S, Q, k), torch.float32, dev)
    out_d = _out((S, Q, k), torch.int32, dev)
    if Q == 0 or S == 0:
        return out_s, out_d
    C, tiles = lane_topk_plan(S, Q, B, k)
    if tiles > 1:          # each tile's ranked pairs, merged by a 2nd launch
        tile_s = _out((S, Q, tiles, k), torch.float32, dev)
        tile_d = _out((S, Q, tiles, k), torch.int32, dev)
    else:
        tile_s = tile_d = None
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    _launch("lane_topk", dev, block_docs.data_ptr(), block_scores.data_ptr(),
            live.data_ptr(), qblocks.data_ptr(), qw.data_ptr(),
            tstart.data_ptr(), ptr(addend), ptr(qf), ptr(hp), ptr(nm),
            out_s.data_ptr(), out_d.data_ptr(), ptr(tile_s), ptr(tile_d),
            S, Q, int(T), B, R, D, k, C, tiles, mode)
    return out_s, out_d


def weighted_run_offsets(runs, C: int):
    """K11's run offsets as a host int32 array, checked: None (one run,
    [0, C)) or n_runs + 1 ascending integers from 0 to C (a sequence, a
    numpy array or a CPU tensor; equal neighbours make an empty run)."""
    if runs is None:
        return np.array([0, C], np.int32)
    if isinstance(runs, torch.Tensor):
        if runs.device.type != "cpu":
            raise ValueError(f"runs must lie on the host, got {runs.device}")
        runs = runs.numpy()
    r = np.asarray(runs)
    if r.ndim != 1 or r.size < 2 or r.dtype.kind not in "iu":
        raise TypeError(f"runs must be 1-D integers, at least 2, got "
                        f"{r.dtype} {r.shape}")
    if r[0] != 0 or r[-1] != C or (r.size > 2 and (r[1:] < r[:-1]).any()):
        raise ValueError(f"runs must ascend from 0 to C = {C}, got "
                         f"{r[:4].tolist()} ... {r[-4:].tolist()}")
    return np.ascontiguousarray(r, dtype=np.int32)


def weighted_block_scatter_plain(acc, block_ids, weights, block_docs,
                                 block_scores, rows=None, runs=None):
    """Plain torch K11, in place: the runs one after another, in order,
    each run's lanes added at once (a run writes each target once, so the
    sum is the kernel's): acc = ((acc + w0 * s0) + w1 * s1) ... for a
    target that several runs hit, each product and sum rounded apart."""
    offs = weighted_run_offsets(runs, int(block_ids.shape[1]))
    for a, b in zip(offs[:-1].tolist(), offs[1:].tolist()):
        if b > a:
            _scatter_run(acc, block_ids[:, a:b], weights[:, a:b], block_docs,
                         block_scores, None if rows is None else rows[:, a:b])
    return acc


def _scatter_run(acc, block_ids, weights, block_docs, block_scores, rows):
    dev = acc.device
    S, R, D = acc.shape
    T = block_docs.shape[1]
    ids = block_ids.long()
    valid = (ids >= 0) & (ids < T)
    if rows is None:
        r = torch.zeros_like(ids)
    else:
        r = rows.long()
        valid &= (r >= 0) & (r < R)
    idc = ids.clamp(0, max(T - 1, 0))
    part = torch.arange(S, device=dev)[:, None]
    docs = block_docs[part, idc].long()                    # [S, c, 128]
    sc = block_scores[part, idc]
    keep = valid[:, :, None] & (sc > 0) & (docs >= 0) & (docs < D)
    v = (weights[:, :, None] * sc)[keep]
    flat = ((part[:, :, None] * R + r[:, :, None]) * D + docs)[keep]
    accf = acc.view(-1)
    accf[flat] = accf[flat] + v


def weighted_block_scatter(acc, block_ids, weights, block_docs,
                           block_scores, rows=None, runs=None):
    """acc[s, rows[s, c], doc] += weights[s, c] * score for each lane with
    score > 0 of block block_ids[s, c], in place; returns acc.

    acc [S, R, D] f32; block_ids, weights, rows [S, C] (i32, f32, i32;
    rows None: row 0); block_docs [S, T, 128] i32, block_scores
    [S, T, 128] f32; runs: n_runs + 1 ascending host offsets from 0 to C
    that cut every partition's positions into runs (None: one run; see
    weighted_run_offsets). Rows outside [0, T), destination rows outside
    [0, R) and docs outside [0, D) add nothing. No two such lanes of one
    run may hit the same (s, row, doc): give a run one term's blocks into
    one row (a term holds each doc once). Lanes of several runs may share
    one, and add to it in run order: the bits of a call per run, in order.
    """
    dev = acc.device
    _check(acc, "acc", torch.float32, 3, dev)
    _check(block_ids, "block_ids", torch.int32, 2, dev)
    _check(weights, "weights", torch.float32, 2, dev)
    _check(block_docs, "block_docs", torch.int32, 3, dev)
    _check(block_scores, "block_scores", torch.float32, 3, dev)
    S, R, D = acc.shape
    if (weights.shape != block_ids.shape or block_ids.shape[0] != S
            or block_docs.shape[0] != S or block_docs.shape[2] != 128
            or block_scores.shape != block_docs.shape):
        raise ValueError(
            f"shapes do not agree: acc {tuple(acc.shape)}, block_ids "
            f"{tuple(block_ids.shape)}, weights {tuple(weights.shape)}, "
            f"block_docs {tuple(block_docs.shape)}, block_scores "
            f"{tuple(block_scores.shape)}")
    if rows is not None:
        _check(rows, "rows", torch.int32, 2, dev)
        if rows.shape != block_ids.shape:
            raise ValueError(f"rows {tuple(rows.shape)} must match "
                             f"block_ids {tuple(block_ids.shape)}")
    C = int(block_ids.shape[1])
    offs = None if runs is None else weighted_run_offsets(runs, C)
    if not _route(dev):
        return weighted_block_scatter_plain(acc, block_ids, weights,
                                            block_docs, block_scores, rows,
                                            offs)
    if C == 0 or S == 0:
        return acc
    if S * C >= 1 << 30:
        raise ValueError(f"{S} x {C} block positions exceed the kernel's "
                         f"index range (2^30)")
    _launch("weighted_block_scatter", dev, block_ids.data_ptr(),
            weights.data_ptr(), 0 if rows is None else rows.data_ptr(),
            block_docs.data_ptr(), block_scores.data_ptr(), acc.data_ptr(),
            0 if offs is None else offs.ctypes.data,
            0 if offs is None else len(offs) - 1, S, C,
            int(block_docs.shape[1]), R, D)
    return acc
