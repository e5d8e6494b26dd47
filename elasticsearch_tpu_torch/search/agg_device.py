"""Device-native analytics tier: the fused batched aggregation engine (the
port of elasticsearch_tpu/search/agg_device.py).

Executes terms / histogram / date_histogram bucket counting — plus one
level of metric-under-bucket sub-aggregation — as fused segment-reduce
dispatches over device-resident precomputed columns:

  * **Precompute at layout-build time.** Per (segment, agg shape) an
    `_AggLayout` bakes the segment-static side of the reduction into ONE
    device-resident i32 column: (doc, bucket-id) pairs grouped by bucket
    for terms; (doc, uniq-value-rank) pairs for histogram and
    date_histogram (values truncated at a fixed granularity ladder —
    hour/minute/second for dates, raw for numerics — so any per-request
    interval/offset/calendar unit composes ON HOST by folding the uniq
    representatives through the host aggregator's own `_key_of`); plus
    the bucket × metric-value cross pairs for sub-aggs. Per query the
    engine pays one masked gather + segment count (the K8 kernel,
    parallel/kernels.py `agg_segment_counts` / `agg_two_level_counts`,
    CUDA in parallel/csrc/agg_counts.cu).

  * **Bit-identical to the host aggregators.** The device computes only
    exact integer counts. Float metrics are exact-refined on host: cross
    pairs are stable-sorted by bucket at build time, so a bucket's
    selected metric values come back in exactly the doc-major CSR order
    the host's `_numeric_all(bucket_mask)` produces, and numpy reduces the
    same f64 sequence — bitwise identical partials. `ES_TPU_AGG=0`
    restores the host path verbatim for A/B.

  * **Engine contract.** Layout columns are charged to the HBM ledger (one
    region per layout, reconciling exactly with `hbm_bytes()`), capped by
    ES_TPU_AGG_HBM_FRAC, and `agg_reduce` is a first-class fault site: a
    faulted dispatch poisons only its own layout group, and each poisoned
    collect falls back to the host aggregator (counted in
    `agg_host_fallbacks`).

Fallback matrix (host path serves whenever any gate fails): knob off,
leaf below AGG_DEVICE_MIN_DOCS, missing/script params, keyword-metric
value_count, non-numeric histogram field, > 2^24 pairs, > 2^16 uniq
bucket values, sub-aggs that are not plain metrics or span multiple
metric fields, HBM budget exceeded, device fault. The gates keep the
reference's values (MAX_PAIRS was the f32 accumulation's exactness
limit; K8 counts in int32) so that routing and the fallback counters
equal the reference's.

Differences from the reference:

  * **Device.** `AggDeviceEngine(device=None)` resolves through
    `device.resolve` (the card) and builds the CUDA kernels at
    construction there, so a kernel that fails to build raises outside
    the per-layout containment and never turns into host fallbacks.
    There is one engine per device (`default_engine(device)`), and a
    collect uses the engine of its leaf's device (`ctx.leaf.segment.
    torch_device`, which `InternalEngine` resolves), so a search on a CPU
    engine aggregates on a CPU agg engine and nothing picks the CPU on
    its own. Layouts upload a copy of their blob to that device, and pair
    docs are checked against the leaf once, when a layout is built.
  * **Containment.** `_run_works` contains `DeviceFaultError` (and so
    `HbmOomError`) only, as the port's other engines do; the reference
    contains every `Exception`. A refused launch (`KernelLaunchError`) or
    a wrapper's `TypeError` / `ValueError` propagates out of the collect
    and is never served around by the host aggregators.
  * **Batched as bulk-tier scheduler work**, as in the reference:
    `_dispatch` routes a collect's works through
    `serving_dispatch(engine, works, 1, tier=TIER_BULK)` on the leaf's
    engine, so concurrent collects that share a layout merge into one
    K8 launch with Q > 1 (rungs = the scheduler's bucket ladder, primed
    through `extend_qc_sizes`; `TurboEngine.extend_qc_sizes` primes the
    engine of its own device). The scheduler's lane thread launches the
    kernel inside the engine's device scope (`threadpool.coalescer`).

Each layout keeps its blob on the host (`layout.host`) and registers one
HBM scrub region under its ledger name, as the reference does; a repair
uploads the blob again (`_reupload`).
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from elasticsearch_tpu_torch import device as _device
from elasticsearch_tpu_torch.common import (
    faults, hbm_ledger, integrity, metrics,
)
from elasticsearch_tpu_torch.common.errors import DeviceFaultError
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.parallel import kernels

AGG_PAIR_GRAN = kernels.AGG_PAIR_GRAN   # pairs per kernel chunk
AGG_SEG_TILE = kernels.AGG_SEG_TILE     # bucket ids per kernel tile
MAX_PAIRS = 1 << 24       # the reference's f32-exactness gate, kept
MAX_UNIQ = 1 << 16        # uniq-rank bucket ceiling per layout
_DATE_GRANS = (3_600_000, 60_000, 1000)   # hour / minute / second, ms
_MAX_EXACT = float(1 << 53)               # f64 exact-integer ceiling

# metric sub-agg types the two-level route serves (partials reproduced by
# _metric_partial in exactly the host collect's shape)
DEVICE_METRICS = frozenset({
    "min", "max", "sum", "avg", "value_count", "stats", "extended_stats",
})


# --------------------------------------------------------------------------
# node counters (the tpu_agg section of GET /_nodes/stats)
# --------------------------------------------------------------------------

_COUNTS_LOCK = threading.Lock()
_COUNTS = {"agg_queries": 0, "agg_device_dispatches": 0,
           "agg_host_fallbacks": 0, "agg_bytes": 0}   # guarded by: _COUNTS_LOCK


def _count(key: str, n: int = 1) -> None:
    with _COUNTS_LOCK:
        _COUNTS[key] += n
    metrics.counter_add(key, n)


def agg_stats() -> dict:
    """The `tpu_agg` section of GET /_nodes/stats, summed over the engines
    built so far (it builds none)."""
    with _ENGINE_LOCK:
        engines = list(_ENGINES.values())
    with _COUNTS_LOCK:
        out = dict(_COUNTS)
    out["enabled"] = bool(knob("ES_TPU_AGG"))
    out["hbm_bytes"] = sum(e.hbm_bytes() for e in engines)
    out["layouts"] = sum(len(e.layout_serials()) for e in engines)
    return out


# --------------------------------------------------------------------------
# layouts: one device-resident i32 column per (segment, agg shape)
# --------------------------------------------------------------------------

_layout_serials = itertools.count(1)


def _pack_pairs(doc: np.ndarray, seg: np.ndarray, n_docs: int):
    """Pad (doc, bucket) pairs to the 1024-pair chunk granule and compute
    each chunk's inclusive bucket-tile range (the kernel's skip scalars).
    Pad pairs carry doc 0 / bucket -1, which the kernel's ok-gate drops.
    Every doc must lie in [0, n_docs): the kernel reads the query masks at
    them without a range check per dispatch."""
    p0 = len(doc)
    if p0 and (int(doc.min()) < 0 or int(doc.max()) >= n_docs):
        raise ValueError(f"agg layout pairs hold docs outside [0, {n_docs})")
    p = max(AGG_PAIR_GRAN, -(-p0 // AGG_PAIR_GRAN) * AGG_PAIR_GRAN)
    d = np.zeros(p, np.int32)
    s = np.full(p, -1, np.int32)
    d[:p0] = doc
    s[:p0] = seg
    nc = p // AGG_PAIR_GRAN
    ct0 = np.ones(nc, np.int32)
    ct1 = np.zeros(nc, np.int32)
    for c in range(nc):
        chunk = s[c * AGG_PAIR_GRAN:(c + 1) * AGG_PAIR_GRAN]
        live = chunk[chunk >= 0]
        if len(live):
            ct0[c] = int(live.min()) // AGG_SEG_TILE
            ct1[c] = int(live.max()) // AGG_SEG_TILE
    return d, s, ct0, ct1


class _AggLayout:
    """One agg shape's precomputed device column for one segment. Owns
    the ledger region and the scrub region; lifecycle is tied to the
    segment's device cache (`seg._device`), so dropping the segment drops
    the region through the weakref finalizer."""

    def __init__(self, kind: str, n_docs: int, sections: List[np.ndarray],
                 meta: dict, device: torch.device):
        self.kind = kind
        self.n_docs = n_docs
        self.serial = next(_layout_serials)
        self.meta = meta
        self.device = device
        self.host = np.ascontiguousarray(
            np.concatenate([a.astype(np.int32, copy=False).ravel()
                            for a in sections]))
        self.nbytes = int(self.host.nbytes)
        self.region_name = f"aggcol{self.serial}_{kind}"
        self._reupload()

    def _reupload(self) -> None:
        # a copy, never a view of the host blob (on the CPU too): the
        # scrubber holds the device column to it
        self.dev = torch.from_numpy(self.host).to(self.device, copy=True)


# --------------------------------------------------------------------------
# the engine: scheduler-facing dispatch adapter
# --------------------------------------------------------------------------


class _AggWork:
    """One agg collect's device work item: a layout + a query mask. The
    engine fills `result` (np count arrays) or `error` (device fault →
    this collect falls back to host). Mutable slots instead of return
    values because the scheduler contract returns fixed-shape score
    arrays, which bucket counts are not."""

    __slots__ = ("layout", "mask", "result", "error")

    def __init__(self, layout: _AggLayout, mask: np.ndarray):
        self.layout = layout
        self.mask = mask
        self.result = None
        self.error: Optional[BaseException] = None


class AggDeviceEngine:
    """Batched device aggregation engine. Speaks the coalescer/scheduler
    `search_many` contract (a list of work batches in, all-zero score
    triples out; results travel on the works)."""

    kind = "agg"

    def __init__(self, device=None):
        self.device = _device.resolve(device)
        if self.device.type == "cuda":
            from elasticsearch_tpu_torch.parallel.cuda_build import build_all

            build_all()          # a build failure surfaces here, not mid-query
        self.qc_sizes = (1, 4, 16, 64, 256)   # scheduler ladder rungs
        self._hbm = hbm_ledger.register_engine(self, kind="agg")
        self._lock = threading.Lock()
        self._bytes = 0                        # guarded by: _lock
        self._live: "weakref.WeakValueDictionary[int, _AggLayout]" = \
            weakref.WeakValueDictionary()
        hbm_ledger.note_primed("agg_reduce", self.qc_sizes)

    # ---- HBM accounting ----

    def hbm_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def ledger_bytes(self) -> int:
        return self._hbm.total_bytes()

    def layout_serials(self) -> Dict[str, int]:
        """Live layouts, region name -> serial (tests build fault specs
        and scrub targets from these)."""
        return {lay.region_name: s for s, lay in list(self._live.items())}

    def _budget(self) -> int:
        return int(float(knob("ES_TPU_AGG_HBM_FRAC"))
                   * float(knob("ES_TPU_TURBO_HBM")))

    def adopt_layout(self, layout: _AggLayout) -> bool:
        """Charge a freshly built layout to the ledger + register its
        scrub region (host-backed repair). False = over the
        ES_TPU_AGG_HBM_FRAC budget — the caller serves from host."""
        with self._lock:
            if self._bytes + layout.nbytes > self._budget():
                return False
            self._bytes += layout.nbytes
            self._live[layout.serial] = layout
        self._hbm.set_region(layout.region_name, layout.nbytes)
        integrity.register_scrub_region(
            layout, layout.region_name, lambda o: o.dev,
            expected=lambda o: o.host,
            repair=lambda o: o._reupload())
        weakref.finalize(layout, self._drop_layout, layout.region_name,
                         layout.nbytes)
        _count("agg_bytes", layout.nbytes)
        return True

    def _drop_layout(self, region_name: str, nbytes: int) -> None:
        with self._lock:
            self._bytes -= nbytes
        self._hbm.drop_region(region_name)

    # ---- scheduler engine contract ----

    def extend_qc_sizes(self, sizes) -> None:
        """Scheduler bucket-ladder hook: widen the padded query-batch
        rungs and mark them primed."""
        merged = sorted(set(self.qc_sizes) | {int(s) for s in sizes})
        self.qc_sizes = tuple(merged)
        hbm_ledger.note_primed("agg_reduce", self.qc_sizes)

    def search_many(self, batches, k: int = 1, check=None, fault_log=None):
        out = []
        for works in batches:
            works = list(works)
            self._run_works(works)
            q = max(1, len(works))
            kk = max(1, int(k))
            out.append((np.zeros((q, kk), np.float32),
                        np.zeros((q, kk), np.int32),
                        np.zeros((q, kk), np.int32)))
        return out

    def _run_works(self, works: List[_AggWork]) -> None:
        groups: Dict[int, List[_AggWork]] = {}
        for w in works:
            groups.setdefault(w.layout.serial, []).append(w)
        for group in groups.values():
            try:
                self._dispatch_group(group)
            except DeviceFaultError as e:  # containment: only this layout's
                for w in group:            # works fall back to the host
                    w.error = e

    def _dispatch_group(self, group: List[_AggWork]) -> None:
        layout = group[0].layout
        q = len(group)
        qpad = next((s for s in self.qc_sizes if s >= q), None)
        if qpad is None:
            qpad = -(-q // self.qc_sizes[-1]) * self.qc_sizes[-1]
        mask = np.zeros((qpad, layout.n_docs), bool)
        for i, w in enumerate(group):
            mask[i] = w.mask
        hbm_ledger.note_dispatch("agg_reduce", qpad)
        metrics.observe("agg_batch_size", q)
        _count("agg_device_dispatches")
        with faults.device_dispatch("agg_reduce", layout.serial):
            dmask = torch.from_numpy(mask).to(self.device)
            if layout.kind == "terms_metric":
                dc, vc = kernels.agg_two_level_counts(
                    dmask, layout.dev,
                    pd=layout.meta["pd"], pm=layout.meta["pm"],
                    n_segments=layout.meta["n_segments"])
                dc, vc = dc.cpu().numpy(), vc.cpu().numpy()
                for i, w in enumerate(group):
                    w.result = (dc[i], vc[i])
            else:
                counts = kernels.agg_segment_counts(
                    dmask, layout.dev, p=layout.meta["p"],
                    n_segments=layout.meta["n_segments"]).cpu().numpy()
                for i, w in enumerate(group):
                    w.result = counts[i]


_ENGINE_LOCK = threading.Lock()
_ENGINES: Dict[torch.device, AggDeviceEngine] = {}   # guarded by: _ENGINE_LOCK


def default_engine(device=None) -> AggDeviceEngine:
    """The engine of `device` (`device.resolve`: the card unless the CPU is
    named), built at its first use; one per device."""
    dev = _device.resolve(device)
    with _ENGINE_LOCK:
        eng = _ENGINES.get(dev)
        if eng is None:
            eng = _ENGINES[dev] = AggDeviceEngine(dev)
        return eng


def _dispatch(seg, works: List[_AggWork]) -> bool:
    """Route works through the serving dispatch facade as bulk-tier
    scheduler work, on the engine of `seg`'s device. True = every work
    carries a device result."""
    from elasticsearch_tpu_torch.threadpool.scheduler import (
        TIER_BULK,
        serving_dispatch,
    )

    serving_dispatch(default_engine(seg.torch_device), works, 1,
                     tier=TIER_BULK)
    ok = True
    for w in works:
        if w.error is not None or w.result is None:
            _count("agg_host_fallbacks")
            ok = False
    return ok


# --------------------------------------------------------------------------
# layout builders (cached on seg._device, refusals cached too)
# --------------------------------------------------------------------------

_BUILD_LOCK = threading.Lock()
_REFUSED = "host"          # cache sentinel: this shape stays on host


def _cached_layout(seg, key: str, build) -> Optional[_AggLayout]:
    with _BUILD_LOCK:
        cached = seg._device.get(key)
        if cached is _REFUSED:
            return None
        if cached is not None:
            return cached
        eng = default_engine(seg.torch_device)
        lay = build(eng.device)
        if lay is None or not eng.adopt_layout(lay):
            seg._device[key] = _REFUSED
            return None
        seg._device[key] = lay
        return lay


def _terms_sections(seg, kc):
    """Level-1 (doc, term-ord) pairs grouped by ord, packed for the
    kernel."""
    counts = kc.ord_start[1:] - kc.ord_start[:-1]
    doc_of_value = np.repeat(np.arange(seg.n_docs, dtype=np.int32), counts)
    order = np.argsort(kc.all_ords, kind="stable")
    return _pack_pairs(doc_of_value[order],
                       kc.all_ords[order].astype(np.int32), seg.n_docs)


def _terms_layout(seg, fname: str, kc) -> Optional[_AggLayout]:
    def build(device):
        if len(kc.all_ords) >= MAX_PAIRS:
            return None
        d, s, ct0, ct1 = _terms_sections(seg, kc)
        return _AggLayout("terms", seg.n_docs, [d, s, ct0, ct1],
                          {"p": len(d), "n_segments": len(kc.terms)}, device)

    return _cached_layout(seg, f"aggdev:terms:{fname}", build)


def _terms_metric_layout(seg, fname: str, kc, mfield: str,
                         mcol) -> Optional[_AggLayout]:
    """Two-level layout: level-1 term pairs + the term-ord × metric-value
    cross pairs, both stable-sorted by ord. Within an ord the cross pairs
    keep (doc asc, value CSR order) — exactly the order the host's
    `_numeric_all(bucket_mask)` flattens, so the host float refinement
    reduces identical sequences."""

    def build(device):
        n = seg.n_docs
        kcounts = (kc.ord_start[1:] - kc.ord_start[:-1]).astype(np.int64)
        mcounts = (mcol.value_start[1:]
                   - mcol.value_start[:-1]).astype(np.int64)
        per_doc = kcounts * mcounts
        pm0 = int(per_doc.sum())
        if pm0 >= MAX_PAIRS or len(kc.all_ords) >= MAX_PAIRS:
            return None
        starts = np.concatenate([[0], np.cumsum(per_doc)])
        mp_doc = np.repeat(np.arange(n, dtype=np.int64), per_doc)
        local = np.arange(pm0, dtype=np.int64) - starts[mp_doc]
        md = mcounts[mp_doc]
        oi = local // np.maximum(md, 1)
        vi = local - oi * md
        ords = kc.all_ords[kc.ord_start[mp_doc] + oi].astype(np.int32)
        val_idx = mcol.value_start[mp_doc] + vi
        order = np.argsort(ords, kind="stable")
        d1, s1, dct0, dct1 = _terms_sections(seg, kc)
        d2, s2, mct0, mct1 = _pack_pairs(
            mp_doc[order].astype(np.int32), ords[order], n)
        lay = _AggLayout(
            "terms_metric", n,
            [d1, s1, dct0, dct1, d2, s2, mct0, mct1],
            {"pd": len(d1), "pm": len(d2), "n_segments": len(kc.terms)},
            device)
        # host refinement data: the cross pairs' docs (selection) and f64
        # values (exact metric reduction), in the device blob's order
        lay.meta["mvals"] = mcol.all_values[val_idx][order]
        lay.meta["mdoc"] = mp_doc[order]
        return lay

    return _cached_layout(seg, f"aggdev:termsm:{fname}:{mfield}", build)


def _uniq_layout(seg, fname: str, col, gran) -> Optional[_AggLayout]:
    """(doc, uniq-value-rank) pairs at a fixed granularity: histogram and
    date_histogram count per RANK on device, and the host folds the
    ranks' representative values through the aggregator's own `_key_of`
    — any interval/offset/calendar unit, bit-identical by construction.
    `gran` is "raw" (ranks of the exact values) or an integer divisor of
    both interval and offset (date ladder), in which case truncation
    cannot move a value across a bucket boundary."""

    def build(device):
        vals = col.values
        exists = col.exists
        sel_docs = np.nonzero(exists)[0]
        v = vals[sel_docs]
        if np.isnan(v).any():
            return None
        g = gran
        if g != "raw" and (not np.all(v == np.floor(v))
                           or np.abs(v).max(initial=0.0) >= _MAX_EXACT):
            g = "raw"      # truncation only sound on exact-integer values
        tv = np.floor(v / g) * g if g != "raw" else v
        reps, uid = np.unique(tv, return_inverse=True)
        if len(reps) > MAX_UNIQ or len(sel_docs) >= MAX_PAIRS:
            return None
        d, s, ct0, ct1 = _pack_pairs(sel_docs.astype(np.int32),
                                     uid.astype(np.int32), seg.n_docs)
        lay = _AggLayout("uniq", seg.n_docs, [d, s, ct0, ct1],
                         {"p": len(d), "n_segments": len(reps)}, device)
        lay.meta["reps"] = reps
        uid_of_doc = np.full(seg.n_docs, -1, np.int64)
        uid_of_doc[sel_docs] = uid
        lay.meta["uid_of_doc"] = uid_of_doc
        return lay

    return _cached_layout(seg, f"aggdev:uniq:{fname}:{gran}", build)


def _metric_pair_docs(seg, mfield: str, mcol) -> np.ndarray:
    """Doc id per flattened metric value (CSR order) — cached host array
    for the histogram sub-agg refinement."""
    key = f"aggdev:mdoc:{mfield}"
    out = seg._device.get(key)
    if out is None:
        mcounts = mcol.value_start[1:] - mcol.value_start[:-1]
        out = np.repeat(np.arange(seg.n_docs, dtype=np.int64), mcounts)
        seg._device[key] = out
    return out


# --------------------------------------------------------------------------
# host-exact refinement helpers
# --------------------------------------------------------------------------


def _metric_partial(mtype: str, vals: np.ndarray):
    """Reproduce the host metric collect partial from a bucket's selected
    values — `vals` is f64 in the host's `_numeric_all` order, so every
    float reduction is the same numpy call on the same sequence."""
    n = len(vals)
    if mtype == "min":
        return {"min": float(vals.min()) if n else None}
    if mtype == "max":
        return {"max": float(vals.max()) if n else None}
    if mtype == "sum":
        return {"sum": float(vals.sum())}
    if mtype == "avg":
        return {"sum": float(vals.sum()), "count": int(n)}
    if mtype == "value_count":
        return {"count": int(n)}
    # stats / extended_stats share the StatsAgg partial
    if not n:
        return {"count": 0, "sum": 0.0, "min": None, "max": None,
                "sum2": 0.0}
    return {"count": int(n), "sum": float(vals.sum()),
            "min": float(vals.min()), "max": float(vals.max()),
            "sum2": float((vals.astype(np.float64) ** 2).sum())}


def _sub_supported(agg) -> Optional[str]:
    """Metric field name when EVERY sub-agg is a plain device-servable
    metric on one shared numeric field; None → host path."""
    mfield = None
    for s in agg.sub:
        if s.type_name not in DEVICE_METRICS or s.sub or s.sub_pipelines:
            return None
        if s.params.get("missing") is not None:
            return None
        f = s.params.get("field")
        if not isinstance(f, str):
            return None
        if mfield is None:
            mfield = f
        elif f != mfield:
            return None
    return mfield


# --------------------------------------------------------------------------
# collect entry points (aggregations.py device routes)
# --------------------------------------------------------------------------


def _enabled() -> bool:
    return bool(knob("ES_TPU_AGG"))


def collect_terms(agg, ctx, kc, mask: np.ndarray):
    """Device route for TermsAgg.collect; None → host path."""
    if not _enabled() or not len(kc.terms):
        return None
    seg = ctx.leaf.segment
    sel = mask & kc.exists
    if not agg.sub:
        lay = _terms_layout(seg, agg.params["field"], kc)
        if lay is None:
            _count("agg_host_fallbacks")
            return None
        work = _AggWork(lay, sel)
        if not _dispatch(seg, [work]):
            return None
        _count("agg_queries")
        counts = work.result
        nz = np.nonzero(counts)[0]
        return {kc.terms[o]: {"doc_count": int(counts[o]), "sub": {}}
                for o in nz}
    mfield = _sub_supported(agg)
    if mfield is None:
        return None
    mcol = seg.numeric.get(mfield)
    if mcol is None:
        return None
    lay = _terms_metric_layout(seg, agg.params["field"], kc, mfield, mcol)
    if lay is None:
        _count("agg_host_fallbacks")
        return None
    work = _AggWork(lay, sel)
    if not _dispatch(seg, [work]):
        return None
    _count("agg_queries")
    doc_counts, val_counts = work.result
    take = sel[lay.meta["mdoc"]]
    vals_sel = lay.meta["mvals"][take]
    bounds = np.concatenate([[0], np.cumsum(val_counts)])
    out: Dict[Any, dict] = {}
    for o in np.nonzero(doc_counts)[0]:
        v = vals_sel[bounds[o]:bounds[o + 1]]
        sub = {s.name: _metric_partial(s.type_name, v) for s in agg.sub}
        out[kc.terms[o]] = {"doc_count": int(doc_counts[o]), "sub": sub}
    return out


def _pick_gran(agg):
    """Largest date granularity dividing both interval and offset (so
    truncated values land in the same bucket as the raw ones); "raw" for
    numeric histograms and anything the ladder can't express."""
    if agg.type_name != "date_histogram":
        return "raw"
    if getattr(agg, "_calendar_unit", lambda: None)() is not None:
        # month/quarter/year truncate UTC datetimes and ignore offset;
        # their boundaries are hour-aligned, so hour ranks suffice
        return 3_600_000
    try:
        interval = float(agg._interval())
        offset = float(agg.params.get("offset", 0.0))
    except Exception:
        return "raw"
    for g in _DATE_GRANS:
        if interval % g == 0 and offset % g == 0:
            return g
    return "raw"


def collect_histogram(agg, ctx, col, mask: np.ndarray):
    """Device route for HistogramAgg / DateHistogramAgg collect; None →
    host path. Level-1 counting runs on device per uniq value rank; the
    host folds rank counts into request buckets with the aggregator's
    own `_key_of` over the rank representatives."""
    if not _enabled():
        return None
    seg = ctx.leaf.segment
    mfield = None
    mcol = None
    if agg.sub:
        mfield = _sub_supported(agg)
        if mfield is None:
            return None
        mcol = seg.numeric.get(mfield)
        if mcol is None:
            return None
    lay = _uniq_layout(seg, agg.params["field"], col, _pick_gran(agg))
    if lay is None:
        _count("agg_host_fallbacks")
        return None
    sel = mask & col.exists
    work = _AggWork(lay, sel)
    if not _dispatch(seg, [work]):
        return None
    _count("agg_queries")
    counts = work.result.astype(np.int64)
    reps = lay.meta["reps"]
    keys = np.round(agg._key_of(reps), 10)
    uk, uinv = np.unique(keys, return_inverse=True)
    dc = np.zeros(len(uk), np.int64)
    np.add.at(dc, uinv, counts)
    if not agg.sub:
        return {float(k): {"doc_count": int(c), "sub": {}}
                for k, c in zip(uk, dc) if c}
    # metric refinement: select cross values on host, stable-sort by the
    # request bucket rank (preserving doc-major CSR order within each
    # bucket — the host `_numeric_all` order), split at the boundaries
    mdoc = _metric_pair_docs(seg, mfield, mcol)
    take = sel[mdoc]
    vals_t = mcol.all_values[take]
    rid = uinv[lay.meta["uid_of_doc"][mdoc[take]]]
    order = np.argsort(rid, kind="stable")
    vals_o = vals_t[order]
    bounds = np.concatenate(
        [[0], np.cumsum(np.bincount(rid, minlength=len(uk)))])
    out: Dict[float, dict] = {}
    for ki in np.nonzero(dc)[0]:
        v = vals_o[bounds[ki]:bounds[ki + 1]]
        sub = {s.name: _metric_partial(s.type_name, v) for s in agg.sub}
        out[float(uk[ki])] = {"doc_count": int(dc[ki]), "sub": sub}
    return out
