"""Device-memory residency ledger and compile-cache introspection (the
port's copy of elasticsearch_tpu/common/hbm_ledger.py, whole).

The column caches of the engines own almost all of the device memory this
stack touches. This module is the host-side set of books: every engine
registers its device-resident regions here (mirroring its ``hbm_bytes()``
arithmetic *exactly* — the cross-check test holds the two to equality),
eviction/zeroing churn is counted, and the ``turbo_eligible`` routing
decision leaves an explainable trail instead of a bare boolean.
``hbm_stats()`` carries ``budget_bytes`` (``ES_TPU_TURBO_HBM``) and
``headroom_bytes``, which the overload controller reads as its
device-memory signal.

A second set of books counts dispatch shapes. The reference timed its XLA
traces there; the port has no trace, so a *miss* is the first dispatch at
an unseen (engine kind, shape) — its wall time is the first launch at that
shape, kernel build included — later dispatches are *hits*, and
``extend_qc_sizes`` priming records *primed shapes*. Warmup coverage is
the fraction of dispatches that landed on a shape already seen.

Everything here is plain host bookkeeping guarded by one lock; nothing on
the device dispatch path blocks on device state.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common import metrics
from elasticsearch_tpu_torch.common.settings import knob

# gauges/counters live in the shared metric registry so the Prometheus
# exposition and sampler ring pick them up like every other metric; the
# dotted tails below must stay surfaced in hbm_stats()/compile_stats()
metrics.declare_gauge("tpu_hbm.occupancy_bytes",
                      "device bytes currently registered by live engines")
metrics.declare_gauge("tpu_hbm.high_watermark_bytes",
                      "peak registered device bytes since process start")
metrics.declare_gauge("tpu_hbm.budget_bytes",
                      "ES_TPU_TURBO_HBM column-cache budget")
metrics.declare_gauge("tpu_hbm.headroom_bytes",
                      "budget minus occupancy (negative = over budget)")
metrics.declare_gauge("tpu_hbm.protected_peak_ratio",
                      "peak fraction of cache slots pinned by an in-flight "
                      "batch's protect set")
metrics.declare_gauge("tpu_hbm.engines", "live engines registered with the ledger")
metrics.declare_counter("tpu_hbm.evictions", "column-cache slot evictions")
metrics.declare_counter("tpu_hbm.churn_bytes",
                        "bytes freed by evictions and cache resets")
metrics.declare_counter("tpu_hbm.zeroed_tiles",
                        "cache tiles queued for zeroing after eviction")
metrics.declare_gauge("tpu_compile.primed_shapes",
                      "(engine kind, QC) shapes primed via extend_qc_sizes")
metrics.declare_gauge("tpu_compile.warmup_coverage_ratio",
                      "fraction of dispatches that hit an already-traced shape")
metrics.declare_counter("tpu_compile.hits",
                        "dispatches at an already-traced (kind, QC) shape")
metrics.declare_counter("tpu_compile.misses",
                        "first dispatches at a new (kind, QC) shape (the "
                        "first launch at each)")
metrics.declare_counter("tpu_compile.retraces",
                        "misses whose shape was never primed — unplanned "
                        "serving-time traces")

_LOCK = threading.RLock()

_ENGINES: Dict[int, "_EngineEntry"] = {}  # guarded by: _LOCK
_SEQ = [0]                                # guarded by: _LOCK
_HIGH_WATERMARK = [0]                     # guarded by: _LOCK
_PROTECT_PEAK = [0.0]                     # guarded by: _LOCK
_EVICTIONS = [0]                          # guarded by: _LOCK
_CHURN_BYTES = [0]                        # guarded by: _LOCK
_ZEROED_TILES = [0]                       # guarded by: _LOCK

_PRIMED: set = set()                      # guarded by: _LOCK  (kind, shape)
_SEEN: set = set()                        # guarded by: _LOCK  (kind, shape)
_COMPILE_HITS = [0]                       # guarded by: _LOCK
_COMPILE_MISSES = [0]                     # guarded by: _LOCK
_COMPILE_RETRACES = [0]                   # guarded by: _LOCK
_COMPILE_EVENTS: List[dict] = []          # guarded by: _LOCK
_COMPILE_EVENT_CAP = 256

_ROUTING_LOG: List[dict] = []             # guarded by: _LOCK
_ROUTING_CAP = 64


class _EngineEntry:
    __slots__ = ("label", "kind", "devices", "regions", "protect_peak")

    def __init__(self, label: str, kind: str, devices: int) -> None:
        self.label = label
        self.kind = kind
        self.devices = max(1, int(devices))
        self.regions: Dict[str, int] = {}
        self.protect_peak = 0.0


def _occupancy_locked() -> int:
    return sum(sum(e.regions.values()) for e in _ENGINES.values())


def _publish_locked() -> None:  # tpulint: holds=_LOCK
    occ = _occupancy_locked()
    if occ > _HIGH_WATERMARK[0]:
        _HIGH_WATERMARK[0] = occ
    budget = int(knob("ES_TPU_TURBO_HBM"))
    metrics.gauge_set("tpu_hbm.occupancy_bytes", occ)
    metrics.gauge_set("tpu_hbm.high_watermark_bytes", _HIGH_WATERMARK[0])
    metrics.gauge_set("tpu_hbm.budget_bytes", budget)
    metrics.gauge_set("tpu_hbm.headroom_bytes", budget - occ)
    metrics.gauge_set("tpu_hbm.protected_peak_ratio", _PROTECT_PEAK[0])
    metrics.gauge_set("tpu_hbm.engines", len(_ENGINES))


def _drop_entry(key: int) -> None:
    with _LOCK:
        _ENGINES.pop(key, None)
        _publish_locked()


class LedgerHandle:
    """Per-engine view of the ledger. Engines call ``set_region`` with the
    exact ``.nbytes`` of each device buffer they hold, so the ledger's
    per-engine total stays byte-identical to the engine's ``hbm_bytes()``."""

    def __init__(self, key: int, label: str) -> None:
        self._key = key
        self.label = label

    def set_region(self, name: str, nbytes: int) -> None:
        with _LOCK:
            entry = _ENGINES.get(self._key)
            if entry is None:
                return
            entry.regions[name] = int(nbytes)
            _publish_locked()

    def drop_region(self, name: str) -> None:
        with _LOCK:
            entry = _ENGINES.get(self._key)
            if entry is not None and name in entry.regions:
                freed = entry.regions.pop(name)
                _CHURN_BYTES[0] += freed
                metrics.counter_add("tpu_hbm.churn_bytes", freed)
                _publish_locked()

    def note_eviction(self, count: int = 1, freed_bytes: int = 0) -> None:
        with _LOCK:
            _EVICTIONS[0] += count
            _CHURN_BYTES[0] += freed_bytes
        metrics.counter_add("tpu_hbm.evictions", count)
        if freed_bytes:
            metrics.counter_add("tpu_hbm.churn_bytes", freed_bytes)

    def note_zeroed_tiles(self, count: int) -> None:
        if count <= 0:
            return
        with _LOCK:
            _ZEROED_TILES[0] += count
        metrics.counter_add("tpu_hbm.zeroed_tiles", count)

    def note_protect_pressure(self, protected: int, capacity: int) -> None:
        if capacity <= 0:
            return
        ratio = min(1.0, protected / capacity)
        with _LOCK:
            entry = _ENGINES.get(self._key)
            if entry is not None and ratio > entry.protect_peak:
                entry.protect_peak = ratio
            if ratio > _PROTECT_PEAK[0]:
                _PROTECT_PEAK[0] = ratio
                _publish_locked()

    def total_bytes(self) -> int:
        with _LOCK:
            entry = _ENGINES.get(self._key)
            return sum(entry.regions.values()) if entry is not None else 0

    def close(self) -> None:
        _drop_entry(self._key)


def register_engine(obj: object, kind: str, devices: int = 1) -> LedgerHandle:
    """Register ``obj`` and return its handle. The entry is dropped when
    the engine is garbage-collected (or ``close()`` is called), so stale
    engines cannot pin phantom occupancy."""
    with _LOCK:
        _SEQ[0] += 1
        key = _SEQ[0]
        label = f"{kind}-{key}"
        _ENGINES[key] = _EngineEntry(label, kind, devices)
        _publish_locked()
    handle = LedgerHandle(key, label)
    try:
        weakref.finalize(obj, _drop_entry, key)
    except TypeError:  # __slots__ without __weakref__ — close() still works
        pass
    return handle


# --- compile-cache introspection ---------------------------------------------

def note_primed(kind: str, sizes) -> None:
    """Record bucket-ladder priming (extend_qc_sizes). Priming does not
    trace by itself — the trace still lands at the first dispatch — so
    primed shapes are tracked separately from seen shapes. A shape is a
    width, or a name where a kernel has one launch shape for any width
    (K3's ``batched``)."""
    with _LOCK:
        for s in sizes:
            _PRIMED.add((kind, s if isinstance(s, str) else int(s)))
        metrics.gauge_set("tpu_compile.primed_shapes", len(_PRIMED))


def _shape_order(key):
    """(kind, width) pairs in width order, named shapes after them."""
    kind, shape = key
    return kind, isinstance(shape, str), shape


def note_dispatch(kind: str, shape) -> bool:
    """Count one dispatch at ``(kind, shape)``. Returns True when this is
    the first dispatch at that shape (its first launch): the caller should
    time it and report the wall cost via ``note_compile_done``."""
    key = (kind, shape)
    with _LOCK:
        if key in _SEEN:
            first = retrace = False
            _COMPILE_HITS[0] += 1
        else:
            _SEEN.add(key)
            first = True
            retrace = key not in _PRIMED
            _COMPILE_MISSES[0] += 1
            if retrace:
                _COMPILE_RETRACES[0] += 1
        total = _COMPILE_HITS[0] + _COMPILE_MISSES[0]
        ratio = _COMPILE_HITS[0] / total if total else 0.0
        metrics.gauge_set("tpu_compile.warmup_coverage_ratio", ratio)
    if first:
        metrics.counter_add("tpu_compile.misses")
        if retrace:
            metrics.counter_add("tpu_compile.retraces")
    else:
        metrics.counter_add("tpu_compile.hits")
    return first


def hot_shapes() -> Dict[str, List[int]]:
    """The integer dispatch shapes this process has traced or primed, per
    engine kind — the payload a relocation source hands its target so the
    moved shard's bucket ladder covers the same widths (warm HBM handoff).
    Non-integer shape keys (e.g. blockmax tuple shapes) are skipped: only
    QC widths feed extend_qc_sizes."""
    out: Dict[str, set] = {}
    with _LOCK:
        for kind, shape in _SEEN | _PRIMED:
            if isinstance(shape, (int,)) and not isinstance(shape, bool):
                out.setdefault(kind, set()).add(int(shape))
    return {k: sorted(v) for k, v in sorted(out.items())}


def note_compile_done(kind: str, shape, wall_s: float) -> None:
    """Record the wall cost of a first dispatch at a shape (the compile
    event)."""
    with _LOCK:
        _COMPILE_EVENTS.append({
            "engine": kind,
            "shape": str(shape),
            "wall_ms": round(float(wall_s) * 1000.0, 3),
            "primed": (kind, shape) in _PRIMED,
        })
        del _COMPILE_EVENTS[: max(0, len(_COMPILE_EVENTS) - _COMPILE_EVENT_CAP)]


# --- routing explainability ---------------------------------------------------

def note_routing(index: str, eligible: bool, reason: str,
                 need_bytes: int, budget_bytes: int) -> None:
    with _LOCK:
        _ROUTING_LOG.append({
            "index": index,
            "eligible": bool(eligible),
            "reason": reason,
            "need_bytes": int(need_bytes),
            "budget_bytes": int(budget_bytes),
            "occupancy_bytes": _occupancy_locked(),
        })
        del _ROUTING_LOG[: max(0, len(_ROUTING_LOG) - _ROUTING_CAP)]


def last_routing() -> Optional[dict]:
    with _LOCK:
        return dict(_ROUTING_LOG[-1]) if _ROUTING_LOG else None


def last_routing_reason() -> Optional[str]:
    last = last_routing()
    return last["reason"] if last else None


# --- stats surfaces ------------------------------------------------------------

def hbm_stats() -> dict:
    """The ``tpu_hbm`` section of GET /_nodes/stats."""
    with _LOCK:
        occ = _occupancy_locked()
        budget = int(knob("ES_TPU_TURBO_HBM"))
        return {
            "occupancy_bytes": occ,
            "high_watermark_bytes": _HIGH_WATERMARK[0],
            "budget_bytes": budget,
            "headroom_bytes": budget - occ,
            "protected_peak_ratio": round(_PROTECT_PEAK[0], 4),
            "evictions": _EVICTIONS[0],
            "churn_bytes": _CHURN_BYTES[0],
            "zeroed_tiles": _ZEROED_TILES[0],
            "engines": {
                e.label: {
                    "kind": e.kind,
                    "devices": e.devices,
                    "occupancy_bytes": sum(e.regions.values()),
                    "per_device_bytes": sum(e.regions.values()) // e.devices,
                    "protected_peak_ratio": round(e.protect_peak, 4),
                    "regions": dict(e.regions),
                } for e in _ENGINES.values()
            },
            "routing": {
                "last": dict(_ROUTING_LOG[-1]) if _ROUTING_LOG else None,
                "log": [dict(r) for r in _ROUTING_LOG],
            },
        }


def compile_stats() -> dict:
    """The ``tpu_compile`` section of GET /_nodes/stats."""
    with _LOCK:
        hits = _COMPILE_HITS[0]
        misses = _COMPILE_MISSES[0]
        total = hits + misses
        return {
            "primed_shapes": [f"{k}:{s}" for k, s in
                              sorted(_PRIMED, key=_shape_order)],
            "seen_shapes": len(_SEEN),
            "hits": hits,
            "misses": misses,
            "retraces": _COMPILE_RETRACES[0],
            "warmup_coverage_ratio": round(hits / total, 4) if total else 0.0,
            "events": [dict(e) for e in _COMPILE_EVENTS],
        }


def reset_for_tests() -> None:
    with _LOCK:
        _ENGINES.clear()
        _HIGH_WATERMARK[0] = 0
        _PROTECT_PEAK[0] = 0.0
        _EVICTIONS[0] = 0
        _CHURN_BYTES[0] = 0
        _ZEROED_TILES[0] = 0
        _PRIMED.clear()
        _SEEN.clear()
        _COMPILE_HITS[0] = 0
        _COMPILE_MISSES[0] = 0
        _COMPILE_RETRACES[0] = 0
        _COMPILE_EVENTS.clear()
        _ROUTING_LOG.clear()
