"""Device-memory residency ledger and dispatch-shape books (the port's copy
of the calls its engines make into elasticsearch_tpu/common/hbm_ledger.py,
without the metrics plumbing).

Engines register each device-resident region with its exact byte count,
so the ledger's per-engine total equals the engine's `hbm_bytes()`. The
dispatch books count the first dispatch at each (engine kind, shape), which
the reference used to time XLA traces; here it times the first launch.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional

_LOCK = threading.RLock()

_ENGINES: Dict[int, "_EngineEntry"] = {}  # guarded by: _LOCK
_SEQ = [0]                                # guarded by: _LOCK
_EVICTIONS = [0]                          # guarded by: _LOCK
_CHURN_BYTES = [0]                        # guarded by: _LOCK
_ZEROED_TILES = [0]                       # guarded by: _LOCK
_PROTECT_PEAK = [0.0]                     # guarded by: _LOCK
_SEEN: set = set()                        # guarded by: _LOCK
_PRIMED: set = set()                      # guarded by: _LOCK
_DISPATCH_EVENTS: List[dict] = []         # guarded by: _LOCK
_EVENT_CAP = 256
_ROUTING_LOG: List[dict] = []             # guarded by: _LOCK
_ROUTING_CAP = 64


class _EngineEntry:
    __slots__ = ("label", "kind", "regions", "protect_peak")

    def __init__(self, label: str, kind: str) -> None:
        self.label = label
        self.kind = kind
        self.regions: Dict[str, int] = {}
        self.protect_peak = 0.0


def _drop_entry(key: int) -> None:
    with _LOCK:
        _ENGINES.pop(key, None)


def _occupancy_locked() -> int:
    return sum(sum(e.regions.values()) for e in _ENGINES.values())


class LedgerHandle:
    """Per-engine view of the ledger."""

    def __init__(self, key: int, label: str) -> None:
        self._key = key
        self.label = label

    def set_region(self, name: str, nbytes: int) -> None:
        with _LOCK:
            entry = _ENGINES.get(self._key)
            if entry is not None:
                entry.regions[name] = int(nbytes)

    def drop_region(self, name: str) -> None:
        with _LOCK:
            entry = _ENGINES.get(self._key)
            if entry is not None and name in entry.regions:
                _CHURN_BYTES[0] += entry.regions.pop(name)

    def note_eviction(self, count: int = 1, freed_bytes: int = 0) -> None:
        with _LOCK:
            _EVICTIONS[0] += count
            _CHURN_BYTES[0] += freed_bytes

    def note_zeroed_tiles(self, count: int) -> None:
        if count > 0:
            with _LOCK:
                _ZEROED_TILES[0] += count

    def note_protect_pressure(self, protected: int, capacity: int) -> None:
        if capacity <= 0:
            return
        ratio = min(1.0, protected / capacity)
        with _LOCK:
            entry = _ENGINES.get(self._key)
            if entry is not None and ratio > entry.protect_peak:
                entry.protect_peak = ratio
            _PROTECT_PEAK[0] = max(_PROTECT_PEAK[0], ratio)

    def total_bytes(self) -> int:
        with _LOCK:
            entry = _ENGINES.get(self._key)
            return sum(entry.regions.values()) if entry is not None else 0

    def close(self) -> None:
        _drop_entry(self._key)


def register_engine(obj: object, kind: str) -> LedgerHandle:
    """Register `obj`; its entry is dropped when it is garbage-collected."""
    with _LOCK:
        _SEQ[0] += 1
        key = _SEQ[0]
        label = f"{kind}-{key}"
        _ENGINES[key] = _EngineEntry(label, kind)
    weakref.finalize(obj, _drop_entry, key)
    return LedgerHandle(key, label)


def note_primed(kind: str, sizes) -> None:
    """Record the dispatch widths an engine was primed for
    (extend_qc_sizes)."""
    with _LOCK:
        for s in sizes:
            _PRIMED.add((kind, int(s)))


def note_dispatch(kind: str, shape) -> bool:
    """Count one dispatch at (kind, shape); True for the first one."""
    with _LOCK:
        first = (kind, shape) not in _SEEN
        _SEEN.add((kind, shape))
    return first


def note_compile_done(kind: str, shape, wall_s: float) -> None:
    """Record the wall time of the first dispatch at a shape."""
    with _LOCK:
        _DISPATCH_EVENTS.append({"engine": kind, "shape": str(shape),
                                 "wall_ms": round(float(wall_s) * 1e3, 3)})
        del _DISPATCH_EVENTS[: max(0, len(_DISPATCH_EVENTS) - _EVENT_CAP)]


def note_routing(index: str, eligible: bool, reason: str,
                 need_bytes: int, budget_bytes: int) -> None:
    with _LOCK:
        _ROUTING_LOG.append({
            "index": index, "eligible": bool(eligible), "reason": reason,
            "need_bytes": int(need_bytes), "budget_bytes": int(budget_bytes),
            "occupancy_bytes": _occupancy_locked()})
        del _ROUTING_LOG[: max(0, len(_ROUTING_LOG) - _ROUTING_CAP)]


def last_routing() -> Optional[dict]:
    with _LOCK:
        return dict(_ROUTING_LOG[-1]) if _ROUTING_LOG else None


def hbm_stats() -> dict:
    """The ledger's books: registered device bytes per engine and region,
    cache churn, protect pressure, first-dispatch events and the routing
    trail."""
    with _LOCK:
        return {
            "occupancy_bytes": _occupancy_locked(),
            "evictions": _EVICTIONS[0],
            "churn_bytes": _CHURN_BYTES[0],
            "zeroed_tiles": _ZEROED_TILES[0],
            "protected_peak_ratio": round(_PROTECT_PEAK[0], 4),
            "engines": {e.label: {"kind": e.kind, "regions": dict(e.regions)}
                        for e in _ENGINES.values()},
            "first_dispatches": [dict(e) for e in _DISPATCH_EVENTS],
            "primed_shapes": len(_PRIMED),
            "routing": [dict(r) for r in _ROUTING_LOG],
        }
