"""Per-engine device-health tracking with a dispatch circuit breaker (the
port's copy of elasticsearch_tpu/common/health.py, whole).

`EngineHealth` is a small three-state machine (closed / open / half_open):

- closed: device dispatches flow normally. `trip_n` CONSECUTIVE device
  faults open the circuit.
- open: `allow_device()` is False — queries route to the host-exact /
  BlockMax fallback tier — until `backoff_ms` elapses, at which point ONE
  half-open probe is admitted.
- half_open: the probe's outcome decides: success closes the circuit and
  resets the backoff; another fault re-opens it with exponential backoff
  (doubling, capped at 32× the base).

Knobs: ``ES_TPU_HEALTH_TRIP_N`` (default 3 consecutive faults) and
``ES_TPU_HEALTH_BACKOFF_MS`` (default 1000 ms base backoff), read when an
engine builds its circuit.

Every engine registers itself here so `GET /_nodes/stats` can render a
node-wide ``tpu_health`` section (`node_health_stats`), including engines
that have since been garbage-collected (cumulative totals survive).
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Dict, Optional

from elasticsearch_tpu_torch.common.settings import knob

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

_COUNTERS = ("device_faults", "circuit_opens", "circuit_reopens", "probes",
             "probe_successes", "fallback_queries")

_REGISTRY: "weakref.WeakSet[EngineHealth]" = weakref.WeakSet()
_NODE_LOCK = threading.Lock()
_NODE_TOTALS: Dict[str, int] = {k: 0 for k in _COUNTERS}


class EngineHealth:
    """Thread-safe dispatch circuit breaker for one engine.

    Subclasses repoint `_REG`/`_TOTALS` to keep a separate population (the
    coordinator's per-node transport circuits must not pollute the
    device-health `tpu_health` section)."""

    _REG = _REGISTRY
    _TOTALS = _NODE_TOTALS  # guarded by: _NODE_LOCK

    def __init__(self, name: str, trip_n: Optional[int] = None,
                 backoff_ms: Optional[int] = None):
        self.name = name
        self.trip_n = (trip_n if trip_n is not None
                       else knob("ES_TPU_HEALTH_TRIP_N"))
        self.base_backoff_ms = (backoff_ms if backoff_ms is not None
                                else knob("ES_TPU_HEALTH_BACKOFF_MS"))
        self._lock = threading.Lock()
        self.state = CLOSED
        self.consecutive_faults = 0
        self.backoff_ms = self.base_backoff_ms
        self._retry_at = 0.0
        self._probing = False
        self.counters: Dict[str, int] = {k: 0 for k in _COUNTERS}  # guarded by: _lock
        self._transitions: collections.deque = collections.deque(maxlen=16)  # guarded by: _lock
        self.last_fault: Optional[str] = None
        self._REG.add(self)

    # ---- state machine ----

    def _move(self, state: str) -> None:  # tpulint: holds=_lock
        self._transitions.append(f"{self.state}->{state}")
        self.state = state

    def allow_device(self) -> bool:
        """True when this call may take the device path. Admits exactly one
        probe at a time while half-open."""
        with self._lock:
            if self.state == CLOSED:
                return True
            now = time.monotonic()
            if self.state == OPEN:
                if now < self._retry_at:
                    return False
                self._move(HALF_OPEN)
                self._probing = True
                self._bump("probes")
                return True
            # half_open: one probe in flight at a time
            if self._probing:
                return False
            self._probing = True
            self._bump("probes")
            return True

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_faults = 0
            if self.state == HALF_OPEN:
                self._move(CLOSED)
                self.backoff_ms = self.base_backoff_ms
                self._probing = False
                self._bump("probe_successes")

    def record_fault(self, err: Optional[BaseException] = None) -> None:
        with self._lock:
            self._bump("device_faults")
            self.consecutive_faults += 1
            if err is not None:
                self.last_fault = f"{type(err).__name__}: {err}"
            if self.state == HALF_OPEN:
                self._probing = False
                self.backoff_ms = min(self.backoff_ms * 2,
                                      self.base_backoff_ms * 32)
                self._open(reopen=True)
            elif (self.state == CLOSED
                  and self.consecutive_faults >= self.trip_n):
                self._open(reopen=False)

    def _open(self, reopen: bool) -> None:  # tpulint: holds=_lock
        self._move(OPEN)
        self._retry_at = time.monotonic() + self.backoff_ms / 1000.0
        self._bump("circuit_reopens" if reopen else "circuit_opens")

    def record_fallback(self, n: int = 1) -> None:
        with self._lock:
            self._bump("fallback_queries", n)

    def _bump(self, key: str, n: int = 1) -> None:  # tpulint: holds=_lock
        self.counters[key] += n
        with _NODE_LOCK:
            # node totals surface through node_health_stats(), not the
            # per-engine stats() payload
            self._TOTALS[key] += n  # tpulint: disable=TPU005

    # ---- reporting ----

    def stats(self) -> dict:
        with self._lock:
            out = {"state": self.state,
                   "consecutive_faults": self.consecutive_faults,
                   "backoff_ms": self.backoff_ms,
                   "trip_n": self.trip_n,
                   "transitions": list(self._transitions)}
            if self.last_fault:
                out["last_fault"] = self.last_fault
            out.update(self.counters)
        return out

    def flat_stats(self) -> Dict[str, int]:
        """Numeric-only keys for TurboEngine.stats."""
        with self._lock:
            out = {f"health_{k}": v for k, v in self.counters.items()}
            out["health_circuit_open"] = int(self.state != CLOSED)
        return out


def node_health_stats() -> dict:
    """Node-wide ``tpu_health`` section for GET /_nodes/stats."""
    engines = sorted(_REGISTRY, key=lambda h: h.name)
    with _NODE_LOCK:
        totals = dict(_NODE_TOTALS)
    return {
        "engines": [dict(e.stats(), name=e.name) for e in engines],
        "open_circuits": sum(1 for e in engines if e.state != CLOSED),
        **totals,
    }


# ---- coordinator-side transport circuits ----
#
# The SAME three-state machine guards the distributed rung of the fault
# ladder: consecutive transport failures to a target node open a circuit
# that replica routing skips (quarantine), then a half-open probe decides
# whether the node ages back in — instead of ARS slowly decaying a dead
# node's EWMA until it gets retried.

_TRANSPORT_REGISTRY: "weakref.WeakSet[EngineHealth]" = weakref.WeakSet()
_TRANSPORT_TOTALS: Dict[str, int] = {k: 0 for k in _COUNTERS}


class NodeTransportHealth(EngineHealth):
    """Circuit for one coordinator->node transport edge. `device_faults`
    counts TRANSPORT failures here (the machine is shared; the registry is
    not, so `tpu_health` never mixes the two populations)."""

    _REG = _TRANSPORT_REGISTRY
    _TOTALS = _TRANSPORT_TOTALS

    # transport-flavored aliases over the shared state machine
    allow_request = EngineHealth.allow_device


def node_transport_health_stats() -> dict:
    """Coordinator transport-circuit summary for the ``tpu_coordinator``
    section of GET /_nodes/stats."""
    circuits = sorted(_TRANSPORT_REGISTRY, key=lambda h: h.name)
    with _NODE_LOCK:
        totals = dict(_TRANSPORT_TOTALS)
    return {
        "nodes": [dict(c.stats(), name=c.name) for c in circuits],
        "open_circuits": sum(1 for c in circuits if c.state != CLOSED),
        "transport_failures": totals["device_faults"],
        "circuit_opens": totals["circuit_opens"],
        "circuit_reopens": totals["circuit_reopens"],
        "probes": totals["probes"],
        "probe_successes": totals["probe_successes"],
    }
