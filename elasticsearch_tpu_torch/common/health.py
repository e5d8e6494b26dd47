"""Per-engine device-health tracking with a dispatch circuit breaker (the
port's copy of EngineHealth from elasticsearch_tpu/common/health.py,
without the node-wide registry that feeds GET /_nodes/stats).

`EngineHealth` is a small three-state machine (closed / open / half_open):

- closed: device dispatches flow normally. TRIP_N CONSECUTIVE device
  faults open the circuit.
- open: `allow_device()` is False — queries route to the host-exact
  fallback tier — until BACKOFF_MS elapses, at which point ONE
  half-open probe is admitted.
- half_open: the probe's outcome decides: success closes the circuit and
  resets the backoff; another fault re-opens it with exponential backoff
  (doubling, capped at 32× the base).

The reference reads both from knobs (ES_TPU_HEALTH_TRIP_N,
ES_TPU_HEALTH_BACKOFF_MS); the port fixes them at the reference's defaults.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

TRIP_N = 3            # consecutive device faults that open the circuit
BACKOFF_MS = 1000     # base backoff before a half-open probe

_COUNTERS = ("device_faults", "circuit_opens", "circuit_reopens", "probes",
             "probe_successes", "fallback_queries")


class EngineHealth:
    """Thread-safe dispatch circuit breaker for one engine."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.state = CLOSED
        self.consecutive_faults = 0
        self.backoff_ms = BACKOFF_MS
        self._retry_at = 0.0
        self._probing = False
        self.counters: Dict[str, int] = {k: 0 for k in _COUNTERS}  # guarded by: _lock
        self._transitions: collections.deque = collections.deque(maxlen=16)  # guarded by: _lock
        self.last_fault: Optional[str] = None

    # ---- state machine (callers hold _lock) ----

    def _move(self, state: str) -> None:
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
                self.counters["probes"] += 1
                return True
            if self._probing:
                return False
            self._probing = True
            self.counters["probes"] += 1
            return True

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_faults = 0
            if self.state == HALF_OPEN:
                self._move(CLOSED)
                self.backoff_ms = BACKOFF_MS
                self._probing = False
                self.counters["probe_successes"] += 1

    def record_fault(self, err: Optional[BaseException] = None) -> None:
        with self._lock:
            self.counters["device_faults"] += 1
            self.consecutive_faults += 1
            if err is not None:
                self.last_fault = f"{type(err).__name__}: {err}"
            if self.state == HALF_OPEN:
                self._probing = False
                self.backoff_ms = min(self.backoff_ms * 2,
                                      BACKOFF_MS * 32)
                self._open(reopen=True)
            elif (self.state == CLOSED
                  and self.consecutive_faults >= TRIP_N):
                self._open(reopen=False)

    def _open(self, reopen: bool) -> None:
        self._move(OPEN)
        self._retry_at = time.monotonic() + self.backoff_ms / 1000.0
        self.counters["circuit_reopens" if reopen else "circuit_opens"] += 1

    def record_fallback(self, n: int = 1) -> None:
        with self._lock:
            self.counters["fallback_queries"] += n

    # ---- reporting ----

    def stats(self) -> dict:
        with self._lock:
            out = {"state": self.state,
                   "consecutive_faults": self.consecutive_faults,
                   "backoff_ms": self.backoff_ms,
                   "trip_n": TRIP_N,
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
