"""Circuit breakers: bounded memory accounting for request-scoped allocations.

Re-designs the reference's parent/child breaker hierarchy
(ref: common/breaker/CircuitBreaker.java,
indices/breaker/HierarchyCircuitBreakerService.java): each child breaker
tracks bytes for one concern (request, fielddata, in_flight_requests) and a
parent enforces the sum. Here it guards *host* memory (segment
staging buffers, reduce buffers); HBM budgeting is handled separately by the
segment registry, which knows device array sizes exactly.

The port's copy of elasticsearch_tpu/common/breaker.py; its code differs only
in the imports.
"""

from __future__ import annotations

import threading

from elasticsearch_tpu_torch.common.errors import CircuitBreakingError


class CircuitBreaker:
    def __init__(self, name: str, limit_bytes: int, overhead: float = 1.0, parent: "CircuitBreaker | None" = None):
        self.name = name
        self.limit_bytes = limit_bytes
        self.overhead = overhead
        self.parent = parent
        self._used = 0        # guarded by: _lock
        self._trip_count = 0  # guarded by: _lock
        self._lock = threading.Lock()

    @property
    def used_bytes(self) -> int:
        return self._used

    @property
    def trip_count(self) -> int:
        return self._trip_count

    def add_estimate_bytes_and_maybe_break(self, bytes_: int, label: str = "<unknown>") -> None:
        with self._lock:
            new_used = self._used + bytes_
            if bytes_ > 0 and new_used * self.overhead > self.limit_bytes:
                self._trip_count += 1
                raise CircuitBreakingError(
                    f"[{self.name}] Data too large, data for [{label}] would be "
                    f"[{new_used}b], wanted [{bytes_}b] on top of [{self._used}b] "
                    f"already used, which is larger than the limit of "
                    f"[{self.limit_bytes}b]",
                    bytes_wanted=bytes_,
                    bytes_used=self._used,
                    bytes_limit=self.limit_bytes,
                    durability="TRANSIENT",
                )
            self._used = new_used
        if self.parent is not None:
            try:
                self.parent.add_estimate_bytes_and_maybe_break(bytes_, label)
            except CircuitBreakingError:
                with self._lock:
                    self._used -= bytes_
                raise

    def add_without_breaking(self, bytes_: int) -> None:
        with self._lock:
            self._used += bytes_
        if self.parent is not None:
            self.parent.add_without_breaking(bytes_)

    def release(self, bytes_: int) -> None:
        self.add_without_breaking(-bytes_)

    def stats(self) -> dict:
        return {
            "limit_size_in_bytes": self.limit_bytes,
            "estimated_size_in_bytes": self._used,
            "overhead": self.overhead,
            "tripped": self._trip_count,
        }


class HierarchyCircuitBreakerService:
    """Parent breaker + named children (ref: HierarchyCircuitBreakerService.java)."""

    def __init__(self, total_limit_bytes: int = 4 << 30):
        self.parent = CircuitBreaker("parent", total_limit_bytes)
        self._breakers: dict[str, CircuitBreaker] = {}
        for name, fraction, overhead in (
            ("request", 0.6, 1.0),
            ("fielddata", 0.4, 1.03),
            ("in_flight_requests", 1.0, 2.0),
        ):
            self._breakers[name] = CircuitBreaker(
                name, int(total_limit_bytes * fraction), overhead, parent=self.parent
            )

    def get_breaker(self, name: str) -> CircuitBreaker:
        return self._breakers[name]

    def stats(self) -> dict:
        out = {name: b.stats() for name, b in self._breakers.items()}
        out["parent"] = self.parent.stats()
        return out
