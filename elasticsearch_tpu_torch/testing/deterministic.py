"""Deterministic task queue: virtual time + seeded interleaving.

The spine of the distributed-simulation test tier (ref:
test/framework/.../cluster/coordination/DeterministicTaskQueue.java — 499
LoC of virtual time that lets Raft-grade properties run in milliseconds).
Every scheduled action in a simulated cluster goes through one of these;
"now" only advances when no runnable task remains, and runnable tasks
execute in seeded-random order to explore interleavings.
"""

from __future__ import annotations

import heapq
import random
from typing import Callable, List, Optional, Tuple


class DeterministicTaskQueue:
    def __init__(self, seed: int = 0):
        self.random = random.Random(seed)
        self.now_ms: float = 0.0
        self._runnable: List[Tuple[int, Callable]] = []
        self._deferred: List[Tuple[float, int, Callable]] = []   # heap by time
        self._seq = 0

    # ---- scheduling API (what simulated nodes see) ----

    def schedule_now(self, fn: Callable) -> None:
        self._seq += 1
        self._runnable.append((self._seq, fn))

    def schedule_at(self, delay_ms: float, fn: Callable) -> "ScheduledHandle":
        self._seq += 1
        handle = ScheduledHandle(fn)
        heapq.heappush(self._deferred, (self.now_ms + delay_ms, self._seq, handle))
        return handle

    # ---- driving the simulation ----

    def has_runnable(self) -> bool:
        return bool(self._runnable)

    def has_deferred(self) -> bool:
        return bool(self._deferred)

    def run_one(self) -> bool:
        """Run one runnable task (seeded-random choice). False if none."""
        if not self._runnable:
            return False
        i = self.random.randrange(len(self._runnable))
        _, fn = self._runnable.pop(i)
        fn()
        return True

    def advance_time(self) -> bool:
        """Jump virtual time to the next deferred task; promote all tasks due."""
        if not self._deferred:
            return False
        self.now_ms = max(self.now_ms, self._deferred[0][0])
        while self._deferred and self._deferred[0][0] <= self.now_ms:
            _, seq, handle = heapq.heappop(self._deferred)
            if not handle.cancelled:
                self._runnable.append((seq, handle.fn))
        return True

    def run_all_runnable(self, limit: int = 100_000) -> None:
        n = 0
        while self.run_one():
            n += 1
            if n > limit:
                raise RuntimeError("runnable task storm: possible livelock")

    def run_until(self, deadline_ms: float, limit: int = 1_000_000) -> None:
        """Advance virtual time to `deadline_ms`, draining tasks on the way."""
        n = 0
        while True:
            if self._runnable:
                self.run_one()
            elif self._deferred and self._deferred[0][0] <= deadline_ms:
                self.advance_time()
            else:
                break
            n += 1
            if n > limit:
                raise RuntimeError("simulation did not quiesce")
        self.now_ms = max(self.now_ms, deadline_ms)

    def run_until_quiet(self, max_time_ms: float = 10 * 60 * 1000,
                        limit: int = 1_000_000) -> None:
        """Run until no runnable and no deferred tasks remain (or time cap)."""
        n = 0
        while (self._runnable or self._deferred) and self.now_ms <= max_time_ms:
            if not self.run_one():
                if not self.advance_time():
                    break
            n += 1
            if n > limit:
                raise RuntimeError("simulation did not quiesce")


class ScheduledHandle:
    __slots__ = ("fn", "cancelled")

    def __init__(self, fn: Callable):
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other):  # heap tie-break stability
        return id(self) < id(other)
