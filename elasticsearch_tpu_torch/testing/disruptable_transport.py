"""Disruptable in-memory transport over the deterministic task queue.

Port of the testing idea in the reference's
test/disruption/DisruptableMockTransport.java: message delivery is a
scheduled task with configurable delay, and a rule table can blackhole or
delay traffic between node pairs to simulate partitions — two-sided,
bridge, or isolate-one.

Failure taxonomy: a dropped delivery surfaces through `on_error` as the
SAME `NodeUnavailableError` the transport layer raises for killed or
partitioned nodes (transport/channels.py) — so coordination code exercises
the identical recovery path here as under live fault injection. Legacy
zero-arg `on_error` callbacks keep working; callbacks that accept one
argument receive the error.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional, Set, Tuple

from elasticsearch_tpu_torch.testing.deterministic import DeterministicTaskQueue


def _invoke_on_error(on_error: Callable, sender: str, to: str) -> None:
    """Call `on_error`, passing a `NodeUnavailableError` when the callback
    accepts an argument (new taxonomy) and nothing when it doesn't (legacy
    zero-arg callbacks, e.g. cluster/coordination.py's lambdas)."""
    try:
        accepts_arg = bool(inspect.signature(on_error).parameters)
    except (TypeError, ValueError):
        accepts_arg = False
    if accepts_arg:
        from elasticsearch_tpu_torch.transport.channels import NodeUnavailableError

        on_error(NodeUnavailableError(
            f"no route from [{sender}] to [{to}] (disruption)"))
    else:
        on_error()


class DisruptableTransport:
    def __init__(self, queue: DeterministicTaskQueue,
                 base_delay_ms: float = 5.0, jitter_ms: float = 10.0):
        self.queue = queue
        self.base_delay_ms = base_delay_ms
        self.jitter_ms = jitter_ms
        self.handlers: Dict[str, Callable] = {}     # node -> handle_message
        self.blackholed: Set[Tuple[str, str]] = set()
        self.disconnected: Set[str] = set()

    def register(self, node_id: str, handler: Callable) -> None:
        """handler(sender, msg, reply_fn)"""
        self.handlers[node_id] = handler

    # ---- disruption rules ----

    def partition(self, side_a: Set[str], side_b: Set[str]) -> None:
        for a in side_a:
            for b in side_b:
                self.blackholed.add((a, b))
                self.blackholed.add((b, a))

    def isolate(self, node_id: str) -> None:
        for other in self.handlers:
            if other != node_id:
                self.blackholed.add((node_id, other))
                self.blackholed.add((other, node_id))

    def heal(self) -> None:
        self.blackholed.clear()
        self.disconnected.clear()

    def _delivery_ok(self, a: str, b: str) -> bool:
        return ((a, b) not in self.blackholed
                and a not in self.disconnected and b not in self.disconnected)

    # ---- the transport API coordinators use ----

    def send(self, sender: str, to: str, msg: dict,
             on_reply: Callable[[dict], None],
             on_error: Optional[Callable[[], None]] = None) -> None:
        delay = self.base_delay_ms + self.queue.random.random() * self.jitter_ms

        def deliver():
            if not self._delivery_ok(sender, to) or to not in self.handlers:
                # silent drop models a blackhole; on_error models a connection
                # error, scheduled so timeouts still apply realistically
                if on_error is not None:
                    self.queue.schedule_at(
                        delay, lambda: _invoke_on_error(on_error, sender, to))
                return

            def reply_fn(reply_msg: dict) -> None:
                rdelay = self.base_delay_ms + self.queue.random.random() * self.jitter_ms

                def deliver_reply():
                    if self._delivery_ok(to, sender):
                        on_reply(reply_msg)
                    elif on_error is not None:
                        _invoke_on_error(on_error, to, sender)

                self.queue.schedule_at(rdelay, deliver_reply)

            self.handlers[to](sender, msg, reply_fn)

        self.queue.schedule_at(delay, deliver)
