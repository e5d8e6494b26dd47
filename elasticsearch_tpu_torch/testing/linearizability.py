"""Linearizability checker (Wing & Gong with Lowe's memoization).

Port of the testing *idea* in the reference's
cluster/coordination/LinearizabilityChecker.java (527 LoC): given a
sequential specification and a concurrent history of invoke/response event
pairs, search for a linearization — a total order of the operations,
consistent with real-time order, that the sequential spec accepts.

Used by the coordination tests to prove the cluster-state register is
linearizable under partitions, message loss, and leader churn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple


@dataclass
class Event:
    kind: str        # "invoke" | "response"
    op_id: int
    value: Any       # input on invoke, output on response


class SequentialSpec:
    """Override: initial_state() and apply(state, input) -> (ok, output, next_state)."""

    def initial_state(self) -> Any:
        raise NotImplementedError

    def apply(self, state: Any, inp: Any, out: Any) -> Tuple[bool, Any]:
        """Return (accepted, next_state) for input/observed-output pair."""
        raise NotImplementedError

    def fingerprint(self, state: Any) -> Any:
        return state


class LinearizabilityChecker:
    def __init__(self, spec: SequentialSpec):
        self.spec = spec

    def is_linearizable(self, history: List[Event], max_steps: int = 2_000_000) -> bool:
        # pair up events
        invokes = {}
        responses = {}
        order = []
        for e in history:
            if e.kind == "invoke":
                invokes[e.op_id] = e
                order.append(e)
            else:
                responses[e.op_id] = e
                order.append(e)
        # ops with no response: may or may not have taken effect — model both
        # by treating them as completable at any later point (standard trick:
        # append synthetic responses at the end with unknown output = None)
        ops = {}
        for op_id, inv in invokes.items():
            resp = responses.get(op_id)
            ops[op_id] = (inv.value, resp.value if resp else None, resp is not None)

        # entries in real-time order: (op_id, invoke_index, response_index)
        idx_of = {}
        for i, e in enumerate(order):
            if e.kind == "invoke":
                idx_of[e.op_id] = [i, len(order)]
        for i, e in enumerate(order):
            if e.kind == "response":
                idx_of[e.op_id][1] = i

        pending = sorted(ops, key=lambda o: idx_of[o][0])
        completed_ops = frozenset(o for o in ops if ops[o][2])
        steps = [0]
        memo = set()

        def search(done: frozenset, state: Any) -> bool:
            steps[0] += 1
            if steps[0] > max_steps:
                raise RuntimeError("linearizability search exceeded budget")
            if completed_ops <= done:
                # incomplete ops are optional: not linearizing one models
                # "the op never took effect"
                return True
            key = (done, self.spec.fingerprint(state))
            if key in memo:
                return False
            # candidate ops: invoked before the earliest response of any
            # not-yet-linearized completed op (minimal-response rule)
            min_resp = min(idx_of[o][1] for o in completed_ops if o not in done)
            for op_id in pending:
                if op_id in done:
                    continue
                if idx_of[op_id][0] > min_resp:
                    break
                inp, out, completed = ops[op_id]
                accepted, nstate = self.spec.apply(state, inp, out if completed else None)
                if accepted and search(done | {op_id}, nstate):
                    return True
            memo.add(key)
            return False

        return search(frozenset(), self.spec.initial_state())


class CasRegisterSpec(SequentialSpec):
    """Compare-and-set register — the cluster-state model: an op is
    (op_kind, arg) with kinds write(v: (expected_version, value)) and read.

    write succeeds iff expected_version == current version; on success the
    register becomes (version+1, value). Reads return (version, value).
    """

    def initial_state(self):
        return (0, None)

    def apply(self, state, inp, out):
        version, value = state
        kind, arg = inp
        if kind == "read":
            if out is None:        # incomplete read: allowed, no state change
                return True, state
            return (out == state), state
        expected, new_value = arg
        ok = expected == version
        nstate = (version + 1, new_value) if ok else state
        if out is None:            # incomplete write: either effect is possible
            return True, nstate if ok else state
        return (out == ok), nstate
