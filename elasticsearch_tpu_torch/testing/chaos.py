"""Crash–restart chaos harness for the write path.

Two pieces the durability ladder needs beyond testing/disruptable_transport:

* `CrashRestartCluster` — a `form_local_cluster` wrapper whose `crash(node)`
  models real node death (channels cut, applier detached, in-memory engines
  abandoned WITHOUT flushing — whatever was not fsynced is gone as far as
  any reopened file can see) and whose `restart(node)` brings the same name
  back over the same `data_path`: engines reload the last commit and replay
  the translog (`recover_from_disk`), then the copy rejoins via node-join +
  peer recovery, including the divergent-tail rollback for a copy that was
  ahead of the promoted primary when it died.

  CPython detail the model depends on: a garbage-collected file object
  flushes its buffer, which would RESURRECT bytes the crash should have
  destroyed. Crashed node objects are therefore stashed in `_wreckage` for
  the harness's lifetime; a separate `open()` of the same path observes
  only what was explicitly flushed/fsynced — the correct crash semantics.

* `AckedWriteHistory` — a per-document invoke/response history with the
  acked-write durability rule expressed as linearizability against a
  last-writer-wins register spec: a write whose ack was observed MUST be
  readable afterwards (losing it fails the check); a write that never
  acked may or may not survive (both are legal); reads record what they
  actually observed. Per-doc histories keep the Wing & Gong search tiny.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.cluster_node import (
    ClusterNode, _register_refresh_handler, form_local_cluster,
)
from elasticsearch_tpu_torch.parallel.routing import shard_for_id
from elasticsearch_tpu_torch.testing.linearizability import (
    Event, LinearizabilityChecker, SequentialSpec,
)


class CrashRestartCluster:
    """An in-process cluster whose nodes can die and come back from disk."""

    def __init__(self, names: List[str], data_path: str,
                 roles: Optional[Dict[str, Tuple[str, ...]]] = None,
                 device=None):
        self.names = list(names)
        self.data_path = data_path
        self.roles = roles or {}
        self.nodes, self.store, self.channels = form_local_cluster(
            names, data_path, roles, device=device)
        # a restarted node comes back on the cluster's device
        self.device = self.nodes[0].device
        self.by_name: Dict[str, ClusterNode] = {
            n.node_name: n for n in self.nodes}
        # crashed node objects, kept ALIVE: dropping them would let file
        # GC flush translog buffers the crash is supposed to destroy
        self._wreckage: List[ClusterNode] = []

    def node(self, name: str) -> ClusterNode:
        return self.by_name[name]

    def master(self) -> ClusterNode:
        return self.by_name[self.store.master_node()]

    def crash(self, name: str, report: bool = True) -> None:
        """Kill `name` without any shutdown courtesy: no flush, no fsync,
        no dying gasp to the master. With report=True a survivor notices
        (node-left -> promotion + reallocation); report=False models a
        restart faster than failure detection (the master never knew)."""
        node = self.by_name.pop(name)
        self.nodes = [n for n in self.nodes if n.node_name != name]
        self._wreckage.append(node)
        self.channels.kill(name)
        self.store.remove_applier(name)
        if report:
            survivor = self.master()
            survivor.report_node_left(name)

    def restart(self, name: str) -> ClusterNode:
        """Reopen `name` from its data_path and rejoin the cluster. The
        engines load the last segment commit and replay the translog above
        it; peer recovery then reconciles each copy with the current
        primary (rolling back a divergent tail where needed)."""
        path = f"{self.data_path}/{name}"
        roles = self.roles.get(name, ("master", "data"))
        node = ClusterNode(name, self.channels, self.store, data_path=path,
                           roles=roles, device=self.device)
        _register_refresh_handler(node)
        self.channels.register(name, node.transport)  # also un-kills
        node.shard_service.state = self.store.current()
        self.store.add_applier(name, node.apply_state)
        self.by_name[name] = node
        self.nodes.append(node)
        node.master_client(
            "internal:cluster/node/join",
            {"node": {"node_id": name, "name": name, "address": "",
                      "roles": list(roles)}})
        # the join is a no-op state-wise when the master never saw the
        # crash (report=False): reconcile explicitly so shards reopen
        node.apply_state(self.store.current())
        return node

    # ---- authoritative reads ----

    def primary_instance(self, index: str, doc_id: str):
        """The current primary's ShardInstance for the shard owning doc_id
        (None while the shard has no started primary)."""
        state = self.store.current()
        meta = state.indices[index]
        sid = shard_for_id(doc_id, meta.number_of_shards)
        primary = state.primary_of(index, sid)
        if primary is None or primary.node_id is None \
                or not primary.serving:
            return None
        holder = self.by_name.get(primary.node_id)
        if holder is None:
            return None
        return holder.shard_service.shards.get((index, sid))

    def read_doc(self, index: str, doc_id: str) -> Optional[dict]:
        """Realtime get through the current primary's engine — the
        authoritative answer for the durability check's final reads."""
        inst = self.primary_instance(index, doc_id)
        if inst is None:
            return None
        hit = inst.engine.get(doc_id)
        return None if hit is None else hit["_source"]


class AckedRegisterSpec(SequentialSpec):
    """Last-writer-wins register per document.

    Inputs are ("write", value) / ("delete", None) / ("read", None).
    A completed write/delete (ack observed) is always linearizable and sets
    the register; an incomplete one (out=None) is linearized optionally by
    the checker — covering both "took effect" and "lost before the WAL".
    A completed read's observed value — encoded ("observed", v), so a
    legitimate None document is distinguishable from the checker's marker
    for an incomplete op — must equal the register.
    """

    def initial_state(self) -> Any:
        return None

    def apply(self, state, inp, out):
        kind, arg = inp
        if kind == "read":
            if out is None:
                return True, state
            return (out[1] == state), state
        nstate = arg if kind == "write" else None
        return True, nstate


class AckedWriteHistory:
    """Concurrent per-doc histories + the acked-write durability check."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: Dict[str, List[Event]] = {}   # guarded by: _lock
        self._next_op = 0                           # guarded by: _lock

    def invoke(self, doc_id: str, kind: str, arg: Any = None) -> int:
        with self._lock:
            self._next_op += 1
            op_id = self._next_op
            self._events.setdefault(doc_id, []).append(
                Event("invoke", op_id, (kind, arg)))
            return op_id

    def respond(self, doc_id: str, op_id: int, out: Any = "ok") -> None:
        with self._lock:
            self._events[doc_id].append(Event("response", op_id, out))

    def record_read(self, doc_id: str, observed: Any) -> None:
        """A completed read observing `observed` (the document's current
        value, None when absent)."""
        op = self.invoke(doc_id, "read")
        self.respond(doc_id, op, ("observed", observed))

    def check(self) -> List[str]:
        """Run the linearizability check per document; return the doc ids
        whose history is NOT linearizable — i.e. where an acked write was
        lost or a read observed an impossible value. Empty list = pass."""
        checker = LinearizabilityChecker(AckedRegisterSpec())
        with self._lock:
            histories = {d: list(ev) for d, ev in self._events.items()}
        return [doc for doc, ev in sorted(histories.items())
                if not checker.is_linearizable(ev)]
