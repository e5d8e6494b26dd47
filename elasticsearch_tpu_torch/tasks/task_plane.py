"""Cluster-wide task plane: fan-out listing, node-routed get/cancel with
ban propagation, orphan reaping, and hot-threads fan-out.

The node-local registry (task_manager.py) knows only its own tasks; this
layer makes `GET /_tasks` a CLUSTER view (ref: TransportListTasksAction's
nodes fan-out), routes `{node}:{id}` operations to the owning node instead
of aliasing every id onto the receiving node, and carries the
TaskCancellationService ban protocol across the wire: cancelling a
coordinator fans `internal:cluster/tasks/ban` to every peer so shard
children — including ones whose registration RPC is still in flight —
die at their next dispatch boundary.

Degradation contract matches the transport tier's: a dead/partitioned
peer never fails the whole listing; it becomes a `node_failures` entry
and the answer stays partial-but-useful.

The port's copy of elasticsearch_tpu/tasks/task_plane.py. A standalone
node builds it without channels or cluster state, and it answers from
the local registry in the same response shapes.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuError, IllegalArgumentError,
)
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.tasks.task_manager import TaskManager
from elasticsearch_tpu_torch.transport.channels import (
    NodeUnavailableError, RpcTimeoutError,
)

# transport actions (cluster:monitor/admin namespaces per the reference's
# action registry; internal: for the node-to-node ban/reap protocol)
ACTION_TASKS_LIST = "cluster:monitor/tasks/list"
ACTION_TASKS_GET = "cluster:monitor/tasks/get"
ACTION_TASKS_CANCEL = "cluster:admin/tasks/cancel"
ACTION_TASKS_DRAIN = "cluster:monitor/tasks/drain"
ACTION_TASKS_BAN = "internal:cluster/tasks/ban"
ACTION_TASKS_REAP = "internal:cluster/tasks/reap"
ACTION_HOT_THREADS = "cluster:monitor/nodes/hot_threads"

_FANOUT_ERRORS = (NodeUnavailableError, RpcTimeoutError)


def _not_running(tid: str) -> ElasticsearchTpuError:
    e = ElasticsearchTpuError(f"task [{tid}] isn't running")
    e.status = 404
    e.error_type = "resource_not_found_exception"
    return e


def _parse_task_id(tid: str) -> int:
    """Numeric parse FIRST: `zzz:notanum` must 400 before any node
    routing gets a chance to 404."""
    try:
        return int(tid.split(":")[-1])
    except ValueError:
        raise IllegalArgumentError(f"malformed task id [{tid}]")


class TaskPlane:
    """One node's view of cluster task management.

    ``channels``/``state_fn`` are None on a standalone Node — every
    operation then degrades to the local registry, same response shapes.
    """

    def __init__(self, tasks: TaskManager, node_name: str,
                 channels=None,
                 state_fn: Optional[Callable[[], object]] = None,
                 transport=None,
                 hot_label: Optional[str] = None):
        self.tasks = tasks
        self.node_name = node_name
        self.channels = channels
        self.state_fn = state_fn
        # "{name}{id}" header chunk for hot_threads sections
        self.hot_label = hot_label or f"{{{node_name}}}{{{tasks.node_id}}}"
        if transport is not None:
            transport.register_request_handler(ACTION_TASKS_LIST, self._on_list)
            transport.register_request_handler(ACTION_TASKS_GET, self._on_get)
            transport.register_request_handler(ACTION_TASKS_CANCEL,
                                               self._on_cancel)
            transport.register_request_handler(ACTION_TASKS_DRAIN,
                                               self._on_drain)
            transport.register_request_handler(ACTION_TASKS_BAN, self._on_ban)
            transport.register_request_handler(ACTION_TASKS_REAP, self._on_reap)
            transport.register_request_handler(ACTION_HOT_THREADS,
                                               self._on_hot_threads)

    # ---------------- topology ----------------

    def _peers(self) -> List[str]:
        if self.channels is None or self.state_fn is None:
            return []
        state = self.state_fn()
        out = []
        for nid, n in getattr(state, "nodes", {}).items():
            name = getattr(n, "name", None) or nid
            if name != self.node_name:
                out.append(name)
        return out

    def _known_node(self, name: str) -> bool:
        return name == self.node_name or name == self.tasks.node_id \
            or name in self._peers()

    # ---------------- list ----------------

    def _local_task_dicts(self, actions: Optional[str],
                          parent_task_id: Optional[str],
                          detailed: bool) -> Dict[str, dict]:
        out = {}
        for t in self.tasks.list(actions):
            if parent_task_id and t.parent_task_id != parent_task_id:
                continue
            out[t.task_id] = t.to_dict(detailed)
        return out

    def list(self, actions: Optional[str] = None,
             nodes: Optional[str] = None,
             parent_task_id: Optional[str] = None,
             detailed: bool = False,
             group_by: str = "nodes") -> dict:
        node_filter = set(nodes.split(",")) if nodes else None
        per_node: Dict[str, dict] = {}
        failures: List[dict] = []
        if node_filter is None or {self.node_name, self.tasks.node_id} & node_filter:
            per_node[self.tasks.node_id] = {"tasks": self._local_task_dicts(
                actions, parent_task_id, detailed)}
        payload = {"actions": actions, "parent_task_id": parent_task_id,
                   "detailed": detailed}
        for peer in self._peers():
            if node_filter is not None and peer not in node_filter:
                continue
            try:
                r = self.channels.request(peer, ACTION_TASKS_LIST, payload,
                                          source=self.node_name)
                per_node[peer] = {"tasks": r["tasks"]}
            except _FANOUT_ERRORS as e:
                failures.append({
                    "type": "failed_node_exception",
                    "reason": f"Failed node [{peer}]",
                    "node_id": peer,
                    "caused_by": {"type": e.error_type, "reason": str(e)},
                })
        out: dict = {}
        if group_by == "parents":
            out["tasks"] = self._group_by_parents(per_node)
        elif group_by == "none":
            out["tasks"] = [d for sec in per_node.values()
                            for d in sec["tasks"].values()]
        else:
            out["nodes"] = per_node
        if failures:
            out["node_failures"] = failures
        return out

    @staticmethod
    def _group_by_parents(per_node: Dict[str, dict]) -> Dict[str, dict]:
        """Flatten the node sections into a parent->children forest (ref:
        ListTasksResponse.getTaskGroups): a task whose parent is present
        in the result set nests under it; everything else is a root."""
        flat: Dict[str, dict] = {}
        for sec in per_node.values():
            flat.update(sec["tasks"])
        roots: Dict[str, dict] = {}
        by_id: Dict[str, dict] = {tid: dict(d) for tid, d in flat.items()}
        for tid, d in by_id.items():
            pid = d.get("parent_task_id")
            if pid and pid in by_id:
                by_id[pid].setdefault("children", []).append(d)
            else:
                roots[tid] = d
        return roots

    def _on_list(self, req) -> dict:
        p = req.payload
        return {"tasks": self._local_task_dicts(
            p.get("actions"), p.get("parent_task_id"),
            bool(p.get("detailed")))}

    # ---------------- get ----------------

    def _owner_of(self, tid: str) -> str:
        return tid.rsplit(":", 1)[0] if ":" in tid else ""

    def _is_local(self, owner: str) -> bool:
        return owner in ("", self.node_name, self.tasks.node_id)

    def get(self, tid: str) -> dict:
        num = _parse_task_id(tid)
        owner = self._owner_of(tid)
        if self._is_local(owner):
            t = self.tasks.get(num)
            if t is None:
                raise _not_running(tid)
            return {"completed": False, "task": t.to_dict(detailed=True)}
        if self.channels is None or not self._known_node(owner):
            raise _not_running(tid)
        try:
            return self.channels.request(owner, ACTION_TASKS_GET,
                                         {"id": num, "tid": tid},
                                         source=self.node_name)
        except _FANOUT_ERRORS:
            raise _not_running(tid)

    def _on_get(self, req) -> dict:
        t = self.tasks.get(req.payload["id"])
        if t is None:
            raise _not_running(req.payload.get("tid", str(req.payload["id"])))
        return {"completed": False, "task": t.to_dict(detailed=True)}

    # ---------------- cancel + ban propagation ----------------

    def cancel(self, tid: str, reason: str = "by user request",
               wait_for_completion: bool = False,
               timeout_ms: Optional[float] = None) -> dict:
        num = _parse_task_id(tid)
        owner = self._owner_of(tid)
        if not self._is_local(owner):
            if self.channels is None or not self._known_node(owner):
                raise _not_running(tid)
            try:
                return self.channels.request(
                    owner, ACTION_TASKS_CANCEL,
                    {"id": num, "tid": tid, "reason": reason,
                     "wait_for_completion": wait_for_completion,
                     "timeout_ms": timeout_ms},
                    source=self.node_name)
            except _FANOUT_ERRORS:
                raise _not_running(tid)
        t = self.tasks.cancel(num, reason)  # 400s on non-cancellable
        if t is None:
            raise _not_running(tid)
        self._propagate_ban(t.task_id, reason)
        if wait_for_completion:
            self.await_drain(t.task_id, timeout_ms)
        return {"nodes": {self.tasks.node_id: {
            "tasks": {t.task_id: t.to_dict(detailed=True)}}}}

    def _propagate_ban(self, parent_task_id: str, reason: str) -> None:
        """Ban locally (cancels registered children + arms
        cancel-on-arrival), then fan the ban to every peer. A peer we
        cannot reach holds no live children we could save anyway — its
        next contact with the cluster re-reaps via node-left."""
        self.tasks.ban(parent_task_id, reason)
        sent = 0
        for peer in self._peers():
            try:
                self.channels.request(
                    peer, ACTION_TASKS_BAN,
                    {"parent_task_id": parent_task_id, "reason": reason},
                    source=self.node_name)
                sent += 1
            except _FANOUT_ERRORS:
                pass
        if sent:
            self.tasks.note_bans_propagated(sent)

    def _on_cancel(self, req) -> dict:
        p = req.payload
        return self.cancel(p.get("tid", str(p["id"])),
                           reason=p.get("reason", "by user request"),
                           wait_for_completion=bool(
                               p.get("wait_for_completion")),
                           timeout_ms=p.get("timeout_ms"))

    def _on_ban(self, req) -> dict:
        p = req.payload
        cancelled = self.tasks.ban(p["parent_task_id"],
                                   p.get("reason", "parent task cancelled"))
        return {"cancelled": len(cancelled)}

    # ---------------- drain (wait_for_completion) ----------------

    def await_drain(self, parent_task_id: str,
                    timeout_ms: Optional[float] = None) -> bool:
        """Block until the task and its descendants are gone cluster-wide
        (bounded by the fan-out timeout knob when no explicit timeout)."""
        if timeout_ms is None:
            timeout_ms = float(knob("ES_TPU_TASK_FANOUT_TIMEOUT_MS"))
        deadline = time.monotonic() + timeout_ms / 1000.0
        ok = self.tasks.wait_for_drain(parent_task_id,
                                       timeout_ms / 1000.0)
        for peer in self._peers():
            remaining_ms = (deadline - time.monotonic()) * 1000.0
            if remaining_ms <= 0:
                return False
            try:
                r = self.channels.request(
                    peer, ACTION_TASKS_DRAIN,
                    {"parent_task_id": parent_task_id,
                     "timeout_ms": remaining_ms},
                    source=self.node_name)
                ok = ok and bool(r.get("drained", True))
            except _FANOUT_ERRORS:
                pass  # a dead peer's tasks died with it
        return ok

    def _on_drain(self, req) -> dict:
        p = req.payload
        return {"drained": self.tasks.wait_for_drain(
            p["parent_task_id"],
            float(p.get("timeout_ms") or 0.0) / 1000.0)}

    # ---------------- orphan reaping (node-left) ----------------

    def broadcast_reap(self, dead_node: str) -> None:
        """Master-side node-left hook: every surviving node bans the dead
        node's id prefix and cancels the children it orphaned."""
        self.tasks.reap_orphans(dead_node)
        for peer in self._peers():
            if peer == dead_node:
                continue
            try:
                self.channels.request(peer, ACTION_TASKS_REAP,
                                      {"node": dead_node},
                                      source=self.node_name)
            except _FANOUT_ERRORS:
                pass

    def _on_reap(self, req) -> dict:
        reaped = self.tasks.reap_orphans(req.payload["node"])
        return {"reaped": len(reaped)}

    # ---------------- hot threads ----------------

    def hot_threads(self) -> str:
        from elasticsearch_tpu_torch.threadpool.pool import hot_threads_report

        sections = [hot_threads_report(self.hot_label)]
        for peer in self._peers():
            try:
                r = self.channels.request(peer, ACTION_HOT_THREADS, {},
                                          source=self.node_name)
                sections.append(r["report"])
            except _FANOUT_ERRORS as e:
                sections.append(f"::: {{{peer}}}\n"
                                f"   failed to fetch hot_threads: {e}\n")
        return "\n".join(sections)

    def _on_hot_threads(self, req) -> dict:
        from elasticsearch_tpu_torch.threadpool.pool import hot_threads_report

        return {"report": hot_threads_report(self.hot_label)}

    # ---------------- /_cat/tasks ----------------

    def cat_rows(self, detailed: bool = False) -> List[str]:
        """Whitespace-table rows for `GET /_cat/tasks` (ref:
        RestTasksAction columns: action, task_id, parent, type,
        start_time, timestamp, running_time, node)."""
        listing = self.list(detailed=detailed, group_by="nodes")
        rows = []
        for nid, sec in sorted(listing.get("nodes", {}).items()):
            for tid, d in sorted(sec["tasks"].items()):
                start_s = d["start_time_in_millis"] / 1000.0
                hhmmss = time.strftime("%H:%M:%S", time.gmtime(start_s))
                running_ms = d["running_time_in_nanos"] / 1e6
                rows.append(" ".join([
                    d["action"], tid,
                    d.get("parent_task_id", "-") or "-",
                    d["type"], str(d["start_time_in_millis"]), hhmmss,
                    f"{running_ms:.1f}ms", d["node"],
                ]))
        return rows
