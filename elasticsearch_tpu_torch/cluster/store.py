"""Cluster-state stores: how committed states reach every node.

Two implementations of one seam (the reference equivalent is
MasterService.submitStateUpdateTask -> Coordinator.publish ->
ClusterApplierService on every node):

  * LocalStateStore — one shared store for in-process multi-node tests:
    synchronous, deterministic apply order, reentrancy-safe via an update
    queue (a state application may itself submit follow-up updates — e.g.
    shard-started reports — which drain in order, ref:
    MasterService.runTasks single-threaded batching).
  * ConsensusStateStore — wraps a live ClusterFormationService: the value
    replicated by the coordination layer IS ClusterState.to_dict(); commits
    arrive via the coordinator's on_commit callback.

The port's copy of elasticsearch_tpu/cluster/store.py; LocalStateStore
carries the port's kernel errors out of its appliers (see `submit`).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuError, KernelBuildError, KernelLaunchError,
)


class NotMasterError(ElasticsearchTpuError):
    status = 503
    error_type = "not_master_exception"


class LocalStateStore:
    """Shared store for in-process clusters (deterministic tests)."""

    def __init__(self, initial: ClusterState, master_name: str):
        self.state = initial
        self.master_name = master_name
        self._appliers: Dict[str, Callable[[ClusterState], None]] = {}
        self._lock = threading.RLock()
        self._queue: List[Callable[[ClusterState], ClusterState]] = []
        self._draining = False

    def add_applier(self, name: str,
                    fn: Callable[[ClusterState], None]) -> None:
        self._appliers[name] = fn

    def remove_applier(self, name: str) -> None:
        self._appliers.pop(name, None)

    def master_node(self) -> Optional[str]:
        return self.master_name

    def is_master(self, name: str) -> bool:
        return name == self.master_name

    def current(self) -> ClusterState:
        return self.state

    def submit(self, updater: Callable[[ClusterState], ClusterState]
               ) -> ClusterState:
        """Run updater through the single-threaded master queue; apply each
        resulting state on every node applier in name order. Nested submits
        (from appliers' deferred actions) enqueue and drain in order.

        An applier that raises a kernel error of the port leaves no node
        behind: every applier still sees the state, the queue drains (the
        failed copy's report among it), then the first such error is
        raised to the submitter."""
        kernel_error: Optional[Exception] = None
        with self._lock:
            self._queue.append(updater)
            if self._draining:
                return self.state
            self._draining = True
            try:
                while self._queue:
                    up = self._queue.pop(0)
                    new_state = up(self.state)
                    if new_state is self.state:
                        continue
                    self.state = new_state
                    for name in sorted(self._appliers):
                        try:
                            self._appliers[name](new_state)
                        except (KernelBuildError, KernelLaunchError) as e:
                            kernel_error = kernel_error or e
            finally:
                self._draining = False
            if kernel_error is not None:
                raise kernel_error
            return self.state


class ConsensusStateStore:
    """Per-node store over the live coordination layer."""

    def __init__(self, formation) -> None:
        # formation: cluster/cluster_service.ClusterFormationService whose
        # replicated value is ClusterState.to_dict()
        self.formation = formation

    def master_node(self) -> Optional[str]:
        if self.formation.is_leader:
            return self.formation.node_name
        return self.formation.leader_name

    def is_master(self, name: str) -> bool:
        return self.master_node() == name

    def current(self) -> ClusterState:
        return ClusterState.from_dict(self.formation.committed_value())

    def submit(self, updater: Callable[[ClusterState], ClusterState]
               ) -> ClusterState:
        if not self.formation.is_leader:
            raise NotMasterError(
                f"not the elected master (leader: "
                f"{self.formation.leader_name})")
        value = self.formation.submit_state_update(
            lambda v: updater(ClusterState.from_dict(v)).to_dict())
        return ClusterState.from_dict(value)
