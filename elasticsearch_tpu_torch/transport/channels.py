"""Node-to-node request channels for the distributed data/control plane.

The reference routes every inter-node call through TransportService
connections looked up from the cluster state's DiscoveryNodes (ref:
transport/TransportService.java sendRequest(DiscoveryNode, ...)). Here the
same seam is a small synchronous interface so the SAME spine code (shard
replication, peer recovery, search fan-out, master actions) runs:

  * in one process for the deterministic multi-node tests
    (LocalNodeChannels — direct dispatch, with kill support to simulate
    node death, and an optional fault hook for injected failures);
  * over real framed TCP between live nodes (TcpNodeChannels — address
    book fed from the cluster state / discovery).

Requests address nodes by node NAME (the stable operator-facing identity;
coordination uses the same convention, see cluster/cluster_service.py).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Set, Tuple

from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuError
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.transport.service import TransportService


class NodeUnavailableError(ElasticsearchTpuError):
    status = 503
    error_type = "node_not_connected_exception"


class RpcTimeoutError(ElasticsearchTpuError):
    """An RPC did not answer within its deadline (ref:
    ReceiveTimeoutTransportException): the coordinator stops waiting; the
    late reply — if any — is dropped."""

    status = 504
    error_type = "receive_timeout_transport_exception"


# Transport RPC actions that are named fault-injection sites (the
# `rpc_*` half of the ES_TPU_FAULTS grammar, common/faults.py).
_RPC_FAULT_SITES = {
    "indices:data/read/search[phase/query]": "rpc_query",
    "indices:data/read/search[phase/fetch/id]": "rpc_fetch",
    "indices:data/read/search[can_match]": "rpc_can_match",
    "indices:data/write/bulk[s]": "rpc_bulk",
    "indices:data/write/bulk[s][r]": "rpc_replica_bulk",
    # every peer-recovery phase shares one site: @nth counts ACROSS the
    # prepare/segments/ops/finalize/cancel sequence of a recovery
    "internal:index/shard/recovery/prepare": "rpc_recovery",
    "internal:index/shard/recovery/segments": "rpc_recovery",
    "internal:index/shard/recovery/ops": "rpc_recovery",
    "internal:index/shard/recovery/finalize": "rpc_recovery",
    "internal:index/shard/recovery/cancel": "rpc_recovery",
    "internal:index/shard/resync/prepare": "rpc_resync",
    "internal:index/shard/resync/apply": "rpc_resync",
    # relocation warm handoff (the recovery RPCs a relocating target runs
    # keep their rpc_recovery site — reuse #node selectors for those)
    "internal:index/shard/relocation/warm_info": "rpc_relocation",
}


class NodeChannels:
    """request() raises NodeUnavailableError when the target is down."""

    def request(self, node: str, action: str, payload: dict,
                source: Optional[str] = None) -> dict:
        raise NotImplementedError


class LocalNodeChannels(NodeChannels):
    """In-process dispatch between TransportServices, by node name.

    Disruption rules mirror testing/disruptable_transport.py's taxonomy —
    kill (node death), isolate (one-sided cut from everyone), partition
    (two-sided blackhole between groups), heal — and all of them surface as
    the SAME `NodeUnavailableError` the fault-injection sites raise, so
    injected and organic transport faults take identical recovery paths."""

    def __init__(self):
        self._services: Dict[str, TransportService] = {}  # guarded by: _lock
        self._killed: set = set()                         # guarded by: _lock
        self._isolated: set = set()                       # guarded by: _lock
        self._blackholed: Set[Tuple[str, str]] = set()    # guarded by: _lock
        self._lock = threading.Lock()
        # test seam: fault(to_node, action) -> raise to inject
        self.fault_hook: Optional[Callable[[str, str], None]] = None

    def register(self, name: str, service: TransportService) -> None:
        with self._lock:
            self._services[name] = service
            self._killed.discard(name)

    def kill(self, name: str) -> None:
        with self._lock:
            self._killed.add(name)

    def revive(self, name: str) -> None:
        with self._lock:
            self._killed.discard(name)

    # ---- partition rules (ref: DisruptableMockTransport) ----

    def isolate(self, name: str) -> None:
        """Cut `name` off from every other node (both directions)."""
        with self._lock:
            self._isolated.add(name)

    def partition(self, side_a: Set[str], side_b: Set[str]) -> None:
        """Two-sided blackhole between the groups."""
        with self._lock:
            for a in side_a:
                for b in side_b:
                    self._blackholed.add((a, b))
                    self._blackholed.add((b, a))

    def heal(self) -> None:
        with self._lock:
            self._isolated.clear()
            self._blackholed.clear()

    def request(self, node: str, action: str, payload: dict,
                source: Optional[str] = None) -> dict:
        with self._lock:
            if node in self._killed or node not in self._services:
                raise NodeUnavailableError(f"node [{node}] is not connected")
            if node in self._isolated or source in self._isolated:
                raise NodeUnavailableError(
                    f"node [{node}] is partitioned away")
            if source is not None and (source, node) in self._blackholed:
                raise NodeUnavailableError(
                    f"no route from [{source}] to [{node}] (partition)")
            service = self._services[node]
        site = _RPC_FAULT_SITES.get(action)
        if site is not None:
            from elasticsearch_tpu_torch.common.faults import transport_fault_point

            transport_fault_point(site, node)
        if self.fault_hook is not None:
            self.fault_hook(node, action)
        return service.handle(action, payload, source_node=source or "local")


class TcpNodeChannels(NodeChannels):
    """Framed-TCP dispatch using an address book (host, port) by name."""

    def __init__(self, self_name: str, self_service: TransportService,
                 timeout: Optional[float] = None):
        self.self_name = self_name
        self.self_service = self_service
        self.timeout = timeout if timeout is not None \
            else knob("ES_TPU_TCP_TIMEOUT_S")
        self._addresses: Dict[str, Tuple[str, int]] = {}  # guarded by: _lock
        self._lock = threading.Lock()

    def set_address(self, name: str, host: str, port: int) -> None:
        with self._lock:
            self._addresses[name] = (host, port)

    def update_from_state(self, state) -> None:
        """Learn peer addresses from the applied cluster state."""
        for n in state.nodes.values():
            if ":" in (n.address or ""):
                host, port = n.address.rsplit(":", 1)
                self.set_address(n.name, host, int(port))

    def request(self, node: str, action: str, payload: dict,
                source: Optional[str] = None) -> dict:
        if node == self.self_name:
            # local short-circuit, as the reference does for local sends
            return self.self_service.handle(action, payload, source_node=node)
        with self._lock:
            addr = self._addresses.get(node)
        if addr is None:
            raise NodeUnavailableError(f"no known address for node [{node}]")
        try:
            return TransportService.send_remote(
                addr[0], addr[1], action, payload,
                source_node=self.self_name, timeout=self.timeout)
        except (ConnectionError, OSError, TimeoutError) as e:
            raise NodeUnavailableError(
                f"node [{node}] unreachable: {e}") from e
