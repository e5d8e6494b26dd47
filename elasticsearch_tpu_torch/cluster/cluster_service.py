"""Live cluster services: the Coordinator wired to real sockets and clocks.

The reference composes Discovery (PeerFinder), MasterService (single-threaded
state-update queue), ClusterApplierService (apply committed states locally)
and the Coordinator around the shared TransportService (ref: node/Node.java
:595-605 DiscoveryModule wiring, cluster/service/MasterService.java:186,
ClusterApplierService.java, discovery/PeerFinder.java:44). This module is
that composition for live nodes; the SAME Coordinator state machine runs
under the deterministic simulation in tests.

Pieces:
  * ThreadScheduler — wall-clock `schedule_at` for the Coordinator.
  * CoordinationTransport — Coordinator messages over the framed TCP action
    "internal:cluster/coordination/msg", with an address book fed by
    discovery handshakes. Node NAMES are the coordination-layer node ids
    (the bootstrap contract: cluster.initial_master_nodes lists names,
    ref: ClusterBootstrapService.java).
  * PeerFinder — probes seed hosts, learns (name, address) pairs.
  * ClusterFormationService — owns the Coordinator + MasterService semantics:
    leaders compute and publish new states; followers forward updates to the
    leader (TransportMasterNodeAction analog) and apply committed states.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.cluster.coordination import (
    Coordinator, CoordinationError, PublishedState,
)
from elasticsearch_tpu_torch.cluster.gateway import PersistedCoordinationState
from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuError
from elasticsearch_tpu_torch.transport.service import TransportService


class _Handle:
    def __init__(self, timer: threading.Timer):
        self._timer = timer

    def cancel(self) -> None:
        self._timer.cancel()


class ThreadScheduler:
    """schedule_at(delay_ms, fn) on wall clock (threading.Timer)."""

    def __init__(self):
        self._stopped = False

    def schedule_at(self, delay_ms: float, fn: Callable[[], None]) -> _Handle:
        t = threading.Timer(max(delay_ms, 1.0) / 1000.0, self._run, args=(fn,))
        t.daemon = True
        t.start()
        return _Handle(t)

    def _run(self, fn) -> None:
        if not self._stopped:
            try:
                fn()
            except Exception:      # noqa: BLE001 — scheduler must survive
                pass

    def stop(self) -> None:
        self._stopped = True


class CoordinationTransport:
    """Adapter: Coordinator's async send API -> framed TCP round trips.

    Each send runs on a short-lived thread (the coordination fan-out is a
    handful of peers at election/publish cadence, not the data path)."""

    def __init__(self, transport: TransportService, self_name: str):
        self.transport = transport
        self.self_name = self_name
        self.addresses: Dict[str, Tuple[str, int]] = {}
        self._local_handler: Optional[Callable] = None

    def set_address(self, name: str, host: str, port: int) -> None:
        self.addresses[name] = (host, port)

    def register_local(self, handler: Callable) -> None:
        """handler(sender, msg, reply_fn) — the Coordinator's handle_message."""
        self._local_handler = handler
        self.transport.register_request_handler(
            "internal:cluster/coordination/msg", self._on_rpc)

    def _on_rpc(self, req) -> dict:
        out: dict = {}

        def reply(msg: dict) -> None:
            out.update(msg)

        if self._local_handler is not None:
            self._local_handler(req.payload["from"], req.payload["msg"], reply)
        return out

    def send(self, sender: str, to: str, msg: dict,
             on_reply: Callable[[dict], None],
             on_error: Optional[Callable[[], None]] = None) -> None:
        addr = self.addresses.get(to)
        if addr is None:
            if on_error is not None:
                on_error()
            return

        def run():
            try:
                resp = TransportService.send_remote(
                    addr[0], addr[1], "internal:cluster/coordination/msg",
                    {"from": sender, "msg": msg}, source_node=sender,
                    timeout=10.0)
            except Exception:      # noqa: BLE001 — network failure
                if on_error is not None:
                    on_error()
                return
            if resp:               # empty dict = handler chose not to reply
                on_reply(resp)

        threading.Thread(target=run, daemon=True).start()


class PeerFinder:
    """Seed-host probing (ref: discovery/PeerFinder.java:44,
    SettingsBasedSeedHostsProvider.java): periodically handshake every seed
    address, learn (node name, bound address), feed the address book."""

    PROBE_INTERVAL_S = 1.0

    def __init__(self, self_name: str, transport: TransportService,
                 seed_hosts: List[Tuple[str, int]],
                 on_peer: Callable[[str, str, int], None]):
        self.self_name = self_name
        self.transport = transport
        self.seed_hosts = list(seed_hosts)
        self.on_peer = on_peer
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        transport.register_request_handler(
            "internal:discovery/handshake",
            lambda req: {"node": self.self_name,
                         "port": self.transport.bound_port})

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            for host, port in list(self.seed_hosts):
                try:
                    resp = TransportService.send_remote(
                        host, port, "internal:discovery/handshake", {},
                        source_node=self.self_name, timeout=2.0)
                    name = resp.get("node")
                    if name and name != self.self_name:
                        self.on_peer(name, host, port)
                except Exception:  # noqa: BLE001 — seed not up yet
                    pass
            self._stop.wait(self.PROBE_INTERVAL_S)

    def stop(self) -> None:
        self._stop.set()


class ClusterFormationService:
    """Coordinator + master-service + applier for one live node.

    State value on the wire is the serialized ClusterState dict; the
    Coordinator replicates it, this service applies commits locally and
    exposes `submit_state_update` with leader-forwarding semantics."""

    def __init__(self, node_name: str, transport: TransportService,
                 initial_value: dict, voting_config: List[str],
                 data_path: Optional[str],
                 on_committed: Callable[[dict], None]):
        self.node_name = node_name
        self.transport = transport
        self.on_committed = on_committed
        self.scheduler = ThreadScheduler()
        self.coord_transport = CoordinationTransport(transport, node_name)
        self._update_lock = threading.Lock()
        self._persist = PersistedCoordinationState(data_path)
        restored = self._persist.load()
        config = frozenset(voting_config)
        initial = PublishedState(term=0, version=0, value=initial_value,
                                 config=config, last_committed_config=config)
        self.coordinator = Coordinator(
            node_name, initial, self.coord_transport, self.scheduler,
            random.Random(hash(node_name) & 0xFFFF),
            on_commit=self._on_commit,
            persistor=self._persist.store,
            restored=restored,
        )
        self.coord_transport.register_local(self.coordinator.handle_message)
        transport.register_request_handler(
            "internal:cluster/state/update", self._on_forwarded_update)
        self.peer_finder: Optional[PeerFinder] = None

    # ---- lifecycle ----

    def start(self, seed_hosts: List[Tuple[str, int]]) -> None:
        self.peer_finder = PeerFinder(
            self.node_name, self.transport, seed_hosts, self._on_peer)
        self.peer_finder.start()
        self.coordinator.start()

    def stop(self) -> None:
        if self.peer_finder is not None:
            self.peer_finder.stop()
        self.coordinator.stop()
        self.scheduler.stop()

    def _on_peer(self, name: str, host: str, port: int) -> None:
        self.coord_transport.set_address(name, host, port)

    # ---- mode / introspection ----

    @property
    def is_leader(self) -> bool:
        return self.coordinator.mode == "LEADER"

    @property
    def leader_name(self) -> Optional[str]:
        return self.coordinator.leader_id

    def committed_value(self) -> dict:
        return self.coordinator.state.accepted.value

    def await_leader(self, timeout: float = 30.0) -> str:
        """Block until some node is known to lead (local mode or leader id)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.coordinator.mode == "LEADER":
                return self.node_name
            if self.coordinator.mode == "FOLLOWER" and self.coordinator.leader_id:
                return self.coordinator.leader_id
            time.sleep(0.05)
        raise TimeoutError(f"[{self.node_name}] no leader after {timeout}s")

    # ---- state updates (MasterService.submitStateUpdateTask analog) ----

    def submit_state_update(self, updater: Callable[[dict], dict],
                            timeout: float = 30.0) -> dict:
        """Run updater(current_value) -> new_value through consensus.

        On the leader: compute + publish + wait for local commit. On a
        follower: forward to the leader (TransportMasterNodeAction). The
        wire-forwarded form re-runs the updater by name on the leader — so
        remote callers instead send the ALREADY-COMPUTED update via
        `_on_forwarded_update` payloads carrying a value diff description."""
        if self.is_leader:
            with self._update_lock:
                new_value = updater(self.coordinator.state.accepted.value)
                pub_term, pub_version = self.coordinator.publish(new_value)
            self._await_commit(pub_term, pub_version, timeout)
            return self.coordinator.state.accepted.value
        raise NotMasterError(self.leader_name)

    def _await_commit(self, pub_term: int, pub_version: int, timeout: float) -> None:
        """Wait for THE publication identified by (term, version) to commit.

        Waiting for any commit would ack a write that a new leader's
        unrelated commit satisfied (ref: MasterService publication listeners
        are per-publication; a term bump fails in-flight publications)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.coordinator.state
            if st.last_committed_version >= pub_version \
                    and st.accepted.term == pub_term:
                return
            if st.current_term != pub_term:
                raise ElasticsearchTpuError(
                    "cluster state publication failed: term changed "
                    f"({pub_term} -> {st.current_term})")
            time.sleep(0.02)
        raise ElasticsearchTpuError("cluster state publication timed out")

    def _on_forwarded_update(self, req) -> dict:
        """Leader-side handler for follower-forwarded whole-value updates."""
        if not self.is_leader:
            raise NotMasterError(self.leader_name)
        new_value = req.payload["value"]
        with self._update_lock:
            pub_term, pub_version = self.coordinator.publish(new_value)
        self._await_commit(pub_term, pub_version, 30.0)
        return {"ok": True}

    def _on_commit(self, st: PublishedState) -> None:
        try:
            self.on_committed(st.value)
        except Exception:          # noqa: BLE001 — applier must not kill consensus
            pass


class NotMasterError(ElasticsearchTpuError):
    status = 503
    error_type = "not_master_exception"

    def __init__(self, leader: Optional[str]):
        super().__init__(f"not the elected master (leader: {leader})")
        self.leader = leader
