"""ClusterNode: the multi-node composition root.

Where node.py wires a complete single-process node, this wires the
DISTRIBUTED spine (ref: node/Node.java:278 — the same constructor builds
both; here the cluster path is explicit): transport + channels, a cluster
state store (shared-local for tests, consensus for live clusters), the
shard service with its replication/recovery/resync actions, the
cluster-state applier, the distributed search action, and the master-side
actions (index CRUD, shard started/failed, node join/left + allocation).

The flow matching the reference:
  create index  -> master computes metadata + unassigned routing
                   -> AllocationService.reroute assigns copies
                   -> publish -> every node's applier creates local shards
                   -> nodes report shard-started -> master marks STARTED
  bulk          -> coordinator groups by shard -> primary node executes +
                   replicates (seqno/term-fenced) -> acks
  search        -> coordinator fans per-shard query -> merge -> fetch
  node dies     -> master disassociates -> replica promoted (term bump)
                   -> new primary resyncs survivors -> writes continue

The port's copy of elasticsearch_tpu/cluster_node.py. ``ClusterNode``,
``LiveClusterNode`` and ``form_local_cluster`` take ``device``: it
resolves once (``device.resolve``: ``None`` is the card, ``"cpu"`` only
when asked; no card raises `DeviceUnavailableError`), as `Node` does, and
every shard copy the node holds serves there. The nodes of one
`form_local_cluster` share the one device.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch import device as _device
from elasticsearch_tpu_torch.action.search_action import SearchActionService
from elasticsearch_tpu_torch.cluster.allocation import AllocationService
from elasticsearch_tpu_torch.cluster.state import (
    ClusterState, DiscoveryNode, IndexMetadata, ShardRouting,
)
from elasticsearch_tpu_torch.cluster.store import LocalStateStore, NotMasterError
from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuError, IllegalArgumentError, IndexClosedError,
    IndexNotFoundError, ResourceAlreadyExistsError,
)
from elasticsearch_tpu_torch.common.settings import Settings, knob
from elasticsearch_tpu_torch.index.translog import TranslogFsyncError
from elasticsearch_tpu_torch.indices.cluster_state_service import (
    IndicesClusterStateService,
)
from elasticsearch_tpu_torch.indices.shard_service import (
    DistributedShardService, PrimaryTermMismatchError, ShardNotFoundError,
    _ops_bytes,
)
from elasticsearch_tpu_torch.parallel.routing import shard_for_id
from elasticsearch_tpu_torch.transport.channels import (
    NodeChannels, NodeUnavailableError,
)
from elasticsearch_tpu_torch.transport.service import TransportService


class ClusterNode:
    def __init__(self, node_name: str, channels: NodeChannels, store,
                 data_path: Optional[str] = None,
                 roles: Tuple[str, ...] = ("master", "data"),
                 transport: Optional[TransportService] = None,
                 device=None):
        self.node_name = node_name
        self.device = _device.resolve(device)
        self.roles = roles
        self.channels = channels
        self.store = store
        self.transport = transport or TransportService(node_name)
        self.allocation = AllocationService()
        # armed by node-left when delayed allocation is on; each fires one
        # reroute through the master update queue at deadline expiry
        self._delayed_timers: List[threading.Timer] = []
        from elasticsearch_tpu_torch.common.indexing_pressure import IndexingPressure

        # ONE write-backpressure budget per node: the coordinating stage
        # (bulk fan-out below) and the primary/replica stages inside the
        # shard service must draw from the same 512MB pool — two separate
        # IndexingPressure instances would admit twice the bytes
        # (ref: IndexingPressure.java is a node-level singleton)
        self.indexing_pressure = IndexingPressure()
        from elasticsearch_tpu_torch.threadpool import ThreadPool

        # same singleton rule for the stage executors: the shard service's
        # write handlers and the search action's query/fetch handlers run
        # on ONE node-level ThreadPool, so saturating writes can never
        # occupy search workers (and vice versa)
        self.thread_pool = ThreadPool()
        from elasticsearch_tpu_torch.tasks import TaskManager
        from elasticsearch_tpu_torch.tasks.task_plane import TaskPlane

        # node task registry + the cluster plane over it: _tasks fan-out,
        # node-routed get/cancel, ban propagation, hot_threads fan-out
        self.tasks = TaskManager(node_name)
        self.task_plane = TaskPlane(
            self.tasks, node_name, channels=channels,
            state_fn=lambda: self.state, transport=self.transport)
        from elasticsearch_tpu_torch.cluster.telemetry_plane import TelemetryPlane
        from elasticsearch_tpu_torch.common import metrics as _metrics

        # cluster telemetry plane: answers nodes-stats / metrics-scrape
        # RPCs for coordinators and fans out when acting as one
        self.telemetry_plane = TelemetryPlane(
            node_name, channels=channels,
            state_fn=lambda: self.state, transport=self.transport)
        _metrics.maybe_start_sampler()
        from elasticsearch_tpu_torch.common.overload import OverloadController
        from elasticsearch_tpu_torch.threadpool import default_scheduler

        # overload control plane: one controller per node folds the
        # pressure signals; the shard/search services consult it for
        # transport admission and retry budgets
        self.overload = OverloadController(
            node_name, thread_pool=self.thread_pool,
            scheduler=default_scheduler(),
            indexing_pressure=self.indexing_pressure)
        self.shard_service = DistributedShardService(
            node_name, self.transport, channels, self.master_client,
            data_path, indexing_pressure=self.indexing_pressure,
            thread_pool=self.thread_pool, tasks=self.tasks,
            overload=self.overload, device=self.device)
        from elasticsearch_tpu_torch.common.integrity import IntegrityScrubber

        # HBM scrubber (ES_TPU_INTEGRITY_SCRUB_S; 0 = off): one region
        # per tick on the management pool, skipped while overload != GREEN
        self.integrity_scrubber = IntegrityScrubber(
            thread_pool=self.thread_pool, overload=self.overload)
        self.integrity_scrubber.start()
        self.applier = IndicesClusterStateService(
            node_name, self.shard_service, self.master_client)
        from elasticsearch_tpu_torch.cluster.remote import RemoteClusterService

        # cross-cluster plane: named remote clusters this node can
        # fan searches out to / pull CCR ops from; the search action gets
        # the registry so `remote:index` patterns split at its front door
        self.remotes = RemoteClusterService(node_name,
                                            overload=self.overload)
        self.search_action = SearchActionService(
            self.transport, channels, self.shard_service,
            thread_pool=self.thread_pool, tasks=self.tasks,
            overload=self.overload, remotes=self.remotes)
        from elasticsearch_tpu_torch.index.ccr import CcrService, ClusterNodeHost

        self.ccr = CcrService(ClusterNodeHost(self), self.remotes,
                              self.transport)
        t = self.transport
        t.register_request_handler("indices:admin/create",
                                   self._on_create_index)
        t.register_request_handler("indices:admin/aliases",
                                   self._on_update_aliases)
        t.register_request_handler("indices:admin/state",
                                   self._on_set_index_state)
        t.register_request_handler("indices:admin/delete",
                                   self._on_delete_index)
        t.register_request_handler("internal:cluster/shard/started",
                                   self._on_shard_started)
        t.register_request_handler("internal:cluster/shard/failed",
                                   self._on_shard_failed)
        t.register_request_handler("internal:cluster/node/left",
                                   self._on_node_left)
        t.register_request_handler("internal:cluster/node/join",
                                   self._on_node_join)
        t.register_request_handler("cluster:admin/settings/update",
                                   self._on_cluster_settings_update)
        t.register_request_handler("cluster:admin/reroute",
                                   self._on_cluster_reroute)
        t.register_request_handler("cluster:monitor/health",
                                   lambda req: self.state.health())
        t.register_request_handler("cluster:monitor/nodes/ping",
                                   lambda req: {"ok": True})

    # ---------------- plumbing ----------------

    @property
    def state(self) -> ClusterState:
        return self.shard_service.state

    def apply_state(self, state: ClusterState) -> None:
        self.applier.apply_cluster_state(state)

    def master_client(self, action: str, payload: dict) -> dict:
        """Route a master-only action to the elected master (ref:
        TransportMasterNodeAction — local execute or forward)."""
        master = self.store.master_node()
        if master is None:
            raise NotMasterError("no elected master")
        if master == self.node_name:
            return self.transport.handle(action, payload)
        return self.channels.request(master, action, payload)

    def _require_master(self) -> None:
        if not self.store.is_master(self.node_name):
            raise NotMasterError(
                f"node [{self.node_name}] is not the elected master")

    # ---------------- master-side actions ----------------

    def _on_create_index(self, req) -> dict:
        self._require_master()
        name = req.payload["name"]
        body = req.payload.get("body") or {}
        settings = Settings(body.get("settings", {}))
        for short, full in (("number_of_shards", "index.number_of_shards"),
                            ("number_of_replicas",
                             "index.number_of_replicas")):
            if settings.raw(full) is None and settings.raw(short) is not None:
                settings = settings.with_updates({full: settings.raw(short)})

        def updater(state: ClusterState) -> ClusterState:
            if name in state.indices:
                raise ResourceAlreadyExistsError(
                    f"index [{name}] already exists", index=name)
            meta = IndexMetadata(
                index=name, uuid=uuid.uuid4().hex[:20], settings=settings,
                mappings=body.get("mappings", {}),
                aliases=body.get("aliases", {}),
                primary_terms=tuple([1] * int(settings.raw(
                    "index.number_of_shards", 1))))
            routing: List[ShardRouting] = []
            for sid in range(meta.number_of_shards):
                routing.append(ShardRouting(index=name, shard_id=sid,
                                            node_id=None, primary=True,
                                            state="UNASSIGNED"))
                for _ in range(meta.number_of_replicas):
                    routing.append(ShardRouting(index=name, shard_id=sid,
                                                node_id=None, primary=False,
                                                state="UNASSIGNED"))
            return self.allocation.reroute(state.with_index(meta, routing))

        self.store.submit(updater)
        return {"acknowledged": True, "index": name}

    def _on_delete_index(self, req) -> dict:
        self._require_master()
        name = req.payload["name"]

        def updater(state: ClusterState) -> ClusterState:
            if name not in state.indices:
                raise IndexNotFoundError(name)
            return state.without_index(name)

        self.store.submit(updater)
        return {"acknowledged": True}

    def _on_update_aliases(self, req) -> dict:
        """Master action behind _aliases / rollover (ref:
        cluster/metadata/MetadataIndexAliasesService.java): apply
        add/remove alias actions as one atomic cluster-state update, so a
        rollover's demote-old/promote-new swap cannot be observed
        half-done."""
        import dataclasses

        self._require_master()
        actions = req.payload.get("actions") or []

        def updater(state: ClusterState) -> ClusterState:
            metas = dict(state.indices)
            for action in actions:
                op, spec = next(iter(action.items()))
                name = spec["index"]
                meta = metas.get(name)
                if meta is None:
                    raise IndexNotFoundError(name)
                aliases = dict(meta.aliases)
                if op == "add":
                    aliases[spec["alias"]] = {
                        k: v for k, v in spec.items()
                        if k not in ("index", "alias")}
                elif op == "remove":
                    aliases.pop(spec["alias"], None)
                else:
                    raise IllegalArgumentError(
                        f"unsupported alias action [{op}]")
                metas[name] = dataclasses.replace(
                    meta, aliases=aliases, version=meta.version + 1)
            new = state
            for name, meta in metas.items():
                if meta is not state.indices.get(name):
                    new = new.with_index(meta, new.routing[name])
            return new

        self.store.submit(updater)
        return {"acknowledged": True}

    def _on_set_index_state(self, req) -> dict:
        """Open/close as a pure cluster-state transition (ref:
        MetadataIndexStateService.java); data nodes enforce the block when
        the applied state reaches them."""
        import dataclasses

        self._require_master()
        name = req.payload["name"]
        target = req.payload["state"]
        if target not in ("open", "close"):
            raise IllegalArgumentError(f"invalid index state [{target}]")

        def updater(state: ClusterState) -> ClusterState:
            meta = state.indices.get(name)
            if meta is None:
                raise IndexNotFoundError(name)
            new_meta = dataclasses.replace(meta, state=target,
                                           version=meta.version + 1)
            return state.with_index(new_meta, state.routing[name])

        self.store.submit(updater)
        return {"acknowledged": True}

    def _on_shard_started(self, req) -> dict:
        self._require_master()
        p = req.payload

        def updater(state: ClusterState) -> ClusterState:
            return self.allocation.reroute(
                self.allocation.apply_started_shard(
                    state, p["index"], p["shard_id"], p["allocation_id"]))

        self.store.submit(updater)
        return {"acknowledged": True}

    def _on_shard_failed(self, req) -> dict:
        self._require_master()
        p = req.payload

        def updater(state: ClusterState) -> ClusterState:
            return self.allocation.apply_failed_shard(
                state, p["index"], p["shard_id"], p["allocation_id"])

        self.store.submit(updater)
        return {"acknowledged": True}

    def _on_node_left(self, req) -> dict:
        self._require_master()
        names = set(req.payload["nodes"])

        def updater(state: ClusterState) -> ClusterState:
            dead = {nid for nid in state.nodes if nid in names}
            if not dead:
                return state
            return self.allocation.disassociate_dead_nodes(state, dead)

        self.store.submit(updater)
        self._schedule_delayed_reroute()
        # reap orphaned child tasks cluster-wide: a dead coordinator can
        # never unblock its shard children, so every surviving node bans
        # the dead node's id prefix (tasks/task_plane.py)
        for name in names:
            self.task_plane.broadcast_reap(name)
        return {"acknowledged": True}

    def _on_node_join(self, req) -> dict:
        """Data-plane join: record the node + its transport address in the
        cluster state, then let allocation use it (ref: JoinHelper + the
        node-join cluster-state task)."""
        self._require_master()
        nd = DiscoveryNode.from_dict(req.payload["node"])

        def updater(state: ClusterState) -> ClusterState:
            existing = state.nodes.get(nd.node_id)
            if existing is not None and existing.address == nd.address:
                return state
            return self.allocation.reroute(state.with_node(nd))

        self.store.submit(updater)
        return {"acknowledged": True}

    def _schedule_delayed_reroute(self) -> None:
        """Arm a reroute at the delayed-allocation deadline: node-left
        leaves replica replacements UNASSIGNED-with-deadline, and unless
        the node bounces back something must wake the allocator when the
        window closes. The timer only *submits* — the decision itself runs
        inside the master update queue against the then-current state (and
        is a no-op when the copies were reclaimed by a rejoin)."""
        delay_ms = knob("ES_TPU_DELAYED_ALLOC_MS")
        if delay_ms <= 0:
            return

        def fire():
            try:
                if self.store.is_master(self.node_name):
                    self.store.submit(
                        lambda st: self.allocation.reroute(st))
            except Exception:  # noqa: BLE001 — a stopped store at shutdown
                pass

        t = threading.Timer(delay_ms / 1000.0 + 0.05, fire)
        t.daemon = True
        t.start()
        self._delayed_timers.append(t)

    def _on_cluster_settings_update(self, req) -> dict:
        """Dynamic cluster-wide settings (ref: TransportClusterUpdate-
        SettingsAction): the payload merges into ClusterState.settings
        (None/"" removes a key) and allocation reruns immediately — so
        setting cluster.routing.allocation.exclude._name IS the drain."""
        self._require_master()
        updates = dict(req.payload.get("settings", {}))

        def updater(state: ClusterState) -> ClusterState:
            return self.allocation.reroute(state.with_settings(updates))

        self.store.submit(updater)
        return {"acknowledged": True, "persistent": updates}

    def _on_cluster_reroute(self, req) -> dict:
        """Explicit reroute commands (ref: TransportClusterRerouteAction).
        Supports `move`; dry_run plans against the current state and
        discards, returning per-command explanations either way."""
        self._require_master()
        p = req.payload
        commands = list(p.get("commands", []))
        dry_run = bool(p.get("dry_run"))

        def plan(state: ClusterState, explain: Optional[list]):
            st = state
            for cmd in commands:
                move = cmd.get("move")
                if not move:
                    if explain is not None:
                        explain.append({
                            "command": sorted(cmd)[0] if cmd else "?",
                            "accepted": False,
                            "reason": "only the move command is supported"})
                    continue
                index = move["index"]
                sid = int(move["shard"])
                frm, to = move["from_node"], move["to_node"]
                src = next(
                    (r for r in st.routing.get(index, [])
                     if r.shard_id == sid and r.node_id == frm
                     and r.state == "STARTED"), None)
                if src is None:
                    if explain is not None:
                        explain.append({
                            "command": "move", "index": index, "shard": sid,
                            "accepted": False,
                            "reason": f"no STARTED copy of [{index}][{sid}] "
                                      f"on [{frm}]"})
                    continue
                moved = self.allocation.initiate_relocation(
                    st, index, sid, src.allocation_id, to)
                if explain is not None:
                    explain.append({
                        "command": "move", "index": index, "shard": sid,
                        "from_node": frm, "to_node": to,
                        "accepted": moved is not st,
                        **({} if moved is not st else
                           {"reason": "move rejected: target unknown, same "
                                      "node, or already holds a copy"})})
                st = moved
            return st

        explanations: list = []
        plan(self.state, explanations)
        if not dry_run:
            self.store.submit(
                lambda st: self.allocation.reroute(plan(st, None)))
        return {"acknowledged": True, "dry_run": dry_run,
                "explanations": explanations,
                "state_version": self.state.version}

    # ---------------- client surface ----------------

    def create_index(self, name: str, body: Optional[dict] = None) -> dict:
        return self.master_client("indices:admin/create",
                                  {"name": name, "body": body or {}})

    def delete_index(self, name: str) -> dict:
        return self.master_client("indices:admin/delete", {"name": name})

    def update_aliases(self, actions: List[dict]) -> dict:
        return self.master_client("indices:admin/aliases",
                                  {"actions": actions})

    def close_index(self, name: str) -> dict:
        return self.master_client("indices:admin/state",
                                  {"name": name, "state": "close"})

    def open_index(self, name: str) -> dict:
        return self.master_client("indices:admin/state",
                                  {"name": name, "state": "open"})

    def resolve_write_index(self, name: str) -> str:
        """Alias -> concrete write index (single holder, or the
        is_write_index one among several)."""
        state = self.state
        if name in state.indices:
            return name
        holders = [(n, state.indices[n].aliases[name])
                   for n in sorted(state.indices)
                   if name in state.indices[n].aliases]
        if not holders:
            raise IndexNotFoundError(name)
        if len(holders) == 1:
            return holders[0][0]
        writers = [n for n, spec in holders if spec.get("is_write_index")]
        if len(writers) != 1:
            raise IllegalArgumentError(
                f"no write index is defined for alias [{name}]")
        return writers[0]

    def rollover(self, alias: str, body: Optional[dict] = None) -> dict:
        """Coordinator-side rollover over master actions (shared mechanics
        in indices/rollover.py; conditions needing node-local store stats
        are not available on this path and raise)."""
        from elasticsearch_tpu_torch.indices.rollover import (
            evaluate_rollover_conditions, next_rollover_name,
            rollover_alias_actions,
        )

        body = body or {}
        old_name = self.resolve_write_index(alias)
        meta = self.state.indices[old_name]
        old_spec = meta.aliases.get(alias, {})
        conditions = body.get("conditions", {}) or {}
        metrics = {"max_age": int(time.time() * 1000) - meta.creation_date}
        if "max_docs" in conditions:
            metrics["max_docs"] = self.search(old_name, {
                "size": 0, "track_total_hits": True,
            })["hits"]["total"]["value"]
        met = evaluate_rollover_conditions(conditions, metrics)
        rolled = (not conditions) or any(met.values())
        new_name = body.get("new_index") or next_rollover_name(old_name)
        out = {"old_index": old_name, "new_index": new_name,
               "rolled_over": False, "dry_run": bool(body.get("dry_run")),
               "conditions": met, "acknowledged": False}
        if body.get("dry_run") or not rolled:
            return out
        self.create_index(new_name, {k: v for k, v in body.items()
                                     if k in ("settings", "mappings",
                                              "aliases")})
        self.update_aliases(rollover_alias_actions(
            alias, old_name, new_name, old_spec))
        out.update({"rolled_over": True, "acknowledged": True})
        return out

    def report_node_left(self, *names: str) -> dict:
        return self.master_client("internal:cluster/node/left",
                                  {"nodes": list(names)})

    def health(self) -> dict:
        return self.state.health()

    def bulk(self, index: str, ops: List[dict],
             retries: Optional[int] = None,
             retry_delay: Optional[float] = None) -> dict:
        """Coordinator-side bulk: group by shard, dispatch to primaries
        (ref: action/bulk/TransportBulkAction.java:164 + the replication
        template). Retries on stale routing — a promoted primary or a moved
        shard shows up in a later cluster state — and on a primary whose
        WAL failed (the master reallocates it). Retry count/delay default
        from ES_TPU_BULK_RETRIES / ES_TPU_BULK_RETRY_MS; the whole dispatch
        is bounded by ES_TPU_BULK_TIMEOUT_MS (0 = no deadline)."""
        if retries is None:
            retries = knob("ES_TPU_BULK_RETRIES")
        if retry_delay is None:
            retry_delay = knob("ES_TPU_BULK_RETRY_MS") / 1000.0
        index = self.resolve_write_index(index)
        state = self.state
        meta = state.indices.get(index)
        if meta is None:
            raise IndexNotFoundError(index)
        if meta.state == "close":
            raise IndexClosedError(f"closed index [{index}]")
        n_shards = meta.number_of_shards
        by_shard: Dict[int, List[Tuple[int, dict]]] = {}
        for pos, op in enumerate(ops):
            sid = shard_for_id(op["id"], n_shards, op.get("routing"))
            by_shard.setdefault(sid, []).append((pos, op))

        # coordinating-stage accounting against the node's ONE shared budget
        # (ref: TransportBulkAction holds coordinating bytes for the fan-out)
        from elasticsearch_tpu_torch.tasks import task_manager as _taskmgr

        with self.indexing_pressure.coordinating(_ops_bytes(ops)):
            if _taskmgr.current_task() is None:
                with self.tasks.task("indices:data/write/bulk",
                                     f"bulk [{index}] ops[{len(ops)}]"):
                    return self._bulk_dispatch(index, ops, by_shard,
                                               retries, retry_delay)
            return self._bulk_dispatch(index, ops, by_shard, retries,
                                       retry_delay)

    def _bulk_dispatch(self, index: str, ops: List[dict],
                       by_shard: Dict[int, List[Tuple[int, dict]]],
                       retries: int, retry_delay: float) -> dict:
        from elasticsearch_tpu_torch.tasks import task_manager as _taskmgr

        results: List[Optional[dict]] = [None] * len(ops)
        errors = False
        timeout_ms = knob("ES_TPU_BULK_TIMEOUT_MS")
        deadline = time.monotonic() + timeout_ms / 1000.0 if timeout_ms else None
        ct = _taskmgr.current_task()
        for sid, items in by_shard.items():
            if ct is not None:
                # per-shard fan-out boundary (same contract as search)
                ct.check()
            payload_ops = [op for _, op in items]
            resp = None
            last_err: Optional[Exception] = None
            for attempt in range(retries):
                if deadline is not None and time.monotonic() >= deadline:
                    last_err = ElasticsearchTpuError(
                        f"bulk deadline ({timeout_ms}ms) exceeded; "
                        f"last error: {last_err}")
                    break
                if attempt and not self.overload.retry_allowed("bulk"):
                    # node-wide retry budget exhausted: fail the items
                    # with the organic error instead of hammering a
                    # browned-out primary for the full retry count
                    break
                state = self.state
                primary = state.primary_of(index, sid)
                # a RELOCATING primary still owns the write path until the
                # target's shard-started commits the swap
                if primary is None or primary.node_id is None \
                        or not primary.serving:
                    last_err = ElasticsearchTpuError(
                        f"no started primary for [{index}][{sid}]")
                    time.sleep(retry_delay)
                    continue
                # circuit-aware dispatch: don't burn a retry on a node the
                # transport breaker already holds OPEN — wait for its
                # half-open probe window instead. allow_request() is
                # consulted immediately before the attempt (an admitted
                # probe that is never attempted wedges the circuit).
                circuit = self.search_action._node_circuit(primary.node_id)
                if not circuit.allow_request():
                    last_err = ElasticsearchTpuError(
                        f"transport circuit open for node "
                        f"[{primary.node_id}]")
                    time.sleep(retry_delay)
                    continue
                bulk_payload = {
                    "index": index, "shard_id": sid,
                    "primary_term": state.indices[index].primary_term(sid),
                    "ops": payload_ops,
                    "ops_bytes": _ops_bytes(payload_ops)}
                if ct is not None:
                    # parent linkage rides the payload top level (next to
                    # ops), so the primary registers a cancellable child
                    bulk_payload["_parent_task"] = ct.task_id
                try:
                    resp = self.channels.request(
                        primary.node_id, "indices:data/write/bulk[s]",
                        bulk_payload)
                    self.search_action._record_transport_outcome(
                        primary.node_id)
                    self.overload.note_success()
                    break
                except (NodeUnavailableError, ShardNotFoundError,
                        PrimaryTermMismatchError, TranslogFsyncError) as e:
                    # TranslogFsyncError: the primary refused to ack into a
                    # broken WAL and failed itself; a later state carries
                    # the promoted/reallocated copy — retry there.
                    self.search_action._record_transport_outcome(
                        primary.node_id, e)
                    last_err = e
                    time.sleep(retry_delay)
            if resp is None:
                errors = True
                for pos, op in items:
                    results[pos] = {"_id": op["id"], "status": 503,
                                    "error": {"type": "unavailable_shards_exception",
                                              "reason": str(last_err)}}
                continue
            for (pos, op), r in zip(items, resp["results"]):
                if "error" in r:
                    errors = True
                results[pos] = r
        return {"errors": errors, "items": results}

    def index_doc(self, index: str, doc_id: str, source: dict) -> dict:
        resp = self.bulk(index, [{"op": "index", "id": doc_id,
                                  "source": source}])
        item = resp["items"][0]
        if "error" in item:
            err = ElasticsearchTpuError(item["error"].get("reason", "error"))
            err.status = item.get("status", 500)
            raise err
        return item

    def search(self, index: str, body: Optional[dict] = None) -> dict:
        return self.search_action.execute_search(index, body or {})

    def refresh(self, index: str) -> None:
        """Refresh every local + remote copy (broadcast by shard copy)."""
        state = self.state
        nodes = {r.node_id for r in state.routing.get(index, [])
                 if r.node_id is not None and r.serving}
        for node in sorted(nodes):
            try:
                self.channels.request(node, "indices:admin/refresh[shard]",
                                      {"index": index})
            except NodeUnavailableError:
                pass

    def update_cluster_settings(self, settings: Dict[str, Optional[str]]) -> dict:
        """Cluster-wide dynamic settings (drain a node by putting its name
        in cluster.routing.allocation.exclude._name; clear with None)."""
        return self.master_client("cluster:admin/settings/update",
                                  {"settings": settings})

    def cluster_reroute(self, commands: List[dict],
                        dry_run: bool = False) -> dict:
        """Explicit allocation commands (move), optionally as a dry run."""
        return self.master_client("cluster:admin/reroute",
                                  {"commands": commands, "dry_run": dry_run})

    def close(self) -> None:
        self.ccr.stop()
        self.integrity_scrubber.stop()
        for t in self._delayed_timers:
            t.cancel()
        for key in list(self.shard_service.shards):
            self.shard_service.remove_shard(*key)
        self.transport.close()
        self.thread_pool.shutdown()


def _register_refresh_handler(node: ClusterNode) -> None:
    def on_refresh(req):
        for (index, _), inst in list(node.shard_service.shards.items()):
            if index == req.payload["index"]:
                inst.engine.refresh()
        return {"ok": True}

    node.transport.register_request_handler(
        "indices:admin/refresh[shard]", on_refresh)


class LiveClusterNode(ClusterNode):
    """A ClusterNode on real sockets: framed-TCP channels, consensus-backed
    state store (the coordination layer replicates ClusterState.to_dict()),
    an applier thread decoupling commit callbacks from shard work, a join
    loop, and leader-side data-node fault detection.

    Two such nodes form a cluster AND index/search documents together.
    """

    def __init__(self, node_name: str, voting_config: List[str],
                 data_path: Optional[str] = None,
                 roles: Tuple[str, ...] = ("master", "data"),
                 ping_interval: float = 0.5, ping_fail_limit: int = 3,
                 device=None):
        from elasticsearch_tpu_torch.cluster.cluster_service import (
            ClusterFormationService,
        )
        from elasticsearch_tpu_torch.cluster.store import ConsensusStateStore
        from elasticsearch_tpu_torch.transport.channels import TcpNodeChannels

        device = _device.resolve(device)   # before any socket or thread
        transport = TransportService(node_name)
        channels = TcpNodeChannels(node_name, transport)
        self._state_cond = threading.Condition()
        self._pending_state: Optional[dict] = None
        self._stopped = threading.Event()
        initial = ClusterState()
        self.formation = ClusterFormationService(
            node_name, transport, initial.to_dict(), voting_config,
            data_path, on_committed=self._on_state_committed)
        # feed discovered peer addresses to the data-plane channels too
        orig_on_peer = self.formation._on_peer

        def on_peer(name: str, host: str, port: int) -> None:
            orig_on_peer(name, host, port)
            channels.set_address(name, host, port)

        self.formation._on_peer = on_peer
        store = ConsensusStateStore(self.formation)
        super().__init__(node_name, channels, store, data_path=data_path,
                         roles=roles, transport=transport, device=device)
        _register_refresh_handler(self)
        self.ping_interval = ping_interval
        self.ping_fail_limit = ping_fail_limit
        self._threads: List[threading.Thread] = []
        self.bound_port: Optional[int] = None

    # ---- lifecycle ----

    def bind(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self.bound_port = self.transport.bind(host, port)
        self.address = f"{host}:{self.bound_port}"
        return self.bound_port

    def start(self, seed_hosts: Optional[List[Tuple[str, int]]] = None) -> None:
        if self.bound_port is None:
            self.bind()
        self.formation.start(seed_hosts or [])
        for fn in (self._applier_loop, self._join_loop, self._ping_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stopped.set()
        with self._state_cond:
            self._state_cond.notify_all()
        self.formation.stop()
        self.close()

    # ---- state application (commit callback -> applier thread) ----

    def _on_state_committed(self, value: dict) -> None:
        with self._state_cond:
            self._pending_state = value    # coalesce: latest state wins
            self._state_cond.notify_all()

    def _applier_loop(self) -> None:
        while not self._stopped.is_set():
            with self._state_cond:
                while self._pending_state is None \
                        and not self._stopped.is_set():
                    self._state_cond.wait(0.5)
                value, self._pending_state = self._pending_state, None
            if value is None:
                continue
            try:
                cs = ClusterState.from_dict(value)
                self.channels.update_from_state(cs)
                self.apply_state(cs)
            except Exception:  # noqa: BLE001 — applier must survive
                pass

    # ---- join loop: register this node + address with the master ----

    def _join_loop(self) -> None:
        while not self._stopped.is_set():
            state = self.state
            me = state.nodes.get(self.node_name)
            if me is not None and me.address == self.address:
                return
            try:
                self.master_client(
                    "internal:cluster/node/join",
                    {"node": {"node_id": self.node_name,
                              "name": self.node_name,
                              "address": self.address,
                              "roles": list(self.roles)}})
            except Exception:  # noqa: BLE001 — no leader yet; retry
                pass
            self._stopped.wait(0.3)

    # ---- leader-side data-plane fault detection ----

    def _ping_loop(self) -> None:
        failures: Dict[str, int] = {}
        while not self._stopped.is_set():
            self._stopped.wait(self.ping_interval)
            if not self.store.is_master(self.node_name):
                failures.clear()
                continue
            state = self.state
            for nid in list(state.nodes):
                if nid == self.node_name:
                    continue
                try:
                    self.channels.request(nid, "cluster:monitor/nodes/ping",
                                          {})
                    failures.pop(nid, None)
                except Exception:  # noqa: BLE001
                    failures[nid] = failures.get(nid, 0) + 1
                    if failures[nid] >= self.ping_fail_limit:
                        failures.pop(nid, None)
                        try:
                            self.transport.handle(
                                "internal:cluster/node/left",
                                {"nodes": [nid]})
                        except Exception:  # noqa: BLE001
                            pass

    def await_state(self, predicate, timeout: float = 30.0) -> ClusterState:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.state
            if predicate(st):
                return st
            time.sleep(0.05)
        raise TimeoutError(f"[{self.node_name}] cluster state condition "
                           f"not met within {timeout}s")


def form_local_cluster(names: List[str], data_path: Optional[str] = None,
                       roles: Optional[Dict[str, Tuple[str, ...]]] = None,
                       device=None
                       ) -> Tuple[List[ClusterNode], LocalStateStore, "LocalNodeChannels"]:
    """In-process cluster over LocalNodeChannels + LocalStateStore — the
    deterministic harness for spine tests (ref: InternalTestCluster). Every
    node serves on `device`, resolved once (None is the card)."""
    from elasticsearch_tpu_torch.transport.channels import LocalNodeChannels

    device = _device.resolve(device)
    roles = roles or {}
    channels = LocalNodeChannels()
    nodes_meta = {n: DiscoveryNode(node_id=n, name=n, address="",
                                   roles=roles.get(n, ("master", "data")))
                  for n in names}
    initial = ClusterState(master_node_id=names[0], nodes=nodes_meta)
    store = LocalStateStore(initial, master_name=names[0])
    nodes: List[ClusterNode] = []
    for name in names:
        path = f"{data_path}/{name}" if data_path else None
        node = ClusterNode(name, channels, store, data_path=path,
                           roles=roles.get(name, ("master", "data")),
                           device=device)
        _register_refresh_handler(node)
        channels.register(name, node.transport)
        store.add_applier(name, node.apply_state)
        node.shard_service.state = initial
        nodes.append(node)
    return nodes, store, channels
