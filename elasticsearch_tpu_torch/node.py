"""Node: the composition root (the port's copy of elasticsearch_tpu/node.py).

Re-designs the reference's Node wiring (ref: node/Node.java:278 constructor,
:776 start()) minus the DI ceremony: a Node owns the cluster state, the
indices service, the transport action registry, and the REST controller.
Single-node operation is complete; multi-node control plane attaches via
transport.bind() (the coordination layer registers its own actions).

Differences from the reference:

- ``device``: the node resolves it once (``device.py``: ``None`` is the
  card, ``"cpu"`` only when asked) and hands it to `IndicesService`, so
  every index the node creates serves on that device. Without a card,
  ``Node()`` raises `DeviceUnavailableError`.
- ``GET /_nodes`` lists that device under ``accelerators``, where the
  reference lists its jax devices.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, Optional

from elasticsearch_tpu_torch import device as _device
from elasticsearch_tpu_torch.cluster.state import ClusterState, DiscoveryNode, IndexMetadata, ShardRouting
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.common.breaker import HierarchyCircuitBreakerService
from elasticsearch_tpu_torch.index.index_service import IndicesService
from elasticsearch_tpu_torch.transport.service import TransportService


class Node:
    def __init__(self, settings: Settings | None = None, data_path: Optional[str] = None,
                 node_name: str = "node-0", device=None):
        self.settings = settings or Settings.EMPTY
        self.device = _device.resolve(device)
        self.node_id = uuid.uuid4().hex[:20]
        self.node_name = node_name
        self._state_lock = threading.Lock()
        node = DiscoveryNode(node_id=self.node_id, name=node_name)
        self.cluster_state = ClusterState(
            cluster_name=str(self.settings.raw("cluster.name", "elasticsearch-tpu")),
            master_node_id=self.node_id,
            nodes={self.node_id: node},
        )
        self.breakers = HierarchyCircuitBreakerService()
        from elasticsearch_tpu_torch.common.indexing_pressure import (
            DEFAULT_LIMIT_BYTES, IndexingPressure,
        )

        self.indexing_pressure = IndexingPressure(int(self.settings.raw(
            "indexing_pressure.memory.limit", DEFAULT_LIMIT_BYTES)))
        from elasticsearch_tpu_torch.threadpool import ThreadPool

        # ONE named-executor set per node (ref: ThreadPool.java is a
        # node-level singleton) — the HTTP frontend and any attached
        # services draw their stage workers from the same bounded pools
        self.thread_pool = ThreadPool()
        from elasticsearch_tpu_torch.common.overload import OverloadController
        from elasticsearch_tpu_torch.threadpool import default_scheduler

        # overload control plane (common/overload.py): folds this node's
        # pressure signals for REST admission + retry budgets
        self.overload = OverloadController(
            node_name, thread_pool=self.thread_pool,
            scheduler=default_scheduler(), breakers=self.breakers,
            indexing_pressure=self.indexing_pressure)
        from elasticsearch_tpu_torch.security import SecurityService

        self.security = SecurityService(self.settings)
        from elasticsearch_tpu_torch.common.settings import ClusterSettings, Setting

        # dynamic cluster settings registry (ref: ClusterSettings + the
        # settings ActionModule exposes over /_cluster/settings)
        # every registered setting has a LIVE consumer below — an update
        # API that silently ignores values would be worse than none
        s_keep = Setting("search.default_keep_alive", "5m", str, dynamic=True)
        s_buckets = Setting("search.max_buckets", 65536, int, dynamic=True)
        s_auto = Setting("action.auto_create_index", True,
                         lambda v: str(v).lower() != "false", dynamic=True)
        from elasticsearch_tpu_torch.cluster.allocation import (
            CONCURRENT_RELOC_SETTING, DEFAULT_CONCURRENT_RELOCATIONS,
            EXCLUDE_NAME_SETTING,
        )

        # allocation maintenance settings: the drain filter and the
        # concurrent-relocations cap flow into ClusterState.settings, where
        # AllocationService's deciders read them (a standalone node has
        # nowhere to relocate, but the dynamic seam is the same one a
        # cluster master consumes)
        s_exclude = Setting(EXCLUDE_NAME_SETTING, "", str, dynamic=True)
        s_reloc = Setting(CONCURRENT_RELOC_SETTING,
                          DEFAULT_CONCURRENT_RELOCATIONS, int, dynamic=True)
        self.cluster_settings = ClusterSettings(
            self.settings, [s_keep, s_buckets, s_auto, s_exclude, s_reloc])
        self._persistent_settings: dict = {}
        self._transient_settings: dict = {}
        self.auto_create_index = True
        self.indices = IndicesService(data_path, breakers=self.breakers,
                                      device=self.device)
        from elasticsearch_tpu_torch.index.index_service import parse_keep_alive
        from elasticsearch_tpu_torch.search import aggregations as _aggs

        self.cluster_settings.add_settings_update_consumer(
            s_auto, lambda v: setattr(self, "auto_create_index", v))
        self.cluster_settings.add_settings_update_consumer(
            s_buckets, lambda v: setattr(_aggs, "MAX_BUCKETS", int(v)))
        self.cluster_settings.add_settings_update_consumer(
            s_keep, lambda v: setattr(self.indices.contexts,
                                      "default_keep_alive_s",
                                      parse_keep_alive(v)))
        self.cluster_settings.add_settings_update_consumer(
            s_exclude, lambda v: self.update_state(
                lambda s: s.with_settings({EXCLUDE_NAME_SETTING: str(v)})))
        self.cluster_settings.add_settings_update_consumer(
            s_reloc, lambda v: self.update_state(
                lambda s: s.with_settings(
                    {CONCURRENT_RELOC_SETTING: str(int(v))})))
        self.transport = TransportService(self.node_id)
        from elasticsearch_tpu_torch.tasks import TaskManager

        self.tasks = TaskManager(self.node_id)
        from elasticsearch_tpu_torch.tasks.task_plane import TaskPlane

        # standalone node: the task plane degrades to the local registry
        # (no channels / cluster state), same REST response shapes
        self.task_plane = TaskPlane(
            self.tasks, self.node_name,
            hot_label=f"{{{self.node_name}}}{{{self.node_id}}}")
        from elasticsearch_tpu_torch.cluster.telemetry_plane import TelemetryPlane
        from elasticsearch_tpu_torch.common import metrics as _metrics

        # standalone telemetry plane: local-only stats/scrape; the REST
        # handlers install a richer local_stats_fn (rest/handlers.py)
        self.telemetry_plane = TelemetryPlane(self.node_name)
        _metrics.maybe_start_sampler()
        self._async_searches: Dict[str, dict] = {}
        from elasticsearch_tpu_torch.ingest import IngestService

        self.ingest = IngestService()
        from elasticsearch_tpu_torch.snapshots import SnapshotsService

        self.snapshots = SnapshotsService(
            self.indices, lambda name, body: self.create_index(name, body),
            delete_index=self.delete_index)
        from elasticsearch_tpu_torch.common.integrity import IntegrityScrubber

        # HBM scrub driver (ES_TPU_INTEGRITY_SCRUB_S; 0 = off): walks the
        # registered device regions on the management pool, yields while
        # the overload level is not GREEN
        self.integrity_scrubber = IntegrityScrubber(
            thread_pool=self.thread_pool, overload=self.overload)
        self.integrity_scrubber.start()
        from elasticsearch_tpu_torch.cluster.remote import RemoteClusterService
        from elasticsearch_tpu_torch.index.ccr import CcrService, StandaloneNodeHost

        # cross-cluster plane: remote registry + CCR pull loop; the REST
        # layer routes `remote:index` searches and /_ccr calls through these
        self.remotes = RemoteClusterService(node_name,
                                            overload=self.overload)
        self.ccr = CcrService(StandaloneNodeHost(self), self.remotes,
                              self.transport)
        self._register_actions()

    # ---- cluster-state updates (single-threaded master semantics,
    #      ref: cluster/service/MasterService.java) ----

    def update_state(self, updater) -> ClusterState:
        with self._state_lock:
            self.cluster_state = updater(self.cluster_state)
            return self.cluster_state

    # ---- index lifecycle ----

    def create_index(self, name: str, body: dict | None = None) -> IndexMetadata:
        body = body or {}
        settings = Settings(body.get("settings", {}))
        if settings.raw("index.number_of_shards") is None and settings.raw("number_of_shards") is not None:
            settings = settings.with_updates({"index.number_of_shards": settings.raw("number_of_shards")})
        if settings.raw("index.number_of_replicas") is None and settings.raw("number_of_replicas") is not None:
            settings = settings.with_updates({"index.number_of_replicas": settings.raw("number_of_replicas")})
        mappings = body.get("mappings", {})
        aliases = body.get("aliases", {})
        meta = self.indices.create_index(name, settings, mappings, aliases)
        routing = []
        for shard_id in range(meta.number_of_shards):
            routing.append(ShardRouting(index=name, shard_id=shard_id, node_id=self.node_id,
                                        primary=True, state="STARTED",
                                        allocation_id=uuid.uuid4().hex[:20]))
            for _ in range(meta.number_of_replicas):
                routing.append(ShardRouting(index=name, shard_id=shard_id, node_id=None,
                                            primary=False, state="UNASSIGNED"))
        self.update_state(lambda s: s.with_index(meta, routing))
        return meta

    def delete_index(self, name: str) -> None:
        self.indices.delete_index(name)
        self.update_state(lambda s: s.without_index(name))

    # ---- transport actions (ref: action/ActionModule.java names) ----

    def _register_actions(self) -> None:
        t = self.transport
        t.register_request_handler(
            "cluster:monitor/health", lambda req: self.cluster_state.health())
        t.register_request_handler(
            "indices:data/read/search",
            lambda req: self.indices.get(req.payload["index"]).search(
                req.payload.get("body", {}), req.payload.get("search_type", "query_then_fetch")))
        t.register_request_handler(
            "indices:data/read/get",
            lambda req: self.indices.get(req.payload["index"]).get_doc(req.payload["id"]) or {})
        t.register_request_handler(
            "indices:admin/refresh",
            lambda req: (self.indices.get(req.payload["index"]).refresh(), {"ok": True})[1])
        from elasticsearch_tpu_torch.cluster.remote import ACTION_REMOTE_SEARCH

        t.register_request_handler(ACTION_REMOTE_SEARCH,
                                   self._on_remote_search)

    def _on_remote_search(self, req) -> dict:
        """Answer a remote coordinator's cross-cluster search leg:
        resolve the pattern locally, search each matching index, merge to
        one well-formed response under the caller's trace/SLA context."""
        from elasticsearch_tpu_torch.cluster.remote import merge_leg_responses
        from elasticsearch_tpu_torch.common import tracing
        from elasticsearch_tpu_torch.threadpool import scheduler

        p = req.payload
        body = dict(p.get("body") or {})
        tc = tracing.child_from_wire(p.get("_trace"), node=self.node_name,
                                     kind="remote_search")
        with tracing.activate(tc), scheduler.activate_tier(p.get("_sla")):
            names = self.cluster_state.resolve_indices(
                p.get("index") or "_all")
            legs = [(None, self.indices.get(n).search(dict(body)))
                    for n in names]
            return merge_leg_responses(
                legs, from_=0, size=int(body.get("size", 10) or 10),
                sort_spec=body.get("sort"))

    def close(self) -> None:
        self.ccr.stop()
        self.integrity_scrubber.stop()
        self.indices.close()
        self.transport.close()
        self.thread_pool.shutdown()
