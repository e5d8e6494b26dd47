"""Immutable cluster state model.

Re-designs the reference's ClusterState/Metadata/IndexMetadata/RoutingTable
(ref: cluster/ClusterState.java, cluster/metadata/Metadata.java:1609,
IndexMetadata.java, cluster/routing/RoutingTable.java) as frozen dataclasses
with copy-on-write updaters. State changes go through a single-threaded
master task queue (cluster/service/MasterService.java analog lives in
cluster/coordination.py) and are versioned; appliers react to diffs.

The port's copy of elasticsearch_tpu/cluster/state.py; its code differs only
in the imports.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.common.settings import Settings


@dataclass(frozen=True)
class DiscoveryNode:
    node_id: str
    name: str
    address: str = "127.0.0.1:9300"
    roles: tuple = ("master", "data", "ingest")

    def to_dict(self) -> dict:
        return {"node_id": self.node_id, "name": self.name,
                "address": self.address, "roles": list(self.roles)}

    @staticmethod
    def from_dict(d: dict) -> "DiscoveryNode":
        return DiscoveryNode(node_id=d["node_id"], name=d["name"],
                             address=d.get("address", ""),
                             roles=tuple(d.get("roles", ())))


@dataclass(frozen=True)
class ShardRouting:
    """Ref: cluster/routing/ShardRouting.java — one shard copy's assignment."""

    index: str
    shard_id: int
    node_id: Optional[str]
    primary: bool
    state: str = "STARTED"     # UNASSIGNED | INITIALIZING | STARTED | RELOCATING
    allocation_id: str = ""
    # relocation linkage (ref: ShardRouting.relocatingNodeId): on the
    # RELOCATING source this names the target node; on the INITIALIZING
    # target it names the source node.
    relocating_node_id: Optional[str] = None
    # delayed allocation (ref: UnassignedInfo.delayed): an UNASSIGNED
    # replacement left behind by node-left is not allocatable before this
    # wall-clock deadline, giving the bounced node a window to rejoin.
    delayed_until_ms: Optional[int] = None
    # the node that last held this copy — a rejoining node reclaims its
    # own delayed copies instead of triggering a copy storm
    last_node_id: Optional[str] = None

    @property
    def serving(self) -> bool:
        """A copy that answers reads: STARTED, or a RELOCATING source that
        keeps serving until the target takes over."""
        return self.state in ("STARTED", "RELOCATING")

    def to_dict(self) -> dict:
        d = {"index": self.index, "shard_id": self.shard_id,
             "node_id": self.node_id, "primary": self.primary,
             "state": self.state, "allocation_id": self.allocation_id}
        if self.relocating_node_id is not None:
            d["relocating_node_id"] = self.relocating_node_id
        if self.delayed_until_ms is not None:
            d["delayed_until_ms"] = self.delayed_until_ms
        if self.last_node_id is not None:
            d["last_node_id"] = self.last_node_id
        return d

    @staticmethod
    def from_dict(d: dict) -> "ShardRouting":
        return ShardRouting(index=d["index"], shard_id=d["shard_id"],
                            node_id=d.get("node_id"), primary=d["primary"],
                            state=d.get("state", "STARTED"),
                            allocation_id=d.get("allocation_id", ""),
                            relocating_node_id=d.get("relocating_node_id"),
                            delayed_until_ms=d.get("delayed_until_ms"),
                            last_node_id=d.get("last_node_id"))


@dataclass(frozen=True)
class IndexMetadata:
    index: str
    uuid: str
    settings: Settings
    mappings: dict
    aliases: Dict[str, dict] = field(default_factory=dict)
    state: str = "open"
    creation_date: int = field(default_factory=lambda: int(time.time() * 1000))
    version: int = 1
    # per-shard primary terms, bumped on every primary failover (ref:
    # IndexMetadata.primaryTerm — the fencing token replicas check)
    primary_terms: tuple = ()
    # per-shard in-sync allocation ids (ref: IndexMetadata
    # in_sync_allocations — the copies a promoted primary may come from)
    in_sync_allocations: Dict[int, tuple] = field(default_factory=dict)

    @property
    def number_of_shards(self) -> int:
        return int(self.settings.raw("index.number_of_shards", 1))

    @property
    def number_of_replicas(self) -> int:
        return int(self.settings.raw("index.number_of_replicas", 1))

    def primary_term(self, shard_id: int) -> int:
        if shard_id < len(self.primary_terms):
            return self.primary_terms[shard_id]
        return 1

    def with_primary_term_bump(self, shard_id: int) -> "IndexMetadata":
        terms = list(self.primary_terms) or [1] * self.number_of_shards
        while len(terms) <= shard_id:
            terms.append(1)
        terms[shard_id] += 1
        return replace(self, version=self.version + 1, primary_terms=tuple(terms))

    def with_in_sync(self, shard_id: int, allocation_ids: tuple) -> "IndexMetadata":
        in_sync = dict(self.in_sync_allocations)
        in_sync[shard_id] = tuple(allocation_ids)
        return replace(self, version=self.version + 1, in_sync_allocations=in_sync)

    def to_dict(self) -> dict:
        return {"index": self.index, "uuid": self.uuid,
                "settings": self.settings.as_dict(), "mappings": self.mappings,
                "aliases": self.aliases, "state": self.state,
                "creation_date": self.creation_date, "version": self.version,
                "primary_terms": list(self.primary_terms),
                "in_sync_allocations": {str(k): list(v) for k, v in
                                        self.in_sync_allocations.items()}}

    @staticmethod
    def from_dict(d: dict) -> "IndexMetadata":
        return IndexMetadata(
            index=d["index"], uuid=d["uuid"], settings=Settings(d["settings"]),
            mappings=d.get("mappings", {}), aliases=d.get("aliases", {}),
            state=d.get("state", "open"),
            creation_date=d.get("creation_date", 0),
            version=d.get("version", 1),
            primary_terms=tuple(d.get("primary_terms", ())),
            in_sync_allocations={int(k): tuple(v) for k, v in
                                 d.get("in_sync_allocations", {}).items()})


@dataclass(frozen=True)
class ClusterState:
    cluster_name: str = "elasticsearch-tpu"
    version: int = 0
    term: int = 0
    master_node_id: Optional[str] = None
    nodes: Dict[str, DiscoveryNode] = field(default_factory=dict)
    indices: Dict[str, IndexMetadata] = field(default_factory=dict)
    routing: Dict[str, List[ShardRouting]] = field(default_factory=dict)
    # cluster-wide persistent settings (ref: Metadata persistentSettings) —
    # allocation filters like cluster.routing.allocation.exclude._name live
    # here so every master sees the same drain intent
    settings: Dict[str, str] = field(default_factory=dict)

    # ---- functional updaters ----

    def with_settings(self, updates: Dict[str, Optional[str]]) -> "ClusterState":
        merged = dict(self.settings)
        for k, v in updates.items():
            if v is None or v == "":
                merged.pop(k, None)
            else:
                merged[k] = str(v)
        return replace(self, version=self.version + 1, settings=merged)

    def with_index(self, meta: IndexMetadata, routing: List[ShardRouting]) -> "ClusterState":
        indices = dict(self.indices)
        indices[meta.index] = meta
        rt = dict(self.routing)
        rt[meta.index] = routing
        return replace(self, version=self.version + 1, indices=indices, routing=rt)

    def without_index(self, index: str) -> "ClusterState":
        indices = dict(self.indices)
        indices.pop(index, None)
        rt = dict(self.routing)
        rt.pop(index, None)
        return replace(self, version=self.version + 1, indices=indices, routing=rt)

    def with_node(self, node: DiscoveryNode) -> "ClusterState":
        nodes = dict(self.nodes)
        nodes[node.node_id] = node
        return replace(self, version=self.version + 1, nodes=nodes)

    def without_node(self, node_id: str) -> "ClusterState":
        nodes = dict(self.nodes)
        nodes.pop(node_id, None)
        master = self.master_node_id if self.master_node_id != node_id else None
        return replace(self, version=self.version + 1, nodes=nodes,
                       master_node_id=master)

    def with_routing_updates(self, index: str,
                             entries: List[ShardRouting]) -> "ClusterState":
        rt = dict(self.routing)
        rt[index] = entries
        return replace(self, version=self.version + 1, routing=rt)

    def with_index_metadata(self, meta: IndexMetadata) -> "ClusterState":
        indices = dict(self.indices)
        indices[meta.index] = meta
        return replace(self, version=self.version + 1, indices=indices)

    def shard_copies(self, index: str, shard_id: int) -> List[ShardRouting]:
        return [r for r in self.routing.get(index, []) if r.shard_id == shard_id]

    def primary_of(self, index: str, shard_id: int) -> Optional[ShardRouting]:
        # during primary relocation two entries carry the primary flag
        # (RELOCATING source + INITIALIZING target); the serving one is
        # authoritative for writes until the swap commits
        best: Optional[ShardRouting] = None
        for r in self.routing.get(index, []):
            if r.shard_id == shard_id and r.primary:
                if r.serving:
                    return r
                if best is None:
                    best = r
        return best

    def entries_on_node(self, node_id: str) -> List[ShardRouting]:
        return [r for shards in self.routing.values() for r in shards
                if r.node_id == node_id]

    def node_by_name(self, name: str) -> Optional[DiscoveryNode]:
        for n in self.nodes.values():
            if n.name == name:
                return n
        return None

    # ---- wire form (the consensus-replicated value) ----

    def to_dict(self) -> dict:
        return {
            "cluster_name": self.cluster_name,
            "version": self.version,
            "term": self.term,
            "master_node_id": self.master_node_id,
            "nodes": {nid: n.to_dict() for nid, n in self.nodes.items()},
            "indices": {name: m.to_dict() for name, m in self.indices.items()},
            "routing": {name: [r.to_dict() for r in shards]
                        for name, shards in self.routing.items()},
            "settings": dict(self.settings),
        }

    @staticmethod
    def from_dict(d: dict) -> "ClusterState":
        return ClusterState(
            cluster_name=d.get("cluster_name", "elasticsearch-tpu"),
            version=d.get("version", 0),
            term=d.get("term", 0),
            master_node_id=d.get("master_node_id"),
            nodes={nid: DiscoveryNode.from_dict(n)
                   for nid, n in d.get("nodes", {}).items()},
            indices={name: IndexMetadata.from_dict(m)
                     for name, m in d.get("indices", {}).items()},
            routing={name: [ShardRouting.from_dict(r) for r in shards]
                     for name, shards in d.get("routing", {}).items()},
            settings=dict(d.get("settings", {})),
        )

    def resolve_indices(self, expression: str) -> List[str]:
        """Index-name expression resolution: names, aliases, wildcards, _all
        (ref: cluster/metadata/IndexNameExpressionResolver.java)."""
        import fnmatch

        if expression in ("_all", "*", ""):
            return sorted(self.indices)
        out: List[str] = []
        for part in expression.split(","):
            part = part.strip()
            if not part:
                continue
            matched = False
            if "*" in part or "?" in part:
                for name in sorted(self.indices):
                    if fnmatch.fnmatchcase(name, part) and name not in out:
                        out.append(name)
                        matched = True
                if not matched:
                    matched = True  # wildcard with no match is not an error
            else:
                if part in self.indices:
                    out.append(part)
                    matched = True
                else:
                    for name, meta in self.indices.items():
                        if part in meta.aliases and name not in out:
                            out.append(name)
                            matched = True
        return out

    def health(self, now_ms: Optional[int] = None) -> dict:
        """Ref: cluster health computation — green/yellow/red from routing.

        RELOCATING sources still serve reads and writes, so they count as
        active; red means some shard has NO serving primary (neither
        STARTED nor RELOCATING)."""
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        active_primary = 0
        active = 0
        unassigned = 0
        initializing = 0
        relocating = 0
        delayed = 0
        served: Dict[Any, bool] = {}
        for index, shards in self.routing.items():
            for s in shards:
                key = (index, s.shard_id)
                served.setdefault(key, False)
                if s.state == "RELOCATING":
                    relocating += 1
                if s.serving:
                    active += 1
                    if s.primary:
                        active_primary += 1
                        served[key] = True
                elif s.state == "INITIALIZING":
                    # a relocation target is the move's other half — the
                    # RELOCATING source already counts as active, so the
                    # target neither drives yellow nor inflates totals
                    if s.relocating_node_id is None:
                        initializing += 1
                else:
                    unassigned += 1
                    if (s.delayed_until_ms is not None
                            and s.delayed_until_ms > now_ms):
                        delayed += 1
        if any(not ok for ok in served.values()):
            status = "red"
        elif unassigned or initializing:
            status = "yellow"
        else:
            status = "green"
        total = active + unassigned + initializing
        return {
            "cluster_name": self.cluster_name,
            "status": status,
            "timed_out": False,
            "number_of_nodes": len(self.nodes),
            "number_of_data_nodes": sum(1 for n in self.nodes.values() if "data" in n.roles),
            "active_primary_shards": active_primary,
            "active_shards": active,
            "relocating_shards": relocating,
            "initializing_shards": initializing,
            "unassigned_shards": unassigned,
            "delayed_unassigned_shards": delayed,
            "number_of_pending_tasks": 0,
            "number_of_in_flight_fetch": 0,
            "task_max_waiting_in_queue_millis": 0,
            "active_shards_percent_as_number": (100.0 * active / total) if total else 100.0,
        }
