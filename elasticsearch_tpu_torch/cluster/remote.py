"""Remote-cluster registry + cross-cluster search fan-out.

The reference keeps named remote-cluster connections in
RemoteClusterService (ref: transport/RemoteClusterService.java — seed
nodes, `skip_unavailable`, per-remote connection health) and routes
`remote:index` search patterns through SearchResponseMerger (ref:
action/search/SearchResponseMerger.java + TransportSearchAction's
ccs_minimize_roundtrips path: ONE search RPC per remote, merged at the
coordinator). Here the same seams are:

  * `RemoteClusterService` — named handles onto another cluster's
    `NodeChannels` with per-remote seed nodes. Every RPC is a named
    fault-injection site (`rpc_remote_search` / `rpc_ccr_fetch`) whose
    ``#part`` selector matches the remote CLUSTER alias; failures feed
    per-edge `NodeTransportHealth` circuits keyed ``cluster:node`` and
    retries spend retry-budget tokens
    (``ES_TPU_REMOTE_RETRIES`` x ``ES_TPU_REMOTE_BACKOFF_MS``).
  * `split_expression` — carves ``remote:pattern`` parts out of a comma
    expression; unknown aliases raise (ref:
    NoSuchRemoteClusterException).
  * `cross_cluster_search` — one fan-out leg per remote plus the local
    leg, merged BIT-IDENTICALLY to the local multi-index merge
    (rest/handlers._multi_index_search ordering: stable sort by sort key
    or -score, legs concatenated local-first then remotes by name), with
    the `_clusters` section's partial-results accounting: a dead
    ``skip_unavailable`` remote degrades to ``skipped`` — never a 5xx.

The registry is deliberately channels-shaped, not node-shaped: the same
service serves the standalone REST `Node` and the multi-node
`ClusterNode` (action/search_action.py wires the coordinator side).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common import metrics, tracing
from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuError, IllegalArgumentError,
)
from elasticsearch_tpu_torch.common.faults import transport_fault_point
from elasticsearch_tpu_torch.common.health import NodeTransportHealth
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.threadpool import scheduler
from elasticsearch_tpu_torch.transport.channels import (
    NodeChannels, NodeUnavailableError, RpcTimeoutError,
)

# One search RPC per remote cluster, answered by a coordinator over there
# (ref: ccs_minimize_roundtrips — the remote runs its own full
# query-then-fetch and returns a merged per-cluster response).
ACTION_REMOTE_SEARCH = "indices:data/read/search[cross_cluster]"


class RemoteCluster:
    """One named remote connection: a channels handle into the remote
    cluster plus the seed nodes to address over it."""

    def __init__(self, name: str, channels: NodeChannels, seeds: List[str],
                 skip_unavailable: bool = False):
        if not seeds:
            raise IllegalArgumentError(
                f"remote cluster [{name}] needs at least one seed node")
        self.name = name
        self.channels = channels
        self.seeds = list(seeds)
        self.skip_unavailable = skip_unavailable


class RemoteClusterService:
    """Named remote clusters + the bounded RPC path into them."""

    def __init__(self, node_name: str, overload=None):
        self.node_name = node_name
        self.overload = overload
        self._remotes: Dict[str, RemoteCluster] = {}     # guarded by: _lock
        # per (cluster, node) transport-circuit edges, keyed "cluster:node"
        # so `tpu_coordinator.transport` shows cross-cluster edges next to
        # the intra-cluster ones without name collisions
        self._edges: Dict[Tuple[str, str], NodeTransportHealth] = {}  # guarded by: _lock
        self._lock = threading.Lock()

    # ---------------- registry ----------------

    def register_remote(self, name: str, channels: NodeChannels,
                        seeds: List[str],
                        skip_unavailable: bool = False) -> None:
        if ":" in name or "," in name or not name:
            raise IllegalArgumentError(
                f"invalid remote cluster alias [{name}]")
        with self._lock:
            self._remotes[name] = RemoteCluster(
                name, channels, seeds, skip_unavailable)

    def remove_remote(self, name: str) -> None:
        with self._lock:
            self._remotes.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._remotes)

    def get(self, name: str) -> RemoteCluster:
        with self._lock:
            rc = self._remotes.get(name)
        if rc is None:
            raise IllegalArgumentError(
                f"no such remote cluster: [{name}]")
        return rc

    def split_expression(self, expression: str) \
            -> Tuple[List[str], Dict[str, List[str]]]:
        """Carve ``remote:pattern`` parts out of a comma expression.

        Returns (local_parts, {cluster: [patterns...]}). A ``name:pat``
        part whose prefix is not a registered alias raises — a typo'd
        alias silently searching nothing would be data loss at read time
        (ref: NoSuchRemoteClusterException)."""
        with self._lock:
            known = set(self._remotes)
        local: List[str] = []
        remote: Dict[str, List[str]] = {}
        for part in (expression or "_all").split(","):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                alias, pattern = part.split(":", 1)
                if alias not in known:
                    raise IllegalArgumentError(
                        f"no such remote cluster: [{alias}]")
                remote.setdefault(alias, []).append(pattern or "_all")
            else:
                local.append(part)
        return local, remote

    def has_remote_parts(self, expression: Optional[str]) -> bool:
        """Cheap pre-check so the single-cluster search path pays nothing:
        only expressions containing ':' ever reach split_expression."""
        if not expression or ":" not in expression:
            return False
        with self._lock:
            if not self._remotes:
                return False
        return any(":" in part for part in expression.split(","))

    # ---------------- bounded remote RPC ----------------

    def _edge(self, cluster: str, node: str) -> NodeTransportHealth:
        with self._lock:
            edge = self._edges.get((cluster, node))
            if edge is None:
                edge = NodeTransportHealth(f"{cluster}:{node}")
                self._edges[(cluster, node)] = edge
        return edge

    def request(self, cluster: str, action: str, payload: dict, *,
                site: str, node: Optional[str] = None) -> dict:
        """One RPC into a remote cluster, rotating across its seed nodes.

        Fires the `site` fault point (``#part`` = the cluster alias) once
        per attempt INSIDE the timed worker, so an injected hang surfaces
        as the same `RpcTimeoutError` a wedged remote would
        (``ES_TPU_RPC_TIMEOUT_MS`` floor, as for intra-cluster RPCs).
        Transport failures feed the ``cluster:node`` circuit and retry up
        to ``ES_TPU_REMOTE_RETRIES`` times — each retry spends a
        retry-budget token and waits ``ES_TPU_REMOTE_BACKOFF_MS``."""
        rc = self.get(cluster)
        candidates = [node] if node is not None else list(rc.seeds)
        retries_max = max(0, int(knob("ES_TPU_REMOTE_RETRIES")))
        backoff_s = max(0, int(knob("ES_TPU_REMOTE_BACKOFF_MS"))) / 1000.0
        last_err: Optional[BaseException] = None
        for attempt in range(retries_max + 1):
            target = candidates[attempt % len(candidates)]
            edge = self._edge(cluster, target)
            if attempt > 0:
                if self.overload is not None \
                        and not self.overload.retry_allowed(site):
                    break
                if site == "rpc_remote_search":
                    metrics.counter_add("ccs_remote_retries")
                else:
                    metrics.counter_add("ccr_fetch_retries")
                time.sleep(backoff_s)
            try:
                if not edge.allow_request() and len(candidates) > 1:
                    # quarantined edge: burn this attempt on the next seed
                    # instead (single-seed remotes still get the half-open
                    # probe cadence allow_request() itself admits)
                    raise NodeUnavailableError(
                        f"remote [{cluster}:{target}] circuit open")
                resp = self._bounded(rc, target, action, payload, site,
                                     cluster)
            except (NodeUnavailableError, RpcTimeoutError) as e:
                last_err = e
                edge.record_fault(e)
                if site == "rpc_remote_search":
                    metrics.counter_add("ccs_remote_failures")
                continue
            edge.record_success()
            if self.overload is not None:
                self.overload.note_success()
            return resp
        assert last_err is not None
        raise last_err

    def _bounded(self, rc: RemoteCluster, target: str, action: str,
                 payload: dict, site: str, cluster: str) -> dict:
        """The `_rpc` bound from action/search_action.py, for the
        cross-cluster hop: ES_TPU_RPC_TIMEOUT_MS floors every remote RPC;
        unbounded (0) dispatches directly with no thread hop."""
        floor_ms = float(knob("ES_TPU_RPC_TIMEOUT_MS"))

        def dispatch() -> dict:
            transport_fault_point(site, cluster)
            return rc.channels.request(target, action, payload,
                                       source=self.node_name)

        if floor_ms <= 0:
            return dispatch()
        box: dict = {}

        def run():
            try:
                box["r"] = dispatch()
            except BaseException as e:  # noqa: BLE001 — crosses the thread
                box["e"] = e

        t = threading.Thread(target=run, daemon=True,
                             name=f"rpc[{cluster}:{target}]")
        t.start()
        t.join(floor_ms / 1000.0)
        if t.is_alive():
            raise RpcTimeoutError(
                f"[{action}] to remote [{cluster}:{target}] timed out "
                f"after {floor_ms:.0f}ms")
        if "e" in box:
            raise box["e"]
        return box["r"]

    # ---------------- GET /_remote/info ----------------

    def remote_info(self) -> dict:
        """Per-remote connection snapshot (ref: RestRemoteClusterInfoAction
        response shape). `connected` is probed live against the seeds —
        a reachable node that quibbles about the probe action still counts
        (reachability is the question, not the handler table)."""
        out: Dict[str, dict] = {}
        for name in self.names():
            rc = self.get(name)
            connected = 0
            for seed in rc.seeds:
                try:
                    rc.channels.request(seed, "cluster:monitor/health", {},
                                        source=self.node_name)
                    connected += 1
                except NodeUnavailableError:
                    continue
                except ElasticsearchTpuError:
                    connected += 1
            out[name] = {
                "connected": connected > 0,
                "mode": "seed",
                "seeds": list(rc.seeds),
                "num_nodes_connected": connected,
                "skip_unavailable": rc.skip_unavailable,
            }
        return out

    def stats(self) -> dict:
        """`tpu_ccs` section of GET /_nodes/stats: fan-out counters from
        the central registry plus the cross-cluster transport edges."""
        from elasticsearch_tpu_torch.common.health import CLOSED

        vals = metrics.counter_values()
        with self._lock:
            edges = sorted(self._edges.values(), key=lambda h: h.name)
        return {
            "remote_clusters": self.names(),
            "remote_searches": vals["ccs_remote_searches"],
            "skipped_clusters": vals["ccs_skipped_clusters"],
            "remote_failures": vals["ccs_remote_failures"],
            "remote_retries": vals["ccs_remote_retries"],
            "edges": [dict(e.stats(), name=e.name) for e in edges],
            "open_circuits": sum(1 for e in edges if e.state != CLOSED),
        }

    # ---------------- cross-cluster search ----------------

    def cross_cluster_search(
            self, body: dict, local_parts: List[str],
            remote_groups: Dict[str, List[str]],
            local_search: Callable[[str, dict], dict]) -> dict:
        """Fan out one search leg per cluster and merge.

        Each leg gets the body rewritten to ``from=0, size=from+size``
        (ref: SearchResponseMerger — the global page is cut AFTER the
        merge, so every cluster must offer its full candidate window);
        the final slice plus the stable local-first/-score ordering makes
        a healthy fan-out bit-identical to the local multi-index merge.
        A dead remote with ``skip_unavailable=true`` degrades to a
        `_clusters.skipped` entry — never an error; without it the
        transport error propagates (ref: the reference's fatal default).
        `_trace`/`_sla` ride the payload across the cluster boundary so
        trace spans show where each leg ran."""
        if body.get("aggs") or body.get("aggregations"):
            raise IllegalArgumentError(
                "cross-cluster search does not support aggregations: "
                "per-cluster agg partials do not merge bit-identically "
                "across cluster boundaries yet")
        from_ = int(body.get("from", 0))
        size = int(body.get("size", 10))
        sub = dict(body)
        sub["from"] = 0
        sub["size"] = from_ + size
        legs: List[Tuple[Optional[str], dict]] = []
        details: Dict[str, dict] = {}
        successful = skipped = partial = 0
        total = (1 if local_parts else 0) + len(remote_groups)
        if local_parts:
            r = local_search(",".join(local_parts), sub)
            legs.append((None, r))
            successful += 1
            if self._leg_partial(r):
                partial += 1
            details["(local)"] = {"status": "successful",
                                  "indices": ",".join(local_parts),
                                  "took": r.get("took", 0)}
        for cluster in sorted(remote_groups):
            rc = self.get(cluster)
            pattern = ",".join(remote_groups[cluster])
            payload: dict = {"index": pattern, "body": sub}
            tc = tracing.current()
            if tc is not None:
                payload["_trace"] = tc.wire()
            payload["_sla"] = scheduler.current_tier()
            metrics.counter_add("ccs_remote_searches")
            t0 = time.monotonic()
            try:
                r = self.request(cluster, ACTION_REMOTE_SEARCH, payload,
                                 site="rpc_remote_search")
            except (NodeUnavailableError, RpcTimeoutError) as e:
                if tc is not None:
                    tc.add_span("rpc_remote_search",
                                (time.monotonic() - t0) * 1e3,
                                cluster=cluster, error=type(e).__name__)
                if not rc.skip_unavailable:
                    raise
                metrics.counter_add("ccs_skipped_clusters")
                skipped += 1
                details[cluster] = {
                    "status": "skipped", "indices": pattern,
                    "reason": {"type": getattr(e, "error_type",
                                               type(e).__name__),
                               "reason": str(e)}}
                continue
            if tc is not None:
                tc.add_span("rpc_remote_search",
                            (time.monotonic() - t0) * 1e3, cluster=cluster)
            legs.append((cluster, r))
            successful += 1
            if self._leg_partial(r):
                partial += 1
            details[cluster] = {"status": "partial" if self._leg_partial(r)
                                else "successful",
                                "indices": pattern, "took": r.get("took", 0)}
        merged = merge_leg_responses(legs, from_=from_, size=size,
                                     sort_spec=body.get("sort"))
        merged["_clusters"] = {"total": total, "successful": successful,
                               "skipped": skipped, "partial": partial,
                               "details": details}
        return merged

    @staticmethod
    def _leg_partial(r: dict) -> bool:
        sh = r.get("_shards", {})
        return bool(r.get("timed_out")) or sh.get("failed", 0) > 0


def _sort_directions(sort_spec) -> List[str]:
    """Per-position sort directions from a request's `sort` clause:
    `{"f": {"order": "desc"}}` / `{"f": "desc"}` / `"f:desc"` / `"f"`."""
    dirs: List[str] = []
    for entry in (sort_spec or []):
        if isinstance(entry, str):
            dirs.append("desc" if entry.endswith(":desc") else "asc")
        elif isinstance(entry, dict) and entry:
            v = next(iter(entry.values()))
            order = v.get("order", "asc") if isinstance(v, dict) else v
            dirs.append("desc" if order == "desc" else "asc")
        else:
            dirs.append("asc")
    return dirs


def merge_leg_responses(legs: List[Tuple[Optional[str], dict]],
                        from_: int = 0, size: int = 10,
                        sort_spec=None) -> dict:
    """Merge per-cluster (or per-index) search responses.

    MUST stay ordering-identical to the coordinator's own multi-index
    merge: sum totals, OR timed_out, sum shard counts, max of max_score,
    stable direction-aware sort of the concatenated hits by sort key or
    -score — Python's stable sort preserves leg order on ties, which is
    exactly the local merge's index-arrival tie-break. Remote hits get
    their `_index` qualified ``cluster:index`` (ref: CCS response
    shape) — everything else is byte-for-byte the leg's hit."""
    all_hits: List[dict] = []
    total = 0
    max_score = None
    timed_out = False
    shards = {"total": 0, "successful": 0, "skipped": 0, "failed": 0}
    shard_failures: List[dict] = []
    took = 0
    for alias, r in legs:
        took += r.get("took", 0)
        total += r["hits"]["total"]["value"]
        timed_out = timed_out or bool(r.get("timed_out"))
        sh = r.get("_shards", {})
        for k in shards:
            shards[k] += sh.get(k, 0)
        shard_failures.extend(sh.get("failures", []))
        if r["hits"]["max_score"] is not None:
            max_score = max(max_score if max_score is not None
                            else float("-inf"), r["hits"]["max_score"])
        for h in r["hits"]["hits"]:
            if alias is not None:
                h = dict(h, _index=f"{alias}:{h.get('_index', '')}")
            all_hits.append(h)
    if any(h.get("sort") is not None for h in all_hits):
        import functools

        dirs = _sort_directions(sort_spec)

        def cmp(a: dict, b: dict) -> int:
            ka, kb = a.get("sort", []), b.get("sort", [])
            for i in range(min(len(ka), len(kb))):
                if ka[i] == kb[i]:
                    continue
                r = -1 if ka[i] < kb[i] else 1
                if i < len(dirs) and dirs[i] == "desc":
                    r = -r
                return r
            return len(ka) - len(kb)

        all_hits.sort(key=functools.cmp_to_key(cmp))
    else:
        all_hits.sort(key=lambda h: -(h.get("_score") or 0.0))
    out_shards: dict = dict(shards)
    if shard_failures:
        out_shards["failures"] = shard_failures
    return {
        "took": took,
        "timed_out": timed_out,
        "_shards": out_shards,
        "hits": {"total": {"value": total, "relation": "eq"},
                 "max_score": max_score,
                 "hits": all_hits[from_: from_ + size]},
    }
