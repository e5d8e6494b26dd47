"""Distributed search: query-then-fetch scatter-gather over the transport.

Re-designs the reference's search coordination (ref:
action/search/AbstractSearchAsyncAction.java:188 per-shard query fan-out,
action/search/FetchSearchPhase.java:94 fetch of winning docs from owning
shards, action/search/SearchPhaseController.java:397 reduced merge;
SearchTransportService.java:70 action names). The per-shard executor is the
device path (the serving engines, else query_phase over the shard's
segments); this module is the host control plane moving ids and scores
between nodes.

Wire format: shard query results serialize hits as plain dicts; aggregation
partials (numpy-bearing monoid objects) travel through the DATA-ONLY tagged
codec (common/wire.py — deserialization never executes code), the same
principle the reference applies with its named-writeable registry.

Coordinator memory is BOUNDED (ref:
action/search/QueryPhaseResultConsumer.java:52,96): shard results reduce
incrementally every `batched_reduce_size` arrivals — hit windows truncate
to from+size and aggregation partials fold into one — with the pending
partials' byte estimate reserved on the coordinator's request breaker.

Shard FAILOVER (ref: AbstractSearchAsyncAction.onShardFailure ->
performPhaseOnShard(nextShard)): a shard-query failure retries the shard on
the next-best STARTED copy — excluded-node tracking, bounded by
``ES_TPU_SEARCH_SHARD_RETRIES`` — and the shard only counts failed when
every copy is exhausted, with per-shard reasons in `_shards.failures`.
Consecutive transport failures to a node open a `NodeTransportHealth`
circuit (common/health.py) that replica routing skips; the request
`timeout` travels in the shard payload and bounds each RPC
(``ES_TPU_RPC_TIMEOUT_MS`` floor) so a hung node yields `timed_out: true`
partials at the coordinator instead of wedging the pool.

The port's copy of elasticsearch_tpu/action/search_action.py. Each data
node answers its shard's query phase on the port's `ServingContext`, on
the shard engine's device (the node's). One difference: the port's kernel
errors (`KernelBuildError`, `KernelLaunchError`) are never served around.
The reference re-runs a failed fast path on the dense executor and fails
a shard over to another copy or into `_shards.failed`; here a kernel error
leaves the shard query, crosses the transport with its type and fails
the search.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import (
    CircuitBreakingError, ElasticsearchTpuError, IndexNotFoundError,
    KernelBuildError, KernelLaunchError, SearchPhaseExecutionError,
)
from elasticsearch_tpu_torch.cluster.remote import ACTION_REMOTE_SEARCH
from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.common import metrics, tracing
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.indices.shard_service import DistributedShardService
from elasticsearch_tpu_torch.search.fetch_phase import execute_fetch_phase
from elasticsearch_tpu_torch.search.query_phase import (
    QuerySearchResult, ShardHit, _sort_key, execute_query_phase, parse_sort,
)
from elasticsearch_tpu_torch.search.reader_context import ReaderContextRegistry
from elasticsearch_tpu_torch.tasks import task_manager as _taskmgr
from elasticsearch_tpu_torch.threadpool import scheduler
from elasticsearch_tpu_torch.transport.channels import (
    NodeChannels, NodeUnavailableError, RpcTimeoutError,
)
from elasticsearch_tpu_torch.transport.service import TransportService

ACTION_QUERY = "indices:data/read/search[phase/query]"
ACTION_FETCH = "indices:data/read/search[phase/fetch/id]"
ACTION_FREE = "indices:data/read/search[free_context]"
ACTION_CAN_MATCH = "indices:data/read/search[can_match]"
_PRE_FILTER_SHARD_SIZE = 4   # ref default is 128; our clusters are smaller
# errors that fail the request outright: never a failover candidate
_REQUEST_ERRORS = (CircuitBreakingError, KernelBuildError, KernelLaunchError)


# ---- coordinator resilience counters (node-wide; `tpu_coordinator`
#      section of GET /_nodes/stats) ----

_COORD_LOCK = threading.Lock()
_COORD_COUNTERS: Dict[str, int] = {  # guarded by: _COORD_LOCK
    "shard_retries": 0,        # failover attempts on a next-best copy
    "node_circuit_open": 0,    # candidates skipped on an open node circuit
    "rpc_timeouts": 0,         # RPCs abandoned past their deadline
    "fetch_failures": 0,       # shards dropped in the fetch phase
    "can_match_reroutes": 0,   # pre-filter targets demoted as unreachable
    "deadline_expired": 0,     # shards not attempted: request deadline hit
    "overload_reroutes": 0,    # rankings where a pressured copy was demoted
}


def _count_coord(key: str, n: int = 1) -> None:
    with _COORD_LOCK:
        _COORD_COUNTERS[key] += n


def coordinator_stats() -> dict:
    """`tpu_coordinator` stats: resilience counters + transport circuits."""
    from elasticsearch_tpu_torch.common.health import node_transport_health_stats

    with _COORD_LOCK:
        out: dict = dict(_COORD_COUNTERS)
    out["transport"] = node_transport_health_stats()
    return out


def _is_transport_error(e: BaseException) -> bool:
    """Transport-level failures feed the node circuit; application errors
    from a reachable node (parse errors, missing shard) do not."""
    return isinstance(e, (NodeUnavailableError, RpcTimeoutError))


@dataclasses.dataclass
class _ShardTarget:
    """One shard to query, with its failover candidates in routing order."""

    index: str
    sid: int
    candidates: List[str]      # STARTED copy holders, best first


def _py(v):
    """numpy scalar -> python for JSON transport."""
    if hasattr(v, "item"):
        return v.item()
    return v


def _merge_suggests(parts: List[dict]) -> dict:
    """Coordinator-side suggest merge (ref: SearchPhaseController
    mergeSuggest): entries align positionally (every shard analyzed the
    same text), options dedupe by (text, _id) — term frequencies SUM
    across shards, scores keep the max — and re-rank."""
    out: Dict[str, list] = {}
    names = {n for p in parts for n in p}
    for name in sorted(names):
        entries: List[dict] = []
        cap = 0
        for p in parts:
            for i, e in enumerate(p.get(name) or []):
                cap = max(cap, len(e["options"]))
                if i >= len(entries):
                    entries.append({k: v for k, v in e.items()
                                    if k != "options"} | {"options": []})
                entries[i]["options"].extend(e["options"])
        for e in entries:
            by_key: Dict[tuple, dict] = {}
            for o in e["options"]:
                key = (o.get("text"), o.get("_id"))
                cur = by_key.get(key)
                if cur is None:
                    by_key[key] = dict(o)
                elif "freq" in o:
                    cur["freq"] = cur.get("freq", 0) + o["freq"]
                    cur["score"] = max(cur["score"], o["score"])
                else:
                    cur["score"] = max(cur["score"], o["score"])
            e["options"] = sorted(
                by_key.values(),
                key=lambda o: (-o.get("score", 0.0), -o.get("freq", 0),
                               o.get("text", "")))[: max(cap, 1)]
        out[name] = entries
    return out


class _QueryPhaseResultConsumer:
    """Bounded incremental coordinator reduce (ref P6;
    action/search/QueryPhaseResultConsumer.java:52,96): shard results fold
    every `batched_reduce_size` arrivals, so coordinator memory holds at
    most batch x (hits + one agg partial) regardless of shard count, and
    pending aggregation partials are accounted on the request breaker."""

    def __init__(self, body: dict, sort, k: int, breaker=None):
        self.body = body
        self.sort = sort
        self.k = k
        self.collapse = (body.get("collapse") or {}).get("field")
        self.batch = max(2, int(body.get("batched_reduce_size", 512)))
        self.breaker = breaker
        self.window: List[Tuple[int, dict]] = []    # sorted, <= k
        self._pend_hits: List[Tuple[int, dict]] = []
        self._pend_aggs: List = []
        self.agg_state = None
        self.total = 0
        self.relation = "eq"
        self._reserved = 0
        self._n_pending = 0
        self.n_reduce_steps = 0

    def consume(self, si: int, resp: dict) -> None:
        from elasticsearch_tpu_torch.common.wire import wire_size_estimate

        self.total += resp["total"]
        if resp["relation"] == "gte":
            self.relation = "gte"
        self._pend_hits.extend((si, h) for h in resp["hits"])
        if resp.get("aggs") is not None:
            est = wire_size_estimate(resp["aggs"])
            if self.breaker is not None:
                self.breaker.add_estimate_bytes_and_maybe_break(
                    est, "<reduce_aggs>")
            self._reserved += est
            self._pend_aggs.append(resp["aggs"])
        self._n_pending += 1
        if self._n_pending >= self.batch:
            self._reduce_step()

    def _key(self, t):
        si, h = t
        if self.sort:
            return _sort_key(
                ShardHit(h["leaf_idx"], h["ord"], h["score"],
                         h["global_ord"], h["sort_values"]),
                self.sort) + (si, h["global_ord"])
        return (-h["score"], si, h["global_ord"])

    def _reduce_step(self) -> None:
        if self._pend_hits:
            allh = self.window + self._pend_hits
            allh.sort(key=self._key)
            if self.collapse:
                seen = set()
                out = []
                for t in allh:
                    v = t[1].get("collapse")
                    if v is not None:
                        key = (type(v).__name__, v)
                        if key in seen:
                            continue
                        seen.add(key)
                    out.append(t)
                    if len(out) >= self.k:
                        break
                allh = out
            self.window = allh[: self.k]
            self._pend_hits = []
        if self._pend_aggs:
            from elasticsearch_tpu_torch.common.wire import decode_value
            from elasticsearch_tpu_torch.search.aggregations import (
                parse_aggs, reduce_partials,
            )

            spec = (self.body.get("aggs")
                    or self.body.get("aggregations") or {})
            aggs, _ = parse_aggs(spec)
            parts = [decode_value(x) for x in self._pend_aggs]
            if self.agg_state is not None:
                parts.append(self.agg_state)
            self.agg_state = reduce_partials(aggs, parts)
            self._pend_aggs = []
            if self.breaker is not None and self._reserved:
                self.breaker.release(self._reserved)
            self._reserved = 0
        self._n_pending = 0
        self.n_reduce_steps += 1

    def finish(self):
        """(window [(si, hit)], reduced agg state)."""
        self._reduce_step()
        if self.breaker is not None and self._reserved:
            self.breaker.release(self._reserved)
            self._reserved = 0
        return self.window, self.agg_state

    def release(self) -> None:
        """Error-path cleanup: drop the pending agg reservation without
        reducing (ref: QueryPhaseResultConsumer implements Releasable so the
        breaker bytes never outlive the request)."""
        if self.breaker is not None and self._reserved:
            self.breaker.release(self._reserved)
        self._reserved = 0
        self._pend_aggs = []


class SearchActionService:
    """Shard-level query/fetch handlers + the coordinator entrypoint."""

    def __init__(self, transport: TransportService, channels: NodeChannels,
                 shard_service: DistributedShardService, breakers=None,
                 thread_pool=None, tasks=None, overload=None, remotes=None):
        from elasticsearch_tpu_torch.common.breaker import (
            HierarchyCircuitBreakerService,
        )
        from elasticsearch_tpu_torch.threadpool import ThreadPool

        self.channels = channels
        self.shards = shard_service
        # node TaskManager (tasks/task_manager.py): shard query/fetch
        # handlers register child tasks under the coordinator's
        # `_parent_task` payload field when wired
        self.tasks = tasks
        self.breakers = breakers or HierarchyCircuitBreakerService()
        self.contexts = ReaderContextRegistry()
        # shard query/fetch phases run on the node's SEARCH pool —
        # bounded and isolated from the write stage (a worker of the
        # same pool re-enters inline, so a coordinator running on a
        # search worker serves its local shards without self-deadlock)
        self.thread_pool = thread_pool or ThreadPool()
        transport.register_request_handler(
            ACTION_QUERY,
            lambda req: self.thread_pool.execute(
                "search", self._on_shard_query, req))
        transport.register_request_handler(
            ACTION_FETCH,
            lambda req: self.thread_pool.execute(
                "search", self._on_shard_fetch, req))
        transport.register_request_handler(ACTION_FREE, self._on_free_context)
        transport.register_request_handler(ACTION_CAN_MATCH,
                                           self._on_can_match)
        # cross-cluster plane: the registry of named remote
        # clusters this coordinator may fan out to, and the handler that
        # answers a REMOTE coordinator's one-RPC-per-cluster search leg
        self.remotes = remotes
        transport.register_request_handler(ACTION_REMOTE_SEARCH,
                                           self._on_remote_search)
        # adaptive replica selection state: EWMA of per-node shard-query
        # service time (ref: OperationRouting.java:34 rankShardsAndUpdateStats
        # / ResponseCollectorService)
        self._node_ewma_ms: Dict[str, float] = {}
        # per-target-node transport circuits (common/health.py): consecutive
        # transport failures quarantine the node from replica routing until
        # a half-open probe readmits it
        self._node_health: Dict[str, "NodeTransportHealth"] = {}
        # overload controller (common/overload.py): transport admission on
        # the data-node side, retry budget + piggybacked peer pressure on
        # the coordinator side
        self.overload = overload
        # node -> (level, monotonic ts) from `_overload` piggybacks
        self._node_pressure: Dict[str, tuple] = {}

    def _overload(self):
        if self.overload is None:
            from elasticsearch_tpu_torch.common.overload import default_overload

            self.overload = default_overload()
        return self.overload

    # ---------------- shard-level handlers (data node) ----------------

    class _ShardView:
        """IndexService-shaped adapter over one ShardInstance so the
        serving fast path (search/serving.ServingContext) runs per shard,
        on the shard engine's device."""

        def __init__(self, inst):
            self.shards = [inst.engine]
            self.mapper = inst.mapper
            self.name = inst.index
            self.device = inst.engine.device

    def _shard_serving(self, inst):
        ctx = getattr(inst, "_serving_ctx", None)
        if ctx is None:
            from elasticsearch_tpu_torch.search.serving import ServingContext

            ctx = ServingContext(self._ShardView(inst))
            inst._serving_ctx = ctx
        return ctx

    def _shard_slowlog(self, phase: str, index: str, shard_id, took_ms: float,
                       body: dict, tc) -> None:
        """Data-node slowlog: check this shard's phase timing against the
        index's effective thresholds (cluster-state settings) and append a
        structured record when over."""
        meta = self.shards.state.indices.get(index)
        if meta is None:
            return
        th = tracing.slowlog_thresholds(meta.settings).get(phase) or {}
        level = tracing.slowlog_check(phase, took_ms, th)
        if level is not None:
            tracing.slowlog_record(
                phase, level, index, took_ms,
                source=body.get("query"), node=self.shards.node_name,
                shard=shard_id, tc=tc)

    def _on_shard_query(self, req) -> dict:
        p = req.payload
        self._admit_shard_request(p, f"[{p['index']}][{p['shard_id']}]")
        tc = tracing.child_from_wire(p.get("_trace"),
                                     node=self.shards.node_name,
                                     kind="shard_query")
        child = self._register_child(ACTION_QUERY, p, tc)
        t0 = time.monotonic()
        try:
            with tracing.activate(tc), \
                    scheduler.activate_tier(p.get("_sla")), \
                    _taskmgr.activate(child):
                if child is not None:
                    # ban raced this registration: die before any dispatch
                    child.check()
                    child.note_dispatch(phase="query")
                out = self._shard_query_inner(req)
        finally:
            if child is not None:
                self.tasks.unregister(child)
        q_ms = (time.monotonic() - t0) * 1e3
        metrics.observe("query", q_ms)
        if tc is not None:
            tc.add_span("query", q_ms, index=p["index"], shard=p["shard_id"])
            tracing.record_trace(tc)
            out["_trace_spans"] = tc.span_dicts()
        self._shard_slowlog("query", p["index"], p["shard_id"], q_ms,
                            p["body"], tc)
        ov = self.overload
        if ov is not None:
            # pressure propagation: piggyback this data node's level on
            # the response payload (popped by the coordinator, never
            # surfaced in a body) so ARS can route around brownout
            out["_overload"] = ov.stats()["level"]
        return out

    def _admit_shard_request(self, p: dict, where: str) -> None:
        """Transport-side admission (data node): the coordinator's `_sla`
        tier rides the payload; bulk-tier shard work sheds at YELLOW,
        interactive at RED. A shed raises 429 back through the RPC — the
        coordinator fails over to a less-loaded copy."""
        ov = self.overload
        if ov is None:
            return
        tier = p.get("_sla") or scheduler.TIER_INTERACTIVE
        retry_after = ov.admit(tier)
        if retry_after is None:
            return
        from elasticsearch_tpu_torch.threadpool import EsRejectedExecutionError

        raise EsRejectedExecutionError(
            f"[{self.shards.node_name}] overload shed "
            f"({ov.stats()['level']}): {tier}-tier shard request {where}",
            node=self.shards.node_name, tier=tier,
            retry_after_s=retry_after)

    def _shard_query_inner(self, req) -> dict:
        p = req.payload
        inst = self.shards.get_shard(p["index"], p["shard_id"])
        searcher = inst.engine.acquire_searcher()
        # shard-level serving fast path: each data node serves its shard
        # on its own Turbo/BlockMax engine, shard-local stats, coordinator
        # fetch/reduce unchanged
        qr: QuerySearchResult | None = None
        if not knob("ES_TPU_DISABLE_SHARD_SERVING"):
            try:
                qr = self._shard_serving(inst).try_query_phase(p["body"])
            except (KernelBuildError, KernelLaunchError):
                raise
            except Exception:  # noqa: BLE001 — fast path never fails a query
                qr = None
        if qr is None:
            qr = execute_query_phase(searcher, inst.mapper, p["body"])
        ctx = self.contexts.create(searcher, inst.mapper, p["index"],
                                   p["shard_id"])
        collapse_field = (p["body"].get("collapse") or {}).get("field")
        hits_wire = []
        for h in qr.hits:
            wh = {"leaf_idx": h.leaf_idx, "ord": h.ord,
                  "score": _py(h.score), "global_ord": h.global_ord,
                  "sort_values": [_py(v) for v in h.sort_values]
                  if h.sort_values is not None else None}
            if collapse_field:
                from elasticsearch_tpu_torch.search.query_phase import collapse_value

                wh["collapse"] = _py(collapse_value(
                    searcher.views[h.leaf_idx].segment, h.ord, collapse_field))
            hits_wire.append(wh)
        aggs_wire = None
        if qr.aggregations is not None:
            from elasticsearch_tpu_torch.common.wire import encode_value

            aggs_wire = encode_value(qr.aggregations)
        suggest_out = None
        if p["body"].get("suggest") is not None:
            from elasticsearch_tpu_torch.search.suggest import execute_suggest

            suggest_out = execute_suggest(searcher.views, inst.mapper,
                                          p["body"]["suggest"])
        return {"total": qr.total, "relation": qr.relation,
                "max_score": _py(qr.max_score), "hits": hits_wire,
                "context_id": ctx.context_id, "aggs": aggs_wire,
                "suggest": suggest_out, "profile": qr.profile,
                "timed_out": bool(getattr(qr, "timed_out", False))}

    def _register_child(self, action: str, p: dict, tc):
        """Shard-side child task linked by the coordinator's `_parent_task`
        payload field (next to `_trace`/`_sla` — never in the body, which
        would break extract_plan's allowed-keys fast path). Returns None
        when the node has no TaskManager wired or no parent was sent."""
        if self.tasks is None or not p.get("_parent_task"):
            return None
        where = f"[{p['index']}][{p['shard_id']}]" if "index" in p \
            else f"[ctx {p.get('context_id')}]"
        return self.tasks.register(
            action, f"shard {where}", parent_task_id=p["_parent_task"],
            trace_id=tc.trace_id if tc is not None else None,
            sla=p.get("_sla"))

    def _on_shard_fetch(self, req) -> dict:
        p = req.payload
        tc = tracing.child_from_wire(p.get("_trace"),
                                     node=self.shards.node_name,
                                     kind="shard_fetch")
        child = self._register_child(ACTION_FETCH, p, tc)
        ctx = self.contexts.get(p["context_id"])
        hits = [ShardHit(leaf_idx=h["leaf_idx"], ord=h["ord"],
                         score=h["score"], global_ord=h["global_ord"],
                         sort_values=h.get("sort_values"))
                for h in p["hits"]]
        t0 = time.monotonic()
        try:
            with tracing.activate(tc), _taskmgr.activate(child):
                if child is not None:
                    child.check()
                    child.note_dispatch(phase="fetch")
                fetched = execute_fetch_phase(ctx.searcher, hits, p["body"],
                                              ctx.index, mapper=ctx.mapper)
        finally:
            if child is not None:
                self.tasks.unregister(child)
        f_ms = (time.monotonic() - t0) * 1e3
        metrics.observe("fetch", f_ms)
        out = {"hits": fetched}
        if tc is not None:
            tc.add_span("fetch", f_ms, index=ctx.index, hits=len(hits))
            tracing.record_trace(tc)
            out["_trace_spans"] = tc.span_dicts()
        self._shard_slowlog("fetch", ctx.index, None, f_ms, p["body"], tc)
        return out

    def _on_free_context(self, req) -> dict:
        freed = self.contexts.release(req.payload["context_id"])
        return {"freed": freed}

    def _on_can_match(self, req) -> dict:
        """Lightweight shard pre-filter (ref:
        action/search/CanMatchPreFilterSearchPhase.java): no scoring — just
        'could any document here match?'. Cheap dictionary/column-bound
        checks against every required term of the query."""
        p = req.payload
        try:
            inst = self.shards.get_shard(p["index"], p["shard_id"])
        except Exception:  # noqa: BLE001 — unknown shard: let query phase fail
            return {"can_match": True}
        terms = p.get("required_terms") or []
        if not terms:
            return {"can_match": True}
        searcher = inst.engine.acquire_searcher()
        for field, term in terms:
            ft = inst.mapper.field_type(field)
            if ft is None or ft.family not in ("inverted", "keyword"):
                continue   # column-served fields have no postings to probe
            if not any(v.segment.term_stats(field, term)[0] > 0
                       for v in searcher.views):
                return {"can_match": False}
        return {"can_match": True}

    def _on_remote_search(self, req) -> dict:
        """Answer a REMOTE coordinator's cross-cluster search leg:
        one RPC per remote cluster (ref: ccs_minimize_roundtrips) — this
        node runs the full local query-then-fetch for the pattern and
        returns the merged per-cluster response. `_trace`/`_sla` crossed
        the cluster boundary in the payload, so the leg's spans parent
        into the caller's trace and its shard dispatches keep the
        caller's SLA tier."""
        p = req.payload
        tc = tracing.child_from_wire(p.get("_trace"),
                                     node=self.shards.node_name,
                                     kind="remote_search")
        with tracing.activate(tc), scheduler.activate_tier(p.get("_sla")):
            return self.execute_search(p.get("index") or "_all",
                                       dict(p.get("body") or {}))

    @staticmethod
    def _required_terms(body: dict) -> List[Tuple[str, str]]:
        """(field, term) pairs every match must contain — conservative: only
        top-level term queries and bool.must/filter term queries qualify."""
        if body.get("knn") is not None:
            # knn hits union with query hits (query_phase mask | knn mask):
            # a shard with no query-term match can still contribute neighbors
            return []
        query = body.get("query") or {}
        out: List[Tuple[str, str]] = []

        def leaf(spec):
            if not isinstance(spec, dict):
                return
            if "term" in spec and isinstance(spec["term"], dict):
                for f, v in spec["term"].items():
                    out.append((f, str(v["value"] if isinstance(v, dict)
                                       else v)))
        leaf(query)
        b = query.get("bool") or {}
        for clause in list(b.get("must", [])) + list(b.get("filter", [])):
            leaf(clause)
        return out

    # ---------------- coordinator (any node) ----------------

    def _free_contexts(self, shard_results: List[dict]) -> None:
        """Release the reader contexts a query phase created."""
        for r in shard_results:
            try:
                self.channels.request(
                    r["_node"], ACTION_FREE,
                    {"context_id": r["context_id"]},
                    source=self.shards.node_name)
            except Exception:  # noqa: BLE001 — reaper collects leftovers
                pass

    # ---- failover plumbing ----

    def _node_circuit(self, node: str):
        h = self._node_health.get(node)
        if h is None:
            from elasticsearch_tpu_torch.common.health import NodeTransportHealth

            h = NodeTransportHealth(f"{self.shards.node_name}->{node}")
            self._node_health[node] = h
        return h

    def _record_transport_outcome(self, node: str,
                                  err: Optional[BaseException] = None) -> None:
        """Feed the node circuit: transport failures count against it; a
        REACHABLE node answering with an application error proves the
        transport edge healthy (and completes any half-open probe)."""
        h = self._node_circuit(node)
        if err is None or not _is_transport_error(err):
            h.record_success()
        else:
            h.record_fault(err)

    def _penalize_node(self, node: str) -> None:
        # penalize the node so ARS stops preferring a failing copy
        prev = self._node_ewma_ms.get(node, 0.0)
        self._node_ewma_ms[node] = 0.7 * prev + 0.3 * 5000.0

    def _note_node_ok(self, node: str, took_ms: float) -> None:
        prev = self._node_ewma_ms.get(node, took_ms)
        self._node_ewma_ms[node] = 0.7 * prev + 0.3 * took_ms
        # age every OTHER node's stat toward zero so a once-bad node is
        # retried eventually (ref: ResponseCollectorService adjusts stats
        # for unselected nodes)
        for other in self._node_ewma_ms:
            if other != node:
                self._node_ewma_ms[other] *= 0.98

    def _note_node_pressure(self, node: str, level: str) -> None:
        """Piggybacked data-node pressure (`_overload` on the shard-query
        response payload): remembered with a timestamp so ARS ranking can
        demote browned-out copies until the signal goes stale."""
        self._node_pressure[node] = (level, time.monotonic())

    def _pressure_rank(self, node: str) -> int:
        """0 green/unknown/stale, 1 yellow, 2 red. Signals age out after
        twice the hysteresis window (min 1s) — a node that stops answering
        stops telling us it is overloaded, and must not be shunned forever."""
        ent = self._node_pressure.get(node)
        if ent is None:
            return 0
        level, ts = ent
        ttl_s = max(1.0, 2 * int(knob("ES_TPU_OVERLOAD_HYSTERESIS_MS"))
                    / 1000.0)
        if time.monotonic() - ts > ttl_s:
            return 0
        return {"yellow": 1, "red": 2}.get(level, 0)

    def _rank_copies(self, copies) -> List[str]:
        """Replica-selection order for one shard's STARTED copies: the
        local copy is free; remote copies rank by service-time EWMA (ref:
        OperationRouting.java:34); copies on nodes that piggybacked an
        elevated overload level are demoted below green ones; quarantined
        nodes (open transport circuit) sink to last resort."""
        from elasticsearch_tpu_torch.common.health import CLOSED

        def key(r):
            h = self._node_health.get(r.node_id)
            quarantined = 1 if h is not None and h.state != CLOSED else 0
            local = 0 if r.node_id == self.shards.node_name else 1
            return (quarantined, self._pressure_rank(r.node_id), local,
                    self._node_ewma_ms.get(r.node_id, 0.0), r.node_id)

        ranked = sorted(copies, key=key)
        if len(ranked) > 1 and any(
                self._pressure_rank(r.node_id) for r in ranked):
            _count_coord("overload_reroutes")
        return [r.node_id for r in ranked]

    @staticmethod
    def _failure_entry(index: str, sid: int, node: Optional[str],
                       err: BaseException, phase: str,
                       attempted: Optional[List[str]] = None) -> dict:
        reason = {"type": getattr(err, "error_type", type(err).__name__),
                  "reason": str(err), "phase": phase}
        if attempted:
            reason["attempted_nodes"] = list(attempted)
        return {"shard": sid, "index": index, "node": node,
                "status": "failed", "reason": reason}

    @staticmethod
    def _shard_body(body: dict, deadline) -> dict:
        """Deadline propagation: the shard query carries the REMAINING
        request budget, so the data node's own dispatch deadline shrinks as
        coordinator time is spent."""
        if deadline is None:
            return body
        rem = deadline.remaining_ms()
        shard_body = dict(body)
        shard_body["timeout"] = max(1, int(rem if rem is not None else 1))
        return shard_body

    def _rpc(self, node: str, action: str, payload: dict,
             deadline=None) -> dict:
        """One bounded RPC. The bound is the request deadline's remaining
        budget, floored at ``ES_TPU_RPC_TIMEOUT_MS`` (so a nearly-spent
        budget still gives the RPC a useful window); with no deadline the
        floor alone applies when set. Unbounded calls dispatch directly —
        no thread hop on the common path. A hung RPC is abandoned at the
        bound (`RpcTimeoutError`); its worker thread dies with the late
        reply instead of wedging a pool worker."""
        floor_ms = float(knob("ES_TPU_RPC_TIMEOUT_MS"))
        timeout_ms: Optional[float] = None
        if deadline is not None:
            rem = deadline.remaining_ms()
            if rem is not None and rem <= 0:
                raise RpcTimeoutError(
                    f"request deadline expired before [{action}] "
                    f"to [{node}]")
            if rem is not None:
                timeout_ms = max(rem, floor_ms)
            elif floor_ms > 0:
                timeout_ms = floor_ms
        elif floor_ms > 0:
            timeout_ms = floor_ms
        src = self.shards.node_name
        if timeout_ms is None:
            return self.channels.request(node, action, payload, source=src)
        box: dict = {}

        def run():
            try:
                box["r"] = self.channels.request(node, action, payload,
                                                 source=src)
            except BaseException as e:  # noqa: BLE001 — crosses the thread
                box["e"] = e

        t = threading.Thread(target=run, daemon=True, name=f"rpc[{node}]")
        t.start()
        t.join(timeout_ms / 1000.0)
        if t.is_alive():
            _count_coord("rpc_timeouts")
            raise RpcTimeoutError(
                f"[{action}] to [{node}] timed out after {timeout_ms:.0f}ms")
        if "e" in box:
            raise box["e"]
        return box["r"]

    def _query_shard_with_failover(self, target: _ShardTarget, body: dict,
                                   deadline, retries_max: int):
        """Query one shard, failing over to the next-best STARTED copy
        (ref: AbstractSearchAsyncAction.onShardFailure ->
        performPhaseOnShard(nextShard)). Attempted nodes are excluded from
        re-selection; open-circuit nodes are skipped unless every copy is
        quarantined (then the best one gets a forced probe). Returns
        (response, None) on success, (None, failure_entry) when the copies
        are exhausted."""
        attempted: List[str] = []
        quarantined: List[str] = []
        last_err: Optional[BaseException] = None
        budget = retries_max + 1

        def attempt(node: str):
            nonlocal last_err
            if attempted:
                _count_coord("shard_retries")
            attempted.append(node)
            tc = tracing.current()
            payload = {"index": target.index, "shard_id": target.sid,
                       "body": self._shard_body(body, deadline),
                       # the coordinator's SLA tier rides to the data
                       # node so its dispatch scheduler budgets the shard
                       # query like the coordinator would
                       "_sla": scheduler.current_tier()}
            ct = _taskmgr.current_task()
            if ct is not None:
                # parent linkage rides the payload next to _trace/_sla
                # (never the body): the data node registers its shard
                # task as a cancellable child of this coordinator
                payload["_parent_task"] = ct.task_id
            if tc is not None:
                # per-attempt propagation: every failover retry shares the
                # SAME trace id, so a recovered request shows both the
                # failed and the successful rpc_query span
                payload["_trace"] = tc.wire()
            t_q = time.monotonic()
            try:
                resp = self._rpc(node, ACTION_QUERY, payload, deadline)
            except _REQUEST_ERRORS:
                # a breaker trip is a REQUEST error, not a shard failure —
                # swallowing it would return silently-wrong aggregations
                # under memory pressure; a kernel error is a fault of the
                # port, which another copy must not serve around
                raise
            except Exception as e:  # noqa: BLE001 — failover candidate
                last_err = e
                if tc is not None:
                    tc.add_span("rpc_query", (time.monotonic() - t_q) * 1e3,
                                node=node, index=target.index,
                                shard=target.sid, attempt=len(attempted),
                                error=type(e).__name__)
                self._penalize_node(node)
                self._record_transport_outcome(node, e)
                return None
            self._record_transport_outcome(node)
            rpc_ms = (time.monotonic() - t_q) * 1000.0
            self._note_node_ok(node, rpc_ms)
            self._overload().note_success()
            lvl = resp.pop("_overload", None)
            if lvl:
                self._note_node_pressure(node, lvl)
            if tc is not None:
                tc.add_span("rpc_query", rpc_ms, node=node,
                            index=target.index, shard=target.sid,
                            attempt=len(attempted))
            resp["_node"] = node
            resp["_index"] = target.index
            resp["_shard"] = target.sid
            return resp

        for node in target.candidates:
            if len(attempted) >= budget:
                break
            if deadline is not None and deadline.expired:
                break
            if attempted and not self._overload().retry_allowed(
                    "shard_failover"):
                # node-wide retry budget exhausted: fail fast with the
                # organic error instead of amplifying a brownout
                break
            h = self._node_health.get(node)
            if h is not None and not h.allow_request():
                _count_coord("node_circuit_open")
                quarantined.append(node)
                continue
            resp = attempt(node)
            if resp is not None:
                return resp, None
        if not attempted and quarantined \
                and not (deadline is not None and deadline.expired):
            # every copy quarantined: one forced probe beats failing the
            # shard with zero attempts
            resp = attempt(quarantined[0])
            if resp is not None:
                return resp, None
        if last_err is None:
            last_err = RpcTimeoutError(
                "request timeout expired before the shard query could run")
        node = attempted[-1] if attempted else \
            (quarantined[-1] if quarantined else None)
        return None, self._failure_entry(target.index, target.sid, node,
                                         last_err, "query",
                                         attempted=attempted)

    def _should_trace(self, body: dict,
                      state: Optional[ClusterState]) -> bool:
        """Coordinator-side trace enablement: profile requests, every-Nth
        sampling, or a slowlog threshold configured on any target index
        (slow queries must carry phase attribution)."""
        if body.get("profile"):
            return True
        if tracing.should_sample():
            return True
        st = state or self.shards.state
        for meta in st.indices.values():
            if tracing.slowlog_configured(meta.settings):
                return True
        return False

    def execute_search(self, index_expr: str, body: dict,
                       state: Optional[ClusterState] = None) -> dict:
        """query_then_fetch across every target shard's best copy, with
        replica failover, deadline propagation, and partial-results
        accounting (see module docstring). Registers a cancellable
        coordinator task when no REST-layer task is already active, and
        wraps the phase runner in a coordinator TraceContext when the
        flight recorder is on (an already-active trace — the REST
        layer's — is reused as-is)."""
        if self.tasks is not None and _taskmgr.current_task() is None:
            with self.tasks.task("indices:data/read/search",
                                 f"indices[{index_expr}]"):
                return self._execute_search_traced(index_expr, body, state)
        return self._execute_search_traced(index_expr, body, state)

    def _execute_search_traced(self, index_expr: str, body: dict,
                               state: Optional[ClusterState] = None) -> dict:
        tc = tracing.current()
        if tc is not None:
            return self._execute_search_phases(index_expr, body, state)
        if not self._should_trace(body, state):
            return self._execute_search_phases(index_expr, body, state)
        tc = tracing.TraceContext(node=self.shards.node_name,
                                  kind="coordinator")
        # the coordinator task registered before the trace existed —
        # backfill so /_tasks shows the same id the flight recorder does
        ct = _taskmgr.current_task()
        if ct is not None and ct.trace_id is None:
            ct.trace_id = tc.trace_id
        with tracing.activate(tc):
            resp = self._execute_search_phases(index_expr, body, state)
        tracing.record_trace(tc)
        return resp

    def _execute_search_phases(self, index_expr: str, body: dict,
                               state: Optional[ClusterState] = None) -> dict:
        from elasticsearch_tpu_torch.tasks.task_manager import (
            Deadline, parse_timeout_ms,
        )

        # cross-cluster fan-out: `remote:pattern` parts split off
        # into one search RPC per remote cluster; the purely-local leg
        # re-enters here under the same task/trace/tier
        if self.remotes is not None \
                and self.remotes.has_remote_parts(index_expr):
            local_parts, remote_groups = \
                self.remotes.split_expression(index_expr)
            return self.remotes.cross_cluster_search(
                body, local_parts, remote_groups,
                lambda expr, sub: self._execute_search_phases(
                    expr, sub, state))

        start = time.monotonic()
        state = state or self.shards.state
        indices = state.resolve_indices(index_expr)
        if not indices:
            raise IndexNotFoundError(index_expr)

        timeout_ms = parse_timeout_ms(body.get("timeout"))
        deadline = Deadline(timeout_ms) if timeout_ms is not None else None
        allow_partial = \
            body.get("allow_partial_search_results", True) is not False
        retries_max = max(0, knob("ES_TPU_SEARCH_SHARD_RETRIES"))

        targets: List[_ShardTarget] = []
        for index in indices:
            meta = state.indices[index]
            if meta.state == "close":
                from elasticsearch_tpu_torch.common.errors import IndexClosedError

                raise IndexClosedError(f"closed index [{index}]")
            for sid in range(meta.number_of_shards):
                copies = [r for r in state.shard_copies(index, sid)
                          if r.serving and r.node_id is not None]
                if not copies:
                    raise ElasticsearchTpuError(
                        f"all shards failed: no started copy of "
                        f"[{index}][{sid}]")
                targets.append(
                    _ShardTarget(index, sid, self._rank_copies(copies)))

        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        sort = parse_sort(body.get("sort"))

        # ---- can_match pre-filter: skip shards that provably hold no
        # matches (ref: CanMatchPreFilterSearchPhase — only bothers when
        # there are enough shards for skipping to pay for the round) ----
        # ref: pre_filter_shard_size — below the threshold the extra
        # round-trip costs more than the skips save
        skipped = 0
        required = self._required_terms(body) \
            if len(targets) >= _PRE_FILTER_SHARD_SIZE else []
        if required:
            kept = []
            for t in targets:
                node = t.candidates[0]
                try:
                    r = self._rpc(node, ACTION_CAN_MATCH,
                                  {"index": t.index, "shard_id": t.sid,
                                   "required_terms": required}, deadline)
                    self._record_transport_outcome(node)
                    if r.get("can_match", True):
                        kept.append(t)
                    else:
                        skipped += 1
                except Exception as e:  # noqa: BLE001 — fail OPEN, but
                    # re-route: the unreachable node must not stay the
                    # query-phase target, so demote it to last resort and
                    # penalize its EWMA before the fan-out
                    self._penalize_node(node)
                    self._record_transport_outcome(node, e)
                    if len(t.candidates) > 1:
                        t.candidates = t.candidates[1:] + [node]
                    _count_coord("can_match_reroutes")
                    kept.append(t)
            targets = kept

        consumer = _QueryPhaseResultConsumer(
            body, sort, k=from_ + size,
            breaker=self.breakers.get_breaker("request"))
        shard_results: List[dict] = []
        failures: List[dict] = []
        failed = 0
        timed_out = False
        fetch_failed: set = set()
        fetched: Dict[Tuple[int, int], dict] = {}  # (shard_idx, pos) -> hit
        ct = _taskmgr.current_task()
        if ct is not None:
            ct.phase = "query"
        try:
            for t in targets:
                if ct is not None:
                    # per-shard fan-out boundary: a cancel (or a ban from
                    # a dead parent) stops the remaining shard lines here
                    ct.check()
                if deadline is not None and deadline.expired:
                    # budget exhausted mid-fan-out: remaining shards become
                    # timed-out partials, not an error (unless strict)
                    timed_out = True
                    _count_coord("deadline_expired")
                    failed += 1
                    failures.append(self._failure_entry(
                        t.index, t.sid, None, RpcTimeoutError(
                            "request timeout expired before the shard "
                            "query could run"), "query"))
                    continue
                resp, failure = self._query_shard_with_failover(
                    t, body, deadline, retries_max)
                if resp is None:
                    failed += 1
                    failures.append(failure)
                    if failure["reason"]["type"] == \
                            "receive_timeout_transport_exception":
                        timed_out = True
                    continue
                if resp.get("timed_out"):
                    timed_out = True
                shard_results.append(resp)
                consumer.consume(len(shard_results) - 1, resp)
                # the consumer owns hit windows + agg partials from here;
                # drop them from the retained metadata so coordinator
                # memory stays bounded by the batch size
                resp["hits"] = ()
                resp["aggs"] = None

            if not allow_partial and failed:
                raise SearchPhaseExecutionError(
                    f"{failed} of {len(targets)} shards failed and "
                    f"allow_partial_search_results=false: "
                    f"{failures[0]['reason']['reason']}",
                    failures=failures)

            # ---- reduce (ref: SearchPhaseController.reducedQueryPhase) ----
            # the incremental consumer already merged/deduped/truncated as
            # results arrived; finish() folds any remainder
            t_merge = time.monotonic()
            window_entries, agg_state = consumer.finish()
            merge_ms = (time.monotonic() - t_merge) * 1e3
            metrics.observe("merge", merge_ms)
            tc = tracing.current()
            if tc is not None:
                tc.add_span("merge", merge_ms, shards=len(shard_results))

            window = [(si, h, shard_results[si])
                      for si, h in window_entries][from_: from_ + size]

            # ---- fetch winning docs from their owning shards (per-shard
            # isolation: ONE failed fetch drops that shard's hits and gets
            # accounted in _shards.failures; the rest of the response — and
            # every reader context — survives) ----
            by_shard: Dict[int, List[dict]] = {}
            for si, h, r in window:
                by_shard.setdefault(si, []).append(h)
            if ct is not None:
                ct.phase = "fetch"
            for si, hits in by_shard.items():
                if ct is not None:
                    ct.check()
                r = shard_results[si]
                node = r["_node"]
                if deadline is not None and deadline.expired:
                    timed_out = True
                    _count_coord("deadline_expired")
                    fetch_failed.add(si)
                    failures.append(self._failure_entry(
                        r["_index"], r["_shard"], node, RpcTimeoutError(
                            "request timeout expired before the fetch "
                            "phase"), "fetch"))
                    continue
                fetch_payload = {"context_id": r["context_id"],
                                 "hits": hits, "body": body}
                ct_f = _taskmgr.current_task()
                if ct_f is not None:
                    fetch_payload["_parent_task"] = ct_f.task_id
                tc_f = tracing.current()
                if tc_f is not None:
                    fetch_payload["_trace"] = tc_f.wire()
                t_f = time.monotonic()
                try:
                    resp = self._rpc(node, ACTION_FETCH, fetch_payload,
                                     deadline)
                    self._record_transport_outcome(node)
                    if tc_f is not None:
                        tc_f.add_span("rpc_fetch",
                                      (time.monotonic() - t_f) * 1e3,
                                      node=node, index=r["_index"],
                                      shard=r["_shard"], hits=len(hits))
                except _REQUEST_ERRORS:
                    raise
                except Exception as e:  # noqa: BLE001 — drop one shard
                    _count_coord("fetch_failures")
                    self._penalize_node(node)
                    self._record_transport_outcome(node, e)
                    fetch_failed.add(si)
                    failures.append(self._failure_entry(
                        r["_index"], r["_shard"], node, e, "fetch"))
                    if _is_transport_error(e) and \
                            isinstance(e, RpcTimeoutError):
                        timed_out = True
                    continue
                for h, out in zip(hits, resp["hits"]):
                    fetched[(si, h["global_ord"], h["leaf_idx"])] = out

            if not allow_partial and (fetch_failed or timed_out):
                reason = (failures[0]["reason"]["reason"] if failures
                          else "request timed out")
                raise SearchPhaseExecutionError(
                    f"partial results with "
                    f"allow_partial_search_results=false: {reason}",
                    failures=failures)
        except BaseException:
            # breaker trip (or any coordinator error) mid-request: the
            # consumer's pending agg reservation and every reader context
            # created so far must not outlive the request — without this the
            # breaker's _reserved bytes leak until process restart and the
            # contexts hold segments until the reaper collects them
            consumer.release()
            self._free_contexts(shard_results)
            raise
        total = consumer.total
        relation = consumer.relation
        collapse_field = consumer.collapse

        max_score = None
        if not sort:
            ms = [r["max_score"] for r in shard_results
                  if r["max_score"] is not None]
            if ms:
                max_score = max(ms)

        hits_out = []
        for si, h, r in window:
            out = fetched.get((si, h["global_ord"], h["leaf_idx"]))
            if out is None:
                continue
            if out.get("_score") is None and h.get("sort_values") is None:
                out["_score"] = h["score"]
            if collapse_field:
                out.setdefault("fields", {})[collapse_field] = [h.get("collapse")]
            hits_out.append(out)

        # ---- aggregations: finalize the incrementally-reduced state ----
        aggs_out = None
        if agg_state is not None:
            from elasticsearch_tpu_torch.search.aggregations import (
                finalize_aggs, parse_aggs,
            )

            spec = body.get("aggs") or body.get("aggregations") or {}
            aggs, pipelines = parse_aggs(spec)
            aggs_out = finalize_aggs(aggs, pipelines, agg_state)

        # ---- suggest: merge shard suggestions ----
        suggest_out = None
        shard_suggests = [r.get("suggest") for r in shard_results
                          if r.get("suggest")]
        if shard_suggests:
            suggest_out = _merge_suggests(shard_suggests)

        # ---- release contexts ----
        self._free_contexts(shard_results)

        profile = None
        if body.get("profile"):
            shards_prof = []
            for r in shard_results:
                entry = {"id": f"[{r['_index']}][{r['_shard']}]",
                         "searches": [{"query": r.get("profile") or [],
                                       "rewrite_time": 0, "collector": []}]}
                spans = r.get("_trace_spans")
                if spans:
                    phases: Dict[str, float] = {}
                    for s in spans:
                        phases[s["name"]] = round(
                            phases.get(s["name"], 0.0) + s["duration_ms"], 3)
                    entry["tpu"] = {"node": r["_node"], "phases": phases,
                                    "spans": spans}
                shards_prof.append(entry)
            profile = {"shards": shards_prof}
            tc_p = tracing.current()
            if tc_p is not None:
                # took decomposition: coordinator-side phase totals (rpc
                # fan-out, reduce) keyed by the shared trace id
                profile["tpu"] = {"trace_id": tc_p.trace_id,
                                  "opaque_id": tc_p.opaque_id,
                                  "node": self.shards.node_name,
                                  "phases": tc_p.phase_totals()}
        if deadline is not None and deadline.expired:
            timed_out = True
        shards_section = {
            "total": len(targets) + skipped,
            "successful": len(shard_results) - len(fetch_failed) + skipped,
            "skipped": skipped,
            "failed": failed + len(fetch_failed),
        }
        if failures:
            # per-shard reasons — only for shards whose copies were
            # EXHAUSTED (or whose fetch failed); recovered failovers leave
            # no trace here, keeping failed-over responses bit-identical to
            # fault-free ones
            shards_section["failures"] = failures
        resp = {
            "took": int((time.monotonic() - start) * 1000),
            "timed_out": bool(timed_out),
            "_shards": shards_section,
            "hits": {"total": {"value": total, "relation": relation},
                     "max_score": max_score, "hits": hits_out},
        }
        from elasticsearch_tpu_torch.search.response import finalize_hits_envelope

        finalize_hits_envelope(resp, body)
        if aggs_out is not None:
            resp["aggregations"] = aggs_out
        if suggest_out is not None:
            resp["suggest"] = suggest_out
        if profile is not None:
            resp["profile"] = profile
        return resp
