"""REST API handlers: the user-facing surface (the port's copy of the
search and data-plane part of elasticsearch_tpu/rest/handlers.py).

Implements the core of the reference's REST API (ref: the 138 Rest*Action
handlers under rest/action/ and the 144 specs in
rest-api-spec/src/main/resources/rest-api-spec/api/): document CRUD, bulk,
search/msearch/count/scroll/PIT, index admin, cluster/cat/nodes monitoring,
analyze, mget, update, delete-by-query, update-by-query, aliases. Response
shapes follow the reference so existing clients can switch over.

The other routes of the reference (security, snapshots, tasks, ingest
pipelines, templates, rollover and resize, close/open, async search,
reindex, termvectors, field caps, explain, rank eval, the cross-cluster
admin routes, the `_tpu` flight recorder and metrics, hot threads and the
remaining `_cat` tables) come with ROADMAP item 9c, part 2; until then they
answer as unknown routes do. `GET /_nodes` lists the node's torch device
(``device.py``) where the reference lists its jax devices.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List

from elasticsearch_tpu_torch import __version__
from elasticsearch_tpu_torch.common.errors import (
    DocumentMissingError,
    ElasticsearchTpuError,
    IllegalArgumentError,
    IndexNotFoundError,
    ParsingError,
)
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.controller import (
    RestController, RestRequest, RestResponse, _error_body,
)

_START_TIME = time.time()


def register_handlers(node: Node, rc: RestController) -> None:
    h = _Handlers(node)
    r = rc.register

    # security action filter (ref: SecurityActionFilter): installed only
    # when xpack.security.enabled — otherwise the node stays open exactly
    # as before
    sec = getattr(node, "security", None)
    if sec is not None and sec.enabled:
        rc.security_filter = sec.rest_filter

    # overload admission (common/overload.py): shed data-path requests at
    # the front door before any body parse or handler work — bulk tier at
    # YELLOW, interactive too at RED. Management/snapshot requests are
    # always admitted so stats and health stay reachable mid-brownout.
    if getattr(node, "overload", None) is not None:
        rc.admission = _overload_admission(node)

    r("GET", "/", h.root)
    # index admin
    r("PUT", "/{index}", h.create_index)
    r("DELETE", "/{index}", h.delete_index)
    r("GET", "/{index}", h.get_index)
    r("HEAD", "/{index}", h.head_index)
    r("GET", "/{index}/_mapping", h.get_mapping)
    r("GET", "/_mapping", h.get_mapping)
    r("GET", "/_settings", h.get_settings)
    r("PUT", "/{index}/_mapping", h.put_mapping)
    r("GET", "/{index}/_settings", h.get_settings)
    r("PUT", "/{index}/_settings", h.put_settings)
    r("POST", "/{index}/_refresh", h.refresh)
    r("GET", "/{index}/_refresh", h.refresh)
    r("POST", "/_refresh", h.refresh_all)
    r("POST", "/{index}/_flush", h.flush)
    r("POST", "/_flush", h.flush_all)
    r("POST", "/{index}/_forcemerge", h.forcemerge)
    r("GET", "/{index}/_stats", h.index_stats)
    r("GET", "/_stats", h.all_stats)
    r("GET", "/{index}/_count", h.count)
    r("POST", "/{index}/_count", h.count)
    r("GET", "/_count", h.count_all)
    r("POST", "/_count", h.count_all)
    # documents
    r("PUT", "/{index}/_doc/{id}", h.index_doc)
    r("POST", "/{index}/_doc/{id}", h.index_doc)
    r("POST", "/{index}/_doc", h.index_doc_auto_id)
    r("PUT", "/{index}/_create/{id}", h.create_doc)
    r("POST", "/{index}/_create/{id}", h.create_doc)
    r("GET", "/{index}/_doc/{id}", h.get_doc)
    r("HEAD", "/{index}/_doc/{id}", h.head_doc)
    r("GET", "/{index}/_source/{id}", h.get_source)
    r("DELETE", "/{index}/_doc/{id}", h.delete_doc)
    r("POST", "/{index}/_update/{id}", h.update_doc)
    r("GET", "/_mget", h.mget)
    r("POST", "/_mget", h.mget)
    r("GET", "/{index}/_mget", h.mget)
    r("POST", "/{index}/_mget", h.mget)
    # bulk
    r("POST", "/_bulk", h.bulk)
    r("PUT", "/_bulk", h.bulk)
    r("POST", "/{index}/_bulk", h.bulk)
    # search
    r("GET", "/{index}/_search", h.search)
    r("POST", "/{index}/_search", h.search)
    r("GET", "/_search", h.search_all)
    r("POST", "/_search", h.search_all)
    r("GET", "/_search/scroll", h.scroll_next)
    r("POST", "/_search/scroll", h.scroll_next)
    r("DELETE", "/_search/scroll", h.scroll_clear)
    r("POST", "/{index}/_pit", h.open_pit)
    r("DELETE", "/_pit", h.close_pit)
    r("POST", "/_msearch", h.msearch)
    r("GET", "/_msearch", h.msearch)
    r("POST", "/{index}/_msearch", h.msearch)
    r("POST", "/{index}/_delete_by_query", h.delete_by_query)
    r("POST", "/{index}/_update_by_query", h.update_by_query)
    # analyze
    r("GET", "/_analyze", h.analyze)
    r("POST", "/_analyze", h.analyze)
    r("GET", "/{index}/_analyze", h.analyze)
    r("POST", "/{index}/_analyze", h.analyze)
    # cluster / monitoring
    r("GET", "/_cluster/settings", h.get_cluster_settings)
    r("PUT", "/_cluster/settings", h.put_cluster_settings)
    r("GET", "/_cluster/health", h.cluster_health)
    r("GET", "/_cluster/state", h.cluster_state)
    r("GET", "/_cluster/stats", h.cluster_stats)
    r("GET", "/_nodes", h.nodes_info)
    r("GET", "/_nodes/stats", h.nodes_stats)
    # aliases
    r("POST", "/_aliases", h.update_aliases)
    r("GET", "/_alias", h.get_aliases)
    r("GET", "/_alias/{name}", h.get_aliases)
    r("GET", "/{index}/_alias", h.get_aliases)
    r("GET", "/{index}/_alias/{name}", h.get_aliases)
    r("PUT", "/{index}/_alias/{name}", h.put_alias)
    r("POST", "/{index}/_alias/{name}", h.put_alias)
    r("PUT", "/{index}/_aliases/{name}", h.put_alias)
    r("DELETE", "/{index}/_alias/{name}", h.delete_alias)
    r("DELETE", "/{index}/_aliases/{name}", h.delete_alias)
    r("HEAD", "/{index}/_alias/{name}", h.head_alias)
    r("HEAD", "/_alias/{name}", h.head_alias)
    # cat
    r("GET", "/_cat/indices", h.cat_indices)
    r("GET", "/_cat/health", h.cat_health)
    r("GET", "/_cat/shards", h.cat_shards)


def _ok(body, status=200) -> RestResponse:
    return RestResponse(status=status, body=body)


class _Handlers:
    def __init__(self, node: Node):
        self.node = node
        # the telemetry plane answers stats RPCs with this node's full
        # REST sections rather than the module-global default set
        tp = getattr(node, "telemetry_plane", None)
        if tp is not None:
            tp.local_stats_fn = self._local_node_stats

    # ---------- info ----------

    def root(self, req: RestRequest) -> RestResponse:
        return _ok({
            "name": self.node.node_name,
            "cluster_name": self.node.cluster_state.cluster_name,
            "cluster_uuid": self.node.node_id,
            "version": {
                "number": __version__,
                "build_flavor": "tpu",
                "lucene_version": "none (tpu-native segments)",
            },
            "tagline": "You Know, for Search",
        })

    # ---------- index admin ----------

    def create_index(self, req: RestRequest) -> RestResponse:
        name = req.param("index")
        meta = self.node.create_index(name, req.body or {})
        return _ok({"acknowledged": True, "shards_acknowledged": True, "index": name})

    def delete_index(self, req: RestRequest) -> RestResponse:
        for name in self._resolve(req.param("index"), require=True):
            self.node.delete_index(name)
        return _ok({"acknowledged": True})

    def get_index(self, req: RestRequest) -> RestResponse:
        out = {}
        for name in self._resolve(req.param("index"), require=True):
            svc = self.node.indices.get(name)
            meta = self.node.cluster_state.indices[name]
            out[name] = {
                "aliases": meta.aliases,
                "mappings": svc.mapper.mapping(),
                "settings": {"index": {
                    "number_of_shards": str(meta.number_of_shards),
                    "number_of_replicas": str(meta.number_of_replicas),
                    "uuid": meta.uuid,
                    "creation_date": str(meta.creation_date),
                    "provided_name": name,
                }},
            }
        return _ok(out)

    def head_index(self, req: RestRequest) -> RestResponse:
        exists = all(self.node.indices.has(n) for n in
                     self._resolve(req.param("index"))) and \
            bool(self._resolve(req.param("index")))
        return RestResponse(status=200 if exists else 404, body={})

    def get_mapping(self, req: RestRequest) -> RestResponse:
        out = {}
        require = not req.param_bool("ignore_unavailable")
        for name in self._resolve(req.param("index"), require=require):
            svc = self.node.indices.get(name)
            svc.check_metadata_allowed()
            out[name] = {"mappings": svc.mapper.mapping()}
        return _ok(out)

    def put_mapping(self, req: RestRequest) -> RestResponse:
        for name in self._resolve(req.param("index"), require=True):
            svc = self.node.indices.get(name)
            svc.check_metadata_allowed()
            svc.mapper.merge(req.body or {})
        return _ok({"acknowledged": True})

    def put_settings(self, req: RestRequest) -> RestResponse:
        """ref: RestUpdateSettingsAction — DYNAMIC index settings update,
        validated, committed through the cluster state (version bump) so
        readers, replication and persistence all see it; replica-count
        changes rebuild the index's replica routing entries."""
        import dataclasses as _dc
        import uuid as _uuid

        from elasticsearch_tpu_torch.cluster.state import ShardRouting
        from elasticsearch_tpu_torch.common.settings import Settings as _S
        from elasticsearch_tpu_torch.tasks.task_manager import parse_timeout_ms

        body = dict(req.body or {})
        updates = _S(body.get("settings", body))
        flat = {}
        for k in updates:
            key = k if k.startswith("index.") else f"index.{k}"
            raw = updates.raw(k)
            if key == "index.number_of_replicas":
                try:
                    if int(raw) < 0:
                        raise ValueError
                except (TypeError, ValueError):
                    raise IllegalArgumentError(
                        f"Failed to parse value [{raw}] for setting [{key}]")
            elif key == "index.default_pipeline":
                if not isinstance(raw, str):
                    raise IllegalArgumentError(
                        f"[{key}] must be a pipeline name")
            elif key.startswith("index.search.slowlog."):
                try:
                    parse_timeout_ms(raw)
                except (TypeError, ValueError):
                    raise IllegalArgumentError(
                        f"Failed to parse value [{raw}] for setting [{key}]")
            elif key in ("index.blocks.write", "index.blocks.read",
                         "index.blocks.read_only", "index.blocks.metadata",
                         "index.max_terms_count",
                         "index.max_result_window",
                         "index.refresh_interval"):
                pass          # enforced by IndexService.check_*_allowed
            else:
                raise IllegalArgumentError(
                    f"Can't update non dynamic setting [{key}]")
            flat[key] = raw

        # The metadata block rejects settings updates UNLESS the request
        # only toggles index.blocks.* itself — otherwise a metadata block
        # could never be removed (ref: TransportUpdateSettingsAction
        # .checkBlock skips the block for all-blocks requests).
        only_blocks = all(k.startswith("index.blocks.") for k in flat)
        for name in self._resolve(req.param("index"), require=True):
            svc = self.node.indices.get(name)
            if not only_blocks:
                svc.check_metadata_allowed()
            new_meta = _dc.replace(
                svc.meta, settings=svc.meta.settings.with_updates(flat))
            svc.meta = new_meta

            def updater(state, name=name, new_meta=new_meta):
                routing = list(state.routing.get(name, []))
                if "index.number_of_replicas" in flat:
                    want = int(flat["index.number_of_replicas"])
                    primaries = [r for r in routing if r.primary]
                    replicas = {r.shard_id: [x for x in routing
                                             if not x.primary
                                             and x.shard_id == r.shard_id]
                                for r in primaries}
                    routing = list(primaries)
                    for p in primaries:
                        have = replicas.get(p.shard_id, [])
                        routing.extend(have[:want])
                        for _ in range(want - len(have)):
                            routing.append(ShardRouting(
                                index=name, shard_id=p.shard_id,
                                node_id=None, primary=False,
                                state="UNASSIGNED"))
                return state.with_index(new_meta, routing)

            self.node.update_state(updater)
        return _ok({"acknowledged": True})

    def get_settings(self, req: RestRequest) -> RestResponse:
        out = {}
        for name in self._resolve(req.param("index"), require=True):
            self.node.indices.get(name).check_metadata_allowed()
            meta = self.node.cluster_state.indices[name]
            out[name] = {"settings": {"index": {
                "number_of_shards": str(meta.number_of_shards),
                "number_of_replicas": str(meta.number_of_replicas),
                "uuid": meta.uuid,
            }}}
        return _ok(out)

    def refresh(self, req: RestRequest) -> RestResponse:
        names = self._resolve(req.param("index"), require=True)
        for name in names:
            self.node.indices.get(name).refresh()
        n = sum(len(self.node.indices.get(x).shards) for x in names)
        return _ok({"_shards": {"total": n, "successful": n, "failed": 0}})

    def refresh_all(self, req: RestRequest) -> RestResponse:
        req.params["index"] = "_all"
        return self.refresh(req)

    def flush(self, req: RestRequest) -> RestResponse:
        names = self._resolve(req.param("index"), require=True)
        for name in names:
            self.node.indices.get(name).flush()
        n = sum(len(self.node.indices.get(x).shards) for x in names)
        return _ok({"_shards": {"total": n, "successful": n, "failed": 0}})

    def flush_all(self, req: RestRequest) -> RestResponse:
        req.params["index"] = "_all"
        return self.flush(req)

    def forcemerge(self, req: RestRequest) -> RestResponse:
        max_segs = req.param_int("max_num_segments", 1)
        for name in self._resolve(req.param("index"), require=True):
            self.node.indices.get(name).force_merge(max_segs)
        return _ok({"_shards": {"total": 1, "successful": 1, "failed": 0}})

    def index_stats(self, req: RestRequest) -> RestResponse:
        out = {"indices": {}}
        total = {"docs": {"count": 0, "deleted": 0}, "store": {"size_in_bytes": 0}}
        for name in self._resolve(req.param("index"), require=True):
            stats = self.node.indices.get(name).stats()
            out["indices"][name] = {"primaries": stats, "total": stats}
            total["docs"]["count"] += stats["docs"]["count"]
            total["store"]["size_in_bytes"] += stats["store"]["size_in_bytes"]
        out["_all"] = {"primaries": total, "total": total}
        n_sh = sum(self.node.cluster_state.indices[n].number_of_shards
                   for n in out["indices"]
                   if n in self.node.cluster_state.indices)
        out["_shards"] = {"total": n_sh, "successful": n_sh, "failed": 0}
        return _ok(out)

    def all_stats(self, req: RestRequest) -> RestResponse:
        req.params["index"] = "_all"
        return self.index_stats(req)

    # ---------- documents ----------

    def index_doc(self, req: RestRequest) -> RestResponse:
        return self._do_index(req, req.param("id"), op_type=req.param("op_type", "index"))

    def index_doc_auto_id(self, req: RestRequest) -> RestResponse:
        import uuid as _uuid

        return self._do_index(req, _uuid.uuid4().hex[:20], op_type="create")

    def create_doc(self, req: RestRequest) -> RestResponse:
        return self._do_index(req, req.param("id"), op_type="create")

    def _auto_create(self, name: str) -> None:
        if self.node.indices.has(name):
            return
        if not getattr(self.node, "auto_create_index", True):
            raise IndexNotFoundError(name)
        self.node.create_index(name, {})  # auto-create (ref: TransportBulkAction)

    def _resolve_write(self, name: str) -> str:
        """Write-target resolution (ref: IndexNameExpressionResolver
        concreteWriteIndex): a concrete index is itself; an alias resolves
        to its single index or, among several, the one flagged
        is_write_index; ambiguous aliases are a 400."""
        if self.node.indices.has(name):
            return name
        cs = self.node.cluster_state
        holders = [(n, cs.indices[n].aliases[name])
                   for n in sorted(cs.indices)
                   if name in cs.indices[n].aliases]
        if not holders:
            return name            # unknown name: auto-create path decides
        if len(holders) == 1:
            return holders[0][0]
        writers = [n for n, spec in holders if spec.get("is_write_index")]
        if len(writers) != 1:
            raise IllegalArgumentError(
                f"no write index is defined for alias [{name}]. The write "
                "index may be explicitly disabled using is_write_index="
                "false or the alias points to multiple indices without one "
                "being designated as a write index")
        return writers[0]

    def _do_index(self, req: RestRequest, doc_id: str, op_type: str) -> RestResponse:
        name = self._resolve_write(req.param("index"))
        self._auto_create(name)
        svc = self.node.indices.get(name)
        kw = {}
        if req.param("if_seq_no") is not None:
            kw["if_seq_no"] = req.param_int("if_seq_no")
            kw["if_primary_term"] = req.param_int("if_primary_term")
        routed = self._run_pipeline(name, doc_id, req.body or {},
                                    req.param("pipeline"))
        if routed is None:   # dropped by the pipeline
            return _ok({"_index": name, "_id": doc_id, "result": "noop",
                        "_shards": {"total": 0, "successful": 0, "failed": 0}})
        source, name, doc_id = routed
        if not self.node.indices.has(name):
            self.node.create_index(name, {})   # pipeline rerouted the doc
        svc = self.node.indices.get(name)
        result = svc.index_doc(doc_id, source, op_type=op_type, **kw)
        resp = self._write_response(name, result)
        if req.param("refresh") in ("true", "", "wait_for"):
            svc.refresh()
            resp["forced_refresh"] = True
        status = 201 if result.result == "created" else 200
        return _ok(resp, status)

    def _write_response(self, index: str, result) -> dict:
        return {
            "_index": index,
            "_id": result.doc_id,
            "_version": result.version,
            "result": result.result,
            "_shards": {"total": 1, "successful": 1, "failed": 0},
            "_seq_no": result.seq_no,
            "_primary_term": result.primary_term,
        }

    def get_doc(self, req: RestRequest) -> RestResponse:
        svc = self.node.indices.get(req.param("index"))
        doc = svc.get_doc(req.param("id"), routing=req.param("routing"))
        if doc is None:
            return _ok({"_index": req.param("index"), "_id": req.param("id"), "found": False}, 404)
        out = {"_index": req.param("index"), **doc, "found": True}
        return _ok(out)

    def head_doc(self, req: RestRequest) -> RestResponse:
        svc = self.node.indices.get(req.param("index"))
        doc = svc.get_doc(req.param("id"))
        return RestResponse(status=200 if doc else 404, body={})

    def get_source(self, req: RestRequest) -> RestResponse:
        svc = self.node.indices.get(req.param("index"))
        doc = svc.get_doc(req.param("id"))
        if doc is None:
            raise DocumentMissingError(f"[{req.param('id')}]: document missing")
        return _ok(doc["_source"])

    def delete_doc(self, req: RestRequest) -> RestResponse:
        name = req.param("index")
        svc = self.node.indices.get(name)
        kw = {}
        if req.param("if_seq_no") is not None:
            kw["if_seq_no"] = req.param_int("if_seq_no")
            kw["if_primary_term"] = req.param_int("if_primary_term")
        result = svc.delete_doc(req.param("id"), **kw)
        if req.param("refresh") in ("true", "", "wait_for"):
            svc.refresh()
        status = 200 if result.result == "deleted" else 404
        return _ok(self._write_response(name, result), status)

    def update_doc(self, req: RestRequest) -> RestResponse:
        """Partial update: doc merge + doc_as_upsert/upsert
        (ref: action/update/UpdateHelper.java)."""
        name = req.param("index")
        body = req.body or {}
        if not self.node.indices.has(name) and (
                "upsert" in body or body.get("doc_as_upsert")):
            self._auto_create(name)
        svc = self.node.indices.get(name)
        doc_id = req.param("id")
        existing = svc.get_doc(doc_id)
        if existing is None:
            if body.get("doc_as_upsert") and "doc" in body:
                source = body["doc"]
            elif "upsert" in body:
                source = body["upsert"]
            else:
                raise DocumentMissingError(f"[{doc_id}]: document missing")
            result = svc.index_doc(doc_id, source)
        else:
            if "doc" not in body:
                raise IllegalArgumentError("failed to parse update request: expected [doc]")
            merged = _deep_merge(dict(existing["_source"]), body["doc"])
            if merged == existing["_source"] and not body.get("detect_noop") is False:
                return _ok({
                    "_index": name, "_id": doc_id, "_version": existing["_version"],
                    "result": "noop",
                    "_shards": {"total": 0, "successful": 0, "failed": 0},
                    "_seq_no": existing["_seq_no"], "_primary_term": existing["_primary_term"],
                })
            result = svc.index_doc(doc_id, merged)
        if req.param("refresh") in ("true", "", "wait_for"):
            svc.refresh()
        return _ok(self._write_response(name, result))

    def mget(self, req: RestRequest) -> RestResponse:
        body = req.body or {}
        docs_spec = body.get("docs")
        if docs_spec is None and "ids" in body:
            docs_spec = [{"_id": str(i), "_index": req.param("index")}
                         for i in body["ids"]]
        out = []
        for spec in docs_spec or []:
            index = spec.get("_index", req.param("index"))
            doc_id = str(spec["_id"])
            try:
                svc = self.node.indices.get(index)
                doc = svc.get_doc(doc_id)
            except IndexNotFoundError:
                doc = None
            if doc is None:
                out.append({"_index": index, "_id": doc_id, "found": False})
            else:
                out.append({"_index": index, **doc, "found": True})
        return _ok({"docs": out})

    # ---------- bulk ----------

    def bulk(self, req: RestRequest) -> RestResponse:
        """NDJSON bulk (ref: action/bulk/TransportBulkAction.java:164).
        The whole request's bytes are reserved on the node's
        IndexingPressure for the bulk's lifetime — a flood bounces with
        429 instead of buffering unbounded (ref: IndexingPressure.java)."""
        from elasticsearch_tpu_torch.tasks import task_manager as _taskmgr

        with self.node.indexing_pressure.coordinating(len(req.raw_body)):
            if _taskmgr.current_task() is None:
                with self.node.tasks.task(
                        "indices:data/write/bulk",
                        f"bulk bytes[{len(req.raw_body)}]"):
                    return self._bulk_inner(req)
            return self._bulk_inner(req)

    def _bulk_inner(self, req: RestRequest) -> RestResponse:
        default_index = req.param("index")
        lines = [ln for ln in req.raw_body.decode("utf-8").split("\n") if ln.strip()]
        items: List[dict] = []
        errors = False
        start = time.monotonic()
        i = 0
        touched = set()
        while i < len(lines):
            try:
                action_line = json.loads(lines[i])
            except json.JSONDecodeError:
                raise ParsingError(f"Malformed action/metadata line [{i + 1}]")
            if len(action_line) != 1:
                raise ParsingError(f"Malformed action/metadata line [{i + 1}]")
            op, meta = next(iter(action_line.items()))
            raw_index = meta.get("_index", default_index)
            if raw_index is None:
                raise ParsingError(
                    f"Validation Failed: 1: index is missing for action "
                    f"line [{i + 1}];")
            index = self._resolve_write(str(raw_index))
            doc_id = meta.get("_id")
            if doc_id is not None:
                doc_id = str(doc_id)
            i += 1
            source = None
            if op in ("index", "create", "update"):
                if i >= len(lines):
                    raise ParsingError("Validation Failed: missing source for bulk op")
                source = json.loads(lines[i])
                i += 1
            try:
                self._auto_create(index)
                svc = self.node.indices.get(index)
                touched.add(index)
                if op in ("index", "create"):
                    if doc_id is None:
                        import uuid as _uuid

                        doc_id = _uuid.uuid4().hex[:20]
                    routed = self._run_pipeline(
                        index, doc_id, source,
                        meta.get("pipeline", req.param("pipeline")))
                    if routed is None:   # dropped by the pipeline
                        items.append({op: {"_index": index, "_id": doc_id,
                                           "result": "noop", "status": 200}})
                        continue
                    source, index, doc_id = routed
                    if not self.node.indices.has(index):
                        self.node.create_index(index, {})
                    svc = self.node.indices.get(index)
                    touched.add(index)
                    result = svc.index_doc(doc_id, source,
                                           op_type="create" if op == "create" else "index")
                    items.append({op: {**self._write_response(index, result),
                                       "status": 201 if result.result == "created" else 200}})
                elif op == "delete":
                    result = svc.delete_doc(doc_id)
                    items.append({op: {**self._write_response(index, result),
                                       "status": 200 if result.result == "deleted" else 404}})
                elif op == "update":
                    sub = RestRequest("POST", "", {"index": index, "id": doc_id}, source)
                    resp = self.update_doc(sub)
                    items.append({op: {**resp.body, "status": resp.status}})
                else:
                    raise ParsingError(f"Malformed action [{op}]")
            except ElasticsearchTpuError as e:
                errors = True
                items.append({op: {"_index": index, "_id": doc_id, "status": e.status,
                                   "error": e.to_dict()}})
        if req.param("refresh") in ("true", "", "wait_for"):
            for name in touched:
                self.node.indices.get(name).refresh()
        took = int((time.monotonic() - start) * 1000)
        return _ok({"took": took, "errors": errors, "items": items})

    # ---------- search ----------

    def _ok_search(self, req: RestRequest, resp: dict, status: int = 200):
        """Search-family envelope: rest_total_hits_as_int renders hits.total
        as the pre-7.0 integer (ref: RestSearchAction TOTAL_HITS_AS_INT)."""
        if req.param_bool("rest_total_hits_as_int"):
            def fix(r):
                hits = r.get("hits") if isinstance(r, dict) else None
                if isinstance(hits, dict) and isinstance(hits.get("total"),
                                                         dict):
                    hits["total"] = hits["total"]["value"]
            fix(resp)
            for sub in resp.get("responses", []) or []:
                fix(sub)
        return _ok(resp, status)

    def _trace_enabled(self, req: RestRequest, body: dict) -> bool:
        """Flight-recorder enablement for one search: profile requests,
        every-Nth sampling (ES_TPU_TRACE_SAMPLE), or any target index with
        a slowlog threshold configured (a slow query must carry phase
        attribution when it lands in the slowlog)."""
        from elasticsearch_tpu_torch.common import tracing

        if body.get("profile"):
            return True
        if tracing.should_sample():
            return True
        try:
            names = self._resolve(req.param("index"))
        except ElasticsearchTpuError:
            return False
        for n in names or ():
            try:
                th = self.node.indices.get(n).effective_slowlog_thresholds()
            except Exception:  # noqa: BLE001 — enablement never fails a search
                continue
            if any(v is not None for per in th.values()
                   for v in per.values()):
                return True
        return False

    def search(self, req: RestRequest) -> RestResponse:
        """Search entry: wraps the phase runner in a per-request
        TraceContext when the flight recorder is on (the `rest_total`
        histogram records regardless). Traced profile responses gain a
        `profile.tpu` section with the trace id and per-phase totals."""
        from elasticsearch_tpu_torch.common import metrics, tracing
        from elasticsearch_tpu_torch.threadpool import (
            activate_tier, tier_for_request,
        )

        body_view = req.body if isinstance(req.body, dict) else {}
        tc = None
        if tracing.current() is None and self._trace_enabled(req, body_view):
            tc = tracing.TraceContext(
                opaque_id=req.headers.get("x-opaque-id"),
                node=self.node.node_name, kind="rest")
        t0 = time.monotonic()
        # SLA tier for the dispatch scheduler: classifier + optional
        # `sla` request param, bound for the whole request like the trace
        tier = tier_for_request(req.method, req.path, req.params)
        with tracing.activate(tc), activate_tier(tier):
            rr = self._search_inner(req)
        total_ms = (time.monotonic() - t0) * 1e3
        metrics.observe("rest_total", total_ms)
        if tc is not None:
            tc.add_span("rest_total", total_ms, path=req.path)
            tracing.record_trace(tc)
            if isinstance(rr.body, dict) and isinstance(
                    rr.body.get("profile"), dict):
                from elasticsearch_tpu_torch.common import hbm_ledger

                # routing explainability: why this index's engine
                # selection went turbo or not, with the byte arithmetic
                routing = hbm_ledger.last_routing()
                tpu_profile = {
                    "trace_id": tc.trace_id, "opaque_id": tc.opaque_id,
                    "node": self.node.node_name,
                    "phases": tc.phase_totals()}
                if routing is not None:
                    tpu_profile["routing_reason"] = routing["reason"]
                    tpu_profile["routing"] = routing
                rr.body["profile"].setdefault("tpu", tpu_profile)
        return rr

    def _search_inner(self, req: RestRequest) -> RestResponse:
        from elasticsearch_tpu_torch.index.index_service import parse_keep_alive

        body = dict(req.body or {})
        # url params mirror body fields (ref: RestSearchAction)
        if req.param("q") is not None:
            body["query"] = {"match": {"_all": req.param("q")}}  # minimal q= support
        for p in ("size", "from"):
            if req.param(p) is not None:
                body[p] = req.param_int(p)
        if req.param("timeout") is not None:
            body["timeout"] = req.param("timeout")
        if req.param("allow_partial_search_results") is not None:
            body["allow_partial_search_results"] = \
                req.param_bool("allow_partial_search_results")
        # point-in-time searches carry their index inside the pinned context
        pit = body.get("pit")
        if pit:
            ctx = self.node.indices.contexts.get(pit["id"])
            if pit.get("keep_alive"):
                ctx.keep_alive_s = parse_keep_alive(pit["keep_alive"])
            clean = {k: v for k, v in body.items() if k != "pit"}
            svc = self.node.indices.get(ctx.index)
            with self.node.tasks.task("indices:data/read/search",
                                      f"pit[{ctx.index}]") as task:
                resp = svc.search(clean, searchers=ctx.extra["searchers"],
                                  task=task)
            resp["pit_id"] = pit["id"]
            return self._ok_search(req, resp)
        # cross-cluster fan-out: `remote:index` parts peel off into
        # one search RPC per registered remote; stays off the hot path for
        # expressions with no ':' or an empty remote registry
        index_expr = req.param("index")
        if self.node.remotes.has_remote_parts(index_expr):
            return self._ok_search(req, self._ccs_search(index_expr, body))
        names = self._resolve(index_expr, require=True)
        search_type = req.param("search_type", "query_then_fetch")
        # every search runs under a registered cancellable task
        # (ref: tasks/TaskManager.java:71 via TransportAction.execute)
        with self.node.tasks.task("indices:data/read/search",
                                  f"indices[{','.join(names)}]") as task:
            if req.param("scroll") is not None:
                if len(names) != 1:
                    raise IllegalArgumentError("scroll requires a single index")
                keep = parse_keep_alive(req.param("scroll"))
                return self._ok_search(req, self.node.indices.scroll_start(
                    names[0], body, keep, task=task))
            if len(names) == 1:
                return self._ok_search(req, self.node.indices.get(
                    names[0]).search(body, search_type, task=task))
            return self._ok_search(req, self._multi_index_search(
                names, body, search_type, task=task))

    def scroll_next(self, req: RestRequest) -> RestResponse:
        from elasticsearch_tpu_torch.index.index_service import parse_keep_alive

        body = dict(req.body or {})
        scroll_id = body.get("scroll_id") or req.param("scroll_id")
        if not scroll_id:
            raise IllegalArgumentError("scroll_id is required")
        keep = parse_keep_alive(body.get("scroll") or req.param("scroll"),
                                0.0) or None
        with self.node.tasks.task("indices:data/read/scroll",
                                  f"scroll[{scroll_id[:8]}]") as task:
            return self._ok_search(req, self.node.indices.scroll_continue(
                scroll_id, keep, task=task))

    def scroll_clear(self, req: RestRequest) -> RestResponse:
        body = dict(req.body or {})
        ids = body.get("scroll_id", [])
        if isinstance(ids, str):
            ids = [ids]
        freed = sum(1 for i in ids if self.node.indices.contexts.release(i))
        return _ok({"succeeded": True, "num_freed": freed})

    def open_pit(self, req: RestRequest) -> RestResponse:
        from elasticsearch_tpu_torch.index.index_service import parse_keep_alive

        names = self._resolve(req.param("index"), require=True)
        if len(names) != 1:
            raise IllegalArgumentError("PIT requires a single index")
        keep = parse_keep_alive(req.param("keep_alive"))
        pit_id = self.node.indices.open_pit(names[0], keep)
        return _ok({"id": pit_id})

    def close_pit(self, req: RestRequest) -> RestResponse:
        body = dict(req.body or {})
        ok = self.node.indices.close_pit(body.get("id", ""))
        return _ok({"succeeded": ok, "num_freed": int(ok)})

    def get_cluster_settings(self, req: RestRequest) -> RestResponse:
        from elasticsearch_tpu_torch.common.settings import Settings as _S

        out = {"persistent": _S(self.node._persistent_settings).as_nested_dict(),
               "transient": _S(self.node._transient_settings).as_nested_dict()}
        if req.param("include_defaults") == "true":
            out["defaults"] = {
                s.key: s.get(self.node.cluster_settings.settings)
                for s in self.node.cluster_settings._registered.values()}
        return _ok(out)

    def put_cluster_settings(self, req: RestRequest) -> RestResponse:
        """ref: RestClusterUpdateSettingsAction — validated against the
        registered dynamic settings; persistent/transient tracked apart."""
        body = dict(req.body or {})
        from elasticsearch_tpu_torch.common.settings import Settings as _S

        # validate EVERYTHING before committing anything (the reference
        # rejects the whole request; partial commits would lie)
        all_updates = {}
        for scope in ("persistent", "transient"):
            flat = _S(body.get(scope) or {})
            all_updates[scope] = {k: flat.raw(k) for k in flat}
        for scope, updates in all_updates.items():
            for key in updates:
                if key not in self.node.cluster_settings._registered:
                    raise IllegalArgumentError(
                        f"{scope} setting [{key}], not recognized")
        for scope in ("persistent", "transient"):
            updates = all_updates[scope]
            if not updates:
                continue
            self.node.cluster_settings.apply(updates)
            store = (self.node._persistent_settings if scope == "persistent"
                     else self.node._transient_settings)
            for k, v in updates.items():
                if v is None:
                    store.pop(k, None)
                else:
                    store[k] = v
        return _ok({"acknowledged": True,
                    "persistent": _S(self.node._persistent_settings).as_nested_dict(),
                    "transient": _S(self.node._transient_settings).as_nested_dict()})

    # ---------- ingest ----------

    def _run_pipeline(self, index: str, doc_id: str, source: dict,
                      pipeline_param):
        """Apply ?pipeline= or the index's default_pipeline; None means
        the document was DROPPED (ref: IngestService drop handling)."""
        pid = pipeline_param
        if pid is None and self.node.indices.has(index):
            meta = self.node.indices.get(index).meta
            pid = meta.settings.raw("index.default_pipeline")
        if not pid or pid == "_none":
            return source, index, doc_id
        return self.node.ingest.process(pid, source, index=index,
                                        doc_id=doc_id or "")

    def search_all(self, req: RestRequest) -> RestResponse:
        req.params.setdefault("index", "_all")
        return self.search(req)

    def _multi_index_search(self, names: List[str], body: dict, search_type: str,
                            task=None) -> dict:
        if task is None:
            from elasticsearch_tpu_torch.tasks import task_manager as _taskmgr

            task = _taskmgr.current_task()
        responses = [(n, self.node.indices.get(n).search(body, search_type, task=task))
                     for n in names]
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        all_hits = []
        total = 0
        max_score = None
        timed_out = False
        shards_total = 0
        shards_ok = 0
        shards_skipped = 0
        shards_failed = 0
        shard_failures: List[dict] = []
        for name, r in responses:
            total += r["hits"]["total"]["value"]
            # a partially-timed-out or partially-failed member index must
            # not be laundered into a clean merged header (ref:
            # SearchResponseMerger.java — ORs timeouts, sums shard counts)
            timed_out = timed_out or bool(r.get("timed_out"))
            sh = r.get("_shards", {})
            shards_total += sh.get("total", 0)
            shards_ok += sh.get("successful", 0)
            shards_skipped += sh.get("skipped", 0)
            shards_failed += sh.get("failed", 0)
            shard_failures.extend(sh.get("failures", []))
            if r["hits"]["max_score"] is not None:
                max_score = max(max_score or float("-inf"), r["hits"]["max_score"])
            all_hits.extend(r["hits"]["hits"])
        if body.get("sort"):
            all_hits.sort(key=lambda h: h.get("sort", []))
        else:
            all_hits.sort(key=lambda h: -(h.get("_score") or 0.0))
        shards: dict = {"total": shards_total, "successful": shards_ok,
                        "skipped": shards_skipped, "failed": shards_failed}
        if shard_failures:
            shards["failures"] = shard_failures
        return {
            "took": sum(r["took"] for _, r in responses),
            "timed_out": timed_out,
            "_shards": shards,
            "hits": {"total": {"value": total, "relation": "eq"},
                     "max_score": max_score,
                     "hits": all_hits[from_: from_ + size]},
        }

    def _ccs_search(self, index_expr: str, body: dict) -> dict:
        """Cross-cluster fan-out for the standalone node: peel the
        `remote:pattern` parts off the expression and let the remote
        registry run one leg per cluster; the purely-local parts re-enter
        the ordinary single-/multi-index path as the local leg."""
        local_parts, remote_groups = \
            self.node.remotes.split_expression(index_expr)

        def local_search(expr: str, sub: dict) -> dict:
            names = self._resolve(expr, require=True)
            if len(names) == 1:
                return self.node.indices.get(names[0]).search(dict(sub))
            return self._multi_index_search(names, dict(sub),
                                            "query_then_fetch")

        with self.node.tasks.task("indices:data/read/search",
                                  f"ccs[{index_expr}]"):
            return self.node.remotes.cross_cluster_search(
                body, local_parts, remote_groups, local_search)

    def msearch(self, req: RestRequest) -> RestResponse:
        from elasticsearch_tpu_torch.threadpool import (
            activate_tier, tier_for_request,
        )

        with activate_tier(tier_for_request(req.method, req.path,
                                            req.params)):
            with self.node.tasks.task(
                    "indices:data/read/msearch",
                    f"msearch bytes[{len(req.raw_body)}]"):
                return self._msearch_inner(req)

    def _msearch_inner(self, req: RestRequest) -> RestResponse:
        lines = [ln for ln in req.raw_body.decode().split("\n") if ln.strip()]
        slots = []   # (index_names | None, body, error | None)
        ccs_exprs: dict = {}   # slot -> `remote:pattern` expression
        i = 0
        while i + 1 <= len(lines) - 1 or (i < len(lines)):
            header = json.loads(lines[i])
            body = json.loads(lines[i + 1]) if i + 1 < len(lines) else {}
            i += 2
            index = header.get("index", req.param("index", "_all"))
            # a `remote:index` line fans out per cluster instead of
            # resolving locally — a line targeting only dead
            # skip_unavailable remotes must come back empty-but-well-formed
            # (`_clusters.skipped` counted), never as an error entry
            if self.node.remotes.has_remote_parts(index):
                ccs_exprs[len(slots)] = index
                slots.append((None, body, None))
                continue
            try:
                slots.append((self._resolve(index, require=True), body, None))
            except ElasticsearchTpuError as e:
                slots.append((None, body, e))
        # single-index bodies group into per-index batches so eligible flat
        # queries share one device dispatch (ref P8 batched _msearch)
        by_index: dict = {}
        for si, (names, body, err) in enumerate(slots):
            if err is None and names is not None and len(names) == 1:
                by_index.setdefault(names[0], []).append(si)
        batched: dict = {}
        for name, idxs in by_index.items():
            try:
                rs = self.node.indices.get(name).msearch([slots[i][1] for i in idxs])
                for si, r in zip(idxs, rs):
                    if isinstance(r, ElasticsearchTpuError):
                        batched[si] = {"error": r.to_dict(), "status": r.status}
                    else:
                        batched[si] = {**r, "status": 200}
            except ElasticsearchTpuError as e:
                for si in idxs:
                    batched[si] = {"error": e.to_dict(), "status": e.status}
        responses = []
        for si, (names, body, err) in enumerate(slots):
            if si in ccs_exprs:
                try:
                    responses.append({**self._ccs_search(ccs_exprs[si],
                                                         body),
                                      "status": 200})
                except ElasticsearchTpuError as e:
                    responses.append({"error": e.to_dict(),
                                      "status": e.status})
            elif err is not None:
                responses.append({"error": err.to_dict(), "status": err.status})
            elif si in batched:
                responses.append(batched[si])
            else:
                try:
                    responses.append({**self._multi_index_search(names, body, "query_then_fetch"),
                                      "status": 200})
                except ElasticsearchTpuError as e:
                    responses.append({"error": e.to_dict(), "status": e.status})
        return self._ok_search(req, {
            "took": sum(r.get("took", 0) for r in responses),
            "responses": responses})

    def count(self, req: RestRequest) -> RestResponse:
        body = dict(req.body or {})
        body["size"] = 0
        body["track_total_hits"] = True
        names = self._resolve(req.param("index"), require=True)
        total = 0
        for n in names:
            total += self.node.indices.get(n).search(body)["hits"]["total"]["value"]
        return _ok({"count": total,
                    "_shards": {"total": len(names), "successful": len(names),
                                "skipped": 0, "failed": 0}})

    def count_all(self, req: RestRequest) -> RestResponse:
        req.params.setdefault("index", "_all")
        return self.count(req)

    def delete_by_query(self, req: RestRequest) -> RestResponse:
        """Scroll-free delete-by-query (ref: reindex module's
        DeleteByQueryRequest — client-side search+delete loop)."""
        names = self._resolve(req.param("index"), require=True)
        body = dict(req.body or {})
        body["size"] = 10000
        body["_source"] = False
        deleted = 0
        start = time.monotonic()
        for n in names:
            svc = self.node.indices.get(n)
            svc.refresh()
            r = svc.search(body)
            for h in r["hits"]["hits"]:
                result = svc.delete_doc(h["_id"])
                if result.result == "deleted":
                    deleted += 1
            svc.refresh()
        return _ok({"took": int((time.monotonic() - start) * 1000), "timed_out": False,
                    "total": deleted, "deleted": deleted, "batches": 1,
                    "version_conflicts": 0, "noops": 0, "failures": []})

    def update_by_query(self, req: RestRequest) -> RestResponse:
        """Re-indexes matching docs in place (no script support yet)."""
        names = self._resolve(req.param("index"), require=True)
        body = dict(req.body or {})
        if "script" in body:
            raise IllegalArgumentError("script in update_by_query is not yet supported")
        body["size"] = 10000
        updated = 0
        start = time.monotonic()
        for n in names:
            svc = self.node.indices.get(n)
            svc.refresh()
            r = svc.search(body)
            for h in r["hits"]["hits"]:
                svc.index_doc(h["_id"], h["_source"])
                updated += 1
            svc.refresh()
        return _ok({"took": int((time.monotonic() - start) * 1000), "timed_out": False,
                    "total": updated, "updated": updated, "batches": 1,
                    "version_conflicts": 0, "noops": 0, "failures": []})

    # ---------- analyze ----------

    def analyze(self, req: RestRequest) -> RestResponse:
        body = req.body or {}
        text = body.get("text", "")
        texts = text if isinstance(text, list) else [text]
        index = req.param("index")
        if index and self.node.indices.has(index):
            registry = self.node.indices.get(index).analysis
            svc = self.node.indices.get(index)
            if "field" in body:
                ft = svc.mapper.field_type(body["field"])
                analyzer = svc.mapper.analyzer_for(ft) if ft is not None else registry.get("standard")
            else:
                analyzer = registry.get(body.get("analyzer", "standard"))
        else:
            from elasticsearch_tpu_torch.analysis import AnalysisRegistry

            analyzer = AnalysisRegistry().get(body.get("analyzer", "standard"))
        tokens = []
        for i, t in enumerate(texts):
            for tok in analyzer.tokenize(t):
                tokens.append({
                    "token": tok.term,
                    "start_offset": tok.start_offset,
                    "end_offset": tok.end_offset,
                    "type": "<ALPHANUM>",
                    "position": tok.position,
                })
        return _ok({"tokens": tokens})

    # ---------- cluster / monitoring ----------

    def cluster_health(self, req: RestRequest) -> RestResponse:
        """GET /_cluster/health — with the maintenance-plane wait params
        (ref: RestClusterHealthAction): `wait_for_status` blocks until the
        cluster is at least that healthy, `wait_for_no_relocating_shards`
        until every move has completed; both are a bounded poll that
        reports `timed_out: true` rather than erroring on expiry."""
        from elasticsearch_tpu_torch.tasks.task_manager import parse_timeout_ms

        want_status = req.param("wait_for_status")
        want_no_reloc = req.param_bool("wait_for_no_relocating_shards")
        health = self.node.cluster_state.health()
        if want_status is None and not want_no_reloc:
            return _ok(health)
        rank = {"green": 0, "yellow": 1, "red": 2}
        if want_status is not None and want_status not in rank:
            raise IllegalArgumentError(
                f"unknown wait_for_status [{want_status}]")
        timeout_ms = parse_timeout_ms(req.param("timeout")) or 30_000.0
        deadline = time.monotonic() + timeout_ms / 1000.0

        def satisfied(h: dict) -> bool:
            if want_status is not None \
                    and rank[h["status"]] > rank[want_status]:
                return False
            if want_no_reloc and h["relocating_shards"] > 0:
                return False
            return True

        while not satisfied(health):
            if time.monotonic() >= deadline:
                health["timed_out"] = True
                return _ok(health)
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
            health = self.node.cluster_state.health()
        return _ok(health)

    def cluster_state(self, req: RestRequest) -> RestResponse:
        cs = self.node.cluster_state
        return _ok({
            "cluster_name": cs.cluster_name,
            "cluster_uuid": self.node.node_id,
            "version": cs.version,
            "state_uuid": f"v{cs.version}",
            "blocks": {},
            "master_node": cs.master_node_id,
            "nodes": {nid: {"name": n.name, "transport_address": n.address,
                            "roles": list(n.roles)} for nid, n in cs.nodes.items()},
            "metadata": {"indices": {
                name: {"state": m.state, "settings": {"index": {
                    "number_of_shards": str(m.number_of_shards),
                    "number_of_replicas": str(m.number_of_replicas)}},
                    "aliases": sorted(m.aliases)}
                for name, m in cs.indices.items()}},
        })

    def cluster_stats(self, req: RestRequest) -> RestResponse:
        total_docs = sum(self.node.indices.get(n).doc_count()
                         for n in self.node.indices.names())
        return _ok({
            "cluster_name": self.node.cluster_state.cluster_name,
            "status": self.node.cluster_state.health()["status"],
            "indices": {"count": len(self.node.indices.names()),
                        "docs": {"count": total_docs, "deleted": 0}},
            "nodes": {"count": {"total": len(self.node.cluster_state.nodes)}},
        })

    def nodes_info(self, req: RestRequest) -> RestResponse:
        from elasticsearch_tpu_torch.device import device_name

        cs = self.node.cluster_state
        return _ok({
            "_nodes": {"total": len(cs.nodes), "successful": len(cs.nodes), "failed": 0},
            "cluster_name": cs.cluster_name,
            "nodes": {nid: {
                "name": n.name,
                "transport_address": n.address,
                "version": __version__,
                "roles": list(n.roles),
                "accelerators": [device_name(self.node.device)],
            } for nid, n in cs.nodes.items()},
        })

    def _local_node_stats(self) -> dict:
        """This node's full stats sections — the REST body for a
        single-node cluster and the telemetry plane's RPC answer when a
        peer coordinator fans out (cluster/telemetry_plane.py)."""
        return {
            "name": self.node.node_name,
            "indices": {"docs": {"count": sum(
                self.node.indices.get(n).doc_count() for n in self.node.indices.names())}},
            "breakers": self.node.breakers.stats(),
            "indexing_pressure": self.node.indexing_pressure.stats(),
            "thread_pool": self.node.thread_pool.stats(),
            "tpu_coalescer": _default_coalescer_stats(),
            "tpu_scheduler": _default_scheduler_stats(),
            "tpu_turbo": _turbo_merge_stats(),
            "tpu_health": _tpu_health_stats(),
            "tpu_coordinator": _tpu_coordinator_stats(),
            "tpu_durability": _tpu_durability_stats(),
            "tpu_search_latency": _tpu_search_latency_stats(),
            "tpu_settings": _tpu_settings_stats(),
            "tpu_hbm": _tpu_hbm_stats(),
            "tpu_agg": _tpu_agg_stats(),
            "tpu_knn": _tpu_knn_stats(),
            "tpu_compile": _tpu_compile_stats(),
            "tpu_tasks": self.node.tasks.stats(),
            "tpu_overload": self.node.overload.stats(),
            "tpu_relocation": _tpu_relocation_stats(),
            "tpu_integrity": _tpu_integrity_stats(),
            "tpu_ccs": self.node.remotes.stats(),
            "tpu_ccr": self.node.ccr.stats(),
            "jvm": {"uptime_in_millis": int((time.time() - _START_TIME) * 1000)},
        }

    def nodes_stats(self, req: RestRequest) -> RestResponse:
        """GET /_nodes/stats — cluster fan-out through the telemetry
        plane: a dead peer degrades to a `node_failures` entry and
        partial stats, never a failed response (/_tasks
        semantics)."""
        cs = self.node.cluster_state
        per_node, failures = self.node.telemetry_plane.nodes_stats()
        nodes = {}
        for name, stats in per_node.items():
            # the local node keeps its id key (response-shape compat);
            # peers key by the name the channels layer routes on
            key = self.node.node_id if name == self.node.node_name else name
            nodes[key] = stats
        out = {
            "_nodes": {"total": len(per_node) + len(failures),
                       "successful": len(per_node),
                       "failed": len(failures)},
            "cluster_name": cs.cluster_name,
            "nodes": nodes,
        }
        if failures:
            out["_nodes"]["failures"] = failures
            out["node_failures"] = failures
        return _ok(out)

    # ---------- aliases ----------

    def update_aliases(self, req: RestRequest) -> RestResponse:
        from dataclasses import replace

        for action in (req.body or {}).get("actions", []):
            op, spec = next(iter(action.items()))
            index = spec["index"]
            alias = spec["alias"]
            meta = self.node.cluster_state.indices.get(index)
            if meta is None:
                raise IndexNotFoundError(index)
            aliases = dict(meta.aliases)
            if op == "add":
                aliases[alias] = {k: v for k, v in spec.items() if k not in ("index", "alias")}
            elif op == "remove":
                aliases.pop(alias, None)
            else:
                raise IllegalArgumentError(f"unsupported alias action [{op}]")
            new_meta = replace(meta, aliases=aliases, version=meta.version + 1)
            routing = self.node.cluster_state.routing[index]
            self.node.update_state(lambda s: s.with_index(new_meta, routing))
        return _ok({"acknowledged": True})

    def get_aliases(self, req: RestRequest) -> RestResponse:
        want = req.param("name")
        out = {}
        for name in self._resolve(req.param("index", "_all"), require=False):
            meta = self.node.cluster_state.indices[name]
            aliases = meta.aliases
            if want is not None:
                import fnmatch as _fn

                pats = [p.strip() for p in want.split(",")]
                aliases = {a: spec for a, spec in aliases.items()
                           if any(_fn.fnmatchcase(a, p) for p in pats)}
                if not aliases:
                    continue
            out[name] = {"aliases": aliases}
        if want is not None and not out:
            return _ok({"error": f"alias [{want}] missing", "status": 404},
                       404)
        return _ok(out)

    def _set_alias(self, index: str, alias: str, spec: dict) -> None:
        from dataclasses import replace

        meta = self.node.cluster_state.indices.get(index)
        if meta is None:
            raise IndexNotFoundError(index)
        aliases = dict(meta.aliases)
        if spec is None:
            aliases.pop(alias, None)
        else:
            aliases[alias] = spec
        new_meta = replace(meta, aliases=aliases, version=meta.version + 1)
        routing = self.node.cluster_state.routing[index]
        self.node.update_state(lambda s, m=new_meta, r=routing:
                               s.with_index(m, r))

    def put_alias(self, req: RestRequest) -> RestResponse:
        spec = {k: v for k, v in (req.body or {}).items()}
        for name in self._resolve(req.param("index"), require=True):
            self._set_alias(name, req.param("name"), spec)
        return _ok({"acknowledged": True})

    def delete_alias(self, req: RestRequest) -> RestResponse:
        found = False
        for name in self._resolve(req.param("index"), require=True):
            if req.param("name") in self.node.cluster_state.indices[name].aliases:
                found = True
            self._set_alias(name, req.param("name"), None)
        if not found:
            return _ok({"error": "aliases missing", "status": 404}, 404)
        return _ok({"acknowledged": True})

    def head_alias(self, req: RestRequest) -> RestResponse:
        import fnmatch as _fn

        want = req.param("name", "")
        pats = [p.strip() for p in want.split(",")]
        names = self._resolve(req.param("index", "_all"), require=False)
        for name in names:
            for a in self.node.cluster_state.indices[name].aliases:
                if any(_fn.fnmatchcase(a, p) for p in pats):
                    return RestResponse(status=200, body={})
        return RestResponse(status=404, body={})

    # ---------- cat ----------

    def cat_indices(self, req: RestRequest) -> RestResponse:
        rows = []
        cs = self.node.cluster_state
        for name in self.node.indices.names():
            svc = self.node.indices.get(name)
            meta = cs.indices[name]
            health = "yellow" if meta.number_of_replicas > 0 else "green"
            rows.append(f"{health} open {name} {meta.uuid} {meta.number_of_shards} "
                        f"{meta.number_of_replicas} {svc.doc_count()} 0 0b 0b")
        return RestResponse(body="\n".join(rows) + ("\n" if rows else ""),
                            content_type="text/plain")

    def cat_health(self, req: RestRequest) -> RestResponse:
        h = self.node.cluster_state.health()
        line = (f"{int(time.time())} {time.strftime('%H:%M:%S')} {h['cluster_name']} "
                f"{h['status']} {h['number_of_nodes']} {h['number_of_data_nodes']} "
                f"{h['active_shards']} {h['active_primary_shards']} 0 0 "
                f"{h['unassigned_shards']} 0 - "
                f"{h['active_shards_percent_as_number']:.1f}%\n")
        return RestResponse(body=line, content_type="text/plain")

    def cat_shards(self, req: RestRequest) -> RestResponse:
        cs = self.node.cluster_state

        def node_name(nid):
            n = cs.nodes.get(nid)
            return n.name if n is not None else (nid or "")

        rows = []
        for index, shards in cs.routing.items():
            if not self.node.indices.has(index):
                continue
            svc = self.node.indices.get(index)
            for s in shards:
                kind = "p" if s.primary else "r"
                docs = svc.shards[s.shard_id].doc_count() if s.primary else 0
                node = node_name(s.node_id) if s.node_id else ""
                # a moving copy renders `source -> target` (ref: the cat
                # shards RELOCATING row); its INITIALIZING other half shows
                # where the bytes are coming from
                if s.state == "RELOCATING" and s.relocating_node_id:
                    node = f"{node} -> {node_name(s.relocating_node_id)}"
                rows.append(f"{index} {s.shard_id} {kind} {s.state} {docs} 0b "
                            f"{'127.0.0.1' if s.node_id else ''} {node}")
        return RestResponse(body="\n".join(rows) + ("\n" if rows else ""),
                            content_type="text/plain")

    # ---------- helpers ----------

    def _resolve(self, expression: str | None, require: bool = False) -> List[str]:
        expression = expression or "_all"
        names = self.node.cluster_state.resolve_indices(expression)
        if require and not names and expression not in ("_all", "*"):
            raise IndexNotFoundError(expression)
        return names



def _default_coalescer_stats() -> dict:
    from elasticsearch_tpu_torch.threadpool.coalescer import default_coalescer

    return default_coalescer().stats()


def _default_scheduler_stats() -> dict:
    from elasticsearch_tpu_torch.threadpool.scheduler import scheduler_stats

    return scheduler_stats()


def _turbo_merge_stats() -> dict:
    """Node-wide Turbo partition-merge counters: fused S > 1
    device dispatches, per-partition dispatch units they covered, and
    how many batch merges ran on device vs through the host _merge3."""
    from elasticsearch_tpu_torch.search.serving import turbo_node_stats

    return turbo_node_stats()


def _tpu_health_stats() -> dict:
    """Node-wide device-health section: per-engine circuit state
    + cumulative fault/fallback counters, plus the serving layer's
    containment counters (recovered shards, fast-path rejections/timeouts)
    and the coalescer's poison-batch retries."""
    from elasticsearch_tpu_torch.common.health import node_health_stats
    from elasticsearch_tpu_torch.search.serving import serving_fault_stats
    from elasticsearch_tpu_torch.threadpool.coalescer import default_coalescer

    out = node_health_stats()
    out.update(serving_fault_stats())
    out["coalesce_batch_retries"] = \
        default_coalescer().stats()["coalesce_batch_retries"]
    return out


def _tpu_search_latency_stats() -> dict:
    """Search flight-recorder section: per-phase latency histogram
    summaries (queue wait per pool, coalesce wait, device, demux, fetch,
    query, merge, rest_total — p50/p90/p99/max over log-spaced buckets),
    the coalescer's batch-size/pad-ratio distributions, and the slowlog
    ring counters. Always on: histograms record whether or not any
    request is traced."""
    from elasticsearch_tpu_torch.common import metrics, tracing

    out = metrics.search_latency_stats()
    out["slowlog"] = tracing.slowlog_stats()
    return out


def _tpu_coordinator_stats() -> dict:
    """Coordinator resilience section: shard failover retries, open
    node-transport circuits, abandoned RPCs, fetch-phase drops, plus the
    per-edge transport circuit states."""
    from elasticsearch_tpu_torch.action.search_action import coordinator_stats

    return coordinator_stats()


def _tpu_durability_stats() -> dict:
    """Write-path durability section: translog fsync failures and
    syncs, injected corruptions, segment-commit failures, crash-replay
    counts, replication retries/failures, peer-recovery outcomes, ghost
    cleanups, and the live async-durability exposure window — one flat
    section so a chaos run's acked-write accounting is auditable with a
    single GET."""
    from elasticsearch_tpu_torch.common.durability import durability_stats

    return durability_stats()


def _tpu_settings_stats() -> dict:
    """Effective ES_TPU_* knob values: every declared knob with its
    parsed value and whether it came from the environment or the default —
    so a chaos/bench run's exact configuration is observable, not inferred
    from shell history."""
    from elasticsearch_tpu_torch.common.settings import effective_knobs

    return effective_knobs()


def _tpu_hbm_stats() -> dict:
    """HBM residency section: per-engine device-byte occupancy
    (byte-identical to the engines' own hbm_bytes()), high watermark,
    eviction/churn counters, protected-slot pressure, budget headroom vs
    ES_TPU_TURBO_HBM, and the turbo_eligible routing log."""
    from elasticsearch_tpu_torch.common import hbm_ledger

    return hbm_ledger.hbm_stats()


def _overload_admission(node):
    """REST front-door admission check for `RestController.admission`:
    returns a 429 RestResponse with Retry-After when the node's overload
    controller sheds this request, None to admit."""
    from elasticsearch_tpu_torch.threadpool import (
        EsRejectedExecutionError, pool_for_request, tier_for_request,
    )

    def admission(method: str, path: str, params: Dict[str, str]):
        if pool_for_request(method, path) not in ("search", "write", "get"):
            return None
        tier = tier_for_request(method, path, params)
        retry_after = node.overload.admit(tier)
        if retry_after is None:
            return None
        err = EsRejectedExecutionError(
            f"[{node.node_name}] overload shed "
            f"({node.overload.stats()['level']}): {tier}-tier request on "
            f"[{path}]", tier=tier, retry_after_s=retry_after)
        return RestResponse(status=err.status, body=_error_body(err),
                            headers={"Retry-After":
                                     str(max(1, int(retry_after)))})

    return admission


def _tpu_agg_stats() -> dict:
    """Device analytics section: collects served on device,
    fused dispatches, host fallbacks, and the HBM bytes held by the
    engine's precomputed agg columns (reconciles with tpu_hbm's `agg`
    engine entry byte-for-byte)."""
    from elasticsearch_tpu_torch.search import agg_device

    return agg_device.agg_stats()


def _tpu_knn_stats() -> dict:
    """Quantized kNN section: queries, int8 first-pass
    dispatches, rescored candidates, certificate misses, host fallbacks,
    and the HBM bytes held by the quantized shards + centroids
    (reconciles with tpu_hbm's `knn` engine entry byte-for-byte)."""
    from elasticsearch_tpu_torch.parallel import knn

    return knn.knn_node_stats()


def _tpu_compile_stats() -> dict:
    """Compile-cache section: primed dispatch shapes, per-dispatch
    hit/miss counters, unplanned retraces, warmup coverage ratio, and the
    recent first-trace events with wall cost — the cold-start cliff and
    the scheduler bucket ladder, measured."""
    from elasticsearch_tpu_torch.common import hbm_ledger

    return hbm_ledger.compile_stats()


def _tpu_relocation_stats() -> dict:
    """Maintenance-plane section: completed moves, cancelled
    relocations, and the warm-HBM-handoff accounting (handoffs run, wall
    ms, fields warmed, qc shapes primed, best-effort failures)."""
    from elasticsearch_tpu_torch.common.relocation import relocation_stats

    return relocation_stats()


def _tpu_integrity_stats() -> dict:
    """Data-integrity plane section: segments verified/corrupted at
    rest, transfer hash verifications and retried transfers, corruption
    markers written/cleared, shard copies failed or quarantined for
    corruption, HBM scrub outcomes (ticks, mismatches, repairs, yields),
    repository verifies, and restore cleanups — the audit surface for the
    three integrity legs."""
    from elasticsearch_tpu_torch.common.integrity import integrity_stats

    return integrity_stats()


def _deep_merge(base: dict, patch: dict) -> dict:
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            base[k] = _deep_merge(dict(base[k]), v)
        else:
            base[k] = v
    return base
