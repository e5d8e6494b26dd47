"""REST API handlers: the user-facing surface (the port's copy of
elasticsearch_tpu/rest/handlers.py).

Implements the core of the reference's REST API (ref: the 138 Rest*Action
handlers under rest/action/ and the 144 specs in
rest-api-spec/src/main/resources/rest-api-spec/api/): document CRUD, bulk,
search/msearch/count/scroll/PIT, index admin, cluster/cat/nodes monitoring,
analyze, mget, update, delete-by-query, update-by-query, aliases, security,
snapshots, tasks, ingest pipelines, templates, lifecycle (close/open,
rollover, shrink/split/clone), async search, the cross-cluster admin routes
and the `_tpu` flight recorder and metrics. The route table is the
reference's. Response shapes follow the reference so existing clients can
switch over. `GET /_nodes` lists the node's torch device (``device.py``)
where the reference lists its jax devices.
"""

from __future__ import annotations

import json
import secrets
import time
from typing import Any, Dict, List

from elasticsearch_tpu_torch import __version__
from elasticsearch_tpu_torch.common.errors import (
    DocumentMissingError,
    ElasticsearchTpuError,
    IllegalArgumentError,
    IndexNotFoundError,
    ParsingError,
    VersionConflictError,
)
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.controller import (
    RestController, RestRequest, RestResponse, _error_body,
)
from elasticsearch_tpu_torch.search.queries import parse_query

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
    # security management
    r("GET", "/_security/_authenticate", h.security_authenticate)
    r("PUT", "/_security/user/{username}", h.security_put_user)
    r("POST", "/_security/user/{username}", h.security_put_user)
    r("DELETE", "/_security/user/{username}", h.security_delete_user)
    r("PUT", "/_security/role/{role}", h.security_put_role)
    r("POST", "/_security/role/{role}", h.security_put_role)
    r("GET", "/_security/role/{role}", h.security_get_role)
    r("DELETE", "/_security/role/{role}", h.security_delete_role)
    r("POST", "/_security/api_key", h.security_create_api_key)
    r("DELETE", "/_security/api_key", h.security_invalidate_api_key)
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
    r("POST", "/_reindex", h.reindex)
    r("GET", "/{index}/_termvectors/{id}", h.termvectors)
    r("POST", "/{index}/_termvectors/{id}", h.termvectors)
    r("POST", "/_render/template", h.render_template)
    r("GET", "/{index}/_search/template", h.search_template)
    r("POST", "/{index}/_search/template", h.search_template)
    r("GET", "/{index}/_rank_eval", h.rank_eval)
    r("POST", "/{index}/_rank_eval", h.rank_eval)
    r("POST", "/{index}/_async_search", h.async_search_submit)
    r("GET", "/_async_search/{id}", h.async_search_get)
    r("DELETE", "/_async_search/{id}", h.async_search_delete)
    r("GET", "/_field_caps", h.field_caps)
    r("POST", "/_field_caps", h.field_caps)
    r("GET", "/{index}/_field_caps", h.field_caps)
    r("POST", "/{index}/_field_caps", h.field_caps)
    r("GET", "/{index}/_explain/{id}", h.explain)
    r("POST", "/{index}/_explain/{id}", h.explain)
    # ingest pipelines (ref: RestPutPipelineAction, RestSimulatePipelineAction)
    r("PUT", "/_ingest/pipeline/{id}", h.put_pipeline)
    r("GET", "/_ingest/pipeline/{id}", h.get_pipeline)
    r("GET", "/_ingest/pipeline", h.get_pipelines)
    r("DELETE", "/_ingest/pipeline/{id}", h.delete_pipeline)
    r("POST", "/_ingest/pipeline/{id}/_simulate", h.simulate_pipeline)
    r("GET", "/_ingest/pipeline/{id}/_simulate", h.simulate_pipeline)
    r("POST", "/_ingest/pipeline/_simulate", h.simulate_pipeline)
    # snapshots (ref: RestPutRepositoryAction, RestCreateSnapshotAction,
    # RestRestoreSnapshotAction, RestDeleteSnapshotAction)
    r("PUT", "/_snapshot/{repo}", h.put_repository)
    r("POST", "/_snapshot/{repo}/_verify", h.verify_repository)
    r("GET", "/_snapshot/{repo}", h.get_repository)
    r("PUT", "/_snapshot/{repo}/{snapshot}", h.create_snapshot)
    r("POST", "/_snapshot/{repo}/{snapshot}", h.create_snapshot)
    r("GET", "/_snapshot/{repo}/{snapshot}", h.get_snapshot)
    r("DELETE", "/_snapshot/{repo}/{snapshot}", h.delete_snapshot)
    r("POST", "/_snapshot/{repo}/{snapshot}/_restore", h.restore_snapshot)
    r("GET", "/_tasks", h.list_tasks)
    r("POST", "/_tasks/_cancel", h.cancel_tasks)
    r("GET", "/_tasks/{task_id}", h.get_task)
    r("POST", "/_tasks/{task_id}/_cancel", h.cancel_task)
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
    r("PUT", "/_index_template/{name}", h.put_index_template)
    r("GET", "/_index_template/{name}", h.get_index_template)
    r("GET", "/_index_template", h.get_index_templates)
    r("DELETE", "/_index_template/{name}", h.delete_index_template)
    r("GET", "/_cluster/settings", h.get_cluster_settings)
    r("PUT", "/_cluster/settings", h.put_cluster_settings)
    r("GET", "/_cluster/health", h.cluster_health)
    r("GET", "/_cluster/state", h.cluster_state)
    r("GET", "/_cluster/stats", h.cluster_stats)
    r("POST", "/_cluster/reroute", h.cluster_reroute)
    r("GET", "/_nodes", h.nodes_info)
    r("GET", "/_nodes/stats", h.nodes_stats)
    r("GET", "/_nodes/hot_threads", h.hot_threads)
    # cross-cluster plane
    r("GET", "/_remote/info", h.remote_info)
    r("PUT", "/{index}/_ccr/follow", h.ccr_follow)
    r("POST", "/{index}/_ccr/follow", h.ccr_follow)
    r("POST", "/{index}/_ccr/pause_follow", h.ccr_pause_follow)
    r("POST", "/{index}/_ccr/resume_follow", h.ccr_resume_follow)
    r("GET", "/{index}/_ccr/stats", h.ccr_stats)
    # search flight recorder
    r("GET", "/_tpu/slowlog", h.tpu_slowlog)
    r("GET", "/_tpu/trace", h.tpu_traces)
    # device telemetry plane
    r("GET", "/_tpu/metrics", h.tpu_metrics)
    r("GET", "/_tpu/metrics/history", h.tpu_metrics_history)
    # lifecycle admin
    r("POST", "/{index}/_close", h.close_index)
    r("POST", "/{index}/_open", h.open_index)
    r("POST", "/{alias}/_rollover", h.rollover)
    r("POST", "/{alias}/_rollover/{new_index}", h.rollover)
    r("PUT", "/{index}/_shrink/{target}", h.resize_shrink)
    r("POST", "/{index}/_shrink/{target}", h.resize_shrink)
    r("PUT", "/{index}/_split/{target}", h.resize_split)
    r("POST", "/{index}/_split/{target}", h.resize_split)
    r("PUT", "/{index}/_clone/{target}", h.resize_clone)
    r("POST", "/{index}/_clone/{target}", h.resize_clone)
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
    # legacy (v1) index templates
    r("PUT", "/_template/{name}", h.put_legacy_template)
    r("POST", "/_template/{name}", h.put_legacy_template)
    r("GET", "/_template/{name}", h.get_legacy_template)
    r("GET", "/_template", h.get_legacy_templates)
    r("DELETE", "/_template/{name}", h.delete_legacy_template)
    r("HEAD", "/_template/{name}", h.head_legacy_template)
    # field-level mapping
    r("GET", "/{index}/_mapping/field/{fields}", h.get_field_mapping)
    r("GET", "/_mapping/field/{fields}", h.get_field_mapping)
    # cat
    r("GET", "/_cat/indices", h.cat_indices)
    r("GET", "/_cat/health", h.cat_health)
    r("GET", "/_cat/shards", h.cat_shards)
    r("GET", "/_cat/count", h.cat_count)
    r("GET", "/_cat/nodes", h.cat_nodes)
    r("GET", "/_cat/segments", h.cat_segments)
    r("GET", "/_cat/segments/{index}", h.cat_segments)
    r("GET", "/_cat/aliases", h.cat_aliases)
    r("GET", "/_cat/allocation", h.cat_allocation)
    r("GET", "/_cat/templates", h.cat_templates)
    r("GET", "/_cat/thread_pool", h.cat_thread_pool)
    r("GET", "/_cat/thread_pool/{name}", h.cat_thread_pool)
    r("GET", "/_cat/tasks", h.cat_tasks)


def _render_search_template(source, params: dict):
    """Mustache subset: {{var}} substitution + {{#toJson}}var{{/toJson}}
    (the two forms that cover the vast majority of real templates)."""
    import re as _re

    if isinstance(source, dict):
        source = json.dumps(source)
    if not isinstance(source, str):
        raise IllegalArgumentError("[source] template is required")
    out = _re.sub(
        r'"\{\{#toJson\}\}(\w+)\{\{/toJson\}\}"',
        lambda m: json.dumps(params.get(m.group(1))), source)
    out = _re.sub(
        r"\{\{(\w+)\}\}",
        lambda m: json.dumps(str(params.get(m.group(1), "")))[1:-1], out)
    try:
        return json.loads(out)
    except json.JSONDecodeError as e:
        raise IllegalArgumentError(f"failed to render template: {e}")


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

    # ---------- security (ref: x-pack security REST actions) ----------

    def _sec(self):
        sec = getattr(self.node, "security", None)
        if sec is None:
            raise IllegalArgumentError("security is not available")
        return sec

    def security_authenticate(self, req: RestRequest) -> RestResponse:
        sec = self._sec()
        if not sec.enabled:
            authn = None
        else:
            authn = sec.authenticate(req.headers)
        username = authn.username if authn else "_anonymous"
        roles = [r.name for r in authn.roles] if authn else ["superuser"]
        return _ok({"username": username, "roles": roles,
                    "enabled": True,
                    "authentication_type":
                        authn.auth_type if authn else "anonymous"})

    def security_put_user(self, req: RestRequest) -> RestResponse:
        body = req.body or {}
        self._sec().put_user(req.param("username"), body.get("password"),
                             body.get("roles", []))
        return _ok({"created": True})

    def security_delete_user(self, req: RestRequest) -> RestResponse:
        found = self._sec().delete_user(req.param("username"))
        return _ok({"found": found}, 200 if found else 404)

    def security_put_role(self, req: RestRequest) -> RestResponse:
        self._sec().put_role(req.param("role"), req.body or {})
        return _ok({"role": {"created": True}})

    def security_get_role(self, req: RestRequest) -> RestResponse:
        sec = self._sec()
        role = sec.roles.get(req.param("role"))
        if role is None:
            return _ok({}, 404)
        return _ok({role.name: {"cluster": role.cluster,
                                "indices": role.indices}})

    def security_delete_role(self, req: RestRequest) -> RestResponse:
        found = self._sec().delete_role(req.param("role"))
        return _ok({"found": found}, 200 if found else 404)

    def security_create_api_key(self, req: RestRequest) -> RestResponse:
        body = req.body or {}
        user = req.param("_authn_user", "elastic")
        roles = None
        owned = []
        if body.get("role_descriptors"):
            # inline role descriptors register as key-OWNED ad-hoc roles,
            # removed with the key on invalidation
            sec = self._sec()
            roles = []
            for rname, rbody in body["role_descriptors"].items():
                full = f"_api_key_{rname}_{secrets.token_hex(4)}"
                sec.put_role(full, rbody)
                roles.append(full)
            owned = list(roles)
        out = self._sec().create_api_key(user, body.get("name", ""), roles,
                                         owned_roles=owned)
        return _ok(out)

    def security_invalidate_api_key(self, req: RestRequest) -> RestResponse:
        body = req.body or {}
        ids = body.get("ids") or ([body["id"]] if body.get("id") else [])
        invalidated = [i for i in ids if self._sec().invalidate_api_key(i)]
        return _ok({"invalidated_api_keys": invalidated,
                    "error_count": len(ids) - len(invalidated)})

    # ---------- index admin ----------

    def create_index(self, req: RestRequest) -> RestResponse:
        name = req.param("index")
        meta = self.node.create_index(name, req.body or {})
        return _ok({"acknowledged": True, "shards_acknowledged": True, "index": name})

    def delete_index(self, req: RestRequest) -> RestResponse:
        for name in self._resolve(req.param("index"), require=True):
            self.node.delete_index(name)
        return _ok({"acknowledged": True})

    # ---- lifecycle admin (ref: action/admin/indices/{close,open,shrink,
    #      rollover}; MetadataRolloverService.java) ----

    def close_index(self, req: RestRequest) -> RestResponse:
        from dataclasses import replace

        names = self._resolve(req.param("index"), require=True)
        for name in names:
            svc = self.node.indices.get(name)
            svc.closed = True
            meta = self.node.cluster_state.indices[name]
            new_meta = replace(meta, state="close", version=meta.version + 1)
            routing = self.node.cluster_state.routing[name]
            self.node.update_state(lambda s, m=new_meta, r=routing:
                                   s.with_index(m, r))
        return _ok({"acknowledged": True, "shards_acknowledged": True,
                    "indices": {n: {"closed": True} for n in names}})

    def open_index(self, req: RestRequest) -> RestResponse:
        from dataclasses import replace

        for name in self._resolve(req.param("index"), require=True):
            svc = self.node.indices.get(name)
            svc.closed = False
            meta = self.node.cluster_state.indices[name]
            new_meta = replace(meta, state="open", version=meta.version + 1)
            routing = self.node.cluster_state.routing[name]
            self.node.update_state(lambda s, m=new_meta, r=routing:
                                   s.with_index(m, r))
        return _ok({"acknowledged": True, "shards_acknowledged": True})

    def rollover(self, req: RestRequest) -> RestResponse:
        """POST /{alias}/_rollover[/{new_index}] (ref:
        MetadataRolloverService.rolloverClusterState; shared mechanics in
        indices/rollover.py): evaluate conditions on the alias's write
        index; when met, create the next index in the -NNNNNN sequence and
        swap the alias."""
        from elasticsearch_tpu_torch.indices.rollover import (
            evaluate_rollover_conditions, next_rollover_name,
            rollover_alias_actions,
        )

        alias = req.param("alias")
        body = req.body or {}
        cs = self.node.cluster_state
        holders = [(n, cs.indices[n].aliases[alias])
                   for n in sorted(cs.indices) if alias in cs.indices[n].aliases]
        if not holders:
            raise IllegalArgumentError(
                f"rollover target [{alias}] does not point to any index")
        writers = [h for h in holders if h[1].get("is_write_index")]
        if len(holders) > 1 and len(writers) != 1:
            raise IllegalArgumentError(
                f"rollover target [{alias}] points to multiple indices "
                "without one write index")
        old_name, old_spec = writers[0] if writers else holders[0]
        svc = self.node.indices.get(old_name)
        meta = cs.indices[old_name]

        conditions = body.get("conditions", {}) or {}
        metrics = {
            "max_docs": svc.doc_count(),
            "max_age": int(time.time() * 1000) - meta.creation_date,
            "max_size": svc.store_size_bytes(),
            "max_primary_shard_size": svc.store_size_bytes()
            // max(len(svc.shards), 1),
            "max_primary_shard_docs": max(
                (e.doc_count() for e in svc.shards), default=0),
        }
        met = evaluate_rollover_conditions(conditions, metrics)
        rolled = (not conditions) or any(met.values())

        new_name = (req.param("new_index") or body.get("new_index")
                    or next_rollover_name(old_name))
        resp = {"acknowledged": False, "shards_acknowledged": False,
                "old_index": old_name, "new_index": new_name,
                "rolled_over": False, "dry_run": bool(body.get("dry_run")),
                "conditions": {f"[{c}: {conditions[c]}]": v
                               for c, v in met.items()}}
        if body.get("dry_run") or not rolled:
            return _ok(resp)

        create_body = {k: v for k, v in body.items()
                       if k in ("settings", "mappings", "aliases")}
        self.node.create_index(new_name, create_body)
        for action in rollover_alias_actions(alias, old_name, new_name,
                                             old_spec):
            op, spec = next(iter(action.items()))
            target = spec["index"]
            payload = None if op == "remove" else {
                k: v for k, v in spec.items() if k not in ("index", "alias")}
            self._set_alias(target, alias, payload)
        resp.update({"acknowledged": True, "shards_acknowledged": True,
                     "rolled_over": True})
        return _ok(resp)

    def resize_shrink(self, req: RestRequest) -> RestResponse:
        return self._resize(req, "shrink")

    def resize_split(self, req: RestRequest) -> RestResponse:
        return self._resize(req, "split")

    def resize_clone(self, req: RestRequest) -> RestResponse:
        return self._resize(req, "clone")

    def _resize(self, req: RestRequest, mode: str) -> RestResponse:
        """_shrink/_split/_clone (ref: action/admin/indices/shrink/
        TransportResizeAction.java): create the target with the adjusted
        shard count and re-route every live doc. TPU segments are HBM/host
        arrays, not files — rebuilding the columnar layout IS the resize
        (there is no hard-link shortcut to preserve), and the murmur3 _id
        routing re-partitions exactly. Custom ?routing values are not
        persisted per doc, so resized copies of custom-routed docs route
        by _id (documented divergence); a doc without a stored _source
        cannot be replayed and fails the resize up front."""
        source = req.param("index")
        target = req.param("target")
        svc = self.node.indices.get(source)
        if self.node.indices.has(target):
            from elasticsearch_tpu_torch.common.errors import (
                ResourceAlreadyExistsError,
            )

            raise ResourceAlreadyExistsError(
                f"index [{target}] already exists")
        body = req.body or {}
        src_meta = self.node.cluster_state.indices[source]
        src_n = src_meta.number_of_shards
        tgt_settings = dict((body.get("settings") or {}))
        tgt_n = int(tgt_settings.get(
            "index.number_of_shards",
            tgt_settings.get("number_of_shards",
                             src_n if mode != "shrink" else 1)))
        if mode == "shrink" and src_n % tgt_n != 0:
            raise IllegalArgumentError(
                f"the number of source shards [{src_n}] must be a multiple "
                f"of [{tgt_n}]")
        if mode == "split" and tgt_n % src_n != 0:
            raise IllegalArgumentError(
                f"the number of target shards [{tgt_n}] must be a multiple "
                f"of [{src_n}]")
        if mode == "clone" and tgt_n != src_n:
            raise IllegalArgumentError(
                "clone must keep the source's shard count")
        tgt_settings["index.number_of_shards"] = tgt_n
        self.node.create_index(target, {
            "settings": tgt_settings,
            "mappings": src_meta.mappings,
            "aliases": body.get("aliases", {}),
        })
        tgt_svc = self.node.indices.get(target)
        for engine in svc.shards:
            searcher = engine.acquire_searcher()
            for v in searcher.views:
                seg = v.segment
                for ord_ in range(seg.n_docs):
                    if not bool(v.live[ord_]):
                        continue
                    src_doc = seg.sources[ord_]
                    if src_doc is None:
                        raise IllegalArgumentError(
                            f"cannot resize [{source}]: doc "
                            f"[{seg.doc_ids[ord_]}] has no _source to "
                            "replay")
                    tgt_svc.index_doc(seg.doc_ids[ord_], src_doc)
        tgt_svc.refresh()
        return _ok({"acknowledged": True, "shards_acknowledged": True,
                    "index": target})

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

    def hot_threads(self, req: RestRequest) -> RestResponse:
        """ref: RestNodesHotThreadsAction — two-sample stack diff per node,
        fanned out across the cluster by the task plane; idle pool workers
        whose stacks didn't move between samples are elided."""
        return RestResponse(status=200,
                            body=self.node.task_plane.hot_threads(),
                            content_type="text/plain")

    # ---------- termvectors / templates(search) ----------

    def termvectors(self, req: RestRequest) -> RestResponse:
        """ref: RestTermVectorsAction — per-field term/freq/position stats
        for one document. REALTIME: the stored source is re-analyzed
        through the mapper (exactly what indexing did), so unrefreshed
        docs work and cost is O(doc terms), not O(vocabulary); df/ttf
        term statistics come from the postings for just the doc's terms."""
        names = self._resolve(req.param("index"), require=True)
        if len(names) != 1:
            raise IllegalArgumentError(
                "_termvectors requires exactly one concrete index")
        name = names[0]
        doc_id = req.param("id")
        svc = self.node.indices.get(name)
        source = svc.get_doc(doc_id)          # realtime (version map)
        if source is None:
            raise DocumentMissingError(f"[{doc_id}]: document missing")
        body = dict(req.body or {})
        want = body.get("fields") or req.param("fields")
        if isinstance(want, str):
            want = want.split(",")
        parsed = svc.mapper.parse(doc_id, source["_source"]
                                  if "_source" in source else source)
        engine = svc.shard_for(doc_id)
        searcher = engine.acquire_searcher()
        tv = {}
        field_terms = dict(parsed.inverted)
        for fname, values in parsed.keyword.items():
            field_terms.setdefault(fname, [(v, [0]) for v in values])
        for fname, entries in field_terms.items():
            if want and fname not in want:
                continue
            merged: Dict[str, list] = {}
            for term, positions in entries:
                merged.setdefault(term, []).extend(positions)
            terms_out = {}
            for t, positions in sorted(merged.items()):
                entry: Dict[str, Any] = {"term_freq": len(positions)}
                entry["tokens"] = [{"position": int(p)}
                                   for p in sorted(positions)]
                if body.get("term_statistics"):
                    df = ttf = 0
                    for v in searcher.views:
                        d, f = v.segment.term_stats(fname, t)
                        df += d
                        ttf += f
                    entry["doc_freq"] = df
                    entry["ttf"] = ttf
                terms_out[t] = entry
            if terms_out:
                stats = {}
                for v in searcher.views:
                    fp = v.segment.postings.get(fname)
                    if fp is None:
                        continue
                    stats["sum_doc_freq"] = stats.get("sum_doc_freq", 0) + \
                        int(fp.doc_freq.sum())
                    stats["sum_ttf"] = stats.get("sum_ttf", 0) + \
                        int(fp.total_term_freq.sum())
                    stats["doc_count"] = stats.get("doc_count", 0) + \
                        int((fp.doc_len > 0).sum())
                tv[fname] = {
                    "field_statistics": {
                        "sum_doc_freq": stats.get("sum_doc_freq", 0),
                        "doc_count": stats.get("doc_count", 0),
                        "sum_ttf": stats.get("sum_ttf", 0),
                    },
                    "terms": terms_out,
                }
        return _ok({"_index": name, "_id": doc_id, "found": True,
                    "term_vectors": tv})

    def render_template(self, req: RestRequest) -> RestResponse:
        body = dict(req.body or {})
        rendered = _render_search_template(
            body.get("source"), body.get("params") or {})
        return _ok({"template_output": rendered})

    def search_template(self, req: RestRequest) -> RestResponse:
        """ref: RestSearchTemplateAction (mustache module) — render the
        source template with params, then execute as a normal search."""
        body = dict(req.body or {})
        rendered = _render_search_template(
            body.get("source"), body.get("params") or {})
        sub = RestRequest("POST", "", dict(req.params), rendered)
        return self.search(sub)

    # ---------- index templates / cluster settings ----------

    def put_index_template(self, req: RestRequest) -> RestResponse:
        self.node.indices.put_template(req.param("name"),
                                       dict(req.body or {}))
        return _ok({"acknowledged": True})

    def get_index_template(self, req: RestRequest) -> RestResponse:
        import fnmatch as _fn

        name = req.param("name")
        out = [{"name": n, "index_template": t}
               for n, t in self.node.indices.templates.items()
               if _fn.fnmatchcase(n, name)]
        if not out and "*" not in name:
            e = ElasticsearchTpuError(
                f"index template matching [{name}] not found")
            e.status = 404
            raise e
        return _ok({"index_templates": out})

    def get_index_templates(self, req: RestRequest) -> RestResponse:
        return _ok({"index_templates": [
            {"name": n, "index_template": t}
            for n, t in self.node.indices.templates.items()]})

    def delete_index_template(self, req: RestRequest) -> RestResponse:
        self.node.indices.delete_template(req.param("name"))
        return _ok({"acknowledged": True})

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

    def cluster_reroute(self, req: RestRequest) -> RestResponse:
        """POST /_cluster/reroute (ref: RestClusterRerouteAction) —
        explicit `move` commands through the same allocation step the
        drain/rebalance deciders use; `dry_run` plans and discards. On a
        standalone node every move is explained-and-rejected (there is no
        second node), which is exactly what the reference answers too."""
        from elasticsearch_tpu_torch.cluster.allocation import AllocationService

        body = dict(req.body or {})
        commands = list(body.get("commands", []))
        dry_run = req.param_bool("dry_run") or bool(body.get("dry_run"))
        alloc = AllocationService()

        def plan(state, explain):
            st = state
            # commands address nodes by id OR name (the reference resolves
            # both in DiscoveryNodes#resolveNode)
            by_name = {n.name: nid for nid, n in st.nodes.items()}
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
                frm = frm if frm in st.nodes else by_name.get(frm, frm)
                to = to if to in st.nodes else by_name.get(to, to)
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
                moved = alloc.initiate_relocation(
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
        plan(self.node.cluster_state, explanations)
        if not dry_run:
            self.node.update_state(lambda st: alloc.reroute(plan(st, None)))
        return _ok({"acknowledged": True, "dry_run": dry_run,
                    "explanations": explanations,
                    "state": {"version": self.node.cluster_state.version}})

    # ---------- rank_eval (ref: modules/rank-eval RankEvalPlugin) ----------

    def rank_eval(self, req: RestRequest) -> RestResponse:
        body = dict(req.body or {})
        names = self._resolve(req.param("index"), require=True)
        metric_spec = body.get("metric", {"precision": {}})
        if not isinstance(metric_spec, dict) or len(metric_spec) != 1:
            raise IllegalArgumentError(
                "[metric] must name exactly one metric")
        (mname, mparams), = metric_spec.items()
        mparams = mparams or {}
        k = int(mparams.get("k", 10))
        details = {}
        scores = []
        for r in body.get("requests", []):
            rid = r["id"]
            rated = {(d["_index"], d["_id"]): int(d["rating"])
                     for d in r.get("ratings", [])}
            request = dict(r.get("request") or {})
            request.setdefault("size", k)
            if len(names) == 1:
                resp = self.node.indices.get(names[0]).search(request)
            else:
                resp = self._multi_index_search(names, request,
                                                "query_then_fetch")
            hits = resp["hits"]["hits"][:k]
            hit_rated = [rated.get((h["_index"], h["_id"]), None)
                         for h in hits]
            rel_thresh = int(mparams.get("relevant_rating_threshold", 1))
            relevant = [x is not None and x >= rel_thresh for x in hit_rated]
            if mname == "precision":
                denom = len(hits) if not mparams.get(
                    "ignore_unlabeled") else sum(
                    1 for x in hit_rated if x is not None)
                score = (sum(relevant) / denom) if denom else 0.0
            elif mname == "recall":
                total_rel = sum(1 for v in rated.values() if v >= rel_thresh)
                score = (sum(relevant) / total_rel) if total_rel else 0.0
            elif mname == "mean_reciprocal_rank":
                score = 0.0
                for i, ok in enumerate(relevant):
                    if ok:
                        score = 1.0 / (i + 1)
                        break
            elif mname == "dcg":
                import math

                # ref: DiscountedCumulativeGain — exponential gain
                score = sum((2 ** (x or 0) - 1) / math.log2(i + 2)
                            for i, x in enumerate(hit_rated))
            else:
                raise IllegalArgumentError(f"unknown metric [{mname}]")
            scores.append(score)
            details[rid] = {
                "metric_score": score,
                "unrated_docs": [{"_index": h["_index"], "_id": h["_id"]}
                                 for h, x in zip(hits, hit_rated)
                                 if x is None],
                "hits": [{"hit": {"_index": h["_index"], "_id": h["_id"],
                                  "_score": h.get("_score")},
                          "rating": x} for h, x in zip(hits, hit_rated)],
            }
        return _ok({"metric_score": (sum(scores) / len(scores)) if scores
                    else 0.0, "details": details, "failures": {}})

    # ---------- async search (ref: x-pack async-search) ----------

    _ASYNC_KEEP_S = 300.0
    _ASYNC_MAX = 100

    def _async_store(self):
        """Created eagerly in Node.__init__ (lazy creation would race under
        the threaded HTTP server); completed entries expire after keep-alive
        and the store is size-capped (the reference expires via keep_alive)."""
        import time as _time

        store = self.node._async_searches
        now = _time.monotonic()
        dead = [k for k, v in list(store.items())
                if not v["is_running"] and v.get("expires_at", 0) < now]
        for k in dead:
            store.pop(k, None)
        while len(store) > self._ASYNC_MAX:
            store.pop(next(iter(store)), None)
        return store

    def async_search_submit(self, req: RestRequest) -> RestResponse:
        import threading as _t
        import time as _time
        import uuid as _uuid

        names = self._resolve(req.param("index"), require=True)
        body = dict(req.body or {})
        wait_ms = 0
        if req.param("wait_for_completion_timeout") is not None:
            from elasticsearch_tpu_torch.tasks.task_manager import parse_timeout_ms

            wait_ms = parse_timeout_ms(
                req.param("wait_for_completion_timeout")) or 0
        sid = _uuid.uuid4().hex
        task = self.node.tasks.register("indices:data/read/async_search",
                                        f"async[{','.join(names)}]")
        entry = {"is_running": True, "is_partial": True, "response": None,
                 "error": None, "start": int(_time.time() * 1000),
                 "task": task, "done": _t.Event()}
        self._async_store()[sid] = entry

        def run():
            try:
                if len(names) == 1:
                    entry["response"] = self.node.indices.get(
                        names[0]).search(body, task=task)
                else:
                    entry["response"] = self._multi_index_search(
                        names, body, "query_then_fetch", task=task)
            except ElasticsearchTpuError as e:
                entry["error"] = e
            except Exception as e:  # noqa: BLE001 — a failed search must
                err = ElasticsearchTpuError(str(e))   # never report success
                err.status = 500
                entry["error"] = err
            finally:
                import time as _tt

                entry["is_running"] = False
                entry["is_partial"] = entry["response"] is None
                entry["expires_at"] = _tt.monotonic() + self._ASYNC_KEEP_S
                self.node.tasks.unregister(task)
                entry["done"].set()

        _t.Thread(target=run, daemon=True,
                  name=f"async-search-{sid[:8]}").start()
        if wait_ms:
            entry["done"].wait(wait_ms / 1000.0)
        return self._async_render(sid, entry)

    def _async_render(self, sid, entry) -> RestResponse:
        if entry["error"] is not None:
            e = entry["error"]
            return RestResponse(status=e.status,
                               body={"error": e.to_dict(), "id": sid})
        return _ok({
            "id": sid,
            "is_running": entry["is_running"],
            "is_partial": entry["is_running"] or entry["response"] is None,
            "start_time_in_millis": entry["start"],
            "response": entry["response"] or {
                "hits": {"total": {"value": 0, "relation": "gte"},
                         "hits": []}},
        })

    def async_search_get(self, req: RestRequest) -> RestResponse:
        entry = self._async_store().get(req.param("id"))
        if entry is None:
            e = ElasticsearchTpuError(
                f"async search [{req.param('id')}] not found")
            e.status = 404
            raise e
        return self._async_render(req.param("id"), entry)

    def async_search_delete(self, req: RestRequest) -> RestResponse:
        entry = self._async_store().pop(req.param("id"), None)
        if entry is None:
            e = ElasticsearchTpuError("not found")
            e.status = 404
            raise e
        if entry["is_running"]:
            entry["task"].cancel("async search deleted")
        return _ok({"acknowledged": True})

    # ---------- reindex / field_caps / explain ----------

    def reindex(self, req: RestRequest) -> RestResponse:
        """Server-side scan + bulk copy (ref: RestReindexAction /
        reindex module): source index (+ optional query) into dest,
        optionally through an ingest pipeline."""
        body = dict(req.body or {})
        src_spec = body.get("source") or {}
        dest_spec = body.get("dest") or {}
        src_names = self._resolve(src_spec.get("index"), require=True)
        dest = dest_spec.get("index")
        if not dest:
            raise IllegalArgumentError("[dest.index] is required")
        pipeline = dest_spec.get("pipeline")
        op_type = dest_spec.get("op_type", "index")
        query = src_spec.get("query", {"match_all": {}})
        start = time.monotonic()
        created = updated = noops = conflicts = 0
        failures: list = []
        with self.node.tasks.task("indices:data/write/reindex",
                                  f"reindex to [{dest}]") as task:
            if not self.node.indices.has(dest):
                self.node.create_index(dest, {})
            dsvc = self.node.indices.get(dest)
            for name in src_names:
                svc = self.node.indices.get(name)
                # scan via the cursor machinery (stable under writes)
                body_q = {"query": query, "size": 500, "_want_cursor": True}
                resp = svc._search_dense(dict(body_q), task=task)
                while True:
                    hits = resp["hits"]["hits"]
                    if not hits:
                        break
                    for h in hits:
                        task.check()
                        source = h.get("_source", {})
                        doc_id = h["_id"]
                        routed = self._run_pipeline(dest, doc_id, source,
                                                    pipeline)
                        if routed is None:
                            noops += 1
                            continue
                        source, d_index, doc_id = routed
                        target = dsvc if d_index == dest else None
                        if target is None:
                            if not self.node.indices.has(d_index):
                                self.node.create_index(d_index, {})
                            target = self.node.indices.get(d_index)
                        try:
                            r = target.index_doc(doc_id, source,
                                                 op_type=op_type)
                            if r.result == "created":
                                created += 1
                            else:
                                updated += 1
                        except VersionConflictError:
                            conflicts += 1
                        except ElasticsearchTpuError as e:
                            # non-conflict errors (mapping conflicts etc.)
                            # must surface in `failures`, not masquerade as
                            # version_conflicts (ref: reindex module's
                            # BulkByScrollResponse)
                            failures.append({
                                "index": d_index, "id": doc_id,
                                "cause": {"type": e.error_type,
                                          "reason": str(e)},
                                "status": e.status})
                    cursor = resp.get("_cursor")
                    if cursor is None:
                        break
                    resp = svc._search_dense({**body_q, "_after_full": cursor},
                                             task=task)
            dsvc.refresh()
        return _ok({"took": int((time.monotonic() - start) * 1000),
                    "timed_out": False, "total": created + updated + noops,
                    "created": created, "updated": updated, "noops": noops,
                    "failures": failures, "batches": 1,
                    "version_conflicts": conflicts})

    def field_caps(self, req: RestRequest) -> RestResponse:
        """ref: RestFieldCapabilitiesAction — per-field type/searchable/
        aggregatable union across the target indices."""
        import fnmatch as _fn

        body = dict(req.body or {})
        pattern = req.param("fields") or body.get("fields", "*")
        if isinstance(pattern, str):
            pattern = pattern.split(",")
        names = self._resolve(req.param("index", "_all"), require=True)
        fields: Dict[str, dict] = {}
        for name in names:
            mapper = self.node.indices.get(name).mapper
            for fname in mapper.field_names():
                ft = mapper.field_type(fname)
                if not any(_fn.fnmatchcase(fname, p) for p in pattern):
                    continue
                type_ = ft.params.get("type", "object")
                caps = fields.setdefault(fname, {}).setdefault(type_, {
                    "type": type_,
                    "metadata_field": False,
                    "searchable": ft.searchable,
                    "aggregatable": ft.has_doc_values,
                })
        return _ok({"indices": names, "fields": fields})

    def explain(self, req: RestRequest) -> RestResponse:
        """ref: RestExplainAction — does this doc match, and with what
        score? Executed by filtering the query to the single document."""
        name = self._resolve(req.param("index"), require=True)[0]
        doc_id = req.param("id")
        svc = self.node.indices.get(name)
        if svc.get_doc(doc_id) is None:
            from elasticsearch_tpu_torch.common.errors import DocumentMissingError

            raise DocumentMissingError(f"[{doc_id}]: document missing")
        body = dict(req.body or {})
        query = body.get("query", {"match_all": {}})
        r = svc.search({"query": {"bool": {
            "must": [query], "filter": [{"ids": {"values": [doc_id]}}]}},
            "size": 1})
        hits = r["hits"]["hits"]
        matched = bool(hits) and hits[0]["_id"] == doc_id
        score = hits[0]["_score"] if matched else 0.0
        return _ok({"_index": name, "_id": doc_id, "matched": matched,
                    "explanation": {
                        "value": score,
                        "description": "score, computed as the sum of the "
                                       "matching clauses' BM25 contributions",
                        "details": [],
                    } if matched else {"value": 0.0,
                                       "description": "no matching term",
                                       "details": []}})

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

    def put_pipeline(self, req: RestRequest) -> RestResponse:
        self.node.ingest.put_pipeline(req.param("id"), dict(req.body or {}))
        return _ok({"acknowledged": True})

    def get_pipeline(self, req: RestRequest) -> RestResponse:
        p = self.node.ingest.get_pipeline(req.param("id"))
        return _ok({p.id: p.body})

    def get_pipelines(self, req: RestRequest) -> RestResponse:
        return _ok(self.node.ingest.pipelines())

    def delete_pipeline(self, req: RestRequest) -> RestResponse:
        self.node.ingest.delete_pipeline(req.param("id"))
        return _ok({"acknowledged": True})

    def simulate_pipeline(self, req: RestRequest) -> RestResponse:
        body = dict(req.body or {})
        if req.param("id"):
            pipeline_body = self.node.ingest.get_pipeline(req.param("id")).body
        else:
            pipeline_body = body.get("pipeline", {})
        docs = self.node.ingest.simulate(pipeline_body, body.get("docs", []))
        return _ok({"docs": docs})

    # ---------- snapshots ----------

    def put_repository(self, req: RestRequest) -> RestResponse:
        body = dict(req.body or {})
        self.node.snapshots.put_repository(
            req.param("repo"), body.get("type", ""),
            body.get("settings", {}))
        return _ok({"acknowledged": True})

    def get_repository(self, req: RestRequest) -> RestResponse:
        repo = self.node.snapshots.repository(req.param("repo"))
        return _ok({repo.name: {"type": "fs",
                                "settings": {"location": repo.location}}})

    def verify_repository(self, req: RestRequest) -> RestResponse:
        """POST /_snapshot/{repo}/_verify — probe round-trip plus a full
        re-hash of every referenced segment blob (integrity plane);
        corrupt blobs come back as per-index lists, not a bare boolean."""
        return _ok(self.node.snapshots.verify_repository(req.param("repo")))

    def create_snapshot(self, req: RestRequest) -> RestResponse:
        body = dict(req.body or {})
        indices = body.get("indices")
        if isinstance(indices, str):
            indices = [i for n in indices.split(",")
                       for i in self._resolve(n, require=True)]
        meta = self.node.snapshots.create(
            req.param("repo"), req.param("snapshot"), indices)
        return _ok({"snapshot": meta})

    def get_snapshot(self, req: RestRequest) -> RestResponse:
        import fnmatch

        snap = req.param("snapshot")
        if snap == "_all" or "*" in snap:
            snaps = self.node.snapshots.list(req.param("repo"))
            if snap != "_all":
                snaps = [s for s in snaps
                         if fnmatch.fnmatchcase(s["snapshot"], snap)]
            return _ok({"snapshots": snaps})
        return _ok({"snapshots": [
            self.node.snapshots.get(req.param("repo"), snap)]})

    def delete_snapshot(self, req: RestRequest) -> RestResponse:
        self.node.snapshots.delete(req.param("repo"), req.param("snapshot"))
        return _ok({"acknowledged": True})

    def restore_snapshot(self, req: RestRequest) -> RestResponse:
        body = dict(req.body or {})
        indices = body.get("indices")
        if isinstance(indices, str):
            indices = indices.split(",")
        return _ok(self.node.snapshots.restore(
            req.param("repo"), req.param("snapshot"), indices,
            body.get("rename_pattern"), body.get("rename_replacement")))

    # ---------- tasks (ref: RestListTasksAction, RestCancelTasksAction) ----------

    def list_tasks(self, req: RestRequest) -> RestResponse:
        """Cluster-wide listing via the task plane: fans out over every
        cluster node, degrades to partial results + `node_failures` when
        a peer is dead (ref: TransportListTasksAction)."""
        return _ok(self.node.task_plane.list(
            actions=req.param("actions"),
            nodes=req.param("nodes"),
            parent_task_id=req.param("parent_task_id"),
            detailed=req.param_bool("detailed"),
            group_by=req.param("group_by", "nodes")))

    def get_task(self, req: RestRequest) -> RestResponse:
        # routed by the `{node}:{id}` prefix — a remote owner answers over
        # the transport; an unknown/dead owner 404s (malformed ids 400)
        return _ok(self.node.task_plane.get(req.param("task_id", "")))

    def cancel_task(self, req: RestRequest) -> RestResponse:
        from elasticsearch_tpu_torch.tasks.task_manager import parse_timeout_ms

        return _ok(self.node.task_plane.cancel(
            req.param("task_id", ""),
            wait_for_completion=req.param_bool("wait_for_completion"),
            timeout_ms=parse_timeout_ms(req.param("timeout"))))

    def cancel_tasks(self, req: RestRequest) -> RestResponse:
        actions = req.param("actions", "*")
        cancelled = self.node.tasks.cancel_matching(actions)
        return _ok({"nodes": {self.node.tasks.node_id: {
            "tasks": {f"{t.node}:{t.id}": t.to_dict() for t in cancelled}}}})

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

    # ---- cross-cluster plane ----

    def remote_info(self, req: RestRequest) -> RestResponse:
        """GET /_remote/info (ref: RestRemoteClusterInfoAction)."""
        return _ok(self.node.remotes.remote_info())

    def ccr_follow(self, req: RestRequest) -> RestResponse:
        """PUT /{index}/_ccr/follow (ref: RestPutFollowAction)."""
        body = dict(req.body or {})
        remote_cluster = body.get("remote_cluster")
        leader_index = body.get("leader_index")
        if not remote_cluster or not leader_index:
            raise IllegalArgumentError(
                "_ccr/follow requires [remote_cluster] and [leader_index]")
        return _ok(self.node.ccr.follow(
            req.param("index"), remote_cluster, leader_index,
            settings=body.get("settings")))

    def ccr_pause_follow(self, req: RestRequest) -> RestResponse:
        return _ok(self.node.ccr.pause_follow(req.param("index")))

    def ccr_resume_follow(self, req: RestRequest) -> RestResponse:
        return _ok(self.node.ccr.resume_follow(req.param("index")))

    def ccr_stats(self, req: RestRequest) -> RestResponse:
        """GET /{index}/_ccr/stats (ref: RestFollowStatsAction)."""
        return _ok(self.node.ccr.follower_stats(req.param("index")))

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

    def tpu_metrics(self, req: RestRequest) -> RestResponse:
        """GET /_tpu/metrics — every declared counter/gauge/histogram from
        all live nodes as one Prometheus text exposition (histograms in
        cumulative-`le` form); dead peers degrade to es_tpu_node_up 0."""
        text, _failures = self.node.telemetry_plane.prometheus()
        return RestResponse(body=text,
                            content_type="text/plain; version=0.0.4")

    def tpu_metrics_history(self, req: RestRequest) -> RestResponse:
        """GET /_tpu/metrics/history — the sampler ring: periodic
        counter/gauge snapshots (ES_TPU_METRICS_SAMPLE_S) plus provider
        sections like the scheduler's per-lane busy fraction, so rates
        are computable without an external scraper."""
        from elasticsearch_tpu_torch.common import metrics as _m
        from elasticsearch_tpu_torch.common.settings import knob

        samples = _m.metrics_history()
        return _ok({"interval_s": knob("ES_TPU_METRICS_SAMPLE_S"),
                    "capacity": knob("ES_TPU_METRICS_HISTORY"),
                    "sampler_running": _m.maybe_start_sampler(),
                    "samples": samples})

    def tpu_slowlog(self, req: RestRequest) -> RestResponse:
        """GET /_tpu/slowlog — the bounded in-memory search slowlog ring:
        structured over-threshold records (phase, level, index, took_ms,
        query source, trace id + per-phase breakdown when traced), newest
        last, plus the cumulative per-level counters."""
        from elasticsearch_tpu_torch.common import tracing

        return _ok({"slowlog": tracing.slowlog_entries(),
                    **tracing.slowlog_stats()})

    def tpu_traces(self, req: RestRequest) -> RestResponse:
        """GET /_tpu/trace — the flight-recorder ring: recently completed
        traced requests with their spans (bounded by ES_TPU_TRACE_RING)."""
        from elasticsearch_tpu_torch.common import tracing

        return _ok({"traces": tracing.recent_traces()})

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

    # ---------- legacy (v1) index templates (ref:
    #            MetadataIndexTemplateService legacy put/get) ----------

    def _legacy_templates(self) -> dict:
        if not hasattr(self.node, "_legacy_templates"):
            self.node._legacy_templates = {}
        return self.node._legacy_templates

    def put_legacy_template(self, req: RestRequest) -> RestResponse:
        body = req.body or {}
        if "index_patterns" not in body and "template" not in body:
            raise IllegalArgumentError(
                "index_template [missing index_patterns]")
        name = req.param("name")
        stored = dict(body)
        pats = stored.get("index_patterns")
        if isinstance(pats, str):
            stored["index_patterns"] = [pats]
        self._legacy_templates()[name] = stored
        # bridge onto the composable registry so creation-time application
        # uses one mechanism
        patterns = body.get("index_patterns") or [body.get("template")]
        if isinstance(patterns, str):
            patterns = [patterns]
        self.node.indices.put_template("__legacy__" + name, {
            "index_patterns": patterns,
            "template": {k: v for k, v in body.items()
                         if k in ("settings", "mappings", "aliases")},
            "priority": int(body.get("order", 0)),
        })
        return _ok({"acknowledged": True})

    def get_legacy_template(self, req: RestRequest) -> RestResponse:
        import fnmatch as _fn

        want = req.param("name")
        store = self._legacy_templates()
        pats = [p.strip() for p in want.split(",")] if want else ["*"]
        out = {n: b for n, b in store.items()
               if any(_fn.fnmatchcase(n, p) for p in pats)}
        if want and not any("*" in p for p in pats) and not out:
            return _ok({"error": f"template [{want}] missing",
                        "status": 404}, 404)
        return _ok(out)

    def get_legacy_templates(self, req: RestRequest) -> RestResponse:
        return _ok(dict(self._legacy_templates()))

    def delete_legacy_template(self, req: RestRequest) -> RestResponse:
        name = req.param("name")
        if name not in self._legacy_templates():
            return _ok({"error": f"index_template [{name}] missing",
                        "status": 404}, 404)
        del self._legacy_templates()[name]
        try:
            self.node.indices.delete_template("__legacy__" + name)
        except Exception:  # noqa: BLE001 — bridge entry may be absent
            pass
        return _ok({"acknowledged": True})

    def head_legacy_template(self, req: RestRequest) -> RestResponse:
        ok = req.param("name") in self._legacy_templates()
        return RestResponse(status=200 if ok else 404, body={})

    def get_field_mapping(self, req: RestRequest) -> RestResponse:
        """GET /{index}/_mapping/field/{fields} (ref:
        TransportGetFieldMappingsAction)."""
        import fnmatch as _fn

        fields = [f.strip() for f in req.param("fields", "").split(",")]
        out = {}
        for name in self._resolve(req.param("index", "_all"), require=False):
            svc = self.node.indices.get(name)
            props = svc.mapper.mapping().get("properties", {})
            matched = {}
            for fname, fdef in props.items():
                if any(_fn.fnmatchcase(fname, p) for p in fields):
                    matched[fname] = {"full_name": fname,
                                      "mapping": {fname.split(".")[-1]: fdef}}
            out[name] = {"mappings": matched}
        return _ok(out)

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

    def cat_allocation(self, req: RestRequest) -> RestResponse:
        n_shards = sum(1 for shards in self.node.cluster_state.routing.values()
                       for r in shards if r.state == "STARTED")
        return RestResponse(
            status=200,
            body=f"{n_shards} {self.node.node_name}\n",
            content_type="text/plain")

    def cat_count(self, req: RestRequest) -> RestResponse:
        total = sum(self.node.indices.get(n).doc_count() for n in self.node.indices.names())
        return RestResponse(body=f"{int(time.time())} {time.strftime('%H:%M:%S')} {total}\n",
                            content_type="text/plain")

    def cat_segments(self, req: RestRequest) -> RestResponse:
        lines = []
        for name in self._resolve(req.param("index", "_all")):
            svc = self.node.indices.get(name)
            for sid, engine in enumerate(svc.shards):
                se = engine.acquire_searcher()
                for v in se.views:
                    lines.append(
                        f"{name} {sid} _{v.segment.seg_id} "
                        f"{int(v.live.sum())} "
                        f"{v.segment.n_docs - int(v.live.sum())} "
                        f"{v.segment.ram_bytes()}")
        return RestResponse(status=200, body="\n".join(lines) + "\n",
                            content_type="text/plain")

    def cat_aliases(self, req: RestRequest) -> RestResponse:
        lines = []
        for name, meta in self.node.cluster_state.indices.items():
            for alias in meta.aliases:
                lines.append(f"{alias} {name} - - - -")
        return RestResponse(status=200, body="\n".join(lines) + "\n",
                            content_type="text/plain")

    def cat_templates(self, req: RestRequest) -> RestResponse:
        lines = [f"{n} [{','.join(t['index_patterns'])}] {t['priority']}"
                 for n, t in self.node.indices.templates.items()]
        return RestResponse(status=200, body="\n".join(lines) + "\n",
                            content_type="text/plain")

    def cat_nodes(self, req: RestRequest) -> RestResponse:
        rows = [f"127.0.0.1 0 0 - cdfhilmrstw * {self.node.node_name}"]
        return RestResponse(body="\n".join(rows) + "\n", content_type="text/plain")

    def cat_thread_pool(self, req: RestRequest) -> RestResponse:
        """GET /_cat/thread_pool[/{name}] — the reference's default
        columns (node_name name active queue rejected) extended with the
        flight recorder's queue-wait view: the smoothed queue-wait EWMA
        and the queue-wait histogram p99 per pool."""
        import fnmatch as _fn

        from elasticsearch_tpu_torch.common import metrics

        want = req.param("name")
        pats = [p.strip() for p in want.split(",")] if want else None
        rows = []
        for name, st in sorted(self.node.thread_pool.stats().items()):
            if pats and not any(_fn.fnmatchcase(name, p) for p in pats):
                continue
            s = metrics.summary(f"queue_wait.{name}")
            p99 = s["p99"] if s else 0.0
            rows.append(f"{self.node.node_name} {name} {st['active']} "
                        f"{st['queue']} {st['rejected']} "
                        f"{st['queue_ewma_ms']} {p99}")
        return RestResponse(body="\n".join(rows) + ("\n" if rows else ""),
                            content_type="text/plain")

    def cat_tasks(self, req: RestRequest) -> RestResponse:
        """GET /_cat/tasks — cluster-wide flat task rows via the task
        plane's fan-out (ref: RestCatTasksAction default columns)."""
        rows = self.node.task_plane.cat_rows(
            detailed=req.param_bool("detailed"))
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
