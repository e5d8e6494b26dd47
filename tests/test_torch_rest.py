"""The port's REST node against the reference's, on the CPU.

The 15 cases of tests/test_rest.py run on twin nodes: every call goes through
the reference's `Node` + `RestController.dispatch` and through the port's
(`Node(device="cpu")`), on the same documents. The statuses must be equal,
and so must the bodies once the keys in VOLATILE are dropped. Search hits
are held in two modes, as in tests/test_torch_index_service.py:

* `turbo` (ES_TPU_FORCE_TURBO=1, ES_TPU_TURBO_COLD_DF=8): ids, order and
  totals equal, scores bitwise (`assert_bitwise`);
* `default`: both nodes serve disjunctions through BlockMax, the port's
  answers held to the reference's BlockMax answers (and every other body
  to the reference's dense executor): ids, order and totals equal, scores
  within `assert_same_results`'s bound (the two BlockMax engines sum a
  doc's terms in different orders, ROADMAP W2).

Each case also keeps its assertions from tests/test_rest.py, on the port's
responses. The reference's calls run with ES_TPU_COALESCE_US=0 (its lane
threads' jax compiles stalled the process; see `_no_batching`).

Then the port alone: the real HTTP round trip, a saturated search pool
answering 429, `python -m elasticsearch_tpu_torch --device cpu` serving in
a process where jax and the reference are refused, the `/_nodes/stats`
sections, the port's stated divergences, and the device-memory ledger's
books that the overload controller reads.
"""

import contextlib
import copy
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest import (
    HttpServer as RefHttpServer, RestController as RefRestController,
    register_handlers as ref_register_handlers,
)
from elasticsearch_tpu_torch.common.errors import DeviceUnavailableError
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest import (
    HttpServer, RestController, register_handlers,
)
from test_torch_index_service import (
    TURBO_ENV, _no_batching, assert_bitwise, assert_same_results,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# Keys whose values differ between any two nodes, or between two runs of
# one node: they are dropped (at any depth) before the bodies are compared.
VOLATILE = {
    "took",                     # wall time
    "uuid", "cluster_uuid",     # random per index / cluster
    "creation_date",            # index creation timestamp
    "allocation_id",            # random per shard copy
    "jvm",                      # node uptime
    "accelerators",             # jax devices vs the torch device
}
# /_nodes/stats: every section is a set of live counters; the bodies are
# compared by their key sets (test_nodes_stats_sections holds those).
STATS_PATH = "/_nodes/stats"
# reference knobs the port does not declare: none, the port declares all
UNPORTED_KNOBS: set = set()


# ---------------------------------------------------------------------------
# twin nodes
# ---------------------------------------------------------------------------


def _is_search_response(d):
    return (isinstance(d, dict) and isinstance(d.get("hits"), dict)
            and isinstance(d["hits"].get("hits"), list))


def _hold_hits(got, want, mode, where):
    """Hold every search response inside `got` to the one at the same place
    in `want` by the mode's contract; return both with the hits cut out."""
    if _is_search_response(got) and _is_search_response(want) and any(
            h.get("_score") is not None
            for h in got["hits"]["hits"] + want["hits"]["hits"]):
        # (a sorted search scores nothing: its hits are compared whole)
        if mode == "turbo":
            assert_bitwise(got, want, where)
        else:
            assert_same_results(got, want, where)
        got = dict(got, hits={k: v for k, v in got["hits"].items()
                              if k not in ("hits", "max_score")})
        want = dict(want, hits={k: v for k, v in want["hits"].items()
                                if k not in ("hits", "max_score")})
    if isinstance(got, dict) and isinstance(want, dict):
        return ({k: _hold_hits(v, want.get(k), mode, where)[0]
                 for k, v in got.items()},
                {k: _hold_hits(got.get(k), v, mode, where)[1]
                 for k, v in want.items()})
    if isinstance(got, list) and isinstance(want, list) \
            and len(got) == len(want):
        pairs = [_hold_hits(a, b, mode, where) for a, b in zip(got, want)]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return got, want


def _strip(d, volatile=VOLATILE):
    if isinstance(d, dict):
        return {k: _strip(v, volatile) for k, v in d.items()
                if k not in volatile}
    if isinstance(d, list):
        return [_strip(v, volatile) for v in d]
    return d


def _keys(d):
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    return None


def _ledger_keys(d):
    """`_keys` of a ledger section, with the per-engine entries (labelled
    by a process-wide sequence number, their regions whatever each engine
    holds) collapsed to their distinct key sets."""
    out = _keys(d)
    if "engines" in out:
        out["engines"] = sorted({tuple(sorted(v))
                                 for v in out["engines"].values()})
    return out


def _cat_rows(text):
    # _cat tables: the column of index uuids is volatile
    return re.sub(r"\b[0-9a-f]{20}\b", "<uuid>", text)


def compare(got, want, mode, method, path, volatile=VOLATILE):
    """The port's response `got` against the reference's `want`, keys in
    `volatile` dropped."""
    where = (method, path)
    assert got.status == want.status, (where, got.body, want.body)
    g, w = got.body, want.body
    if isinstance(g, str) or isinstance(w, str):
        assert isinstance(g, str) and isinstance(w, str), where
        assert _cat_rows(g) == _cat_rows(w), where
        return
    if path.split("?")[0] == STATS_PATH:
        gk, wk = _keys(g), _keys(w)
        for nodes in (gk, wk):
            nodes["nodes"] = sorted(nodes["nodes"].values(),
                                    key=lambda v: sorted(v))
        gs = [set(n) for n in gk["nodes"]]
        ws = [set(n) for n in wk["nodes"]]
        assert gs == ws, where
        return
    g, w = _hold_hits(g, w, mode, where)
    g, w = _strip(g, volatile), _strip(w, volatile)
    assert g == w, (where, g, w)


class Twin:
    """One call, two nodes: the reference's answer is the expected one.

    `settings` (a dict) goes to both nodes. Random ids the two nodes hand
    out (node ids, auto document ids, and the top-level `ID_KEYS` of a
    response: API keys, async searches) are mapped: the port's id -> the
    reference's, so that a later call naming the port's id reaches the
    reference with its own, in the path, the body and the headers."""

    # top-level response keys that carry an id the node drew at random
    ID_KEYS = ("id", "api_key", "encoded")
    volatile = VOLATILE

    def __init__(self, mode, settings=None):
        self.mode = mode
        self.ref = RefNode(RefSettings(settings) if settings else None)
        self.ref_rc = RefRestController()
        ref_register_handlers(self.ref, self.ref_rc)
        self.node = Node(Settings(settings) if settings else None,
                         device="cpu")
        self.rc = RestController()
        register_handlers(self.node, self.rc)
        # random ids, the node's and the auto-generated documents': the
        # port's id -> the reference's id
        self.ids = {self.node.node_id: self.ref.node_id}

    def _ref_text(self, s):
        for port_id, ref_id in self.ids.items():
            s = s.replace(port_id, ref_id)
        return s

    def translate(self, want):
        """The reference's response with its random ids replaced by the
        port's."""
        if isinstance(want.body, (dict, list)):
            text = json.dumps(want.body)
        elif isinstance(want.body, str):
            text = want.body
        else:
            return want
        for port_id, ref_id in self.ids.items():
            text = text.replace(ref_id, port_id)
        want.body = json.loads(text) if not isinstance(want.body, str) \
            else text
        return want

    def learn(self, got, want):
        """Map the random ids of a response pair."""
        if not (isinstance(got.body, dict) and isinstance(want.body, dict)):
            return
        for key in self.ID_KEYS:
            a, b = got.body.get(key), want.body.get(key)
            if isinstance(a, str) and isinstance(b, str) and a != b \
                    and len(a) >= 16:
                self.ids[a] = b

    def call(self, method, path, body=None, params=None, headers=None):
        if isinstance(body, (dict, list)):
            body = json.dumps(body)
        params = params or {}
        ref_body = self._ref_text(body) if isinstance(body, str) else body
        ref_headers = {k: self._ref_text(v)
                       for k, v in (headers or {}).items()}
        with _no_batching():
            want = self.ref_rc.dispatch(
                method, self._ref_text(path),
                {k: self._ref_text(v) for k, v in params.items()},
                ref_body, headers=ref_headers)
        got = self.rc.dispatch(method, path, dict(params), body,
                               headers=dict(headers or {}))
        if (method == "POST" and re.fullmatch(r"/[^/]+/_doc", path)
                and got.status == 201 and want.status == 201):
            self.ids[got.body["_id"]] = want.body["_id"]
        self.learn(got, want)
        compare(got, self.translate(want), self.mode, method, path,
                self.volatile)
        return got

    def close(self):
        self.node.close()
        self.ref.close()


@contextlib.contextmanager
def _mode_env(mode):
    mp = pytest.MonkeyPatch()
    for key in TURBO_ENV:
        mp.delenv(key, raising=False)
    if mode == "turbo":
        for key, val in TURBO_ENV.items():
            mp.setenv(key, val)
    try:
        yield
    finally:
        mp.undo()


# ---------------------------------------------------------------------------
# the cases of tests/test_rest.py, each a sequence of twin calls
# ---------------------------------------------------------------------------


def case_root_info(call, node):
    r = call("GET", "/")
    assert r.status == 200
    assert r.body["tagline"] == "You Know, for Search"
    assert r.body["version"]["build_flavor"] == "tpu"


def case_index_crud(call, node):
    r = call("PUT", "/books", {"settings": {"number_of_shards": 2},
                               "mappings": {"properties": {"title": {"type": "text"}}}})
    assert r.status == 200 and r.body["acknowledged"]
    assert call("HEAD", "/books").status == 200
    assert call("HEAD", "/missing").status == 404
    r = call("GET", "/books")
    assert r.body["books"]["mappings"]["properties"]["title"]["type"] == "text"
    assert r.body["books"]["settings"]["index"]["number_of_shards"] == "2"
    r = call("PUT", "/books")
    assert r.status == 400  # already exists
    assert "resource_already_exists_exception" in json.dumps(r.body)
    assert call("DELETE", "/books").body["acknowledged"]
    assert call("HEAD", "/books").status == 404
    assert call("DELETE", "/missing").status == 404


def case_doc_crud_and_versioning(call, node):
    r = call("PUT", "/idx/_doc/1", {"title": "hello"})
    assert r.status == 201 and r.body["result"] == "created" and r.body["_version"] == 1
    r = call("PUT", "/idx/_doc/1", {"title": "hello again"})
    assert r.status == 200 and r.body["result"] == "updated" and r.body["_version"] == 2
    r = call("GET", "/idx/_doc/1")
    assert r.body["found"] and r.body["_source"]["title"] == "hello again"
    assert call("GET", "/idx/_source/1").body == {"title": "hello again"}
    assert call("HEAD", "/idx/_doc/1").status == 200
    r = call("PUT", "/idx/_create/1", {"title": "nope"})
    assert r.status == 409
    r = call("DELETE", "/idx/_doc/1")
    assert r.status == 200 and r.body["result"] == "deleted"
    assert call("GET", "/idx/_doc/1").status == 404
    r = call("PUT", "/idx/_doc/2", {"n": 1})
    seq = r.body["_seq_no"]
    r = call("PUT", "/idx/_doc/2", {"n": 2}, params={"if_seq_no": str(seq + 5), "if_primary_term": "1"})
    assert r.status == 409
    r = call("PUT", "/idx/_doc/2", {"n": 2}, params={"if_seq_no": str(seq), "if_primary_term": "1"})
    assert r.status == 200


def case_auto_id_and_update(call, node):
    r = call("POST", "/idx/_doc", {"x": 1})
    assert r.status == 201 and len(r.body["_id"]) > 0
    doc_id = r.body["_id"]
    r = call("POST", f"/idx/_update/{doc_id}", {"doc": {"y": 2}})
    assert r.body["result"] == "updated"
    src = call("GET", f"/idx/_doc/{doc_id}").body["_source"]
    assert src == {"x": 1, "y": 2}
    r = call("POST", f"/idx/_update/{doc_id}", {"doc": {"y": 2}})
    assert r.body["result"] == "noop"
    r = call("POST", "/idx/_update/zzz", {"doc": {"a": 1}, "doc_as_upsert": True})
    assert r.body["result"] == "created"
    r = call("POST", "/idx/_update/missing2", {"doc": {"a": 1}})
    assert r.status == 404


def case_bulk_and_search_flow(call, node):
    bulk = "\n".join([
        json.dumps({"index": {"_index": "lib", "_id": "1"}}),
        json.dumps({"title": "the quick brown fox", "year": 2001}),
        json.dumps({"index": {"_index": "lib", "_id": "2"}}),
        json.dumps({"title": "lazy dogs sleep", "year": 2005}),
        json.dumps({"create": {"_index": "lib", "_id": "3"}}),
        json.dumps({"title": "quick quick fox fox", "year": 2010}),
        json.dumps({"delete": {"_index": "lib", "_id": "2"}}),
        json.dumps({"update": {"_index": "lib", "_id": "1"}}),
        json.dumps({"doc": {"year": 2002}}),
    ]) + "\n"
    r = call("POST", "/_bulk", bulk, params={"refresh": "true"})
    assert r.status == 200
    assert not r.body["errors"]
    ops = [next(iter(item)) for item in r.body["items"]]
    assert ops == ["index", "index", "create", "delete", "update"]
    r = call("GET", "/lib/_search", {"query": {"match": {"title": "quick fox"}}})
    hits = r.body["hits"]["hits"]
    assert [h["_id"] for h in hits] == ["3", "1"]
    assert r.body["hits"]["total"]["value"] == 2
    r = call("GET", "/lib/_count")
    assert r.body["count"] == 2
    bulk_err = "\n".join([
        json.dumps({"create": {"_index": "lib", "_id": "1"}}),
        json.dumps({"title": "dup"}),
    ]) + "\n"
    r = call("POST", "/_bulk", bulk_err)
    assert r.body["errors"] is True
    assert r.body["items"][0]["create"]["status"] == 409


def case_msearch(call, node):
    call("PUT", "/a/_doc/1", {"t": "alpha"}, params={"refresh": "true"})
    call("PUT", "/b/_doc/1", {"t": "beta"}, params={"refresh": "true"})
    body = "\n".join([
        json.dumps({"index": "a"}),
        json.dumps({"query": {"match_all": {}}}),
        json.dumps({"index": "b"}),
        json.dumps({"query": {"match": {"t": "beta"}}}),
        json.dumps({"index": "missing"}),
        json.dumps({"query": {"match_all": {}}}),
    ]) + "\n"
    r = call("POST", "/_msearch", body)
    rs = r.body["responses"]
    assert rs[0]["hits"]["total"]["value"] == 1
    assert rs[1]["hits"]["hits"][0]["_id"] == "1"
    assert rs[2]["status"] == 404


def case_multi_index_and_wildcard_search(call, node):
    call("PUT", "/logs-1/_doc/1", {"msg": "error one"}, params={"refresh": "true"})
    call("PUT", "/logs-2/_doc/2", {"msg": "error two"}, params={"refresh": "true"})
    r = call("GET", "/logs-*/_search", {"query": {"match": {"msg": "error"}}})
    assert r.body["hits"]["total"]["value"] == 2
    r = call("GET", "/_search", {"query": {"match_all": {}}})
    assert r.body["hits"]["total"]["value"] >= 2
    r = call("GET", "/_cat/indices")
    assert "logs-1" in r.body


def case_aliases(call, node):
    call("PUT", "/idx-v1/_doc/1", {"x": 1}, params={"refresh": "true"})
    r = call("POST", "/_aliases", {"actions": [{"add": {"index": "idx-v1", "alias": "current"}}]})
    assert r.body["acknowledged"]
    r = call("GET", "/current/_search", {"query": {"match_all": {}}})
    assert r.body["hits"]["total"]["value"] == 1
    r = call("GET", "/idx-v1/_alias")
    assert "current" in r.body["idx-v1"]["aliases"]
    call("POST", "/_aliases", {"actions": [{"remove": {"index": "idx-v1", "alias": "current"}}]})
    r = call("GET", "/current/_search", {"query": {"match_all": {}}})
    assert r.status == 404


def case_delete_by_query(call, node):
    for i in range(6):
        call("PUT", f"/dbq/_doc/{i}", {"n": i})
    call("POST", "/dbq/_refresh")
    r = call("POST", "/dbq/_delete_by_query", {"query": {"range": {"n": {"gte": 3}}}})
    assert r.body["deleted"] == 3
    assert call("GET", "/dbq/_count").body["count"] == 3


def case_analyze(call, node):
    r = call("POST", "/_analyze", {"analyzer": "standard", "text": "The Quick Fox"})
    assert [t["token"] for t in r.body["tokens"]] == ["the", "quick", "fox"]
    assert r.body["tokens"][1]["position"] == 1


def case_cluster_apis(call, node):
    call("PUT", "/x", {"settings": {"number_of_shards": 1, "number_of_replicas": 0}})
    r = call("GET", "/_cluster/health")
    assert r.body["status"] in ("green", "yellow")
    assert r.body["number_of_nodes"] == 1
    r = call("GET", "/_cluster/state")
    assert "x" in r.body["metadata"]["indices"]
    r = call("GET", "/_nodes")
    assert r.body["_nodes"]["total"] == 1
    r = call("GET", "/_nodes/stats")
    assert "breakers" in r.body["nodes"][node.node_id]
    r = call("GET", "/_cat/health")
    assert "elasticsearch-tpu" in r.body
    r = call("GET", "/_cat/shards")
    assert "x 0 p STARTED" in r.body


def case_sharded_index_via_rest(call, node):
    call("PUT", "/big", {"settings": {"number_of_shards": 3, "number_of_replicas": 0}})
    for i in range(30):
        call("PUT", f"/big/_doc/{i}", {"body": f"word{i % 5} filler"})
    call("POST", "/big/_refresh")
    r = call("GET", "/big/_count")
    assert r.body["count"] == 30
    r = call("GET", "/big/_search", {"query": {"match": {"body": "word3"}}, "size": 20})
    assert r.body["hits"]["total"]["value"] == 6
    assert r.body["_shards"]["total"] == 3
    r = call("GET", "/big/_stats")
    assert r.body["_all"]["primaries"]["docs"]["count"] == 30


def case_error_shapes(call, node):
    r = call("GET", "/missing/_search", {"query": {"match_all": {}}})
    assert r.status == 404
    assert r.body["error"]["type"] == "index_not_found_exception"
    call("PUT", "/e/_doc/1", {"a": 1}, params={"refresh": "true"})
    r = call("GET", "/e/_search", {"query": {"bad_query": {}}})
    assert r.status == 400
    assert r.body["error"]["type"] == "parsing_exception"


def case_index_blocks_read_and_metadata_enforced(call, node):
    assert call("PUT", "/b", {"mappings": {
        "properties": {"t": {"type": "text"}}}}).status == 200
    assert call("PUT", "/b/_doc/1", {"t": "hello world"}).status == 201
    call("POST", "/b/_refresh")
    assert call("PUT", "/b/_settings",
                {"index.blocks.read": True}).status == 200
    for method, path, body in [
            ("GET", "/b/_doc/1", None),
            ("POST", "/b/_search", {"query": {"match_all": {}}}),
            ("POST", "/b/_count", None),
            ("POST", "/b/_mget", {"ids": ["1"]})]:
        r = call(method, path, body)
        assert r.status == 403, (method, path, r.body)
        assert "cluster_block_exception" in json.dumps(r.body)
    assert call("PUT", "/b/_doc/2", {"t": "two"}).status == 201
    assert call("PUT", "/b/_settings",
                {"index.blocks.read": False}).status == 200
    assert call("GET", "/b/_doc/1").status == 200
    assert call("PUT", "/b/_settings",
                {"index.blocks.metadata": True}).status == 200
    assert call("GET", "/b/_mapping").status == 403
    assert call("GET", "/b/_settings").status == 403
    assert call("PUT", "/b/_mapping",
                {"properties": {"x": {"type": "keyword"}}}).status == 403
    assert call("PUT", "/b/_settings",
                {"index.refresh_interval": "1s"}).status == 403
    assert call("PUT", "/b/_settings",
                {"index.blocks.metadata": False}).status == 200
    assert call("GET", "/b/_mapping").status == 200


def _http(base, method, path, body=None, timeout=30):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class _HttpResponse:
    def __init__(self, status, body):
        self.status, self.body = status, body


def case_real_http_roundtrip(twin):
    """tests/test_rest.py's HTTP round trip, on an HTTP server per node."""
    ref_server = RefHttpServer(twin.ref_rc, port=0)
    server = HttpServer(twin.rc, port=0)
    ref_server.start()
    server.start()
    ref_base = f"http://127.0.0.1:{ref_server.port}"
    base = f"http://127.0.0.1:{server.port}"
    try:
        def http(method, path, body=None):
            with _no_batching():
                want = _HttpResponse(*_http(ref_base, method, path, body))
            got = _HttpResponse(*_http(base, method, path, body))
            compare(got, twin.translate(want), twin.mode, method, path)
            return got.status, got.body

        status, body = http("GET", "/")
        assert status == 200 and body["tagline"] == "You Know, for Search"
        status, body = http("PUT", "/h/_doc/1?refresh=true", {"t": "hello http"})
        assert status == 201
        status, body = http("POST", "/h/_search", {"query": {"match": {"t": "hello"}}})
        assert body["hits"]["total"]["value"] == 1
        status, _ = http("GET", "/nope/_doc/1")
        assert status == 404
    finally:
        server.stop()
        ref_server.stop()


CASES = {
    "root_info": case_root_info,
    "index_crud": case_index_crud,
    "doc_crud_and_versioning": case_doc_crud_and_versioning,
    "auto_id_and_update": case_auto_id_and_update,
    "bulk_and_search_flow": case_bulk_and_search_flow,
    "msearch": case_msearch,
    "multi_index_and_wildcard_search": case_multi_index_and_wildcard_search,
    "aliases": case_aliases,
    "delete_by_query": case_delete_by_query,
    "analyze": case_analyze,
    "cluster_apis": case_cluster_apis,
    "sharded_index_via_rest": case_sharded_index_via_rest,
    "error_shapes": case_error_shapes,
    "real_http_roundtrip": None,
    "index_blocks_read_and_metadata_enforced":
        case_index_blocks_read_and_metadata_enforced,
}


@pytest.mark.parametrize("mode", ["turbo", "default"])
@pytest.mark.parametrize("case", list(CASES))
def test_rest_case_matches_reference(case, mode):
    with _mode_env(mode):
        twin = Twin(mode)
        try:
            if CASES[case] is None:
                case_real_http_roundtrip(twin)
            else:
                CASES[case](twin.call, twin.node)
        finally:
            twin.close()


# ---------------------------------------------------------------------------
# ingest pipelines: the single-node cases of tests/test_ingest.py
# ---------------------------------------------------------------------------


class IngestTwin:
    """One `IngestService` call, two services: each call runs on the
    reference's and on the port's, and both must return the same value or
    raise the same error with the same message."""

    def __init__(self):
        from elasticsearch_tpu.ingest import IngestService as RefIngest
        from elasticsearch_tpu_torch.ingest import IngestService

        self.ref, self.port = RefIngest(), IngestService()

    def _both(self, name, *args, **kw):
        outs = []
        for svc in (self.ref, self.port):
            try:
                outs.append(("ok", getattr(svc, name)(
                    *copy.deepcopy(args), **copy.deepcopy(kw))))
            except Exception as e:  # noqa: BLE001 — compared below
                outs.append(("raised", type(e).__name__, str(e)))
        want, got = outs
        assert got == want, (name, args, got, want)
        if got[0] == "raised":
            from elasticsearch_tpu_torch import ingest

            raise getattr(ingest, got[1])(got[2])
        return got[1]

    def put_pipeline(self, pid, body):
        return self._both("put_pipeline", pid, body)

    def process(self, pid, source, **kw):
        return self._both("process", pid, source, **kw)

    def simulate(self, body, docs):
        return self._both("simulate", body, docs)

    def get_pipeline(self, pid):
        return self._both("get_pipeline", pid).body


def _run(svc, processors, source, **kw):
    svc.put_pipeline("p", {"processors": processors})
    r = svc.process("p", source, **kw)
    return None if r is None else r[0]


def ingest_set_remove_rename(svc):
    out = _run(svc, [
        {"set": {"field": "env", "value": "prod"}},
        {"set": {"field": "greeting", "value": "hi {{user.name}}"}},
        {"rename": {"field": "old", "target_field": "new"}},
        {"remove": {"field": "junk"}},
    ], {"user": {"name": "kim"}, "old": 1, "junk": True})
    assert out == {"user": {"name": "kim"}, "env": "prod",
                   "greeting": "hi kim", "new": 1}


def ingest_convert_and_string_processors(svc):
    out = _run(svc, [
        {"convert": {"field": "n", "type": "integer"}},
        {"convert": {"field": "flag", "type": "boolean"}},
        {"lowercase": {"field": "tag"}},
        {"uppercase": {"field": "up"}},
        {"trim": {"field": "pad"}},
        {"split": {"field": "csv", "separator": ","}},
        {"join": {"field": "parts", "separator": "-"}},
        {"gsub": {"field": "phone", "pattern": r"[-\s]", "replacement": ""}},
        {"append": {"field": "tags", "value": ["b", "c"]}},
    ], {"n": "42", "flag": "TRUE", "tag": "HOT", "up": "cold", "pad": "  x ",
        "csv": "a,b", "parts": ["x", "y"], "phone": "1-800 555",
        "tags": "a"})
    assert out["n"] == 42 and out["flag"] is True
    assert out["tag"] == "hot" and out["up"] == "COLD" and out["pad"] == "x"
    assert out["csv"] == ["a", "b"] and out["phone"] == "1800555"
    assert out["parts"] == "x-y" and out["tags"] == ["a", "b", "c"]


def ingest_date_processor(svc):
    out = _run(svc, [{"date": {"field": "ts", "formats": ["UNIX"]}}],
               {"ts": "1700000000"})
    assert out["@timestamp"].startswith("2023-11-14T")
    out = _run(svc, [{"date": {"field": "d", "formats": ["%d/%m/%Y"],
                               "target_field": "when"}}],
               {"d": "02/01/2020"})
    assert out["when"].startswith("2020-01-02T")
    with pytest.raises(Exception, match="not a date"):
        _run(svc, [{"date": {"field": "d", "formats": ["%Y"]}}],
             {"d": "not a date"})


def ingest_dissect(svc):
    out = _run(svc, [{"dissect": {
        "field": "msg", "pattern": "%{client} - %{verb} %{path}"}}],
        {"msg": "1.2.3.4 - GET /index.html"})
    assert out["client"] == "1.2.3.4"
    assert out["verb"] == "GET" and out["path"] == "/index.html"


def ingest_drop_and_fail(svc):
    assert _run(svc, [{"drop": {}}], {"x": 1}) is None
    svc.put_pipeline("f", {"processors": [
        {"fail": {"message": "bad doc {{id}}"}}]})
    with pytest.raises(Exception, match="bad doc 7"):
        svc.process("f", {"id": 7})


def ingest_on_failure_chains(svc):
    out = _run(svc, [
        {"convert": {"field": "n", "type": "integer",
                     "on_failure": [{"set": {"field": "n", "value": -1}}]}},
    ], {"n": "not-a-number"})
    assert out["n"] == -1
    out = _run(svc, [
        {"convert": {"field": "n", "type": "integer",
                     "ignore_failure": True}},
        {"set": {"field": "ok", "value": 1}},
    ], {"n": "nope"})
    assert out["n"] == "nope" and out["ok"] == 1
    svc.put_pipeline("pf", {
        "processors": [{"fail": {"message": "boom"}}],
        "on_failure": [{"set": {"field": "failed", "value": True}}]})
    assert svc.process("pf", {})[0]["failed"] is True


def ingest_unknown_processor_and_missing_pipeline(svc):
    from elasticsearch_tpu_torch.ingest import (
        IngestProcessorError, PipelineMissingError,
    )

    with pytest.raises(IngestProcessorError):
        svc.put_pipeline("x", {"processors": [{"nope": {}}]})
    with pytest.raises(PipelineMissingError):
        svc.get_pipeline("ghost")


def ingest_pipeline_reroutes_via_meta(svc):
    svc.put_pipeline("route", {"processors": [
        {"set": {"field": "_index", "value": "logs-2026"}}]})
    out = svc.process("route", {"x": 1}, index="logs", doc_id="7")
    assert out == ({"x": 1}, "logs-2026", "7")


def ingest_simulate(svc):
    docs = svc.simulate(
        {"processors": [{"uppercase": {"field": "a"}}]},
        [{"_source": {"a": "x"}}, {"_source": {"b": 1}}])
    assert docs[0]["doc"]["_source"]["a"] == "X"
    assert "error" in docs[1]


INGEST_CASES = {
    "set_remove_rename": ingest_set_remove_rename,
    "convert_and_string_processors": ingest_convert_and_string_processors,
    "date_processor": ingest_date_processor,
    "dissect": ingest_dissect,
    "drop_and_fail": ingest_drop_and_fail,
    "on_failure_chains": ingest_on_failure_chains,
    "unknown_processor_and_missing_pipeline":
        ingest_unknown_processor_and_missing_pipeline,
    "pipeline_reroutes_via_meta": ingest_pipeline_reroutes_via_meta,
    "simulate": ingest_simulate,
}


@pytest.mark.parametrize("case", list(INGEST_CASES))
def test_ingest_case_matches_reference(case):
    INGEST_CASES[case](IngestTwin())


@pytest.mark.parametrize("mode", ["turbo", "default"])
def test_rest_ingest_pipelines_match_reference(mode):
    """tests/test_ingest.py's bulk and default_pipeline case over the twin
    REST nodes, the pipelines put into each node's service directly
    (tests/test_torch_rest_admin.py puts them over `/_ingest/pipeline`)."""
    with _mode_env(mode):
        twin = Twin(mode)
        try:
            for node in (twin.ref, twin.node):
                node.ingest.put_pipeline("clean", {"processors": [
                    {"lowercase": {"field": "tag"}},
                    {"set": {"field": "via", "value": "clean"}}]})
                node.ingest.put_pipeline("dropper",
                                         {"processors": [{"drop": {}}]})
                node.ingest.put_pipeline("route", {"processors": [
                    {"set": {"field": "_index", "value": "pipes-2026"}}]})
            call = twin.call
            call("PUT", "/pipes", {"settings": {
                "index": {"default_pipeline": "clean"}}})
            assert call("PUT", "/pipes/_doc/1", {"tag": "HOT"}).status \
                in (200, 201)
            call("POST", "/pipes/_refresh")
            doc = call("GET", "/pipes/_doc/1").body
            assert doc["_source"] == {"tag": "hot", "via": "clean"}
            lines = [
                json.dumps({"index": {"_index": "pipes", "_id": "2",
                                      "pipeline": "dropper"}}),
                json.dumps({"tag": "GONE"}),
                json.dumps({"index": {"_index": "pipes", "_id": "3",
                                      "pipeline": "clean"}}),
                json.dumps({"tag": "WARM"}),
                json.dumps({"index": {"_index": "pipes", "_id": "4",
                                      "pipeline": "ghost"}}),
                json.dumps({"tag": "LOST"}),
            ]
            body = call("POST", "/_bulk",
                        "\n".join(lines) + "\n").body
            assert body["items"][0]["index"]["result"] == "noop"
            assert body["items"][2]["index"]["status"] >= 400
            call("POST", "/pipes/_refresh")
            assert call("GET", "/pipes/_doc/2").status == 404
            assert call("GET", "/pipes/_doc/3").body["_source"]["tag"] \
                == "warm"
            # ?pipeline= reroutes the document to another index
            r = call("PUT", "/pipes/_doc/5", {"tag": "X"},
                     params={"pipeline": "route", "refresh": "true"})
            assert r.body["_index"] == "pipes-2026"
            call("POST", "/pipes-2026/_search",
                 {"query": {"match_all": {}}})
            assert call("PUT", "/pipes/_doc/6", {"tag": "X"},
                        params={"pipeline": "ghost"}).status == 404
        finally:
            twin.close()


# ---------------------------------------------------------------------------
# cross-cluster search: `remote:index` expressions (tests/test_ccs_ccr.py)
# ---------------------------------------------------------------------------


def _remote_pkgs():
    from elasticsearch_tpu.cluster import remote as ref_remote
    from elasticsearch_tpu.transport import channels as ref_channels
    from elasticsearch_tpu_torch.cluster import remote
    from elasticsearch_tpu_torch.transport import channels

    return ((ref_remote, ref_channels), (remote, channels))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared by the caller
        return ("raised", type(e).__name__, str(e))


def test_remote_registry_and_merge_match_reference():
    """tests/test_ccs_ccr.py's registry and leg-merge cases on both
    packages: the same expressions split the same way, the same names are
    refused, and the same legs merge to the same page."""
    def leg(idx, scores):
        return {"took": 1, "timed_out": False,
                "_shards": {"total": 1, "successful": 1, "skipped": 0,
                            "failed": 0},
                "hits": {"total": {"value": len(scores), "relation": "eq"},
                         "max_score": max(scores),
                         "hits": [{"_index": idx, "_id": f"{idx}{i}",
                                   "_score": s, "sort": [s, i]}
                                  for i, s in enumerate(scores)]}}

    legs = [(None, leg("a", [3.0, 1.0, 1.0])), ("r", leg("b", [2.0, 1.0]))]
    results = []
    for remote, channels in _remote_pkgs():
        svc = remote.RemoteClusterService("n0")
        svc.register_remote("east", channels.LocalNodeChannels(), ["a"])
        results.append([
            _outcome(lambda: svc.split_expression(
                "idx1,east:logs-*,idx2,east:more")),
            _outcome(lambda: svc.split_expression("typo:logs")),
            _outcome(lambda: svc.register_remote(
                "bad:name", channels.LocalNodeChannels(), ["a"])),
            _outcome(lambda: svc.register_remote(
                "noseeds", channels.LocalNodeChannels(), [])),
            svc.has_remote_parts("idx1,idx2"),
            svc.has_remote_parts("east:logs"),
            svc.names(),
            [remote.merge_leg_responses(copy.deepcopy(legs), from_=f,
                                        size=2, sort_spec=sort)
             for f in (0, 2) for sort in (None, [{"n": "asc"}],
                                          [{"n": "desc"}])],
        ])
    want, got = results
    assert got == want
    assert got[0] == ("ok", (["idx1", "idx2"],
                             {"east": ["logs-*", "more"]}))
    assert [o[0] for o in got[1:4]] == ["raised"] * 3


class CcsTwin(Twin):
    """Twin REST nodes, each with a second node of its own package
    registered as remote `east` (skip_unavailable) and as remote `strict`
    (not) over private LocalNodeChannels."""

    def __init__(self, mode):
        super().__init__(mode)
        (_, ref_channels), (_, channels) = _remote_pkgs()
        self.ref_east = RefNode(node_name="east-0")
        self.east = Node(node_name="east-0", device="cpu")
        self.ids[self.east.node_id] = self.ref_east.node_id
        self.ref_ch = ref_channels.LocalNodeChannels()
        self.ch = channels.LocalNodeChannels()
        for local, east, ch in ((self.ref, self.ref_east, self.ref_ch),
                                (self.node, self.east, self.ch)):
            ch.register("east-0", east.transport)
            local.remotes.register_remote("east", ch, ["east-0"],
                                          skip_unavailable=True)
            local.remotes.register_remote("strict", ch, ["east-0"])
            east.create_index("logs", {"settings": {"number_of_shards": 1}})
            for i, text in enumerate(["hello there", "hello hello",
                                      "goodbye"]):
                east.indices.get("logs").index_doc(
                    f"e{i}", {"n": i, "body": text})
            east.indices.get("logs").refresh()

    def kill_east(self):
        self.ref_ch.kill("east-0")
        self.ch.kill("east-0")

    def close(self):
        super().close()
        self.east.close()
        self.ref_east.close()


@pytest.mark.parametrize("mode", ["turbo", "default"])
def test_rest_remote_search_matches_reference(mode):
    """`_search` and `_msearch` over `remote:index` expressions, on twin
    nodes each with a remote of its own package: a healthy fan-out, the
    page cut after the merge, a sorted fan-out, an unknown alias, aggs
    refused, then the remote dead with and without skip_unavailable."""
    with _mode_env(mode):
        twin = CcsTwin(mode)
        try:
            call = twin.call
            call("PUT", "/home", {"settings": {"number_of_shards": 1}})
            call("PUT", "/home/_doc/h1", {"n": 10, "body": "hello"})
            call("POST", "/home/_refresh")
            q = {"query": {"match": {"body": "hello"}}, "size": 10}
            r = call("POST", "/home,east:logs/_search", q)
            assert r.status == 200
            assert r.body["hits"]["total"]["value"] == 3
            assert r.body["_clusters"]["successful"] == 2
            assert {h["_index"] for h in r.body["hits"]["hits"]} \
                == {"home", "east:logs"}
            call("POST", "/home,east:logs/_search", dict(q, size=1, **{
                "from": 1}))
            call("POST", "/east:logs/_search",
                 {"query": {"match_all": {}}, "sort": [{"n": "desc"}]})
            assert call("POST", "/typo:logs/_search", q).status == 400
            assert call("POST", "/home,east:logs/_search", dict(
                q, aggs={"n": {"terms": {"field": "n"}}})).status == 400
            lines = [{"index": "east:logs"}, q, {"index": "home"}, q]
            payload = "".join(json.dumps(x) + "\n" for x in lines)
            r = call("POST", "/_msearch", payload)
            assert [x["hits"]["total"]["value"]
                    for x in r.body["responses"]] == [2, 1]
            twin.kill_east()
            r = call("POST", "/_msearch", payload)
            dead, alive = r.body["responses"]
            assert "error" not in dead and dead["status"] == 200
            assert dead["hits"]["hits"] == []
            assert dead["_clusters"]["skipped"] == 1
            assert alive["hits"]["total"]["value"] == 1
            r = call("POST", "/home,east:logs/_search", q)
            assert r.status == 200 and r.body["_clusters"]["skipped"] == 1
            assert call("POST", "/home,strict:logs/_search", q).status \
                >= 500
        finally:
            twin.close()


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def test_real_http_roundtrip():
    node = Node(device="cpu")
    rc = RestController()
    register_handlers(node, rc)
    server = HttpServer(rc, port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        status, body = _http(base, "GET", "/")
        assert status == 200 and body["tagline"] == "You Know, for Search"
        status, body = _http(base, "PUT", "/h/_doc/1?refresh=true",
                             {"t": "hello http"})
        assert status == 201
        status, body = _http(base, "POST", "/h/_search",
                             {"query": {"match": {"t": "hello"}}})
        assert body["hits"]["total"]["value"] == 1
        status, _ = _http(base, "GET", "/nope/_doc/1")
        assert status == 404
    finally:
        server.stop()
        node.close()


def test_http_server_sheds_load_with_429():
    """tests/test_threadpool.py's test on the port: a saturated search pool
    answers 429 with es_rejected_execution_exception while management keeps
    serving, and `_cat/thread_pool/search` and `/_nodes/stats` report the
    rejection."""
    from elasticsearch_tpu_torch.threadpool import ThreadPool

    sizes = {"search": 1, "write": 1, "get": 1, "management": 1,
             "snapshot": 1}
    node = Node(device="cpu")
    pool = ThreadPool(sizes=sizes, queue_sizes=dict(sizes))
    node.thread_pool.shutdown()
    node.thread_pool = pool
    rc = RestController()
    register_handlers(node, rc)
    release = threading.Event()
    started = threading.Event()

    def slow_search(req):
        from elasticsearch_tpu_torch.rest.controller import RestResponse

        started.set()
        release.wait(10)
        return RestResponse(body={"slow": True})

    rc.register("GET", "/_slowtest/_search", slow_search)
    server = HttpServer(rc, port=0, thread_pool=pool)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    threads = []
    try:
        t1 = threading.Thread(target=_http,
                              args=(base, "GET", "/_slowtest/_search"))
        t1.start()
        threads.append(t1)
        assert started.wait(10)
        t2 = threading.Thread(target=_http,
                              args=(base, "GET", "/_slowtest/_search"))
        t2.start()                       # sits in the queue (capacity 1)
        threads.append(t2)
        deadline = time.monotonic() + 5
        while pool.stats()["search"]["queue"] < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        status, body = _http(base, "GET", "/_slowtest/_search")
        assert status == 429
        assert body["error"]["type"] == "es_rejected_execution_exception"
        assert "search" in body["error"]["reason"]
        status, _ = _http(base, "GET", "/_cluster/health")
        assert status == 200
        status, body = _http(base, "GET", "/_nodes/stats")
        assert status == 200
        search = body["nodes"][node.node_id]["thread_pool"]["search"]
        assert search["rejected"] >= 1
        assert (search["threads"], search["queue_size"]) == (1, 1)
        with urllib.request.urlopen(base + "/_cat/thread_pool/search",
                                    timeout=15) as resp:
            cols = resp.read().decode().split()
        assert cols[:5] == [node.node_name, "search", "1", "1", "1"]
        assert len(cols) == 7
        float(cols[5])
        float(cols[6])
    finally:
        release.set()
        for t in threads:
            t.join(timeout=10)
        server.stop()
        pool.shutdown()
        node.close()


def test_http_server_takes_many_connections_at_once():
    """48 clients, 6 requests each, all at once: every connection is
    answered, and the server listens with a backlog of LISTEN_BACKLOG. The
    reference's server listens with socketserver's backlog of 5: when the
    host is loaded (its accept loop waits for the GIL), some of these
    connections are reset there (ROADMAP W17)."""
    from concurrent.futures import ThreadPoolExecutor

    from elasticsearch_tpu_torch.rest.controller import RestResponse
    from elasticsearch_tpu_torch.rest.http_server import LISTEN_BACKLOG

    def slow(req):
        time.sleep(0.05)
        return RestResponse(body={"ok": True})

    rc = RestController()
    rc.register("GET", "/_slowtest/_search", slow)
    server = HttpServer(rc, port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    n = 48
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait(timeout=30)
        return [_http(base, "GET", "/_slowtest/_search")[0]
                for _ in range(6)]

    try:
        with ThreadPoolExecutor(n) as ex:
            statuses = [x for r in ex.map(client, range(n)) for x in r]
    finally:
        server.stop()
    assert statuses == [200] * (6 * n)
    assert server._server.request_queue_size == LISTEN_BACKLOG >= 128


_SERVE = r"""
import importlib.abc, runpy, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "elasticsearch_tpu" or name.startswith("elasticsearch_tpu."):
            raise ImportError("refused: " + name)
        return None

sys.modules["jax"] = None
sys.meta_path.insert(0, Refuse())
sys.argv = ["elasticsearch_tpu_torch", "--device", "cpu", "--port", "0"]
runpy.run_module("elasticsearch_tpu_torch", run_name="__main__")
"""


def test_main_serves_without_jax_or_reference():
    """`python -m elasticsearch_tpu_torch --device cpu --port 0` serves
    `_search`, `_msearch`, kNN and aggs in a process where jax and every
    elasticsearch_tpu module are refused."""
    env = dict(os.environ, ES_TPU_FORCE_KNN="1", ES_TPU_FORCE_TURBO="1")
    proc = subprocess.Popen([sys.executable, "-c", _SERVE], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "started, http on" not in line:
            assert time.monotonic() < deadline, "no started line"
            line = proc.stdout.readline()
            assert line or proc.poll() is None, proc.stderr.read()
        port = int(line.rsplit(":", 1)[1])
        assert port > 0
        base = f"http://127.0.0.1:{port}"
        mappings = {"properties": {
            "body": {"type": "text"}, "tag": {"type": "keyword"},
            "vec": {"type": "dense_vector", "dims": 4,
                    "similarity": "cosine"}}}
        assert _http(base, "PUT", "/g", {"mappings": mappings})[0] == 200
        for i in range(40):
            doc = {"body": f"alpha w{i % 7} beta" if i % 3 else "gamma",
                   "tag": f"t{i % 4}",
                   "vec": [1.0, float(i % 5), float(i % 3), 0.5]}
            assert _http(base, "PUT", f"/g/_doc/{i}", doc)[0] == 201
        assert _http(base, "POST", "/g/_refresh")[0] == 200
        status, body = _http(base, "POST", "/g/_search",
                             {"query": {"match": {"body": "alpha w3"}}})
        assert status == 200 and body["hits"]["total"]["value"] > 0
        data = "\n".join(json.dumps(x) for x in [
            {"index": "g"}, {"query": {"match": {"body": "beta"}}},
            {"index": "g"}, {"query": {"match": {"body": "gamma"}}},
        ]) + "\n"
        req = urllib.request.Request(base + "/_msearch", data=data.encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            rs = json.loads(resp.read())["responses"]
        assert [r["hits"]["total"]["value"] for r in rs] == [26, 14]
        status, body = _http(base, "POST", "/g/_search", {"knn": {
            "field": "vec", "query_vector": [1.0, 2.0, 1.0, 0.5], "k": 3,
            "num_candidates": 10}})
        assert status == 200 and len(body["hits"]["hits"]) == 3
        status, body = _http(base, "POST", "/g/_search", {
            "size": 0, "aggs": {"tags": {"terms": {"field": "tag"}}}})
        assert status == 200
        buckets = body["aggregations"]["tags"]["buckets"]
        assert sorted(b["doc_count"] for b in buckets) == [10, 10, 10, 10]
        status, body = _http(base, "GET", "/_nodes")
        (info,) = body["nodes"].values()
        assert info["accelerators"] == ["cpu"]
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def _stats_pair():
    from elasticsearch_tpu.common import hbm_ledger as ref_ledger
    from elasticsearch_tpu_torch.common import hbm_ledger

    class Engine:
        pass

    # one engine in each ledger, so that both list an engine entry
    ref_eng, eng = Engine(), Engine()
    ref_ledger.register_engine(ref_eng, "turbo").set_region("cols", 64)
    hbm_ledger.register_engine(eng, "turbo").set_region("cols", 64)
    ref = RefNode()
    ref_rc = RefRestController()
    ref_register_handlers(ref, ref_rc)
    node = Node(device="cpu")
    rc = RestController()
    register_handlers(node, rc)
    try:
        want = ref_rc.dispatch("GET", STATS_PATH, {}, None)
        got = rc.dispatch("GET", STATS_PATH, {}, None)
    finally:
        node.close()
        ref.close()
    assert got.status == want.status == 200
    (g,) = got.body["nodes"].values()
    (w,) = want.body["nodes"].values()
    return g, w


def test_nodes_stats_sections():
    """Every section of the reference's `/_nodes/stats` is there, with the
    same keys recursively in `tpu_hbm` and `tpu_compile`; `tpu_settings`
    lists the same knobs."""
    g, w = _stats_pair()
    assert set(g) == set(w)
    for section in ("tpu_hbm", "tpu_compile"):
        assert _ledger_keys(g[section]) == _ledger_keys(w[section]), section
    assert set(w["tpu_settings"]) - set(g["tpu_settings"]) == UNPORTED_KNOBS
    assert set(g["tpu_settings"]) <= set(w["tpu_settings"])
    for name, entry in g["tpu_settings"].items():
        ref_entry = w["tpu_settings"][name]
        assert (entry["default"], entry["type"]) == \
            (ref_entry["default"], ref_entry["type"]), name


def test_node_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceUnavailableError):
        Node()


def _basic(user, pw):
    import base64

    return {"Authorization": "Basic " + base64.b64encode(
        f"{user}:{pw}".encode()).decode()}


def test_security_enabled_answers_as_reference():
    """A node with `xpack.security.enabled` serves, and answers 401 / 403 /
    200 exactly as the reference's: no credentials, a wrong password and
    an unknown user are refused, a user whose role lacks the index or the
    cluster privilege is forbidden, the superuser and a reader pass."""
    twin = Twin("default", {"xpack.security.enabled": "true",
                            "bootstrap.password": "s3cret"})
    try:
        call = twin.call
        su = _basic("elastic", "s3cret")
        assert call("GET", "/").status == 401
        assert call("GET", "/", headers=_basic("elastic", "bad")).status \
            == 401
        assert call("GET", "/", headers=_basic("nobody", "x")).status == 401
        assert call("GET", "/", headers=su).status == 200
        call("PUT", "/_security/role/r", {"indices": [
            {"names": ["open-*"], "privileges": ["read"]}]}, headers=su)
        call("PUT", "/_security/user/u", {"password": "upw",
                                          "roles": ["r"]}, headers=su)
        call("PUT", "/open-1/_doc/1", {"t": "hello"},
             params={"refresh": "true"}, headers=su)
        call("PUT", "/closed-1/_doc/1", {"t": "hello"},
             params={"refresh": "true"}, headers=su)
        u = _basic("u", "upw")
        q = {"query": {"match": {"t": "hello"}}}
        assert call("POST", "/open-1/_search", q, headers=u).status == 200
        assert call("POST", "/closed-1/_search", q, headers=u).status == 403
        assert call("PUT", "/open-1/_doc/2", {"t": "x"}, headers=u).status \
            == 403
        assert call("GET", "/_cluster/health", headers=u).status == 403
        body = "".join(json.dumps(x) + "\n" for x in (
            {"index": "open-1"}, q, {"index": "closed-1"}, q))
        assert call("POST", "/_msearch", body, headers=u).status == 403
        assert call("POST", "/_msearch", body, headers=su).status == 200
    finally:
        twin.close()


@pytest.mark.parametrize("method,path,status", [
    ("GET", "/_tasks", 200),
    ("PUT", "/_snapshot/repo", 500),        # no body: no repository type
    ("PUT", "/_ingest/pipeline/p", 200),
    ("POST", "/logs/_rollover", 400),       # no index holds the alias
    ("GET", "/_cat/thread_pool", 200),
    ("GET", "/_security/_authenticate", 200),
])
def test_part_two_routes_match_reference(method, path, status):
    """A route of part 2 answers as the reference's does, status and body,
    on twin nodes (the same six calls that answered as unknown routes
    before part 2 was ported)."""
    twin = Twin("default")
    try:
        if path == "/_cat/thread_pool":
            # its last two columns, the queue-wait EWMA and p99, read each
            # package's process-wide histograms, which hold every earlier
            # test's waits: the other five are compared
            got, want = (rc.dispatch(method, path, {}, None)
                         for rc in (twin.rc, twin.ref_rc))
            assert got.status == want.status == status
            assert [r.split()[:5] for r in got.body.splitlines()] == \
                [r.split()[:5] for r in want.body.splitlines()]
            return
        assert twin.call(method, path).status == status
    finally:
        twin.close()


def test_hbm_ledger_feeds_the_overload_signal(monkeypatch):
    """Engine bytes near a small ES_TPU_TURBO_HBM raise the `hbm` pressure
    signal of the port's OverloadController exactly as the reference's.
    Each ledger keeps the engines other tests left alive; one engine more
    in each brings both to the same occupancy."""
    from elasticsearch_tpu.common import hbm_ledger as ref_ledger
    from elasticsearch_tpu.common.overload import (
        OverloadController as RefOverload,
    )
    from elasticsearch_tpu_torch.common import hbm_ledger
    from elasticsearch_tpu_torch.common.overload import OverloadController

    class Engine:
        pass

    gc.collect()
    gc.disable()            # no engine of another test leaves mid-way
    ref_eng, eng = Engine(), Engine()
    ref_h = ref_ledger.register_engine(ref_eng, "turbo")
    h = hbm_ledger.register_engine(eng, "turbo")
    try:
        ref0 = ref_ledger.hbm_stats()["occupancy_bytes"]
        port0 = hbm_ledger.hbm_stats()["occupancy_bytes"]
        base = max(ref0, port0)
        budget = base + (1 << 20)
        monkeypatch.setenv("ES_TPU_TURBO_HBM", str(budget))
        for extra in (0, 700_000, 1_000_000, 1_200_000):
            ref_h.set_region("cols", base + extra - ref0)
            h.set_region("cols", base + extra - port0)
            want = RefOverload("n")._compute_signals()
            got = OverloadController("n")._compute_signals()
            assert got == want, extra
            assert got["hbm"] == round(min(1.0, (base + extra) / budget), 4)
        stats = hbm_ledger.hbm_stats()
        assert _ledger_keys(stats) == _ledger_keys(ref_ledger.hbm_stats())
        assert stats["budget_bytes"] == budget
        assert stats["headroom_bytes"] == budget - (base + 1_200_000)
        assert _keys(hbm_ledger.compile_stats()) == \
            _keys(ref_ledger.compile_stats())
    finally:
        ref_h.close()
        h.close()
        gc.enable()
