"""The port's REST node, part 2: security, snapshots, tasks, lifecycle,
templates, async search, ingest pipelines and CCR, against the reference's.

The reference suites tests/test_security.py, test_snapshots.py,
test_tasks.py, test_lifecycle.py and test_misc_apis.py, the
`/_ingest/pipeline` routes of test_ingest.py and
test_ccs_ccr.py::test_rest_ccr_endpoints_and_stats_sections are held case
for case. A case that drives a REST controller runs on twin nodes
(`test_torch_rest.Twin`: every call goes to the reference's node and to the
port's `Node(device="cpu")`, statuses and bodies must be equal but for
mapped random ids and wall-clock keys, search hits held in the `turbo` or
`default` mode's contract); most run the reference's own test function with
the twin's `call` in place of its fixture, so its assertions hold on the
port's responses. A case that drives a node's services directly runs once
on each package and compares what each saw. The reference's calls run with
ES_TPU_COALESCE_US=0, as in test_torch_rest.py.
"""

import base64
import json
import os
import re
import threading
import time
import types

import numpy as np
import pytest
import torch

import test_lifecycle as ref_lifecycle
import test_misc_apis as ref_misc
import test_security as ref_security
import test_snapshots as ref_snapshots
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest import (
    RestController as RefRestController,
    register_handlers as ref_register_handlers,
)
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest import RestController, register_handlers
from test_torch_index_service import (
    _no_batching, assert_bitwise, assert_same_results,
)
from test_torch_rest import VOLATILE, Twin, _mode_env

torch.set_num_threads(1)

MODES = ["turbo", "default"]
SECURE = {"xpack.security.enabled": "true", "bootstrap.password": "s3cret"}
ELASTIC = ref_security.ELASTIC
# wall-clock keys of task, snapshot, async-search and profile bodies, the
# profile's random trace id, and its routing record's `occupancy_bytes`:
# the process-wide device-memory ledger's total, which counts every engine
# earlier tests left alive, and whose per-engine regions the two packages
# size differently (test_torch_rest.py holds the ledgers' keys, not bytes)
ADMIN_VOLATILE = VOLATILE | {
    "start_time_in_millis", "end_time_in_millis", "running_time_in_nanos",
    "time_in_nanos", "breakdown", "expiration_time_in_millis", "phases",
    "trace_id", "occupancy_bytes",
}


class AdminTwin(Twin):
    volatile = ADMIN_VOLATILE

    def __init__(self, mode, settings=None):
        super().__init__(mode, settings)
        # the profile's routing reason names each package's device: the
        # port declines Turbo off the card where the reference declines it
        # off the TPU
        self.ids["backend_not_cuda"] = "backend_not_tpu"


def _json_call(twin):
    """test_misc_apis.py's `call`: (status, decoded body), `raw=` bytes."""
    def call(method, path, body=None, params=None, raw=None):
        data = raw.decode() if raw is not None else body
        r = twin.call(method, path, data, params)
        return r.status, json.loads(r.encode() or b"{}")
    return call


# ---------------------------------------------------------------------------
# tests/test_security.py
# ---------------------------------------------------------------------------

# cases of the reference that take its `api` fixture (call, node)
SECURITY_API_CASES = [
    "test_anonymous_rejected_when_security_on",
    "test_wrong_password_and_unknown_user_401",
    "test_authenticate_endpoint",
    "test_authz_matrix_reader_vs_writer",
    "test_bulk_target_scoped_by_role",
    "test_api_key_roundtrip_and_invalidation",
    "test_api_key_with_restricted_role_descriptors",
    "test_reindex_requires_source_read_and_dest_write",
    "test_aliases_actions_require_index_manage",
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", SECURITY_API_CASES)
def test_security_case_matches_reference(case, mode):
    with _mode_env(mode):
        twin = AdminTwin(mode, SECURE)
        try:
            getattr(ref_security, case)((twin.call, twin.node))
        finally:
            twin.close()


def test_security_anonymous_roles_match_reference():
    """test_anonymous_roles_grant_configured_access on twin nodes."""
    twin = AdminTwin("default", {
        "xpack.security.enabled": "true",
        "xpack.security.authc.anonymous.roles": "monitoring_user"})
    try:
        assert twin.call("GET", "/_cluster/health").status == 200
        assert twin.call("PUT", "/idx", {}).status == 403
    finally:
        twin.close()


def test_security_classify_matches_reference():
    """test_scripts_stay_cluster_scoped: the filter's request classes are
    the reference's, on the same requests."""
    from elasticsearch_tpu.rest.controller import RestRequest as RefRequest
    from elasticsearch_tpu.security.service import _classify as ref_classify
    from elasticsearch_tpu_torch.rest.controller import RestRequest
    from elasticsearch_tpu_torch.security.service import _classify

    cases = [
        ("PUT", "/_scripts/s1",
         {"script": {"lang": "painless", "source": "1"}}, ["_scripts", "s1"]),
        ("POST", "/_reindex", {"source": {"index": ["a", "b"]},
                               "dest": {"index": "c"}}, ["_reindex"]),
        ("POST", "/_aliases", {"actions": [
            {"add": {"index": "x", "alias": "al"}},
            {"remove": {"indices": ["y", "z"], "alias": "al"}}]},
         ["_aliases"]),
        ("POST", "/_msearch", None, ["_msearch"]),
        ("GET", "/logs-*/_search", None, ["logs-*", "_search"]),
        ("GET", "/_cluster/health", None, ["_cluster", "health"]),
    ]
    got = []
    for method, path, body, parts in cases:
        kw = dict(method=method, path=path, params={}, body=body,
                  raw_body=b"", headers={})
        got.append(_classify(RestRequest(**kw), parts))
        assert got[-1] == ref_classify(RefRequest(**kw), parts), path
    assert got[0][0] == "cluster" and got[0][2] is None
    assert got[1][0] == "multi"
    assert got[2] == ("index", "manage", ["x", "y", "z"])


def test_security_disabled_by_default_matches_reference():
    twin = AdminTwin("default")
    try:
        assert twin.call("GET", "/").status == 200
        assert twin.call("GET", "/_security/_authenticate").status == 200
    finally:
        twin.close()


def test_security_filter_leaves_msearch_body_whole():
    """The filter reads `_msearch` NDJSON to authorize each index; the
    handler still reads every line of the same body afterwards."""
    twin = AdminTwin("default", SECURE)
    try:
        call = twin.call
        call("PUT", "/_security/role/r", {"indices": [
            {"names": ["a", "b"], "privileges": ["read"]}]}, headers=ELASTIC)
        call("PUT", "/_security/user/u", {"password": "pw", "roles": ["r"]},
             headers=ELASTIC)
        for name in ("a", "b"):
            call("PUT", f"/{name}/_doc/1", {"t": f"hello {name}"},
                 params={"refresh": "true"}, headers=ELASTIC)
        q = {"query": {"match": {"t": "hello"}}}
        body = "".join(json.dumps(x) + "\n" for x in (
            {"index": "a"}, q, {"index": "b"}, q, {"index": "a"}, q))
        r = call("POST", "/_msearch", body, headers=ref_security._basic(
            "u", "pw"))
        assert r.status == 200
        assert [x["hits"]["total"]["value"] for x in r.body["responses"]] \
            == [1, 1, 1]
    finally:
        twin.close()


# ---------------------------------------------------------------------------
# tests/test_lifecycle.py
# ---------------------------------------------------------------------------

LIFECYCLE_CASES = sorted(n for n in dir(ref_lifecycle)
                         if n.startswith("test_"))


def test_lifecycle_cases_are_the_reference_set():
    assert len(LIFECYCLE_CASES) == 11


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", LIFECYCLE_CASES)
def test_lifecycle_case_matches_reference(case, mode):
    with _mode_env(mode):
        twin = AdminTwin(mode)
        try:
            getattr(ref_lifecycle, case)((twin.call, twin.node))
        finally:
            twin.close()


# ---------------------------------------------------------------------------
# tests/test_misc_apis.py
# ---------------------------------------------------------------------------

# cases of the reference that take its `env` fixture (node, call) alone
MISC_ENV_CASES = [
    "test_sliced_search_partitions_completely",
    "test_script_fields",
    "test_rank_eval",
    "test_async_search_lifecycle",
    "test_cluster_settings_consumers_take_effect",
    "test_template_bare_topology_keys",
    "test_termvectors",
    "test_search_template",
    "test_termvectors_realtime_and_escaping",
    "test_put_index_settings_dynamic_only",
]
# cases that search
MISC_SEARCHING = {
    "test_sliced_search_partitions_completely", "test_script_fields",
    "test_rank_eval", "test_async_search_lifecycle", "test_search_template",
}


@pytest.mark.parametrize("case,mode", [
    (c, m) for c in MISC_ENV_CASES
    for m in (MODES if c in MISC_SEARCHING else ["default"])])
def test_misc_case_matches_reference(case, mode):
    with _mode_env(mode):
        twin = AdminTwin(mode)
        try:
            getattr(ref_misc, case)((twin.node, _json_call(twin)))
        finally:
            twin.close()


@pytest.mark.parametrize("mode", MODES)
def test_misc_profile_and_hot_threads_match_reference(mode):
    """test_profile_and_hot_threads: the profile tree is the reference's
    but for its timings; both nodes' hot threads are a text report."""
    with _mode_env(mode):
        twin = AdminTwin(mode)
        try:
            ref_misc.fill(_json_call(twin), n=30)
            st, r = _json_call(twin)("POST", "/t/_search", {
                "query": {"bool": {"must": [{"match": {"body": "common"}}],
                                   "filter": [{"term": {"tag": "g1"}}]}},
                "profile": True})
            assert st == 200
            prof = r["profile"]["shards"][0]["searches"][0]["query"]
            assert prof and prof[0]["type"] == "BoolQuery"
            kids = {c["type"] for c in prof[0]["children"]}
            assert {"MatchQuery", "TermQuery"} <= kids
            assert all(c["time_in_nanos"] >= 0 for c in prof[0]["children"])
            for rc in (twin.ref_rc, twin.rc):
                raw = rc.dispatch("GET", "/_nodes/hot_threads", {}, None)
                assert raw.status == 200 and b"thread [" in raw.encode()
        finally:
            twin.close()


def test_misc_search_slow_log_matches_reference(caplog):
    """test_search_slow_log: a 0 ms warn threshold logs the search on
    both nodes, and both slowlog rings hold it."""
    import logging

    twin = AdminTwin("default")
    try:
        call = twin.call
        call("PUT", "/slow", {"settings": {"index": {"search": {"slowlog": {
            "threshold": {"query": {"warn": "0ms"}}}}}}})
        call("PUT", "/slow/_doc/1", {"x": "hello world"})
        call("POST", "/slow/_refresh")
        with caplog.at_level(logging.WARNING,
                             logger="index.search.slowlog"):
            call("POST", "/slow/_search", {"query": {"match": {"x": "hello"}}})
        msgs = [rec.getMessage() for rec in caplog.records
                if rec.name == "index.search.slowlog"]
        assert len(msgs) == 2 and all("took" in m for m in msgs), msgs
        for rc in (twin.ref_rc, twin.rc):
            ring = rc.dispatch("GET", "/_tpu/slowlog", {}, None).body
            assert any(e["index"] == "slow" for e in ring["slowlog"])
    finally:
        twin.close()


def test_misc_plugin_spi_matches_reference(tmp_path, monkeypatch):
    """test_plugin_spi on each package's loader."""
    from elasticsearch_tpu.plugins import (
        PluginError as RefPluginError, load_plugins as ref_load_plugins,
    )
    from elasticsearch_tpu_torch.plugins import PluginError, load_plugins

    (tmp_path / "demo_plugin.py").write_text(
        "def install(node, rc=None):\n"
        "    node.ingest.put_pipeline('from-plugin', {'processors': [\n"
        "        {'set': {'field': 'via', 'value': 'plugin'}}]})\n"
        "    node.plugin_touched = True\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    for make, load, error in ((RefNode, ref_load_plugins, RefPluginError),
                              (lambda: Node(device="cpu"), load_plugins,
                               PluginError)):
        monkeypatch.setenv("ES_TPU_PLUGINS", "demo_plugin")
        node = make()
        try:
            assert load(node) == ["demo_plugin"] and node.plugin_touched
            assert node.ingest.has("from-plugin")
        finally:
            node.close()
        monkeypatch.setenv("ES_TPU_PLUGINS", "no_such_module_xyz")
        node = make()
        try:
            with pytest.raises(error):
                load(node)
        finally:
            node.close()


# ---------------------------------------------------------------------------
# tests/test_snapshots.py: each scenario on each package's node
# ---------------------------------------------------------------------------


def _pkg(ref):
    """The classes a scenario names, from the reference or the port."""
    if ref:
        from elasticsearch_tpu.common.errors import ResourceAlreadyExistsError
        from elasticsearch_tpu.rest import RestController as RC
        from elasticsearch_tpu.rest import register_handlers as reg
        from elasticsearch_tpu.snapshots.repository import (
            SnapshotMissingError,
        )
    else:
        from elasticsearch_tpu_torch.common.errors import (
            ResourceAlreadyExistsError,
        )
        from elasticsearch_tpu_torch.rest import RestController as RC
        from elasticsearch_tpu_torch.rest import register_handlers as reg
        from elasticsearch_tpu_torch.snapshots.repository import (
            SnapshotMissingError,
        )
    return types.SimpleNamespace(
        exists=ResourceAlreadyExistsError, missing=SnapshotMissingError,
        RestController=RC, register_handlers=reg)


def _search(svc, seen):
    r = svc.search({"query": {"match": {"body": "alpha beta"}},
                    "size": 30, "track_total_hits": True})
    seen.append(("search", r))
    return ref_snapshots.results(svc)


def snap_delete_restore_identical(node, pkg, repo, seen):
    svc = ref_snapshots.fill(node)
    for i in range(0, 40, 3):
        svc.delete_doc(str(i))
    svc.refresh()
    want = _search(svc, seen)
    meta = node.snapshots.create("backup", "snap1", ["src"])
    assert meta["state"] == "SUCCESS"
    seen.append(("stats", meta["stats"], meta["shards"]))
    node.delete_index("src")
    assert not node.indices.has("src")
    node.snapshots.restore("backup", "snap1")
    assert _search(node.indices.get("src"), seen) == want
    node.indices.get("src").index_doc("new", {"body": "alpha", "n": 999})
    node.indices.get("src").refresh()
    assert node.indices.get("src").get_doc("new") is not None
    _search(node.indices.get("src"), seen)


def snap_reuses_unchanged_segments(node, pkg, repo, seen):
    svc = ref_snapshots.fill(node)
    node.snapshots.create("backup", "snap1", ["src"])
    blobs = os.path.join(repo, "blobs")
    n1 = len(os.listdir(blobs))
    meta2 = node.snapshots.create("backup", "snap2", ["src"])
    assert len(os.listdir(blobs)) == n1
    assert meta2["stats"]["segments_reused"] == meta2["stats"]["segments"]
    svc.index_doc("x1", {"body": "alpha zeta", "n": 1})
    svc.refresh()
    node.snapshots.create("backup", "snap3", ["src"])
    n3 = len(os.listdir(blobs))
    assert n1 < n3 <= n1 + 2
    seen.append(("blobs", n1, n3, meta2["stats"]))


def snap_restore_with_rename(node, pkg, repo, seen):
    svc = ref_snapshots.fill(node, n=60, shards=1)
    want = _search(svc, seen)
    node.snapshots.create("backup", "snap1", ["src"])
    r = node.snapshots.restore("backup", "snap1", rename_pattern="src",
                               rename_replacement="copy")
    assert r["snapshot"]["indices"] == ["copy"]
    seen.append(("restore", r))
    assert _search(node.indices.get("copy"), seen) == want
    assert node.indices.has("src")
    with pytest.raises(pkg.exists):
        node.snapshots.restore("backup", "snap1")


def snap_delete_gc(node, pkg, repo, seen):
    svc = ref_snapshots.fill(node, n=50, shards=1)
    node.snapshots.create("backup", "a", ["src"])
    svc.index_doc("y", {"body": "beta", "n": 7})
    svc.refresh()
    node.snapshots.create("backup", "b", ["src"])
    blobs = os.path.join(repo, "blobs")
    n_all = len(os.listdir(blobs))
    node.snapshots.delete("backup", "b")
    n_left = len(os.listdir(blobs))
    assert n_left < n_all
    seen.append(("gc", n_all, n_left))
    node.delete_index("src")
    node.snapshots.restore("backup", "a")
    assert node.indices.get("src").doc_count() == 50
    with pytest.raises(pkg.missing):
        node.snapshots.get("backup", "b")
    _search(node.indices.get("src"), seen)


def snap_rest_roundtrip(node, pkg, repo, seen):
    rc = pkg.RestController()
    pkg.register_handlers(node, rc)

    def call(method, path, body=None):
        raw = json.dumps(body).encode() if body is not None else None
        resp = rc.dispatch(method, path, {}, raw)
        out = json.loads(resp.encode() or b"{}")
        seen.append(("rest", method, path, resp.status))
        return resp.status, out

    ref_snapshots.fill(node, index="ri", n=30, shards=1)
    r2 = os.path.join(os.path.dirname(repo), "r2")
    st, _ = call("PUT", "/_snapshot/r2",
                 {"type": "fs", "settings": {"location": r2}})
    assert st == 200
    st, body = call("PUT", "/_snapshot/r2/s1", {"indices": "ri"})
    assert st == 200 and body["snapshot"]["state"] == "SUCCESS"
    st, body = call("GET", "/_snapshot/r2/s1")
    assert st == 200 and body["snapshots"][0]["indices"] == ["ri"]
    st, body = call("POST", "/_snapshot/r2/s1/_restore",
                    {"rename_pattern": "ri", "rename_replacement": "ri2"})
    assert st == 200
    seen.append(("restore", body))
    assert node.indices.get("ri2").doc_count() == 30
    st, _ = call("DELETE", "/_snapshot/r2/s1")
    assert st == 200
    st, _ = call("GET", "/_snapshot/r2/s1")
    assert st == 404
    _search(node.indices.get("ri2"), seen)


SNAPSHOT_CASES = {
    "test_snapshot_delete_restore_identical": snap_delete_restore_identical,
    "test_second_snapshot_reuses_unchanged_segments":
        snap_reuses_unchanged_segments,
    "test_restore_with_rename": snap_restore_with_rename,
    "test_delete_snapshot_gc": snap_delete_gc,
    "test_snapshot_rest_roundtrip": snap_rest_roundtrip,
}


def test_snapshot_cases_are_the_reference_set():
    assert sorted(SNAPSHOT_CASES) == sorted(
        n for n in dir(ref_snapshots) if n.startswith("test_"))


def _hold_seen(got, want, mode):
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        if g[0] == "search":
            (assert_bitwise if mode == "turbo" else assert_same_results)(
                g[1], w[1], g[0])
        else:
            assert g == w


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(SNAPSHOT_CASES))
def test_snapshot_case_matches_reference(case, mode, tmp_path):
    """Each scenario runs on a reference node and on a port node, each
    with a repository of its own; what each saw must agree (search hits
    by the mode's contract)."""
    seen = {}
    with _mode_env(mode):
        for ref in (True, False):
            root = tmp_path / ("ref" if ref else "port")
            repo = str(root / "repo")
            node = RefNode() if ref else Node(device="cpu")
            node.snapshots.put_repository("backup", "fs",
                                          {"location": repo})
            seen[ref] = []
            try:
                if ref:
                    with _no_batching():
                        SNAPSHOT_CASES[case](node, _pkg(ref), repo,
                                             seen[ref])
                else:
                    SNAPSHOT_CASES[case](node, _pkg(ref), repo, seen[ref])
            finally:
                node.close()
    _hold_seen(seen[False], seen[True], mode)


def test_snapshot_blobs_restore_across_packages(tmp_path):
    """A repository the reference wrote restores on the port, and the
    other way round: the blob format is one (`segment_io`, never
    pickle)."""
    for writer_ref in (True, False):
        repo = str(tmp_path / f"repo-{writer_ref}")
        writer = RefNode() if writer_ref else Node(device="cpu")
        reader = Node(device="cpu") if writer_ref else RefNode()
        try:
            for n in (writer, reader):
                n.snapshots.put_repository("backup", "fs",
                                           {"location": repo})
            with _no_batching():
                svc = ref_snapshots.fill(writer, n=60, shards=1)
                want = ref_snapshots.results(svc)
                writer.snapshots.create("backup", "s", ["src"])
            with _no_batching():
                reader.snapshots.restore("backup", "s")
                got = ref_snapshots.results(reader.indices.get("src"))
            assert got == want
        finally:
            writer.close()
            reader.close()


# ---------------------------------------------------------------------------
# tests/test_tasks.py
# ---------------------------------------------------------------------------


def _task_services():
    from elasticsearch_tpu.cluster.state import IndexMetadata as RefMeta
    from elasticsearch_tpu.common.settings import Settings as RefSettings
    from elasticsearch_tpu.index.index_service import (
        IndexService as RefIndexService,
    )
    from elasticsearch_tpu_torch.cluster.state import IndexMetadata
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.index_service import IndexService

    mappings = {"properties": {"body": {"type": "text"},
                               "n": {"type": "integer"}}}
    ref = RefIndexService(RefMeta(index="t", uuid="u",
                                  settings=RefSettings({}),
                                  mappings=mappings))
    port = IndexService(IndexMetadata(index="t", uuid="u",
                                      settings=Settings({}),
                                      mappings=mappings), device="cpu")
    for svc in (ref, port):
        rng = np.random.default_rng(3)
        for i in range(600):
            words = [f"w{rng.integers(0, 3000)}" for _ in range(6)]
            svc.index_doc(str(i), {"body": " ".join(words), "n": i})
            if i % 100 == 99:
                svc.refresh()
        svc.refresh()
    return ref, port


@pytest.fixture(scope="module")
def task_svcs():
    ref, port = _task_services()
    yield ref, port
    ref.close()
    port.close()


def test_task_register_list_cancel_matches_reference():
    from elasticsearch_tpu.tasks import TaskManager as RefTaskManager
    from elasticsearch_tpu_torch.tasks import TaskCancelledError, TaskManager

    seen = []
    for tm in (RefTaskManager("node-A"), TaskManager("node-A")):
        t = tm.register("indices:data/read/search", "test")
        seen.append((tm.get(t.id) is t, t in tm.list("indices:data/read/*"),
                     tm.list("cluster:*"), t.id, t.node, t.to_dict().keys()))
        tm.cancel(t.id)
        assert t.is_cancelled
        tm.unregister(t)
        assert tm.get(t.id) is None
    assert seen[0] == seen[1]
    with pytest.raises(TaskCancelledError):
        t.check()


def test_task_precancelled_search_raises_promptly(task_svcs):
    from elasticsearch_tpu_torch.tasks import TaskCancelledError, TaskManager

    _, svc = task_svcs
    task = TaskManager("n").register("indices:data/read/search",
                                     "wildcard agg")
    task.cancel()
    body = {"query": {"wildcard": {"body": {"value": "w1*"}}},
            "aggs": {"m": {"max": {"field": "n"}}}}
    t0 = time.monotonic()
    with pytest.raises(TaskCancelledError):
        svc.search(body, task=task)
    assert time.monotonic() - t0 < 2.0


def test_task_cancel_mid_flight_returns_promptly(task_svcs):
    """The reference's case on the port's service, with its timings: a
    heavy wildcard-agg search cancelled mid-flight returns within the
    uncancelled wall + 0.5 s, when the cancel wins the race; uncancelled,
    its answer is the reference's."""
    from elasticsearch_tpu_torch.tasks import TaskCancelledError, TaskManager

    ref, svc = task_svcs
    body = {"query": {"wildcard": {"body": {"value": "w*"}}},
            "aggs": {"terms": {"terms": {"field": "n", "size": 50}}}}
    t0 = time.monotonic()
    full = svc._search_dense(body)
    full_wall = time.monotonic() - t0
    with _no_batching():
        want = ref._search_dense(body)
    assert full["aggregations"] == want["aggregations"]
    assert full["hits"]["total"] == want["hits"]["total"]
    task = TaskManager("n").register("indices:data/read/search", "heavy")
    canceller = threading.Timer(min(full_wall / 4, 0.05), task.cancel)
    canceller.start()
    t0 = time.monotonic()
    try:
        svc.search(body, task=task)
    except TaskCancelledError:
        assert time.monotonic() - t0 < full_wall + 0.5
    finally:
        canceller.cancel()


def test_task_timeout_partial_matches_reference(task_svcs):
    ref, svc = task_svcs
    body = {"query": {"match_all": {}}, "timeout": "0ms",
            "track_total_hits": True}
    r = svc._search_dense(body)
    with _no_batching():
        want = ref._search_dense(body)
    assert r["timed_out"] is True and want["timed_out"] is True
    assert r["hits"]["total"] == want["hits"]["total"]
    full = svc._search_dense({"query": {"match_all": {}},
                              "track_total_hits": True})
    assert full["timed_out"] is False
    assert r["hits"]["total"]["value"] <= full["hits"]["total"]["value"]


def test_task_terminate_after_matches_reference(task_svcs):
    ref, svc = task_svcs
    body = {"query": {"match_all": {}}, "terminate_after": 150,
            "track_total_hits": True}
    r = svc._search_dense(body)
    with _no_batching():
        want = ref._search_dense(body)
    assert r.get("terminated_early") is True
    assert 150 <= r["hits"]["total"]["value"] < 600
    assert (r["hits"]["total"], r.get("terminated_early")) == \
        (want["hits"]["total"], want.get("terminated_early"))


def test_tasks_rest_api_matches_reference():
    twin = AdminTwin("default")
    try:
        t = twin.node.tasks.register("indices:data/read/search", "slow one")
        rt = twin.ref.tasks.register("indices:data/read/search", "slow one")
        assert (t.id, t.node) == (rt.id, twin.node.node_id)
        r = twin.call("GET", "/_tasks")
        assert f"{t.node}:{t.id}" in r.body["nodes"][t.node]["tasks"]
        r = twin.call("GET", f"/_tasks/{t.node}:{t.id}")
        assert r.status == 200 and r.body["task"]["description"] == "slow one"
        # _cat/tasks: start time (epoch ms, time of day) and running time
        # masked
        rows = [re.sub(r"\d{13} \d+:\d+:\d+ [\d.]+\w+", "<time>",
                       rc.dispatch("GET", "/_cat/tasks", {}, None).body)
                for rc in (twin.ref_rc, twin.rc)]
        assert twin.translate(types.SimpleNamespace(body=rows[0])).body \
            == rows[1]
        assert f"{t.node}:{t.id}" in rows[1]
        r = twin.call("POST", f"/_tasks/{t.node}:{t.id}/_cancel")
        assert r.status == 200 and t.is_cancelled and rt.is_cancelled
        assert twin.call("GET", "/_tasks/zzz:notanum").status == 400
        assert twin.call("POST", "/_tasks/_cancel",
                         params={"actions": "indices:*"}).status == 200
    finally:
        twin.close()


# ---------------------------------------------------------------------------
# tests/test_ingest.py: the /_ingest/pipeline routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_ingest_pipeline_routes_match_reference(mode):
    """test_bulk_and_default_pipeline_integration with its pipelines put
    over REST, then get (one, all, missing), simulate (by id, inline,
    GET), delete and get again."""
    with _mode_env(mode):
        twin = AdminTwin(mode)
        try:
            call = twin.call
            clean = {"processors": [{"lowercase": {"field": "tag"}},
                                    {"set": {"field": "via",
                                             "value": "clean"}}]}
            assert call("PUT", "/_ingest/pipeline/clean", clean).status == 200
            call("PUT", "/pipes", {"settings": {
                "index": {"default_pipeline": "clean"}}})
            assert call("PUT", "/pipes/_doc/1", {"tag": "HOT"}).status \
                in (200, 201)
            call("POST", "/pipes/_refresh")
            assert call("GET", "/pipes/_doc/1").body["_source"] == \
                {"tag": "hot", "via": "clean"}
            call("PUT", "/_ingest/pipeline/dropper",
                 {"processors": [{"drop": {}}]})
            lines = [
                json.dumps({"index": {"_index": "pipes", "_id": "2",
                                      "pipeline": "dropper"}}),
                json.dumps({"tag": "GONE"}),
                json.dumps({"index": {"_index": "pipes", "_id": "3",
                                      "pipeline": "clean"}}),
                json.dumps({"tag": "WARM"}),
            ]
            r = call("POST", "/_bulk", "\n".join(lines) + "\n")
            assert r.body["items"][0]["index"]["result"] == "noop"
            call("POST", "/pipes/_refresh")
            assert call("GET", "/pipes/_doc/2").status == 404
            assert call("GET", "/pipes/_doc/3").body["_source"]["tag"] \
                == "warm"
            call("POST", "/pipes/_search", {"query": {"match_all": {}}})
            assert call("GET", "/_ingest/pipeline/clean").body == \
                {"clean": clean}
            assert set(call("GET", "/_ingest/pipeline").body) == \
                {"clean", "dropper"}
            assert call("GET", "/_ingest/pipeline/ghost").status == 404
            docs = {"docs": [{"_source": {"tag": "A"}},
                             {"_source": {"other": 1}}]}
            call("POST", "/_ingest/pipeline/clean/_simulate", docs)
            call("GET", "/_ingest/pipeline/clean/_simulate", docs)
            call("POST", "/_ingest/pipeline/_simulate", dict(
                docs, pipeline={"processors": [
                    {"uppercase": {"field": "tag"}}]}))
            assert call("DELETE", "/_ingest/pipeline/dropper").status == 200
            assert call("GET", "/_ingest/pipeline/dropper").status == 404
            assert call("DELETE", "/_ingest/pipeline/dropper").status == 404
        finally:
            twin.close()


# ---------------------------------------------------------------------------
# tests/test_ccs_ccr.py::test_rest_ccr_endpoints_and_stats_sections
# ---------------------------------------------------------------------------


def test_rest_ccr_endpoints_and_stats_match_reference(monkeypatch):
    """Twin REST nodes, each following an index of a standalone leader
    node of its own package registered as remote `east`."""
    from elasticsearch_tpu.transport.channels import (
        LocalNodeChannels as RefChannels,
    )
    from elasticsearch_tpu_torch.transport.channels import LocalNodeChannels

    monkeypatch.setenv("ES_TPU_CCR_POLL_MS", "0")
    twin = AdminTwin("default")
    ref_east = RefNode(node_name="east-0")
    east = Node(node_name="east-0", device="cpu")
    twin.ids[east.node_id] = ref_east.node_id
    try:
        for local, leader, ch in ((twin.ref, ref_east, RefChannels()),
                                  (twin.node, east, LocalNodeChannels())):
            ch.register("east-0", leader.transport)
            local.remotes.register_remote("east", ch, ["east-0"],
                                          skip_unavailable=True)
            leader.create_index("logs", {"settings": {"number_of_shards": 1}})
            for i in range(4):
                leader.indices.get("logs").index_doc(f"e{i}", {"n": i})
        call = twin.call
        r = call("PUT", "/logs_copy/_ccr/follow",
                 {"remote_cluster": "east", "leader_index": "logs"})
        assert r.status == 200 and r.body["index_following_started"]
        assert call("PUT", "/nocluster/_ccr/follow",
                    {"leader_index": "logs"}).status == 400
        with _no_batching():
            assert twin.ref.ccr.poll_once() == 4
        assert twin.node.ccr.poll_once() == 4
        r = call("GET", "/logs_copy/_ccr/stats")
        shard = r.body["indices"][0]["shards"][0]
        assert shard["follower_checkpoint"] == 3 and shard["lag_ops"] == 0
        assert call("POST", "/logs_copy/_ccr/pause_follow").body[
            "acknowledged"]
        assert call("POST", "/logs_copy/_ccr/resume_follow").body[
            "acknowledged"]
        call("POST", "/logs_copy/_refresh")
        call("POST", "/logs_copy/_search", {"query": {"match_all": {}},
                                            "sort": [{"n": "asc"}]})
        call("GET", "/_remote/info")
        stats = call("GET", "/_nodes/stats")
        node_stats = next(iter(stats.body["nodes"].values()))
        assert node_stats["tpu_ccr"]["followers"][0]["index"] == "logs_copy"
        assert node_stats["tpu_ccs"]["remote_clusters"] == ["east"]
        assert twin.node.ccr.follower_stats() == \
            twin.ref.ccr.follower_stats()
    finally:
        twin.close()
        east.close()
        ref_east.close()


# ---------------------------------------------------------------------------
# the route table
# ---------------------------------------------------------------------------


def _route_table(rc):
    return {(method, "/" + "/".join(r.segments))
            for method, routes in rc._routes.items() for r in routes}


def test_route_table_matches_reference():
    """The two controllers register the same (method, pattern) pairs, and
    the port's `_Handlers` has every method of the reference's."""
    from elasticsearch_tpu.rest import handlers as ref_handlers
    from elasticsearch_tpu_torch.rest import handlers

    ref, node = RefNode(), Node(device="cpu")
    try:
        ref_rc, rc = RefRestController(), RestController()
        ref_register_handlers(ref, ref_rc)
        register_handlers(node, rc)
        assert _route_table(rc) == _route_table(ref_rc)
        assert {("GET", "/_tasks"), ("PUT", "/_snapshot/{repo}"),
                ("POST", "/{alias}/_rollover"),
                ("POST", "/{index}/_async_search"),
                ("GET", "/_security/_authenticate")} <= _route_table(rc)
    finally:
        node.close()
        ref.close()
    methods = {n for n in vars(handlers._Handlers) if not n.startswith("__")}
    ref_methods = {n for n in vars(ref_handlers._Handlers)
                   if not n.startswith("__")}
    assert ref_methods <= methods


def test_secured_async_search_and_api_key_ids_map():
    """An API key and an async search on twin secured nodes: the random
    ids of each are mapped, and the later calls that name them answer
    alike."""
    twin = AdminTwin("default", SECURE)
    try:
        call = twin.call
        call("PUT", "/t/_doc/1", {"body": "hello"}, params={"refresh": "true"},
             headers=ELASTIC)
        key = call("POST", "/_security/api_key", {"name": "k"},
                   headers=ELASTIC).body
        hdr = {"Authorization": f"ApiKey {key['encoded']}"}
        assert base64.b64decode(key["encoded"]).decode().startswith(
            key["id"] + ":")
        r = call("POST", "/t/_async_search", {"query": {"match": {
            "body": "hello"}}}, params={"wait_for_completion_timeout": "10s"},
            headers=hdr)
        assert r.status == 200 and not r.body["is_running"]
        sid = r.body["id"]
        assert call("GET", f"/_async_search/{sid}", headers=hdr).status == 200
        assert call("DELETE", f"/_async_search/{sid}",
                    headers=hdr).status == 200
        assert call("GET", f"/_async_search/{sid}", headers=hdr).status == 404
        call("DELETE", "/_security/api_key", {"id": key["id"]},
             headers=ELASTIC)
        assert call("GET", "/t/_count", headers=hdr).status == 401
    finally:
        twin.close()
