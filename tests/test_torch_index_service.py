"""The port's IndexService and serving fast path against the reference's,
on the CPU.

The same documents go into the reference's `IndexService` and the port's
(`device="cpu"`, the kernels' plain versions), and the cases of
tests/test_serving.py run on both:

* `turbo` mode (ES_TPU_FORCE_TURBO=1, ES_TPU_TURBO_COLD_DF=8): both
  packages serve through Turbo; ids, totals and `_source` are equal and
  scores are bitwise equal.
* `default` mode: both packages serve disjunctions through BlockMax
  (`select_bm25_engine` off the card without ES_TPU_FORCE_TURBO). The
  port's answers are held to the reference's BlockMax answers under
  tests/test_blockmax.py's rule (`assert_blockmax_results`: scores within
  rtol and atol 2e-5, ids and order equal wherever adjacent scores are
  separated beyond that, the same set across near-ties; the two sum a
  doc's terms in different orders, ROADMAP W2), totals and `_source`
  equal, and to the port's dense executor within the reference's own
  bound (`assert_same_results`: 2e-4 relative plus 2e-4).

Conjunctive bodies Turbo cannot take go to the host columnar executor in
both packages. kNN bodies go through `_knn_batch` with ES_TPU_FORCE_KNN=1:
ids and order equal, scores within 2 ulp (ROADMAP W1).
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster.state import IndexMetadata as RefMeta
from elasticsearch_tpu.common.errors import (
    ElasticsearchTpuError as RefEsError,
)
from elasticsearch_tpu.common.settings import Settings as RefSettings
from elasticsearch_tpu.index.index_service import IndexService as RefService
from elasticsearch_tpu.search import serving as ref_serving
from elasticsearch_tpu_torch.cluster.state import IndexMetadata
from elasticsearch_tpu_torch.common.errors import (
    DeviceUnavailableError, ElasticsearchTpuError,
)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.index_service import (
    IndexService, IndicesService,
)
from elasticsearch_tpu_torch.search import serving

torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta",
         "iota", "kappa", "lam", "mu", "nu", "xi", "omicron", "pi"]
TAGS = ["red", "green", "blue", "yellow"]
MAPPINGS = {"properties": {"body": {"type": "text"},
                           "tag": {"type": "keyword"},
                           "n": {"type": "integer"}}}
TURBO_ENV = {"ES_TPU_FORCE_TURBO": "1", "ES_TPU_TURBO_COLD_DF": "8"}

# tests/test_serving.py BODIES and INELIGIBLE
BODIES = [
    {"query": {"match": {"body": "alpha beta"}}},
    {"query": {"match": {"body": "gamma"}}, "size": 25},
    {"query": {"term": {"body": {"value": "delta", "boost": 2.0}}}},
    {"query": {"match": {"body": {"query": "alpha beta gamma",
                                  "operator": "and"}}}},
    {"query": {"bool": {
        "must": [{"match": {"body": {"query": "alpha", "operator": "and"}}}],
        "filter": [{"term": {"tag": "red"}}]}}},
    {"query": {"bool": {
        "must": [{"term": {"body": "beta"}}],
        "should": [{"term": {"body": "gamma"}}, {"term": {"body": "pi"}}],
        "must_not": [{"term": {"tag": "blue"}}]}}},
    {"query": {"bool": {
        "filter": [{"terms": {"tag": ["red", "green"]}},
                   {"term": {"body": "epsilon"}}],
        "must": [{"match": {"body": {"query": "zeta", "operator": "and"}}}]}}},
    {"query": {"match_phrase": {"body": "alpha beta"}}},
    {"query": {"match_phrase": {"body": {"query": "alpha gamma", "slop": 2}}}},
    {"query": {"bool": {
        "must": [{"match_phrase": {"body": "beta gamma"}}],
        "filter": [{"term": {"tag": "green"}}]}}},
    {"query": {"match": {"body": "theta iota"}}, "from": 5, "size": 10},
    {"query": {"match": {"body": "kappa"}}, "track_total_hits": 20},
    {"query": {"match": {"body": "mu nu xi"}}, "track_total_hits": True},
    {"query": {"bool": {"should": [{"match": {"body": "omicron"}},
                                   {"term": {"body": "pi"}}]}}},
    {"query": {"bool": {
        "must": [{"match": {"body": {"query": "alpha", "operator": "and"}}}],
        "filter": [{"bool": {"should": [{"term": {"tag": "red"}},
                                        {"term": {"tag": "green"}}]}}]}}},
    {"query": {"bool": {
        "filter": [{"bool": {"must": [{"term": {"body": "beta"}}],
                             "should": [{"term": {"tag": "red"}}]}}],
        "must": [{"term": {"body": "gamma"}}]}}},
]

INELIGIBLE = [
    {"query": {"match": {"body": "alpha"}}, "sort": [{"n": "asc"}]},
    {"query": {"match": {"body": "alpha"}},
     "aggs": {"m": {"max": {"field": "n"}}}},
    {"query": {"range": {"n": {"gte": 10}}}},
    {"query": {"bool": {"should": [{"match": {"body": "alpha"}}],
                        "minimum_should_match": 2}}},
    {"query": {"match_all": {}}},
    {"query": {"wildcard": {"body": {"value": "alp*"}}}},
    {"query": {"bool": {
        "must": [{"bool": {"should": [{"term": {"body": "beta"}},
                                      {"term": {"body": "gamma"}}]}},
                 {"term": {"body": "alpha"}}]}}},
    {"query": {"bool": {"should": [
        {"match": {"body": {"query": "alpha beta", "operator": "and"}}},
        {"term": {"body": "gamma"}}]}}},
]


def _docs(n_docs=400, seed=31):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_docs):
        words = rng.choice(WORDS, size=int(rng.integers(3, 20)))
        out.append((str(i), {"body": " ".join(words),
                             "tag": str(rng.choice(TAGS)),
                             "n": int(rng.integers(0, 100))}))
    return out


def _fill(svc, docs, refresh_at=150, deletes=range(0, 60, 7)):
    for i, (doc_id, src) in enumerate(docs):
        svc.index_doc(doc_id, src)
        if i == refresh_at:
            svc.refresh()       # two segments in shard 0
    for i in deletes:
        svc.delete_doc(str(i))
    svc.refresh()
    return svc


@contextlib.contextmanager
def _no_batching():
    """ES_TPU_COALESCE_US=0 for the duration: dispatches run directly on
    the calling thread."""
    prev = os.environ.get("ES_TPU_COALESCE_US")
    os.environ["ES_TPU_COALESCE_US"] = "0"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["ES_TPU_COALESCE_US"]
        else:
            os.environ["ES_TPU_COALESCE_US"] = prev


class _Direct:
    """The reference's service with every call dispatched directly (rows
    are bitwise those of its scheduler, by its own contract): the expected
    values come from the calling thread, and only the port's calls go
    through scheduler lanes (jax compiles in the reference's lane threads
    stalled this process)."""

    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        v = getattr(self._obj, name)
        if name == "serving":
            return _Direct(v)
        if not callable(v):
            return v

        def call(*args, **kwargs):
            with _no_batching():
                return v(*args, **kwargs)
        return call


def _pair(index="t", shards=1, mappings=MAPPINGS, docs=None, **fill):
    """(reference service, port service) over the same documents."""
    settings = {"index.number_of_shards": shards} if shards > 1 else {}
    ref = _Direct(RefService(RefMeta(index=index, uuid="u_" + index,
                                      settings=RefSettings(settings),
                                      mappings=mappings)))
    port = IndexService(IndexMetadata(index=index, uuid="u_" + index,
                                      settings=Settings(settings),
                                      mappings=mappings), device="cpu")
    docs = _docs() if docs is None else docs
    return _fill(ref, docs, **fill), _fill(port, docs, **fill)


@pytest.fixture(scope="module", params=["turbo", "default"])
def mode(request):
    mp = pytest.MonkeyPatch()
    for key in TURBO_ENV:
        mp.delenv(key, raising=False)
    if request.param == "turbo":
        for key, val in TURBO_ENV.items():
            mp.setenv(key, val)
    ref, port = _pair(index="t_" + request.param)
    yield request.param, ref, port
    ref.close()
    port.close()
    mp.undo()


def assert_same_results(fast, dense, body):
    """tests/test_serving.py's bound between two routes."""
    fh = fast["hits"]["hits"]
    dh = dense["hits"]["hits"]
    assert [h["_id"] for h in fh] == [h["_id"] for h in dh], body
    for a, b in zip(fh, dh):
        if a.get("_score") is not None and b.get("_score") is not None:
            assert abs(a["_score"] - b["_score"]) \
                <= 2e-4 * abs(b["_score"]) + 2e-4, body
        assert a["_source"] == b["_source"]
    assert fast["hits"].get("total") == dense["hits"].get("total"), body
    fm, dm = fast["hits"]["max_score"], dense["hits"]["max_score"]
    if fm is None or dm is None:
        assert fm == dm, body
    else:
        assert abs(fm - dm) <= 2e-4 * abs(dm) + 2e-4


def assert_bitwise(got, want, body):
    """The same hits, totals and _source, scores bitwise."""
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert [h["_id"] for h in gh] == [h["_id"] for h in wh], body
    assert [np.float32(h["_score"]) for h in gh] == \
        [np.float32(h["_score"]) for h in wh], body
    assert [h["_source"] for h in gh] == [h["_source"] for h in wh], body
    assert got["hits"].get("total") == want["hits"].get("total"), body
    assert got["hits"]["max_score"] == want["hits"]["max_score"], body


def assert_blockmax_results(got, want, body):
    """tests/test_blockmax.py's rule on two responses: scores within rtol
    and atol 2e-5; the same ids in the same order wherever adjacent scores
    are separated beyond that, the same set across near-ties; totals,
    max_score and each hit's _source equal."""
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert len(gh) == len(wh), body
    gs = np.asarray([h["_score"] for h in gh], np.float64)
    ws = np.asarray([h["_score"] for h in wh], np.float64)
    np.testing.assert_allclose(gs, ws, rtol=2e-5, atol=2e-5)
    gaps = np.abs(np.diff(ws)) > 2e-5 * np.abs(ws[:-1]) + 2e-5
    gid, wid = [h["_id"] for h in gh], [h["_id"] for h in wh]
    if gaps.all():
        assert gid == wid, body
    else:
        assert set(gid) == set(wid), body
    src = {h["_id"]: h["_source"] for h in wh}
    assert all(h["_source"] == src[h["_id"]] for h in gh), body
    assert got["hits"].get("total") == want["hits"].get("total"), body
    fm, wm = got["hits"]["max_score"], want["hits"]["max_score"]
    assert (fm is None) == (wm is None), body
    if fm is not None:
        assert abs(fm - wm) <= 2e-5 * abs(wm) + 2e-5, body


# ---------------------------------------------------------------------------
# tests/test_serving.py on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("body", BODIES, ids=range(len(BODIES)))
def test_fast_path_matches_dense(mode, body):
    name, ref, port = mode
    assert serving.extract_plan(body, port.mapper) is not None
    want = ref.serving.try_search(body, "query_then_fetch")
    assert want is not None
    plan = serving.extract_plan(body, port.mapper)
    fast = port.serving.try_search(body, "query_then_fetch")
    assert fast is not None, f"fast path did not engage: {body}"
    assert_same_results(fast, port._search_dense(body), body)
    if name == "default" and plan.is_disjunctive:
        # both packages' BlockMax route
        assert port.serving.snapshot().engine("body").kind == "blockmax"
        assert_blockmax_results(fast, want, body)
        return
    assert_bitwise(fast, want, body)


@pytest.mark.parametrize("body", INELIGIBLE, ids=range(len(INELIGIBLE)))
def test_ineligible_bodies_fall_back(mode, body):
    _, ref, port = mode
    assert serving.extract_plan(body, port.mapper) is None, body
    assert ref_serving.extract_plan(body, ref.mapper) is None, body
    got, want = port.search(body), ref.search(body)
    assert "hits" in got
    assert_same_results(got, want, body)


def test_msearch_batches_match_individual(mode):
    _, ref, port = mode
    bodies = [
        {"query": {"match": {"body": "alpha"}}},
        {"query": {"match": {"body": "beta gamma"}}},
        {"query": {"range": {"n": {"gte": 50}}}},        # dense fallback
        {"query": {"bool": {"must": [{"term": {"body": "delta"}}],
                            "filter": [{"term": {"tag": "red"}}]}}},
    ]
    batch = port.msearch(bodies)
    want = ref.msearch(bodies)
    for body, br, wr in zip(bodies, batch, want):
        assert_same_results(br, port._search_dense(body), body)
        assert_same_results(br, wr, body)


def test_random_disjunctions_match(mode):
    name, ref, port = mode
    rng = np.random.default_rng(7)
    for _ in range(25):
        n = int(rng.integers(1, 4))
        terms = rng.choice(WORDS, size=n, replace=False)
        body = {"query": {"match": {"body": " ".join(terms)}},
                "size": int(rng.integers(1, 30))}
        fast = port.serving.try_search(body, "query_then_fetch")
        want = ref.serving.try_search(body, "query_then_fetch")
        assert fast is not None
        assert_same_results(fast, port._search_dense(body), body)
        if name == "default":
            assert_blockmax_results(fast, want, body)
            continue
        assert_bitwise(fast, want, body)


def test_track_total_hits_false_omits_total_on_both_paths(mode):
    _, ref, port = mode
    body = {"query": {"match": {"body": "alpha"}}, "track_total_hits": False}
    got = port.search(body)
    dense = port._search_dense(body)
    assert "total" not in got["hits"] and "total" not in dense["hits"]
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in dense["hits"]["hits"]] == \
        [h["_id"] for h in ref.search(body)["hits"]["hits"]]


def test_msearch_isolates_per_body_errors(mode):
    _, ref, port = mode
    bodies = [
        {"query": {"match": {"body": "alpha"}}},
        {"query": {"no_such_query": {}}},
        {"query": {"term": {"body": "beta"}}},
    ]
    out = port.msearch(bodies)
    want = ref.msearch(bodies)
    assert "hits" in out[0] and "hits" in out[2]
    assert isinstance(out[1], ElasticsearchTpuError)
    assert isinstance(want[1], RefEsError)
    assert str(out[1]) == str(want[1])
    for i in (0, 2):
        assert_same_results(out[i], want[i], bodies[i])


def test_multi_shard_defaults_to_dense_but_dfs_serves(monkeypatch):
    """Two shards: the fast path declines query_then_fetch; with
    dfs_query_then_fetch it serves (through Turbo here, with the knobs) and
    equals the dense dfs response and the reference's."""
    for key, val in TURBO_ENV.items():
        monkeypatch.setenv(key, val)
    docs = [(str(i), {"body": f"alpha {WORDS[i % len(WORDS)]}"})
            for i in range(100)]
    ref, port = _pair(index="m", shards=2,
                      mappings={"properties": {"body": {"type": "text"}}},
                      docs=docs, refresh_at=-1, deletes=())
    try:
        body = {"query": {"match": {"body": "alpha beta"}}}
        assert port.serving.try_search(body, "query_then_fetch") is None
        fast = port.serving.try_search(body, "dfs_query_then_fetch")
        assert fast is not None
        dense = port._search_dense(body, "dfs_query_then_fetch")
        assert_same_results(fast, dense, body)
        want = ref.serving.try_search(body, "dfs_query_then_fetch")
        assert_bitwise(fast, want, body)
        # the default search_type goes dense on both
        assert_same_results(port.search(body), ref.search(body), body)
    finally:
        ref.close()
        port.close()


@pytest.fixture()
def turbo_pair(monkeypatch):
    """tests/test_serving.py's turbo_svc on both packages."""
    for key, val in TURBO_ENV.items():
        monkeypatch.setenv(key, val)
    rng = np.random.default_rng(99)
    docs = []
    for i in range(320):
        words = rng.choice(WORDS, size=int(rng.integers(3, 16)))
        docs.append((str(i), {"body": " ".join(words)}))
    ref, port = _pair(index="turbo_t",
                      mappings={"properties": {"body": {"type": "text"}}},
                      docs=docs, refresh_at=140, deletes=range(0, 50, 9))
    yield ref, port
    ref.close()
    port.close()


def test_turbo_engine_selected_and_matches_dense(turbo_pair):
    ref, port = turbo_pair
    eng = port.serving.snapshot().engine("body")
    assert eng.kind == "turbo"
    assert len(eng.turbos) == 2
    assert all(t.device.type == "cpu" for t in eng.turbos)
    bodies = [
        {"query": {"match": {"body": "alpha beta"}}},
        {"query": {"match": {"body": "gamma"}}, "size": 20},
        {"query": {"term": {"body": {"value": "delta", "boost": 2.0}}}},
        {"query": {"match": {"body": "theta iota kappa"}}, "from": 3},
        {"query": {"match": {"body": "zzz_missing"}}},
    ]
    for body in bodies:
        fast = port.serving.try_search(body, "query_then_fetch")
        assert fast is not None, body
        assert_same_results(fast, port._search_dense(body), body)
        assert_bitwise(fast, ref.serving.try_search(body, "query_then_fetch"),
                       body)
    assert eng.stats["builds"] > 0
    assert eng.stats["merge_host"] > 0       # two partitions merged


def test_turbo_msearch_batch(turbo_pair):
    ref, port = turbo_pair
    bodies = [{"query": {"match": {"body": w}}} for w in
              ["alpha", "beta gamma", "pi omicron", "mu"]]
    batch = port.msearch(bodies)
    want = ref.msearch(bodies)
    for body, br, wr in zip(bodies, batch, want):
        assert_same_results(br, port._search_dense(body), body)
        assert_bitwise(br, wr, body)


# ---------------------------------------------------------------------------
# the rest of the serving context
# ---------------------------------------------------------------------------


def test_try_query_phase_matches_reference(turbo_pair):
    """The per-shard query-phase fast path: the same leaf/ord hits, scores
    and totals as the reference's, for a disjunction and a bool body."""
    ref, port = turbo_pair
    for body in ({"query": {"match": {"body": "alpha beta"}}, "size": 7},
                 {"query": {"bool": {"must": [{"term": {"body": "beta"}}],
                                     "should": [{"term": {"body": "pi"}}]}}},
                 {"query": {"match": {"body": "gamma"}}, "profile": True}):
        got = port.serving.try_query_phase(body)
        want = ref.serving.try_query_phase(body)
        assert got is not None and want is not None, body
        assert [(h.leaf_idx, h.ord, h.global_ord) for h in got.hits] == \
            [(h.leaf_idx, h.ord, h.global_ord) for h in want.hits], body
        assert [np.float32(h.score) for h in got.hits] == \
            [np.float32(h.score) for h in want.hits], body
        assert (got.total, got.relation, got.max_score) == \
            (want.total, want.relation, want.max_score), body
        if body.get("profile"):
            assert got.profile[-1]["type"] == "DeviceDispatch"
            assert "engine=turbo partitions=2" in \
                got.profile[-1]["description"]
    assert port.serving.try_query_phase(
        {"query": {"range": {"n": {"gte": 1}}}}) is None


def test_check_cancels_through_serving(turbo_pair):
    """A cancelled task raises through try_search before any dispatch, as
    in the reference; an expired timeout gives a timed_out response."""
    from elasticsearch_tpu_torch.tasks.task_manager import (
        TaskCancelledError, TaskManager,
    )

    _, port = turbo_pair
    task = TaskManager("n").register("indices:data/read/search")
    task.cancel("test")
    for body in ({"query": {"match": {"body": "alpha"}}},
                 {"query": {"bool": {"must": [{"term": {"body": "beta"}}]}}}):
        with pytest.raises(TaskCancelledError):
            port.serving.try_search(body, "query_then_fetch", task=task)


def test_blockmax_serves_default_mode(monkeypatch):
    """No knobs on the CPU: both snapshots select BlockMax, msearch serves
    every body of the batch through it (one _disjunctive_batch), and the
    port's answers hold to the reference's BlockMax answers."""
    for key in TURBO_ENV:
        monkeypatch.delenv(key, raising=False)
    ref, port = _pair(index="bm")
    try:
        eng = port.serving.snapshot().engine("body")
        assert eng.kind == "blockmax" == \
            ref.serving.snapshot().engine("body").kind
        assert serving.engine_desc(eng) == ("blockmax", 1)
        bodies = [{"query": {"match": {"body": w}}}
                  for w in ("alpha", "beta gamma", "pi")]
        served = port.serving.try_msearch(bodies, "query_then_fetch")
        assert all(r is not None for r in served)
        want = ref.msearch(bodies)
        for body, got, w in zip(bodies, port.msearch(bodies), want):
            assert_blockmax_results(got, w, body)
            assert_same_results(got, port._search_dense(body), body)
        assert eng.last_timing["n_queries"] == 3
    finally:
        ref.close()
        port.close()


LONG_VOCAB = [f"w{i}" for i in range(160)]


def _long_docs(n_docs=400, seed=37):
    """Documents over LONG_VOCAB, each word in about 7% of them: no word
    is hot (df > docs / 8), so each term of a match is a K10 run."""
    rng = np.random.default_rng(seed)
    return [(str(i), {"body": " ".join(rng.choice(LONG_VOCAB,
                                                  int(rng.integers(3, 20)))),
                      "tag": str(rng.choice(TAGS)),
                      "n": int(rng.integers(0, 100))})
            for i in range(n_docs)]


def test_blockmax_long_match_matches_reference(monkeypatch):
    """A pasted-text `match` of 100 distinct terms beside short bodies in
    one msearch: BlockMax serves every body (K10 rows of 100 runs, more
    than the kernel stages in a pass; no body goes to the dense executor)
    and the port's answers hold to the reference's BlockMax answers."""
    from elasticsearch_tpu_torch.parallel import kernels

    for key in TURBO_ENV:
        monkeypatch.delenv(key, raising=False)
    runs = []
    lane_topk = kernels.lane_topk

    def spy(*args, **kw):
        runs.append(int(args[5].shape[2]) - 1)
        return lane_topk(*args, **kw)

    monkeypatch.setattr(kernels, "lane_topk", spy)
    ref, port = _pair(index="bml", docs=_long_docs())
    try:
        assert port.serving.snapshot().engine("body").kind == "blockmax"
        bodies = [{"query": {"match": {"body": " ".join(LONG_VOCAB[:100])}}},
                  {"query": {"match": {"body": " ".join(LONG_VOCAB[40:140])}},
                   "size": 25},
                  {"query": {"match": {"body": "w3 w150"}}}]
        f0 = serving.serving_fault_stats()["fastpath_reject_error"]
        served = port.serving.try_msearch(bodies, "query_then_fetch")
        assert all(r is not None for r in served)
        assert serving.serving_fault_stats()["fastpath_reject_error"] == f0
        assert max(runs) >= 100
        for body, got, want in zip(bodies, served, ref.msearch(bodies)):
            assert_blockmax_results(got, want, body)
            assert_same_results(got, port._search_dense(body), body)
    finally:
        ref.close()
        port.close()


def _trip(health):
    while health.allow_device():
        health.record_fault(RuntimeError("tripped by the test"))


def test_blockmax_circuit_sends_batch_to_dense(monkeypatch):
    """A tripped BlockMaxBM25.health: _disjunctive_batch and try_search
    decline every body before any dispatch and count the fallback, as the
    reference's circuit does; the dense executor answers them."""
    for key in TURBO_ENV:
        monkeypatch.delenv(key, raising=False)
    ref, port = _pair(index="bmc")
    try:
        bodies = [{"query": {"match": {"body": w}}}
                  for w in ("alpha", "beta gamma", "pi")]
        engines = [svc.serving.snapshot().engine("body") for svc in (ref, port)]
        for eng in engines:
            _trip(eng.health)
        before = [eng.health.flat_stats() for eng in engines]
        assert ref.serving.try_msearch(bodies, "query_then_fetch") == \
            port.serving.try_msearch(bodies, "query_then_fetch") == \
            [None] * 3
        assert ref.serving.try_search(bodies[0], "query_then_fetch") is None
        assert port.serving.try_search(bodies[0], "query_then_fetch") is None
        after = [eng.health.flat_stats() for eng in engines]
        deltas = [{k: a[k] - b.get(k, 0) for k in a}
                  for a, b in zip(after, before)]
        assert deltas[0] == deltas[1]
        assert any(v == 4 for k, v in deltas[1].items() if "fallback" in k)
        for body, got, want in zip(bodies, port.msearch(bodies),
                                   ref.msearch(bodies)):
            assert_same_results(got, want, body)
    finally:
        ref.close()
        port.close()


def test_blockmax_pass_fault_is_contained(monkeypatch):
    """blockmax_pass:raise@1 fails the first BlockMax dispatch: dispatched
    directly (ES_TPU_COALESCE_US=0), the batch is contained
    (fastpath_device_fault counted, the engine's circuit records the
    fault) and the dense executor answers, as in the reference; the next
    batch serves through BlockMax again."""
    from elasticsearch_tpu.common import faults as ref_faults
    from elasticsearch_tpu_torch.common import faults

    for key in TURBO_ENV:
        monkeypatch.delenv(key, raising=False)
    ref, port = _pair(index="bmf")
    try:
        bodies = [{"query": {"match": {"body": w}}}
                  for w in ("alpha", "beta gamma")]
        counts = []
        for svc, flt, mod in ((ref, ref_faults, ref_serving),
                              (port, faults, serving)):
            eng = svc.serving.snapshot().engine("body")
            c0 = mod.serving_fault_stats()["fastpath_device_fault"]
            h0 = eng.health.flat_stats()
            with flt.inject("blockmax_pass:raise@1"), _no_batching():
                first = svc.serving.try_msearch(bodies, "query_then_fetch")
                second = svc.serving.try_msearch(bodies, "query_then_fetch")
            assert first == [None, None]
            assert all(r is not None for r in second)
            h1 = eng.health.flat_stats()
            counts.append((
                mod.serving_fault_stats()["fastpath_device_fault"] - c0,
                {k: h1[k] - h0.get(k, 0) for k in h1}))
        assert counts[0] == counts[1] and counts[1][0] == 1
        # through the port's scheduler the failed batch is retried query by
        # query (its poison-batch containment), so the fault fired once
        # costs no body its fast path
        with faults.inject("blockmax_pass:raise@1"):
            assert all(r is not None for r in port.serving.try_msearch(
                bodies, "query_then_fetch"))
        for body, got, want in zip(bodies, port.msearch(bodies),
                                   ref.msearch(bodies)):
            assert_blockmax_results(got, want, body)
    finally:
        ref.close()
        port.close()


def test_request_cache_hits_and_slowlog():
    _, port = _pair(index="rc")
    try:
        body = {"size": 0, "query": {"match": {"body": "alpha"}},
                "aggs": {"t": {"terms": {"field": "tag"}}}}
        a = port.search(body)
        b = port.search(body)
        assert a["aggregations"] == b["aggregations"]
        assert port.request_cache_stats == {"hits": 1, "misses": 1}
        port.index_doc("x", {"body": "alpha", "tag": "red", "n": 1})
        port.refresh()
        port.search(body)
        assert port.request_cache_stats["misses"] == 2
        assert port.stats()["request_cache"]["hits"] == 1
    finally:
        port.close()


def test_scroll_and_pit_on_the_port():
    svc = IndicesService(device="cpu")
    try:
        svc.create_index("s", Settings({}), MAPPINGS)
        idx = svc.get("s")
        _fill(idx, _docs(60))
        body = {"query": {"match": {"body": "alpha"}}, "size": 7}
        first = svc.scroll_start("s", body, 60.0)
        seen = [h["_id"] for h in first["hits"]["hits"]]
        while True:
            nxt = svc.scroll_continue(first["_scroll_id"])
            if not nxt["hits"]["hits"]:
                break
            seen += [h["_id"] for h in nxt["hits"]["hits"]]
        full = idx._search_dense({**body, "size": 100})
        assert seen == [h["_id"] for h in full["hits"]["hits"]]
        pit = svc.open_pit("s", 30.0)
        assert svc.close_pit(pit)
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# kNN through _knn_batch (ES_TPU_FORCE_KNN=1)
# ---------------------------------------------------------------------------


def test_knn_batch_matches_reference(monkeypatch):
    monkeypatch.setenv("ES_TPU_FORCE_KNN", "1")
    dims = 16
    mappings = {"properties": {
        "vec": {"type": "dense_vector", "dims": dims,
                "similarity": "cosine"},
        "tag": {"type": "keyword"}}}
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((240, dims)).astype(np.float32)
    docs = [(str(i), {"vec": vecs[i].tolist(), "tag": TAGS[i % 4]})
            for i in range(240)]
    ref, port = _pair(index="kv", mappings=mappings, docs=docs,
                      refresh_at=119, deletes=range(0, 40, 11))
    try:
        qs = rng.standard_normal((5, dims)).astype(np.float32)
        bodies = [{"knn": {"field": "vec", "query_vector": q.tolist(),
                           "k": 8}} for q in qs]
        bodies.append({"knn": {"field": "vec", "query_vector":
                               qs[0].tolist(), "k": 5,
                               "filter": {"term": {"tag": "red"}}}})
        got = port.serving.try_msearch(bodies, "query_then_fetch")
        want = ref.serving.try_msearch(bodies, "query_then_fetch")
        eng = port.serving.snapshot().knn_engine("vec")
        assert eng is not None and eng.S == 2
        for body, g, w in zip(bodies, got, want):
            assert g is not None and w is not None
            gh, wh = g["hits"]["hits"], w["hits"]["hits"]
            assert [h["_id"] for h in gh] == [h["_id"] for h in wh]
            gs = np.array([h["_score"] for h in gh], np.float32)
            ws = np.array([h["_score"] for h in wh], np.float32)
            assert (np.abs(gs - ws) <= 2 * np.spacing(np.abs(ws))).all()
            assert g["hits"]["total"] == w["hits"]["total"]
            assert_same_results(g, port._search_dense(body), body)
    finally:
        ref.close()
        port.close()


def test_knn_engine_gated_off_the_card_without_the_knob(monkeypatch):
    monkeypatch.delenv("ES_TPU_FORCE_KNN", raising=False)
    mappings = {"properties": {"vec": {"type": "dense_vector", "dims": 4,
                                       "similarity": "cosine"}}}
    docs = [(str(i), {"vec": [1.0, float(i), 0.5, -1.0]}) for i in range(20)]
    _, port = _pair(index="kg", mappings=mappings, docs=docs,
                    refresh_at=-1, deletes=())
    try:
        assert port.serving.snapshot().knn_engine("vec") is None
        body = {"knn": {"field": "vec", "query_vector": [1, 2, 3, 4],
                        "k": 3}}
        assert port.serving.try_search(body, "query_then_fetch") is None
        assert len(port.search(body)["hits"]["hits"]) == 3
    finally:
        port.close()


def test_index_service_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    meta = IndexMetadata(index="d", uuid="u_d", settings=Settings({}),
                         mappings=MAPPINGS)
    with pytest.raises(DeviceUnavailableError):
        IndexService(meta)
    with pytest.raises(DeviceUnavailableError):
        IndicesService()
    svc = IndexService(meta, device="cpu")
    assert svc.device.type == "cpu"
    assert all(s.device.type == "cpu" for s in svc.shards)
    svc.index_doc("1", {"body": "alpha", "tag": "red", "n": 1})
    svc.refresh()
    assert svc.serving.snapshot().device.type == "cpu"
    svc.close()


def test_kernel_errors_are_not_served_around(turbo_pair, monkeypatch):
    """A kernel that cannot launch is a fault of the port: the error
    reaches the caller of IndexService.search, and the dense executor does
    not answer in its place (the reference declines on any error)."""
    from elasticsearch_tpu_torch.common.errors import KernelLaunchError

    _, port = turbo_pair
    eng = port.serving.snapshot().engine("body")

    def no_launch(*a, **kw):
        raise KernelLaunchError("sweep_rowmax launch failed: cudaError 1")

    monkeypatch.setattr(eng, "search_many", no_launch)
    monkeypatch.setattr(eng, "search_bool", no_launch)
    dense = []
    monkeypatch.setattr(port, "_search_dense",
                        lambda *a, **kw: dense.append(a))
    for body in ({"query": {"match": {"body": "alpha beta"}}},
                 {"query": {"bool": {"must": [{"term": {"body": "beta"}}]}}}):
        with pytest.raises(KernelLaunchError):
            port.search(body)
    assert not dense
