"""Port serving path vs the reference, on the CPU.

`extract_plan` must flatten every body to the same FlatPlan in both
packages, and `select_bm25_engine(...).search_many` must return the
reference's (scores, partition, ord) bit for bit with ES_TPU_FORCE_TURBO=1
(the reference's own switch for serving Turbo off its device; the port
honours it for device="cpu").
"""

import dataclasses

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.segment import build_field_postings
from elasticsearch_tpu.mapper.mapper_service import MapperService as RefMapper
from elasticsearch_tpu.search import serving as ref_serving
from elasticsearch_tpu_torch.common.errors import DeviceUnavailableError
from elasticsearch_tpu_torch.index.segment import (
    POSTINGS_ARRAYS, postings_from_arrays,
)
from elasticsearch_tpu_torch.mapper import MapperService
from elasticsearch_tpu_torch.search import serving

torch.set_num_threads(1)

MAPPINGS = {"properties": {"body": {"type": "text"},
                           "tag": {"type": "keyword"}}}
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lam", "mu", "nu", "xi", "omicron", "pi"]

BODIES = [
    {"query": {"match": {"body": "alpha beta"}}},
    {"query": {"match": {"body": "Gamma, DELTA!"}}, "size": 25},
    {"query": {"term": {"body": {"value": "delta", "boost": 2.0}}}},
    {"query": {"match": {"body": {"query": "alpha beta gamma",
                                  "operator": "and"}}}},
    {"query": {"bool": {"should": [{"match": {"body": "omicron"}},
                                   {"term": {"body": "pi"}}]}}},
    {"query": {"bool": {"should": [{"match": {"body": "kappa mu"}}]}}},
    {"query": {"bool": {
        "must": [{"term": {"body": "beta"}}],
        "should": [{"term": {"body": "gamma"}}],
        "must_not": [{"term": {"tag": "blue"}}]}}},
    {"query": {"match_phrase": {"body": "alpha beta"}}},
    {"query": {"match": {"body": "theta iota"}}, "from": 5, "size": 10},
    {"query": {"match": {"tag": "red"}}},                    # keyword: none
    {"query": {"match_all": {}}},                            # none
    {"query": {"match": {"body": "xi"}}, "aggs": {}},        # key: none
    {"query": {"match": {"body": {"query": "nu", "fuzziness": 1}}}},
]


def _plan_dict(plan):
    return None if plan is None else dataclasses.asdict(plan)


@pytest.mark.parametrize("body", BODIES, ids=range(len(BODIES)))
def test_extract_plan_same(body):
    want = ref_serving.extract_plan(body, RefMapper(MAPPINGS))
    got = serving.extract_plan(body, MapperService(MAPPINGS))
    assert _plan_dict(got) == _plan_dict(want)


class _Seg:
    def __init__(self, n_docs, fp):
        self.n_docs = n_docs
        self.postings = {"body": fp}


@pytest.fixture(scope="module")
def index():
    """Two partitions of a small text corpus, built by the reference and
    carried across to the port."""
    rng = np.random.default_rng(31)
    ref_segs, port_segs, lives = [], [], []
    for n in (700, 500):
        lens = rng.integers(3, 20, size=n).astype(np.int64)
        toks = rng.integers(0, len(WORDS), size=int(lens.sum()))
        docs = np.repeat(np.arange(n, dtype=np.int64), lens)
        fp = build_field_postings("body", lens, docs, toks, list(WORDS))
        ref_segs.append(_Seg(n, fp))
        port_segs.append(_Seg(n, postings_from_arrays(
            {a: getattr(fp, a) for a in POSTINGS_ARRAYS}, fp.terms,
            fp.sum_doc_len)))
        lives.append(rng.random(n) > 0.1)
    return ref_segs, port_segs, lives


def test_select_bm25_engine_bitwise(index, monkeypatch):
    monkeypatch.setenv("ES_TPU_FORCE_TURBO", "1")
    ref_segs, port_segs, lives = index
    ref = ref_serving.select_bm25_engine(ref_segs, "body", lives, None,
                                         cold_df=300)
    port = serving.select_bm25_engine(port_segs, "body", lives,
                                      device="cpu", cold_df=300)
    assert ref.kind == port.kind == "turbo"
    bodies = [b for b in BODIES if b["query"].get("match", {}).get("body")
              or "term" in b["query"] or "bool" in b["query"]]
    ref_m, port_m = RefMapper(MAPPINGS), MapperService(MAPPINGS)
    batch_ref, batch_port = [], []
    for b in bodies:
        pr = ref_serving.extract_plan(b, ref_m)
        pp = serving.extract_plan(b, port_m)
        if pr is not None and pr.is_disjunctive:
            batch_ref.append(pr.disj)
            batch_port.append(pp.disj)
    assert batch_port == batch_ref and len(batch_port) >= 5
    rng = np.random.default_rng(5)
    pairs = [[WORDS[a], WORDS[b]] for a, b in
             rng.integers(0, len(WORDS), size=(12, 2))]
    want = ref.search_many([batch_ref, pairs], k=10)
    got = port.search_many([batch_port, pairs], k=10)
    for gb, wb in zip(got, want):
        for g, w, name in zip(gb, wb, ("scores", "partitions", "ords")):
            assert np.array_equal(g, w), name
    assert port.stats["fallbacks"] == ref.stats["fallbacks"]


def test_cpu_needs_force_turbo(index, monkeypatch):
    """Without ES_TPU_FORCE_TURBO the reference leaves the CPU to BlockMax;
    the port, which has no BlockMax yet, says so instead of falling back."""
    monkeypatch.delenv("ES_TPU_FORCE_TURBO", raising=False)
    _, port_segs, _ = index
    assert not serving.turbo_eligible(port_segs, "body", device="cpu")
    with pytest.raises(NotImplementedError, match="BlockMax"):
        serving.select_bm25_engine(port_segs, "body", device="cpu")


def test_default_device_is_cuda(index, monkeypatch):
    """An entry point called without device= runs on the card; on a host
    without one it raises rather than picking the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.setenv("ES_TPU_FORCE_TURBO", "1")
    _, port_segs, _ = index
    with pytest.raises(DeviceUnavailableError):
        serving.select_bm25_engine(port_segs, "body")


# ---------------------------------------------------------------------------
# the scheduler's hooks on the engines
# ---------------------------------------------------------------------------


def test_extend_qc_sizes_gives_the_reference_ladder(index, monkeypatch):
    """The scheduler's bucket ladder lands in both engines' dispatch
    widths, ROWS_PER_STEP-rounded, and TurboEngine primes the agg engine of
    its own device."""
    from elasticsearch_tpu.search import agg_device as ref_agg
    from elasticsearch_tpu_torch.search import agg_device

    monkeypatch.setenv("ES_TPU_FORCE_TURBO", "1")
    monkeypatch.setattr(agg_device, "_ENGINES", {})
    ref_segs, port_segs, lives = index
    ref = ref_serving.select_bm25_engine(ref_segs, "body", lives, None,
                                         cold_df=300)
    port = serving.select_bm25_engine(port_segs, "body", lives,
                                      device="cpu", cold_df=300)
    assert port.qc_sizes == ref.qc_sizes
    for ladder in ((1, 4, 16, 64, 256), (3, 12), (512,)):
        ref.extend_qc_sizes(ladder)
        port.extend_qc_sizes(ladder)
        assert port.qc_sizes == ref.qc_sizes
        assert all(t.qc_sizes == port.qc_sizes for t in port.turbos)
    assert port.qc_sizes == (8, 16, 64, 256, 512)
    assert agg_device.default_engine("cpu").qc_sizes == \
        ref_agg.default_engine().qc_sizes == (1, 3, 4, 12, 16, 64, 256, 512)
    # a batch of 9 now launches at width 16 on both
    q9 = [[WORDS[i], WORDS[i + 1]] for i in range(9)]
    for g, w in zip(port.search_many([q9], k=10)[0],
                    ref.search_many([q9], k=10)[0]):
        assert np.array_equal(g, w)


class _Cancelled(Exception):
    pass


def _cancel_after(n):
    """A check callable that raises on its (n+1)-th call."""
    calls = {"n": 0}

    def check():
        calls["n"] += 1
        if calls["n"] > n:
            raise _Cancelled()
    return check, calls


@pytest.mark.parametrize("entry", ["search_many", "search_bool",
                                   "search_many_host", "search_bool_host"])
def test_check_cancels_as_the_reference(index, monkeypatch, entry):
    """The check callables of TurboEngine and its host tiers are called at
    the reference's points: the same count before a completed call, and a
    raising check cancels both at the same call. ES_TPU_TURBO_MESH=0 gives
    the reference the port's sequential partition route."""
    monkeypatch.setenv("ES_TPU_FORCE_TURBO", "1")
    monkeypatch.setenv("ES_TPU_TURBO_MESH", "0")
    ref_segs, port_segs, lives = index
    ref = ref_serving.select_bm25_engine(ref_segs, "body", lives, None,
                                         cold_df=300)
    port = serving.select_bm25_engine(port_segs, "body", lives,
                                      device="cpu", cold_df=300)
    qs = [[WORDS[i], WORDS[(i * 3) % len(WORDS)]] for i in range(10)]
    specs = [{"must": [(WORDS[i], 1.0)], "should": [(WORDS[i + 1], 1.0)]}
             for i in range(10)]

    def run(eng, check):
        if entry == "search_many":
            return eng.search_many([qs], k=10, check=check)
        if entry == "search_bool":
            return eng.search_bool(specs, k=10, check=check)
        if entry == "search_many_host":
            return [t.search_many_host([qs], k=10, check=check)
                    for t in eng.turbos]
        return [t.search_bool_host(specs, k=10, check=check)
                for t in eng.turbos]

    rc, r_calls = _cancel_after(10 ** 6)
    pc, p_calls = _cancel_after(10 ** 6)
    run(ref, rc)
    run(port, pc)
    assert p_calls["n"] == r_calls["n"] > 0
    for stop in (0, r_calls["n"] - 1):
        rc, r_calls = _cancel_after(stop)
        pc, p_calls = _cancel_after(stop)
        with pytest.raises(_Cancelled):
            run(ref, rc)
        with pytest.raises(_Cancelled):
            run(port, pc)
        assert p_calls["n"] == r_calls["n"] == stop + 1


@pytest.mark.parametrize("entry", ["search_many", "search_bool"])
def test_host_rescore_runs_outside_the_engine_lock(index, monkeypatch,
                                                   entry):
    """TurboBM25 holds its lock over the device passes only: while a
    query's exact rescore and certificate run, another thread can take the
    lock (a second lane's sweep), and the rows stay the reference's.
    ES_TPU_BITSET_HOST_DF=0 keeps the bool queries on the device route."""
    import threading

    monkeypatch.setenv("ES_TPU_FORCE_TURBO", "1")
    monkeypatch.setenv("ES_TPU_TURBO_MESH", "0")
    monkeypatch.setenv("ES_TPU_BITSET_HOST_DF", "0")
    ref_segs, port_segs, lives = index
    ref = ref_serving.select_bm25_engine(ref_segs, "body", lives, None,
                                         cold_df=8)
    port = serving.select_bm25_engine(port_segs, "body", lives,
                                      device="cpu", cold_df=8)
    qs = [[WORDS[i], WORDS[(i * 3) % len(WORDS)]] for i in range(10)]
    specs = [{"must": [(WORDS[i], 1.0)], "should": [(WORDS[i + 1], 1.0)]}
             for i in range(10)]
    free = []
    name = "_finish_query" if entry == "search_many" else "_finish_bool"
    for t in port.turbos:
        finish = getattr(t, name)

        def spy(*a, _t=t, _finish=finish):
            got = []

            def other():
                ok = _t._serve_lock.acquire(timeout=5)
                got.append(ok)
                if ok:
                    _t._serve_lock.release()

            th = threading.Thread(target=other)
            th.start()
            th.join()
            free.append(got == [True])
            return _finish(*a)

        monkeypatch.setattr(t, name, spy)
    if entry == "search_many":
        got, want = (e.search_many([qs], k=10)[0] for e in (port, ref))
    else:
        got, want = (e.search_bool(specs, k=10) for e in (port, ref))
    assert free and all(free)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_agg_collects_ride_bulk_tier(monkeypatch):
    """Agg dispatches are bulk-tier scheduler work: the bulk counter moves,
    the interactive counter does not (tests/test_agg_device.py's case on
    the port's IndexService on the CPU)."""
    import elasticsearch_tpu_torch.search.aggregations as agg_mod
    from elasticsearch_tpu_torch.cluster.state import IndexMetadata
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.index_service import IndexService
    from elasticsearch_tpu_torch.search import agg_device
    from elasticsearch_tpu_torch.threadpool.scheduler import scheduler_stats

    monkeypatch.setattr(agg_device, "_ENGINES", {})
    meta = IndexMetadata(index="agg", uuid="u", settings=Settings({}),
                         mappings={"properties": {"tag": {"type": "keyword"}}})
    svc = IndexService(meta, device="cpu")
    rng = np.random.default_rng(17)
    for i in range(1200):
        svc.index_doc(str(i), {"tag": [f"t{rng.integers(0, 40)}"]})
    svc.refresh()
    body = {"size": 0, "aggs": {"tags": {"terms": {"field": "tag"}}}}
    monkeypatch.setattr(agg_mod, "AGG_DEVICE_MIN_DOCS", 1)

    def tiers():
        t = scheduler_stats().get("tiers", {})
        return (t.get("bulk", {}).get("dispatches", 0),
                t.get("interactive", {}).get("dispatches", 0))

    svc._search_dense(body)                  # warm: layout build
    a0 = agg_device.agg_stats()
    b0, i0 = tiers()
    svc._search_dense(body)
    b1, i1 = tiers()
    a1 = agg_device.agg_stats()
    assert b1 > b0
    assert i1 == i0
    assert a1["agg_device_dispatches"] > a0["agg_device_dispatches"]
    assert a1["agg_host_fallbacks"] == a0["agg_host_fallbacks"]
    svc.close()


def test_concurrent_agg_collects_share_one_launch(monkeypatch):
    """Concurrent collects on one layout merge in the bulk tier's lane into
    one dispatch of several queries, each result equal to its solo one."""
    import threading

    import elasticsearch_tpu_torch.search.aggregations as agg_mod
    from elasticsearch_tpu_torch.cluster.state import IndexMetadata
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.index_service import IndexService
    from elasticsearch_tpu_torch.search import agg_device

    monkeypatch.setattr(agg_device, "_ENGINES", {})
    monkeypatch.setattr(agg_mod, "AGG_DEVICE_MIN_DOCS", 1)
    monkeypatch.setenv("ES_TPU_SCHED_BULK_US", "300000")
    # the default ladder, pinned: earlier flushes in this process would
    # otherwise autotune it (a ladder of (1,) flushes every query alone)
    monkeypatch.setenv("ES_TPU_SCHED_BUCKETS", "1,4,16,64,256")
    meta = IndexMetadata(index="agg2", uuid="u2", settings=Settings({}),
                         mappings={"properties": {
                             "tag": {"type": "keyword"},
                             "n": {"type": "integer"}}})
    svc = IndexService(meta, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(900):
        svc.index_doc(str(i), {"tag": f"t{rng.integers(0, 30)}",
                               "n": int(rng.integers(0, 100))})
    svc.refresh()
    bodies = [{"size": 0, "query": {"range": {"n": {"gte": lo}}},
               "aggs": {"tags": {"terms": {"field": "tag"}}}}
              for lo in range(0, 80, 10)]
    want = [svc._search_dense(b)["aggregations"] for b in bodies]
    sizes = []
    orig = agg_device.AggDeviceEngine._dispatch_group

    def spy(self, group):
        sizes.append(len(group))
        return orig(self, group)

    monkeypatch.setattr(agg_device.AggDeviceEngine, "_dispatch_group", spy)
    got = [None] * len(bodies)
    barrier = threading.Barrier(len(bodies))

    def run(i):
        barrier.wait(timeout=10)
        got[i] = svc._search_dense(bodies[i])["aggregations"]

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert got == want
    assert sum(sizes) == len(bodies) and max(sizes) > 1
    svc.close()
