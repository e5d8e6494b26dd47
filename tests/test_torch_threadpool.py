"""The port's thread pools, dispatch coalescer and adaptive scheduler,
held to the reference's expectations (tests/test_threadpool.py and
tests/test_scheduler.py) on the CPU.

The pool, tier, flush, poison-retry, legacy-mode and window-zero cases
run the same stub engines through both packages (`pkg` is "ref" or
"port") with the same expectations. The cases on a real engine run the
port's Turbo engine on the CPU (`device="cpu"`, `ES_TPU_FORCE_TURBO=1`,
the kernels' plain versions): scheduled and coalesced rows are bitwise
equal to solo rows, and to the reference engine's solo rows on the same
documents; so are the reference's `blockmax` variants (no knobs on the
CPU: BlockMax), whose port rows are also held to the reference BlockMax
engine's solo rows under tests/test_blockmax.py's rule (rtol and atol
2e-5, near-ties as sets: the two sum a doc's terms in different orders).
`test_http_server_sheds_load_with_429` waits for the REST node (item 9c).
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import elasticsearch_tpu.common.errors as ref_errors
import elasticsearch_tpu.common.metrics as ref_metrics
import elasticsearch_tpu.threadpool as ref_threadpool
import elasticsearch_tpu.threadpool.coalescer as ref_coalescer
import elasticsearch_tpu.threadpool.scheduler as ref_scheduler
import elasticsearch_tpu_torch.common.errors as port_errors
import elasticsearch_tpu_torch.common.metrics as port_metrics
import elasticsearch_tpu_torch.threadpool as port_threadpool
import elasticsearch_tpu_torch.threadpool.coalescer as port_coalescer
import elasticsearch_tpu_torch.threadpool.scheduler as port_scheduler
from elasticsearch_tpu_torch.common import faults as port_faults

torch.set_num_threads(1)

PKGS = {
    "ref": types.SimpleNamespace(tp=ref_threadpool, sched=ref_scheduler,
                                 co=ref_coalescer, errors=ref_errors,
                                 metrics=ref_metrics),
    "port": types.SimpleNamespace(tp=port_threadpool, sched=port_scheduler,
                                  co=port_coalescer, errors=port_errors,
                                  metrics=port_metrics),
}

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lam", "mu", "nu", "xi", "omicron", "pi"]

QUERIES = [["alpha"], ["beta", "gamma"], ["delta"], ["pi", "omicron"],
           ["mu", "nu", "xi"], ["kappa"], ["theta", "iota"], ["zeta", "eta"]]


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


def tiny_pool(pkg, **overrides):
    sizes = {"search": 1, "write": 1, "get": 1, "management": 1,
             "snapshot": 1}
    queues = {"search": 1, "write": 1, "get": 1, "management": 1,
              "snapshot": 1}
    sizes.update(overrides.get("sizes", {}))
    queues.update(overrides.get("queues", {}))
    return pkg.tp.ThreadPool(sizes=sizes, queue_sizes=queues)


def _fill(svc, rng_seed=99, n=320, refresh_at=140, delete_step=9):
    rng = np.random.default_rng(rng_seed)
    for i in range(n):
        words = rng.choice(WORDS, size=int(rng.integers(3, 16)))
        svc.index_doc(str(i), {"body": " ".join(words)})
        if i == refresh_at:
            svc.refresh()
    for i in range(0, 50, delete_step):
        svc.delete_doc(str(i))
    svc.refresh()
    return svc


def _build_index(monkeypatch, uuid: str, ref: bool = False,
                 turbo: bool = True):
    """The reference tests' two-segment index with deletions, on the
    port's IndexService on the CPU (or the reference's), Turbo forced
    (or, turbo=False, no knobs: BlockMax)."""
    if turbo:
        monkeypatch.setenv("ES_TPU_FORCE_TURBO", "1")
        monkeypatch.setenv("ES_TPU_TURBO_COLD_DF", "8")
    else:
        monkeypatch.delenv("ES_TPU_FORCE_TURBO", raising=False)
        monkeypatch.delenv("ES_TPU_TURBO_COLD_DF", raising=False)
    if ref:
        from elasticsearch_tpu.cluster.state import IndexMetadata
        from elasticsearch_tpu.common.settings import Settings
        from elasticsearch_tpu.index.index_service import IndexService
        kw = {}
    else:
        from elasticsearch_tpu_torch.cluster.state import IndexMetadata
        from elasticsearch_tpu_torch.common.settings import Settings
        from elasticsearch_tpu_torch.index.index_service import IndexService
        kw = {"device": "cpu"}
    meta = IndexMetadata(
        index="tp_" + uuid, uuid=uuid, settings=Settings({}),
        mappings={"properties": {"body": {"type": "text"}}})
    return _fill(IndexService(meta, **kw))


def _assert_rows_equal(got, want, ctx):
    gs, gp, go = got
    ws, wp, wo = want
    assert np.array_equal(gs, ws), ctx
    assert np.array_equal(gp, wp), ctx
    assert np.array_equal(go, wo), ctx


def _assert_rows_close(got, want, ctx):
    """tests/test_blockmax.py's rule on one (scores, parts, ords) row set;
    -inf (the reference's empty slot) compares as the port's 0."""
    ws = np.where(np.isfinite(want[0]), want[0], 0)
    np.testing.assert_allclose(got[0], ws, rtol=2e-5, atol=2e-5)
    for q in range(ws.shape[0]):
        v = ws[q] > 0
        g = list(zip(got[1][q][v], got[2][q][v]))
        w = list(zip(want[1][q][v], want[2][q][v]))
        gaps = np.abs(np.diff(ws[q][v])) > 2e-5 * ws[q][v][:-1] + 2e-5
        assert (g == w) if gaps.all() else (set(g) == set(w)), ctx


def _concurrent(fn, queries):
    """fn(i, q) for each query on its own thread, all released together;
    returns (results, errors) aligned with `queries`."""
    results = [None] * len(queries)
    errors = [None] * len(queries)
    barrier = threading.Barrier(len(queries))

    def worker(i, q):
        try:
            barrier.wait(timeout=10)
            results[i] = fn(i, q)
        except BaseException as e:  # noqa: BLE001 — asserted by callers
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i, q))
               for i, q in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results, errors


def _concurrent_sched(sched, eng, queries, k=10, tiers=None, fault_logs=None):
    return _concurrent(lambda i, q: sched.dispatch(
        eng, [q], k, tier=tiers[i] if tiers else None,
        fault_log=fault_logs[i] if fault_logs else None), queries)


def _stub_engine(pkg, fail_merged=False, poison=None):
    """The reference suite's search_many stub: deterministic per-query
    rows; optionally raises on merged batches or a poisoned query term."""
    fault = pkg.errors.DeviceFaultError

    class _StubEngine:
        def __init__(self):
            self.calls = []

        def search_many(self, batches, k=10, check=None):
            qs = batches[0]
            self.calls.append(len(qs))
            if fail_merged and len(qs) > 1:
                raise fault("poisoned merged batch", site="turbo_sweep")
            out_s = np.zeros((len(qs), k), np.float32)
            out_p = np.zeros((len(qs), k), np.int32)
            out_o = np.zeros((len(qs), k), np.int32)
            for i, q in enumerate(qs):
                if poison is not None and poison in q:
                    raise fault(f"query {q} is poison", site="turbo_sweep")
                out_s[i, 0] = float(len(q[0])) + 1.0
                out_o[i, 0] = len(q[0])
            return [(out_s, out_p, out_o)]

    return _StubEngine()


# ---------------------------------------------------------------------------
# named pools (tests/test_threadpool.py)
# ---------------------------------------------------------------------------


def test_submit_executes_and_counts(pkg):
    pool = pkg.tp.ThreadPool(sizes={"search": 2})
    try:
        tasks = [pool.submit("search", lambda x: x * 2, i) for i in range(8)]
        assert [t.get(timeout=10) for t in tasks] == [i * 2 for i in range(8)]
        if pkg is PKGS["ref"]:
            # the reference wakes a waiter before it counts the task
            # (ROADMAP W5); the port counts first
            deadline = time.monotonic() + 5
            while pool.stats()["search"]["completed"] < 8 \
                    and time.monotonic() < deadline:
                time.sleep(0.001)
        st = pool.stats()["search"]
        assert st["completed"] == 8
        assert st["queue"] == 0 and st["active"] == 0
        assert 1 <= st["largest"] <= 2
        assert st["ewma_ms"] >= 0.0
    finally:
        pool.shutdown()


def test_saturated_pool_rejects_with_429_and_pool_name(pkg):
    pool = tiny_pool(pkg)
    release = threading.Event()
    try:
        running = pool.submit("search", release.wait, 10)
        time.sleep(0.05)
        queued = pool.submit("search", lambda: "queued")
        with pytest.raises(pkg.tp.EsRejectedExecutionError) as ei:
            pool.submit("search", lambda: "rejected")
        assert ei.value.status == 429
        assert ei.value.error_type == "es_rejected_execution_exception"
        assert "search" in str(ei.value)
        assert pool.stats()["search"]["rejected"] == 1
        assert ei.value.to_dict()["type"] == "es_rejected_execution_exception"
        release.set()
        assert queued.get(timeout=10) == "queued"
        assert running.get(timeout=10) is True
    finally:
        release.set()
        pool.shutdown()


def test_write_saturation_does_not_reject_searches(pkg):
    pool = tiny_pool(pkg)
    release = threading.Event()
    try:
        pool.submit("write", release.wait, 10)
        time.sleep(0.05)
        pool.submit("write", lambda: None)
        with pytest.raises(pkg.tp.EsRejectedExecutionError):
            pool.submit("write", lambda: None)
        assert pool.submit("search", lambda: "ok").get(timeout=10) == "ok"
        assert pool.stats()["search"]["rejected"] == 0
        assert pool.stats()["write"]["rejected"] == 1
    finally:
        release.set()
        pool.shutdown()


def test_execute_reenters_inline_from_own_worker(pkg):
    pool = tiny_pool(pkg)
    try:
        def nested():
            return pool.execute("search", lambda: "inner")

        assert pool.execute("search", nested) == "inner"
    finally:
        pool.shutdown()


def test_task_errors_propagate_to_waiter(pkg):
    pool = pkg.tp.ThreadPool(sizes={"management": 1})
    try:
        def boom():
            raise ValueError("broken task")

        with pytest.raises(ValueError, match="broken task"):
            pool.execute("management", boom)
        if pkg is PKGS["ref"]:
            # counted after the waiter wakes in the reference (W5)
            deadline = time.monotonic() + 5
            while pool.stats()["management"]["completed"] < 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.001)
        assert pool.stats()["management"]["completed"] == 1
    finally:
        pool.shutdown()


def test_pool_for_request_classification(pkg):
    pool_for_request = pkg.tp.pool_for_request
    assert pool_for_request("POST", "/idx/_search") == "search"
    assert pool_for_request("GET", "/_msearch") == "search"
    assert pool_for_request("POST", "/idx/_bulk") == "write"
    assert pool_for_request("POST", "/_reindex") == "write"
    assert pool_for_request("GET", "/idx/_doc/1") == "get"
    assert pool_for_request("PUT", "/idx/_doc/1") == "write"
    assert pool_for_request("GET", "/idx/_source/1") == "get"
    assert pool_for_request("PUT", "/_snapshot/repo/snap") == "snapshot"
    assert pool_for_request("GET", "/_cluster/health") == "management"
    assert pool_for_request("GET", "/") == "management"


# ---------------------------------------------------------------------------
# dispatch coalescer on the port's Turbo engine (tests/test_threadpool.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_solo():
    """The reference engines' solo rows for QUERIES on the same index, by
    engine kind."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for kind in ENGINES:
            svc = _build_index(mp, "ref_solo_" + kind, ref=True,
                               turbo=kind == "turbo")
            eng = svc.serving.snapshot().engine("body")
            assert eng.kind == kind
            out[kind] = [eng.search_many([[q]], k=10)[0] for q in QUERIES]
            svc.close()
    finally:
        mp.undo()
    return out


ENGINES = ("turbo", "blockmax")


def _hold_ref(got, ref, kind, ctx):
    if kind == "turbo":
        _assert_rows_equal(got, ref, ctx)
    else:
        _assert_rows_close(got, ref, ctx)


@pytest.mark.parametrize("kind", ENGINES)
def test_coalesced_rows_bit_identical_to_solo(monkeypatch, ref_solo, kind):
    svc = _build_index(monkeypatch, "u_co1" + kind, turbo=kind == "turbo")
    try:
        eng = svc.serving.snapshot().engine("body")
        assert eng.kind == kind
        solo = [eng.search_many([[q]], k=10)[0] for q in QUERIES]
        for q, got, want in zip(QUERIES, solo, ref_solo[kind]):
            _hold_ref(got, want, kind, f"port solo vs reference {q}")
        co = port_coalescer.DispatchCoalescer(window_us=500_000,
                                              max_batch=len(QUERIES))
        results, errors = _concurrent(
            lambda i, q: co.dispatch(eng, [q], 10), QUERIES)
        assert errors == [None] * len(QUERIES)
        for q, got, want in zip(QUERIES, results, solo):
            _assert_rows_equal(got, want, q)
        st = co.stats()
        assert st["coalesced_queries"] == len(QUERIES)
        assert st["coalesced_dispatches"] < len(QUERIES)
        assert st["largest_batch"] > 1
    finally:
        svc.close()


def test_coalescer_keys_by_k_and_window_zero_disables(monkeypatch):
    svc = _build_index(monkeypatch, "u_co2")
    try:
        eng = svc.serving.snapshot().engine("body")
        co = port_coalescer.DispatchCoalescer(window_us=0)
        s, p, o = co.dispatch(eng, [["alpha"]], 10)
        want = eng.search_many([[["alpha"]]], k=10)[0]
        _assert_rows_equal((s, p, o), want, "win0")
        assert co.stats()["coalesced_dispatches"] == 0
        assert co.stats()["direct_dispatches"] == 1

        # different k values never share a device dispatch
        co2 = port_coalescer.DispatchCoalescer(window_us=50_000)
        out = {}

        def run(k):
            out[k] = co2.dispatch(eng, [["beta", "gamma"]], k)

        ts = [threading.Thread(target=run, args=(k,)) for k in (5, 10)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        for k in (5, 10):
            want = eng.search_many([[["beta", "gamma"]]], k=k)[0]
            _assert_rows_equal(out[k], want, k)
            assert out[k][0].shape == (1, k)
    finally:
        svc.close()


def test_mid_window_engine_swap_keeps_batches_separate(monkeypatch):
    svc = _build_index(monkeypatch, "u_co3")
    try:
        eng1 = svc.serving.snapshot().engine("body")
        solo1 = eng1.search_many([[["alpha"]]], k=10)[0]
        co = port_coalescer.DispatchCoalescer(window_us=400_000)
        got1 = {}

        def old_engine_waiter():
            got1["rows"] = co.dispatch(eng1, [["alpha"]], 10)

        t = threading.Thread(target=old_engine_waiter)
        t.start()
        deadline = time.monotonic() + 5
        while co.stats()["coalesced_dispatches"] == 0 \
                and not co._pending and time.monotonic() < deadline:
            time.sleep(0.005)
        svc.index_doc("new", {"body": "alpha alpha alpha fresh"})
        svc.refresh()
        eng2 = svc.serving.snapshot().engine("body")
        assert eng2 is not eng1
        rows2 = co.dispatch(eng2, [["alpha"]], 10)
        t.join(timeout=60)
        _assert_rows_equal(got1["rows"], solo1, "old engine")
        _assert_rows_equal(rows2, eng2.search_many([[["alpha"]]], k=10)[0],
                           "new engine")
        assert co.stats()["coalesced_dispatches"] == 2
    finally:
        svc.close()


def _serving_bodies():
    return [{"query": {"match": {"body": " ".join(q)}}} for q in QUERIES]


def _assert_same_responses(got, want, bodies):
    for b, g, w in zip(bodies, got, want):
        assert g is not None, b
        assert [h["_id"] for h in g["hits"]["hits"]] == \
            [h["_id"] for h in w["hits"]["hits"]], b
        assert [h["_score"] for h in g["hits"]["hits"]] == \
            [h["_score"] for h in w["hits"]["hits"]], b
        assert g["hits"]["total"] == w["hits"]["total"], b


def test_serving_path_coalesces_concurrent_searches(monkeypatch):
    svc = _build_index(monkeypatch, "u_co4")
    try:
        monkeypatch.setenv("ES_TPU_SCHED_MODE", "legacy")
        bodies = _serving_bodies()
        monkeypatch.setenv("ES_TPU_COALESCE_US", "0")
        want = [svc.serving.try_search(b, "query_then_fetch")
                for b in bodies]
        assert all(w is not None for w in want)
        monkeypatch.setenv("ES_TPU_COALESCE_US", "300000")
        co = port_coalescer.default_coalescer()
        before = co.stats()["coalesced_dispatches"]
        got, errors = _concurrent(
            lambda i, b: svc.serving.try_search(b, "query_then_fetch"),
            bodies)
        assert errors == [None] * len(bodies)
        merged = co.stats()["coalesced_dispatches"] - before
        assert 1 <= merged < len(bodies)
        _assert_same_responses(got, want, bodies)
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# adaptive scheduler (tests/test_scheduler.py)
# ---------------------------------------------------------------------------


def test_parse_buckets_knob(pkg):
    parse, default = pkg.sched._parse_buckets, pkg.sched.DEFAULT_BUCKETS
    assert parse("1,4,16,64,256") == (1, 4, 16, 64, 256)
    assert parse(" 16, 4 ,4,1 ") == (1, 4, 16)
    assert parse("8") == (8,)
    assert parse("banana") == default
    assert parse("") == default
    assert parse("0,-4") == default
    assert parse("-4,0,2") == (2,)


def test_tier_for_request_classification(pkg):
    tier_for_request = pkg.tp.tier_for_request
    bulk, inter = pkg.sched.TIER_BULK, pkg.sched.TIER_INTERACTIVE
    assert tier_for_request("POST", "/idx/_search") == inter
    assert tier_for_request("GET", "/idx/_doc/1") == inter
    assert tier_for_request("GET", "/idx/_mget") == inter
    assert tier_for_request("POST", "/_msearch") == bulk
    assert tier_for_request("POST", "/_search/scroll") == bulk
    assert tier_for_request("POST", "/idx/_async_search") == bulk
    assert tier_for_request("GET", "/idx/_rank_eval") == bulk
    assert tier_for_request("POST", "/idx/_bulk") == bulk
    assert tier_for_request("GET", "/_cluster/health") == bulk
    assert tier_for_request("POST", "/idx/_search", {"sla": "bulk"}) == bulk
    assert tier_for_request("POST", "/idx/_bulk",
                            {"sla": "interactive"}) == inter
    assert tier_for_request("POST", "/idx/_search",
                            {"sla": "platinum"}) == inter


def test_tier_context_rides_pool_submissions(pkg):
    sc = pkg.sched
    assert sc.current_tier() == sc.TIER_INTERACTIVE
    with sc.activate_tier(sc.TIER_BULK):
        assert sc.current_tier() == sc.TIER_BULK
        with sc.activate_tier(None):
            assert sc.current_tier() == sc.TIER_BULK
        with sc.activate_tier(sc.TIER_INTERACTIVE):
            assert sc.current_tier() == sc.TIER_INTERACTIVE
        assert sc.current_tier() == sc.TIER_BULK
    assert sc.current_tier() == sc.TIER_INTERACTIVE
    pool = pkg.tp.ThreadPool(sizes={"search": 1})
    try:
        with sc.activate_tier(sc.TIER_BULK):
            task = pool.submit("search", sc.current_tier)
        assert task.get(timeout=10) == sc.TIER_BULK
        assert pool.submit("search", sc.current_tier).get(timeout=10) \
            == sc.TIER_INTERACTIVE
    finally:
        pool.shutdown()


def test_task_manager_reads_trace_and_tier_from_thread(pkg):
    """A task registered inside a trace and a tier carries both (the
    port's task manager used to leave them unset)."""
    if pkg is PKGS["ref"]:
        from elasticsearch_tpu.common import tracing
        from elasticsearch_tpu.tasks.task_manager import TaskManager
    else:
        from elasticsearch_tpu_torch.common import tracing
        from elasticsearch_tpu_torch.tasks.task_manager import TaskManager
    tm = TaskManager("n1")
    tc = tracing.TraceContext(trace_id="abc123")
    with tracing.activate(tc), pkg.sched.activate_tier(pkg.sched.TIER_BULK):
        task = tm.register("indices:data/read/search")
    assert task.trace_id == "abc123"
    assert task.sla == pkg.sched.TIER_BULK
    plain = tm.register("indices:data/read/search")
    assert plain.trace_id is None
    assert plain.sla == pkg.sched.TIER_INTERACTIVE


def _waiter(pkg, nq, tier, age, now):
    w = pkg.sched._Waiter([["q"]] * nq, tier)
    w.enqueued = now - age
    return w


def test_build_batch_flush_rules(pkg):
    sc = pkg.sched
    bulk, inter = sc.TIER_BULK, sc.TIER_INTERACTIVE
    sched = sc.AdaptiveDispatchScheduler(buckets=(1, 4, 16),
                                         interactive_us=1000.0,
                                         bulk_us=8000.0)
    lane = sc._Lane(object(), 10, ("e", 10), inflight=2)
    now = time.monotonic()

    lane.queue = [_waiter(pkg, 1, bulk, 0.001, now)]
    batch, depth = sched._build_batch(lane, now)
    assert batch is None and depth == 1 and len(lane.queue) == 1

    lane.queue = [_waiter(pkg, 1, bulk, 0.001, now),
                  _waiter(pkg, 1, inter, 0.002, now)]
    batch, depth = sched._build_batch(lane, now)
    assert depth == 2 and batch.bucket == 1
    assert [w.tier for w in batch.waiters] == [inter]
    assert [w.tier for w in lane.queue] == [bulk]

    lane.queue = [_waiter(pkg, 1, bulk, 0.001, now),
                  _waiter(pkg, 1, bulk, 0.0005, now),
                  _waiter(pkg, 1, bulk, 0.0001, now),
                  _waiter(pkg, 2, inter, 0.002, now)]
    batch, depth = sched._build_batch(lane, now)
    assert depth == 5 and batch.bucket == 4
    assert len(batch.queries) == 4
    assert batch.waiters[0].tier == inter
    assert len(lane.queue) == 1

    lane.queue = [_waiter(pkg, 4, bulk, 0.0001, now) for _ in range(4)]
    batch, depth = sched._build_batch(lane, now)
    assert depth == 16 and batch.bucket == 16
    assert len(batch.queries) == 16 and not lane.queue

    lane.queue = [_waiter(pkg, 4, inter, 0.01, now) for _ in range(5)]
    batch, depth = sched._build_batch(lane, now)
    assert depth == 20 and batch.bucket == 16
    assert len(batch.queries) == 16 and len(lane.queue) == 1


@pytest.mark.parametrize("kind", ENGINES)
def test_scheduled_rows_bit_identical_to_solo(monkeypatch, ref_solo, kind):
    monkeypatch.setenv("ES_TPU_COALESCE_US", "300000")
    svc = _build_index(monkeypatch, "u_sc1" + kind, turbo=kind == "turbo")
    try:
        eng = svc.serving.snapshot().engine("body")
        assert eng.kind == kind
        solo = [eng.search_many([[q]], k=10)[0] for q in QUERIES]
        sched = port_scheduler.AdaptiveDispatchScheduler(
            buckets=(len(QUERIES),), interactive_us=400000.0,
            bulk_us=400000.0)
        results, errors = _concurrent_sched(sched, eng, QUERIES)
        assert errors == [None] * len(QUERIES)
        for q, got, want, ref in zip(QUERIES, results, solo,
                                     ref_solo[kind]):
            _assert_rows_equal(got, want, f"merged {q}")
            _hold_ref(got, ref, kind, f"merged vs reference {q}")
        st = sched.stats()
        assert st["sched_dispatches"] == 1
        assert st["sched_queries"] == len(QUERIES)
        assert st["largest_batch"] == len(QUERIES)
        assert st["bucket_counts"] == {str(len(QUERIES)): 1}

        sched0 = port_scheduler.AdaptiveDispatchScheduler(
            buckets=port_scheduler.DEFAULT_BUCKETS, interactive_us=0.0,
            bulk_us=0.0)
        results0, errors0 = _concurrent_sched(sched0, eng, QUERIES)
        assert errors0 == [None] * len(QUERIES)
        for q, got, want in zip(QUERIES, results0, solo):
            _assert_rows_equal(got, want, f"split {q}")
        st0 = sched0.stats()
        assert st0["sched_queries"] == len(QUERIES)
        assert 1 <= st0["sched_dispatches"] <= len(QUERIES)
    finally:
        svc.close()


def test_scheduler_primes_engine_bucket_shapes(monkeypatch):
    monkeypatch.setenv("ES_TPU_COALESCE_US", "300000")
    svc = _build_index(monkeypatch, "u_sc_prime")
    try:
        eng = svc.serving.snapshot().engine("body")
        base = set(eng.qc_sizes)
        pad_before = port_metrics.summary("coalesce_pad_ratio")["count"]
        sched = port_scheduler.AdaptiveDispatchScheduler(
            buckets=(1, 4, 16, 64), interactive_us=0.0, bulk_us=0.0)
        got = sched.dispatch(eng, [QUERIES[0]], 10)
        assert {8, 16, 64} <= set(eng.qc_sizes)
        assert set(eng.qc_sizes) >= base
        assert list(eng.qc_sizes) == sorted(set(eng.qc_sizes))
        assert port_metrics.summary("coalesce_pad_ratio")["count"] \
            > pad_before
        _assert_rows_equal(got, eng.search_many([[QUERIES[0]]], k=10)[0],
                           "primed")
    finally:
        svc.close()


def test_interactive_budget_flushes_past_parked_bulk(pkg):
    sc = pkg.sched
    eng = _stub_engine(pkg)
    sched = sc.AdaptiveDispatchScheduler(buckets=(4,), interactive_us=8000.0,
                                         bulk_us=10_000_000.0, inflight=2)
    results = [None] * 4
    done = [threading.Event() for _ in range(4)]

    def run(i, tier):
        results[i] = sched.dispatch(eng, [[f"q{i}"]], 10, tier=tier)
        done[i].set()

    threads = [threading.Thread(target=run, args=(i, sc.TIER_BULK))
               for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    assert eng.calls == []
    t0 = time.monotonic()
    run(3, sc.TIER_INTERACTIVE)
    assert time.monotonic() - t0 < 2.0
    for i in range(3):
        assert done[i].wait(5), f"bulk waiter {i} still parked"
    assert eng.calls == [4]
    for i in range(4):
        assert float(results[i][0][0, 0]) == len(f"q{i}") + 1.0
    st = sched.stats()
    assert st["tiers"][sc.TIER_INTERACTIVE]["dispatches"] == 1
    assert st["tiers"][sc.TIER_BULK]["dispatches"] == 3
    assert st["bucket_counts"] == {"4": 1}


def _blocked_waiter(sched, eng):
    """Dispatch one query whose boundary check parks (the second check
    call), so the waiter holds its batch's in-flight slot until released."""
    parked = threading.Event()
    release = threading.Event()
    box = {}
    calls = {"n": 0}

    def check():
        calls["n"] += 1
        if calls["n"] == 2:
            parked.set()
            assert release.wait(20)

    def run():
        box["rows"] = sched.dispatch(eng, [["aa"]], 10, check=check)

    t = threading.Thread(target=run)
    t.start()
    return t, parked, release, box


def test_double_buffer_dispatches_while_demux_in_flight(pkg):
    eng = _stub_engine(pkg)
    sched = pkg.sched.AdaptiveDispatchScheduler(
        buckets=(1,), interactive_us=0.0, bulk_us=0.0, inflight=2)
    t_a, parked, release, box = _blocked_waiter(sched, eng)
    assert parked.wait(10)
    assert sched.stats()["inflight"] == 1
    rows_b = sched.dispatch(eng, [["bbb"]], 10)
    assert float(rows_b[0][0, 0]) == 4.0
    assert t_a.is_alive()
    assert sched.stats()["max_inflight"] == 2
    release.set()
    t_a.join(timeout=10)
    assert not t_a.is_alive()
    assert float(box["rows"][0][0, 0]) == 3.0
    assert sched.stats()["inflight"] == 0


def test_single_slot_serializes_behind_unconsumed_batch(pkg):
    eng = _stub_engine(pkg)
    sched = pkg.sched.AdaptiveDispatchScheduler(
        buckets=(1,), interactive_us=0.0, bulk_us=0.0, inflight=1)
    t_a, parked, release, box = _blocked_waiter(sched, eng)
    assert parked.wait(10)
    done_b = threading.Event()
    rows = {}

    def run_b():
        rows["b"] = sched.dispatch(eng, [["bbb"]], 10)
        done_b.set()

    t_b = threading.Thread(target=run_b)
    t_b.start()
    assert not done_b.wait(0.4)
    assert eng.calls == [1]
    release.set()
    assert done_b.wait(10)
    t_a.join(timeout=10)
    t_b.join(timeout=10)
    assert eng.calls == [1, 1]
    assert float(rows["b"][0][0, 0]) == 4.0
    assert sched.stats()["max_inflight"] == 1


def test_poison_batch_retries_each_waiter_solo(pkg):
    eng = _stub_engine(pkg, fail_merged=True)
    sched = pkg.sched.AdaptiveDispatchScheduler(
        buckets=(3,), interactive_us=400000.0, bulk_us=400000.0)
    queries = [["a"], ["bb"], ["ccc"]]
    results, errors = _concurrent_sched(sched, eng, queries)
    assert errors == [None, None, None]
    for q, r in zip(queries, results):
        assert float(r[0][0, 0]) == len(q[0]) + 1.0, q
    assert sched.stats()["sched_batch_retries"] == 1
    assert sorted(eng.calls) == [1, 1, 1, 3]


def test_poison_query_error_isolated_to_its_waiter(pkg):
    eng = _stub_engine(pkg, poison="bad")
    sched = pkg.sched.AdaptiveDispatchScheduler(
        buckets=(3,), interactive_us=400000.0, bulk_us=400000.0)
    queries = [["good"], ["bad"], ["fine"]]
    results, errors = _concurrent_sched(sched, eng, queries)
    bad_i = queries.index(["bad"])
    for i, (r, e) in enumerate(zip(results, errors)):
        if i == bad_i:
            assert isinstance(e, pkg.errors.DeviceFaultError) and r is None
        else:
            assert e is None
            assert float(r[0][0, 0]) == len(queries[i][0]) + 1.0
    assert sched.stats()["sched_batch_retries"] == 1


def test_all_retries_failing_surfaces_original_error(pkg):
    fault = pkg.errors.DeviceFaultError

    class _Dead:
        def search_many(self, batches, k=10, check=None):
            raise fault("engine is gone", site="turbo_sweep")

    sched = pkg.sched.AdaptiveDispatchScheduler(
        buckets=(2,), interactive_us=400000.0, bulk_us=400000.0)
    results, errors = _concurrent_sched(sched, _Dead(), [["a"], ["b"]])
    assert results == [None, None]
    assert all(isinstance(e, fault) for e in errors)


def test_lane_kernel_launch_error_reaches_every_waiter():
    """A lane whose engine cannot launch its kernel raises that error to
    each waiter (after the solo retries); nothing serves the rows."""
    launch_error = port_errors.KernelLaunchError

    class _NoLaunch:
        def __init__(self):
            self.calls = []

        def search_many(self, batches, k=10, check=None):
            self.calls.append(len(batches[0]))
            raise launch_error("sweep_rowmax launch failed: cudaError 1")

    eng = _NoLaunch()
    sched = port_scheduler.AdaptiveDispatchScheduler(
        buckets=(2,), interactive_us=400000.0, bulk_us=400000.0)
    results, errors = _concurrent_sched(sched, eng, [["a"], ["b"]])
    assert results == [None, None]
    assert all(isinstance(e, launch_error) for e in errors), errors
    assert sorted(eng.calls) == [1, 1, 2]


@pytest.mark.faults
def test_scheduler_contains_injected_device_fault(monkeypatch):
    """ES_TPU_FAULTS-style device faults under a merged scheduler
    dispatch: the two-partition engine's fused dispatch faults and any
    per-partition turbo_sweep fallback faults too, so containment
    re-scores the work through the host tier: rows stay bitwise equal to
    solo rows and the FaultRecords reach every waiter's fault_log (the
    reference's fused case, test_scheduler.py)."""
    monkeypatch.setenv("ES_TPU_COALESCE_US", "300000")
    svc = _build_index(monkeypatch, "u_sc_flt")
    try:
        eng = svc.serving.snapshot().engine("body")
        assert eng.fused and len(eng.turbos) == 2
        queries = QUERIES[:4]
        solo = [eng.search_many([[q]], k=10)[0] for q in queries]
        sched = port_scheduler.AdaptiveDispatchScheduler(
            buckets=(4,), interactive_us=400000.0, bulk_us=400000.0)
        flogs = [[] for _ in queries]
        with port_faults.inject(
                "fused_dispatch:raise@1;turbo_sweep:raisexinf"):
            results, errors = _concurrent_sched(sched, eng, queries,
                                                fault_logs=flogs)
        assert errors == [None] * len(queries)
        for q, got, want in zip(queries, results, solo):
            _assert_rows_equal(got, want, f"fault-contained {q}")
        for flog in flogs:
            assert flog, "fault records must reach every waiter"
            assert all(f.site in ("fused_dispatch", "turbo_sweep")
                       for f in flog)
        assert sched.stats()["sched_batch_retries"] == 0
    finally:
        svc.close()


def test_legacy_mode_routes_through_coalescer(pkg, monkeypatch):
    eng = _stub_engine(pkg)
    sc = pkg.sched
    monkeypatch.setenv("ES_TPU_COALESCE_US", "0")
    monkeypatch.setenv("ES_TPU_SCHED_MODE", "legacy")
    co_before = pkg.co.default_coalescer().stats()["direct_dispatches"]
    sc_before = sc.default_scheduler().stats()["direct_dispatches"]
    modes_before = sc.scheduler_stats()["mode_dispatches"]
    sc.serving_dispatch(eng, [["a"]], 10)
    assert pkg.co.default_coalescer().stats()["direct_dispatches"] \
        == co_before + 1
    assert sc.default_scheduler().stats()["direct_dispatches"] == sc_before
    st = sc.scheduler_stats()
    assert st["mode"] == "legacy"
    assert st["mode_dispatches"]["legacy"] == modes_before["legacy"] + 1
    monkeypatch.setenv("ES_TPU_SCHED_MODE", "adaptive")
    sc.serving_dispatch(eng, [["b"]], 10)
    assert sc.default_scheduler().stats()["direct_dispatches"] \
        == sc_before + 1
    assert pkg.co.default_coalescer().stats()["direct_dispatches"] \
        == co_before + 1
    assert sc.scheduler_stats()["mode_dispatches"]["adaptive"] \
        == modes_before["adaptive"] + 1
    assert eng.calls == [1, 1]


def test_window_zero_disables_batching_entirely(pkg, monkeypatch):
    eng = _stub_engine(pkg)
    monkeypatch.setenv("ES_TPU_COALESCE_US", "0")
    sched = pkg.sched.AdaptiveDispatchScheduler(buckets=(8,))
    before = sched.stats()
    out = sched.dispatch(eng, [["a"]], 10)
    assert float(out[0][0, 0]) == 2.0
    st = sched.stats()
    assert st["direct_dispatches"] == before["direct_dispatches"] + 1
    assert st["sched_dispatches"] == before["sched_dispatches"]
    assert st["lanes"] == 0
    assert eng.calls == [1]


def test_serving_path_batches_through_scheduler(monkeypatch):
    svc = _build_index(monkeypatch, "u_sc_e2e")
    try:
        bodies = _serving_bodies()
        monkeypatch.setenv("ES_TPU_COALESCE_US", "0")
        want = [svc.serving.try_search(b, "query_then_fetch")
                for b in bodies]
        assert all(w is not None for w in want)
        monkeypatch.setenv("ES_TPU_SCHED_MODE", "adaptive")
        monkeypatch.setenv("ES_TPU_COALESCE_US", "300000")
        monkeypatch.setenv("ES_TPU_SCHED_BUCKETS", str(len(bodies)))
        monkeypatch.setenv("ES_TPU_SCHED_INTERACTIVE_US", "300000")
        monkeypatch.setenv("ES_TPU_SCHED_BULK_US", "300000")
        sched = port_scheduler.default_scheduler()
        before = sched.stats()
        got, errors = _concurrent(
            lambda i, b: svc.serving.try_search(b, "query_then_fetch"),
            bodies)
        assert errors == [None] * len(bodies)
        after = sched.stats()
        flushes = after["sched_dispatches"] - before["sched_dispatches"]
        assert after["sched_queries"] - before["sched_queries"] \
            == len(bodies)
        assert 1 <= flushes < len(bodies)
        inter = port_scheduler.TIER_INTERACTIVE
        assert after["tiers"][inter]["dispatches"] \
            - before["tiers"][inter]["dispatches"] == len(bodies)
        _assert_same_responses(got, want, bodies)
    finally:
        svc.close()


def test_derive_ladder_from_synthetic_histograms(pkg):
    derive = pkg.sched._derive_ladder
    depth = {"count": 500, "p50": 4, "p90": 32, "p99": 64, "max": 200}
    assert derive(depth, None) == (1, 4, 32, 64, 256)
    assert derive(depth, {"count": 500, "p90": 0.1}) == (1, 4, 32, 64, 256)
    assert derive(depth, {"count": 500, "p90": 0.6}) == \
        (1, 2, 4, 16, 32, 64, 128, 256)
    assert derive({"count": 100, "p50": 1024, "p90": 2048,
                   "p99": 4096, "max": 4000}, None)[-1] == 512


def test_autotune_ladder_pins_synthetic_trace(pkg, monkeypatch):
    monkeypatch.delenv("ES_TPU_SCHED_BUCKETS", raising=False)
    pkg.metrics.reset_for_tests()
    sched = pkg.sched.AdaptiveDispatchScheduler()
    assert sched.ladder() == pkg.sched.DEFAULT_BUCKETS
    for _ in range(100):
        pkg.metrics.observe("sched_queue_depth", 1)
    for _ in range(40):
        pkg.metrics.observe("sched_queue_depth", 48)
    lad = sched.ladder()
    assert lad == (1, 64)
    assert sched.ladder() == lad
    st = sched.stats()
    assert st["bucket_source"] == "auto"
    assert st["buckets"] == [1, 64]
    monkeypatch.setenv("ES_TPU_SCHED_BUCKETS", "2,8")
    assert sched.ladder() == (2, 8)
    assert sched.stats()["bucket_source"] == "knob"


def test_waiter_wider_than_the_autotuned_ladder_is_served(monkeypatch):
    """After 64 flushes of one query the autotuned ladder is (1,). A waiter
    of two queries then finds no rung: the reference builds a batch with no
    waiter, whose in-flight slot nothing releases, and after two of them
    its lane waits forever (ROADMAP W19; not run on the reference, it
    would hang). The port flushes the waiter at its own width."""
    monkeypatch.delenv("ES_TPU_SCHED_BUCKETS", raising=False)
    port_metrics.reset_for_tests()
    try:
        for _ in range(70):
            port_metrics.observe("sched_queue_depth", 1)
        sched = port_scheduler.AdaptiveDispatchScheduler(interactive_us=0.0)
        assert sched.ladder() == (1,)
        eng = _stub_engine(PKGS["port"])
        out = {}

        def run():
            out["rows"] = [sched.dispatch(eng, QUERIES[:2], 10)
                           for _ in range(3)]

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), "the scheduler lane deadlocked"
        want = eng.search_many([QUERIES[:2]], k=10)[0]
        for rows in out["rows"]:
            _assert_rows_equal(rows, want, "wide waiter")
        assert eng.calls[:3] == [2, 2, 2]
    finally:
        port_metrics.reset_for_tests()


def test_waiter_that_fits_a_rung_keeps_the_knob_ladder(pkg, monkeypatch):
    """A ladder whose rungs are not powers of two: a waiter that fits a
    rung flushes at that rung, on the reference and on the port alike
    (only a waiter wider than the top rung widens the bucket, W19)."""
    monkeypatch.setenv("ES_TPU_SCHED_BUCKETS", "1,3,6,12")
    sched = pkg.sched.AdaptiveDispatchScheduler(interactive_us=0.0)
    assert sched.ladder() == (1, 3, 6, 12)
    eng = _stub_engine(pkg)
    out = {}

    def run():
        out["rows"] = [sched.dispatch(eng, QUERIES[:n], 10)
                       for n in (3, 5, 1)]

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "the scheduler lane deadlocked"
    for n, rows in zip((3, 5, 1), out["rows"]):
        _assert_rows_equal(rows, eng.search_many([QUERIES[:n]], k=10)[0],
                           f"{n} queries")
    assert sched.stats()["bucket_counts"] == {"1": 1, "3": 1, "6": 1}


def test_prime_reprimes_on_ladder_change(pkg):
    class _Eng:
        def __init__(self):
            self.calls = []

        def extend_qc_sizes(self, sizes):
            self.calls.append(tuple(sizes))

    sched = pkg.sched.AdaptiveDispatchScheduler(buckets=(1, 4))
    e = _Eng()
    sched._prime_engine(e)
    sched._prime_engine(e)
    assert e.calls == [(1, 4)]
    sched._buckets = (1, 4, 32)
    sched._prime_engine(e)
    assert e.calls == [(1, 4), (1, 4, 32)]
