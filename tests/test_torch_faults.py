"""tests/test_faults.py on both packages, on the CPU.

Each case of the reference's device-fault suite that
tests/test_torch_turbo_sharded.py does not already twin
(`test_fused_dispatch_fault_bit_identical`,
`test_partition_column_fault_isolated`,
`test_merge_kernel_fault_degrades_to_host_merge` are there) runs here
under its own name on the reference and on the port, on the same
numpy-seeded corpora: the reference's Turbo on its CPU mesh (Pallas in
interpret mode), the port's on `device="cpu"` (its kernels' plain
versions). Faults are injected with the same spec in both packages. Each
case asserts the reference's contract on both runs, then holds the port's
rows bitwise to the reference's (Turbo's final scores come from the host,
ROADMAP contract), and the fault records, health counters and serving
counters to move alike.

How a jax error becomes a torch one, per case:

* `test_oom_mode_and_device_error_translation`: XLA's
  `RESOURCE_EXHAUSTED` runtime error is `torch.OutOfMemoryError` on the
  card (a RuntimeError subclass saying "CUDA out of memory"); both become
  `HbmOomError` under `device_errors`. A RuntimeError with the reference's
  marker text is translated in both packages; a ValueError passes through.
* the engine cases: the injected fault is the same `DeviceFaultError` in
  both packages (the fault grammar is shared), raised at the same site.
* the coalescer and serving cases have no device error of their own: a
  stub engine raises `DeviceFaultError` in both.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common import errors as ref_errors
from elasticsearch_tpu.common import faults as ref_faults
from elasticsearch_tpu.common import health as ref_health
from elasticsearch_tpu.parallel import turbo as ref_turbo
from elasticsearch_tpu.parallel.spmd import build_stacked_bm25 as ref_stack
from elasticsearch_tpu.search import serving as ref_serving
from elasticsearch_tpu_torch.common import errors, faults, health
from elasticsearch_tpu_torch.parallel.spmd import build_stacked_bm25
from elasticsearch_tpu_torch.parallel.turbo import TurboBM25
from elasticsearch_tpu_torch.search import serving
from test_faults import BATCH, SPECS, _pcorpus
from test_torch_turbo_sharded import _Seg, carry

torch.set_num_threads(1)

K = 10


class Pkg:
    """One package's side of a case: its modules and engine builders."""

    def __init__(self, port: bool):
        self.port = port
        self.faults = faults if port else ref_faults
        self.errors = errors if port else ref_errors
        self.health = health if port else ref_health
        self.serving = serving if port else ref_serving
        self.pkg = "elasticsearch_tpu_torch" if port else "elasticsearch_tpu"

    def turbo(self, fp, n_docs, cold_df=5, hbm=64 << 20):
        if self.port:
            return TurboBM25(build_stacked_bm25([_Seg(n_docs, carry(fp))],
                                                "body"),
                             hbm_budget_bytes=hbm, cold_df=cold_df,
                             device="cpu")
        return ref_turbo.TurboBM25(
            ref_stack([_Seg(n_docs, fp)], "body", serve_only=True),
            hbm_budget_bytes=hbm, cold_df=cold_df)

    def engine(self, parts, mesh=True):
        """tests/test_faults.py's `_engine`: the reference on its mesh (or
        none), the port fused (or sequential) on the one device."""
        turbos = [self.turbo(fp, n) for n, fp in parts]
        if self.port:
            return serving.TurboEngine(turbos, fused=mesh)
        return ref_serving.TurboEngine(
            turbos, mesh=ref_serving._turbo_mesh(len(turbos)) if mesh
            else None)

    def module(self, dotted):
        import importlib

        return importlib.import_module(f"{self.pkg}.{dotted}")


REF, PORT = Pkg(False), Pkg(True)
BOTH = (REF, PORT)


@pytest.fixture(autouse=True)
def _clear_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def _host_many(eng, batch, k):
    per = [t.search_many_host([batch], k=k)[0] for t in eng.turbos]
    return eng._merge3(per, len(batch), k)


def _host_bool(eng, specs, k):
    per = [t.search_bool_host(specs, k=k) for t in eng.turbos]
    return eng._merge3(per, len(specs), k)


def _assert_rows_equal(got, want, ctx):
    for g, w, name in zip(got, want, ("scores", "parts", "ords")):
        assert np.array_equal(np.asarray(g), np.asarray(w)), (ctx, name)


def _flog(flog):
    return [(f.site, f.partition, f.recovered) for f in flog]


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------


def test_parse_spec_full_grammar():
    spec = ("turbo_sweep#1:raise@2x3;fused_dispatch:oom~0.5;"
            "merge_kernel:hang=0.01;column_upload:raisexinf")
    views = []
    for p in BOTH:
        cl = p.faults.parse_spec(spec)
        assert [(c.site, c.part, c.mode) for c in cl] == [
            ("turbo_sweep", 1, "raise"), ("fused_dispatch", None, "oom"),
            ("merge_kernel", None, "hang"), ("column_upload", None, "raise")]
        assert (cl[0].nth, cl[0].count) == (2, 3)
        assert cl[1].prob == 0.5 and cl[1].rng is not None
        assert cl[2].arg == 0.01
        assert cl[3].count == float("inf")
        views.append([(c.site, c.part, c.mode, c.nth, c.count, c.arg,
                       c.prob) for c in cl])
    assert views[0] == views[1]


@pytest.mark.parametrize("bad", [
    "not_a_site:raise",          # unknown site
    "turbo_sweep:explode",       # unknown mode
    "turbo_sweep#x:raise",       # bad partition
    "turbo_sweep",               # missing mode
    "turbo_sweep:raise@zz",      # bad nth
])
def test_parse_spec_rejects(bad):
    for p in BOTH:
        with pytest.raises(p.faults.FaultSpecError):
            p.faults.parse_spec(bad)


def test_fault_point_nth_count_and_part_scope():
    for p in BOTH:
        f = p.faults
        with f.inject("turbo_sweep#1:raise@2x2"):
            f.fault_point("turbo_sweep", 0)       # wrong partition: never
            f.fault_point("merge_kernel", 1)      # wrong site: never
            f.fault_point("turbo_sweep", 1)       # call 1 < nth
            for _ in range(2):                    # calls 2, 3 fire (x2)
                with pytest.raises(p.errors.DeviceFaultError) as ei:
                    f.fault_point("turbo_sweep", 1)
                assert ei.value.site == "turbo_sweep"
                assert ei.value.part == 1
            f.fault_point("turbo_sweep", 1)       # count exhausted
        f.fault_point("turbo_sweep", 1)           # restored on exit


def test_oom_mode_and_device_error_translation():
    """The oom mode raises HbmOomError in both packages. The reference's
    device OOM is an XLA RESOURCE_EXHAUSTED runtime error; the port's is
    `torch.OutOfMemoryError`: each becomes HbmOomError under
    `device_errors`, and so does a RuntimeError with the reference's text
    in the port. Non-device errors pass through."""
    torch_oom = torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.11 GiB "
        "total capacity)")
    device_oom = {False: RuntimeError(
        "RESOURCE_EXHAUSTED: out of memory on chip"), True: torch_oom}
    for p in BOTH:
        with p.faults.inject("turbo_sweep:oom"):
            with pytest.raises(p.errors.HbmOomError):
                p.faults.fault_point("turbo_sweep")
        errs = [device_oom[p.port],
                RuntimeError("RESOURCE_EXHAUSTED: out of memory on chip")]
        for err in errs:
            with pytest.raises(p.errors.HbmOomError) as ei:
                with p.faults.device_errors("turbo_sweep", 2):
                    raise err
            assert (ei.value.site, ei.value.part) == ("turbo_sweep", 2)
            assert ei.value.__cause__ is err
        with pytest.raises(ValueError):           # non-device errors pass
            with p.faults.device_errors("turbo_sweep"):
                raise ValueError("not a device problem")


# ---------------------------------------------------------------------------
# engine-level differentials: fault at every site, results bit-identical
# ---------------------------------------------------------------------------


def test_solo_sweep_fault_bit_identical():
    rows, logs = {}, {}
    for p in BOTH:
        eng = p.engine([(700, _pcorpus(700, 40, 7))], mesh=False)
        want = _host_many(eng, BATCH, K)
        logs[p.port] = []
        for spec in ("turbo_sweep:raise@1", "turbo_sweep:oom@1"):
            flog = []
            with p.faults.inject(spec):
                got = eng.search_many([BATCH], k=K, fault_log=flog)[0]
            _assert_rows_equal(got, want, spec)
            assert flog and flog[0].partition == 0 and flog[0].recovered
            logs[p.port].append(_flog(flog))
        assert eng.stats["health_device_faults"] >= 2
        rows[p.port] = (want, eng.stats["health_device_faults"])
    _assert_rows_equal(rows[True][0], rows[False][0], "port vs reference")
    assert rows[True][1] == rows[False][1]
    assert logs[True] == logs[False]


def test_bool_and_phrase_under_partition_fault():
    out = {}
    phrases = [["t0", "t1"], ["t2", "t0"]]
    for p in BOTH:
        eng = p.engine([(600, _pcorpus(600, 40, 5)),
                        (800, _pcorpus(800, 32, 6))])
        want = _host_bool(eng, SPECS, K)
        with p.faults.inject("column_upload#0:raise@1"):
            got = eng.search_bool(SPECS, k=K)
        _assert_rows_equal(got, want, "bool under column fault")
        want_p = _host_bool(
            eng, [{"phrases": [(ph, 0, 1.0)]} for ph in phrases], K)
        with p.faults.inject("turbo_sweep:raisexinf"):
            got_p = eng.search_phrase(phrases, k=K, slop=0)
        _assert_rows_equal(got_p, want_p, "phrase under sweep fault")
        out[p.port] = (got, got_p)
    _assert_rows_equal(out[True][0], out[False][0], "bool: port vs ref")
    _assert_rows_equal(out[True][1], out[False][1], "phrase: port vs ref")


def test_blockmax_fault_point_raises():
    for p in BOTH:
        with p.faults.inject("blockmax_pass:raise@1"):
            with pytest.raises(p.errors.DeviceFaultError) as ei:
                p.faults.fault_point("blockmax_pass")
        assert ei.value.site == "blockmax_pass"


# ---------------------------------------------------------------------------
# circuit breaker lifecycle
# ---------------------------------------------------------------------------


def test_circuit_opens_after_trip_n_and_probe_restores(monkeypatch):
    """The case's trip_n=2 / backoff 40 ms, given to the port through its
    knobs (ES_TPU_HEALTH_TRIP_N, ES_TPU_HEALTH_BACKOFF_MS) and to the
    reference as the case does, by constructor."""
    out = {}
    for p in BOTH:
        eng = p.engine([(700, _pcorpus(700, 40, 9))], mesh=False)
        if p.port:
            monkeypatch.setenv("ES_TPU_HEALTH_TRIP_N", "2")
            monkeypatch.setenv("ES_TPU_HEALTH_BACKOFF_MS", "40")
            eng.health = p.health.EngineHealth("turbo")
            assert (eng.health.trip_n, eng.health.base_backoff_ms) == (2, 40)
        else:
            eng.health = p.health.EngineHealth("turbo", trip_n=2,
                                               backoff_ms=40)
        t = eng.turbos[0]
        want = _host_many(eng, BATCH, K)
        eng.search_many([BATCH], k=K)                  # warm, clean
        with p.faults.inject("turbo_sweep:raisexinf"):
            for i in range(2):                         # trip the breaker
                _assert_rows_equal(eng.search_many([BATCH], k=K)[0], want,
                                   f"contained fault {i}")
            assert eng.health.state == "open"
            d0 = t.stats["dispatches"]
            _assert_rows_equal(eng.search_many([BATCH], k=K)[0], want,
                               "open")
            assert t.stats["dispatches"] == d0
            assert eng.health.counters["fallback_queries"] >= len(BATCH)
        time.sleep(0.06)                               # past backoff
        _assert_rows_equal(eng.search_many([BATCH], k=K)[0], want, "probe")
        assert eng.health.state == "closed"
        c = eng.health.counters
        assert c["circuit_opens"] == 1
        assert c["probes"] == 1 and c["probe_successes"] == 1
        assert list(eng.health._transitions) == [
            "closed->open", "open->half_open", "half_open->closed"]
        out[p.port] = (want, dict(c))
    _assert_rows_equal(out[True][0], out[False][0], "port vs reference")
    assert out[True][1] == out[False][1]


def test_failed_probe_reopens_with_exponential_backoff(monkeypatch):
    monkeypatch.setenv("ES_TPU_HEALTH_TRIP_N", "1")
    monkeypatch.setenv("ES_TPU_HEALTH_BACKOFF_MS", "10")
    for p in BOTH:
        # the port through its knobs, the reference by constructor
        h = (p.health.EngineHealth("x") if p.port
             else p.health.EngineHealth("x", trip_n=1, backoff_ms=10))
        h.record_fault(p.errors.DeviceFaultError("boom"))
        assert h.state == "open" and h.backoff_ms == 10
        for i in range(1, 8):
            h._retry_at = 0.0                  # make the probe due now
            assert h.allow_device()            # half-open probe admitted
            assert not h.allow_device()        # only ONE probe in flight
            h.record_fault(p.errors.DeviceFaultError("boom"))
            assert h.state == "open"
            assert h.backoff_ms == min(10 * 2 ** i, 320)
        assert h.counters["circuit_reopens"] == 7
        h._retry_at = 0.0
        assert h.allow_device()
        h.record_success()
        assert h.state == "closed" and h.backoff_ms == 10


def test_health_visible_in_node_stats_and_handler():
    keys = []
    for p in BOTH:
        h = p.health.EngineHealth("visible_test", trip_n=1, backoff_ms=10)
        h.record_fault(p.errors.DeviceFaultError("boom"))
        node = p.health.node_health_stats()
        mine = [e for e in node["engines"] if e["name"] == "visible_test"]
        assert mine and mine[0]["state"] == "open"
        assert node["open_circuits"] >= 1
        assert node["device_faults"] >= 1
        full = p.module("rest.handlers")._tpu_health_stats()
        for key in ("engines", "open_circuits", "device_faults",
                    "fastpath_reject_error", "shard_fault_recoveries",
                    "coalesce_batch_retries"):
            assert key in full
        keys.append((set(full), set(mine[0])))
        del h
    assert keys[0] == keys[1]


# ---------------------------------------------------------------------------
# coalescer: poison-batch solo retry
# ---------------------------------------------------------------------------


class _StubEngine:
    """tests/test_faults.py's stub: deterministic per-query rows; raises
    the package's DeviceFaultError on merged batches and/or on a poisoned
    query term."""

    def __init__(self, err, fail_merged=False, poison=None):
        self.err = err
        self.fail_merged = fail_merged
        self.poison = poison
        self.calls = []

    def search_many(self, batches, k=10, check=None):
        qs = batches[0]
        self.calls.append(len(qs))
        if self.fail_merged and len(qs) > 1:
            raise self.err("poisoned merged batch", site="turbo_sweep")
        out_s = np.zeros((len(qs), k), np.float32)
        out_p = np.zeros((len(qs), k), np.int32)
        out_o = np.zeros((len(qs), k), np.int32)
        for i, q in enumerate(qs):
            if self.poison is not None and self.poison in q:
                raise self.err(f"query {q} is poison", site="turbo_sweep")
            out_s[i, 0] = float(len(q[0])) + 1.0
            out_o[i, 0] = len(q[0])
        return [(out_s, out_p, out_o)]


def _concurrent(co, eng, queries, k=10):
    results = [None] * len(queries)
    errs = [None] * len(queries)
    barrier = threading.Barrier(len(queries))

    def worker(i, q):
        try:
            barrier.wait(timeout=10)
            results[i] = co.dispatch(eng, [q], k)
        except BaseException as e:  # noqa: BLE001 — asserted below
            errs[i] = e

    threads = [threading.Thread(target=worker, args=(i, q))
               for i, q in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results, errs


def _coalescer(p):
    return p.module("threadpool.coalescer").DispatchCoalescer(
        window_us=200000)


def test_poison_batch_retries_each_waiter_solo():
    calls = []
    for p in BOTH:
        eng = _StubEngine(p.errors.DeviceFaultError, fail_merged=True)
        co = _coalescer(p)
        queries = [["a"], ["bb"], ["ccc"]]
        results, errs = _concurrent(co, eng, queries)
        assert errs == [None, None, None]
        for q, r in zip(queries, results):
            assert float(r[0][0, 0]) == len(q[0]) + 1.0, q
        assert co.stats()["coalesce_batch_retries"] == 1
        assert sorted(eng.calls) == [1, 1, 1, 3]
        calls.append(sorted(eng.calls))
    assert calls[0] == calls[1]


def test_poison_query_error_isolated_to_its_waiter():
    for p in BOTH:
        eng = _StubEngine(p.errors.DeviceFaultError, poison="bad")
        co = _coalescer(p)
        queries = [["good"], ["bad"], ["fine"]]
        results, errs = _concurrent(co, eng, queries)
        bad_i = queries.index(["bad"])
        for i, (r, e) in enumerate(zip(results, errs)):
            if i == bad_i:
                assert isinstance(e, p.errors.DeviceFaultError) and r is None
            else:
                assert e is None
                assert float(r[0][0, 0]) == len(queries[i][0]) + 1.0
        assert co.stats()["coalesce_batch_retries"] == 1


def test_all_retries_failing_surfaces_original_error():
    for p in BOTH:
        err = p.errors.DeviceFaultError

        class _Dead:
            def search_many(self, batches, k=10, check=None):
                raise err("engine is gone", site="turbo_sweep")

        results, errs = _concurrent(_coalescer(p), _Dead(), [["a"], ["b"]])
        assert results == [None, None]
        assert all(isinstance(e, err) for e in errs)


# ---------------------------------------------------------------------------
# serving path: _shards accounting, allow_partial_search_results, timeout
# ---------------------------------------------------------------------------

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lam", "mu"]


def _turbo_svc(p):
    """tests/test_faults.py's `turbo_svc` for one package: 260 docs in two
    segments (two partitions), ES_TPU_FORCE_TURBO and cold_df 8 set by
    the caller."""
    meta = p.module("cluster.state").IndexMetadata(
        index="faults_t", uuid="u_faults",
        settings=p.module("common.settings").Settings({}),
        mappings={"properties": {"body": {"type": "text"}}})
    cls = p.module("index.index_service").IndexService
    svc = cls(meta, device="cpu") if p.port else cls(meta)
    rng = np.random.default_rng(21)
    for i in range(260):
        words = rng.choice(WORDS, size=int(rng.integers(3, 14)))
        svc.index_doc(str(i), {"body": " ".join(words)})
        if i == 120:
            svc.refresh()
    svc.refresh()
    return svc


@pytest.fixture()
def turbo_svcs(monkeypatch):
    monkeypatch.setenv("ES_TPU_FORCE_TURBO", "1")
    monkeypatch.setenv("ES_TPU_TURBO_COLD_DF", "8")
    svcs = {p.port: _turbo_svc(p) for p in BOTH}
    yield svcs
    for s in svcs.values():
        s.close()


def _hits(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def test_apsr_false_turns_fault_into_request_error(turbo_svcs):
    body = {"query": {"match": {"body": "alpha beta"}},
            "allow_partial_search_results": False}
    for p in BOTH:
        with p.faults.inject("column_upload:raise@1"):
            with pytest.raises(p.errors.SearchPhaseExecutionError) as ei:
                turbo_svcs[p.port].search(body)
        assert "allow_partial_search_results" in str(ei.value)


def test_recovered_fault_reported_in_shards(turbo_svcs):
    body = {"query": {"match": {"body": "alpha beta"}}}
    out = {}
    for p in BOTH:
        svc = turbo_svcs[p.port]
        want = svc.serving.try_search(body, "query_then_fetch")
        r0 = p.serving.serving_fault_stats()["shard_fault_recoveries"]
        with p.faults.inject("column_upload#0:raise@1"):
            got = svc.search(body)
        fails = got["_shards"].get("failures")
        assert fails and fails[0]["status"] == "recovered"
        assert fails[0]["reason"]["site"] == "column_upload"
        assert _hits(got) == _hits(want)
        recovered = p.serving.serving_fault_stats()[
            "shard_fault_recoveries"] - r0
        assert recovered > 0
        clean = svc.search(dict(body, size=11))
        assert "failures" not in clean["_shards"]
        assert clean["_shards"]["failed"] == 0
        out[p.port] = (_hits(got), _hits(clean), fails[0]["reason"],
                       {k: v for k, v in got["_shards"].items()
                        if k != "failures"}, recovered)
    assert out[True] == out[False]


def test_timeout_yields_timed_out_partial(turbo_svcs, monkeypatch):
    monkeypatch.setenv("ES_TPU_COALESCE_US", "0")
    spec = ("turbo_sweep:hang=0.08;fused_dispatch:hang=0.08;"
            "column_upload:hang=0.08")
    for p in BOTH:
        svc = turbo_svcs[p.port]
        svc.search({"query": {"match": {"body": "alpha"}}})  # warm
        body = {"query": {"match": {"body": "alpha beta"}},
                "timeout": "5ms"}
        with p.faults.inject(spec):
            resp = svc.search(body)
        assert resp["timed_out"] is True
        resp2 = svc.search({"query": {"match": {"body": "alpha beta"}}})
        assert resp2["timed_out"] is False and resp2["hits"]["hits"]


def test_reject_errors_counted_and_logged_once(caplog, monkeypatch):
    class _BoomMapper:
        def __getattr__(self, name):
            raise RuntimeError("mapper exploded")

    for p in BOTH:
        sv = p.serving
        # a fresh set of logged types: another test of this process may
        # have logged this error already
        monkeypatch.setattr(sv, "_LOGGED_REJECT_TYPES", set())
        n0 = sv.serving_fault_stats()["fastpath_reject_error"]
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="search.serving"):
            for _ in range(3):
                assert sv.extract_plan(
                    {"query": {"match": {"body": "x"}}},
                    _BoomMapper()) is None
        assert sv.serving_fault_stats()["fastpath_reject_error"] == n0 + 3
        hits = [r for r in caplog.records
                if "RuntimeError" in r.getMessage()]
        assert len(hits) == 1      # first occurrence logged, rest counted


def test_coalesced_turbo_fault_bit_identical():
    out = {}
    for p in BOTH:
        eng = p.engine([(700, _pcorpus(700, 40, 11))], mesh=False)
        eng.search_many([BATCH], k=K)              # warm columns
        co = _coalescer(p)
        want = _host_many(eng, BATCH, K)
        with p.faults.inject("turbo_sweep:raise@1"):
            results, errs = _concurrent(co, eng, BATCH)
        assert errs == [None] * len(BATCH)
        for qi, r in enumerate(results):
            for j, name in enumerate(("scores", "parts", "ords")):
                assert np.array_equal(np.asarray(r[j][0]),
                                      np.asarray(want[j][qi])), (qi, name)
        out[p.port] = want
    _assert_rows_equal(out[True], out[False], "port vs reference")
