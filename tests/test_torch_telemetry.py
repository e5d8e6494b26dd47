"""tests/test_telemetry.py on both packages, on the CPU, and the HBM
ledger of every port engine that owns device memory.

Each of the reference suite's nine cases runs here under its own name, on
the reference (Pallas in interpret mode) and on the port
(`device="cpu"`), on the same numpy-seeded corpus, under the reference's
assertions, and then holds what the two packages must share: scoring bits,
ledger books (engine kinds, regions, evictions), compile-book events,
exposition lines, stats keys. Where the port differs by design the case
says so:

* the compile cache is the port's first-launch-per-shape books
  (common/hbm_ledger.py): a *miss* is the first dispatch at an unseen
  (engine kind, QC), its wall time the first launch, kernel build
  included; hits, primed shapes and retraces keep the reference's
  meaning;
* `turbo_eligible` names its device gate `backend_not_cuda` where the
  reference names it `backend_not_tpu`.

`test_ledger_matches_hbm_bytes_for_every_engine` is the audit of the
ledger beyond Turbo: KnnEngine (with its dense mirror), the agg layouts,
BlockMax, the spmd column cache and ShardedTurbo each hold their ledger
regions equal to their own `hbm_bytes()`.
"""

import gc
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster_node import form_local_cluster as ref_form
from elasticsearch_tpu.common import hbm_ledger as ref_ledger
from elasticsearch_tpu.common import metrics as ref_metrics
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.parallel.spmd import build_stacked_bm25 as ref_stack
from elasticsearch_tpu.parallel.turbo import TurboBM25 as RefTurbo
from elasticsearch_tpu.rest import RestController as RefRC
from elasticsearch_tpu.rest import register_handlers as ref_register
from elasticsearch_tpu.search import serving as ref_serving
from elasticsearch_tpu_torch.cluster_node import form_local_cluster
from elasticsearch_tpu_torch.common import hbm_ledger, metrics
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.parallel.spmd import build_stacked_bm25
from elasticsearch_tpu_torch.parallel.turbo import TurboBM25
from elasticsearch_tpu_torch.rest import RestController, register_handlers
from elasticsearch_tpu_torch.search import serving
from test_telemetry import _PROM_LINE, _corpus
from test_torch_turbo_sharded import _Seg, carry

torch.set_num_threads(1)

PORT = dict(ledger=hbm_ledger, metrics=metrics, form=form_local_cluster,
            serving=serving)
REF = dict(ledger=ref_ledger, metrics=ref_metrics, form=ref_form,
           serving=ref_serving)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    for m in (metrics, hbm_ledger, ref_metrics, ref_ledger):
        m.reset_for_tests()
    yield
    for m in (metrics, hbm_ledger, ref_metrics, ref_ledger):
        m.reset_for_tests()


def _turbo(port: bool, seed=5, **kw):
    """tests/test_telemetry.py's `_turbo` in one package."""
    fp, rng = _corpus(seed=seed)
    kw.setdefault("hbm_budget_bytes", 64 << 20)
    kw.setdefault("cold_df", 10)
    if port:
        stacked = build_stacked_bm25([_Seg(2000, carry(fp))], "body")
        return TurboBM25(stacked, device="cpu", **kw), rng
    stacked = ref_stack([_Seg(2000, fp)], "body", serve_only=True)
    return RefTurbo(stacked, **kw), rng


def _search(turbo, queries, k):
    return turbo.search_many([queries], k=k)[0]


def _both():
    return ((False, REF), (True, PORT))


# ------------------------------------------------------------------ differential


def test_telemetry_armed_is_bit_identical_to_disabled(monkeypatch):
    """The sampler thread and every ledger hook leave the scoring bits
    alone, in both packages, and the two packages' bits agree."""
    bits = {}
    for port, pk in _both():
        m, led = pk["metrics"], pk["ledger"]

        def run(sample_s):
            monkeypatch.setenv("ES_TPU_METRICS_SAMPLE_S", sample_s)
            m.reset_for_tests()
            led.reset_for_tests()
            armed = m.maybe_start_sampler()
            turbo, rng = _turbo(port, seed=11)
            queries = [[f"t{a}", f"t{b}"] for a, b in
                       rng.integers(0, 60, size=(16, 2))]
            scores, ords = _search(turbo, queries, 10)
            return (armed, np.asarray(scores).tobytes(),
                    np.asarray(ords).tobytes())

        armed, s1, o1 = run("0.01")
        assert armed is True
        time.sleep(0.05)
        assert len(m.metrics_history()) >= 1
        disarmed, s2, o2 = run("0")
        assert disarmed is False
        assert s1 == s2 and o1 == o2
        bits[port] = (s1, o1)
    assert bits[True] == bits[False]


# ------------------------------------------------------------ ledger exactness


def test_ledger_matches_hbm_bytes_exactly_under_churn():
    """Eviction churn keeps the ledger equal to `hbm_bytes()` in both
    packages; the two evict the same number of slots."""
    out = {}
    for port, pk in _both():
        led = pk["ledger"]
        turbo, _ = _turbo(port, seed=7, hbm_budget_bytes=1, cold_df=5)
        assert turbo.Hp == 32
        assert turbo._hbm.total_bytes() == turbo.hbm_bytes()
        assert led.hbm_stats()["occupancy_bytes"] == turbo.hbm_bytes()
        _search(turbo, [[f"t{i}"] for i in range(30)], 5)
        _search(turbo, [[f"t{i}"] for i in range(30, 60)], 5)
        st = led.hbm_stats()
        assert st["evictions"] > 0
        assert st["churn_bytes"] > 0
        assert turbo._hbm.total_bytes() == turbo.hbm_bytes()
        assert st["occupancy_bytes"] == turbo.hbm_bytes()
        assert st["high_watermark_bytes"] >= st["occupancy_bytes"]
        assert st["budget_bytes"] >= 0
        (entry,) = st["engines"].values()
        assert entry["kind"] == "turbo"
        assert entry["occupancy_bytes"] == turbo.hbm_bytes()
        out[port] = (st["evictions"], sorted(entry["regions"]))
    assert out[True] == out[False]


def test_ledger_drops_engine_on_gc():
    for port, pk in _both():
        led = pk["ledger"]
        turbo, _ = _turbo(port, seed=9)
        occ = led.hbm_stats()["occupancy_bytes"]
        assert occ == turbo.hbm_bytes() > 0
        del turbo
        gc.collect()
        st = led.hbm_stats()
        assert st["occupancy_bytes"] == 0
        assert st["engines"] == {}


# ------------------------------------------------------ compile introspection


def _ref_shapes(primed):
    """The port primes K3's one launch shape, `turbo_sparse:batched`, beside
    the reference's chunk-count ladder; the rest is the reference's."""
    return set(primed) - {"turbo_sparse:batched"}


def test_compile_cache_introspection_hits_misses_priming():
    """The port's books count first launches per (kind, QC) where the
    reference's count XLA traces: misses, hits, events and priming move
    alike in both (K3's shapes as `_ref_shapes` states)."""
    out = {}
    for port, pk in _both():
        led = pk["ledger"]
        turbo, rng = _turbo(port, seed=1)
        queries = [[f"t{a}", f"t{b}"] for a, b in
                   rng.integers(0, 60, size=(12, 2))]
        _search(turbo, queries, 10)
        cs1 = led.compile_stats()
        assert cs1["misses"] >= 1
        assert cs1["events"], "first dispatches must record compile events"
        ev = cs1["events"][0]
        assert ev["engine"] == "turbo" and ev["wall_ms"] >= 0.0
        _search(turbo, queries, 10)
        cs2 = led.compile_stats()
        assert cs2["misses"] == cs1["misses"]
        assert cs2["hits"] > cs1["hits"]
        assert 0.0 < cs2["warmup_coverage_ratio"] <= 1.0
        turbo.extend_qc_sizes((128,))
        cs3 = led.compile_stats()
        assert "turbo:128" in cs3["primed_shapes"]
        assert cs3["retraces"] == cs2["retraces"]
        out[port] = (cs1["misses"], cs2["hits"] - cs1["hits"],
                     [(e["engine"], e["shape"], e["primed"]) for e in cs1["events"]],
                     sorted(_ref_shapes(cs3["primed_shapes"])),
                     cs3["retraces"],
                     cs2["warmup_coverage_ratio"])
    assert out[True] == out[False]


def test_turbo_eligible_records_routing_reason(monkeypatch):
    """Off the reference's TPU / the port's card, the backend gate decides
    (`backend_not_tpu` / `backend_not_cuda`) unless forced; forced, both
    take the budget's reason."""
    fp, _ = _corpus(seed=3)
    reasons = {}
    for force in ("0", "1"):
        monkeypatch.setenv("ES_TPU_FORCE_TURBO", force)
        for port, pk in _both():
            led = pk["ledger"]
            if port:
                eligible = serving.turbo_eligible(
                    [_Seg(2000, carry(fp))], "body", device="cpu")
            else:
                eligible = ref_serving.turbo_eligible(
                    [_Seg(2000, fp)], "body", None)
            last = led.last_routing()
            assert last is not None
            assert last["index"] == "body"
            assert last["eligible"] is eligible
            assert last["reason"] in ("backend_not_tpu", "backend_not_cuda",
                                      "forced_turbo", "fits_hbm_budget",
                                      "exceeds_hbm_budget")
            assert led.last_routing_reason() == last["reason"]
            reasons[(force, port)] = (eligible, last["reason"])
    assert reasons[("0", False)] == (False, "backend_not_tpu")
    assert reasons[("0", True)] == (False, "backend_not_cuda")
    assert reasons[("1", True)] == reasons[("1", False)]


# ------------------------------------------------------- Prometheus exposition


def test_prometheus_exposition_golden_format():
    texts = {}
    for port, pk in _both():
        m = pk["metrics"]
        m.counter_add("sched_flushes")
        m.gauge_set("sched_inflight", 3)
        m.observe("device", 1.5)
        m.observe("device", 250.0)
        text = m.render_prometheus(
            {"a": m.scrape_payload()}, [{"node_id": "b"}])
        assert text.endswith("\n")
        lines = text.splitlines()
        for ln in lines:
            if not ln.startswith("#"):
                assert _PROM_LINE.match(ln), f"invalid line: {ln!r}"
        assert 'es_tpu_node_up{node="a"} 1' in lines
        assert 'es_tpu_node_up{node="b"} 0' in lines
        assert "# TYPE es_tpu_sched_flushes_total counter" in lines
        assert 'es_tpu_sched_flushes_total{node="a"} 1' in lines
        assert "# TYPE es_tpu_sched_inflight gauge" in lines
        assert 'es_tpu_sched_inflight{node="a"} 3' in lines
        assert "# TYPE es_tpu_device histogram" in lines
        buckets = [ln for ln in lines
                   if ln.startswith('es_tpu_device_bucket{node="a"')]
        counts = [int(ln.rsplit(" ", 1)[1]) for ln in buckets]
        assert counts == sorted(counts), "buckets must be cumulative"
        assert buckets[-1].startswith(
            'es_tpu_device_bucket{node="a",le="+Inf"}')
        assert counts[-1] == 2
        assert 'es_tpu_device_count{node="a"} 2' in lines
        assert 'es_tpu_device_sum{node="a"} 251.5' in lines
        for name in m.DECLARED_COUNTERS:
            assert f"# TYPE {m._prom_name(name)}_total counter" in lines
        for name in m.DECLARED_GAUGES:
            assert f"# TYPE {m._prom_name(name)} gauge" in lines
        for name in m.DECLARED:
            assert f"# TYPE {m._prom_name(name)} histogram" in lines
        texts[port] = {ln for ln in lines if ln.startswith("# TYPE")}
    # the port declares every metric of the reference
    assert texts[False] <= texts[True], sorted(texts[False] - texts[True])


# ------------------------------------------------------------------- fan-out


def test_nodes_stats_fanout_degrades_over_dead_peer():
    shapes = {}
    for port, pk in _both():
        kw = {"device": "cpu"} if port else {}
        nodes, store, channels = pk["form"](["a", "b"], **kw)
        try:
            a, b = nodes
            per_node, failures = a.telemetry_plane.nodes_stats()
            assert set(per_node) == {"a", "b"} and failures == []
            for sec in per_node.values():
                assert "tpu_hbm" in sec and "tpu_compile" in sec
                assert "occupancy_bytes" in sec["tpu_hbm"]
            channels.kill("b")
            per_node, failures = a.telemetry_plane.nodes_stats()
            assert set(per_node) == {"a"}
            assert [f["node_id"] for f in failures] == ["b"]
            assert failures[0]["type"] == "failed_node_exception"
            assert failures[0]["caused_by"]["type"] == \
                "node_not_connected_exception"
            text, pfail = a.telemetry_plane.prometheus()
            assert 'es_tpu_node_up{node="a"} 1' in text
            assert 'es_tpu_node_up{node="b"} 0' in text
            assert [f["node_id"] for f in pfail] == ["b"]
            channels.revive("b")
            per_node, failures = a.telemetry_plane.nodes_stats()
            assert set(per_node) == {"a", "b"} and failures == []
            shapes[port] = ({n: sorted(s) for n, s in per_node.items()},
                            sorted(failures[0]) if failures else None)
        finally:
            for n in nodes:
                n.close()
    assert shapes[True] == shapes[False]


# ---------------------------------------------------------------- REST surface


def test_rest_metrics_endpoints_and_nodes_stats_sections():
    keys = {}
    for port, (node_cls, rc_cls, reg) in (
            (False, (RefNode, RefRC, ref_register)),
            (True, (Node, RestController, register_handlers))):
        node = node_cls(device="cpu") if port else node_cls()
        rc = rc_cls()
        reg(node, rc)
        try:
            r = rc.dispatch("GET", "/_tpu/metrics", {}, None)
            assert r.status == 200
            assert r.content_type.startswith("text/plain")
            assert "# TYPE es_tpu_node_up gauge" in r.body
            assert "# TYPE es_tpu_sched_inflight gauge" in r.body
            h = rc.dispatch("GET", "/_tpu/metrics/history", {}, None)
            assert h.status == 200
            assert h.body["sampler_running"] is False
            assert isinstance(h.body["samples"], list)
            st = rc.dispatch("GET", "/_nodes/stats", {}, None)
            assert st.status == 200
            assert st.body["_nodes"]["failed"] == 0
            sec = st.body["nodes"][node.node_id]
            assert sec["tpu_hbm"]["occupancy_bytes"] >= 0
            assert "warmup_coverage_ratio" in sec["tpu_compile"]
            keys[port] = (sorted(h.body), sorted(sec["tpu_hbm"]),
                          sorted(sec["tpu_compile"]))
        finally:
            node.close()
    assert keys[True] == keys[False]


def test_sample_now_includes_scheduler_provider():
    keys = {}
    for port, pk in _both():
        m = pk["metrics"]
        s = m.sample_now()
        assert "ts" in s and "counters" in s and "gauges" in s
        assert "tpu_scheduler" in s
        assert set(m.metrics_history()[-1]) == set(s)
        keys[port] = set(s)
    assert keys[True] == keys[False]


# ---------------------------------------------------------------------------
# the ledger of every port engine that owns device memory
# ---------------------------------------------------------------------------


def _ledger_entry(engine):
    return hbm_ledger.hbm_stats()["engines"][engine._hbm.label]


def test_ledger_matches_hbm_bytes_for_every_engine(monkeypatch):
    """KnnEngine (before and after its dense mirror is uploaded), the agg
    engine's layouts, BlockMax, the spmd column cache and the fused S > 1
    Turbo: each engine's ledger regions sum to its `hbm_bytes()`, and the
    node's occupancy is their sum."""
    from elasticsearch_tpu_torch.parallel import knn
    from elasticsearch_tpu_torch.parallel.blockmax import BlockMaxBM25
    from elasticsearch_tpu_torch.parallel.spmd import Bm25ColumnCache
    from elasticsearch_tpu_torch.search import agg_device as port_dev
    from test_knn_quantized import _cols, _queries
    from test_torch_agg import BODIES, Pair
    from test_torch_knn import _port_cols

    eng = knn.KnnEngine(_port_cols(_cols([2100, 900], seed=3)), stacked=True,
                        device="cpu")
    assert eng._hbm.total_bytes() == eng.hbm_bytes()
    before = eng.hbm_bytes()
    monkeypatch.setenv("ES_TPU_KNN_INT8", "0")        # the dense route
    eng.search_many([[knn.KnnWork(q) for q in _queries(4)]], k=10)
    assert eng.hbm_bytes() > before                   # the mirror is up
    assert eng._hbm.total_bytes() == eng.hbm_bytes()
    assert _ledger_entry(eng)["regions"]["knn_dense_mirror"] == \
        eng.hbm_bytes() - before
    monkeypatch.delenv("ES_TPU_KNN_INT8")

    monkeypatch.setattr(port_dev, "_ENGINES", {})
    agg = port_dev.default_engine("cpu")
    p = Pair(n=1200, seed=19)
    try:
        p.run(True, BODIES["terms_and_histogram_4"], p.live, True,
              monkeypatch)
        assert agg.hbm_bytes() > 0
        assert agg.ledger_bytes() == agg.hbm_bytes()
        assert set(_ledger_entry(agg)["regions"]) == \
            set(agg.layout_serials())
    finally:
        p.svc.close()

    fps = [_corpus(n_docs=1500, seed=s)[0] for s in (2, 4)]
    stacked = build_stacked_bm25([_Seg(1500, carry(fp)) for fp in fps],
                                 "body", device_arrays=True, serve_only=True,
                                 device="cpu")
    bm = BlockMaxBM25(stacked, device="cpu")
    bm.search([["t1", "t2"], ["t3"]], k=5)
    assert bm._hbm.total_bytes() == bm.hbm_bytes() > 0
    cache = Bm25ColumnCache(stacked, capacity=64)
    assert cache._hbm.total_bytes() == cache.hbm_bytes() > 0

    turbos = [_turbo(True, seed=s)[0] for s in (21, 22)]
    fused = serving.TurboEngine(turbos, fused=True)
    fused.search_many([[["t1", "t2"], ["t5"]]], k=5)
    for t in turbos:
        assert t._hbm.total_bytes() == t.hbm_bytes()
    assert fused.hbm_bytes() == sum(t.hbm_bytes() for t in turbos)

    engines = [eng, agg, bm, cache] + turbos
    st = hbm_ledger.hbm_stats()
    assert st["occupancy_bytes"] >= sum(e._hbm.total_bytes()
                                        for e in engines)
