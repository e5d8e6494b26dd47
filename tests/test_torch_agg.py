"""The port's aggregations against the reference, on the CPU.

The reference leaf is the one tests/test_agg_device.py builds (2,500 docs,
multi-valued `tag`, `price` with gaps, `ts`); the port's leaf carries its
columns across with `numeric_column_from_arrays` and
`keyword_column_from_arrays`. For every aggregation body of
tests/test_agg_device.py and query masks made from a seed (5%, 20%, 90%,
empty, and the docs of `body:w3`), four routes must give equal dicts,
floats included (tolerance 0): the port's device route (its K8 wrapper
runs the plain torch version on a CPU engine), the port's host path, the
reference's device route (K8 in interpret mode) and the reference's host
path. The device routes are forced by shrinking AGG_DEVICE_MIN_DOCS, as
the reference's suite does, and the counters of both packages must move
alike. The rest of the copied aggregations.py is held on the host path.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import elasticsearch_tpu.search.aggregations as ref_aggs
import elasticsearch_tpu_torch.search.aggregations as port_aggs
from elasticsearch_tpu.common import faults as ref_faults
from elasticsearch_tpu.search import agg_device as ref_dev
from elasticsearch_tpu_torch.common import faults as port_faults
from elasticsearch_tpu_torch.common.errors import KernelLaunchError
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.index.segment import (
    KEYWORD_ARRAYS, NUMERIC_ARRAYS, POSTINGS_ARRAYS,
    keyword_column_from_arrays, numeric_column_from_arrays,
    postings_from_arrays,
)
from elasticsearch_tpu_torch.search import agg_device as port_dev
from test_agg_device import BASE_MS, _make_service

torch.set_num_threads(1)

COUNTERS = ("agg_queries", "agg_device_dispatches", "agg_host_fallbacks",
            "agg_bytes")

# every aggregation body of tests/test_agg_device.py
BODIES = {
    "terms": {"tags": {"terms": {"field": "tag", "size": 50}}},
    "date_7d_offset": {"d": {"date_histogram": {
        "field": "ts", "fixed_interval": "7d", "offset": 10_800_000}}},
    "date_month": {"d": {"date_histogram": {
        "field": "ts", "calendar_interval": "month"}}},
    "date_12h": {"d": {"date_histogram": {
        "field": "ts", "fixed_interval": "12h"}}},
    "terms_metrics": {"tags": {
        "terms": {"field": "tag", "size": 50},
        "aggs": {"p": {"stats": {"field": "price"}},
                 "a": {"avg": {"field": "price"}},
                 "lo": {"min": {"field": "price"}},
                 "nv": {"value_count": {"field": "price"}}}}},
    "histogram_stats": {"h": {
        "histogram": {"field": "price", "interval": 7.5},
        "aggs": {"s": {"stats": {"field": "price"}}}}},
    "date_month_extended": {"d": {
        "date_histogram": {"field": "ts", "calendar_interval": "month"},
        "aggs": {"s": {"extended_stats": {"field": "price"}}}}},
    "terms_and_histogram": {"tags": {"terms": {"field": "tag"}},
                            "h": {"histogram": {"field": "price",
                                                "interval": 5}}},
    "terms_default": {"tags": {"terms": {"field": "tag"}}},
    "terms_stats": {"tags": {"terms": {"field": "tag", "size": 50},
                             "aggs": {"s": {"stats": {"field": "price"}}}}},
    "terms_and_histogram_4": {"tags": {"terms": {"field": "tag"}},
                              "h": {"histogram": {"field": "price",
                                                  "interval": 4}}},
}
MASKS = ("p05", "p20", "p90", "empty", "body_w3")


def _counts(mod):
    with mod._COUNTS_LOCK:
        return dict(mod._COUNTS)


def _delta(after, before):
    return {k: after[k] - before[k] for k in COUNTERS}


def _port_segment(seg):
    """The port's leaf segment over a reference segment's arrays."""
    return SimpleNamespace(
        n_docs=seg.n_docs,
        numeric={f: numeric_column_from_arrays(
            {n: getattr(c, n) for n in NUMERIC_ARRAYS})
            for f, c in seg.numeric.items()},
        keyword={f: keyword_column_from_arrays(
            {n: getattr(c, n) for n in KEYWORD_ARRAYS}, c.terms)
            for f, c in seg.keyword.items()},
        postings={f: postings_from_arrays(
            {n: getattr(fp, n) for n in POSTINGS_ARRAYS}, fp.terms,
            fp.sum_doc_len, f) for f, fp in seg.postings.items()},
        doc_ids=list(seg.doc_ids), sources=list(seg.sources), _device={},
        torch_device=torch.device("cpu"))


class Pair:
    """One reference service and the port's leaf over the same columns."""

    def __init__(self, n=2500, seed=7):
        self.svc = _make_service(n=n, seed=seed)
        (view,) = self.svc.shards[0].acquire_searcher().views
        seg = view.segment
        self.n = seg.n_docs
        self.live = np.asarray(view.live, bool)
        self.ref_ctx = ref_aggs.AggContext(
            leaf=SimpleNamespace(segment=seg, n_docs=seg.n_docs),
            mapper=None, executor=None, live=self.live)
        self.port_seg = _port_segment(seg)
        self.port_ctx = port_aggs.AggContext(
            leaf=SimpleNamespace(segment=self.port_seg, n_docs=seg.n_docs),
            mapper=None, executor=None, live=self.live.copy())
        rng = np.random.default_rng(seed + 100)
        fp = seg.postings["body"]
        o = fp.term_to_ord["w3"]
        w3 = np.zeros(self.n, bool)
        w3[fp.post_doc[fp.post_start[o]:fp.post_start[o + 1]]] = True
        self.masks = {"p05": rng.random(self.n) < 0.05,
                      "p20": rng.random(self.n) < 0.2,
                      "p90": rng.random(self.n) < 0.9,
                      "empty": np.zeros(self.n, bool),
                      "body_w3": w3}

    def run(self, port: bool, spec, mask, device: bool, monkeypatch):
        mod = port_aggs if port else ref_aggs
        monkeypatch.setattr(mod, "AGG_DEVICE_MIN_DOCS",
                            1 if device else 1 << 60)
        aggs, pipes = mod.parse_aggs(spec)
        ctx = self.port_ctx if port else self.ref_ctx
        partial = mod.collect_leaf(aggs, ctx, mask)
        return mod.finalize_aggs(aggs, pipes,
                                 mod.reduce_partials(aggs, [partial]))

    def four(self, spec, mask, monkeypatch):
        """{route: response} and the device routes' counter deltas."""
        out, deltas = {}, {}
        for name, port, mod in (("port", True, port_dev),
                                ("ref", False, ref_dev)):
            c0 = _counts(mod)
            out[name + "_device"] = self.run(port, spec, mask, True,
                                             monkeypatch)
            deltas[name] = _delta(_counts(mod), c0)
            out[name + "_host"] = self.run(port, spec, mask, False,
                                           monkeypatch)
        return out, deltas


@pytest.fixture
def cpu_engine(monkeypatch):
    """A fresh engine registry for the test, and the engine of the CPU,
    which the port's leaves (on the CPU) select: its K8 wrapper runs the
    plain version. Nothing picks the CPU on its own."""
    monkeypatch.setattr(port_dev, "_ENGINES", {})
    return port_dev.default_engine("cpu")


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.svc.close()


@pytest.fixture(scope="module")
def module_engine():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_dev, "_ENGINES", {})
        yield port_dev.default_engine("cpu")


@pytest.fixture(autouse=True)
def _no_faults():
    ref_faults.clear()
    yield
    ref_faults.clear()


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("body", sorted(BODIES))
def test_four_routes_equal(pair, module_engine, monkeypatch, body, mask):
    out, deltas = pair.four(BODIES[body], pair.masks[mask], monkeypatch)
    want = out["ref_host"]
    for route in ("port_device", "port_host", "ref_device"):
        assert out[route] == want, route
    assert deltas["port"] == deltas["ref"]
    n_aggs = len(BODIES[body])
    assert deltas["port"]["agg_queries"] == n_aggs
    assert deltas["port"]["agg_device_dispatches"] == n_aggs
    assert deltas["port"]["agg_host_fallbacks"] == 0
    if mask == "empty":
        for name, res in want.items():
            if "tags" in name:
                assert res["buckets"] == []
    else:
        assert any(b["doc_count"] for r in want.values()
                   for b in r["buckets"])


def test_device_route_reaches_the_k8_wrapper(pair, module_engine,
                                              monkeypatch):
    """The device route runs K8's plain version through the wrapper (no
    CUDA launch on the CPU), once per dispatch."""
    from elasticsearch_tpu_torch.parallel import kernels

    calls = []
    real = kernels.agg_two_level_counts_plain
    monkeypatch.setattr(kernels, "agg_two_level_counts_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kernels.reset_launches()
    out = pair.run(True, BODIES["terms_stats"], pair.masks["p20"], True,
                   monkeypatch)
    assert calls == [1] and kernels.LAUNCHES["agg_counts"] == 0
    assert out == pair.run(False, BODIES["terms_stats"], pair.masks["p20"],
                           False, monkeypatch)


def test_coalesced_batch_equals_single_works(pair, module_engine,
                                             monkeypatch):
    """Several works on one layout in one search_many call (a batch padded
    to the 4 rung) equal the same works dispatched one by one."""
    pair.run(True, BODIES["terms_stats"], pair.masks["p05"], True,
             monkeypatch)                                  # builds the layout
    lay = next(v for k, v in pair.port_seg._device.items()
               if k.startswith("aggdev:termsm:"))
    kc = pair.port_seg.keyword["tag"]
    sels = [pair.masks[m] & kc.exists for m in ("p05", "p20", "p90")]
    works = [port_dev._AggWork(lay, s) for s in sels]
    res = module_engine.search_many([works], 1)
    assert len(res) == 1 and res[0][0].shape == (3, 1) and not res[0][0].any()
    for w, s in zip(works, sels):
        one = port_dev._AggWork(lay, s)
        module_engine.search_many([[one]], 1)
        assert w.error is None and one.error is None
        assert all(np.array_equal(a, b) for a, b in zip(w.result, one.result))


# ---------------------------------------------------------------------------
# fallback, A/B, faults, ledger (the reference suite's counterparts)
# ---------------------------------------------------------------------------


def test_over_budget_layouts_fall_back_to_host(cpu_engine, monkeypatch):
    """ES_TPU_AGG_HBM_FRAC=0 refuses every layout in both packages: the
    host aggregators serve (identical responses), counted as fallbacks."""
    monkeypatch.setenv("ES_TPU_AGG_HBM_FRAC", "0.0")
    p = Pair(n=1200, seed=11)
    spec = BODIES["terms_default"]
    out, deltas = p.four(spec, p.live, monkeypatch)
    assert all(v == out["ref_host"] for v in out.values())
    assert deltas["port"] == deltas["ref"]
    assert deltas["port"]["agg_host_fallbacks"] > 0
    assert deltas["port"]["agg_device_dispatches"] == 0
    assert deltas["port"]["agg_bytes"] == 0
    assert cpu_engine.hbm_bytes() == 0 == cpu_engine.ledger_bytes()
    p.svc.close()


def test_agg_flag_off_restores_host_path_verbatim(cpu_engine, monkeypatch):
    p = Pair(n=1500, seed=3)
    spec = BODIES["terms_stats"]
    on = {port: p.run(port, spec, p.live, True, monkeypatch)
          for port in (True, False)}
    assert on[True] == on[False]

    monkeypatch.setenv("ES_TPU_AGG", "0")
    assert not knob("ES_TPU_AGG")
    for port, mod in ((True, port_dev), (False, ref_dev)):
        before = _counts(mod)
        off = p.run(port, spec, p.live, True, monkeypatch)
        assert _counts(mod) == before      # no device counter moves
        assert off == on[port]

    monkeypatch.delenv("ES_TPU_AGG")
    for port, mod in ((True, port_dev), (False, ref_dev)):
        before = _counts(mod)
        assert p.run(port, spec, p.live, True, monkeypatch) == on[port]
        assert _counts(mod)["agg_queries"] == before["agg_queries"] + 1
    p.svc.close()


def test_agg_reduce_fault_contained_with_host_fallback(cpu_engine,
                                                       monkeypatch):
    """An injected agg_reduce fault poisons only that dispatch, in both
    packages: the collect falls back to the host aggregator with an
    identical response, and the next dispatch runs on the device again."""
    p = Pair(n=1500, seed=5)
    spec = BODIES["terms_default"]
    want = {port: p.run(port, spec, p.live, True, monkeypatch)
            for port in (True, False)}                 # builds the layouts
    assert want[True] == want[False]
    engines = ((True, port_dev, port_faults, cpu_engine),
               (False, ref_dev, ref_faults, ref_dev.default_engine()))
    for port, mod, flt, eng in engines:
        serials = [s for n, s in eng.layout_serials().items()
                   if n.endswith("_terms")]
        assert serials
        before = _counts(mod)
        with flt.inject(f"agg_reduce#{max(serials)}:raise@1"):
            got = p.run(port, spec, p.live, True, monkeypatch)
        assert got == want[port]
        d = _delta(_counts(mod), before)
        assert d == {"agg_queries": 0, "agg_device_dispatches": 1,
                     "agg_host_fallbacks": 1, "agg_bytes": 0}

        before = _counts(mod)
        assert p.run(port, spec, p.live, True, monkeypatch) == want[port]
        assert _delta(_counts(mod), before) == {
            "agg_queries": 1, "agg_device_dispatches": 1,
            "agg_host_fallbacks": 0, "agg_bytes": 0}
    p.svc.close()


@pytest.mark.parametrize("exc, contained", [
    (KernelLaunchError("agg_counts: launch refused"), False),
    (ValueError("agg_counts: blob length"), False),
    (TypeError("agg_counts: mask dtype"), False),
    (torch.OutOfMemoryError("agg_counts: CUDA out of memory. Tried to "
                            "allocate 2.00 GiB"), True),
    (RuntimeError("agg_counts: CUDA error: an illegal memory access"),
     False),
])
def test_only_device_faults_are_contained(cpu_engine, monkeypatch, exc,
                                          contained):
    """A refused launch or a wrapper's check propagates out of the collect
    and is never served around by the host aggregators, nor is a CUDA
    error without a device-fault marker; CUDA OOM (which becomes
    HbmOomError) falls back to host."""
    from elasticsearch_tpu_torch.parallel import kernels

    p = Pair(n=1200, seed=29)
    spec = BODIES["terms_default"]
    want = p.run(True, spec, p.live, True, monkeypatch)   # builds the layout

    def refuse(*a, **kw):
        raise exc

    monkeypatch.setattr(kernels, "agg_segment_counts", refuse)
    before = _counts(port_dev)
    if contained:
        assert p.run(True, spec, p.live, True, monkeypatch) == want
        assert _delta(_counts(port_dev), before)["agg_host_fallbacks"] == 1
    else:
        with pytest.raises(type(exc), match="agg_counts"):
            p.run(True, spec, p.live, True, monkeypatch)
        assert _delta(_counts(port_dev), before)["agg_host_fallbacks"] == 0
    p.svc.close()


def test_ledger_reconciles_and_knobs_declared(cpu_engine, monkeypatch):
    """The ledger's agg engine bytes == the engine's own accounting == the
    tpu_agg stats section; the knobs carry the reference's defaults."""
    assert knob("ES_TPU_AGG") is True
    assert knob("ES_TPU_AGG_HBM_FRAC") == 0.25
    p = Pair(n=1200, seed=19)
    spec = BODIES["terms_and_histogram_4"]
    before = _counts(port_dev)
    assert p.run(True, spec, p.live, True, monkeypatch) == p.run(
        False, spec, p.live, True, monkeypatch)
    assert cpu_engine.hbm_bytes() > 0
    assert cpu_engine.hbm_bytes() == cpu_engine.ledger_bytes()
    assert _delta(_counts(port_dev), before)["agg_bytes"] == \
        cpu_engine.hbm_bytes()
    stats = port_dev.agg_stats()
    assert stats["hbm_bytes"] == cpu_engine.hbm_bytes()
    assert stats["layouts"] == 2 and stats["enabled"] is True
    for key in COUNTERS:
        assert key in stats
    p.svc.close()


def test_dropped_leaf_releases_its_ledger_regions(cpu_engine, monkeypatch):
    """A layout's region leaves the ledger with the segment cache that
    holds it (the weakref finalizer)."""
    import gc

    p = Pair(n=1200, seed=23)
    p.run(True, BODIES["terms_stats"], p.live, True, monkeypatch)
    assert cpu_engine.hbm_bytes() > 0
    p.port_seg._device.clear()
    gc.collect()
    assert cpu_engine.hbm_bytes() == 0 == cpu_engine.ledger_bytes()
    p.svc.close()


def test_layout_docs_are_range_checked_once():
    with pytest.raises(ValueError, match="outside"):
        port_dev._pack_pairs(np.array([0, 5], np.int32),
                             np.array([1, 1], np.int32), 5)
    d, s, ct0, ct1 = port_dev._pack_pairs(np.array([4, 2], np.int32),
                                          np.array([3, 20000], np.int32), 5)
    assert len(d) == 1024 and (s[2:] == -1).all() and (d[2:] == 0).all()
    assert (int(ct0[0]), int(ct1[0])) == (0, 1)


# ---------------------------------------------------------------------------
# the rest of the copied aggregations.py, on the host path
# ---------------------------------------------------------------------------

HOST_BODIES = {
    "range": {"r": {"range": {"field": "price", "ranges": [
        {"to": 30.0}, {"from": 30.0, "to": 45.5}, {"from": 45.5}]},
        "aggs": {"s": {"sum": {"field": "price"}}}}},
    # a string bound needs a key: the default key is float(bound) in both
    # packages (ROADMAP W12)
    "date_range": {"r": {"date_range": {"field": "ts", "ranges": [
        {"to": "2020-10-01", "key": "early"},
        {"from": "2020-10-01", "to": BASE_MS + 40 * 86_400_000, "key": "mid"},
        {"from": BASE_MS + 40 * 86_400_000}]}}},
    "missing": {"m": {"missing": {"field": "price"},
                      "aggs": {"t": {"terms": {"field": "tag"}}}}},
    "global": {"g": {"global": {}, "aggs": {"mx": {"max": {"field": "price"}},
                                            "c": {"value_count": {
                                                "field": "tag"}}}}},
    "cardinality": {"ct": {"cardinality": {"field": "tag"}},
                    "cp": {"cardinality": {"field": "price"}}},
    "percentiles": {"pc": {"percentiles": {"field": "price"}},
                    "pr": {"percentile_ranks": {"field": "price",
                                                "values": [30, 40.5]}},
                    "mad": {"median_absolute_deviation": {"field": "price"}}},
    "composite": {"c": {"composite": {"size": 7, "sources": [
        {"t": {"terms": {"field": "tag"}}},
        {"w": {"date_histogram": {"field": "ts", "fixed_interval": "30d"}}}],
        "after": {"t": "t12", "w": 0}},
        "aggs": {"a": {"avg": {"field": "price"}}}}},
    "top_hits": {"t": {"terms": {"field": "tag", "size": 3},
                       "aggs": {"top": {"top_hits": {
                           "size": 2, "sort": [{"price": {"order": "desc"}}]}},
                                "first": {"top_hits": {"size": 1}}}}},
    "derivative_cumulative_sum": {"d": {
        "date_histogram": {"field": "ts", "fixed_interval": "7d"},
        "aggs": {"s": {"sum": {"field": "price"}},
                 "der": {"derivative": {"buckets_path": "s"}},
                 "cum": {"cumulative_sum": {"buckets_path": "s"}}}},
        "tot": {"sum_bucket": {"buckets_path": "d>s"}},
        "mx": {"max_bucket": {"buckets_path": "d>s"}}},
    "bucket_script_selector": {"t": {
        "terms": {"field": "tag", "size": 40},
        "aggs": {"s": {"sum": {"field": "price"}},
                 "n": {"value_count": {"field": "price"}},
                 "mean": {"bucket_script": {
                     "buckets_path": {"s": "s", "n": "n"},
                     "script": "s / n"}},
                 "keep": {"bucket_selector": {
                     "buckets_path": {"c": "_count"},
                     "script": {"source": "c > params['lim']",
                                "params": {"lim": 60}}}}}}},
}


@pytest.mark.parametrize("mask", ("p20", "p90", "empty"))
@pytest.mark.parametrize("body", sorted(HOST_BODIES))
def test_host_aggregations_equal(pair, module_engine, monkeypatch, body,
                                 mask):
    spec = HOST_BODIES[body]
    m = pair.masks[mask]
    got = pair.run(True, spec, m, False, monkeypatch)
    assert got == pair.run(False, spec, m, False, monkeypatch)
    if mask == "p90":
        assert got and all(v for v in got.values())


def test_date_range_string_bound_without_key_raises_in_both(pair,
                                                            monkeypatch):
    spec = {"r": {"date_range": {"field": "ts",
                                 "ranges": [{"to": "2020-10-01"}]}}}
    for port in (True, False):
        with pytest.raises(ValueError, match="could not convert"):
            pair.run(port, spec, pair.live, False, monkeypatch)
