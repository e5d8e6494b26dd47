"""tests/test_integrity.py on both packages, and the scrub regions of the
port's kNN and agg engines against the reference's, on the CPU.

The reference's integrity cases run through `torch_cluster_twin`: each
runs on the reference, then from its source on the port (`device="cpu"`),
under the reference's assertions; the final cluster states, engine
histories and search answers of the two runs are compared, and so are the
`tpu_integrity` counters at the end of each run (`observe`). Among them
are the two `test_check_on_startup_*` cases: with ES_TPU_CHECK_ON_STARTUP
the startup scan catches an injected `segment_read` flip before the copy
reports started, and with the knob off it never looks. The Turbo scrub
cases (`test_hbm_scrub_*`, `test_scrub_baseline_*`) are twinned in
tests/test_torch_turbo_sharded.py and are skipped here.

Beside them:

* the kNN twin of tests/test_knn_quantized.py's
  `test_knn_scrub_bitflip_repair`. The reference fails its own version
  (ROADMAP W1: its answers are held to a gemm summed in another order),
  so the port's repaired answers are held bitwise to the port's pre-flip
  answers, and to the reference engine's ords and partitions with scores
  within 2 ulp; mismatch and repair counts and region names are equal;
* the agg twin of tests/test_agg_device.py's
  `test_hbm_scrub_repairs_flipped_agg_column`, both packages, responses
  equal before and after the repair;
* in-place flips of the port's device tensors (what the injected flip
  stands for), found and repaired;
* `_host_bytes` on a tensor whose `__array__` raises, as a CUDA tensor's
  does: the scrubber copies a tensor down itself.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common import faults as ref_faults
from elasticsearch_tpu.common import integrity as ref_integrity
from elasticsearch_tpu.parallel import knn as ref_knn
from elasticsearch_tpu.search import agg_device as ref_dev
from elasticsearch_tpu_torch.common import faults, integrity
from elasticsearch_tpu_torch.common.health import EngineHealth
from elasticsearch_tpu_torch.parallel import knn
from elasticsearch_tpu_torch.search import agg_device as port_dev
from test_knn_quantized import _cols, _queries
from test_torch_agg import BODIES, Pair
from test_torch_knn import _assert_close, _port_cols
from torch_cluster_twin import twin_suite

torch.set_num_threads(1)

K = 10
TURBO_CASES = ("test_hbm_scrub_detects_and_repairs_injected_flip",
               "test_hbm_scrub_repairs_real_device_corruption",
               "test_scrub_baseline_regions_track_legitimate_updates")


def _observe_integrity(mod, mp, observed):
    observed["tpu_integrity"] = lambda: mod.integrity.integrity_stats()


twin_suite("integrity", globals(), skip=TURBO_CASES,
           observe=_observe_integrity)

PACKAGES = ((False, ref_integrity, ref_faults), (True, integrity, faults))


@pytest.fixture
def clean_scrub():
    for m in (integrity, ref_integrity):
        m.reset_for_tests()
        m.reset_scrub_for_tests()
    yield
    for m in (integrity, ref_integrity):
        m.reset_for_tests()
        m.reset_scrub_for_tests()
    faults.clear()
    ref_faults.clear()


def _cycle(m):
    return [m.scrub_once() for _ in range(m.scrub_registry_size())]


def _scrub_counts(m):
    st = m.integrity_stats()
    return {x: st[x] for x in ("scrub_ticks", "scrub_clean",
                               "scrub_baselined", "scrub_mismatches",
                               "scrub_repairs", "scrub_regions")}


def _flip_in_place(t: torch.Tensor) -> None:
    """One bit of the tensor's middle byte flipped where it lies, as rot
    in device memory would (integrity.bitflip's byte)."""
    b = t.view(-1).view(torch.uint8)
    mid = b.numel() // 2
    b[mid] ^= 1


# ---------------------------------------------------------------------------
# kNN: knn_shards, knn_meta, knn_centroids
# ---------------------------------------------------------------------------


def test_knn_scrub_bitflip_repair(clean_scrub):
    """tests/test_knn_quantized.py's case on both packages: a full cycle is
    clean, an injected hbm_region flip on knn_shards is found once and
    repaired, the repaired engine answers as before, and the next cycle is
    clean again."""
    cols = _cols([1800, 1300], seed=47)
    qs = _queries(10, seed=25)
    out = {}
    for port, m, fm in PACKAGES:
        mod = knn if port else ref_knn
        eng = (knn.KnnEngine(_port_cols(cols), device="cpu") if port
               else ref_knn.KnnEngine(cols))
        works = [[mod.KnnWork(q) for q in qs]]
        pre = eng.search_many(works, k=K)[0]
        first = _cycle(m)
        assert {r["result"] for r in first} == {"clean"}
        with fm.inject("hbm_region#knn_shards:raise@1x1"):
            results = _cycle(m)
        hit = [r for r in results if r and r["result"] == "mismatch"]
        assert len(hit) == 1 and hit[0]["region"].endswith(".knn_shards")
        assert hit[0]["repaired"] is True
        post = eng.search_many(works, k=K)[0]
        _cycle(m)
        out[port] = dict(pre=pre, post=post, counts=_scrub_counts(m),
                         regions=sorted(r["region"] for r in first),
                         health=eng.health.counters["device_faults"])
    p, r = out[True], out[False]
    for g, w in zip(p["post"], p["pre"]):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    _assert_close(p["post"], r["post"], "repaired port vs reference")
    _assert_close(p["pre"], r["pre"], "pre-flip port vs reference")
    assert p["counts"] == r["counts"]
    assert p["counts"]["scrub_mismatches"] == 1
    assert p["counts"]["scrub_repairs"] == 1
    assert p["regions"] == r["regions"] == [
        "KnnEngine.knn_centroids", "KnnEngine.knn_meta",
        "KnnEngine.knn_shards"]
    assert p["health"] == r["health"] == 1


@pytest.mark.parametrize("region, attr", [
    ("knn_shards", "d_q8"), ("knn_meta", "d_meta"),
    ("knn_centroids", "d_cent")])
def test_knn_in_place_flip_found_and_repaired(clean_scrub, region, attr):
    """A bit flipped in the port's device tensor itself (no injection) is
    found against the host copy and uploaded again; the answers are
    bitwise those before the flip."""
    cols = _cols([4200, 1300], seed=31)      # 4200 rows: k-means centroids
    qs = _queries(8, seed=11)
    eng = knn.KnnEngine(_port_cols(cols), stacked=True, device="cpu")
    works = [[knn.KnnWork(q) for q in qs]]
    want = eng.search_many(works, k=K)[0]
    good = getattr(eng, attr).clone()
    _flip_in_place(getattr(eng, attr))
    assert not torch.equal(getattr(eng, attr), good)
    outcomes = {r["region"]: r for r in integrity.scrub_owner(eng)}
    assert outcomes[f"KnnEngine.{region}"]["result"] == "mismatch"
    assert {o["result"] for n, o in outcomes.items()
            if n != f"KnnEngine.{region}"} == {"clean"}
    assert torch.equal(getattr(eng, attr), good)
    got = eng.search_many(works, k=K)[0]
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert {r["result"] for r in integrity.scrub_owner(eng)} == {"clean"}


def test_knn_set_live_keeps_the_host_copy(clean_scrub):
    """A delete moves the live row of the host meta with the device one,
    so the next scrub is clean, not a false mismatch."""
    cols = _cols([2000], seed=5)
    eng = knn.KnnEngine(_port_cols(cols), device="cpu")
    live = np.ones(2000, bool)
    live[::7] = False
    eng.set_live(0, live)
    assert {r["result"] for r in integrity.scrub_owner(eng)} == {"clean"}


def test_knn_scrub_trips_health_after_trip_n(clean_scrub, monkeypatch):
    """ES_TPU_HEALTH_TRIP_N scrub mismatches in a row open the kNN
    engine's circuit, as dispatch faults do; after the backoff the probe
    (a clean scrub) closes it."""
    monkeypatch.setenv("ES_TPU_HEALTH_TRIP_N", "2")
    monkeypatch.setenv("ES_TPU_HEALTH_BACKOFF_MS", "1")
    eng = knn.KnnEngine(_port_cols(_cols([1500], seed=3)), device="cpu")
    assert (eng.health.trip_n, eng.health.base_backoff_ms) == (2, 1)
    with faults.inject("hbm_region:raise@1x2"):   # the first two regions
        res = integrity.scrub_owner(eng)
    assert [r["result"] for r in res] == ["mismatch", "mismatch", "clean"]
    assert eng.health.state == "open"
    import time

    time.sleep(0.005)
    assert eng.health.allow_device()            # the half-open probe
    integrity.scrub_owner(eng)
    assert eng.health.state == "closed"
    assert list(eng.health._transitions) == [
        "closed->open", "open->half_open", "half_open->closed"]


# ---------------------------------------------------------------------------
# agg layouts: one region per layout
# ---------------------------------------------------------------------------


@pytest.fixture
def agg_engine(monkeypatch):
    monkeypatch.setattr(port_dev, "_ENGINES", {})
    return port_dev.default_engine("cpu")


def test_hbm_scrub_repairs_flipped_agg_column(clean_scrub, agg_engine,
                                             monkeypatch):
    """tests/test_agg_device.py's case on both packages: the newest terms
    layout's region, flipped by an injected hbm_region clause, is found
    once and repaired, and the repaired column serves the same response;
    counts and region names equal."""
    p = Pair(n=1500, seed=13)
    spec = BODIES["terms_default"]
    engines = {True: agg_engine, False: ref_dev.default_engine()}
    out = {}
    try:
        for port, m, fm in PACKAGES:
            want = p.run(port, spec, p.live, True, monkeypatch)
            eng = engines[port]
            serials = eng.layout_serials()
            region = max((n for n in serials if n.endswith("_terms")),
                         key=serials.get)
            with fm.inject(f"hbm_region#{region}:raise@1x1"):
                results = _cycle(m)
            hit = [r for r in results if r and r["result"] == "mismatch"]
            assert len(hit) == 1 and hit[0]["region"].endswith(region)
            assert m.integrity_stats()["scrub_repairs"] == 1
            got = p.run(port, spec, p.live, True, monkeypatch)
            assert got == want
            out[port] = dict(want=want, counts=_scrub_counts(m),
                             results=sorted(r["result"] for r in results),
                             kind=hit[0]["region"].split(".")[0])
    finally:
        p.svc.close()
    assert out[True]["want"] == out[False]["want"]
    assert out[True]["counts"] == out[False]["counts"]
    assert out[True]["results"] == out[False]["results"]
    assert out[True]["kind"] == out[False]["kind"] == "_AggLayout"


def test_agg_in_place_flip_found_and_repaired(clean_scrub, agg_engine,
                                             monkeypatch):
    p = Pair(n=1200, seed=17)
    spec = BODIES["terms_stats"]
    try:
        want = p.run(True, spec, p.live, True, monkeypatch)
        (layout,) = [lay for lay in agg_engine._live.values()
                     if lay.kind == "terms_metric"]
        good = layout.dev.clone()
        _flip_in_place(layout.dev)
        res = integrity.scrub_owner(layout)
        assert [r["result"] for r in res] == ["mismatch"]
        assert res[0]["bytes"] == layout.nbytes
        assert torch.equal(layout.dev, good)
        assert p.run(True, spec, p.live, True, monkeypatch) == want
    finally:
        p.svc.close()


# ---------------------------------------------------------------------------
# the scrubber reads a tensor without np.asarray
# ---------------------------------------------------------------------------


class _NoArray(torch.Tensor):
    """A tensor that refuses numpy's array protocol, as a CUDA tensor
    does."""

    def __array__(self, *a, **kw):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")


class _Owner:
    def __init__(self, host):
        self.host = host
        self.dev = torch.from_numpy(host.copy()).as_subclass(_NoArray)
        self.health = EngineHealth("stub", trip_n=1, backoff_ms=10)

    def repair(self):
        self.dev = torch.from_numpy(self.host.copy()).as_subclass(_NoArray)


def test_host_bytes_takes_a_tensor_without_asarray(clean_scrub):
    host = np.arange(4096, dtype=np.int32)
    o = _Owner(host)
    with pytest.raises(TypeError):
        np.asarray(o.dev)
    integrity.register_scrub_region(o, "stub", lambda x: x.dev,
                                    expected=lambda x: x.host,
                                    repair=lambda x: x.repair())
    integrity.attach_scrub_health(o, o.health)
    assert integrity._host_bytes(o.dev).tobytes() == host.tobytes()
    assert integrity.scrub_once() == {"region": "_Owner.stub",
                                      "result": "clean"}
    _flip_in_place(o.dev)
    out = integrity.scrub_once()
    assert out["result"] == "mismatch" and out["repaired"] is True
    assert torch.equal(o.dev, torch.from_numpy(host))
    assert integrity.integrity_stats()["scrub_repaired_bytes"] == \
        host.nbytes
    assert o.health.state == "open"
    (cycle,) = integrity.scrub_owner(o)
    assert cycle["result"] == "clean" and cycle["bytes"] == host.nbytes
    assert cycle["seconds"] >= 0.0
