"""Port KnnEngine vs the reference KnnEngine, on the CPU.

The same seeded columns and queries (the helpers of test_knn_quantized.py)
go through both packages: the reference with its Pallas kernels in
interpret mode, the port with its kernels' plain torch versions
(device="cpu"). K9's candidate sets are bitwise the reference's
(test_torch_kernels.py), so both engines rescore the same candidates and
certify the same queries. The rescore and dense gemms sum in torch's order,
not XLA's (ROADMAP W1, W2), so the contract is:

- ords and partitions identical to the reference engine's;
- scores within SCORE_ULPS units in the last place of the reference's:
  W1 measured at most 2 ulp between XLA's own gemm shapes, and torch's
  48-d bf16 products summed in another order land as close;
- knn_node_stats() counters equal in both packages.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common import faults as ref_faults
from elasticsearch_tpu.index.segment import (
    build_field_postings as ref_build_postings,
)
from elasticsearch_tpu.mapper.mapper_service import MapperService as RefMapper
from elasticsearch_tpu.parallel import knn as ref_knn
from elasticsearch_tpu.parallel.spmd import make_mesh
from elasticsearch_tpu.search import serving as ref_serving
from elasticsearch_tpu_torch.common import faults
from elasticsearch_tpu_torch.index.segment import (
    VectorColumn, build_field_postings,
)
from elasticsearch_tpu_torch.mapper import MapperService
from elasticsearch_tpu_torch.parallel import knn
from elasticsearch_tpu_torch.search import serving
from test_knn_quantized import _cols, _queries

torch.set_num_threads(1)

K = 10
SCORE_ULPS = 2
COUNTERS = ("knn_queries", "knn_int8_dispatches", "knn_rescore_docs",
            "knn_host_fallbacks", "knn_uncertified", "knn_bytes")


def _port_cols(cols):
    return [VectorColumn(c.vectors, c.norms, c.exists, c.dims, c.similarity)
            for c in cols]


def _reset():
    ref_knn.reset_for_tests()
    knn.reset_for_tests()


def _run(cols, qs, *, filters=None, mesh=None, stacked=False, k=K,
         ref_engine=None):
    """Both engines on the same queries; counters reset before each."""
    _reset()
    ref = ref_engine or ref_knn.KnnEngine(cols, mesh=mesh)
    want = ref.search_many(
        [[ref_knn.KnnWork(q, filters=filters) for q in qs]], k=k)[0]
    ref_counts = {c: ref_knn.knn_node_stats()[c] for c in COUNTERS}
    port = knn.KnnEngine(_port_cols(cols), stacked=stacked, device="cpu")
    got = port.search_many(
        [[knn.KnnWork(q, filters=filters) for q in qs]], k=k)[0]
    port_counts = {c: knn.knn_node_stats()[c] for c in COUNTERS}
    return got, want, port, port_counts, ref_counts


def _assert_close(got, want, label):
    gs, gp, go = (np.asarray(a) for a in got)
    ws, wp, wo = (np.asarray(a) for a in want)
    assert np.array_equal(go, wo), f"{label}: ords differ"
    assert np.array_equal(gp, wp), f"{label}: partitions differ"
    assert np.array_equal(gs > 0, ws > 0), f"{label}: empty slots differ"
    tol = SCORE_ULPS * np.spacing(np.abs(ws).astype(np.float32))
    assert (np.abs(gs - ws) <= tol).all(), \
        f"{label}: scores beyond {SCORE_ULPS} ulp"


def _assert_counters(port_counts, ref_counts, skip=()):
    for c in COUNTERS:
        if c not in skip:
            assert port_counts[c] == ref_counts[c], \
                f"{c}: port {port_counts[c]} vs reference {ref_counts[c]}"


@pytest.mark.parametrize("similarity", ["cosine", "dot_product", "l2_norm"])
def test_solo_matches_reference(similarity):
    unit = similarity == "dot_product"      # ES contract: unit vectors
    cols = _cols([3000], similarity=similarity, unit=unit)
    qs = _queries(20, unit=unit)
    got, want, _, pc, rc = _run(cols, qs)
    _assert_close(got, want, f"solo {similarity}")
    _assert_counters(pc, rc)
    assert pc["knn_int8_dispatches"] > 0 and pc["knn_host_fallbacks"] == 0


def test_unstacked_two_partitions():
    cols = _cols([2200, 1600], seed=23)
    qs = _queries(16, seed=9)
    got, want, port, pc, rc = _run(cols, qs)
    assert not port.stats()["fused"]
    _assert_close(got, want, "unstacked S=2")
    _assert_counters(pc, rc)
    assert set(np.asarray(got[1]).ravel()) == {0, 1}


def test_stacked_three_partitions_vs_fused_mesh():
    """S = 3 stacked on one device against the reference's fused engine on
    the 4-device CPU mesh, 40 queries straddling two qc rungs. The
    reference pads its stack to the mesh (4 partitions), so its knn_bytes
    count one more partition."""
    cols = _cols([2500, 1800, 2100], seed=17)
    qs = _queries(40, seed=5)
    got, want, port, pc, rc = _run(cols, qs, mesh=make_mesh(4, dp=1),
                                   stacked=True)
    assert port.stats()["fused"] == 1 and port.d_q8.shape[0] == 3
    _assert_close(got, want, "stacked S=3")
    _assert_counters(pc, rc, skip=("knn_bytes",))


def test_filtered():
    cols = _cols([2400, 1900], seed=29)
    qs = _queries(12, seed=13)
    rng = np.random.default_rng(41)
    masks = [rng.random(len(c.vectors)) > 0.6 for c in cols]
    got, want, _, pc, rc = _run(cols, qs, filters=masks)
    _assert_close(got, want, "filtered")
    _assert_counters(pc, rc)
    for s, p, o in zip(*(np.asarray(a) for a in got)):
        assert all(masks[pi][oi] for si, pi, oi in zip(s, p, o) if si > 0)


def test_filtered_stacked_selective():
    """A 2% filter on stacked partitions: K9's masked variant in one
    launch."""
    cols = _cols([2100, 2300], seed=31)
    qs = _queries(10, seed=15)
    rng = np.random.default_rng(43)
    masks = [rng.random(len(c.vectors)) < 0.02 for c in cols]
    got, want, _, pc, rc = _run(cols, qs, filters=masks,
                                mesh=make_mesh(2, dp=1), stacked=True)
    _assert_close(got, want, "filtered stacked 2%")
    _assert_counters(pc, rc)


def test_int8_off_ab(monkeypatch):
    """ES_TPU_KNN_INT8=0: the dense route in both packages, the same ids
    as the int8 route, no int8 dispatch."""
    cols = _cols([2200, 1600], seed=23)
    qs = _queries(16, seed=9)
    on, _, _, _, _ = _run(cols, qs)
    monkeypatch.setenv("ES_TPU_KNN_INT8", "0")
    got, want, port, pc, rc = _run(cols, qs)
    _assert_close(got, want, "int8 off")
    _assert_close(on, want, "int8 on vs off")
    _assert_counters(pc, rc)
    assert pc["knn_int8_dispatches"] == 0 and pc["knn_queries"] == 16
    assert port._hbm.total_bytes() == port.hbm_bytes()
    assert port.stats()["hbm_bytes"] == port.hbm_bytes()


def test_set_live_deletes():
    """Docs deleted through set_live (the first query's hits on partition
    0) leave both packages' answers alike."""
    cols = _cols([2200, 1600], seed=23)
    qs = _queries(6, seed=9)
    ref = ref_knn.KnnEngine(cols)
    port = knn.KnnEngine(_port_cols(cols), device="cpu")
    s, p, o = port.search_many([[knn.KnnWork(q) for q in qs]], k=K)[0]
    live = np.ones(2200, bool)
    live[o[0][(p[0] == 0) & (s[0] > 0)]] = False
    assert not live.all()
    ref.set_live(0, live)
    port.set_live(0, live)
    want = ref.search_many([[ref_knn.KnnWork(q) for q in qs]], k=K)[0]
    got = port.search_many([[knn.KnnWork(q) for q in qs]], k=K)[0]
    _assert_close(got, want, "set_live")
    gs, gp, go = got
    assert live[go[(gp == 0) & (gs > 0)]].all()


@pytest.fixture(scope="module")
def ivf_case():
    cols = _cols([9000], seed=37)
    qs = _queries(32, seed=19)
    return cols, qs, ref_knn.KnnEngine(cols)


def test_ivf_nprobe_zero_exact(ivf_case):
    cols, qs, ref = ivf_case
    got, want, port, pc, rc = _run(cols, qs, ref_engine=ref)
    assert int(port.d_cvalid[0].sum()) > 1, "IVF never built at n=9000"
    _assert_close(got, want, "ivf nprobe=0")
    _assert_counters(pc, rc, skip=("knn_bytes",))


def test_ivf_nprobe_24_recall(ivf_case, monkeypatch):
    """At nprobe = 24 both packages keep recall@10 >= 0.99 against the
    exact answers (centroid scores are an f32 gemm in both, so a probe on a
    near-tie may differ: recall, not ids, is the contract here)."""
    cols, qs, ref = ivf_case
    exact, _, _, _, _ = _run(cols, qs, ref_engine=ref)
    monkeypatch.setenv("ES_TPU_KNN_NPROBE", "24")
    got, want, _, _, _ = _run(cols, qs, ref_engine=ref)
    for label, res in (("port", got), ("reference", want)):
        hits = total = 0
        for qi in range(len(qs)):
            truth = {(p, o) for s, p, o in zip(*(np.asarray(a)[qi]
                                                 for a in exact)) if s > 0}
            found = {(p, o) for s, p, o in zip(*(np.asarray(a)[qi]
                                                 for a in res)) if s > 0}
            hits += len(truth & found)
            total += len(truth)
        assert total > 0 and hits / total >= 0.99, \
            f"{label}: IVF recall@10 {hits / total:.4f} < 0.99 at nprobe=24"


def test_knn_score_fault_contained():
    """An injected knn_score fault on partition 1 (the per-partition solo
    route) is contained in both packages: only partition 1 is recorded,
    and its host-exact f64 answers are the same numpy code in both."""
    cols = _cols([1500, 1200, 1400], seed=43)
    qs = _queries(8, seed=21)
    _reset()
    ref = ref_knn.KnnEngine(cols)
    rlog = []
    with ref_faults.inject("knn_score#1:raise@1"):
        want = ref.search_many([[ref_knn.KnnWork(q) for q in qs]], k=K,
                               fault_log=rlog)[0]
    port = knn.KnnEngine(_port_cols(cols), device="cpu")
    plog = []
    with faults.inject("knn_score#1:raise@1"):
        got = port.search_many([[knn.KnnWork(q) for q in qs]], k=K,
                               fault_log=plog)[0]
    assert plog and all(r.partition == 1 and r.site == "knn_score"
                        and r.recovered for r in plog)
    assert len(plog) == len(rlog)
    _assert_close(got, want, "knn_score#1 fault")
    assert knn.knn_node_stats()["knn_host_fallbacks"] \
        == ref_knn.knn_node_stats()["knn_host_fallbacks"] == len(qs)
    assert port.stats()["health_device_faults"] == 1


def _planted(n, dims, n_q, seed):
    """Rows N(0, 1) with 6 near-copies of each query (cos about 0.95)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, dims)).astype(np.float32)
    q = rng.standard_normal((n_q, dims)).astype(np.float32)
    at = rng.choice(n, size=(n_q, 6), replace=False)
    for i in range(n_q):
        noise = rng.standard_normal((6, dims)).astype(np.float32)
        v[at[i]] = q[i] + 0.33 * np.linalg.norm(q[i]) / np.sqrt(dims) * noise
    col = SimpleNamespace(vectors=v,
                          norms=np.linalg.norm(v, axis=1).astype(np.float32),
                          exists=np.ones(n, bool), dims=dims,
                          similarity="cosine")
    return [col], q


@pytest.mark.parametrize("planted", [True, False])
def test_certificate_planted_and_gaussian(planted, monkeypatch):
    """Planted near-duplicates: both packages certify every query. Gaussian
    rows with the over-fetch cut to k (ES_TPU_KNN_RESCORE_MULT=1): the
    first dropped candidate's optimistic score lies above the 10th exact
    score, so both send every query to the dense route."""
    if planted:
        cols, qs = _planted(6000, 48, 12, seed=71)
    else:
        monkeypatch.setenv("ES_TPU_KNN_RESCORE_MULT", "1")
        cols = _cols([6000], seed=73)
        qs = _queries(12, seed=75)
    got, want, _, pc, rc = _run(cols, qs)
    _assert_close(got, want, f"planted={planted}")
    _assert_counters(pc, rc)
    if planted:
        assert pc["knn_uncertified"] == 0
    else:
        assert pc["knn_uncertified"] == len(qs)


# ---------------------------------------------------------------------------
# serving: plan extraction, filter masks, engine selection
# ---------------------------------------------------------------------------

MAPPINGS = {"properties": {"body": {"type": "text"},
                           "tag": {"type": "keyword"},
                           "vec": {"type": "dense_vector", "dims": 8}}}
QV = [float(x) for x in np.random.default_rng(61).standard_normal(8)]

KNN_BODIES = [
    {"knn": {"field": "vec", "query_vector": QV, "k": 7}},
    {"knn": {"field": "vec", "query_vector": QV, "k": 12,
             "filter": {"term": {"tag": "red"}}}, "size": 12},
    {"knn": {"field": "vec", "query_vector": QV, "k": 9,
             "filter": {"bool": {
                 "must": [{"term": {"tag": "green"}}],
                 "must_not": [{"term": {"body": "alpha"}}]}}}},
    {"query": {"match": {"body": "alpha"}},
     "knn": {"field": "vec", "query_vector": QV, "k": 5}},      # hybrid
    {"knn": {"field": "vec", "query_vector": QV, "k": 5, "boost": 2.0}},
    {"knn": [{"field": "vec", "query_vector": QV, "k": 5},
             {"field": "vec", "query_vector": QV, "k": 3}]},     # multi
    {"knn": [{"field": "vec", "query_vector": QV, "k": 4}]},    # list of 1
    {"knn": {"field": "vec", "query_vector": QV, "k": 5,
             "filter": {"match": {"body": "alpha beta"}}}},      # any-of
    {"knn": {"field": "vec", "query_vector": QV, "k": 5,
             "filter": {"bool": {"should": [
                 {"term": {"body": "alpha"}}]}}}},               # required or
    {"knn": {"field": "vec", "query_vector": QV, "k": 5,
             "filter": {"bool": {"must": [{"match": {"body": "beta"}}],
                                 "should": [{"term": {"body": "x"}}],
                                 "minimum_should_match": 1}}}},
    {"knn": {"field": "vec", "query_vector": QV, "k": 5,
             "filter": {"match_all": {}}}},                      # no clause
    {"knn": {"field": "vec", "query_vector": QV, "k": 5,
             "filter": {"match_phrase": {"body": "alpha beta"}}}},
    {"knn": {"field": "body", "query_vector": QV, "k": 5}},     # not vector
    {"knn": {"field": "vec", "query_vector": QV, "k": 0}},
    {"knn": {"field": "vec", "query_vector": QV}, "size": 2000},
    {"knn": {"field": "vec", "query_vector": QV}, "aggs": {}},
]


def _plan_dict(plan):
    return None if plan is None else dataclasses.asdict(plan)


@pytest.mark.parametrize("body", KNN_BODIES, ids=range(len(KNN_BODIES)))
def test_extract_knn_plan_same(body):
    want = ref_serving.extract_knn_plan(body, RefMapper(MAPPINGS))
    got = serving.extract_knn_plan(body, MapperService(MAPPINGS))
    assert _plan_dict(got) == _plan_dict(want)


def test_extract_knn_plan_declines_hybrid_and_boost():
    m = MapperService(MAPPINGS)
    assert serving.extract_knn_plan(KNN_BODIES[3], m) is None
    assert serving.extract_knn_plan(KNN_BODIES[4], m) is None
    assert serving.extract_knn_plan(KNN_BODIES[2], m).filter_plan is not None


def _corpus(n_parts=2, n=700, seed=59):
    """Partitions with a text body, a keyword tag and 8-d vectors, built
    by both packages' postings builders from the same tokens."""
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta"]
    tags = ["red", "green"]
    ref_parts, parts = [], []
    for _ in range(n_parts):
        body = rng.integers(0, 4, size=(n, 4))
        tag = rng.integers(0, 2, size=(n, 1))
        vec = rng.standard_normal((n, 8)).astype(np.float32)
        col = VectorColumn(vec, np.linalg.norm(vec, axis=1).astype(np.float32),
                           np.ones(n, bool), 8, "cosine")
        post, ref_post = {}, {}
        for field, toks, vocab in (("body", body, words), ("tag", tag, tags)):
            lens = np.full(n, toks.shape[1], np.int64)
            docs = np.repeat(np.arange(n, dtype=np.int64), toks.shape[1])
            post[field] = build_field_postings(field, lens, docs,
                                               toks.ravel(), vocab)
            ref_post[field] = ref_build_postings(field, lens, docs,
                                                 toks.ravel(), vocab)
        parts.append(SimpleNamespace(n_docs=n, postings=post,
                                     vectors={"vec": col}))
        ref_parts.append(SimpleNamespace(segment=SimpleNamespace(
            n_docs=n, postings=ref_post)))
    return parts, ref_parts


def test_knn_bodies_end_to_end(monkeypatch):
    """DSL bodies through extract_knn_plan, _knn_filter_mask and a stacked
    two-partition engine, against the reference's filter masks and its
    engine over the same columns."""
    monkeypatch.setenv("ES_TPU_FORCE_KNN", "1")
    parts, ref_parts = _corpus()
    m, rm = MapperService(MAPPINGS), RefMapper(MAPPINGS)
    eng = serving.select_knn_engine(parts, "vec", device="cpu")
    assert eng is not None and eng.stats()["fused"] == 1
    cols = [p.vectors["vec"] for p in parts]
    ref = ref_knn.KnnEngine(cols, mesh=make_mesh(2, dp=1))
    for body in KNN_BODIES[:3]:
        plan = serving.extract_knn_plan(body, m)
        rplan = ref_serving.extract_knn_plan(body, rm)
        filters = rfilters = None
        if plan.filter_plan is not None:
            filters = [serving._knn_filter_mask(plan.filter_plan, p)
                       for p in parts]
            rfilters = [ref_serving._knn_filter_mask(rplan.filter_plan, p)
                        for p in ref_parts]
            for a, b in zip(filters, rfilters):
                assert np.array_equal(a, b)
            assert 0 < sum(int(f.sum()) for f in filters) < 2 * 700
        vec = np.asarray(plan.vector, np.float32)
        got = eng.search_many([[knn.KnnWork(vec, filters)]], k=plan.k)[0]
        want = ref.search_many([[ref_knn.KnnWork(vec, rfilters)]],
                               k=rplan.k)[0]
        _assert_close(got, want, f"body {body}")


def test_select_knn_engine_gates_and_stubs(monkeypatch):
    parts, _ = _corpus(n_parts=3, n=300)
    monkeypatch.delenv("ES_TPU_FORCE_KNN", raising=False)
    assert serving.select_knn_engine(parts, "vec", device="cpu") is None
    monkeypatch.setenv("ES_TPU_FORCE_KNN", "1")
    assert serving.select_knn_engine(parts, "nope", device="cpu") is None
    # a partition without the field gets an all-missing stub column
    parts[1].vectors = {}
    eng = serving.select_knn_engine(parts, "vec", device="cpu")
    assert eng.S == 3 and not eng._exists[1].any()
    s, p, o = eng.search_many([[knn.KnnWork(np.ones(8, np.float32))]])[0]
    assert 1 not in set(p[0][s[0] > 0])
    # mixed dims decline
    c = parts[0].vectors["vec"]
    parts[1].vectors = {"vec": VectorColumn(np.zeros((300, 4), np.float32),
                                            np.zeros(300, np.float32),
                                            np.ones(300, bool), 4, "cosine")}
    assert serving.select_knn_engine(parts, "vec", device="cpu") is None
    assert c.dims == 8
