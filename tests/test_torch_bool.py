"""Port bool and phrase serving vs the reference, bitwise, on the CPU.

Each case builds one positional index with the reference's postings
builder, carries it across with `postings_from_arrays` (positions
included), and serves the same bool specs or phrases through both
TurboBM25 engines: the reference with its Pallas kernels in interpret mode,
the port with `device="cpu"` (its kernels' plain torch versions). Every
case runs on three routes: the bitset sweep (ES_TPU_BITSET=1: K5 + K6),
the coverage sweep (ES_TPU_BITSET=0: K7), and the galloping host
intersection (ES_TPU_BITSET_HOST_DF above every df). Top-k (scores, ords)
must be bit-identical (tolerance 0: both engines rescore on the host in
the same f64 order), equal to the port's own host tier, and the engines
must take the same routes (their counters agree). The specs are
tests/test_turbo_bitset.py's SPECS and the solo cases of
tests/test_turbo_bool.py.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common import faults as ref_faults
from elasticsearch_tpu.index.segment import build_field_postings
from elasticsearch_tpu.mapper.mapper_service import MapperService as RefMapper
from elasticsearch_tpu.parallel.spmd import build_stacked_bm25 as ref_stack
from elasticsearch_tpu.parallel.turbo import TurboBM25 as RefTurbo
from elasticsearch_tpu.search import serving as ref_serving
from elasticsearch_tpu_torch.common import faults
from elasticsearch_tpu_torch.index.positions import phrase_freqs
from elasticsearch_tpu_torch.index.segment import (
    POSTINGS_ARRAYS, postings_from_arrays,
)
from elasticsearch_tpu_torch.mapper import MapperService
from elasticsearch_tpu_torch.parallel import turbo
from elasticsearch_tpu_torch.parallel.spmd import build_stacked_bm25
from elasticsearch_tpu_torch.parallel.turbo import TurboBM25
from elasticsearch_tpu_torch.search import serving

torch.set_num_threads(1)

K = 10
# counters both engines keep for the bool and phrase routes
ROUTE_STATS = ("bool_device", "bool_host", "fallbacks", "bitset_gallop",
               "bitset_blocks_skipped", "bitset_packs", "phrase_builds",
               "degraded", "builds", "dispatches", "sparse_queries",
               "sparse_fallbacks", "cold_queries")
ROUTES = {
    "bitset": {"ES_TPU_BITSET": "1", "ES_TPU_BITSET_HOST_DF": "0"},
    "coverage": {"ES_TPU_BITSET": "0", "ES_TPU_BITSET_HOST_DF": "0"},
    "gallop": {"ES_TPU_BITSET": "1", "ES_TPU_BITSET_HOST_DF": str(1 << 30)},
}


class _Seg:
    def __init__(self, n_docs, fp):
        self.n_docs = n_docs
        self.postings = {"body": fp}
        self.vectors = {}


def _pcorpus(n_docs, vocab, seed, s=1.1, lens=(4, 24)):
    """The positional Zipf corpus of tests/test_turbo_bool.py (and, with
    other arguments, of tests/test_turbo_bitset.py)."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** s
    probs /= probs.sum()
    lens = rng.integers(*lens, size=n_docs).astype(np.int64)
    tokens = rng.choice(vocab, size=int(lens.sum()), p=probs).astype(np.int64)
    tok_docs = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    tok_pos = (np.arange(len(tokens), dtype=np.int64)
               - np.repeat(bounds[:-1], lens))
    fp = build_field_postings("body", lens, tok_docs, tokens,
                              [f"t{i}" for i in range(vocab)],
                              token_pos=tok_pos)
    return fp, tokens, bounds, rng


def carry(fp):
    return postings_from_arrays({n: getattr(fp, n) for n in POSTINGS_ARRAYS},
                                fp.terms, fp.sum_doc_len)


def engines(fp, n_docs, live=None, **kw):
    lm = None if live is None else [live]
    ref = RefTurbo(ref_stack([_Seg(n_docs, fp)], "body", live_masks=lm,
                             serve_only=True), **kw)
    port = TurboBM25(build_stacked_bm25([_Seg(n_docs, carry(fp))], "body",
                                        live_masks=lm), device="cpu", **kw)
    return ref, port


def assert_same(got, want, label):
    (gs, gd), (ws, wd) = got, want
    assert np.array_equal(gd, wd), f"{label}: ords differ"
    assert np.array_equal(gs, ws), f"{label}: scores differ"


# tests/test_turbo_bitset.py's SPECS: every clause kind the intersect
# kernel represents, fan-in overflow (> 8 required, > 4 must_not), an
# unmatchable and a should-only query
SPECS = [
    {"must": [("t1", 1.0), ("t3", 1.0)], "should": [("t5", 1.0)]},
    {"must": [("t0", 1.0)], "must_not": ["t2"],
     "should": [("t7", 1.0), ("t9", 0.5)]},
    {"filter": ["t4"], "should": [("t1", 1.0)]},
    {"must": [("t2", 1.0), ("t6", 2.0)], "must_not": ["t1", "t3"],
     "should": [("t0", 1.0)]},
    {"must": [("t5", 1.0)], "should": [("t8", 1.0), ("t10", 1.0)]},
    {"must": [(f"t{i}", 1.0) for i in range(10)]},
    {"must": [("t0", 1.0)], "must_not": [f"t{i}" for i in range(1, 8)]},
    {"must": [("t1", 1.0)], "filter": ["t0", "t2"], "must_not": ["t30"]},
    {"must": [("absent", 1.0), ("t1", 1.0)]},
    {"should": [("t3", 1.0), ("t7", 2.0)]},
]


def _drawn_specs(rng, vocab, n, bounds, tokens):
    """tests/test_turbo_bool.py's _draw_specs: mixed clause kinds, a third
    of them with a slop-0 phrase drawn from a real adjacency."""
    specs = []
    for i in range(n):
        t = rng.choice(vocab, size=6, replace=False)
        spec = {}
        if i % 3 != 2:
            spec["must"] = [(f"t{t[0]}", 1.0)]
            if i % 2:
                spec["must"].append((f"t{t[1]}",
                                     float(rng.choice([1.0, 2.0]))))
        spec["should"] = [(f"t{t[2]}", 1.0), (f"t{t[3]}", 0.5)]
        if i % 4 == 0:
            spec["filter"] = [f"t{t[4]}"]
        if i % 5 == 0:
            spec["must_not"] = [f"t{t[5]}"]
        if i % 3 == 2:
            d = int(rng.integers(0, len(bounds) - 1))
            lo, hi = int(bounds[d]), int(bounds[d + 1])
            j = int(rng.integers(lo, hi - 1))
            a, b = int(tokens[j]), int(tokens[j + 1])
            if a != b:
                spec["phrases"] = [([f"t{a}", f"t{b}"], 0, 1.0)]
        specs.append(spec)
    specs.append({"must": [("t0", 1.0), ("t1", 1.0)], "filter": ["t2"]})
    specs.append({"must": [("t0", 1.0)], "must_not": ["t1"]})
    specs.append({"must": [("absent", 1.0), ("t1", 1.0)]})
    specs.append({"should": [("t3", 1.0), ("t7", 2.0)]})
    return specs


def _phrases(rng, tokens, bounds, n, distinct=False):
    out = []
    while len(out) < n:
        d = int(rng.integers(0, len(bounds) - 1))
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        j = int(rng.integers(lo, hi - 1))
        p = [f"t{int(tokens[j])}", f"t{int(tokens[j + 1])}"]
        if p[0] != p[1] and not (distinct and p in out):
            out.append(p)
    return out


@pytest.fixture(scope="module")
def bool_corpus():
    return _pcorpus(2000, 60, 11)


@pytest.fixture(scope="module")
def bitset_corpus():
    return _pcorpus(2500, 40, 7)


@pytest.fixture(scope="module")
def tie_corpus():
    """Docs of one length over a hot Zipf head (test_torch_turbo.py's
    tie_heavy_fallback corpus, with positions): conjunctions of two head
    terms tie on more docs than the collected rows hold."""
    return _pcorpus(3000, 2000, 9, s=1.07, lens=(12, 13))


CASES = ("bitset_specs", "split_flushes", "drawn_specs", "deleted_docs",
         "cold_should_sparse", "all_cold", "phrases_slop0", "phrases_slop2",
         "capacity_degradation", "tie_heavy_fallback")


def _case(name, bool_corpus, bitset_corpus, tie_corpus):
    """(fp, n_docs, engine kwargs, live, bool specs) for a named case; a
    phrase case's specs are what search_phrase makes of its phrases."""
    fp, tokens, bounds, _ = bool_corpus
    rng = np.random.default_rng(100 + CASES.index(name))
    specs = _drawn_specs(np.random.default_rng(12), 60, 24, bounds, tokens)
    kw = {"cold_df": 5, "hbm_budget_bytes": 64 << 20, "qc_sizes": (8, 32)}
    phrase = lambda ph, slop: [{"phrases": [(p, slop, 1.0)]}  # noqa: E731
                               for p in ph]
    if name == "bitset_specs":
        return bitset_corpus[0], 2500, kw, None, SPECS
    if name == "split_flushes":
        extra = []
        for _ in range(20):
            a, b, c = rng.choice(30, size=3, replace=False)
            extra.append({"must": [(f"t{a}", 1.0)], "should": [(f"t{b}", 1.0)],
                          "must_not": [f"t{c}"]})
        return bitset_corpus[0], 2500, {**kw, "qc_sizes": (8,)}, None, \
            SPECS + extra
    if name == "drawn_specs":
        return fp, 2000, kw, None, specs
    if name == "deleted_docs":
        live = np.ones(2000, bool)
        live[::3] = False
        return fp, 2000, kw, live, specs[:14]
    if name == "cold_should_sparse":
        # heads colized, the rest cold: cold SHOULD terms score through K3
        return fp, 2000, {**kw, "cold_df": 150}, None, specs
    if name == "all_cold":
        return fp, 2000, {**kw, "cold_df": 1 << 30}, None, specs
    if name == "phrases_slop0":
        return fp, 2000, kw, None, phrase(_phrases(rng, tokens, bounds, 12), 0)
    if name == "phrases_slop2":
        return fp, 2000, kw, None, phrase(
            [["t0", "t1"], ["t1", "t0"], ["t2", "t5"]], 2)
    if name == "capacity_degradation":
        # more distinct phrases than slots: the overflow degrades to host
        return fp, 2000, {**kw, "hbm_budget_bytes": 256 << 10}, None, \
            phrase(_phrases(rng, tokens, bounds, 48, distinct=True), 0)
    if name == "tie_heavy_fallback":
        # chip_smoke's heavy config-2 shape (two head-term musts and a
        # cold should) on tied docs: certificates fail in both engines
        specs = []
        for _ in range(24):
            a, b = rng.choice(20, size=2, replace=False)
            specs.append({"must": [(f"t{a}", 1.0), (f"t{b}", 1.0)],
                          "should": [(f"t{int(rng.integers(40, 400))}", 1.0)]})
        return tie_corpus[0], 3000, {**kw, "cold_df": 200}, None, specs
    raise KeyError(name)


def _serve(engine, specs):
    """search_phrase for a bare-phrase batch (as a user calls it), else
    search_bool."""
    ph = [s["phrases"][0] for s in specs
          if list(s) == ["phrases"] and len(s["phrases"]) == 1]
    if len(ph) == len(specs) and len({p[1] for p in ph}) == 1:
        return engine.search_phrase([p[0] for p in ph], k=K, slop=ph[0][1])
    return engine.search_bool(specs, k=K)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", CASES)
def test_search_bool_bitwise(name, route, bool_corpus, bitset_corpus,
                             tie_corpus, monkeypatch):
    for key, value in ROUTES[route].items():
        monkeypatch.setenv(key, value)
    fp, n, kw, live, specs = _case(name, bool_corpus, bitset_corpus,
                                   tie_corpus)
    ref, port = engines(fp, n, live=live, **kw)
    for label in ("first pass", "warm pass"):
        got = _serve(port, specs)
        assert_same(got, _serve(ref, specs), f"{label}, port vs reference")
        for key in ROUTE_STATS:
            assert port.stats[key] == ref.stats[key], (label, key)
    assert_same(got, port.search_bool_host(specs, k=K), "port vs own host")
    assert port.hbm_bytes() == port._hbm.total_bytes()
    st = port.stats
    # (a should-only query has no required clause to gallop on or to
    # keep it off the device: it takes the sweep on every route)
    if route == "gallop" and name not in ("all_cold", "phrases_slop2"):
        assert st["bitset_gallop"] > 0
    elif name in ("all_cold", "phrases_slop2"):
        assert st["bool_host"] > 0
    else:
        assert st["bool_device"] > 0
    if route == "bitset" and st["bool_device"]:
        assert st["bitset_packs"] > 0 and st["bitset_blocks_skipped"] > 0
        assert port.bits.dtype == torch.int32 and \
            st["bitset_bytes"] == port.bits.nbytes
    if route == "coverage":
        assert port.bits is None and st["bitset_packs"] == 0
    if name == "capacity_degradation" and route != "gallop":
        assert st["degraded"] > 0
    if name == "cold_should_sparse" and route != "gallop":
        assert st["sparse_queries"] > 0
    if name == "phrases_slop0" and route != "gallop":
        assert st["phrase_builds"] > 0
    if name == "phrases_slop2":
        assert st["phrase_builds"] == 0 and st["bool_device"] == 0
    if name == "tie_heavy_fallback" and route != "gallop":
        # the counters were held equal above; the case must reach the
        # fallback
        assert st["fallbacks"] > 0


def test_phrase_freqs_and_positions_match_reference(bool_corpus):
    """The port's positional postings builder and phrase_freqs give the
    reference's arrays, exact and sloppy."""
    from elasticsearch_tpu.index.positions import phrase_freqs as ref_pf
    from elasticsearch_tpu_torch.index.segment import (
        build_field_postings as port_build,
    )

    fp, tokens, bounds, _ = bool_corpus
    lens = np.diff(bounds)
    docs = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    pos = np.arange(len(tokens), dtype=np.int64) - np.repeat(bounds[:-1],
                                                             lens)
    # the builder must not rely on tokens arriving in position order
    perm = np.random.default_rng(3).permutation(len(tokens))
    got = port_build("body", lens, docs[perm], tokens[perm],
                     [f"t{i}" for i in range(60)], token_pos=pos[perm])
    for n in POSTINGS_ARRAYS:
        assert np.array_equal(getattr(got, n), getattr(fp, n)), n
    port_fp = carry(fp)
    for terms in (["t0", "t1"], ["t1", "t0", "t2"], ["t5"], ["t3", "zz"]):
        for slop in (0, 1, 2):
            for a, b in zip(phrase_freqs(port_fp, terms, slop=slop),
                            ref_pf(fp, terms, slop=slop)):
                assert np.array_equal(a, b), (terms, slop)


@pytest.mark.parametrize("key, pos", [
    ([1 << 61, 3], [0, 3]),      # (key + 1) * span reaches 2^63
    ([5, 7], [0, -1]),           # a negative position
])
def test_positions_sort_key_out_of_range_raises(key, pos):
    """The positions builder sorts one combined (term, doc, position)
    integer and refuses inputs whose combination would not order right."""
    from elasticsearch_tpu_torch.index.segment import (
        _sorted_keys_and_positions,
    )

    with pytest.raises(ValueError, match="63-bit"):
        _sorted_keys_and_positions(np.array(key, np.int64),
                                   np.array(pos, np.int64))


MAPPINGS = {"properties": {"body": {"type": "text"}}}
DSL_BODIES = [
    {"query": {"bool": {
        "must": [{"term": {"body": "t1"}}, {"match": {"body": "t3"}}],
        "should": [{"term": {"body": "t5"}}],
        "filter": [{"term": {"body": "t4"}}],
        "must_not": [{"term": {"body": "t2"}}]}}},
    {"query": {"match_phrase": {"body": "t0 t1"}}},
    {"query": {"match_phrase": {"body": {"query": "t1 t0", "slop": 2}}}},
    {"query": {"match": {"body": {"query": "t0 t2 t6", "operator": "and"}}}},
    {"query": {"bool": {
        "must": [{"match": {"body": {
            "query": " ".join(f"t{i}" for i in range(10)),
            "operator": "and"}}}],
        "must_not": [{"terms": {"body": [f"t{i}" for i in range(20, 26)]}}]}}},
    {"query": {"bool": {"must": [{"match_phrase": {"body": "t2 t3"}}],
                        "should": [{"term": {"body": "t7"}}]}}},
    {"query": {"bool": {"filter": [{"term": {"body": "t0"}}],
                        "must": [{"term": {"body": {"value": "t9",
                                                    "boost": 2.0}}}]}}},
]


def _dsl_specs(mod, mapper):
    specs = []
    for b in DSL_BODIES:
        plan = mod.extract_plan(b, mapper)
        assert plan is not None and plan.is_conjunctive, b
        spec = mod._turbo_bool_spec(plan)
        assert spec is not None, b
        specs.append(spec)
    return specs


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_engine_search_bool_over_dsl_bitwise(route, bool_corpus,
                                             monkeypatch):
    """extract_plan -> _turbo_bool_spec -> TurboEngine.search_bool and
    search_phrase, against the reference's engine."""
    for key, value in ROUTES[route].items():
        monkeypatch.setenv(key, value)
    specs = _dsl_specs(serving, MapperService(MAPPINGS))
    assert specs == _dsl_specs(ref_serving, RefMapper(MAPPINGS))
    fp = bool_corpus[0]
    ref_t, port_t = engines(fp, 2000, cold_df=5, qc_sizes=(8, 32))
    ref = ref_serving.TurboEngine([ref_t])
    port = serving.TurboEngine([port_t])
    for g, w, name in zip(port.search_bool(specs, k=K),
                          ref.search_bool(specs, k=K),
                          ("scores", "partitions", "ords")):
        assert np.array_equal(g, w), name
    ph = [["t0", "t1"], ["t2", "t3"], ["t1", "t0"]]
    for slop in (0, 2):
        for g, w in zip(port.search_phrase(ph, k=K, slop=slop),
                        ref.search_phrase(ph, k=K, slop=slop)):
            assert np.array_equal(g, w), slop
    for key in ROUTE_STATS:
        assert port.stats[key] == ref.stats[key], key


def test_bitset_fault_contained_like_reference(bool_corpus, monkeypatch):
    """An injected bitset_intersect fault is contained as in the reference:
    the partition is served by its host tier with one fault record, the
    answers stay bit-identical, and a clean retry takes the device again."""
    monkeypatch.setenv("ES_TPU_BITSET_HOST_DF", "0")
    fp, tokens, bounds, _ = bool_corpus
    specs = _drawn_specs(np.random.default_rng(12), 60, 12, bounds, tokens)
    ref_t, port_t = engines(fp, 2000, cold_df=5, qc_sizes=(8, 32))
    ref = ref_serving.TurboEngine([ref_t])
    port = serving.TurboEngine([port_t])
    spec = "bitset_intersect:raise@1"
    with ref_faults.inject(spec):
        ref_log = []
        want = ref.search_bool(specs, k=K, fault_log=ref_log)
    with faults.inject(spec):
        log = []
        got = port.search_bool(specs, k=K, fault_log=log)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert [(r.site, r.partition) for r in log] == \
        [(r.site, r.partition) for r in ref_log] == [("bitset_intersect", 0)]
    d0 = port_t.stats["bool_device"]
    for g, w in zip(port.search_bool(specs, k=K), want):
        assert np.array_equal(g, w)
    assert port_t.stats["bool_device"] > d0


@pytest.mark.parametrize("spec", ["sparse_gather:raise@1",
                                  "sparse_gather:raise@3"])
def test_cold_should_fault_like_reference(spec, bool_corpus, bitset_corpus,
                                          tie_corpus, monkeypatch):
    """The cold SHOULD sides of a device chunk share one K3 launch; an
    injected sparse_gather fault hits the same query as in the reference,
    which alone scores its cold side on the host. Answers and counters
    equal the reference's, on the bitset route."""
    for key, value in ROUTES["bitset"].items():
        monkeypatch.setenv(key, value)
    fp, n, kw, live, specs = _case("cold_should_sparse", bool_corpus,
                                   bitset_corpus, tie_corpus)
    ref, port = engines(fp, n, live=live, **kw)
    sizes = []
    launch = port._sparse_launch
    port._sparse_launch = lambda preps: (sizes.append(len(preps)),
                                         launch(preps))[1]
    with ref_faults.inject(spec):
        want = ref.search_bool(specs, k=K)
    with faults.inject(spec):
        got = port.search_bool(specs, k=K)
    assert_same(got, want, spec)
    for key in ROUTE_STATS:
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["sparse_fallbacks"] == 1
    assert sum(sizes) == port.stats["sparse_queries"] - 1
    assert len(sizes) <= port.stats["dispatches"]
    assert_same(got, port.search_bool_host(specs, k=K), "port vs own host")


def test_intersect_sorted_matches_numpy():
    rng = np.random.default_rng(11)
    for na, nb in [(3, 4000), (200, 250), (0, 50), (70, 0), (1, 1)]:
        a = np.unique(rng.integers(0, 10000, size=na).astype(np.int64))
        b = np.unique(rng.integers(0, 10000, size=nb).astype(np.int64))
        got = turbo._intersect_sorted(a, b)
        assert np.array_equal(np.sort(got), np.intersect1d(a, b)), (na, nb)


def test_node_bitset_stats_track_engines(bitset_corpus, monkeypatch):
    monkeypatch.setenv("ES_TPU_BITSET", "1")
    monkeypatch.setenv("ES_TPU_BITSET_HOST_DF", "0")
    before = turbo.node_bitset_stats()
    _, port = engines(bitset_corpus[0], 2500, cold_df=5, qc_sizes=(8, 32))
    port.search_bool(SPECS, k=K)
    after = turbo.node_bitset_stats()
    for key in ("bitset_packs", "bitset_blocks_skipped"):
        assert after[key] - before[key] == port.stats[key] > 0
