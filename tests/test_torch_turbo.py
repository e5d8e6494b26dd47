"""Port TurboBM25 vs the reference TurboBM25, bitwise, on the CPU.

Each case builds one index with the reference's postings builder, carries
it across with `postings_from_arrays`, and serves the same queries through
both engines: the reference with its Pallas kernels in interpret mode, the
port with `device="cpu"` (its kernels' plain torch versions). Top-k
(scores, ords) must be bit-identical on the device route and on the host
tier, and the engines must take the same routes (their counters agree).
The cases are those of tests/test_turbo.py and, for the disjunction,
tests/test_turbo_sparse.py.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common import faults as ref_faults
from elasticsearch_tpu.index.segment import build_field_postings
from elasticsearch_tpu.parallel.spmd import build_stacked_bm25 as ref_stack
from elasticsearch_tpu.parallel.turbo import TurboBM25 as RefTurbo
from elasticsearch_tpu.search.serving import TurboEngine as RefEngine
from elasticsearch_tpu_torch.common import faults
from elasticsearch_tpu_torch.index.segment import (
    POSTINGS_ARRAYS, postings_from_arrays,
)
from elasticsearch_tpu_torch.parallel import kernels
from elasticsearch_tpu_torch.parallel.spmd import build_stacked_bm25
from elasticsearch_tpu_torch.parallel.turbo import TurboBM25
from elasticsearch_tpu_torch.search.serving import TurboEngine

torch.set_num_threads(1)

K = 10
# counters both engines keep for the disjunctive route
ROUTE_STATS = ("builds", "fallbacks", "cold_queries", "dispatches",
               "degraded", "sparse_queries", "sparse_slices", "sparse_bytes",
               "sparse_fallbacks")


class _Seg:
    def __init__(self, n_docs, fp):
        self.n_docs = n_docs
        self.postings = {"body": fp}


def _corpus(n_docs, vocab, seed, s=1.1, lens=(4, 20)):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** s
    probs /= probs.sum()
    ln = rng.integers(*lens, size=n_docs).astype(np.int64)
    tokens = rng.choice(vocab, size=int(ln.sum()), p=probs).astype(np.int64)
    tok_docs = np.repeat(np.arange(n_docs, dtype=np.int64), ln)
    return build_field_postings("body", ln, tok_docs, tokens,
                                [f"t{i}" for i in range(vocab)])


def carry(fp):
    """The port's FieldPostings over a reference index's arrays."""
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
    for (gs, gd), (ws, wd) in zip(got, want):
        assert np.array_equal(gd, wd), f"{label}: ords differ"
        assert np.array_equal(gs, ws), f"{label}: scores differ"


def check(ref, port, batches, k=K):
    want = ref.search_many(batches, k=k)
    got = port.search_many(batches, k=k)
    assert_same(got, want, "device route")
    assert_same(port.search_many_host(batches, k=k),
                ref.search_many_host(batches, k=k), "host tier")
    assert_same(got, port.search_many_host(batches, k=k), "port vs own host")
    for key in ROUTE_STATS:
        assert port.stats[key] == ref.stats[key], key


def _pairs(rng, hi, n):
    return [[f"t{a}", f"t{b}"] for a, b in rng.integers(0, hi, size=(n, 2))]


def _sparse_queries():
    qs = [[(f"t{i}", 1.0), (f"t{i + 11}", 0.7)] for i in range(0, 20, 3)]
    qs.append([("t30", 1.0), ("t35", 1.0)])             # cold-only
    qs.append([("t31", 2.0)])                           # single cold term
    qs.append([("t0", 1.0), ("t25", 1.0), ("t38", 0.5)])   # mixed
    qs.append([("t1", 1.0), ("t2", 0.5)])               # colized-only
    qs.append([("absent", 1.0), ("t33", 1.0)])          # unknown + cold
    return qs


CASES = {
    # every term cold at this size (df < COLD_DF): the sparse tier serves
    "cold_only": dict(n=3000, vocab=300, seed=0, kw={},
                      q=lambda r: [_pairs(r, 200, 16)]),
    # cold_df forced low so columns engage
    "colized": dict(n=2000, vocab=50, seed=1, kw={"cold_df": 10},
                    q=lambda r: [_pairs(r, 50, 12)]),
    "live_mask": dict(n=1500, vocab=40, seed=2, kw={"cold_df": 10},
                      live=lambda n: np.arange(n) % 3 != 0,
                      q=lambda r: [_pairs(r, 40, 6)]),
    "mixed_boosted": dict(
        n=2500, vocab=120, seed=3, kw={"cold_df": 60},
        q=lambda r: [[[("t0", 2.0), (f"t{100 + i}", 1.0)] for i in range(8)]]),
    "missing_and_duplicate_terms": dict(
        n=1000, vocab=30, seed=4, kw={"cold_df": 40},
        q=lambda r: [[["zzz_missing"], ["t0", "zzz_missing"],
                      ["t1", "t1", "t5"], [("t2", 0.5), ("t2", 1.5)], []],
                     [["t3"]]]),
    # budget floor is 32 slots and nearly every term is colizable, so one
    # batch demands more columns than capacity: overflow stays cold
    "capacity_overflow": dict(
        n=3000, vocab=80, seed=7, kw={"hbm_budget_bytes": 1, "cold_df": 5},
        q=lambda r: [[[f"t{i}", f"t{(i + 37) % 80}"] for i in range(40)]]),
    "qc_sizes_intermediate": dict(
        n=1200, vocab=30, seed=8, kw={"cold_df": 10, "qc_sizes": (3, 20, 64)},
        q=lambda r: [[[f"t{i % 30}", f"t{(i + 11) % 30}"]
                      for i in range(17)]]),
    # docs of one length over a hot Zipf head: thousands of docs tie on a
    # term's top score, more than the collected rows hold, so certificates
    # fail and both engines answer those queries by the exact host merge
    "tie_heavy_fallback": dict(n=3000, vocab=2000, seed=9, s=1.07,
                               kw={"cold_df": 200}, lens=(12, 13),
                               q=lambda r: [_pairs(r, 20, 16)]),
    # tests/test_turbo_sparse.py's corpus and queries: t0..t7 colized,
    # the rest cold, queries straddling the boundary
    "sparse_straddle": dict(n=3000, vocab=40, seed=7, kw={"cold_df": 800},
                            lens=(4, 24), q=lambda r: [_sparse_queries()]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_search_many_bitwise(name):
    c = CASES[name]
    fp = _corpus(c["n"], c["vocab"], c["seed"], s=c.get("s", 1.1),
                 lens=c.get("lens", (4, 20)))
    live = c["live"](c["n"]) if "live" in c else None
    ref, port = engines(fp, c["n"], live=live,
                        **{"hbm_budget_bytes": 64 << 20, **c["kw"]})
    batches = c["q"](np.random.default_rng(c["seed"] + 50))
    check(ref, port, batches)
    # a second pass reuses the resident columns and slices
    check(ref, port, batches)
    assert port.hbm_bytes() == port._hbm.total_bytes()
    if name == "capacity_overflow":
        assert port.Hp == 32 and port.stats["degraded"] > 0
    if name == "tie_heavy_fallback":
        # check() held the counts equal; the case must reach the fallback
        assert port.stats["fallbacks"] == ref.stats["fallbacks"] > 0
    if name == "qc_sizes_intermediate":
        assert port.qc_sizes == (8, 24, 64)


@pytest.fixture(scope="module")
def sparse_fp():
    return _corpus(3000, 40, 7, lens=(4, 24))


@pytest.mark.parametrize("env", [
    {"ES_TPU_SPARSE": "0"},                     # host cold fork A/B
    {"ES_TPU_SPARSE_WIDTHS": "1024,2048"},      # custom ladder
    {"ES_TPU_SPARSE_WIDTHS": "1024"},           # df above the ladder
])
def test_sparse_knobs_bitwise(sparse_fp, monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ref, port = engines(sparse_fp, 3000, hbm_budget_bytes=64 << 20,
                        cold_df=2500)
    qs = [[("t2", 1.0), ("t30", 1.0)], [("t35", 1.0), ("t38", 1.0)],
          [("t9", 1.0), ("t2", 0.3)]]
    check(ref, port, [qs])
    if env.get("ES_TPU_SPARSE") == "0":
        assert port._sp_pool is None and port.stats["cold_queries"] > 0
    elif env["ES_TPU_SPARSE_WIDTHS"] == "1024":
        assert port.stats["sparse_fallbacks"] > 0


def test_turbo_sweep_fault_contained_like_reference(sparse_fp):
    """An injected turbo_sweep fault is contained the same way in both
    engines: the partition is served by its host tier, one fault record
    names the site and partition, and results stay bit-identical; a clean
    retry takes the device route again."""
    ref_t, port_t = engines(sparse_fp, 3000, hbm_budget_bytes=64 << 20,
                            cold_df=800)
    ref, port = RefEngine([ref_t]), TurboEngine([port_t])
    qs = _sparse_queries()
    spec = "turbo_sweep:raise@1"
    with ref_faults.inject(spec):
        ref_log = []
        want = ref.search_many([qs], k=K, fault_log=ref_log)
    kernels.reset_launches()
    with faults.inject(spec):
        log = []
        got = port.search_many([qs], k=K, fault_log=log)
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(g, w)
    assert [(r.site, r.partition) for r in log] == \
        [(r.site, r.partition) for r in ref_log] == [("turbo_sweep", 0)]
    assert port.health.counters["device_faults"] == \
        ref.health.counters["device_faults"] == 1
    clean = port.search_many([qs], k=K)
    for g, w in zip(clean[0], want[0]):
        assert np.array_equal(g, w)
    assert port.health.counters["device_faults"] == 1


def test_full_slice_pool_uploads_what_it_packed(sparse_fp):
    """With a two-granule slice pool, a batch's cold terms cannot all be
    sliced: the slices packed before the pool filled must still reach the
    device, or later queries would read stale granules and prune real hits.
    (The reference returns before that upload, turbo.py:945; the port
    uploads, so its device route stays bit-identical to its host tier.)"""
    _, port = engines(sparse_fp, 3000, hbm_budget_bytes=40960, cold_df=800)
    assert port._sp_cap == 2
    qs = [[("t0", 1.0), (f"t{i}", 1.0)] for i in range(9, 30, 2)]
    qs += [[("t1", 1.0), ("t9", 1.0), ("t20", 0.5)]]   # two cold: unsliceable
    for _ in range(2):
        got = port.search_many([qs], k=K)
        assert_same(got, port.search_many_host([qs], k=K), "full pool")
    assert port.stats["sparse_queries"] > port.stats["sparse_fallbacks"] > 0
    assert torch.equal(port._sp_pool, torch.from_numpy(port._sp_host))


def _count_group_launches(port):
    """Record the size of every batched K3 launch of `port`."""
    sizes = []
    launch = port._sparse_launch

    def counted(preps):
        sizes.append(len(preps))
        return launch(preps)

    port._sparse_launch = counted
    return sizes


def test_pool_pressure_splits_groups_like_reference(sparse_fp, monkeypatch):
    """A slice pool of five usable granules under a batch whose queries
    each need two new one-granule slices: each query's _ensure_sparse
    evicts slices the pending K3 group still reads, so the group launches
    first (flush-before-evict) and the batch takes several launches. The
    evictions, slices, bytes and fallbacks equal the reference's, which
    slices query by query, and so do the answers. The first query's cold
    term is wider than the ladder, so the batch's up-front slicing in
    ensure_columns gives up before packing anything (the reference's
    pool-full upload bug, ROADMAP W7, never arises)."""
    monkeypatch.setenv("ES_TPU_SPARSE_WIDTHS", "1024")
    ref, port = engines(sparse_fp, 3000, hbm_budget_bytes=98304,
                        cold_df=2500)
    assert port._sp_cap == ref._sp_cap == 6
    qs = [[("t2", 1.0), ("t9", 1.0)]]
    # t0 is colized, so the cold totals decide which docs survive the
    # bound-prune: a total read from an overwritten granule changes answers
    qs += [[("t0", 0.5), (f"t{7 + i}", 1.0), (f"t{8 + i}", 0.8)]
           for i in range(0, 30, 2)]
    qs += [[("t15", 1.0), ("t16", 0.5)], [("t37", 1.0), ("t7", 2.0)],
           [("t30", 1.0)]]
    sizes = _count_group_launches(port)
    got = port.search_many([qs], k=K)
    assert_same(got, port.search_many_host([qs], k=K), "port vs own host")
    assert_same(got, ref.search_many([qs], k=K), "device route")
    for key in ROUTE_STATS:
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["sparse_fallbacks"] == 1
    assert len(sizes) > 4 and sum(sizes) == len(qs) - 1
    assert torch.equal(port._sp_pool, torch.from_numpy(port._sp_host))
    # again (both engines), with the slices left by the first pass
    check(ref, port, [qs])


@pytest.mark.parametrize("spec", ["sparse_gather:raise@1",
                                  "sparse_gather:raise@3"])
def test_sparse_fault_falls_back_like_reference(sparse_fp, spec):
    """An injected sparse_gather fault hits the same query in both engines
    (one fault point per query with a cold side, in query order): that
    query alone scores its cold side on the host, the rest of its group
    shares one K3 launch, and answers and counters equal the
    reference's."""
    ref, port = engines(sparse_fp, 3000, hbm_budget_bytes=64 << 20,
                        cold_df=800)
    sizes = _count_group_launches(port)
    qs = _sparse_queries()
    with ref_faults.inject(spec):
        want = ref.search_many([qs], k=K)
    with faults.inject(spec):
        got = port.search_many([qs], k=K)
    assert_same(got, want, spec)
    for key in ROUTE_STATS:
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["sparse_fallbacks"] == 1
    n_cold = port.stats["sparse_queries"]
    assert sizes == [n_cold - 1]
    assert_same(got, port.search_many_host([qs], k=K), "host tier")


def test_batched_launch_fault_falls_group_back(sparse_fp, monkeypatch):
    """A device fault in the batched K3 launch falls every query of its
    group back to the host enumeration, each counted; the slice pool is
    kept and the answers equal the host tier's."""
    _, port = engines(sparse_fp, 3000, hbm_budget_bytes=64 << 20,
                      cold_df=800)
    qs = _sparse_queries()
    want = port.search_many_host([qs], k=K)

    def broken(*a, **kw):
        raise RuntimeError("INTERNAL: injected launch failure")

    monkeypatch.setattr(kernels, "sparse_gather", broken)
    got = port.search_many([qs], k=K)
    assert_same(got, want, "launch fault")
    assert port.stats["sparse_fallbacks"] == port.stats["sparse_queries"] > 0
    assert port._sp_of and torch.equal(port._sp_pool,
                                       torch.from_numpy(port._sp_host))


def test_postings_builder_and_tf_at_match_reference():
    """The port's own postings builder (chip_smoke.py builds its index with
    it) gives the reference's arrays, and tf_at reads them the same way."""
    from elasticsearch_tpu.index.segment import tf_at as ref_tf_at
    from elasticsearch_tpu_torch.index.segment import (
        build_field_postings as port_build, tf_at,
    )

    rng = np.random.default_rng(11)
    lens = rng.integers(1, 30, size=900).astype(np.int64)
    toks = rng.integers(0, 70, size=int(lens.sum())).astype(np.int64)
    docs = np.repeat(np.arange(900, dtype=np.int64), lens)
    names = [f"t{i}" for i in range(70)]
    want = build_field_postings("body", lens, docs, toks, names)
    got = port_build("body", lens, docs, toks, names)
    for n in POSTINGS_ARRAYS:
        assert np.array_equal(getattr(got, n), getattr(want, n)), n
    assert got.terms == want.terms and got.sum_doc_len == want.sum_doc_len
    cand = np.sort(rng.choice(900, size=200, replace=False)).astype(np.int32)
    for t in ("t0", "t33", "t69", "absent"):
        for a, b in zip(tf_at(got, t, cand), ref_tf_at(want, t, cand)):
            assert np.array_equal(a, b), t
