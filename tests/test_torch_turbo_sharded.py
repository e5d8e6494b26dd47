"""The port's fused S > 1 Turbo route vs the reference's, on the CPU.

With S > 1 partitions the port's TurboEngine sweeps every partition in one
launch per query chunk (parallel.turbo.ShardedTurbo, kernels F1-F3) and
merges the partition top-ks on the device (K4), as the reference's does
on its mesh. Each case of tests/test_turbo_sharded.py has a twin here: the
same numpy-seeded corpora go through both packages, the reference on the
8-device CPU mesh of tests/conftest.py (Pallas in interpret mode), the
port on `device="cpu"` (its kernels' plain versions). Per case the port's
fused (score, partition, ord) rows must be bitwise the reference's fused
rows and the port's own sequential route's (ES_TPU_TURBO_MESH=0, which
merges through `_merge3`), and the fused counters (`fused_dispatches`,
`merge_device`, `partition_dispatches`) must move as the reference's do.

Beside them: F1-F3's plain versions bitwise against the reference's
`_fused_sweep_*` programs on the same stacked inputs (partitions of
different slot counts and superwindows, a padding partition), the fused
route's fault containment (an injected `fused_dispatch` fault contained
bitwise, a kernel error propagating), and the scrub twins of
tests/test_integrity.py's Turbo cases.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.common import faults as ref_faults
from elasticsearch_tpu.common import integrity as ref_integrity
from elasticsearch_tpu.index.segment import build_field_postings
from elasticsearch_tpu.parallel import kernels as ref_k
from elasticsearch_tpu.parallel import make_mesh
from elasticsearch_tpu.parallel import turbo as ref_turbo
from elasticsearch_tpu.parallel.spmd import build_stacked_bm25 as ref_stack
from elasticsearch_tpu.search import serving as ref_serving
from elasticsearch_tpu_torch.common import faults, integrity
from elasticsearch_tpu_torch.common.errors import KernelLaunchError
from elasticsearch_tpu_torch.index.segment import (
    POSTINGS_ARRAYS, postings_from_arrays,
)
from elasticsearch_tpu_torch.parallel import kernels as k
from elasticsearch_tpu_torch.parallel.spmd import build_stacked_bm25
from elasticsearch_tpu_torch.parallel.turbo import TurboBM25
from elasticsearch_tpu_torch.search import serving
from torch_kernel_cases import sweep_inputs

torch.set_num_threads(1)

FUSED_KEYS = ("fused_dispatches", "merge_device", "partition_dispatches",
              "merge_host")


class _Seg:
    def __init__(self, n_docs, fp):
        self.n_docs = n_docs
        self.postings = {"body": fp}
        self.vectors = {}


def _pcorpus(n_docs, vocab, seed):
    """tests/test_turbo_sharded.py's positional Zipf corpus."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    lens = rng.integers(4, 24, size=n_docs).astype(np.int64)
    tokens = rng.choice(vocab, size=int(lens.sum()), p=probs).astype(np.int64)
    return _corpus_fp(lens, tokens, vocab)


def _corpus_fp(lens, tokens, vocab):
    n_docs = len(lens)
    tok_docs = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    tok_pos = (np.arange(len(tokens), dtype=np.int64)
               - np.repeat(bounds[:-1], lens))
    names = [f"t{i}" for i in range(vocab)]
    return build_field_postings("body", lens, tok_docs, tokens, names,
                                token_pos=tok_pos)


def carry(fp):
    return postings_from_arrays({n: getattr(fp, n) for n in POSTINGS_ARRAYS},
                                fp.terms, fp.sum_doc_len)


class Twin:
    """The reference's fused engine and the port's over the same
    partitions, and the port's sequential engine over the port's ones."""

    def __init__(self, parts, cold_df=5, hbm=64 << 20, **kw):
        ref_ts = [ref_turbo.TurboBM25(
            ref_stack([_Seg(n, fp)], "body", serve_only=True),
            hbm_budget_bytes=hbm, cold_df=cold_df, **kw) for n, fp in parts]
        self.ref = ref_serving.TurboEngine(
            ref_ts, mesh=ref_serving._turbo_mesh(len(ref_ts)))
        port_ts = [TurboBM25(build_stacked_bm25([_Seg(n, carry(fp))], "body"),
                             hbm_budget_bytes=hbm, cold_df=cold_df,
                             device="cpu", **kw) for n, fp in parts]
        self.port = serving.TurboEngine(port_ts, fused=True)
        self.seq = serving.TurboEngine(port_ts)

    def stats(self):
        return ({x: self.ref.merge_stats[x] for x in FUSED_KEYS},
                {x: self.port.merge_stats[x] for x in FUSED_KEYS})

    def run(self, call, *args, **kw):
        """call on all three engines; the fused rows held bitwise to the
        reference's and to the sequential route's, the fused counters'
        moves to the reference's. Returns the port's rows."""
        r0, p0 = self.stats()
        want = getattr(self.ref, call)(*args, **kw)
        got = getattr(self.port, call)(*args, **kw)
        r1, p1 = self.stats()
        assert {x: p1[x] - p0[x] for x in FUSED_KEYS} == \
            {x: r1[x] - r0[x] for x in FUSED_KEYS}, (call, r0, r1, p0, p1)
        assert p1["fused_dispatches"] > p0["fused_dispatches"], call
        seq = getattr(self.seq, call)(*args, **kw)
        _assert_rows_equal(got, want, f"{call}: port vs reference")
        _assert_rows_equal(got, seq, f"{call}: fused vs sequential")
        return got


def _assert_rows_equal(got, want, ctx):
    if isinstance(got, list):
        assert len(got) == len(want), ctx
        for bi, (g, w) in enumerate(zip(got, want)):
            _assert_rows_equal(g, w, f"{ctx} batch {bi}")
        return
    for g, w, name in zip(got, want, ("scores", "parts", "ords")):
        assert np.array_equal(np.asarray(g), np.asarray(w)), (ctx, name)


@pytest.fixture(scope="module")
def eng3():
    """Three partitions of different sizes and vocabularies (different
    slot counts: the weight axis padded in the fused launch) and terms
    absent from the small-vocabulary partition."""
    return Twin([(1500, _pcorpus(1500, 40, 1)), (900, _pcorpus(900, 56, 2)),
                 (2100, _pcorpus(2100, 32, 3))])


# ---------------------------------------------------------------------------
# the merge kernel against an independent lexicographic reference
# ---------------------------------------------------------------------------


def _ref_merge(scores, ords, kk):
    Q, _ = scores.shape
    out = (np.zeros((Q, kk), np.float32), np.zeros((Q, kk), np.int32),
           np.zeros((Q, kk), np.int32))
    for qi in range(Q):
        cand = [(float(s), lane // kk, int(o))
                for lane, (s, o) in enumerate(zip(scores[qi], ords[qi]))
                if s > 0]
        cand.sort(key=lambda x: (-x[0], x[1], x[2]))
        for j, (s, p, o) in enumerate(cand[:kk]):
            out[0][qi, j], out[1][qi, j], out[2][qi, j] = s, p, o
    return out


def test_merge_topk_matches_lexicographic_reference():
    rng = np.random.default_rng(5)
    Q, S, kk = 6, 4, 10
    scores = rng.choice(np.asarray([0.0, 0.0, 1.5, 2.25, 3.5], np.float32),
                        size=(Q, S * kk))
    ords = np.stack([rng.permutation(1000)[:S * kk] for _ in range(Q)])
    ords = ords.astype(np.int32)
    want = _ref_merge(scores, ords, kk)
    _assert_rows_equal(ref_k.merge_topk(scores, ords, k=kk), want, "ref")
    got = k.merge_topk(torch.from_numpy(scores), torch.from_numpy(ords), k=kk)
    _assert_rows_equal([t.numpy() for t in got], want, "port")


# ---------------------------------------------------------------------------
# the fused route against the reference's and the sequential route
# ---------------------------------------------------------------------------


def test_fused_disjunctive_bit_identical_one_dispatch(eng3):
    batch = [["t0", "t1"], ["t3"], [("t2", 2.0), "t5"], ["t7", "t0", "t9"],
             ["t33", "t1"],        # t33 absent from the vocab-32 partition
             ["t90"]]              # absent from every partition
    d0 = [t.stats["dispatches"] for t in eng3.port.turbos]
    f0 = eng3.port.merge_stats["fused_dispatches"]
    m0 = eng3.port.merge_stats["merge_device"]
    got = eng3.port.search_many([batch], k=10)[0]
    # one launch for all partitions, merged on the device, no solo sweep
    assert eng3.port.merge_stats["fused_dispatches"] - f0 == 1
    assert eng3.port.merge_stats["merge_device"] - m0 == 1
    assert [t.stats["dispatches"] for t in eng3.port.turbos] == d0
    _assert_rows_equal(got, eng3.ref.search_many([batch], k=10)[0], "disj")
    eng3.run("search_many", [batch], k=10)


def test_fused_multi_batch_and_chunking():
    # one width of 8: the 9 queries of both batches split into two chunks,
    # two fused launches for all partitions, one device merge per batch
    tw = Twin([(500, _pcorpus(500, 30, 61)), (400, _pcorpus(400, 30, 67))],
              qc_sizes=(8,))
    b1 = [[f"t{i}", f"t{(i * 3 + 1) % 20}"] for i in range(7)]
    b2 = [["t2"], ["t4", "t6"]]
    f0 = tw.port.merge_stats["fused_dispatches"]
    m0 = tw.port.merge_stats["merge_device"]
    tw.run("search_many", [b1, b2], k=7)
    assert tw.port.merge_stats["fused_dispatches"] - f0 == 2
    assert tw.port.merge_stats["merge_device"] - m0 == 2


@pytest.mark.parametrize("bitset", ["1", "0"])
def test_fused_bool_and_phrase_bit_identical(eng3, monkeypatch, bitset):
    """Both bool routes: ES_TPU_BITSET=1 (F3: K5 + K6 per partition) and
    =0 (F2: the coverage gate)."""
    monkeypatch.setenv("ES_TPU_BITSET", bitset)
    specs = [
        {"must": [("t0", 1.0), ("t1", 1.0)]},
        {"must": [("t2", 1.0)], "must_not": ["t1"]},
        {"should": [("t3", 1.0), ("t4", 2.0)]},
        {"must": [("t0", 1.0)], "filter": ["t5"]},
        {"must": [("t0", 1.0)], "phrases": [(("t0", "t1"), 0, 1.0)]},
        {"phrases": [(["t1", "t0"], 0, 1.0)]},
    ]
    eng3.run("search_bool", specs, k=10)
    phrases = [["t0", "t1"], ["t2", "t0"], ["t1", "t3"]]
    eng3.run("search_phrase", phrases, k=5, slop=0)


def test_fused_refresh_picks_up_new_columns(eng3):
    """Columns built after the fused engine's first launch (a cols_epoch
    move) are read by the next fused launch: the port's launch reads each
    partition's cache in place, nothing to re-sync."""
    epochs0 = [t.cols_epoch for t in eng3.port.turbos]
    batch = [["t11", "t13"], ["t12", "t14", "t15"]]
    eng3.run("search_many", [batch], k=10)
    assert any(t.cols_epoch > e for t, e in zip(eng3.port.turbos, epochs0))


def test_fused_certificate_fallback_bit_identical(eng3):
    """force_cert_fail discards the device collection inside the fused
    path too: the per-partition exact host fallback runs and the merge
    still agrees (both exact)."""
    specs = [{"must": [("t0", 1.0), ("t6", 1.0)]},
             {"must": [("t1", 1.0)], "should": [("t2", 1.0)]}]
    fb0 = eng3.port.stats["fallbacks"]
    rfb0 = eng3.ref.stats["fallbacks"]
    engines = eng3.ref.turbos + eng3.port.turbos
    try:
        for t in engines:
            t.force_cert_fail = True
        eng3.run("search_bool", specs, k=10)
    finally:
        for t in engines:
            t.force_cert_fail = False
    assert eng3.port.stats["fallbacks"] > fb0
    assert eng3.ref.stats["fallbacks"] > rfb0


# ---------------------------------------------------------------------------
# tie-break: equal scores across and within partitions, short partitions
# ---------------------------------------------------------------------------


def test_fused_ties_across_partitions():
    """Two identical partitions: every hit ties across them; equal (score,
    ord) order by partition asc."""
    fp = _pcorpus(700, 30, 7)
    tw = Twin([(700, fp), (700, fp)])
    batch = [["t0", "t2"], ["t1"], ["t4", "t5"]]
    s, p, o = tw.run("search_many", [batch], k=10)[0]
    for qi in range(len(batch)):
        for j in range(9):
            if s[qi, j] > 0 and s[qi, j] == s[qi, j + 1]:
                assert (p[qi, j], o[qi, j]) < (p[qi, j + 1], o[qi, j + 1])


def test_fused_ties_within_partition():
    """A partition whose second half duplicates its first: equal (score,
    partition) pairs order by ord asc."""
    rng = np.random.default_rng(17)
    lens = rng.integers(4, 20, size=400).astype(np.int64)
    toks = rng.choice(25, size=int(lens.sum()),
                      p=(lambda w: w / w.sum())(
                          1.0 / np.arange(1, 26) ** 1.1)).astype(np.int64)
    fp_dup = _corpus_fp(np.concatenate([lens, lens]),
                        np.concatenate([toks, toks]), 25)
    tw = Twin([(800, fp_dup), (600, _pcorpus(600, 25, 19))])
    tw.run("search_many", [[["t0", "t1"], ["t3", "t2"]]], k=10)


def test_fused_k_exceeds_partition_candidates():
    """Tail terms matching a handful of docs a partition: the merged tail
    pads with (0, 0, 0) as _merge3 does."""
    tw = Twin([(60, _pcorpus(60, 40, 23)), (40, _pcorpus(40, 40, 29)),
               (50, _pcorpus(50, 40, 31))], cold_df=2)
    got = tw.run("search_many", [[["t38"], ["t39", "t37"], ["t36"]]], k=10)
    assert np.any(got[0][0] == 0), "expected padded tail slots"


# ---------------------------------------------------------------------------
# serving selection, the knob, and the coalescer on the fused engine
# ---------------------------------------------------------------------------


def test_select_engine_routes_multi_partition_to_fused_turbo(monkeypatch):
    monkeypatch.setenv("ES_TPU_FORCE_TURBO", "1")
    fps = [_pcorpus(600, 30, 41), _pcorpus(450, 30, 43)]
    ref_segs = [_Seg(600, fps[0]), _Seg(450, fps[1])]
    port_segs = [_Seg(600, carry(fps[0])), _Seg(450, carry(fps[1]))]
    mesh = make_mesh(2, dp=1)
    assert ref_serving.turbo_eligible(ref_segs, "body", mesh, cold_df=5)
    assert serving.turbo_eligible(port_segs, "body", device="cpu",
                                  cold_df=5)
    ref = ref_serving.select_bm25_engine(ref_segs, "body", None, mesh,
                                         cold_df=5)
    port = serving.select_bm25_engine(port_segs, "body", device="cpu",
                                      cold_df=5)
    assert ref.kind == port.kind == "turbo"
    assert ref.mesh is not None and port.fused
    assert serving.engine_desc(port) == ref_serving.engine_desc(ref) == \
        ("fused_turbo", 2)
    batch = [["t0", "t1"], ["t2"]]
    want = ref.search_many([batch], k=10)[0]
    got = port.search_many([batch], k=10)[0]
    _assert_rows_equal(got, want, "selected")
    assert port.merge_stats["merge_device"] == \
        ref.merge_stats["merge_device"] >= 1
    # the knob at 0: the sequential route and the host merge, both sides
    monkeypatch.setenv("ES_TPU_TURBO_MESH", "0")
    ref0 = ref_serving.select_bm25_engine(ref_segs, "body", None, mesh,
                                          cold_df=5)
    port0 = serving.select_bm25_engine(port_segs, "body", device="cpu",
                                       cold_df=5)
    assert ref0.mesh is None and not port0.fused
    assert serving.engine_desc(port0) == ref_serving.engine_desc(ref0) == \
        ("turbo", 2)
    _assert_rows_equal(port0.search_many([batch], k=10)[0],
                       ref0.search_many([batch], k=10)[0], "knob 0")
    assert port0.merge_stats["merge_host"] == \
        ref0.merge_stats["merge_host"] == 1
    assert port0.merge_stats["fused_dispatches"] == 0


def test_turbo_mesh_env_disable(monkeypatch):
    """The mesh-less counterpart of `_turbo_mesh`: S = 1 never fuses, the
    knob at 0 (or less) turns fusion off, any positive cap keeps it (one
    card: no device count to cap)."""
    monkeypatch.delenv("ES_TPU_TURBO_MESH", raising=False)
    assert ref_serving._turbo_mesh(1) is None
    assert not serving._turbo_fused(1)
    assert ref_serving._turbo_mesh(3) is not None
    assert serving._turbo_fused(3)
    monkeypatch.setenv("ES_TPU_TURBO_MESH", "0")
    assert ref_serving._turbo_mesh(3) is None
    assert not serving._turbo_fused(3)
    monkeypatch.setenv("ES_TPU_TURBO_MESH", "2")
    m = ref_serving._turbo_mesh(5)
    assert m is not None and m.devices.size == 2
    assert serving._turbo_fused(5)


def test_sharded_engine_coalescer_rows_and_keys():
    """The coalescer serves the fused engine with rows bitwise its solo
    dispatch's; its batch key is stable per engine object and distinct
    across engines over the same partitions."""
    from elasticsearch_tpu_torch.threadpool.coalescer import (
        DispatchCoalescer, _engine_key,
    )

    tw = Twin([(600, _pcorpus(600, 30, 47)), (500, _pcorpus(500, 30, 53))])
    eng = tw.port
    queries = [["t0", "t1"], ["t2"], ["t1", "t3"], ["t4"]]
    solo = [eng.search_many([[q]], k=10)[0] for q in queries]
    for q, s in zip(queries, solo):
        _assert_rows_equal(s, tw.ref.search_many([[q]], k=10)[0], q)

    co = DispatchCoalescer(window_us=400_000, max_batch=len(queries))
    results = [None] * len(queries)
    errors = []
    barrier = threading.Barrier(len(queries))

    def worker(i, q):
        try:
            barrier.wait(timeout=10)
            results[i] = co.dispatch(eng, [q], 10)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i, q))
               for i, q in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for q, got, want in zip(queries, results, solo):
        _assert_rows_equal((got[0][0], got[1][0], got[2][0]),
                           (want[0][0], want[1][0], want[2][0]), q)
    assert co.stats()["largest_batch"] > 1
    k1, k1b = _engine_key(eng), _engine_key(eng)
    assert k1 == k1b
    eng2 = type(eng)(eng.turbos, fused=eng.fused)     # a refreshed wrapper
    assert _engine_key(eng2) != k1
    assert _engine_key(eng2) == _engine_key(eng2)


# ---------------------------------------------------------------------------
# F1-F3: the plain versions against the reference's fused programs
# ---------------------------------------------------------------------------

# three partitions of different (nsw, Hpt); the reference's mesh of 2
# pads them to four (the fourth all zero)
FUSED_PARTS = ((2, 33), (1, 9), (2, 17))
FUSED_QC = 8


def _fused_inputs():
    """Per partition (qscale, hi, lo, wq, live) from sweep_inputs, and the
    reference's stacked, padded arrays of them."""
    parts = [sweep_inputs(40 + i, qc=FUSED_QC, hpt=hpt, nsw=nsw)
             for i, (nsw, hpt) in enumerate(FUSED_PARTS)]
    S, Sp = len(parts), 4
    nsw_max = max(n for n, _ in FUSED_PARTS)
    hw = max(h for _, h in FUSED_PARTS)
    dpc, dpr = nsw_max * k.N_CHUNKS, nsw_max * k.SW_ROWS
    st = {"qscale": np.ones((Sp, FUSED_QC, 1), np.float32),
          "hi": np.zeros((Sp, dpc, hw, 16, 128), np.int8),
          "lo": np.zeros((Sp, dpc, hw, 16, 128), np.int8),
          "wq": np.zeros((Sp, 2, FUSED_QC, hw), np.int8),
          "live": np.zeros((Sp, dpr, 128), np.float32)}
    for i, (qs, hi, lo, wq, live) in enumerate(parts):
        st["qscale"][i] = qs
        st["hi"][i, :hi.shape[0], :hi.shape[1]] = hi
        st["lo"][i, :lo.shape[0], :lo.shape[1]] = lo
        st["wq"][i, :, :, :wq.shape[2]] = wq
        st["live"][i, :live.shape[0]] = live
    assert S < Sp
    return parts, st, nsw_max


def _port_args(parts, st):
    S = len(parts)
    return (torch.from_numpy(st["qscale"][:S].copy()),
            [torch.from_numpy(p[1]) for p in parts],
            [torch.from_numpy(p[2]) for p in parts],
            torch.from_numpy(st["wq"][:S].copy()),
            [torch.from_numpy(p[4]) for p in parts],
            [n for n, _ in FUSED_PARTS])


N_ROWS = 33


def test_fused_sweep_rowmax_plain_bitwise():
    parts, st, nsw_max = _fused_inputs()
    want = np.asarray(ref_turbo._fused_sweep_disj(
        jnp.asarray(st["qscale"]), jnp.asarray(st["hi"]),
        jnp.asarray(st["lo"]), jnp.asarray(st["wq"]),
        jnp.asarray(st["live"]), mesh=make_mesh(2, dp=1), QC=FUSED_QC,
        nsw=nsw_max, n_rows=N_ROWS))
    qs, hi, lo, wq, live, nsw = _port_args(parts, st)
    got = k.fused_sweep_rowmax(qs, hi, lo, wq, live, nsw=nsw, n_rows=N_ROWS)
    assert np.array_equal(got.numpy(), want[:len(parts)])
    # and each partition alone, through K2 and the row pick
    for i in range(len(parts)):
        rm, rr = k.sweep_rowmax(qs[i], hi[i], lo[i],
                                wq[i, :, :, :hi[i].shape[1]].contiguous(),
                                live[i], nsw=nsw[i])
        assert torch.equal(k.pick_rows(rm, rr, n_rows=N_ROWS), got[i])
    assert np.all(want[len(parts):, :, :N_ROWS] == -1)   # the padding


def _conj_parts(parts, st, rng):
    """nreq / wp per partition: a required slot and a must_not one among
    each query's weighted slots, stacked as the reference takes them."""
    Sp, _, _, hw = st["wq"].shape
    nreq = np.zeros((Sp, FUSED_QC, 1), np.int32)
    wp = np.zeros((Sp, FUSED_QC, hw), np.int8)
    for i, (_, hi, _, wq, _) in enumerate(parts):
        for q in range(FUSED_QC):
            slots = np.nonzero(wq[0, q])[0]
            if len(slots):
                wp[i, q, slots[0]] = 1
                nreq[i, q, 0] = 1
            other = int(rng.integers(0, hi.shape[1]))
            if other not in slots[:1]:
                wp[i, q, other] = -2
    return nreq, wp


def test_fused_sweep_rowmax_conj_plain_bitwise():
    parts, st, nsw_max = _fused_inputs()
    nreq, wp = _conj_parts(parts, st, np.random.default_rng(7))
    want = np.asarray(ref_turbo._fused_sweep_bool(
        jnp.asarray(st["qscale"]), jnp.asarray(nreq), jnp.asarray(st["hi"]),
        jnp.asarray(st["lo"]), jnp.asarray(st["wq"]), jnp.asarray(wp),
        jnp.asarray(st["live"]), mesh=make_mesh(2, dp=1), QC=FUSED_QC,
        nsw=nsw_max, n_rows=N_ROWS))
    qs, hi, lo, wq, live, nsw = _port_args(parts, st)
    S = len(parts)
    got = k.fused_sweep_rowmax_conj(
        qs, torch.from_numpy(nreq[:S].copy()), hi, lo, wq,
        torch.from_numpy(wp[:S].copy()), live, nsw=nsw, n_rows=N_ROWS)
    assert np.array_equal(got.numpy(), want[:S])
    # the gate matters: the disjunctive sweep keeps other rows
    disj = k.fused_sweep_rowmax(qs, hi, lo, wq, live, nsw=nsw, n_rows=N_ROWS)
    assert not torch.equal(disj, got)


def test_fused_sweep_rowmax_bitset_plain_bitwise():
    """F3 on each partition's own packed bitsets (partition-local slots:
    each partition's sentinels inside its slice of the reference's
    stacked bits); clause rows of real slots, the ones sentinel, and the
    zero sentinel (an inactive row)."""
    parts, st, nsw_max = _fused_inputs()
    Sp = st["wq"].shape[0]
    S = len(parts)
    hw = st["wq"].shape[3]
    rng = np.random.default_rng(9)
    bits_ref = np.zeros((Sp, hw + 1, nsw_max * k.SW_WORD_ROWS, 128),
                        np.uint32)
    q_slots = np.zeros((Sp, FUSED_QC, k.BITSET_CLAUSES), np.int32)
    q_neg = np.zeros((Sp, FUSED_QC, k.BITSET_NEGS), np.int32)
    port_bits = []
    for i, (_, hi, lo, _, _) in enumerate(parts):
        b = k.pack_presence_bits(torch.from_numpy(hi), torch.from_numpy(lo))
        port_bits.append(b)
        bits_ref[i, :b.shape[0], :b.shape[1]] = b.numpy().view(np.uint32)
        hp = hi.shape[1] - 1                 # zero sentinel Hp, ones Hp + 1
        for q in range(FUSED_QC):
            if q == FUSED_QC - 1:
                q_slots[i, q] = hp                           # inactive row
                q_neg[i, q] = hp
                continue
            req = rng.choice(hp, size=1 + q % 2, replace=False)
            q_slots[i, q] = [req[j % len(req)] if q % 3 else hp + 1
                             for j in range(k.BITSET_CLAUSES)]
            q_neg[i, q] = hp
            if q % 2:
                q_neg[i, q, 0] = int(rng.integers(0, hp))
    want_p, want_c = ref_turbo._fused_sweep_bitset(
        jnp.asarray(st["qscale"]), jnp.asarray(q_slots), jnp.asarray(q_neg),
        jnp.asarray(bits_ref), jnp.asarray(st["hi"]), jnp.asarray(st["lo"]),
        jnp.asarray(st["wq"]), jnp.asarray(st["live"]),
        mesh=make_mesh(2, dp=1), QC=FUSED_QC, nsw=nsw_max, n_rows=N_ROWS)
    qs, hi, lo, wq, live, nsw = _port_args(parts, st)
    got_p, got_c = k.fused_sweep_rowmax_bitset(
        qs, torch.from_numpy(q_slots[:S].copy()),
        torch.from_numpy(q_neg[:S].copy()), port_bits, hi, lo, wq, live,
        nsw=nsw, n_rows=N_ROWS)
    assert np.array_equal(got_p.numpy(), np.asarray(want_p)[:S])
    assert np.array_equal(got_c.numpy(), np.asarray(want_c)[:S])
    assert got_c.numpy().any() and not got_c.numpy()[:, -1].any()


def test_fused_wrappers_reject_bad_inputs():
    parts, st, _ = _fused_inputs()
    qs, hi, lo, wq, live, nsw = _port_args(parts, st)
    with pytest.raises(ValueError):          # one nsw too many
        k.fused_sweep_rowmax(qs, hi, lo, wq, live, nsw=nsw + [1], n_rows=33)
    with pytest.raises(ValueError):          # weights narrower than a cache
        k.fused_sweep_rowmax(qs, hi, lo, wq[..., :9].contiguous(), live,
                             nsw=nsw, n_rows=33)
    with pytest.raises(ValueError):          # nsw past a partition's columns
        k.fused_sweep_rowmax(qs, hi, lo, wq, live, nsw=[2, 2, 2], n_rows=33)
    with pytest.raises(TypeError):
        k.fused_sweep_rowmax(qs.double(), hi, lo, wq, live, nsw=nsw,
                             n_rows=33)
    bits = [k.pack_presence_bits(h, l_) for h, l_ in zip(hi, lo)]
    bad = torch.full((len(parts), FUSED_QC, k.BITSET_CLAUSES), 12,
                     dtype=torch.int32)  # past the second partition's 11
    with pytest.raises(ValueError):
        k.fused_sweep_rowmax_bitset(
            qs, bad, torch.zeros((len(parts), FUSED_QC, k.BITSET_NEGS),
                                 dtype=torch.int32),
            bits, hi, lo, wq, live, nsw=nsw, n_rows=33)


# ---------------------------------------------------------------------------
# fault containment on the fused route
# ---------------------------------------------------------------------------

BATCH = [["t0", "t1"], ["t3"], [("t2", 2.0), "t5"], ["t7", "t0", "t9"]]


@pytest.fixture
def eng2():
    """A warm two-partition twin (tests/test_faults.py's eng2)."""
    tw = Twin([(900, _pcorpus(900, 40, 1)), (1300, _pcorpus(1300, 32, 2))])
    tw.port.search_many([BATCH], k=10)
    tw.ref.search_many([BATCH], k=10)
    yield tw
    faults.clear()
    ref_faults.clear()


def _host_many(eng, batch, kk):
    per = [t.search_many_host([batch], k=kk)[0] for t in eng.turbos]
    return eng._merge3(per, len(batch), kk)


def test_fused_dispatch_fault_bit_identical(eng2):
    """fused_dispatch:raise@1 is contained (that chunk's partitions take
    the exact host merge), the rows bitwise the host route's, in both
    packages, and the record names the site."""
    want = _host_many(eng2.port, BATCH, 10)
    _assert_rows_equal(want, _host_many(eng2.ref, BATCH, 10), "host")
    logs = []
    for eng, fmod in ((eng2.ref, ref_faults), (eng2.port, faults)):
        flog = []
        with fmod.inject("fused_dispatch:raise@1"):
            got = eng.search_many([BATCH], k=10, fault_log=flog)[0]
        _assert_rows_equal(got, want, "fused_dispatch")
        logs.append([f.site for f in flog])
    assert logs[0] == logs[1] and "fused_dispatch" in logs[1]


def test_merge_kernel_fault_degrades_to_host_merge(eng2):
    want = _host_many(eng2.port, BATCH, 10)
    h0 = eng2.port.merge_stats["merge_host"]
    flog = []
    with faults.inject("merge_kernel:raise@1"):
        got = eng2.port.search_many([BATCH], k=10, fault_log=flog)[0]
    _assert_rows_equal(got, want, "merge_kernel")
    assert eng2.port.merge_stats["merge_host"] == h0 + 1
    assert any(f.site == "merge_kernel" for f in flog)


def test_partition_column_fault_isolated():
    """A fresh twin: column_upload#1 faults partition 1's first build; it
    is served by its host tier, its peer by the fused launch, and a clean
    retry is served on the device again."""
    tw = Twin([(600, _pcorpus(600, 40, 3)), (800, _pcorpus(800, 32, 4))])
    want = _host_many(tw.port, BATCH, 10)
    try:
        flog = []
        with faults.inject("column_upload#1:raise@1"):
            got = tw.port.search_many([BATCH], k=10, fault_log=flog)[0]
        _assert_rows_equal(got, want, "column_upload#1")
        assert [(f.site, f.partition) for f in flog] == \
            [("column_upload", 1)]
        _assert_rows_equal(tw.port.search_many([BATCH], k=10)[0], want,
                           "recovered")
    finally:
        faults.clear()


def test_kernel_error_in_fused_dispatch_propagates(eng2, monkeypatch):
    """A KernelLaunchError inside the fused dispatch is not contained: it
    leaves the engine, and try_msearch, as on every other route."""
    def no_launch(*a, **kw):
        raise KernelLaunchError("fused_sweep_rowmax launch failed: "
                                "cudaError 1")

    monkeypatch.setattr(k, "fused_sweep_rowmax", no_launch)
    monkeypatch.setattr(k, "fused_sweep_rowmax_bitset", no_launch)
    flog = []
    with pytest.raises(KernelLaunchError):
        eng2.port.search_many([BATCH], k=10, fault_log=flog)
    assert not flog
    with pytest.raises(KernelLaunchError):
        eng2.port.search_bool([{"must": [("t0", 1.0)]}], k=10)
    assert eng2.port.health.flat_stats()["health_device_faults"] == 0


def test_kernel_error_in_fused_dispatch_leaves_try_msearch(monkeypatch):
    from elasticsearch_tpu_torch.cluster.state import IndexMetadata
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.index_service import IndexService

    monkeypatch.setenv("ES_TPU_FORCE_TURBO", "1")
    monkeypatch.setenv("ES_TPU_TURBO_COLD_DF", "2")
    monkeypatch.setenv("ES_TPU_COALESCE_US", "0")
    meta = IndexMetadata(index="fused_ke", uuid="fused_ke",
                         settings=Settings({}),
                         mappings={"properties": {"body": {"type": "text"}}})
    svc = IndexService(meta, device="cpu")
    try:
        words = ["alpha", "beta", "gamma", "delta"]
        for part in range(2):          # two segments: two partitions
            for i in range(20):
                svc.index_doc(f"{part}-{i}", {
                    "body": f"{words[i % 4]} {words[(i + part) % 4]}"})
            svc.refresh()
        eng = svc.serving.snapshot().engine("body")
        assert eng.fused and len(eng.turbos) == 2

        def no_launch(*a, **kw):
            raise KernelLaunchError("fused_sweep_rowmax launch failed")

        monkeypatch.setattr(k, "fused_sweep_rowmax", no_launch)
        with pytest.raises(KernelLaunchError):
            svc.serving.try_msearch([{"query": {"match": {"body": "alpha"}}}],
                                    "query_then_fetch")
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# the Turbo scrub regions (tests/test_integrity.py's Turbo cases)
# ---------------------------------------------------------------------------


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


def _scrub_corpus(n_docs=1500, vocab=120, seed=7):
    """tests/test_integrity.py's corpus."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    lens = rng.integers(4, 20, size=n_docs).astype(np.int64)
    tokens = rng.choice(vocab, size=int(lens.sum()),
                        p=probs).astype(np.int64)
    tok_docs = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    fp = build_field_postings("body", lens, tok_docs, tokens,
                              [f"t{i}" for i in range(vocab)])
    return fp, n_docs


def _scrub_turbo(ref: bool, cold_df: int = 10):
    fp, n = _scrub_corpus()
    if ref:
        return ref_turbo.TurboBM25(ref_stack([_Seg(n, fp)], "body",
                                             serve_only=True),
                                   hbm_budget_bytes=64 << 20,
                                   cold_df=cold_df)
    return TurboBM25(build_stacked_bm25([_Seg(n, carry(fp))], "body"),
                     hbm_budget_bytes=64 << 20, cold_df=cold_df,
                     device="cpu")


def _cycle(m):
    return [m.scrub_once() for _ in range(m.scrub_registry_size())]


QUERIES = [[("t1", 1.0), ("t3", 1.0)], [("t2", 2.0)],
           [("t5", 1.0), ("t9", 1.0), ("t1", 1.0)]]


def test_hbm_scrub_detects_and_repairs_injected_flip(clean_scrub):
    """An injected hbm_region flip on lane_docs is found and repaired from
    the host copy, in both packages; the repaired engine answers as a
    never-scrubbed one and the next cycle is clean."""
    control = _scrub_turbo(False)
    integrity.reset_scrub_for_tests()
    for ref, m, fm in ((False, integrity, faults),
                       (True, ref_integrity, ref_faults)):
        turbo = _scrub_turbo(ref)
        assert m.scrub_registry_size() >= 5
        _cycle(m)
        st = m.integrity_stats()
        assert st["scrub_mismatches"] == 0 and st["scrub_clean"] >= 3
        with fm.inject("hbm_region#lane_docs:raise@1x1"):
            results = _cycle(m)
        hit = [r for r in results if r and r["result"] == "mismatch"]
        assert len(hit) == 1 and hit[0]["region"].endswith(".lane_docs")
        st = m.integrity_stats()
        assert st["scrub_mismatches"] == 1 and st["scrub_repairs"] == 1
        assert st["scrub_repaired_bytes"] > 0
        _cycle(m)
        assert m.integrity_stats()["scrub_mismatches"] == 1
        if not ref:
            got = turbo.search_many([QUERIES], k=10)[0]
            want = control.search_many([QUERIES], k=10)[0]
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
            port_regions = sorted(r.name for r in integrity._REGIONS)
        else:
            ref_regions = sorted(r.name for r in ref_integrity._REGIONS)
    assert port_regions == ref_regions


def test_hbm_scrub_repairs_real_device_corruption(clean_scrub):
    """No injection: flipped bits written into the port's live tensor in
    place are found by the scrubber and repaired from the host copy."""
    turbo = _scrub_turbo(False)
    good = turbo.live.clone()
    bad = np.frombuffer(integrity.bitflip(good.numpy().tobytes()),
                        np.float32).reshape(good.shape)
    turbo.live.copy_(torch.from_numpy(bad.copy()))
    assert not torch.equal(turbo.live, good)
    for _ in range(integrity.scrub_registry_size() * 2):
        integrity.scrub_once()
    assert integrity.integrity_stats()["scrub_repairs"] >= 1
    assert torch.equal(turbo.live, good)


def test_scrub_baseline_regions_track_legitimate_updates(clean_scrub):
    """The column cache (updated in place) scrubs against a baseline per
    cols_epoch: new columns move the epoch and re-baseline, never a
    mismatch; so do the slice pool and the bitsets once made (cold_df
    raised so that the corpus has cold terms, which take slices)."""
    turbo = _scrub_turbo(False, cold_df=60)
    turbo.search_many([[[("t1", 1.0)]]], k=5)
    for _ in range(integrity.scrub_registry_size() * 2):
        integrity.scrub_once()
    before = integrity.integrity_stats()["scrub_mismatches"]
    fp = turbo.fp
    cold = [t for t in fp.terms
            if 0 < fp.doc_freq[fp.term_to_ord[t]] < turbo.cold_df]
    turbo.search_many([[[("t2", 1.0), ("t4", 1.0)], [(cold[0], 1.0)]]], k=5)
    turbo.search_bool([{"must": [("t1", 1.0), ("t2", 1.0)]}], k=5)
    for _ in range(integrity.scrub_registry_size() * 2):
        integrity.scrub_once()
    st = integrity.integrity_stats()
    assert st["scrub_mismatches"] == before
    assert st["scrub_baselined"] >= 1
    names = {r.name for r in integrity._REGIONS}
    assert {"cols_hi", "cols_lo", "cols_bits", "sparse_pool"} <= names
