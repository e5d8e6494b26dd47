"""The port's BlockMaxBM25 and spmd programs against the reference's, on the
CPU.

The same seeded numpy corpus goes through the reference on its CPU mesh
(its XLA programs) and through the port with `device="cpu"` (the K10
`lane_topk` and K11 `weighted_block_scatter` kernels' plain versions, torch
for the rest). The reference sums a doc's lanes with a log-step scan and the
port in term order (ROADMAP W2), so the contract is tests/test_blockmax.py's
`assert_topk_equal`: scores within rtol and atol 2e-5, ids and order equal
wherever adjacent scores are separated beyond that, the same set across
near-ties. The port's empty slots are (0, 0, 0) where the reference's device
programs leave -inf scores; the comparison maps -inf to 0. Host paths
(`_bool_host`, `search_phrase`) are held bitwise, and the routing counters
(`last_timing`'s n_queries and n_overflow) equal.

The cases are those of tests/test_blockmax.py, tests/test_parallel.py and
tests/test_positions.py's BlockMax phrase case, plus each kernel's plain
version against the reference program it replaces.
"""

import numpy as np
import pytest
import torch

import elasticsearch_tpu.parallel.blockmax as ref_bm
from elasticsearch_tpu.index.engine import InternalEngine as RefEngine
from elasticsearch_tpu.index.segment import build_field_postings
from elasticsearch_tpu.mapper import MapperService as RefMapper
from elasticsearch_tpu.parallel import (
    build_stacked_bm25 as ref_stack, build_stacked_knn as ref_stack_knn,
    make_mesh, prepare_query_blocks as ref_prepare,
    sharded_bm25_topk as ref_sharded, sharded_knn_topk as ref_knn,
    shard_for_id,
)
from elasticsearch_tpu.parallel.spmd import (
    Bm25ColumnCache as RefCache, unpack_ids_np,
)
import elasticsearch_tpu_torch.parallel.blockmax as bm
from elasticsearch_tpu_torch.index.segment import (
    POSTINGS_ARRAYS, VectorColumn, postings_from_arrays,
)
from elasticsearch_tpu_torch.parallel import kernels
from elasticsearch_tpu_torch.parallel.blockmax import BlockMaxBM25
from elasticsearch_tpu_torch.parallel.spmd import (
    Bm25ColumnCache, build_stacked_bm25, build_stacked_knn,
    prepare_query_blocks, sharded_bm25_topk, sharded_knn_topk,
)

torch.set_num_threads(1)

VOCAB = 300
N_DOCS = 3000


# ---------------------------------------------------------------------------
# corpora (tests/test_blockmax.py) and their carry-over to the port
# ---------------------------------------------------------------------------


class _Seg:
    pass


def zipf_corpus(rng, n_docs, n_shards):
    probs = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    probs /= probs.sum()
    lens = rng.integers(4, 40, size=n_docs).astype(np.int64)
    terms = rng.choice(VOCAB, size=int(lens.sum()), p=probs)
    shard_of = rng.integers(0, n_shards, size=n_docs)
    names = [f"t{i}" for i in range(VOCAB)]
    segments = []
    for s in range(n_shards):
        mask = shard_of == s
        doc_lens = lens[mask]
        tok_doc_global = np.repeat(np.arange(n_docs), lens)
        tok_mask = mask[tok_doc_global]
        local_ord = np.cumsum(mask) - 1
        tok_docs = local_ord[tok_doc_global[tok_mask]]
        fp = build_field_postings("body", doc_lens, tok_docs.astype(np.int64),
                                  terms[tok_mask].astype(np.int64), names)
        seg = _Seg()
        seg.n_docs = int(mask.sum())
        seg.postings = {"body": fp}
        segments.append(seg)
    return segments


def draw_queries(rng, n, n_terms=(1, 2, 3)):
    qprobs = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    qprobs /= qprobs.sum()
    out = []
    for _ in range(n):
        m = int(rng.choice(n_terms))
        out.append([f"t{t}" for t in rng.choice(VOCAB, size=m, p=qprobs,
                                                replace=False)])
    return out


def carry(segments, field="body"):
    """The port's partitions over the reference segments' arrays."""
    out = []
    for seg in segments:
        new = _Seg()
        new.n_docs = seg.n_docs
        new.postings = {}
        for f, fp in seg.postings.items():
            new.postings[f] = postings_from_arrays(
                {n: getattr(fp, n) for n in POSTINGS_ARRAYS}, fp.terms,
                fp.sum_doc_len, field=f)
        new.vectors = {
            f: VectorColumn(vc.vectors, vc.norms, vc.exists, vc.dims,
                            vc.similarity)
            for f, vc in getattr(seg, "vectors", {}).items()}
        out.append(new)
    return out


def port_engine(segments, live=None):
    st = build_stacked_bm25(carry(segments), "body", live, device="cpu",
                            device_arrays=True, serve_only=True)
    return BlockMaxBM25(st, "cpu")


def finite(x):
    return np.where(np.isfinite(x), x, 0.0).astype(np.float32)


def assert_topk_equal(ref, got, q, queries):
    """tests/test_blockmax.py's rule: scores within rtol / atol 2e-5; same
    (partition, ord) order wherever adjacent scores are separated beyond
    that, the same set across near-ties. -inf (the reference's empty slot)
    compares as the port's 0."""
    ref_s, ref_sh, ref_o = ref
    got_s, got_sh, got_o = got
    rs, gs = finite(ref_s[q]), np.asarray(got_s[q])
    np.testing.assert_allclose(gs, rs, rtol=2e-5, atol=2e-5)
    valid = rs > 0
    assert ((gs > 0) == valid).all(), f"query {q}: {queries[q]}"
    ref_ids = list(zip(ref_sh[q][valid], ref_o[q][valid]))
    got_ids = list(zip(got_sh[q][valid], got_o[q][valid]))
    s = rs[valid]
    gaps = np.abs(np.diff(s)) > 2e-5 * np.abs(s[:-1]) + 2e-5
    if gaps.all():
        assert got_ids == ref_ids, f"query {q}: {queries[q]}"
    else:
        assert set(got_ids) == set(ref_ids), f"query {q}: {queries[q]}"


def assert_all(ref, got, queries):
    for q in range(len(queries)):
        assert_topk_equal(ref, got, q, queries)


# ---------------------------------------------------------------------------
# tests/test_blockmax.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 4])
def test_blockmax_matches_exhaustive(n_shards):
    rng = np.random.default_rng(17)
    segments = zipf_corpus(rng, N_DOCS, n_shards)
    mesh = make_mesh(n_shards, dp=1)
    stacked = ref_stack(segments, "body", mesh=mesh)
    ref = ref_bm.BlockMaxBM25(stacked, mesh)
    port = port_engine(segments)
    queries = draw_queries(rng, 40)

    exhaustive = ref_sharded(mesh, stacked, *ref_prepare(stacked, queries),
                             k=10)
    want = ref.search(queries, k=10)
    got = port.search(queries, k=10)
    assert_all(want, got, queries)
    assert_all(exhaustive, got, queries)
    for key in ("n_queries", "n_overflow"):
        assert port.last_timing[key] == ref.last_timing[key], key


def test_blockmax_culls_blocks():
    """A frequent term's low-impact blocks are dropped when a rare term
    sets the bar, and the port keeps exactly the reference's blocks."""
    n_docs = 20_000
    lens = np.full(n_docs, 10, np.int64)
    tok_docs, tok_terms = [], []
    rng = np.random.default_rng(11)
    for d in range(n_docs):
        toks = []
        if d % 8 == 0 and d < 19200:          # 2400 docs with "common" (tf 1)
            toks.append(0)
        if 960 <= d < 1088 and d % 8 == 0:    # 16 of them with tf 8
            toks.extend([0] * 7)
        if 4000 <= d < 4020:                  # 20 docs with "rare"
            toks.append(1)
        while len(toks) < 10:
            toks.append(2 + int(rng.integers(0, 5000)))
        tok_docs.extend([d] * 10)
        tok_terms.extend(toks[:10])
    names = ["common", "rare"] + [f"f{i}" for i in range(5000)]
    fp = build_field_postings("body", lens, np.asarray(tok_docs, np.int64),
                              np.asarray(tok_terms, np.int64), names)
    seg = _Seg()
    seg.n_docs = n_docs
    seg.postings = {"body": fp}
    mesh = make_mesh(1, dp=1)
    ref = ref_bm.BlockMaxBM25(ref_stack([seg], "body", mesh=mesh), mesh)
    port = port_engine([seg])

    want = ref.search([["common", "rare"]], k=10)
    got = port.search([["common", "rare"]], k=10)
    assert_all(want, got, [["common", "rare"]])
    mc = port._terms["common"]
    assert mc.hot_slot < 0, "common unexpectedly classified hot"
    n_blocks = len(mc.blocks[0].ids)
    assert n_blocks >= 15
    q = [[("common", 1.0), ("rare", 1.0)]]
    sel, max_total = port._select(q, np.asarray([got[0][0][-1]], np.float32))
    rsel, rmax = ref._select(q, np.asarray([finite(want[0])[0][-1]],
                                           np.float32))
    kept = int(sel[0]["common"][0].sum())
    assert kept < n_blocks // 2, f"kept {kept} of {n_blocks} common blocks"
    assert np.array_equal(sel[0]["common"][0], rsel[0]["common"][0])
    assert max_total == rmax


def _brute_bool(segments, total_docs, avgdl, spec, k):
    """tests/test_blockmax.py's dense reference: scores + coverage per
    partition, filter, rank."""
    from elasticsearch_tpu.ops import bm25_idf

    must = [(t, b, True) for t, b in spec.get("must", ())]
    must += [(t, 0.0, True) for t in spec.get("filter", ())]
    should = [(t, b, False) for t, b in spec.get("should", ())]
    nm = len(must)
    out = []
    df_of = {}
    for t, _, _ in must + should:
        df_of[t] = sum(int(fp.doc_freq[fp.term_to_ord[t]])
                       for fp in (s.postings["body"] for s in segments)
                       if t in fp.term_to_ord)
    for si, seg in enumerate(segments):
        fp = seg.postings["body"]
        bs = ref_bm._host_block_scores(fp, avgdl)
        scores = np.zeros(seg.n_docs, np.float32)
        cover = np.zeros(seg.n_docs, np.int32)
        for t, b, req in must + should:
            if df_of[t] == 0:
                continue
            o = fp.term_to_ord.get(t)
            if o is None:
                continue
            w = bm25_idf(total_docs, df_of[t]) * b
            lo, hi = int(fp.post_start[o]), int(fp.post_start[o + 1])
            docs = fp.post_doc[lo:hi]
            start, cnt = int(fp.block_start[o]), int(fp.block_count[o])
            lane = bs[start:start + cnt].ravel()
            ld = fp.block_docs[start:start + cnt].ravel()
            nz = lane > 0
            scores[ld[nz]] += (w * lane[nz]).astype(np.float32)
            if req:
                cover[docs] += 1
        ok = (cover == nm) & (scores > 0)
        docs = np.nonzero(ok)[0]
        if len(docs):
            sel = np.lexsort((docs, -scores[docs]))[:k]
            out.extend((float(scores[docs[i]]), si, int(docs[i])) for i in sel)
    out.sort(key=lambda x: (-x[0], x[1], x[2]))
    return out[:k]


def _bool_queries(rng):
    qprobs = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    qprobs /= qprobs.sum()
    queries = []
    for _ in range(30):
        terms = [f"t{t}" for t in rng.choice(VOCAB, size=5, p=qprobs,
                                             replace=False)]
        queries.append({
            "must": [(terms[0], 1.0),
                     (terms[1], float(rng.choice([1.0, 2.0])))],
            "should": [(terms[2], 1.0), (terms[3], 1.0)],
            "filter": [terms[4]] if rng.random() < 0.5 else [],
        })
    # hot-term cases: t0/t1 are stopword-grade under the Zipf draw
    queries.append({"must": [("t0", 1.0)], "should": [("t5", 1.0)]})
    queries.append({"must": [("t0", 1.0), ("t1", 1.0)], "filter": ["t2"]})
    queries.append({"must": [("t200", 1.0)], "filter": ["t0"]})
    queries.append({"must": [("absent-term", 1.0), ("t1", 1.0)]})
    # a term both required and filtered counts twice toward coverage
    queries.append({"must": [("t3", 1.0)], "filter": ["t3"]})
    return queries


@pytest.mark.parametrize("n_shards,host_conj_df", [(1, 0), (2, 0),
                                                   (1, 1 << 16)])
def test_search_bool_matches_brute_force(n_shards, host_conj_df,
                                         monkeypatch):
    """host_conj_df=0 sends every query to the device program (K10's bool
    mode); the default threshold routes these small-df queries to the host
    conjunction, which is host code and bitwise equal to the reference's."""
    monkeypatch.setattr(ref_bm, "_HOST_CONJ_DF", host_conj_df)
    monkeypatch.setattr(bm, "_HOST_CONJ_DF", host_conj_df)
    rng = np.random.default_rng(41)
    segments = zipf_corpus(rng, N_DOCS, n_shards)
    mesh = make_mesh(n_shards, dp=1)
    stacked = ref_stack(segments, "body", mesh=mesh)
    ref = ref_bm.BlockMaxBM25(stacked, mesh)
    port = port_engine(segments)
    queries = _bool_queries(rng)

    got = port.search_bool(queries, k=10)
    want = ref.search_bool(queries, k=10)
    assert_all(want, got, queries)
    if host_conj_df:
        assert np.array_equal(got[0], finite(want[0]))
    for qi_, spec in enumerate(queries):
        exp = _brute_bool(segments, stacked.total_docs, stacked.avgdl,
                          spec, 10)
        res = [(float(got[0][qi_][j]), int(got[1][qi_][j]),
                int(got[2][qi_][j])) for j in range(10) if got[0][qi_][j] > 0]
        assert len(res) == len(exp), f"query {qi_}: {spec}"
        for (es, _, _), (gs, _, _) in zip(exp, res):
            assert abs(es - gs) <= 2e-5 * abs(es) + 2e-5, f"query {qi_}"
        ws = np.asarray([w[0] for w in exp])
        gaps = np.abs(np.diff(ws)) > 2e-5 * np.abs(ws[:-1]) + 2e-5
        if gaps.all():
            assert [(sh, o) for _, sh, o in exp] == \
                [(sh, o) for _, sh, o in res], f"query {qi_}: {spec}"
        else:
            assert {(sh, o) for _, sh, o in exp} == \
                {(sh, o) for _, sh, o in res}, f"query {qi_}: {spec}"


def test_search_bool_overflow_fallback(monkeypatch):
    rng = np.random.default_rng(43)
    segments = zipf_corpus(rng, N_DOCS, 1)
    mesh = make_mesh(1, dp=1)
    stacked = ref_stack(segments, "body", mesh=mesh)
    queries = [{"must": [("t10", 1.0)], "should": [("t20", 1.0)]}
               for _ in range(3)]
    want_brute = [_brute_bool(segments, stacked.total_docs, stacked.avgdl,
                              q, 10) for q in queries]
    for mod in (ref_bm, bm):
        monkeypatch.setattr(mod, "_MAX_BUCKET", 4)
        monkeypatch.setattr(mod, "_HOST_CONJ_DF", 0)
    ref = ref_bm.BlockMaxBM25(stacked, mesh)
    port = port_engine(segments)
    got = port.search_bool(queries, k=10)
    assert_all(ref.search_bool(queries, k=10), got, queries)
    for qi_, w in enumerate(want_brute):
        res = [(int(got[1][qi_][j]), int(got[2][qi_][j]))
               for j in range(10) if got[0][qi_][j] > 0]
        assert [(sh, o) for _, sh, o in w] == res
    # t10 and t20 are hot at this size (df > n/8), so those queries keep no
    # sparse block and take the device program; a hot must (df > n/4, past
    # the host conjunction's cut) with sparse shoulds past a one-block
    # bucket takes _bool_exhaustive, host code: bitwise
    sparse = [t for t in (f"t{i}" for i in range(25, 300))
              if (m := port._term_meta(t)) is not None and m.hot_slot < 0
              and len(m.blocks[0].ids) >= 1][:4]
    queries = [{"must": [("t0", 1.0)], "should": [(sparse[0], 1.0),
                                                  (sparse[1], 2.0)]},
               {"must": [("t1", 1.0)], "filter": ["t0"],
                "should": [(sparse[2], 1.0), (sparse[3], 1.0)]}]
    for mod in (ref_bm, bm):
        monkeypatch.setattr(mod, "_MAX_BUCKET", 1)
    calls = []
    real = port._bool_exhaustive
    monkeypatch.setattr(port, "_bool_exhaustive",
                        lambda *a: calls.append(1) or real(*a))
    got = port.search_bool(queries, k=10)
    want = ref.search_bool(queries, k=10)
    assert len(calls) == len(queries)
    assert np.array_equal(got[0], finite(want[0])) and (got[0] > 0).any()
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g[got[0] > 0], w[got[0] > 0])


def test_overflow_path_matches_exhaustive(monkeypatch):
    """Queries whose surviving blocks exceed the largest bucket take the
    scatter path (K11) and stay exact; forced by shrinking the
    bucket ladder so ordinary queries overflow."""
    rng = np.random.default_rng(23)
    segments = zipf_corpus(rng, N_DOCS, 2)
    mesh = make_mesh(2, dp=1)
    stacked = ref_stack(segments, "body", mesh=mesh)
    queries = draw_queries(rng, 12)
    exhaustive = ref_sharded(mesh, stacked, *ref_prepare(stacked, queries),
                             k=10)
    for mod in (ref_bm, bm):
        monkeypatch.setattr(mod, "_GROUP_SHAPES", [(8, 512)])
        monkeypatch.setattr(mod, "_MAX_BUCKET", 8)
    # the reference's scatter in chunks of 16 blocks; the port's in one
    # launch, a run a term
    monkeypatch.setattr(ref_bm, "_OVERFLOW_CHUNK", 16)
    ref = ref_bm.BlockMaxBM25(stacked, mesh)
    port = port_engine(segments)
    got = port.search(queries, k=10)
    want = ref.search(queries, k=10)
    assert_all(want, got, queries)
    assert_all(exhaustive, got, queries)
    assert port.last_timing["n_overflow"] == ref.last_timing["n_overflow"]
    # at this corpus size few queries keep more than 8 sparse blocks a
    # partition: a one-block ladder sends most of them to the overflow path
    for mod in (ref_bm, bm):
        monkeypatch.setattr(mod, "_GROUP_SHAPES", [(1, 512)])
        monkeypatch.setattr(mod, "_MAX_BUCKET", 1)
    monkeypatch.setattr(ref_bm, "_OVERFLOW_CHUNK", 2)
    got = port.search(queries, k=10)
    want = ref.search(queries, k=10)
    assert_all(want, got, queries)
    assert_all(exhaustive, got, queries)
    assert port.last_timing["n_overflow"] == ref.last_timing["n_overflow"] > 0


def test_live_mask_and_hot_columns_match():
    """Deleted docs never surface; the hot columns equal the reference's."""
    rng = np.random.default_rng(29)
    segments = zipf_corpus(rng, N_DOCS, 2)
    live = [np.random.default_rng(s).random(seg.n_docs) > 0.2
            for s, seg in enumerate(segments)]
    mesh = make_mesh(2, dp=1)
    ref = ref_bm.BlockMaxBM25(ref_stack(segments, "body", live_masks=live,
                                        mesh=mesh), mesh)
    port = port_engine(segments, live)
    assert np.array_equal(port.hot_cols.numpy(), np.asarray(ref.hot_cols))
    assert port.hbm_bytes() == ref.hbm_bytes()
    queries = draw_queries(rng, 30)
    got = port.search(queries, k=10)
    assert_all(ref.search(queries, k=10), got, queries)
    for q in range(len(queries)):
        for s, o, sc in zip(got[1][q], got[2][q], got[0][q]):
            if sc > 0:
                assert live[s][o]


# ---------------------------------------------------------------------------
# each plain kernel against the reference program it replaces
# ---------------------------------------------------------------------------


def _engines(n_shards, seed=31, live=None):
    rng = np.random.default_rng(seed)
    segments = zipf_corpus(rng, N_DOCS, n_shards)
    mesh = make_mesh(n_shards, dp=1)
    ref = ref_bm.BlockMaxBM25(ref_stack(segments, "body", live_masks=live,
                                        mesh=mesh), mesh)
    return rng, mesh, ref, port_engine(segments, live)


def _unpacked(packed):
    p = np.asarray(packed)
    return p[:, 0], unpack_ids_np(p[:, 1]), unpack_ids_np(p[:, 2])


def _ported(packed):
    return packed[:, 0], packed[:, 1].astype(np.int32), \
        packed[:, 2].astype(np.int32)


@pytest.mark.parametrize("n_shards", [1, 3])
def test_lane_topk_plain_matches_reference_programs(n_shards):
    """K10's plain version, behind the port's hybrid and lane programs,
    against the reference's `_hybrid_program` (`_one_query_topk`,
    `_lane_candidates`) and `_lane_program` on the same assembled rows,
    all blocks kept (no culling) and in pass A's best-block assembly."""
    import jax.numpy as jnp

    rng, mesh, ref, port = _engines(n_shards)
    queries = draw_queries(rng, 24, n_terms=(1, 2, 3, 4))
    flat = [[(t, 1.0) for t in dict.fromkeys(q)] for q in queries]
    for q in flat:
        for t, _ in q:
            ref._term_meta(t)
            port._term_meta(t)
    st = ref.stacked
    for sel, bucket in (([{}] * len(flat), 256), (None, bm.PASS_A_BLOCKS)):
        rW, rqb, rqi = ref._assemble(flat, sel, bucket)
        W, qb, qi, ts = port._assemble(flat, sel, bucket)
        assert np.array_equal(W, rW) and np.array_equal(qb, rqb) \
            and np.array_equal(qi, rqi)
        want = _unpacked(ref_bm._hybrid_program(
            st.block_docs, st.block_scores, st.live, ref.hot_cols,
            jnp.asarray(rW), jnp.asarray(rqb), jnp.asarray(rqi),
            mesh=mesh, k=10))
        got = _ported(port._hybrid_program(W, qb, qi, ts, 10))
        assert_all(want, got, flat)
        lane = [i for i, q in enumerate(flat)
                if all(not port._terms.get(t) or port._terms[t].hot_slot < 0
                       for t, _ in q)]
        want = _unpacked(ref_bm._lane_program(
            st.block_docs, st.block_scores, st.live,
            jnp.asarray(rqb[lane]), jnp.asarray(rqi[lane]), mesh=mesh,
            k=10))
        got = _ported(port._lane_program(qb[lane], qi[lane], ts[lane], 10))
        assert_all(want, got, [flat[i] for i in lane])


def test_lane_topk_bool_plain_matches_reference_program(monkeypatch):
    """K10's bool mode behind the port's bool program against the
    reference's `_bool_program` (`_one_query_topk_bool`)."""
    monkeypatch.setattr(ref_bm, "_HOST_CONJ_DF", 0)
    monkeypatch.setattr(bm, "_HOST_CONJ_DF", 0)
    rng, mesh, ref, port = _engines(2, seed=37)
    queries = _bool_queries(rng)
    calls = {"ref": [], "port": []}
    real_ref, real_port = ref_bm._bool_program, port._bool_program

    def spy_ref(*a, **kw):
        out = real_ref(*a, **kw)
        calls["ref"].append(_unpacked(out))
        return out

    def spy_port(*a):
        out = real_port(*a)
        calls["port"].append(_ported(out))
        return out

    monkeypatch.setattr(ref_bm, "_bool_program", spy_ref)
    monkeypatch.setattr(port, "_bool_program", spy_port)
    port.search_bool(queries, k=10)
    ref.search_bool(queries, k=10)
    assert calls["port"] and len(calls["port"]) <= len(calls["ref"])
    got = tuple(np.concatenate([c[i] for c in calls["port"]])
                for i in range(3))
    want = tuple(np.concatenate([c[i] for c in calls["ref"]])
                 for i in range(3))
    # the reference pads each dispatch to its Qc: its real rows come first
    n = len(got[0])
    rows = []
    off = 0
    for c in calls["ref"]:
        rows.extend(range(off, off + len(c[0])))
        off += len(c[0])
    assert len(rows) >= n
    real = []
    off = 0
    for c_port, c_ref in zip(calls["port"], calls["ref"]):
        real.extend(range(off, off + len(c_port[0])))
        off += len(c_ref[0])
    want = tuple(w[real] for w in want)
    assert_all(want, got, list(range(n)))


def test_weighted_block_scatter_plain_matches_reference_scatter():
    """K11's plain version and the port's accumulator top-k against the
    reference's `_scatter_chunk` + `_acc_topk`, term by term in chunks."""
    import jax.numpy as jnp

    rng, mesh, ref, port = _engines(2, seed=53)
    st = ref.stacked
    for q in draw_queries(rng, 8, n_terms=(2, 3, 4)):
        terms = [(t, 1.0) for t in dict.fromkeys(q)]
        got = port._exhaustive_topk(terms, {}, 10)
        want = ref._exhaustive_topk(terms, {}, 10)
        assert_all(_unpacked(want[None]), _ported(got[None]), [terms])
    # the accumulator itself: one term's blocks, weight w
    t = "t3"
    m = port._term_meta(t)
    ref._term_meta(t)
    ids = [m.blocks[s].ids for s in range(2)]
    width = max(len(b) for b in ids)
    qb = np.zeros((2, width), np.int32)
    qw = np.zeros((2, width), np.float32)
    for s, b in enumerate(ids):
        qb[s, : len(b)] = b
        qw[s, : len(b)] = np.float32(m.idf)
    acc = torch.zeros((2, 1, port.D), dtype=torch.float32)
    kernels.weighted_block_scatter(acc, torch.from_numpy(qb),
                                   torch.from_numpy(qw),
                                   port.stacked.block_docs,
                                   port.stacked.block_scores)
    racc = ref_bm._scatter_chunk(
        st.block_docs, st.block_scores, jnp.zeros((2, port.D), jnp.float32),
        jnp.asarray(qb), jnp.asarray(qw), mesh=mesh)
    assert np.array_equal(acc[:, 0].numpy(), np.asarray(racc))


@pytest.mark.parametrize("chunk", [8192, 16])
@pytest.mark.parametrize("n_shards", [1, 3])
def test_exhaustive_runs_match_reference_chunks(n_shards, chunk,
                                                monkeypatch):
    """The overflow path's accumulator: the port's one K11 call (plain
    version), a run a non-hot term in term order, bitwise equal to the
    reference's `_scatter_chunk` on the chunks its `_exhaustive_topk`
    builds (the query's terms concatenated per shard, each slot with its
    term's weight; one chunk of 8192 slots, or chunks of 16); and both
    engines' top-k, on queries of 2-4 terms and on 100-term bodies, under
    tests/test_blockmax.py's rule."""
    rng, mesh, ref, port = _engines(n_shards, seed=59)
    monkeypatch.setattr(ref_bm, "_OVERFLOW_CHUNK", chunk)
    queries = draw_queries(rng, 6, n_terms=(2, 3, 4)) + [
        [f"t{t}" for t in rng.choice(VOCAB, 100, replace=False)]
        for _ in range(2)]
    got_acc, want_acc, held = [], [], 0
    scatter, chunk_fn = kernels.weighted_block_scatter, ref_bm._scatter_chunk

    def spy(acc, *args, **kw):
        assert kw["runs"] is None or len(kw["runs"]) > 2   # None: one run
        out = scatter(acc, *args, **kw)
        got_acc.append(out[:, 0].clone().numpy())
        return out

    def ref_spy(*args, **kw):
        out = chunk_fn(*args, **kw)
        want_acc.append(np.asarray(out))
        return out

    monkeypatch.setattr(kernels, "weighted_block_scatter", spy)
    monkeypatch.setattr(ref_bm, "_scatter_chunk", ref_spy)
    for q in queries:
        terms = [(t, 1.0) for t in dict.fromkeys(q)]
        for t, _ in terms:
            port._term_meta(t)
            ref._term_meta(t)
        got_acc.clear()
        want_acc.clear()
        got = port._exhaustive_topk(terms, {}, 10)
        want = ref._exhaustive_topk(terms, {}, 10)
        assert len(got_acc) <= 1
        if got_acc:
            assert np.array_equal(got_acc[0].view(np.int32),
                                  want_acc[-1].view(np.int32))
            held += 1
        else:
            assert not want_acc or not want_acc[-1].any()
        assert_all(_unpacked(want[None]), _ported(got[None]), [terms])
    assert held >= 6, held


def test_stacked_device_arrays_match_reference():
    """build_stacked_bm25(device_arrays=True) holds the reference's
    stacked fields bit for bit; without it, only host metadata."""
    rng = np.random.default_rng(3)
    segments = zipf_corpus(rng, 900, 3)
    live = [np.arange(s.n_docs) % 5 != 1 for s in segments]
    r = ref_stack(segments, "body", live_masks=live)
    p = build_stacked_bm25(carry(segments), "body", live, device="cpu",
                           device_arrays=True)
    for name in ("block_docs", "block_tfs", "block_scores", "doc_len",
                 "live"):
        assert np.array_equal(getattr(p, name).numpy(),
                              np.asarray(getattr(r, name))), name
    for a, b in zip(p.block_max_scores, r.block_max_scores):
        assert np.array_equal(a, b[: len(a)])
    assert (p.avgdl, p.total_docs, p.max_docs) == \
        (r.avgdl, r.total_docs, r.max_docs)
    h = build_stacked_bm25(carry(segments), "body", live)
    assert h.block_docs is None and h.block_max_scores is None
    s = build_stacked_bm25(carry(segments), "body", live, device="cpu",
                           device_arrays=True, serve_only=True)
    assert s.block_tfs is None and s.doc_len is None


# ---------------------------------------------------------------------------
# tests/test_parallel.py
# ---------------------------------------------------------------------------

MAPPING = {"properties": {"body": {"type": "text"},
                          "vec": {"type": "dense_vector", "dims": 16}}}
N_PAR_DOCS = 400
N_SHARDS = 4


def par_corpus(rng):
    vocab = [f"w{i}" for i in range(80)]
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    probs /= probs.sum()
    docs = {}
    for i in range(N_PAR_DOCS):
        body = " ".join(rng.choice(vocab, size=int(rng.integers(4, 40)),
                                   p=probs))
        vec = rng.normal(size=16).astype(np.float32)
        docs[str(i)] = {"body": body, "vec": vec.tolist()}
    return docs


def _segments(docs, n):
    engines = [RefEngine(RefMapper(dict(MAPPING))) for _ in range(n)]
    for doc_id, src in docs.items():
        engines[shard_for_id(doc_id, n) if n > 1 else 0].index(doc_id, src)
    for e in engines:
        e.refresh()
    return [e.acquire_searcher().views[0].segment for e in engines]


@pytest.fixture(scope="module")
def sharded():
    rng = np.random.default_rng(7)
    docs = par_corpus(rng)
    return docs, _segments(docs, N_SHARDS)


def _both(segments, live=None):
    mesh = make_mesh(len(segments), dp=1)
    ref = ref_stack(segments, "body", live_masks=live, mesh=mesh)
    port = build_stacked_bm25(carry(segments), "body", live, device="cpu",
                              device_arrays=True)
    return mesh, ref, port


def test_sharded_bm25_matches_reference(sharded):
    _, segments = sharded
    mesh, ref, port = _both(segments)
    queries = [["w0", "w3"], ["w1"], ["w5", "w9", "w21"], ["w2", "w40"]]
    qb, qi = prepare_query_blocks(port, queries)
    rqb, rqi = ref_prepare(ref, queries)
    assert np.array_equal(qb, rqb) and np.array_equal(qi, rqi)
    got = sharded_bm25_topk(port, qb, qi, k=10)
    want = ref_sharded(mesh, ref, rqb, rqi, k=10)
    assert_all(want, got, queries)


def test_sharded_bm25_single_terms_top_hit(sharded):
    """test_parallel.py's dp case without a mesh: every query's best hit
    contains its term."""
    _, segments = sharded
    mesh, ref, port = _both(segments)
    queries = [["w0"], ["w1"], ["w2"], ["w3"]]
    got = sharded_bm25_topk(port, *prepare_query_blocks(port, queries), k=5)
    assert got[0].shape == (4, 5)
    want = ref_sharded(mesh, ref, *ref_prepare(ref, queries), k=5)
    assert_all(want, got, queries)
    for qn, terms in enumerate(queries):
        src = segments[got[1][qn, 0]].sources[got[2][qn, 0]]["body"]
        assert terms[0] in src.split()


def test_sharded_knn_matches_reference(sharded):
    docs, segments = sharded
    mesh = make_mesh(4, dp=1)
    ref = ref_stack_knn(segments, "vec", mesh=mesh)
    port = build_stacked_knn(carry(segments), "vec", device="cpu")
    queries = np.random.default_rng(3).normal(size=(3, 16)).astype(np.float32)
    got = sharded_knn_topk(port, queries, k=5)
    want = ref_knn(mesh, ref, queries, k=5)
    assert_all(want, got, list(range(3)))
    all_ids = sorted(docs)
    mat = np.stack([np.asarray(docs[d]["vec"], np.float32) for d in all_ids])
    for qn in range(3):
        cos = mat @ queries[qn] / (np.linalg.norm(mat, axis=1)
                                   * np.linalg.norm(queries[qn]))
        exp = [all_ids[i] for i in np.argsort(-cos)[:5]]
        assert [segments[sh].doc_ids[o]
                for sh, o in zip(got[1][qn], got[2][qn])] == exp


def test_live_mask_excludes_deleted(sharded):
    _, segments = sharded
    mesh, ref, port = _both(segments)
    qb, qi = prepare_query_blocks(port, [["w0"]])
    _, shard_of, ord_of = sharded_bm25_topk(port, qb, qi, k=3)
    best = (int(shard_of[0, 0]), int(ord_of[0, 0]))
    live = [np.ones(seg.n_docs, bool) for seg in segments]
    live[best[0]][best[1]] = False
    mesh, ref2, port2 = _both(segments, live)
    got = sharded_bm25_topk(port2, qb, qi, k=3)
    assert best not in list(zip(got[1][0], got[2][0]))
    assert_all(ref_sharded(mesh, ref2, qb, qi, k=3), got, [["w0"]])


def test_column_cache_matches_block_path(sharded):
    _, segments = sharded
    mesh, ref, port = _both(segments)
    cache = Bm25ColumnCache(port, capacity=64)
    rcache = RefCache(ref, mesh, capacity=64)
    queries = [["w0", "w3"], ["w1"], ["w5", "w9", "w21"], ["w2", "w40"]]
    got = cache.search(queries, k=10)
    assert_all(rcache.search(queries, k=10), got, queries)
    assert_all(sharded_bm25_topk(port, *prepare_query_blocks(port, queries),
                                 k=10), got, queries)
    # second batch reuses cached columns (w0/w1) + adds a cold term
    queries2 = [["w0"], ["w1", "w60"]]
    got2 = cache.search(queries2, k=5)
    assert_all(rcache.search(queries2, k=5), got2, queries2)
    assert cache.term_slot.keys() == rcache.term_slot.keys()


def test_column_cache_eviction():
    docs = par_corpus(np.random.default_rng(11))
    segments = _segments(docs, 2)
    mesh, ref, port = _both(segments)
    cache = Bm25ColumnCache(port, capacity=4)
    rcache = RefCache(ref, mesh, capacity=4)
    for q in (["w0", "w1"], ["w2", "w3"], ["w4", "w5"]):
        cache.search([q], k=3)
        rcache.search([q], k=3)
    assert len(cache.term_slot) <= 4
    assert cache.term_slot.keys() == rcache.term_slot.keys()
    # evicted terms are rebuilt correctly
    got = cache.search([["w0", "w1"]], k=3)
    assert_all(rcache.search([["w0", "w1"]], k=3), got, [["w0", "w1"]])


def test_column_cache_never_evicts_current_batch_terms():
    docs = par_corpus(np.random.default_rng(12))
    segments = _segments(docs, 1)
    mesh, ref, port = _both(segments)
    cache = Bm25ColumnCache(port, capacity=4)
    cache.search([["w0", "w1", "w2", "w3"]], k=3)
    got = cache.search([["w0", "w1", "w2", "w4"]], k=3)
    assert set(cache.term_slot) == {"w0", "w1", "w2", "w4"}
    want = ref_sharded(mesh, ref, *ref_prepare(ref, [["w0", "w1", "w2",
                                                      "w4"]]), k=3)
    assert_all(want, got, [0])
    with pytest.raises(ValueError):
        cache.search([["w0", "w1", "w2"], ["w4", "w5"]], k=3)


# ---------------------------------------------------------------------------
# tests/test_positions.py's BlockMax phrase case
# ---------------------------------------------------------------------------


def test_blockmax_search_phrase_matches_reference():
    """search_phrase is host code: bitwise equal to the reference's."""
    rng = np.random.default_rng(21)
    segs = []
    for _ in range(2):
        n_docs = 200
        lens = rng.integers(3, 30, size=n_docs).astype(np.int64)
        tokens = rng.choice(10, size=int(lens.sum())).astype(np.int64)
        tok_docs = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
        tok_pos = np.concatenate([np.arange(n, dtype=np.int64)
                                  for n in lens])
        names = [f"t{i:02d}" for i in range(10)]
        seg = _Seg()
        seg.n_docs = n_docs
        seg.postings = {"body": build_field_postings(
            "body", lens, tok_docs, tokens, names, token_pos=tok_pos)}
        segs.append(seg)
    mesh = make_mesh(1, dp=1)
    ref = ref_bm.BlockMaxBM25(ref_stack(segs, "body", mesh=mesh), mesh)
    port = port_engine(segs)
    live = [np.arange(200) % 7 != 3, np.ones(200, bool)]
    phrases = [[names[2], names[5]], [names[1], names[1]],
               [names[0], names[3], names[4]], ["absent", names[2]]]
    for slop in (0, 1, 2):
        for lh in (None, live):
            got = port.search_phrase(phrases, k=10, slop=slop, live_host=lh)
            want = ref.search_phrase(phrases, k=10, slop=slop, live_host=lh)
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
    assert (got[0] > 0).any()
