"""The port's ops/scoring.py against the reference's jit functions, bitwise,
on the CPU.

The same seeded block postings (tests/torch_kernel_cases.py) go through the
reference's `bm25_scatter_scores` / `constant_scatter_mask` / `masked_top_k`
/ `total_hits` (jit on the CPU) and through the port's, whose block scatter
runs its plain version (`kernels.bm25_block_scatter_plain`,
`block_presence_plain`) for CPU tensors; the plain versions are also called
directly. Tolerance 0 everywhere: the BM25 denominator follows XLA-CPU's
fused multiply-add (ROADMAP W6; without it 3,664 of the 34,778 live
lanes of the head term differ by an ulp), and a term's postings hold each doc once, so
storing each live lane's score equals the reference's scatter-add into
zeros (W4). `masked_top_k` holds lax.top_k's tie order (W3) on tied
scores, with k above the masked count and with everything masked; its
padding slots are (-inf, 0, invalid) where lax.top_k gives the lowest
-inf columns, and only `valid` is compared there.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import scoring as ref
from elasticsearch_tpu_torch.ops import scoring as port
from elasticsearch_tpu_torch.parallel import kernels as k
from torch_kernel_cases import (
    SCATTER_CASES, SCATTER_EDGE_CASES, presence_ids, scatter_case,
    scatter_edge_case, scatter_ladder, scatter_postings,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def postings():
    return scatter_postings()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("avgdl_scale", [1.0, 0.37, 1e-9])
@pytest.mark.parametrize("case", SCATTER_CASES)
def test_bm25_scatter_scores_bitwise(postings, case, avgdl_scale):
    fp, avgdl = postings
    ids, idf = scatter_case(fp, case)
    avg = max(avgdl * avgdl_scale, 1e-9)
    n = len(fp.doc_len)
    want = np.asarray(ref.bm25_scatter_scores(
        fp.block_docs, fp.block_tfs, fp.doc_len, ids, idf,
        np.float32(avg), n_docs=n, k1=1.2, b=0.75))
    got = port.bm25_scatter_scores(
        _t(fp.block_docs), _t(fp.block_tfs), _t(fp.doc_len), _t(ids),
        _t(idf), float(np.float32(avg)), n_docs=n, k1=1.2, b=0.75)
    plain = k.bm25_block_scatter_plain(
        _t(ids), _t(idf), _t(fp.block_docs), _t(fp.block_tfs),
        _t(fp.doc_len), avgdl=avg, k1=1.2, b=0.75)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert torch.equal(plain, got)
    assert (want > 0).sum() == int(fp.doc_freq[
        np.searchsorted(fp.block_start, ids[0], side="right") - 1])


def test_bm25_denominator_needs_the_fma(postings):
    """The head term's scores without the contraction differ from the
    reference's: the fused multiply-add is what makes them bitwise."""
    fp, avgdl = postings
    ids, idf = scatter_case(fp, "head")
    want = np.asarray(ref.bm25_scatter_scores(
        fp.block_docs, fp.block_tfs, fp.doc_len, ids, idf,
        np.float32(avgdl), n_docs=len(fp.doc_len)))
    rows = _t(ids).long()
    tf = _t(fp.block_tfs)[rows].reshape(-1)
    docs = _t(fp.block_docs)[rows].reshape(-1).long()
    live = tf > 0
    dl = _t(fp.doc_len)[docs[live]]
    t = 0.25 + (0.75 * dl) / torch.full_like(dl, float(np.float32(avgdl)))
    unfused = tf[live] + float(np.float32(1.2)) * t
    w = _t(idf)[torch.nonzero(live).reshape(-1) // 128]
    s = (w * tf[live]) * float(np.float32(2.2)) / unfused
    assert (s.numpy() != want[docs[live].numpy()]).sum() > 0


@pytest.mark.parametrize("n_terms", [1, 12, 40])
def test_constant_scatter_mask_bitwise(postings, n_terms):
    fp, _ = postings
    ids = presence_ids(fp, n_terms)
    n = len(fp.doc_len)
    want = np.asarray(ref.constant_scatter_mask(
        fp.block_docs, fp.block_tfs, ids, n_docs=n))
    got = port.constant_scatter_mask(_t(fp.block_docs), _t(fp.block_tfs),
                                     _t(ids), n_docs=n)
    plain = k.block_presence_plain(_t(ids), _t(fp.block_docs),
                                   _t(fp.block_tfs), n_docs=n)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(plain, got)


@pytest.fixture(scope="module")
def postings_odd():
    """40,001 docs: n_docs not a multiple of 4 or 16."""
    return scatter_postings(seed=3, n_docs=40_001)


@pytest.fixture(scope="module")
def postings_large():
    """200,000 docs: a head term of some 1,500 rows."""
    return scatter_postings(seed=5, n_docs=200_000, n_terms=4_000)


def _both_bitwise(docs, tfs, doc_len, ids, idf, avgdl):
    """Both wrappers on the CPU against the reference's jit functions on
    one row list, bitwise."""
    n = len(doc_len)
    want = np.asarray(ref.bm25_scatter_scores(
        docs, tfs, doc_len, ids, idf, np.float32(avgdl), n_docs=n, k1=1.2,
        b=0.75))
    got = k.bm25_block_scatter(_t(ids), _t(idf), _t(docs), _t(tfs),
                               _t(doc_len), avgdl=avgdl, k1=1.2, b=0.75)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    want_mask = np.asarray(ref.constant_scatter_mask(docs, tfs, ids,
                                                     n_docs=n))
    got_mask = k.block_presence(_t(ids), _t(docs), _t(tfs), n_docs=n)
    assert np.array_equal(got_mask.numpy(), want_mask)
    assert int(got_mask.sum()) == int((want > 0).sum())


@pytest.mark.parametrize("size", ["odd", "large"])
@pytest.mark.parametrize("case", SCATTER_EDGE_CASES)
def test_block_scatter_edges_bitwise(postings_odd, postings_large, case,
                                     size):
    """The card tests' block-scatter edges (rows shuffled, a ragged row
    count, a live row 0) through the port's wrappers on the CPU and the
    reference's jit functions, on 40,001 docs and on 200,000."""
    fp, avgdl = postings_odd if size == "odd" else postings_large
    fp, ids, idf = scatter_edge_case(fp, case)
    _both_bitwise(fp.block_docs, fp.block_tfs, fp.doc_len, ids, idf, avgdl)


@pytest.mark.parametrize("n_rows", [1, 37, 300])
def test_block_scatter_ladder_bitwise(n_rows):
    """The card tests' row-count ladder (scatter_ladder: rows made
    directly) at small counts, through the port's wrappers on the CPU and
    the reference."""
    docs, tfs, doc_len, ids, idf, avgdl = scatter_ladder(n_rows)
    _both_bitwise(docs, tfs, doc_len, ids, idf, avgdl)


def test_pad_block_ids_same(postings):
    fp, _ = postings
    for o in (0, 5, 700):
        ids = fp.term_block_ids(fp.terms[o])
        assert np.array_equal(port.pad_block_ids(ids), ref.pad_block_ids(ids))
    assert np.array_equal(port.pad_block_ids(np.arange(3), 16),
                          ref.pad_block_ids(np.arange(3), 16))


def _scores(case, n, rng):
    if case == "ties":
        return rng.integers(0, 4, size=n).astype(np.float32)
    return rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("case,n,density,kk", [
    ("ties", 500, 0.5, 10), ("ties", 500, 0.02, 50),     # k above the count
    ("random", 2000, 0.3, 100), ("ties", 300, 0.0, 10),   # all masked
    ("random", 64, 1.0, 64), ("ties", 1000, 0.9, 1)])
def test_masked_top_k_and_total_hits_bitwise(case, n, density, kk):
    rng = np.random.default_rng(n + kk)
    s = _scores(case, n, rng)
    m = rng.random(n) < density
    ws, wo, wv = (np.asarray(x) for x in ref.masked_top_k(s, m, k=kk))
    gs, go, gv = (x.numpy() for x in port.masked_top_k(_t(s), _t(m), k=kk))
    assert np.array_equal(gv, wv)
    assert np.array_equal(gs[gv].view(np.int32), ws[wv].view(np.int32))
    assert np.array_equal(go[gv], wo[wv])
    assert (gs[~gv] == -np.inf).all() and (go[~gv] == 0).all()
    assert int(gv.sum()) == min(kk, int(m.sum()))
    t = port.total_hits(_t(m))
    assert t.dtype == torch.int32 and int(t) == int(ref.total_hits(m))


def test_scatter_wrappers_check_their_inputs(postings):
    fp, avgdl = postings
    ids, idf = scatter_case(fp, "rare")
    args = [_t(ids), _t(idf), _t(fp.block_docs), _t(fp.block_tfs),
            _t(fp.doc_len)]
    with pytest.raises(TypeError):
        k.bm25_block_scatter(args[0].long(), *args[1:], avgdl=avgdl,
                             k1=1.2, b=0.75)
    with pytest.raises(ValueError):
        k.bm25_block_scatter(args[0], args[1][:-1], *args[2:], avgdl=avgdl,
                             k1=1.2, b=0.75)
    with pytest.raises(ValueError):
        k.block_presence(args[0], args[2][:, :64].contiguous(),
                         args[3][:, :64].contiguous(), n_docs=10)
    with pytest.raises(ValueError):
        port.bm25_scatter_scores(args[2], args[3], args[4], args[0],
                                 args[1], avgdl, n_docs=7)
    k.reset_launches()
    k.bm25_block_scatter(*args, avgdl=avgdl, k1=1.2, b=0.75)
    k.block_presence(args[0], args[2], args[3], n_docs=len(fp.doc_len))
    assert k.LAUNCHES["bm25_block_scatter"] == 0 == \
        k.LAUNCHES["block_presence"]          # CPU: the plain versions
