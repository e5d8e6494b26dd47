"""The CUDA kernels against their plain torch versions on the card.

Marked `cuda`: each test skips without an NVIDIA Hopper card (decided
inside the test). On the H100 run it without the repo's conftest, which
imports jax for the reference tests:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Inputs are the adversarial cases of the CPU differential tests (ties,
negative and all-zero weights, padding lanes, zero groups, overlapping
cold slices, the batched K3 cases (shared docs, chunk boundaries at one
doc, tiles that meet with no shared doc, narrowed tile ranges, docs past
the grid, empty queries, a duplicated term, a 256-query group), fan-in
padding, overflow and sentinel rows, the bitset pack's columns (lo
only, bytes of -128, an all-zero slot, odd nsw), K2's group edges (QC
not a multiple of the group, a group weighting every slot, all-zero
queries, a dead
superwindow, tied rows), K7's on its own (filters, a must_not in the
top row, nreq 0, the integer path, padding queries, lists past the
capacity), K6's on K2's with masks (a masked-out superwindow, an all-zero
mask, empty 16-bit halves), dead rows and windows, exact score ties,
empty merge lanes,
agg pad chunks, buckets past n_segments, unsorted pairs over several tiles,
tile ranges that disagree with the pairs, padded batches, the two-level
blob, a hot bucket; the word design's Q of 5 to 64 over grouped,
doc-ordered and hot layouts, runs across chunks and tiles), K4's rank-merge
edges (copied triples, NaN / -0.0 / negative lanes, few positive lanes, L
not a multiple of 32) plus shapes the main path does not reach (more slots
than a block has threads, a query tile that is not full, 4096-d rows) and
K9's tiling cases (query tiles, a short last chunk of windows, rows that all
tie, idle windows), and the block scatter's head, mid and rare terms, a
boosted idf, several terms' blocks for the presence mask, row ids
outside the block arrays, and its edges (rows shuffled, a row count that
is not a whole number of the kernel's steps, a live row 0, 40,001 and
200,000 docs, a ladder of row counts up to 8 x the warps the card holds,
so that every grid plan is taken), K10 `lane_topk` at the four (bucket,
Qc) shapes of BlockMax's dispatch groups in its lane, hybrid and bool
modes with ties, a k past the block's threads, a term in two runs, empty
rows and runs and a dead partition, rows over many tiles with ties across
them, a dense run that takes a tile several passes, rows of one tile
beside rows of many, k of 1 and 15,360, rows of 100 and 2,800 runs
(more than a pass stages: the sorted tiles and the chunks), run twice and
from a CUDA graph, BlockMax msearch of a 100-term match,
and K11 `weighted_block_scatter` at
the overflow path's 8192 blocks, into column-cache rows, and with ids and
rows outside the arrays (run twice: no atomics). Every comparison is
bitwise. Each
kernel is also run
once on outputs filled with NaN / -1 (kernels.poisoned; K1: column tiles
filled with a nonzero byte pattern; K8: its outputs and word scratch), so a
kernel that leaves an entry unwritten cannot pass on reused memory.
"""

from contextlib import nullcontext as _nullcontext

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.parallel import cuda_build
from elasticsearch_tpu_torch.parallel import kernels as k
from torch_kernel_cases import (
    AGG_CASES, AGG_WORD_CASES, CONJ_EDGE_CASES, MERGE_EDGE_CASES,
    FUSED_CASES, FUSED_CONJ_CASES, PACK_CASES, SPARSE_BATCH_CASES,
    agg_inputs, agg_masks, agg_plan, fused_conj_inputs, fused_inputs,
    agg_section, agg_word_inputs, overflow_slots, pack_inputs,
    merge_edge_inputs, bitset_edge_inputs, bitset_inputs, clause_slots,
    conj_edge_inputs, conj_inputs, knn_inputs, lanes_and_groups,
    mask_inputs, merge_inputs, sparse_batch_inputs, sparse_group,
    sparse_inputs, sweep_inputs, SWEEP_EDGE_CASES, sweep_edge_inputs,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _c(a, dev):
    return torch.from_numpy(np.array(a)).to(dev)


@pytest.mark.parametrize("seed,n_groups,rows,dense", [
    (0, 4, 3, False), (1, 8, 128, True), (2, 12, 40, False)])
def test_build_columns_kernel(dev, seed, n_groups, rows, dense):
    docs, scores, gr, gn, gb, gs = lanes_and_groups(seed, n_groups, rows,
                                                    dense)
    hpt = n_groups // 4 + 3
    shape = (4 * k.TILE // k.CHUNK, hpt, 16, 128)
    stale = np.random.default_rng(seed).integers(-5, 6, size=shape)
    outs = []
    for run in (k.build_columns, k.build_columns_plain):
        hi = _c(stale.astype(np.int8), dev)
        lo = _c(stale.astype(np.int8), dev)
        run(*(_c(a, dev) for a in (gr, gn, gb, gs, docs, scores)), hi, lo)
        outs.append((hi, lo))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("qc,hpt,nsw,case", [
    (8, 33, 2, None), (24, 700, 1, None)]
    + [(None, None, None, c) for c in SWEEP_EDGE_CASES])
def test_sweep_rowmax_kernel(dev, qc, hpt, nsw, case):
    """Random shapes and the edges of K2's group design (sweep_edge_inputs:
    QC 7, 24 and 257, QC 8 on three superwindows, a group weighting all
    700 slots, all-zero queries, a dead superwindow, tied rows)."""
    if case is None:
        qscale, hi, lo, wq, live = sweep_inputs(3, qc=qc, hpt=hpt, nsw=nsw)
    else:
        qscale, hi, lo, wq, live, nsw = sweep_edge_inputs(case)
    args = [_c(a, dev) for a in (qscale, hi, lo, wq, live)]
    km, kr = k.sweep_rowmax(*args, nsw=nsw)
    pm, pr = k.sweep_rowmax_plain(*args, nsw=nsw)
    torch.cuda.synchronize()
    assert torch.equal(km, pm) and torch.equal(kr, pr)


def _fused_args(case, dev, mode, pad_qc=None):
    """A fused wrapper's positional arguments for `mode` on the card (the
    bitsets packed from each partition's columns by the plain pack), QC
    padded with inert queries to `pad_qc` where given."""
    f = fused_inputs(case, pad_qc)
    c = {n: _c(f[n], dev) for n in ("qscale", "wq", "nreq", "wp")}
    hi = [_c(a, dev) for a in f["hi"]]
    lo = [_c(a, dev) for a in f["lo"]]
    live = [_c(a, dev) for a in f["live"]]
    if mode == "disj":
        return (c["qscale"], hi, lo, c["wq"], live), f["nsw"]
    if mode == "conj":
        return (c["qscale"], c["nreq"], hi, lo, c["wq"], c["wp"], live), \
            f["nsw"]
    bits = [k.pack_presence_bits_plain(h, l_) for h, l_ in zip(hi, lo)]
    return (c["qscale"], _c(f["q_slots"], "cpu"), _c(f["q_neg"], "cpu"),
            bits, hi, lo, c["wq"], live), f["nsw"]


FUSED_WRAPPERS = {
    "disj": ("fused_sweep_rowmax", ("fused_sweep_rowmax",)),
    "conj": ("fused_sweep_rowmax_conj", ("fused_sweep_rowmax_conj",)),
    "bitset": ("fused_sweep_rowmax_bitset",
               ("fused_intersect_bitset", "fused_sweep_rowmax_bitset")),
}


@pytest.mark.parametrize("mode", list(FUSED_WRAPPERS))
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_sweep_kernel(dev, case, mode):
    """F1-F3 bitwise their plain versions (each partition's K2, K7 or K5 +
    K6 and the row pick): partitions of different nsw and Hpt, QC not a
    multiple of the group, a cache past the list floor, and 70 partitions
    (two launches of MAX_FUSED_PARTS); QC 1 and 8 with dead padding, a
    union past one batch, staged lists past the tile's, row groups no query
    keeps and integer-path queries (at these QCs F1 and F3 run
    sweep_group_kernel; test_fused_cluster_kernel_edges pads them to the
    cluster kernel); once more on poisoned outputs and from a CUDA graph;
    one launch of each kernel per 64 partitions."""
    name, kernels_ = FUSED_WRAPPERS[mode]
    args, nsw = _fused_args(case, dev, mode)
    fn = getattr(k, name)
    plain = getattr(k, name + "_plain")
    n_launch = -(-len(nsw) // k.MAX_FUSED_PARTS)
    k.reset_launches()
    got = fn(*args, nsw=nsw, n_rows=33)
    assert all(k.LAUNCHES[x] == n_launch for x in kernels_), k.LAUNCHES
    if mode == "bitset":
        pargs = (args[0], args[1].to(dev), args[2].to(dev)) + args[3:]
        want = plain(*pargs, nsw=nsw, n_rows=33)
    else:
        want = plain(*args, nsw=nsw, n_rows=33)
    with k.poisoned():
        again = fn(*args, nsw=nsw, n_rows=33)
    torch.cuda.synchronize()
    for g, w, a in zip(got if mode == "bitset" else (got,),
                       want if mode == "bitset" else (want,),
                       again if mode == "bitset" else (again,)):
        assert torch.equal(g, w) and torch.equal(a, w)
    if case == "three":
        keep = {}

        def call():
            if mode == "bitset":      # the launches, slots on the card
                keep["out"] = k._fused_bitset_launches(
                    *pargs, nsw, 33, [int(h.shape[1]) for h in args[4]])
            else:
                keep["out"] = fn(*args, nsw=nsw, n_rows=33)

        call()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            call()
        g.replay()
        torch.cuda.synchronize()
        out = keep["out"]
        for o, w in zip(out if mode == "bitset" else (out,),
                        want if mode == "bitset" else (want,)):
            assert torch.equal(o, w)


FUSED_PAD = {"disj": k.FUSED_MIN_QC, "bitset": k.FUSED_MIN_QC_BITSET,
             "conj": k.FUSED_MIN_QC_CONJ}
FUSED_HI = {"disj": 1, "conj": 2, "bitset": 4}   # cols_hi's argument


@pytest.mark.parametrize("mode", ["disj", "bitset", "conj"])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_cluster_kernel_edges(dev, case, mode):
    """F1-F3 on every FUSED_CASES entry padded with inert queries to the
    QC from which they run the cluster kernel (fused_sweep_kernel):
    bitwise their plain versions, also on poisoned outputs, one launch of
    each kernel per 64 partitions."""
    name, kernels_ = FUSED_WRAPPERS[mode]
    bitset = mode == "bitset"
    pad = FUSED_PAD[mode]
    args, nsw = _fused_args(case, dev, mode, pad_qc=pad)
    hpt = max(int(h.shape[1]) for h in args[FUSED_HI[mode]])
    assert k.fused_sweep_plan(pad, hpt, mode)["cluster"]
    fn = getattr(k, name)
    plain = getattr(k, name + "_plain")
    k.reset_launches()
    got = fn(*args, nsw=nsw, n_rows=33)
    n_launch = -(-len(nsw) // k.MAX_FUSED_PARTS)
    assert all(k.LAUNCHES[x] == n_launch for x in kernels_), k.LAUNCHES
    pargs = ((args[0], args[1].to(dev), args[2].to(dev)) + args[3:]
             if bitset else args)
    want = plain(*pargs, nsw=nsw, n_rows=33)
    with k.poisoned():
        again = fn(*args, nsw=nsw, n_rows=33)
    torch.cuda.synchronize()
    for g, w, a in zip(got if bitset else (got,), want if bitset else (want,),
                       again if bitset else (again,)):
        assert torch.equal(g, w) and torch.equal(a, w)


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("case", FUSED_CONJ_CASES)
def test_fused_conj_kernel_edges(dev, case, pad):
    """F2 on its edges (FUSED_CONJ_CASES: coverage-only filters and
    queries with no score weight, a must_not in a query's top row, nreq 0,
    the integer path, 128 padding queries of 256, a tile whose score and
    coverage slots pass one batch) at their own QC and padded with inert
    queries to FUSED_MIN_QC_CONJ where below it, so on both sides of the
    threshold: bitwise its plain version, also on poisoned outputs, one
    launch."""
    qc = fused_conj_inputs(case)["wq"].shape[2]
    f = fused_conj_inputs(case, max(qc, k.FUSED_MIN_QC_CONJ) if pad
                          else None)
    c = {n: _c(f[n], dev) for n in ("qscale", "wq", "nreq", "wp")}
    args = (c["qscale"], c["nreq"], [_c(a, dev) for a in f["hi"]],
            [_c(a, dev) for a in f["lo"]], c["wq"], c["wp"],
            [_c(a, dev) for a in f["live"]])
    kw = {"nsw": f["nsw"], "n_rows": 33}
    k.reset_launches()
    got = k.fused_sweep_rowmax_conj(*args, **kw)
    assert k.LAUNCHES["fused_sweep_rowmax_conj"] == 1, k.LAUNCHES
    want = k.fused_sweep_rowmax_conj_plain(*args, **kw)
    with k.poisoned():
        again = k.fused_sweep_rowmax_conj(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)


def test_fused_max_parts_matches_kernel(dev):
    """kernels.MAX_FUSED_PARTS mirrors the built MAX_PARTS of both
    sources' fused entries."""
    assert cuda_build.kernel("fused_max_parts")() == k.MAX_FUSED_PARTS


def test_fused_sweep_plan_matches_kernel(dev):
    """kernels.fused_sweep_plan and the FUSED_* constants, which the CPU
    emulation of F1-F3's cluster kernel reads, are the built
    sweep_rowmax.cu's (es_fused_sweep_plan) for each of the three modes,
    the QC from which a launch runs the cluster kernel included; another
    mode is refused."""
    import ctypes

    fn = cuda_build.kernel("fused_sweep_plan")
    for qc in (1, 8, 24, 63, 64, 127, 128, 129, 256, 257, 1024):
        for hpt in (9, 97, 225, 700, 4096):
            for m, mode in enumerate(k.FUSED_MODES):
                out = (ctypes.c_int * 10)()
                assert fn(qc, hpt, m, out) == 0
                p = k.fused_sweep_plan(qc, hpt, mode)
                assert list(out) == [p[x] for x in (
                    "gq", "oq", "lc", "dc", "ring_slots", "slot_cap",
                    "smem")] + [k.FUSED_CLUSTER, k.FUSED_STAGE_ROWS,
                                int(p["cluster"])], (qc, hpt, mode)
    assert fn(64, 97, 3, (ctypes.c_int * 10)()) != 0
    for m, mode in enumerate(k.FUSED_MODES):
        assert cuda_build.kernel("fused_sweep_clusters")(256, 97, m) >= 1


def test_fused_kernels_refuse_bad_tables(dev):
    """The fused C entries refuse a table that does not fit the launch: a
    partition nsw past nsw_max, more than MAX_PARTS partitions; F1 at QC 8
    (sweep_group_kernel) and F2 at FUSED_MIN_QC_CONJ (its cluster
    kernel)."""
    stream = torch.cuda.current_stream().cuda_stream
    for mode, qc in (("disj", 8), ("conj", k.FUSED_MIN_QC_CONJ)):
        args, nsw = _fused_args("three", dev, mode, pad_qc=qc)
        i = FUSED_HI[mode]
        qscale, hi, lo, wq, live = (args[0], args[i], args[i + 1],
                                    args[i + 2], args[-1])
        table = k._sweep_table(hi, lo, live, nsw,
                               [int(h.shape[1]) for h in hi])
        rm = torch.empty((3, 2, qc, k.CAND_PAD), device=dev)
        rr = torch.empty((3, 2, qc, k.CAND_PAD), dtype=torch.int32,
                         device=dev)
        ins = ([qscale, wq] if mode == "disj"
               else [qscale, args[1], wq, args[5]])
        fn = cuda_build.kernel(FUSED_WRAPPERS[mode][0])
        for n_parts, nsw_max in ((3, 1), (k.MAX_FUSED_PARTS + 1, 2)):
            rc = fn(table.ctypes.data, n_parts,
                    *(t.data_ptr() for t in ins), rm.data_ptr(),
                    rr.data_ptr(), qc, int(wq.shape[3]), nsw_max, stream)
            assert rc != 0, (mode, n_parts, nsw_max)


def test_sweep_group_constants_match_kernel(dev):
    """kernels.SWEEP_GROUP and sweep_list_cap, which the CPU emulation of
    K2's grouping reads, are what the built sweep_rowmax.cu uses."""
    assert cuda_build.kernel("sweep_group")() == k.SWEEP_GROUP
    for hpt in (1, 15, 16, 17, 33, 225, 255, 256, 257, 700, 0xFFFF):
        assert cuda_build.kernel("sweep_list_cap")(hpt) == \
            k.sweep_list_cap(hpt), hpt


def test_sparse_gather_kernel(dev):
    coff, cw, ct0, ct1, pool = sparse_inputs(5, n_terms=9, n_tiles=6)
    args = [_c(a, dev) for a in (coff, cw, ct0, ct1, pool)]
    got = k.sparse_gather(*args, n_tiles=6)
    want = k.sparse_gather_plain(*args, n_tiles=6)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", SPARSE_BATCH_CASES + ("group",))
def test_sparse_gather_batched_kernel(dev, case):
    if case == "group":
        coff, cw, ct0, ct1, qoff, pool, n_tiles = sparse_group(4, 256)
    else:
        coff, cw, ct0, ct1, qoff, pool, n_tiles = sparse_batch_inputs(case)
    args = [_c(a, dev) for a in (coff, cw, ct0, ct1, pool)]
    qo = _c(qoff, dev)
    k.reset_launches()
    got = k.sparse_gather(*args, n_tiles=n_tiles, qoff=qo)
    # what the serving path calls: its own host check, no read-back
    got2 = k.sparse_gather(*args, n_tiles=n_tiles, qoff=qo,
                           host_checked=True)
    want = k.sparse_gather_plain(*args, n_tiles=n_tiles, qoff=qo)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got2, want)
    assert k.LAUNCHES["sparse_gather"] == (2 if len(coff) else 0)


@pytest.mark.parametrize("bad", ["granule", "qoff"])
def test_sparse_gather_batched_rejects_bad_input(dev, bad):
    coff, cw, ct0, ct1, qoff, pool, n_tiles = sparse_batch_inputs(
        "empty_query_middle")
    coff, qoff = coff.copy(), qoff.copy()
    if bad == "granule":
        coff[5] = pool.shape[0]
    else:
        qoff[2] = qoff[3] + 1
    args = [_c(a, dev) for a in (coff, cw, ct0, ct1, pool)]
    k.reset_launches()
    with pytest.raises(ValueError, match="outside the pool" if bad ==
                       "granule" else "qoff"):
        k.sparse_gather(*args, n_tiles=n_tiles, qoff=_c(qoff, dev))
    assert k.LAUNCHES["sparse_gather"] == 0


def test_launches_counted_and_bad_input_raises(dev):
    k.reset_launches()
    qscale, hi, lo, wq, live = sweep_inputs(0, qc=8, hpt=9, nsw=1)
    args = [_c(a, dev) for a in (qscale, hi, lo, wq, live)]
    k.sweep_rowmax(*args, nsw=1)
    assert k.LAUNCHES["sweep_rowmax"] == 1
    with pytest.raises(ValueError):
        k.sweep_rowmax(args[0].cpu(), *args[1:], nsw=1)
    assert k.LAUNCHES["sweep_rowmax"] == 1


@pytest.mark.parametrize("bad", [-1, "n_gran"])
def test_sparse_gather_rejects_granule_outside_pool(dev, bad):
    coff, cw, ct0, ct1, pool = sparse_inputs(5, n_terms=9, n_tiles=6)
    coff = coff.copy()
    coff[2] = pool.shape[0] if bad == "n_gran" else bad
    args = [_c(a, dev) for a in (coff, cw, ct0, ct1, pool)]
    k.reset_launches()
    with pytest.raises(ValueError, match="outside the pool"):
        k.sparse_gather(*args, n_tiles=6)
    assert k.LAUNCHES["sparse_gather"] == 0


@pytest.mark.parametrize("qc,hpt,nsw,case", [
    (8, 33, 2, None), (24, 700, 2, None)]
    + [(None, None, None, c) for c in CONJ_EDGE_CASES])
def test_sweep_rowmax_conj_kernel(dev, qc, hpt, nsw, case):
    """Random shapes and the edges of K7's group block (conj_edge_inputs:
    filters, a must_not in the top row, nreq 0, the integer path, QC 7
    and 257, 128 padding queries of 256, lists past the capacity at Hpt
    700, tied rows); the C entry once more on outputs filled with NaN."""
    from elasticsearch_tpu_torch.tools.k2_ab import run_raw

    if case is None:
        arrs = conj_inputs(7, qc=qc, hpt=hpt, nsw=nsw)
    else:
        *arrs, nsw = conj_edge_inputs(case)
    args = [_c(a, dev) for a in arrs]
    km, kr = k.sweep_rowmax_conj(*args, nsw=nsw)
    pm, pr = k.sweep_rowmax_conj_plain(*args, nsw=nsw)
    rm, rr = run_raw(cuda_build.kernel("sweep_rowmax_conj"), args, nsw,
                     poison=True)
    torch.cuda.synchronize()
    assert torch.equal(km, pm) and torch.equal(kr, pr)
    assert torch.equal(rm, pm) and torch.equal(rr, pr)


@pytest.mark.parametrize("qc,hpt,nsw,case", [
    (8, 33, 2, None), (24, 700, 3, None)]
    + [(None, None, None, c) for c in SWEEP_EDGE_CASES])
def test_sweep_rowmax_bitset_kernel(dev, qc, hpt, nsw, case):
    """Random shapes and K2's group edges with masks (bitset_edge_inputs:
    a query's first superwindow masked out, an all-zero mask, empty 16-bit
    halves); the C entry once more on outputs filled with NaN."""
    from elasticsearch_tpu_torch.tools.k2_ab import run_raw

    if case is None:
        qscale, hi, lo, wq, live = sweep_inputs(6, qc=qc, hpt=hpt, nsw=nsw)
        mask = mask_inputs(6, qc=qc, nsw=nsw)
    else:
        qscale, hi, lo, wq, mask, live, nsw = bitset_edge_inputs(case)
    args = [_c(a, dev) for a in (qscale, hi, lo, wq, mask, live)]
    km, kr = k.sweep_rowmax_bitset(*args, nsw=nsw)
    pm, pr = k.sweep_rowmax_bitset_plain(*args, nsw=nsw)
    rm, rr = run_raw(cuda_build.kernel("sweep_rowmax_bitset"), args, nsw,
                     poison=True)
    torch.cuda.synchronize()
    assert torch.equal(km, pm) and torch.equal(kr, pr)
    assert torch.equal(rm, pm) and torch.equal(rr, pr)
    assert torch.isinf(km[0, 0]).all() and torch.isinf(km[:, -1]).all()


@pytest.mark.parametrize("qc,n_slots,nsw", [(8, 13, 2), (40, 300, 3)])
def test_intersect_bitset_kernel(dev, qc, n_slots, nsw):
    bits = bitset_inputs(nsw, n_slots, nsw)
    q_slots, q_neg = clause_slots(nsw + 10, qc, n_slots)
    args = [_c(a, dev) for a in (q_slots, q_neg, bits)]
    got = k.intersect_bitset(*args, nsw=nsw)
    want = k.intersect_bitset_plain(*args, nsw=nsw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("qc,n_slots,nsw", [(8, 13, 1), (40, 300, 3),
                                             (256, 40, 2), (13, 13, 2),
                                             (300, 40, 1)])
def test_intersect_bitset_counts_kernel(dev, qc, n_slots, nsw):
    """K5's mask and counts in one launch: the mask equal to the plain
    version's, the counts to mask_chunk_counts of the kernel's own mask,
    with the slots given on the card (read back) and on the host; they
    ride in the launch's parameters, one launch per 256 queries."""
    bits = bitset_inputs(nsw + 3, n_slots, nsw)
    q_slots, q_neg = clause_slots(nsw + 20, qc, n_slots)
    args = [_c(a, dev) for a in (q_slots, q_neg, bits)]
    k.reset_launches()
    mask, counts = k.intersect_bitset_counts(*args, nsw=nsw)
    hm, hc = k.intersect_bitset_counts(_c(q_slots, "cpu"), _c(q_neg, "cpu"),
                                       args[2], nsw=nsw)
    pm, pc = k.intersect_bitset_counts_plain(*args, nsw=nsw)
    torch.cuda.synchronize()
    assert k.LAUNCHES["intersect_bitset"] == 2 * -(-qc // 256)
    assert torch.equal(mask, pm) and torch.equal(hm, pm)
    assert torch.equal(counts, k.mask_chunk_counts(mask))
    assert torch.equal(counts, pc) and torch.equal(hc, pc)
    assert counts.dtype == torch.int32 and int(counts.max()) > 0


def test_intersect_table_q_matches_kernel(dev):
    """kernels.INTERSECT_TABLE_Q mirrors the built TABLE_Q (the queries a
    host-slot launch carries)."""
    assert cuda_build.kernel("intersect_table_q")() == k.INTERSECT_TABLE_Q


def test_intersect_bitset_counts_fan_in_overflow_kernel(dev):
    """Queries cut from 11 required and 6 prohibited clauses to K5's 8 and
    4, as the engine cuts them."""
    bits = bitset_inputs(7, 40, 3)
    q_slots, q_neg, _, _ = overflow_slots(8, 24, 40)
    args = [_c(a, dev) for a in (q_slots, q_neg, bits)]
    mask, counts = k.intersect_bitset_counts(*args, nsw=3)
    pm, pc = k.intersect_bitset_counts_plain(*args, nsw=3)
    torch.cuda.synchronize()
    assert torch.equal(mask, pm) and torch.equal(counts, pc)


@pytest.mark.parametrize("on_card", [False, True])
def test_intersect_bitset_counts_rejects_slot_on_card(dev, on_card):
    """A slot outside [0, Hp+2) raises ValueError on the card route too,
    whether the slots come from the host or lie on the card, and nothing
    launches."""
    bits = _c(bitset_inputs(0, 13, 1), dev)
    q_slots, q_neg = clause_slots(1, 8, 13)
    q_neg[3, 0] = 15
    where = dev if on_card else "cpu"
    k.reset_launches()
    with pytest.raises(ValueError, match="outside the bitsets"):
        k.intersect_bitset_counts(_c(q_slots, where), _c(q_neg, where), bits,
                                  nsw=1)
    assert k.LAUNCHES["intersect_bitset"] == 0


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_presence_bits_kernel(dev, case):
    """The pack kernel (csrc/pack_bits.cu) against its plain version on the
    card and on the CPU: random columns, lo-only columns, bytes of -128,
    an all-zero slot, odd nsw, the smallest cache; one launch counted."""
    hi, lo = pack_inputs(case)
    k.reset_launches()
    got = k.pack_presence_bits(_c(hi, dev), _c(lo, dev))
    want = k.pack_presence_bits_plain(_c(hi, dev), _c(lo, dev))
    torch.cuda.synchronize()
    assert k.LAUNCHES["pack_presence_bits"] == 1
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), k.pack_presence_bits(_c(hi, "cpu"),
                                                       _c(lo, "cpu")))


def test_pack_presence_bits_on_card(dev):
    """The pack on the card writes the bits the CPU route writes."""
    _, hi, lo, _, _ = sweep_inputs(2, qc=2, hpt=11, nsw=2)
    got = k.pack_presence_bits(_c(hi, dev), _c(lo, dev)).cpu()
    want = k.pack_presence_bits(_c(hi, "cpu"), _c(lo, "cpu"))
    assert torch.equal(got, want)


@pytest.mark.parametrize("similarity", ["cosine", "dot_product", "l2_norm"])
@pytest.mark.parametrize("qc,nw,dims,masked,parts", [
    (8, 3, 48, False, 1), (37, 2, 768, True, 1), (16, 2, 4096, False, 1),
    (20, 2, 100, True, 3)])
def test_knn_int8_window_topc_kernel(dev, similarity, qc, nw, dims, masked,
                                     parts):
    qi8, qmeta, q8, meta, act, fmask = knn_inputs(
        qc + nw, qc=qc, nw=nw, dims=dims, masked=masked, n_parts=parts)
    args = [_c(a, dev) for a in (qi8, qmeta, q8, meta, act)]
    fm = None if fmask is None else _c(fmask, dev)
    ks, kr = k.knn_int8_window_topc(*args, fm, similarity=similarity)
    ps, pr = k.knn_int8_window_topc_plain(*args, fm, similarity=similarity)
    torch.cuda.synchronize()
    assert torch.equal(ks, ps) and torch.equal(kr, pr)
    assert torch.isfinite(ks).any()


# K9's two-pass tiling: query tiles of 128 (QC 1, 129, 256), a short last
# chunk of windows, dimsP 64 and 4096, stacked and masked, rows that are all
# copies of 3 (ties past the 32 kept and past the candidate list: the
# whole-row selection), and windows
# no query of a tile probes
K9_TILING = {
    "qc1": dict(qc=1, nw=2, dims=768),
    "qc129": dict(qc=129, nw=2, dims=256),
    "qc256": dict(qc=256, nw=2, dims=768),
    "short_chunk": dict(qc=40, nw=4, dims=64, pad=64),
    "dims64": dict(qc=24, nw=2, dims=60, pad=64),
    "dims4096": dict(qc=20, nw=2, dims=4096),
    "stacked4_masked": dict(qc=37, nw=3, dims=128, masked=True, n_parts=4),
    "dups": dict(qc=33, nw=2, dims=128, dups=True),
    "idle": dict(qc=140, nw=3, dims=128),
}


@pytest.mark.parametrize("similarity", ["cosine", "dot_product", "l2_norm"])
@pytest.mark.parametrize("case", sorted(K9_TILING))
def test_knn_int8_window_topc_tiling(dev, monkeypatch, similarity, case):
    kw = K9_TILING[case]
    qi8, qmeta, q8, meta, act, fmask = knn_inputs(
        len(case) + kw["qc"], **kw)
    if case == "short_chunk":     # chunks of 3 windows: [0, 3), [3, 4)
        per_window = kw["qc"] * k.KNN_W * 4
        monkeypatch.setattr(k, "KNN_SCRATCH_BYTES", 3 * per_window)
        assert k.knn_chunks(kw["nw"], k.knn_chunk_windows(
            kw["nw"], kw["qc"])) == [(0, 3), (3, 4)]
    if case == "idle":            # window 1 idle for all, query 5 for all
        act[..., :, 1] = 0.0
        act[..., 5, :] = 0.0
    args = [_c(a, dev) for a in (qi8, qmeta, q8, meta, act)]
    fm = None if fmask is None else _c(fmask, dev)
    ks, kr = k.knn_int8_window_topc(*args, fm, similarity=similarity)
    ps, pr = k.knn_int8_window_topc_plain(*args, fm, similarity=similarity)
    torch.cuda.synchronize()
    assert torch.equal(ks, ps) and torch.equal(kr, pr)
    assert torch.isfinite(ks).any()
    # a (query, window) the probe skipped keeps every slot (-inf, 0)
    idle = torch.from_numpy(act == 0).to(dev)
    idle = idle.transpose(-1, -2)[..., None].expand_as(ks)
    assert torch.isinf(ks[idle]).all() and (kr[idle] == 0).all()
    if case == "dups":            # ties beyond the 32 kept, rows ascending
        fin = torch.isfinite(ks)
        assert int(fin.sum(dim=-1).max()) == k.KNN_CANDW
        same = (ks[..., 1:] == ks[..., :-1]) & fin[..., 1:]
        assert bool(same.any())
        assert bool((kr[..., 1:] > kr[..., :-1])[same].all())


@pytest.mark.parametrize("n_parts,kk,q", [(1, 10, 16), (4, 10, 256),
                                          (3, 300, 5)])
def test_merge_topk_kernel(dev, n_parts, kk, q):
    s, o = merge_inputs(n_parts + kk, q=q, n_parts=n_parts, kk=kk)
    args = [_c(a, dev) for a in (s, o)]
    got = k.merge_topk(*args, k=kk)
    want = k.merge_topk_plain(*args, k=kk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _agg_run(fn, mask, blob, ps, n_seg):
    if len(ps) == 1:
        return [fn[0](mask, blob, p=ps[0], n_segments=n_seg)]
    return list(fn[1](mask, blob, pd=ps[0], pm=ps[1], n_segments=n_seg))


@pytest.mark.parametrize("case", sorted(AGG_CASES) + ["hot_4_tiles"])
def test_agg_counts_kernel(dev, case):
    if case == "hot_4_tiles":
        rng = np.random.default_rng(9)
        n_docs, n_seg = 200_000, 60_000
        sec = agg_section(rng, n_docs, n_seg, 1_000_000, grouped=False)
        hot = agg_section(rng, n_docs, n_seg, 500_000, head=0.3)
        mask = agg_masks(rng, 5, n_docs, live_rows=4, density=0.05)
        blob, ps = np.concatenate(list(sec) + list(hot)), [len(sec[0]),
                                                           len(hot[0])]
    else:
        mask, blob, ps, n_seg = agg_inputs(case)
    m, b = _c(mask, dev), _c(blob, dev)
    k.reset_launches()
    got = _agg_run((k.agg_segment_counts, k.agg_two_level_counts), m, b, ps,
                   n_seg)
    assert k.LAUNCHES["agg_counts"] == 1
    want = _agg_run((k.agg_segment_counts_plain,
                     k.agg_two_level_counts_plain), m, b, ps, n_seg)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    assert all(int(g.sum()) > 0 for g in got)


@pytest.mark.parametrize("case", sorted(AGG_WORD_CASES))
def test_agg_counts_word_kernel(dev, case):
    """K8's word design at its edges: Q of 5, 9, 17, 33 and 40, runs across
    chunks and a tile boundary, inconsistent ranges and 33,000 buckets at
    Q > 1; once more on outputs and word scratch filled with -1."""
    mask, blob, ps, n_seg = agg_word_inputs(case)
    m, b = _c(mask, dev), _c(blob, dev)
    k.reset_launches()
    got = _agg_run((k.agg_segment_counts, k.agg_two_level_counts), m, b, ps,
                   n_seg)
    assert k.LAUNCHES["agg_counts"] == 1
    want = _agg_run((k.agg_segment_counts_plain,
                     k.agg_two_level_counts_plain), m, b, ps, n_seg)
    with k.poisoned():
        raw = _agg_run((k.agg_segment_counts, k.agg_two_level_counts), m, b,
                       ps, n_seg)
    torch.cuda.synchronize()
    for g, w, r in zip(got, want, raw):
        assert torch.equal(g, w) and torch.equal(r, w)


AGG_Q_LAYOUTS = {   # n_docs, n_segments, n_pairs, agg_section options
    "grouped": (200_000, 300, 600_000, dict()),
    "doc_ordered": (200_000, 2161, 400_000, dict(grouped=False)),
    "hot": (200_000, 256, 500_000, dict(head=0.4)),
}


@pytest.mark.parametrize("layout", sorted(AGG_Q_LAYOUTS))
@pytest.mark.parametrize("q", [1, 4, 16, 33, 64])
def test_agg_counts_kernel_q(dev, q, layout):
    """K8 at the engine's rungs and past one word group, on a grouped
    (terms), a doc-ordered (hour ranks: 2,161 buckets, two histogram
    passes at Q 33 and 64) and a hot-bucket layout, with a quarter of the
    rows all False as a padded batch; the two-level form at the same time
    (the layout twice); once more on outputs and scratch filled with
    -1."""
    n_docs, n_seg, n_pairs, kw = AGG_Q_LAYOUTS[layout]
    rng = np.random.default_rng(q * 7 + len(layout))
    sec = agg_section(rng, n_docs, n_seg, n_pairs, **kw)
    mask = agg_masks(rng, q, n_docs, live_rows=max(1, q - q // 4),
                     density=0.05)
    blob = np.concatenate(list(sec) * 2)
    ps = [len(sec[0])] * 2
    m, b = _c(mask, dev), _c(blob, dev)
    got = _agg_run((k.agg_segment_counts, k.agg_two_level_counts), m, b, ps,
                   n_seg)
    one = k.agg_segment_counts(m, b[:blob.size // 2].contiguous(), p=ps[0],
                               n_segments=n_seg)
    want = _agg_run((k.agg_segment_counts_plain,
                     k.agg_two_level_counts_plain), m, b, ps, n_seg)
    with k.poisoned():
        raw = _agg_run((k.agg_segment_counts, k.agg_two_level_counts), m, b,
                       ps, n_seg)
    torch.cuda.synchronize()
    for g, w, r in zip(got, want, raw):
        assert torch.equal(g, w) and torch.equal(r, w)
    assert torch.equal(one, want[0]) and int(one.sum()) > 0


def test_agg_word_bytes_matches_kernel(dev):
    """kernels.agg_word_bytes, which sizes K8's scratch, is what the built
    agg_counts.cu asks for."""
    fn = cuda_build.kernel("agg_word_bytes")
    for q in (1, 2, 8, 9, 16, 17, 32, 33, 64, 256):
        for n in (1, 7, 8, 10_000_000):
            assert fn(q, n) == k.agg_word_bytes(q, n), (q, n)


def test_agg_plan_matches_kernel(dev):
    """The tests' model of K8's histogram plan (agg_plan, from
    AGG_HIST_BINS), which the emulation runs, is the plan the built
    agg_counts.cu makes (es_agg_plan): one pass for 256 buckets at every
    Q, two for 2,161 hour ranks at Q = 32 and for 60,000 buckets at
    Q = 1."""
    import ctypes

    fn = cuda_build.kernel("agg_plan")
    plan = (ctypes.c_int * 4)()
    for q in (1, 4, 8, 9, 16, 17, 26, 27, 32, 33, 40, 64, 256):
        for n_seg in (1, 256, 2161, 16_384, 33_000, 60_000):
            assert fn(q, n_seg, plan) == 0
            assert tuple(plan) == agg_plan(q, n_seg), (q, n_seg)
    assert agg_plan(32, 2161)[2] == 2 and agg_plan(1, 60_000)[2] == 2
    assert all(agg_plan(q, 256)[3] == agg_plan(q, 256)[0]
               for q in (1, 16, 32, 64))


@pytest.mark.parametrize("case", MERGE_EDGE_CASES)
def test_merge_topk_edges_kernel(dev, case):
    """K4's rank merge at its edges, by the wrapper and once more on
    outputs filled with NaN / -1."""
    s, o, kk = merge_edge_inputs(case)
    args = [_c(a, dev) for a in (s, o)]
    got = k.merge_topk(*args, k=kk)
    with k.poisoned():
        raw = k.merge_topk(*args, k=kk)
    want = k.merge_topk_plain(*args, k=kk)
    torch.cuda.synchronize()
    for g, r, w in zip(got, raw, want):
        assert torch.equal(g, w) and torch.equal(r, w)


@pytest.mark.parametrize("kernel", ["build_columns", "sparse_gather",
                                    "merge_topk", "intersect_bitset",
                                    "knn_int8_window_topc",
                                    "pack_presence_bits"])
def test_poisoned_outputs(dev, kernel):
    """W15: K1, K3, K4, K5, K9 and the bitset pack on outputs filled with
    NaN / -1 (kernels.poisoned; K1: tiles filled with a nonzero byte
    pattern, so its nrows = 0 groups must write their zeros; K5: its
    counts too, which its C entry zeroes; K9: its scratch too), bitwise
    equal to the plain versions."""
    if kernel == "build_columns":
        docs, scores, gr, gn, gb, gs = lanes_and_groups(4, 8, 40, False)
        assert (gn == 0).any()
        shape = (4 * k.TILE // k.CHUNK, 8 // 4 + 3, 16, 128)
        hi, lo, hi_p, lo_p = (torch.full(shape, 0x5A, dtype=torch.int8,
                                         device=dev) for _ in range(4))
        groups = [_c(a, dev) for a in (gr, gn, gb, gs)]
        lanes = [_c(a, dev) for a in (docs, scores)]
        k.build_columns(*groups, *lanes, hi, lo)
        k.build_columns_plain(*groups, *lanes, hi_p, lo_p)
        torch.cuda.synchronize()
        assert torch.equal(hi, hi_p) and torch.equal(lo, lo_p)
        zero = (gb[gn == 0] // k.CHUNK, gs[gn == 0])
        for c0, slot in zip(*zero):
            assert not hi[c0:c0 + k.TILE // k.CHUNK, slot].any()
        return
    with k.poisoned():
        if kernel == "sparse_gather":
            coff, cw, ct0, ct1, qoff, pool, n_tiles = sparse_group(5, 64)
            args = [_c(a, dev) for a in (coff, cw, ct0, ct1, pool)]
            qo = _c(qoff, dev)
            got = [k.sparse_gather(*args, n_tiles=n_tiles, qoff=qo),
                   k.sparse_gather(*args, n_tiles=n_tiles)]
            want = [k.sparse_gather_plain(*args, n_tiles=n_tiles, qoff=qo),
                    k.sparse_gather_plain(*args, n_tiles=n_tiles)]
        elif kernel == "merge_topk":
            s, o = merge_inputs(9, q=256, n_parts=4, kk=10)
            args = [_c(a, dev) for a in (s, o)]
            got = k.merge_topk(*args, k=10)
            want = k.merge_topk_plain(*args, k=10)
        elif kernel == "intersect_bitset":
            bits = bitset_inputs(3, 40, 3)
            q_slots, q_neg = clause_slots(13, 40, 40)
            args = [_c(a, dev) for a in (q_slots, q_neg, bits)]
            got = [k.intersect_bitset(*args, nsw=3),
                   *k.intersect_bitset_counts(*args, nsw=3)]
            want = [k.intersect_bitset_plain(*args, nsw=3),
                    *k.intersect_bitset_counts_plain(*args, nsw=3)]
        elif kernel == "pack_presence_bits":
            got, want = [], []
            for case in ("random", "nsw3"):
                hi, lo = (_c(a, dev) for a in pack_inputs(case))
                got.append(k.pack_presence_bits(hi, lo))
                want.append(k.pack_presence_bits_plain(hi, lo))
        else:
            got, want = [], []
            for kw in (dict(qc=37, nw=3, dims=128, masked=True, n_parts=4),
                       dict(qc=129, nw=2, dims=256)):
                qi8, qmeta, q8, meta, act, fmask = knn_inputs(11, **kw)
                args = [_c(a, dev) for a in (qi8, qmeta, q8, meta, act)]
                fm = None if fmask is None else _c(fmask, dev)
                got += k.knn_int8_window_topc(*args, fm, similarity="cosine")
                want += k.knn_int8_window_topc_plain(*args, fm,
                                                     similarity="cosine")
    torch.cuda.synchronize()
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# --------------------------------------------------------------------------
# block scatter (ops/scoring.py's BM25 / presence scatter)
# --------------------------------------------------------------------------


def _lane_case(name, mode, dev):
    from torch_kernel_cases import lane_topk_inputs

    bd, bs, live, qb, qw, ts, kk, extra = lane_topk_inputs(name, mode)
    args = [_c(a, dev) for a in (bd, bs, live, qb, qw, ts)]
    kw = {key: _c(v, dev) for key, v in extra.items()}
    return args, kk, kw


def _same_lane_rows(got, want):
    return (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]))


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("mode", ["lane", "hybrid", "bool"])
@pytest.mark.parametrize("name", ["g32", "g512", "g8192", "g32768", "ties",
                                  "big_k", "edges", "tiles", "k1", "skew",
                                  "mixed", "k15360", "runs100",
                                  "runs2800"])
def test_lane_topk_kernel(dev, name, mode, poison):
    """K10 at the four (bucket, Qc) shapes of blockmax._GROUP_SHAPES (up to
    4.19M lanes a row), its edges and the tiled kernel's cases (a row over
    many tiles with ties across them, a narrow dense run whose blocks
    outgrow a tile's staging room beside a sparse one, rows of one tile
    beside rows of many, k of 1, 10, 300 and 15,360, rows of 100 runs
    (the sorted tiles) and of 2,800 runs at k 15,360 (the runs in chunks,
    each lane searching the other chunks' runs in global memory)), in each
    mode,
    bitwise against the plain version, run twice (the first on outputs
    and tile scratch filled with NaN / -1 when `poison`)."""
    args, kk, kw = _lane_case(name, mode, dev)
    k.reset_launches()
    with k.poisoned() if poison else _nullcontext():
        first = k.lane_topk(*args, k=kk, **kw)
    again = k.lane_topk(*args, k=kk, **kw)
    want = k.lane_topk_plain(*args, k=kk, **kw)
    torch.cuda.synchronize()
    assert k.LAUNCHES["lane_topk"] == 2
    assert _same_lane_rows(first, want)
    assert _same_lane_rows(again, want)
    assert (want[0] > 0).any()


@pytest.mark.parametrize("name", ["tiles", "edges"])
def test_lane_topk_graph_replay(dev, name):
    """One K10 call captured in a CUDA graph (its tile launch and, for
    "tiles", its merge launch) and replayed on new inputs written into the
    captured tensors: each replay bitwise the plain version's rows."""
    args, kk, kw = _lane_case(name, "hybrid", dev)
    k.lane_topk(*args, k=kk, **kw)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = k.lane_topk(*args, k=kk, **kw)
    for scale in (1.0, 0.5):
        args[4].mul_(scale)              # qw: new scores, same launch
        g.replay()
        want = k.lane_topk_plain(*args, k=kk, **kw)
        torch.cuda.synchronize()
        assert _same_lane_rows(got, want)


def test_lane_topk_kernel_refuses_short_plan(dev):
    """The C entry takes the wrapper's tiling and refuses one whose grid
    leaves a row's tiles out (tiles x C < B), or more tiles without the
    scratch; the wrapper's own plan launches."""
    args, kk, kw = _lane_case("tiles", "lane", dev)
    bd, bs, live, qb, qw, ts = args
    S, T, _ = bd.shape
    Q, _, B = qb.shape
    R, D = ts.shape[2] - 1, live.shape[1]
    out_s = torch.empty((S, Q, kk), device=dev)
    out_d = torch.empty((S, Q, kk), dtype=torch.int32, device=dev)
    C, tiles = k.lane_topk_plan(S, Q, B, kk)
    assert tiles > 1
    scr_s = torch.empty((S, Q, tiles, kk), device=dev)
    scr_d = torch.empty((S, Q, tiles, kk), dtype=torch.int32, device=dev)
    head = [bd.data_ptr(), bs.data_ptr(), live.data_ptr(), qb.data_ptr(),
            qw.data_ptr(), ts.data_ptr(), 0, 0, 0, 0, out_s.data_ptr(),
            out_d.data_ptr()]
    scr = [scr_s.data_ptr(), scr_d.data_ptr()]
    for plan, tile_ptrs in (((C, tiles - 1), scr), ((C // 2, tiles), scr),
                            ((C, tiles), [0, 0])):
        with pytest.raises(k.KernelLaunchError):
            k._launch("lane_topk", dev, *head, *tile_ptrs, S, Q, T, B, R, D,
                      kk, *plan, 0)
    k._launch("lane_topk", dev, *head, *scr, S, Q, T, B, R, D, kk, C, tiles,
              0)
    want = k.lane_topk_plain(*args, k=kk, **kw)
    torch.cuda.synchronize()
    assert _same_lane_rows((out_s, out_d), want)


def test_lane_topk_cap_matches_kernel(dev):
    for kk in (1, 10, 256, 257, 300, 1000, 1792, 15360, 15872):
        assert cuda_build.kernel("lane_topk_cap")(kk) == k.lane_topk_cap(kk)


def test_lane_topk_refuses(dev):
    """k past the big-k buffer is refused with ValueError; the largest k
    taken before the tiled kernel (15,360) and up to 15,872 are taken."""
    args, _, kw = _lane_case("edges", "lane", dev)
    with pytest.raises(ValueError):
        k.lane_topk(*args, k=15873)
    k.lane_topk(*args, k=15872)
    torch.cuda.synchronize()


_WEIGHTED_CASES = ["overflow", "columns", "outside", "multi", "runs100",
                   "mixed", "runs2500", "wide"]


def _weighted_case(name, dev):
    from torch_kernel_cases import weighted_scatter_inputs

    acc, ids, w, rows, bd, bs, runs = weighted_scatter_inputs(name)
    args = [_c(a, dev) for a in (ids, w, bd, bs)]
    return acc, args, {"rows": None if rows is None else _c(rows, dev),
                       "runs": runs}


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("name", _WEIGHTED_CASES)
def test_weighted_block_scatter_kernel(dev, name, poison):
    """K11 bitwise against the plain version, and run to run (no
    atomics): one run, and runs that share docs (one row, 100 rare terms,
    several rows, 2,500 runs, a few runs of a thousand blocks); also under
    kernels.poisoned."""
    acc, args, kw = _weighted_case(name, dev)
    outs = []
    k.reset_launches()
    with k.poisoned() if poison else _nullcontext():
        for run in (k.weighted_block_scatter, k.weighted_block_scatter,
                    k.weighted_block_scatter_plain):
            a = _c(acc, dev)
            run(a, *args, **kw)
            outs.append(a)
    torch.cuda.synchronize()
    assert k.LAUNCHES["weighted_block_scatter"] == 2
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    assert torch.equal(outs[0].view(torch.int32), outs[2].view(torch.int32))
    assert not torch.equal(outs[0], _c(acc, dev))


@pytest.mark.parametrize("name", ["columns", "runs100", "wide"])
def test_weighted_block_scatter_graph_replay(dev, name):
    """K11 (a launch a run, all from one call) captured into a CUDA graph
    and replayed onto fresh copies of the accumulator: each replay bitwise
    the plain version's."""
    acc, args, kw = _weighted_case(name, dev)
    want = _c(acc, dev)
    k.weighted_block_scatter_plain(want, *args, **kw)
    a = _c(acc, dev)
    k.weighted_block_scatter(a, *args, **kw)      # built and warm
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        k.weighted_block_scatter(a, *args, **kw)
    for _ in range(3):
        a.copy_(_c(acc, dev))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int32), want.view(torch.int32))


def test_weighted_block_scatter_refuses_bad_runs(dev):
    """A descending table, one past C or short of it raises ValueError on
    the card before anything launches; acc is left as it was."""
    acc, args, kw = _weighted_case("mixed", dev)
    runs = kw["runs"]
    C = int(args[0].shape[1])
    a = _c(acc, dev)
    k.reset_launches()
    for bad in ([0, 5, 3, C], [0, C + 1], [0, C - 1], [1, C],
                runs[::-1].copy()):
        with pytest.raises(ValueError):
            k.weighted_block_scatter(a, *args, rows=kw["rows"], runs=bad)
    with pytest.raises(ValueError):          # a table on the card
        k.weighted_block_scatter(a, *args, rows=kw["rows"],
                                 runs=torch.from_numpy(runs).to(dev))
    torch.cuda.synchronize()
    assert k.LAUNCHES["weighted_block_scatter"] == 0
    assert torch.equal(a, _c(acc, dev))


def test_exhaustive_topk_one_launch_per_query(dev):
    """BlockMax's overflow path launches K11 once per query that has
    non-hot terms, whatever its number of terms (2 to 100), and answers
    as the same engine on the CPU: the accumulator bitwise (the plain
    version on the same runs), the top-k under tests/test_blockmax.py's
    rule (the hot-term sums may round differently on the card)."""
    from elasticsearch_tpu_torch.parallel.blockmax import BlockMaxBM25
    from elasticsearch_tpu_torch.parallel.spmd import build_stacked_bm25
    from torch_kernel_cases import blockmax_partitions

    parts, vocab = blockmax_partitions()
    engines = {d: BlockMaxBM25(build_stacked_bm25(
        parts, "body", device=d, device_arrays=True, serve_only=True), d)
        for d in ("cuda", "cpu")}
    rng = np.random.default_rng(71)
    queries = [list(rng.choice(vocab, n, replace=False))
               for n in (2, 3, 4, 100, 100)]
    accs = {"cuda": [], "cpu": []}
    scatter = k.weighted_block_scatter

    def spy(acc, *args, **kw):
        out = scatter(acc, *args, **kw)
        accs[acc.device.type].append(out.cpu())
        return out

    k.weighted_block_scatter = spy
    try:
        for q in queries:
            terms = [(t, 1.0) for t in q]
            got = {}
            for d, eng in engines.items():
                for t in q:
                    eng._term_meta(t)
                k.reset_launches()
                got[d] = eng._exhaustive_topk(terms, {}, 10)
                torch.cuda.synchronize()
                assert k.LAUNCHES["weighted_block_scatter"] == (
                    1 if d == "cuda" else 0), (d, len(q))
            sa, sb = got["cuda"][0], got["cpu"][0]
            np.testing.assert_allclose(sa, sb, rtol=2e-5, atol=2e-5)
            ia = list(zip(got["cuda"][1], got["cuda"][2]))
            ib = list(zip(got["cpu"][1], got["cpu"][2]))
            if (np.abs(np.diff(sb)) > 2e-5 * np.abs(sb[:-1]) + 2e-5).all():
                assert ia == ib, len(q)
            else:                           # near-ties (the hot sums)
                assert set(ia) == set(ib), len(q)
    finally:
        k.weighted_block_scatter = scatter
    assert len(accs["cuda"]) == len(accs["cpu"]) == len(queries)
    for a, b in zip(accs["cuda"], accs["cpu"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture(scope="module")
def scatter_fp():
    from torch_kernel_cases import scatter_postings

    return scatter_postings()


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("case", ["head", "mid", "rare", "head_boosted"])
def test_bm25_block_scatter_kernel(dev, scatter_fp, case, poison):
    """bitwise against the plain version, also on an output filled with
    NaN first (its C entry zero-fills it)"""
    from torch_kernel_cases import scatter_case

    fp, avgdl = scatter_fp
    ids, idf = scatter_case(fp, case)
    args = [_c(a, dev) for a in (ids, idf, fp.block_docs, fp.block_tfs,
                                 fp.doc_len)]
    k.reset_launches()
    with k.poisoned() if poison else _nullcontext():
        got = k.bm25_block_scatter(*args, avgdl=avgdl, k1=1.2, b=0.75)
    want = k.bm25_block_scatter_plain(*args, avgdl=avgdl, k1=1.2, b=0.75)
    torch.cuda.synchronize()
    assert k.LAUNCHES["bm25_block_scatter"] == 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("n_terms", [1, 12, 40])
def test_block_presence_kernel(dev, scatter_fp, n_terms, poison):
    from torch_kernel_cases import presence_ids

    fp, _ = scatter_fp
    args = [_c(a, dev) for a in (presence_ids(fp, n_terms), fp.block_docs,
                                 fp.block_tfs)]
    n = len(fp.doc_len)
    k.reset_launches()
    with k.poisoned() if poison else _nullcontext():
        got = k.block_presence(*args, n_docs=n)
    want = k.block_presence_plain(*args, n_docs=n)
    torch.cuda.synchronize()
    assert k.LAUNCHES["block_presence"] == 1
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def scatter_fp_odd():
    """40,001 docs: n_docs not a multiple of 4 or 16."""
    from torch_kernel_cases import scatter_postings

    return scatter_postings(seed=3, n_docs=40_001)


@pytest.fixture(scope="module")
def scatter_fp_large():
    """200,000 docs: a head term of some 1,500 rows."""
    from torch_kernel_cases import scatter_postings

    return scatter_postings(seed=5, n_docs=200_000, n_terms=4_000)


def _scatter_both(dev, fp, ids, idf, avgdl, poison):
    """Both kernels on one row list, each bitwise against its plain
    version (on outputs filled with NaN / ones first when `poison`)."""
    args = [_c(a, dev) for a in (ids, idf, fp.block_docs, fp.block_tfs,
                                 fp.doc_len)]
    n = len(fp.doc_len)
    pargs = (args[0], args[2], args[3])
    k.reset_launches()
    with k.poisoned() if poison else _nullcontext():
        got = k.bm25_block_scatter(*args, avgdl=avgdl, k1=1.2, b=0.75)
        mask = k.block_presence(*pargs, n_docs=n)
    want = k.bm25_block_scatter_plain(*args, avgdl=avgdl, k1=1.2, b=0.75)
    want_mask = k.block_presence_plain(*pargs, n_docs=n)
    torch.cuda.synchronize()
    assert k.LAUNCHES["bm25_block_scatter"] == 1
    assert k.LAUNCHES["block_presence"] == 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(mask, want_mask)
    return want


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("size", ["odd", "large"])
@pytest.mark.parametrize("case", ["shuffled", "ragged", "row0_live"])
def test_block_scatter_edges_kernel(dev, scatter_fp_odd, scatter_fp_large,
                                    case, size, poison):
    """Rows shuffled, a row count that is not a whole number of the
    kernel's steps, and a live row 0 (scored, not skipped as padding); on
    40,001 docs and on 200,000."""
    from torch_kernel_cases import scatter_edge_case

    fp, avgdl = scatter_fp_odd if size == "odd" else scatter_fp_large
    fp, ids, idf = scatter_edge_case(fp, case)
    want = _scatter_both(dev, fp, ids, idf, avgdl, poison)
    if case == "row0_live":       # row 0's live lanes scored, nonzero
        live0 = fp.block_docs[0][fp.block_tfs[0] > 0]
        assert bool((want[_c(live0, dev).long()] > 0).all())


# rows of the ladder as fractions of the warps an H100-class card holds at
# once (SMs x 64): the kernel takes a thread a lane, 2 lanes or 4 as the
# rows fit the card, and past that walks its grid over several steps
_LADDER = [(0, 8), (1, 16), (1, 4), (1, 3), (1, 2), (1, 1), (2, 1), (8, 1)]


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("num,den", _LADDER)
def test_block_scatter_ladder_kernel(dev, num, den, poison):
    """One term's rows (scatter_ladder) from 8 to 8 x the warps the card
    holds at once: every lanes-a-thread plan the C entry picks, and a
    persistent grid that strides over many steps."""
    from types import SimpleNamespace

    from torch_kernel_cases import scatter_ladder

    resident = torch.cuda.get_device_properties(dev).multi_processor_count * 64
    n_rows = num * resident // den if num else den
    docs, tfs, doc_len, ids, idf, avgdl = scatter_ladder(n_rows)
    fp = SimpleNamespace(block_docs=docs, block_tfs=tfs, doc_len=doc_len)
    want = _scatter_both(dev, fp, ids, idf, avgdl, poison)
    assert int((want > 0).sum()) == int((tfs > 0).sum())


def test_block_scatter_skips_rows_outside(dev, scatter_fp):
    """Row ids outside [0, T) and an empty id list write nothing (the
    output stays zero-filled); a CPU argument is refused before launch."""
    fp, avgdl = scatter_fp
    t = fp.block_docs.shape[0]
    ids = _c(np.array([0, -3, t, t + 5], np.int32), dev)
    idf = _c(np.ones(4, np.float32), dev)
    docs, tfs, dl = (_c(a, dev) for a in (fp.block_docs, fp.block_tfs,
                                          fp.doc_len))
    with k.poisoned():
        out = k.bm25_block_scatter(ids, idf, docs, tfs, dl, avgdl=avgdl,
                                   k1=1.2, b=0.75)
        empty = k.block_presence(ids[:0], docs, tfs, n_docs=len(fp.doc_len))
    torch.cuda.synchronize()
    assert not out.any() and not empty.any()
    with pytest.raises(ValueError):
        k.block_presence(ids.cpu(), docs, tfs, n_docs=10)


# ---------------------------------------------------------------------------
# the serving path: the scheduler's widths and its lane threads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qc", [8, 16])
def test_sweep_rowmax_path_widths_kernel(dev, qc):
    """K2 at the widths the scheduler's ladder puts on the serving path
    (buckets 1 and 4 round to 8, 16 stays 16): bitwise against its plain
    version, also on outputs filled with NaN / -1 first."""
    qscale, hi, lo, wq, live = sweep_inputs(11 + qc, qc=qc, hpt=225, nsw=2)
    args = [_c(a, dev) for a in (qscale, hi, lo, wq, live)]
    pm, pr = k.sweep_rowmax_plain(*args, nsw=2)
    km, kr = k.sweep_rowmax(*args, nsw=2)
    with k.poisoned():
        qm, qr = k.sweep_rowmax(*args, nsw=2)
    torch.cuda.synchronize()
    assert torch.equal(km, pm) and torch.equal(kr, pr)
    assert torch.equal(qm, pm) and torch.equal(qr, pr)


WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lam", "mu", "nu", "xi", "omicron", "pi"]
QUERIES = [["alpha"], ["beta", "gamma"], ["delta"], ["pi", "omicron"],
           ["mu", "nu", "xi"], ["kappa"], ["theta", "iota"], ["zeta", "eta"]]


def _card_service(monkeypatch, dev, n=400, agg=False):
    from elasticsearch_tpu_torch.cluster.state import IndexMetadata
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.index_service import IndexService

    monkeypatch.setenv("ES_TPU_TURBO_COLD_DF", "8")
    props = {"body": {"type": "text"}, "tag": {"type": "keyword"}}
    svc = IndexService(IndexMetadata(index="card", uuid="card",
                                     settings=Settings({}),
                                     mappings={"properties": props}),
                       device=dev)
    rng = np.random.default_rng(99)
    for i in range(n):
        words = rng.choice(WORDS, size=int(rng.integers(3, 16)))
        svc.index_doc(str(i), {"body": " ".join(words),
                               "tag": f"t{rng.integers(0, 12)}"})
    svc.refresh()
    return svc


def test_blockmax_long_match_on_card(dev, monkeypatch):
    """BlockMax on the card (the snapshot's Turbo budget at 1 byte) serves
    an msearch of 100-term `match` bodies beside a short one through K10
    rows of 100 runs, sends no body to the dense executor, and answers as
    the port on the CPU: the same ids, scores within tests/test_blockmax.py's
    2e-5 (the hot-term sums may round differently on the card)."""
    from elasticsearch_tpu_torch.cluster.state import IndexMetadata
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.index_service import IndexService
    from elasticsearch_tpu_torch.search import serving

    monkeypatch.setitem(serving.select_bm25_engine.__kwdefaults__,
                        "hbm_budget_bytes", 1)
    vocab = [f"w{i}" for i in range(160)]
    rng = np.random.default_rng(37)
    docs = [" ".join(rng.choice(vocab, int(rng.integers(3, 20))))
            for _ in range(400)]
    bodies = [{"query": {"match": {"body": " ".join(vocab[:100])}}},
              {"query": {"match": {"body": " ".join(vocab[40:140])}},
               "size": 25},
              {"query": {"match": {"body": "w3 w150"}}}]
    runs = []
    lane_topk = k.lane_topk

    def spy(*args, **kw):
        runs.append(int(args[5].shape[2]) - 1)
        return lane_topk(*args, **kw)

    monkeypatch.setattr(k, "lane_topk", spy)
    got = {}
    for d in (dev, torch.device("cpu")):
        svc = IndexService(IndexMetadata(
            index="long", uuid="long", settings=Settings({}),
            mappings={"properties": {"body": {"type": "text"}}}), device=d)
        for i, body in enumerate(docs):
            svc.index_doc(str(i), {"body": body})
        svc.refresh()
        assert svc.serving.snapshot().engine("body").kind == "blockmax"
        f0 = serving.serving_fault_stats()["fastpath_reject_error"]
        k.reset_launches()
        got[d.type] = svc.serving.try_msearch(bodies, "query_then_fetch")
        assert serving.serving_fault_stats()["fastpath_reject_error"] == f0
        assert all(r is not None for r in got[d.type])
        assert (k.LAUNCHES["lane_topk"] > 0) == (d.type == "cuda")
        svc.close()
    assert max(runs) >= 100
    for body, a, b in zip(bodies, got["cuda"], got["cpu"]):
        ah, bh = a["hits"]["hits"], b["hits"]["hits"]
        sa = np.asarray([h["_score"] for h in ah], np.float64)
        sb = np.asarray([h["_score"] for h in bh], np.float64)
        np.testing.assert_allclose(sa, sb, rtol=2e-5, atol=2e-5)
        ia, ib = [h["_id"] for h in ah], [h["_id"] for h in bh]
        if (np.abs(np.diff(sb)) > 2e-5 * np.abs(sb[:-1]) + 2e-5).all():
            assert ia == ib, body
        else:                                   # near-ties: as sets
            assert set(ia) == set(ib), body


def _spy_threads(monkeypatch, name):
    """Records (thread name, current CUDA device) at every call of
    kernels.`name`."""
    import threading

    seen = []
    fn = getattr(k, name)

    def spy(*a, **kw):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_device()))
        return fn(*a, **kw)

    monkeypatch.setattr(k, name, spy)
    return seen


def _together(fn, items):
    import threading

    out = [None] * len(items)
    errors = [None] * len(items)
    barrier = threading.Barrier(len(items))

    def run(i):
        try:
            barrier.wait(timeout=30)
            out[i] = fn(items[i])
        except BaseException as e:  # noqa: BLE001 — asserted by callers
            errors[i] = e

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(items))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    return out, errors


def test_scheduler_lane_launches_k2_on_engine_device(dev, monkeypatch):
    """A scheduler lane thread launches K2 on the engine's device; the
    merged rows equal each query's direct call bitwise."""
    from elasticsearch_tpu_torch.threadpool.scheduler import (
        AdaptiveDispatchScheduler,
    )

    svc = _card_service(monkeypatch, dev)
    eng = svc.serving.snapshot().engine("body")
    assert eng.kind == "turbo" and eng.device.type == "cuda"
    direct = [eng.search_many([[q]], k=10)[0] for q in QUERIES]
    seen = _spy_threads(monkeypatch, "sweep_rowmax")
    sched = AdaptiveDispatchScheduler(buckets=(len(QUERIES),),
                                      interactive_us=400000.0,
                                      bulk_us=400000.0)
    rows, errors = _together(lambda q: sched.dispatch(eng, [q], 10),
                             QUERIES)
    assert errors == [None] * len(QUERIES)
    for got, want in zip(rows, direct):
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert sched.stats()["sched_dispatches"] == 1
    assert seen and all(name.startswith("es-tpu-sched") for name, _ in seen)
    assert all(d == eng.device.index for _, d in seen)
    svc.close()


def test_scheduler_lane_launches_k8_on_engine_device(dev, monkeypatch):
    """Concurrent aggregation collects reach K8 from the bulk tier's lane
    thread on the agg engine's device, several queries in one launch, with
    aggregations equal to the same bodies dispatched directly."""
    import elasticsearch_tpu_torch.search.aggregations as agg_mod

    monkeypatch.setattr(agg_mod, "AGG_DEVICE_MIN_DOCS", 1)
    monkeypatch.setenv("ES_TPU_SCHED_BULK_US", "300000")
    monkeypatch.setenv("ES_TPU_SCHED_BUCKETS", "1,4,16,64,256")
    svc = _card_service(monkeypatch, dev, n=3000)
    bodies = [{"size": 0, "query": {"term": {"body": w}},
               "aggs": {"t": {"terms": {"field": "tag"}}}}
              for w in WORDS[:8]]
    monkeypatch.setenv("ES_TPU_COALESCE_US", "0")
    want = [svc._search_dense(b)["aggregations"] for b in bodies]
    monkeypatch.setenv("ES_TPU_COALESCE_US", "2000")
    seen = _spy_threads(monkeypatch, "agg_segment_counts")
    qs = []
    fn = k.agg_segment_counts

    def count_q(mask, *a, **kw):
        qs.append(int(mask.shape[0]))
        return fn(mask, *a, **kw)

    monkeypatch.setattr(k, "agg_segment_counts", count_q)
    got, errors = _together(lambda b: svc._search_dense(b)["aggregations"],
                            bodies)
    assert errors == [None] * len(bodies)
    assert got == want
    assert seen and all(name.startswith("es-tpu-sched") for name, _ in seen)
    assert all(d == dev.index or d == torch.cuda.current_device()
               for _, d in seen)
    assert max(qs) > 1
    svc.close()


def test_lane_launch_failure_raises_to_waiters(dev, monkeypatch):
    """A lane whose K2 launch fails raises KernelLaunchError to every
    waiter (after the solo retries); no plain version serves the rows."""
    from elasticsearch_tpu_torch.common.errors import KernelLaunchError
    from elasticsearch_tpu_torch.threadpool.scheduler import (
        AdaptiveDispatchScheduler,
    )

    svc = _card_service(monkeypatch, dev)
    eng = svc.serving.snapshot().engine("body")
    eng.search_many([QUERIES[:1]], k=10)      # columns built, kernels loaded
    real = cuda_build.kernel

    def failing(name):
        return (lambda *a: 1) if name == "sweep_rowmax" else real(name)

    def no_plain(*a, **kw):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(cuda_build, "kernel", failing)
    monkeypatch.setattr(k, "sweep_rowmax_plain", no_plain)
    sched = AdaptiveDispatchScheduler(buckets=(4,), interactive_us=400000.0,
                                      bulk_us=400000.0)
    rows, errors = _together(lambda q: sched.dispatch(eng, [q], 10),
                             QUERIES[:4])
    assert rows == [None] * 4
    assert all(isinstance(e, KernelLaunchError) for e in errors), errors
    svc.close()
