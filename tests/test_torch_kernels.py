"""Port kernels vs the reference Pallas kernels, bitwise, on the CPU.

The same numpy inputs, made from a seed, go through the reference
(elasticsearch_tpu/parallel/kernels.py, Pallas in interpret mode on the CPU
as tests/test_turbo.py runs it) and through the port's wrappers, which run
their plain torch versions for CPU tensors. K1, K2, the row pick, K3, the
bitset helpers and K5-K7 must agree bit for bit (tolerance 0): the
kernels' arithmetic is integer or bitwise, one rounding per step, or sums
in a fixed order. The reference's uint32 bitsets are compared with the
port's int32 ones through a numpy view. K3's batched form (qoff) is held
to the reference run query by query, and a numpy emulation of the CUDA
kernel's per-lane search order to the plain version. K8's counts are integers, bitwise on every case. K9's float epilogue is
bitwise too:
the port follows the order in which XLA on the CPU compiles the reference
kernel, fused multiply-adds included (ROADMAP W11). K9's rows are stored
doc-major in the port, so the reference gets them transposed. The CUDA
kernels themselves are held against the same plain versions on the card by
chip_smoke.py and tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from types import SimpleNamespace

from elasticsearch_tpu.parallel import kernels as ref_k
from elasticsearch_tpu.parallel import turbo as ref_turbo
from elasticsearch_tpu.parallel.knn import KnnEngine as RefKnnEngine
from elasticsearch_tpu_torch.common.errors import KernelLaunchError
from elasticsearch_tpu_torch.parallel import kernels as k
from torch_kernel_cases import (
    AGG_CASES, AGG_WORD_CASES, CONJ_EDGE_CASES, COUNT_MASK_CASES,
    MERGE_EDGE_CASES, PACK_CASES, SPARSE_BATCH_CASES,
    count_mask_inputs, emulate_intersect_counts, emulate_mask_counts,
    emulate_pack_bits, overflow_slots, pack_inputs, agg_inputs, agg_masks,
    agg_plan, agg_section,
    agg_word_inputs, emulate_agg_bits, emulate_agg_counts, emulate_agg_pack,
    emulate_merge_rank, merge_edge_inputs, bitset_edge_inputs, bitset_inputs,
    clause_slots, conj_edge_inputs, conj_inputs,
    emulate_sparse_gather, knn_inputs, lanes_and_groups, mask_inputs,
    merge_inputs, sparse_batch_inputs, sparse_group, sparse_inputs,
    sweep_inputs, SWEEP_EDGE_CASES, emulate_sweep_group, plan_sweep_batches,
    sweep_edge_inputs, sweep_list,
)

torch.set_num_threads(1)

TILE = k.TILE


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed,n_groups,rows,dense", [
    (0, 4, 3, False),
    (1, 8, 128, True),
])
def test_build_columns_bitwise(seed, n_groups, rows, dense):
    docs, scores, gr, gn, gb, gs = lanes_and_groups(seed, n_groups, rows,
                                                     dense)
    hpt = n_groups // 4 + 3
    shape = (4 * TILE // k.CHUNK, hpt, 16, 128)
    # stale content in the cache must be overwritten by the groups' tiles
    rng = np.random.default_rng(seed + 100)
    stale = rng.integers(-5, 6, size=shape).astype(np.int8)
    want_hi, want_lo = ref_k.build_columns(
        jnp.asarray(gr), jnp.asarray(gn), jnp.asarray(gb), jnp.asarray(gs),
        jnp.asarray(docs), jnp.asarray(scores), jnp.asarray(stale),
        jnp.asarray(stale), n_groups=len(gr))
    hi, lo = _t(stale.copy()), _t(stale.copy())
    k.reset_launches()
    k.build_columns(_t(gr), _t(gn), _t(gb), _t(gs), _t(docs), _t(scores),
                    hi, lo)
    assert np.array_equal(hi.numpy(), np.asarray(want_hi))
    assert np.array_equal(lo.numpy(), np.asarray(want_lo))
    assert k.LAUNCHES["build_columns"] == 0     # CPU runs the plain version


@pytest.fixture(scope="module")
def sweep_case():
    qscale, hi, lo, wq, live = sweep_inputs(3, qc=8, hpt=33, nsw=2)
    want = ref_k.sweep_rowmax(jnp.asarray(qscale), jnp.asarray(hi),
                              jnp.asarray(lo), jnp.asarray(wq),
                              jnp.asarray(live), QC=8, nsw=2)
    got = k.sweep_rowmax(_t(qscale), _t(hi), _t(lo), _t(wq), _t(live), nsw=2)
    return want, got


def test_sweep_rowmax_bitwise(sweep_case):
    (wm, wr), (gm, gr) = sweep_case
    assert np.array_equal(gm.numpy(), np.asarray(wm))
    assert np.array_equal(gr.numpy(), np.asarray(wr))
    # the case has ties, empty queries and padding to check
    assert np.isinf(gm.numpy()).any() and np.isfinite(gm.numpy()).any()


@pytest.mark.parametrize("n_rows", [5, 33, 40])
def test_pick_rows_bitwise(sweep_case, n_rows):
    from elasticsearch_tpu_torch.parallel.turbo import _pick_rows

    (wm, wr), _ = sweep_case
    want = ref_turbo._pick_rows(wm, wr, n_rows=n_rows)
    got = _pick_rows(_t(np.asarray(wm)), _t(np.asarray(wr)), n_rows=n_rows)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", SWEEP_EDGE_CASES)
def test_sweep_rowmax_kernel_order_emulated(case):
    """The CUDA K2's grouping (SWEEP_GROUP queries a block, lists in
    batches that fit), its two paths (exact f32 sums
    with dead docs masked and the row max taken before the scale, or int32
    sums) and its warp selection order, emulated in numpy, equal the plain
    version and the reference bitwise on the edge cases the card tests use
    (all_slots at Hpt 300 here: more list entries than a block holds at
    once, on the integer path)."""
    qscale, hi, lo, wq, live, nsw = sweep_edge_inputs(case, all_slots_hpt=300)
    got_m, got_r = emulate_sweep_group(qscale, hi, lo, wq, live, nsw)
    pm, pr = k.sweep_rowmax_plain(_t(qscale), _t(hi), _t(lo), _t(wq),
                                  _t(live), nsw=nsw)
    assert np.array_equal(got_m, pm.numpy())
    assert np.array_equal(got_r, pr.numpy())
    wm, wr = ref_k.sweep_rowmax(jnp.asarray(qscale), jnp.asarray(hi),
                                jnp.asarray(lo), jnp.asarray(wq),
                                jnp.asarray(live), QC=wq.shape[1], nsw=nsw)
    assert np.array_equal(got_m, np.asarray(wm))
    assert np.array_equal(got_r, np.asarray(wr))
    assert np.isfinite(got_m).any()


@pytest.mark.parametrize("cap", [3, 8, 256])
def test_sweep_group_plan(cap):
    """K2's batches of a group: every query once, in order, each batch's
    lists within cap; and the emulation with each plan equals the plain
    version."""
    qscale, hi, lo, wq, live, nsw = sweep_edge_inputs("qc257")
    g = k.SWEEP_GROUP
    cnt = [int(((wq[0, q] != 0) | (wq[1, q] != 0)).sum()) for q in range(g)]
    batches = plan_sweep_batches(cnt, cap)
    assert [j for b in batches for j in b] == list(range(g))
    assert all(sum(cnt[j] for j in b) <= cap for b in batches)
    assert (len(batches) > 1) == (cap < sum(cnt))
    got_m, got_r = emulate_sweep_group(qscale, hi, lo, wq, live, nsw,
                                       cap=cap)
    pm, pr = k.sweep_rowmax_plain(_t(qscale), _t(hi), _t(lo), _t(wq),
                                  _t(live), nsw=nsw)
    assert np.array_equal(got_m, pm.numpy())
    assert np.array_equal(got_r, pr.numpy())


@pytest.mark.parametrize("case", CONJ_EDGE_CASES)
def test_sweep_rowmax_conj_kernel_order_emulated(case):
    """K7 on K2's group block (a query's list: score entries, then
    coverage ones; the coverage gate ANDed into live before the scores;
    queries with no score weight out of the rows and batches), emulated in
    numpy, equals the plain version and the reference bitwise on the edge
    cases the card tests use (all_slots at Hpt 300 here)."""
    qscale, nreq, hi, lo, wq, wp, live, nsw = conj_edge_inputs(
        case, all_slots_hpt=300)
    got_m, got_r = emulate_sweep_group(qscale, hi, lo, wq, live, nsw,
                                       wp=wp, nreq=nreq)
    pm, pr = k.sweep_rowmax_conj_plain(_t(qscale), _t(nreq), _t(hi), _t(lo),
                                       _t(wq), _t(wp), _t(live), nsw=nsw)
    assert np.array_equal(got_m, pm.numpy())
    assert np.array_equal(got_r, pr.numpy())
    wm, wr = ref_k.sweep_rowmax_conj(
        jnp.asarray(qscale), jnp.asarray(nreq), jnp.asarray(hi),
        jnp.asarray(lo), jnp.asarray(wq), jnp.asarray(wp),
        jnp.asarray(live), QC=wq.shape[1], nsw=nsw)
    assert np.array_equal(got_m, np.asarray(wm))
    assert np.array_equal(got_r, np.asarray(wr))
    assert np.isfinite(got_m).any()


@pytest.mark.parametrize("cap", [8, 40, 256])
def test_sweep_conj_group_plan(cap):
    """K7's lists and batches on the filters case's first group (lists of
    up to 8 entries): score slots first, the coverage slots the tail, an
    empty list for a query with no score weight (filters alone), every
    query once per plan with each batch within cap; and the emulation with
    each cap equals the plain version."""
    qscale, nreq, hi, lo, wq, wp, live, nsw = conj_edge_inputs("filters")
    wh, wl = wq[0].astype(np.int64), wq[1].astype(np.int64)
    g = k.SWEEP_GROUP
    lists = [sweep_list(q, wh, wl, wp) for q in range(g)]
    for q, (slots, n_score, c0) in enumerate(lists):
        scored = (wh[q] != 0) | (wl[q] != 0)
        if not scored.any():
            assert len(slots) == 0
            continue
        assert sorted(slots[:n_score]) == list(np.nonzero(scored)[0])
        assert sorted(slots[c0:]) == list(np.nonzero(wp[q])[0])
        assert c0 <= n_score and len(set(slots)) == len(slots)
    assert any(len(x[0]) == 0 for x in lists)
    cnt = [len(x[0]) for x in lists]
    assert max(cnt) <= 8
    batches = plan_sweep_batches(cnt, cap)
    assert [j for b in batches for j in b] == list(range(g))
    assert all(sum(cnt[j] for j in b) <= cap for b in batches)
    assert (len(batches) > 1) == (cap < sum(cnt))
    got_m, got_r = emulate_sweep_group(qscale, hi, lo, wq, live, nsw,
                                       cap=cap, wp=wp, nreq=nreq)
    pm, pr = k.sweep_rowmax_conj_plain(_t(qscale), _t(nreq), _t(hi), _t(lo),
                                       _t(wq), _t(wp), _t(live), nsw=nsw)
    assert np.array_equal(got_m, pm.numpy())
    assert np.array_equal(got_r, pr.numpy())


@pytest.mark.parametrize("case", SWEEP_EDGE_CASES)
def test_sweep_rowmax_bitset_kernel_order_emulated(case):
    """K6 on K2's group block (each query's mask bit ANDed into live
    before its scores; a row with no surviving doc reads nothing and is
    -inf), emulated in numpy, equals the plain version and the reference
    bitwise on K2's edge cases with masks that empty a query's first
    superwindow, a whole query and 16-bit halves (all_slots at Hpt 300
    here)."""
    qscale, hi, lo, wq, mask, live, nsw = bitset_edge_inputs(
        case, all_slots_hpt=300)
    got_m, got_r = emulate_sweep_group(qscale, hi, lo, wq, live, nsw,
                                       mask=mask)
    pm, pr = k.sweep_rowmax_bitset_plain(_t(qscale), _t(hi), _t(lo), _t(wq),
                                         _t(mask), _t(live), nsw=nsw)
    assert np.array_equal(got_m, pm.numpy())
    assert np.array_equal(got_r, pr.numpy())
    wm, wr = ref_k.sweep_rowmax_bitset(
        jnp.asarray(qscale), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(wq), jnp.asarray(_u32(mask)), jnp.asarray(live),
        QC=wq.shape[1], nsw=nsw)
    assert np.array_equal(got_m, np.asarray(wm))
    assert np.array_equal(got_r, np.asarray(wr))
    assert np.isfinite(got_m).any()
    assert np.isinf(got_m[0, 0]).all() and np.isinf(got_m[:, -1]).all()


def test_sparse_gather_bitwise():
    coff, cw, ct0, ct1, pool = sparse_inputs(5, n_terms=5, n_tiles=4)
    want = ref_k.sparse_gather(jnp.asarray(coff), jnp.asarray(cw),
                               jnp.asarray(ct0), jnp.asarray(ct1),
                               jnp.asarray(pool), n_tiles=4)
    got = k.sparse_gather(_t(coff), _t(cw), _t(ct0), _t(ct1), _t(pool),
                          n_tiles=4)
    assert got.shape == (16, 8, 128)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bad", [-1, "n_gran"])
def test_sparse_gather_rejects_granule_outside_pool(bad):
    """An out-of-range granule offset raises ValueError in the wrapper, on
    every route, instead of reading zeros (kernel) or an IndexError (plain
    version)."""
    coff, cw, ct0, ct1, pool = sparse_inputs(5, n_terms=5, n_tiles=4)
    coff = coff.copy()
    coff[1] = pool.shape[0] if bad == "n_gran" else bad
    with pytest.raises(ValueError, match="outside the pool"):
        k.sparse_gather(_t(coff), _t(cw), _t(ct0), _t(ct1), _t(pool),
                        n_tiles=4)


def _ref_sparse_per_query(coff, cw, ct0, ct1, qoff, pool, n_tiles):
    """The reference's sparse_gather run query by query, each dispatch
    padded to a power-of-two chunk count as the serving path padded it,
    padding rows dropped and the outputs concatenated."""
    outs = []
    for a, b in zip(qoff[:-1], qoff[1:]):
        n = int(b - a)
        if not n:
            continue
        pad = max(2, 1 << (n - 1).bit_length()) - n
        args = [np.concatenate([x[a:b], np.full(pad, f, x.dtype)])
                for x, f in ((coff, 0), (cw, 0.0), (ct0, 1), (ct1, 0))]
        out = ref_k.sparse_gather(*(jnp.asarray(x) for x in args),
                                  jnp.asarray(pool), n_tiles=n_tiles)
        outs.append(np.asarray(out)[:n])
    return (np.concatenate(outs) if outs
            else np.zeros((0, 8, 128), np.float32))


@pytest.mark.parametrize("case", SPARSE_BATCH_CASES)
def test_sparse_gather_batched_bitwise(case):
    """One batched dispatch (qoff) equals the reference's per-query
    dispatches, concatenated, bit for bit."""
    coff, cw, ct0, ct1, qoff, pool, n_tiles = sparse_batch_inputs(case)
    want = _ref_sparse_per_query(coff, cw, ct0, ct1, qoff, pool, n_tiles)
    got = k.sparse_gather(_t(coff), _t(cw), _t(ct0), _t(ct1), _t(pool),
                          n_tiles=n_tiles, qoff=_t(qoff))
    assert got.shape == (len(coff), 8, 128)
    assert np.array_equal(got.numpy(), want)
    if len(coff):
        assert (want != 0).any()
    # the plain version called with every query's chunks as one query would
    # add across queries: qoff must matter wherever queries share docs
    if case in ("shared_docs", "empty_query_middle"):
        merged = k.sparse_gather(_t(coff), _t(cw), _t(ct0), _t(ct1),
                                 _t(pool), n_tiles=n_tiles)
        assert not np.array_equal(merged.numpy(), want)


@pytest.mark.parametrize("case", SPARSE_BATCH_CASES + ("single", "group"))
def test_sparse_gather_kernel_order_emulated(case):
    """The CUDA kernel's per-lane order (block doc range, staged candidates,
    binary search, multiply then add), emulated in numpy, equals the plain
    version bitwise: on every batched case, on the single-query layout of
    test_sparse_gather_bitwise and on a 64-query group."""
    if case == "single":
        coff, cw, ct0, ct1, pool = sparse_inputs(5, n_terms=5, n_tiles=4)
        qoff, n_tiles = None, 4
    elif case == "group":
        coff, cw, ct0, ct1, qoff, pool, n_tiles = sparse_group(3, 64)
    else:
        coff, cw, ct0, ct1, qoff, pool, n_tiles = sparse_batch_inputs(case)
    got = emulate_sparse_gather(coff, cw, ct0, ct1, qoff, pool, n_tiles)
    want = k.sparse_gather_plain(
        _t(coff), _t(cw), _t(ct0), _t(ct1), _t(pool), n_tiles=n_tiles,
        qoff=None if qoff is None else _t(qoff))
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("qoff", [[1, 9, 15], [0, 9, 14], [0, 10, 9, 15],
                                  []])
def test_sparse_gather_rejects_bad_qoff(qoff):
    coff, cw, ct0, ct1, _, pool, n_tiles = sparse_batch_inputs("shared_docs")
    with pytest.raises(ValueError, match="qoff"):
        k.sparse_gather(_t(coff), _t(cw), _t(ct0), _t(ct1), _t(pool),
                        n_tiles=n_tiles,
                        qoff=torch.tensor(qoff, dtype=torch.int32))


def _u32(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("nsw", [2, 3])
def test_pack_presence_bits_bitwise(nsw):
    _, hi, lo, _, _ = sweep_inputs(nsw, qc=2, hpt=11, nsw=nsw)
    want = ref_k.pack_presence_bits(jnp.asarray(hi), jnp.asarray(lo))
    got = k.pack_presence_bits(_t(hi), _t(lo))
    assert got.dtype == torch.int32
    assert np.array_equal(_u32(got.numpy()), np.asarray(want))


def test_mask_chunk_counts_bitwise():
    mask = mask_inputs(4, qc=8, nsw=2)
    want = ref_k.mask_chunk_counts(jnp.asarray(_u32(mask)))
    got = k.mask_chunk_counts(_t(mask))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.min() == 0 and got.max() > 0


@pytest.mark.parametrize("nsw", [2, 3])
def test_intersect_bitset_bitwise(nsw):
    """Fan-in padding, None rows (zero sentinel), rows with no required
    clause (ones sentinel), 8 clauses, a must_not repeating a clause, over
    random blocks in several superwindows."""
    n_slots = 13
    bits = bitset_inputs(nsw, n_slots, nsw)
    q_slots, q_neg = clause_slots(nsw + 10, 8, n_slots)
    want = ref_k.intersect_bitset(jnp.asarray(q_slots), jnp.asarray(q_neg),
                                  jnp.asarray(_u32(bits)), QC=8, nsw=nsw)
    got = k.intersect_bitset(_t(q_slots), _t(q_neg), _t(bits), nsw=nsw)
    assert got.shape == (8, nsw * k.SW_WORD_ROWS, 128)
    assert np.array_equal(_u32(got.numpy()), np.asarray(want))
    g = got.numpy()
    assert not g[0].any() and g[1:].any()


def test_intersect_bitset_rejects_slot_outside_bits():
    bits = bitset_inputs(0, 13, 1)
    q_slots, q_neg = clause_slots(1, 8, 13)
    q_neg[3, 0] = 15
    with pytest.raises(ValueError, match="outside the bitsets"):
        k.intersect_bitset(_t(q_slots), _t(q_neg), _t(bits), nsw=1)


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_presence_bits_cases_bitwise(case):
    """The pack on lo-only columns, bytes of -128, an all-zero slot beside
    a full one, odd nsw and the smallest cache, against the reference."""
    hi, lo = pack_inputs(case)
    want = ref_k.pack_presence_bits(jnp.asarray(hi), jnp.asarray(lo))
    got = k.pack_presence_bits(_t(hi), _t(lo))
    assert got.shape == (hi.shape[1] + 1, hi.shape[0] // 2, 128)
    assert np.array_equal(_u32(got.numpy()), np.asarray(want))


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_bits_kernel_emulated(case):
    """A numpy model of csrc/pack_bits.cu (__vcmpne4 per row, eight rows
    summed a byte, the 4x4 byte transpose) writes the plain version's
    bits."""
    hi, lo = pack_inputs(case)
    want = k.pack_presence_bits_plain(_t(hi), _t(lo)).numpy()
    assert np.array_equal(emulate_pack_bits(hi, lo), want)


@pytest.mark.parametrize("nsw", [1, 2, 3])
def test_intersect_bitset_counts_bitwise(nsw):
    """Mask and counts on the CPU route against the reference's
    intersect_bitset (interpret mode) and mask_chunk_counts: inactive rows
    (zero sentinel), rows with no required clause (ones sentinel), 8
    distinct clauses, repeated slots, a must_not repeating a clause and
    the ones sentinel as a must_not."""
    n_slots = 13
    bits = bitset_inputs(20 + nsw, n_slots, nsw)
    q_slots, q_neg = clause_slots(30 + nsw, 11, n_slots)
    want = ref_k.intersect_bitset(jnp.asarray(q_slots), jnp.asarray(q_neg),
                                  jnp.asarray(_u32(bits)), QC=11, nsw=nsw)
    want_c = ref_k.mask_chunk_counts(want)
    mask, counts = k.intersect_bitset_counts(_t(q_slots), _t(q_neg),
                                             _t(bits), nsw=nsw)
    assert mask.dtype == torch.int32 and counts.dtype == torch.int32
    assert np.array_equal(_u32(mask.numpy()), np.asarray(want))
    assert np.array_equal(counts.numpy(), np.asarray(want_c))
    c = counts.numpy()
    assert c[0] == 0 and c.max() > 0
    assert np.array_equal(mask.numpy(), k.intersect_bitset(
        _t(q_slots), _t(q_neg), _t(bits), nsw=nsw).numpy())


@pytest.mark.parametrize("nsw", [1, 3])
def test_intersect_bitset_counts_fan_in_overflow(nsw):
    """Queries with 11 required and 6 prohibited clauses, cut to K5's 8 and
    4 as the engine cuts them: the same mask and counts as the reference,
    and a superset of the full clause set's matches."""
    n_slots = 40
    bits = bitset_inputs(40 + nsw, n_slots, nsw)
    q_slots, q_neg, reqs, negs = overflow_slots(50 + nsw, 9, n_slots)
    want = ref_k.intersect_bitset(jnp.asarray(q_slots), jnp.asarray(q_neg),
                                  jnp.asarray(_u32(bits)), QC=9, nsw=nsw)
    mask, counts = k.intersect_bitset_counts(_t(q_slots), _t(q_neg),
                                             _t(bits), nsw=nsw)
    assert np.array_equal(_u32(mask.numpy()), np.asarray(want))
    assert np.array_equal(counts.numpy(),
                          np.asarray(ref_k.mask_chunk_counts(want)))
    b = _u32(bits)[:, : nsw * k.SW_WORD_ROWS]
    got = _u32(mask.numpy())
    for q in range(9):
        full = np.bitwise_and.reduce(b[reqs[q]], axis=0)
        full &= ~np.bitwise_or.reduce(b[negs[q]], axis=0)
        assert not (full & ~got[q]).any()


@pytest.mark.parametrize("qc,nsw,n_slots", [(8, 1, 13), (13, 2, 13),
                                            (20, 3, 40), (1, 1, 9)])
def test_intersect_counts_kernel_emulated(qc, nsw, n_slots):
    """A numpy model of csrc/intersect_bitset.cu (a block per query and
    superwindow, slot lists with repeats and sentinels skipped, the
    per-warp flags summed by __syncthreads_count) gives the plain
    version's mask and counts."""
    bits = bitset_inputs(60 + qc, n_slots, nsw)
    q_slots, q_neg = clause_slots(70 + qc, max(qc, 6), n_slots)
    q_slots, q_neg = q_slots[:qc], q_neg[:qc]
    mask, counts = emulate_intersect_counts(q_slots, q_neg, bits, nsw)
    pm, pc = k.intersect_bitset_counts_plain(_t(q_slots), _t(q_neg),
                                             _t(bits), nsw=nsw)
    assert np.array_equal(mask, pm.numpy())
    assert np.array_equal(counts, pc.numpy())


@pytest.mark.parametrize("case", COUNT_MASK_CASES)
def test_chunk_count_scheme_emulated(case):
    """K5's per-warp flag and popcount scheme (emulate_mask_counts) equals
    mask_chunk_counts, the port's and the reference's, on random masks,
    masks with only high-half or only low-half bits, words with only the
    sign bit set, and an empty mask."""
    mask = count_mask_inputs(case)
    got = emulate_mask_counts(mask)
    assert np.array_equal(got, k.mask_chunk_counts(_t(mask)).numpy())
    assert np.array_equal(got, np.asarray(
        ref_k.mask_chunk_counts(jnp.asarray(_u32(mask)))))
    if case in ("high_only", "sign_bit"):
        assert got.max() > 0


def test_intersect_bitset_counts_rejects_bad_slots():
    """A slot outside [0, Hp+2) or slots on another device than the CPU
    route's bits raise before any work."""
    bits = bitset_inputs(0, 13, 1)
    q_slots, q_neg = clause_slots(1, 8, 13)
    q_slots[2, 5] = -1
    with pytest.raises(ValueError, match="outside the bitsets"):
        k.intersect_bitset_counts(_t(q_slots), _t(q_neg), _t(bits), nsw=1)
    q_slots[2, 5] = 0
    with pytest.raises(TypeError):
        k.intersect_bitset_counts(_t(q_slots).long(), _t(q_neg), _t(bits),
                                  nsw=1)
    with pytest.raises(ValueError, match="does not cover"):
        k.intersect_bitset_counts(_t(q_slots), _t(q_neg), _t(bits), nsw=2)


def test_sweep_rowmax_bitset_bitwise():
    qscale, hi, lo, wq, live = sweep_inputs(6, qc=8, hpt=33, nsw=2)
    mask = mask_inputs(6, qc=8, nsw=2)
    want = ref_k.sweep_rowmax_bitset(
        jnp.asarray(qscale), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(wq), jnp.asarray(_u32(mask)), jnp.asarray(live),
        QC=8, nsw=2)
    got = k.sweep_rowmax_bitset(_t(qscale), _t(hi), _t(lo), _t(wq),
                                _t(mask), _t(live), nsw=2)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    gm = got[0].numpy()
    # the masked-out superwindow and the all-zero mask come out empty
    assert np.isinf(gm[0, 0]).all() and np.isinf(gm[:, -1]).all()
    assert np.isfinite(gm).any()


def test_sweep_rowmax_conj_bitwise():
    qscale, nreq, hi, lo, wq, wp, live = conj_inputs(7, qc=8, hpt=33, nsw=2)
    want = ref_k.sweep_rowmax_conj(
        jnp.asarray(qscale), jnp.asarray(nreq), jnp.asarray(hi),
        jnp.asarray(lo), jnp.asarray(wq), jnp.asarray(wp),
        jnp.asarray(live), QC=8, nsw=2)
    got = k.sweep_rowmax_conj(_t(qscale), _t(nreq), _t(hi), _t(lo), _t(wq),
                              _t(wp), _t(live), nsw=2)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # coverage changes what the disjunctive sweep would keep
    disj = k.sweep_rowmax(_t(qscale), _t(hi), _t(lo), _t(wq), _t(live),
                          nsw=2)[0].numpy()
    gm = got[0].numpy()
    assert not np.array_equal(gm, disj) and np.isfinite(gm).any()


def test_wrappers_reject_bad_inputs():
    qscale, hi, lo, wq, live = sweep_inputs(0, qc=8, hpt=9, nsw=1)
    with pytest.raises(TypeError):
        k.sweep_rowmax(_t(qscale).double(), _t(hi), _t(lo), _t(wq),
                       _t(live), nsw=1)
    with pytest.raises(ValueError):
        k.sweep_rowmax(_t(qscale), _t(hi), _t(lo), _t(wq), _t(live), nsw=2)
    with pytest.raises(ValueError):
        k.sweep_rowmax(_t(qscale), _t(hi), _t(lo),
                       _t(wq).transpose(1, 2), _t(live), nsw=1)
    with pytest.raises(TypeError):
        k.sparse_gather(_t(np.zeros(2, np.int64)), _t(np.zeros(2, np.float32)),
                        _t(np.zeros(2, np.int32)), _t(np.zeros(2, np.int32)),
                        _t(np.zeros((1, 8, 128), np.int32)), n_tiles=1)
    # neither a wrapper check nor a launch failure is a RuntimeError, which
    # fault containment would serve around on the host tier
    assert not issubclass(KernelLaunchError, RuntimeError)
    assert not issubclass(TypeError, RuntimeError)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("similarity", ["cosine", "dot_product", "l2_norm"])
def test_knn_int8_window_topc_bitwise(similarity, masked):
    """K9 over 3 windows with dead rows, an all-dead window, windows left
    inactive by the probe, exact ties, and (masked) a per-query filter."""
    qi8, qmeta, q8, meta, act, fmask = knn_inputs(11, qc=8, nw=3, dims=48,
                                                  masked=masked)
    want_s, want_r = ref_k.knn_int8_window_topc(
        jnp.asarray(qi8), jnp.asarray(qmeta),
        jnp.asarray(np.ascontiguousarray(q8.transpose(0, 2, 1))),
        jnp.asarray(meta), jnp.asarray(act),
        None if fmask is None else jnp.asarray(fmask), similarity=similarity)
    k.reset_launches()
    got_s, got_r = k.knn_int8_window_topc(
        _t(qi8), _t(qmeta), _t(q8), _t(meta), _t(act),
        None if fmask is None else _t(fmask), similarity=similarity)
    assert k.LAUNCHES["knn_int8_window_topc"] == 0
    assert got_s.shape == (3, 8, k.KNN_CANDW)
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    gs = got_s.numpy()
    # the all-dead window is empty, others hold candidates, ties tie
    assert np.isinf(gs[2]).all() and np.isfinite(gs[:2]).any()
    assert any(len(set(r)) < len(r) for r in gs[:2].reshape(-1, 32))


@pytest.mark.parametrize("case", ["dups", "idle"])
@pytest.mark.parametrize("similarity", ["cosine", "dot_product", "l2_norm"])
def test_knn_int8_window_topc_ties_and_idle_bitwise(similarity, case):
    """The plain K9 against the reference where every row is a copy of one
    of 3 (ties far past the 32 kept, broken by row asc) and where a window
    is idle for every query and a query for every window (slots stay
    (-inf, 0)); dimsP 64. Rows are held bitwise; scores within 2 ulp
    (the kNN tests' bound, ROADMAP W1), because at dimsP 64 (and on some tied data) XLA on the CPU contracts
    K9's epilogue into other fused multiply-adds than at the shapes of
    test_knn_int8_window_topc_bitwise (ROADMAP W11)."""
    qi8, qmeta, q8, meta, act, _ = knn_inputs(13, qc=6, nw=2, dims=40,
                                              pad=64, dups=case == "dups")
    if case == "idle":
        act[:, 1] = 0.0
        act[3, :] = 0.0
    want_s, want_r = ref_k.knn_int8_window_topc(
        jnp.asarray(qi8), jnp.asarray(qmeta),
        jnp.asarray(np.ascontiguousarray(q8.transpose(0, 2, 1))),
        jnp.asarray(meta), jnp.asarray(act), None, similarity=similarity)
    got_s, got_r = k.knn_int8_window_topc(
        _t(qi8), _t(qmeta), _t(q8), _t(meta), _t(act), None,
        similarity=similarity)
    gs, gr = got_s.numpy(), got_r.numpy()
    ws = np.asarray(want_s)
    assert np.array_equal(gr, np.asarray(want_r))
    assert np.array_equal(np.isinf(gs), np.isinf(ws))
    fin = np.isfinite(ws)
    assert (np.abs(gs[fin] - ws[fin])
            <= 2 * np.spacing(np.abs(ws[fin]))).all()
    idle = (act == 0).T
    assert np.isinf(gs[idle]).all() and (gr[idle] == 0).all()
    if case == "dups":
        assert (gs[0, 0] == gs[0, 0, 0]).all()
        assert (np.diff(gr[0, 0]) > 0).all()


@pytest.mark.parametrize("nw,qc,n_parts,budget", [
    (977, 256, 1, 32 << 20), (977, 16, 1, 32 << 20), (245, 256, 4, 32 << 20),
    (17, 256, 1, 32 << 20), (5, 3000, 2, 1 << 20), (1, 1, 1, 1 << 40),
    (70000, 1, 1, 1 << 40), (977, 256, 1, 16 << 20)])
def test_knn_chunk_plan(nw, qc, n_parts, budget):
    """K9's chunks of windows cover [0, nw) in order, each within the
    scratch budget, at least one window each even when one window alone is
    over it, and within the score pass's grid limit."""
    cw = k.knn_chunk_windows(nw, qc, n_parts, budget)
    chunks = k.knn_chunks(nw, cw)
    assert chunks[0][0] == 0 and chunks[-1][1] == nw
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(w1 - w0 >= 1 for w0, w1 in chunks)
    assert all(w1 - w0 <= cw for w0, w1 in chunks)
    per_window = n_parts * qc * k.KNN_W * 4
    assert cw == 1 or cw * per_window <= budget
    assert cw * (k.KNN_W // 128) <= 65535
    if per_window <= budget and nw * per_window > budget:
        assert (cw + 1) * per_window > budget      # the budget is used
    assert k.knn_chunk_windows(nw, qc, n_parts) == k.knn_chunk_windows(
        nw, qc, n_parts, k.KNN_SCRATCH_BYTES)


def test_knn_int8_window_topc_stacked_equals_per_partition():
    """The stacked launch (a partition axis) equals one launch per
    partition."""
    qi8, qmeta, q8, meta, act, fmask = knn_inputs(
        12, qc=5, nw=2, dims=48, masked=True, n_parts=3)
    got_s, got_r = k.knn_int8_window_topc(
        _t(qi8), _t(qmeta), _t(q8), _t(meta), _t(act), _t(fmask),
        similarity="cosine")
    assert got_s.shape == (3, 2, 5, k.KNN_CANDW)
    for p in range(3):
        ps, pr = k.knn_int8_window_topc(
            _t(qi8), _t(qmeta), _t(q8[p]), _t(meta[p]), _t(act[p]),
            _t(fmask[p]), similarity="cosine")
        assert torch.equal(got_s[p], ps) and torch.equal(got_r[p], pr)


def test_knn_fma_is_correctly_rounded():
    """The plain K9's fused multiply-add against long double arithmetic on
    cases built to sit next to a rounding boundary."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal(200_000).astype(np.float32)
    b = rng.standard_normal(200_000).astype(np.float32)
    c = (-(a.astype(np.float64) * b)).astype(np.float32)
    c[::2] *= np.float32(1 + 2 ** -22)
    c[1::4] = rng.standard_normal(c[1::4].shape).astype(np.float32) * 1e-4
    ld = np.longdouble
    want = (a.astype(ld) * b.astype(ld) + c.astype(ld)).astype(np.float32)
    assert np.finfo(ld).nmant > 53, "needs an extended long double"
    got = k._fma(_t(a), _t(b), _t(c)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_parts,kk", [(1, 10), (3, 10), (4, 7)])
def test_merge_topk_bitwise(n_parts, kk):
    """K4 against the reference kernel and the reference's host lexsort
    merge, with empty lanes, ties within and across partitions and one ord
    in several partitions."""
    s, o = merge_inputs(n_parts * 10 + kk, q=16, n_parts=n_parts, kk=kk)
    want = ref_k.merge_topk(jnp.asarray(s), jnp.asarray(o), k=kk)
    k.reset_launches()
    got = k.merge_topk(_t(s), _t(o), k=kk)
    assert k.LAUNCHES["merge_topk"] == 0
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    host = SimpleNamespace(_fused=False, S=n_parts, n_docs=[40])
    s_all = s.reshape(16, n_parts, kk).transpose(1, 0, 2)
    o_all = o.reshape(16, n_parts, kk).transpose(1, 0, 2)
    lex = RefKnnEngine._merge(host, s_all, o_all, kk)
    for g, w in zip(got, lex):
        assert np.array_equal(g.numpy(), w)
    gs = got[0].numpy()
    assert (gs == 0).any() and (gs > 0).any()


def test_merge_partition_topk_matches_host_merge():
    from elasticsearch_tpu_torch.parallel.spmd import merge_partition_topk

    s, o = merge_inputs(5, q=12, n_parts=3, kk=10)
    s_all = s.reshape(12, 3, 10).transpose(1, 0, 2).copy()
    o_all = o.reshape(12, 3, 10).transpose(1, 0, 2).copy()
    got = merge_partition_topk(s_all, o_all, 10, device="cpu")
    host = SimpleNamespace(_fused=False, S=3, n_docs=[40])
    for g, w in zip(got, RefKnnEngine._merge(host, s_all, o_all, 10)):
        assert np.array_equal(g, w)


def test_knn_wrappers_reject_bad_inputs():
    qi8, qmeta, q8, meta, act, _ = knn_inputs(0, qc=4, nw=1, dims=48)
    args = [_t(a) for a in (qi8, qmeta, q8, meta, act)]
    with pytest.raises(ValueError, match="similarity"):
        k.knn_int8_window_topc(*args, similarity="hamming")
    with pytest.raises(ValueError):
        k.knn_int8_window_topc(args[0][:, :64].contiguous(), *args[1:])
    with pytest.raises(TypeError):
        k.knn_int8_window_topc(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError):
        k.knn_int8_window_topc(*args[:4], args[4][:, :0].contiguous())
    s, o = merge_inputs(0, q=2, n_parts=2, kk=5)
    with pytest.raises(ValueError, match="whole partitions"):
        k.merge_topk(_t(s), _t(o), k=3)
    with pytest.raises(TypeError):
        k.merge_topk(_t(s), _t(o).long(), k=5)


def _agg_both(mask, blob, ps, n_seg):
    """(port, reference) K8 counts, one array per section."""
    if len(ps) == 1:
        got = [k.agg_segment_counts(_t(mask), _t(blob), p=ps[0],
                                    n_segments=n_seg)]
        want = [ref_k.agg_segment_counts(jnp.asarray(mask),
                                         jnp.asarray(blob), p=ps[0],
                                         n_segments=n_seg)]
    else:
        got = k.agg_two_level_counts(_t(mask), _t(blob), pd=ps[0],
                                     pm=ps[1], n_segments=n_seg)
        want = ref_k.agg_two_level_counts(jnp.asarray(mask),
                                          jnp.asarray(blob), pd=ps[0],
                                          pm=ps[1], n_segments=n_seg)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_agg_counts_bitwise(case):
    """K8: pad pairs and pad chunks, buckets at or past n_segments (some
    past the last tile), unsorted pairs over 3 tiles, tile ranges that
    disagree with the pairs, a batch padded to its rung, and the two-level
    blob, against the JAX kernel in interpret mode."""
    mask, blob, ps, n_seg = agg_inputs(case)
    k.reset_launches()
    got, want = _agg_both(mask, blob, ps, n_seg)
    assert k.LAUNCHES["agg_counts"] == 0
    assert len(got) == len(ps)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (mask.shape[0], n_seg)
        assert np.array_equal(g, w)
    assert all(g.sum() > 0 for g in got)
    if case == "q_padded_to_rung":
        assert not got[0][1:].any()


def test_agg_counts_ranges_decide():
    """The tile ranges are honoured, not rederived: the inconsistent case
    counts less than the same pairs with consistent ranges."""
    mask, blob, ps, n_seg = agg_inputs("inconsistent_ranges")
    rng = np.random.default_rng(AGG_CASES["inconsistent_ranges"][0])
    good = np.concatenate(agg_section(rng, 8000, n_seg, 6000, grouped=False))
    bad = k.agg_segment_counts(_t(mask), _t(blob), p=ps[0], n_segments=n_seg)
    ok = k.agg_segment_counts(_t(mask), _t(good), p=ps[0], n_segments=n_seg)
    assert np.array_equal(good[:2 * ps[0]], blob[:2 * ps[0]])
    assert int(bad.sum()) < int(ok.sum())


def test_agg_wrappers_reject_bad_inputs():
    mask, blob, ps, n_seg = agg_inputs("pads")
    m, b = _t(mask), _t(blob)
    with pytest.raises(ValueError, match="need"):
        k.agg_segment_counts(m, b[:-1].contiguous(), p=ps[0], n_segments=n_seg)
    with pytest.raises(ValueError, match="multiple"):
        k.agg_segment_counts(m, b, p=ps[0] - 1, n_segments=n_seg)
    with pytest.raises(TypeError):
        k.agg_segment_counts(m.to(torch.uint8), b, p=ps[0], n_segments=n_seg)
    with pytest.raises(TypeError):
        k.agg_segment_counts(m, b.long(), p=ps[0], n_segments=n_seg)
    with pytest.raises(ValueError, match="need"):
        k.agg_two_level_counts(m, b, pd=ps[0], pm=1024, n_segments=n_seg)


# ---------------------------------------------------------------------------
# the K8 and K4 designs (word pack + run-length counts; one-pass rank merge)
# held to the plain versions and the reference before the card runs them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(AGG_WORD_CASES))
def test_agg_word_counts_bitwise(case):
    """K8 at the edges of the word design: Q of 5, 9, 17, 33 and 40 (every
    word width, two query groups, all-False padding rows), runs across
    chunks and a tile boundary, inconsistent tile ranges and 33,000
    buckets at Q > 1. The plain version equals the JAX kernel in interpret
    mode, and the numpy model of agg_counts.cu (pack, persistent grid,
    runs, carry-save planes) equals both, also with the histogram cut to
    force sub-tile passes."""
    mask, blob, ps, n_seg = agg_word_inputs(case)
    k.reset_launches()
    got, want = _agg_both(mask, blob, ps, n_seg)
    assert k.LAUNCHES["agg_counts"] == 0
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (mask.shape[0], n_seg)
        assert np.array_equal(g, w)
    assert all(g.sum() > 0 for g in got)
    for kw in (dict(), dict(blocks=2, threads=32, hist_bins=9 * n_seg // 4)):
        model = emulate_agg_counts(mask, blob, ps, n_seg, **kw)
        for g, m in zip(got, model):
            assert np.array_equal(g, m), kw
    if case == "q40_padded":
        assert not any(g[23:].any() for g in got)


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_agg_counts_model_matches_plain(case):
    """The numpy model of agg_counts.cu on the existing K8 cases (Q 2-4,
    pads, buckets past n_segments, three tiles, inconsistent ranges, the
    two-level blob), and at Q = 1 on each case's first mask row (the byte
    path), with one block and with several, and with passes forced."""
    mask, blob, ps, n_seg = agg_inputs(case)
    plain = [g.numpy() for g in _agg_run_plain(mask, blob, ps, n_seg)]
    one = [g.numpy() for g in _agg_run_plain(mask[:1], blob, ps, n_seg)]
    for kw in (dict(blocks=1), dict(blocks=7, threads=64),
               dict(blocks=3, hist_bins=max(1, n_seg // 3) * 4)):
        for g, m in zip(plain, emulate_agg_counts(mask, blob, ps, n_seg,
                                                  **kw)):
            assert np.array_equal(g, m), kw
        for g, m in zip(one, emulate_agg_counts(mask[:1], blob, ps, n_seg,
                                                **kw)):
            assert np.array_equal(g, m), kw


def _agg_run_plain(mask, blob, ps, n_seg):
    m, b = _t(mask), _t(blob)
    if len(ps) == 1:
        return [k.agg_segment_counts(m, b, p=ps[0], n_segments=n_seg)]
    return list(k.agg_two_level_counts(m, b, pd=ps[0], pm=ps[1],
                                       n_segments=n_seg))


@pytest.mark.parametrize("q,n_docs", [(2, 13), (8, 16), (9, 21), (16, 8),
                                      (17, 30), (32, 9), (33, 12), (64, 7)])
def test_agg_word_pack_model(q, n_docs):
    """The byte arithmetic and permutes of agg_counts.cu's pack_kernel put
    bit q of word d at mask[32g + q, d], docs padded to a multiple of 4
    with zero words, in agg_word_bytes bytes; pack_bits_kernel's nibble
    multiply puts row 0's doc d at bit d % 32 of word d / 32."""
    rng = np.random.default_rng(q * 100 + n_docs)
    mask = rng.random((q, n_docs)) < 0.5
    words = emulate_agg_pack(mask)
    n_pad = -(-n_docs // 4) * 4
    width = 1 if q <= 8 else 2 if q <= 16 else 4
    assert words.shape == (-(-q // 32), n_pad)
    assert k.agg_word_bytes(q, n_docs) == (words.shape[0] * n_pad * width
                                           if width == 4 else n_pad * width)
    for g in range(words.shape[0]):
        for d in range(n_pad):
            want = sum(int(mask[32 * g + j, d]) << j
                       for j in range(min(32, q - 32 * g)) if d < n_docs)
            assert words[g, d] == want
            assert words[g, d] < (1 << (8 * width))
    bits = emulate_agg_bits(mask[0])
    assert k.agg_word_bytes(1, n_docs) == len(bits) * 4
    for d in range(len(bits) * 32):
        want = int(mask[0, d]) if d < n_docs else 0
        assert (int(bits[d >> 5]) >> (d & 31)) & 1 == want


def test_agg_counts_empty_rows_and_q1_model():
    """All-False mask rows count nothing on every route, and a layout
    whose only selected pairs sit in one padded row of a 64-row batch."""
    rng = np.random.default_rng(77)
    sec = agg_section(rng, 3000, 50, 3000, head=0.4)
    blob, ps = np.concatenate(sec), [len(sec[0])]
    mask = agg_masks(rng, 64, 3000, live_rows=1, density=0.5)
    mask[0] = False
    mask[37, ::7] = True
    got, want = _agg_both(mask, blob, ps, 50)
    assert np.array_equal(got[0], want[0])
    assert not np.delete(got[0], 37, axis=0).any() and got[0][37].any()
    model = emulate_agg_counts(mask, blob, ps, 50, blocks=3)
    assert np.array_equal(got[0], model[0])


@pytest.mark.parametrize("case", MERGE_EDGE_CASES)
def test_merge_rank_edges(case):
    """K4 at the edges of the one-pass rank merge: duplicate triples within
    a partition, one score in every partition, NaN / -0.0 / negative lanes,
    fewer positive lanes than k, L = 21. The plain version equals the JAX
    kernel in interpret mode, and the numpy model of merge_topk.cu equals
    them; empty slots are (0, 0, 0) with a +0.0 score. (The host lexsort
    merge keeps copied triples, so test_merge_topk_bitwise holds it on
    inputs without copies.)"""
    s, o, kk = merge_edge_inputs(case)
    q, L = s.shape
    want = ref_k.merge_topk(jnp.asarray(s), jnp.asarray(o), k=kk)
    got = k.merge_topk(_t(s), _t(o), k=kk)
    model = emulate_merge_rank(s, o, kk)
    for g, w, m in zip(got, want, model):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy(), m)
    assert not np.signbit(got[0].numpy()).any()


@pytest.mark.parametrize("seed,n_parts,kk,q", [(0, 4, 10, 32), (1, 1, 10, 8),
                                               (2, 3, 300, 2), (3, 5, 3, 20)])
def test_merge_rank_model_matches_plain(seed, n_parts, kk, q):
    """The numpy model of the rank merge on merge_inputs (ties within and
    across partitions, shared ords, empty lanes), at the path's S 4 x k 10
    and at the card test's S 3 x k 300."""
    s, o = merge_inputs(seed, q=q, n_parts=n_parts, kk=kk)
    got = k.merge_topk_plain(_t(s), _t(o), k=kk)
    for g, m in zip(got, emulate_merge_rank(s, o, kk)):
        assert np.array_equal(g.numpy(), m)


@pytest.mark.parametrize("q, n_seg, want", [
    (1, 256, (1, 256, 1, 1)), (16, 256, (1, 256, 1, 1)),
    (64, 256, (2, 256, 1, 2)), (26, 2161, (1, 2161, 1, 1)),
    (27, 2161, (1, 2123, 2, 2)), (32, 2161, (1, 1792, 2, 2)),
    (40, 2161, (2, 1792, 2, 3)), (1, 60_000, (1, 57_344, 2, 2))])
def test_agg_plan_model(q, n_seg, want):
    """The histogram plan agg_counts.cu's header states, from the tests'
    model (agg_plan; the card test holds it to es_agg_plan): (word
    groups, W, passes of the first group, passes summed over the groups).
    256 tag buckets take one pass at every Q, 2,161 hour ranks one up to
    Q = 26, two at Q = 27-32; 60,000 buckets two at Q = 1."""
    assert agg_plan(q, n_seg) == want


def test_poisoned_fills_wrapper_outputs():
    """kernels.poisoned: inside it, _out (every wrapper's output and
    scratch allocation) fills floats with NaN and integers with -1, and
    the switch is restored on exit, also after an error."""
    assert not k._POISON
    with k.poisoned():
        f = k._out((3, 5), torch.float32, torch.device("cpu"))
        i = k._out((7,), torch.int32, torch.device("cpu"))
        b = k._out((2, 2), torch.int8, torch.device("cpu"))
        with k.poisoned():
            pass
        assert k._POISON
    assert torch.isnan(f).all() and (i == -1).all() and (b == -1).all()
    assert not k._POISON
    with pytest.raises(RuntimeError):
        with k.poisoned():
            raise RuntimeError("inside")
    assert not k._POISON
