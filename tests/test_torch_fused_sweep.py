"""F1-F3's sweep as the cluster kernel runs it, on the CPU.

sweep_rowmax.cu's fused_sweep_kernel (F1 `es_fused_sweep_rowmax`, F2
`es_fused_sweep_rowmax_conj`, F3's second launch
`es_fused_sweep_rowmax_bitset`) splits a superwindow's 512 rows over a
cluster of FUSED_CLUSTER blocks, takes a tile's queries into one block,
stages the union of their slots (F2: score and coverage slots) in shared
memory a row group at a time (in batches whose union fits the ring),
forms F2's coverage gate from the stage, scores the staged queries on an
exact int32 path and the others as sweep_group_kernel does, and picks
each query's top rows over the cluster's row maxima. Its order is
emulated in numpy (`emulate_fused_sweep`, tests/torch_kernel_cases.py,
with the plan mirrored by `kernels.fused_sweep_plan`) and held bitwise
against the plain F1-F3 on every FUSED_CASES entry and F2's edges
(FUSED_CONJ_CASES), and against the reference's K2 and K7 on some; the
card test `test_fused_sweep_plan_matches_kernel` holds the mirror to the
built kernel. Below the plan's QC for it (`kernels.FUSED_MIN_QC`, F3
`FUSED_MIN_QC_BITSET`, F2 `FUSED_MIN_QC_CONJ`) a launch runs
sweep_group_kernel over the partitions instead (`emulate_sweep_group`
with the launch's list capacity).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.parallel import kernels as ref_k
from elasticsearch_tpu_torch.parallel import kernels as k
from torch_kernel_cases import (
    FUSED_CASES, FUSED_CONJ_CASES, emulate_fused_sweep, emulate_sweep_group,
    fused_batches, fused_conj_inputs, fused_inputs, fused_plan_of,
)

torch.set_num_threads(1)

N_ROWS = 33


def _t(a):
    return torch.from_numpy(np.array(a))


def _masks(f):
    """Each partition's K5 mask (the plain version) stacked as F3's second
    launch reads it, [S, QC, nsw_max * 16, 128], zero past a partition's
    nsw; and the partitions' bitsets."""
    nsw_max = max(f["nsw"])
    qc = f["wq"].shape[2]
    out = np.zeros((len(f["hi"]), qc, nsw_max * k.SW_WORD_ROWS, 128),
                   np.int32)
    bits = []
    for i, (h, lo) in enumerate(zip(f["hi"], f["lo"])):
        b = k.pack_presence_bits_plain(_t(h), _t(lo))
        m, _ = k.intersect_bitset_counts_plain(
            _t(f["q_slots"][i]), _t(f["q_neg"][i]), b, nsw=f["nsw"][i])
        out[i, :, :f["nsw"][i] * k.SW_WORD_ROWS] = m.numpy()
        bits.append(b)
    return out, bits


def _emulate(f, mask, mode, stats=None):
    """emulate_fused_sweep on a case's inputs in `mode`."""
    conj = {"nreq": f["nreq"], "wp": f["wp"]} if mode == "conj" else {}
    return emulate_fused_sweep(f["qscale"], f["wq"], f["hi"], f["lo"],
                               f["live"], f["nsw"], mask=mask, stats=stats,
                               **conj)


def _picked_plain(f, bits, mode):
    """The plain F1 / F2 / F3's picked rows of a case."""
    hi, lo, live = ([_t(a) for a in f[n]] for n in ("hi", "lo", "live"))
    if mode == "disj":
        return k.fused_sweep_rowmax_plain(
            _t(f["qscale"]), hi, lo, _t(f["wq"]), live, nsw=f["nsw"],
            n_rows=N_ROWS)
    if mode == "conj":
        return k.fused_sweep_rowmax_conj_plain(
            _t(f["qscale"]), _t(f["nreq"]), hi, lo, _t(f["wq"]),
            _t(f["wp"]), live, nsw=f["nsw"], n_rows=N_ROWS)
    return k.fused_sweep_rowmax_bitset_plain(
        _t(f["qscale"]), _t(f["q_slots"]), _t(f["q_neg"]), bits, hi, lo,
        _t(f["wq"]), live, nsw=f["nsw"], n_rows=N_ROWS)[0]


# what each edge case must reach in the kernel's order (emulation counts)
FEATURES = {
    "union": lambda st, f, mode: st["batches"] > sum(f["nsw"]),
    "lists": lambda st, f, mode: st["direct"] > 0,
    "wide": lambda st, f, mode: st["direct"] > 0,
    "intpath": lambda st, f, mode: st["direct"] > 0,
    "skip": lambda st, f, mode: mode != "bitset" or st["skipped_stages"] > 0,
}


@pytest.mark.parametrize("mode", ["disj", "bitset", "conj"])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_sweep_cluster_order_emulated(case, mode):
    """The cluster kernel's order (tiles, rank-owned lists, staged and
    direct queries, batches by union, the row split, the selection over
    the cluster's rows) gives each partition's plain K2 / K7 / K6 rows on
    its own superwindows, dead padding past them, and the plain F1 / F2 /
    F3's picked rows, bitwise."""
    f = fused_inputs(case)
    mask, bits = _masks(f) if mode == "bitset" else (None, None)
    st = {}
    rm, rr = _emulate(f, mask, mode, st)
    pm, pr = _plain_rows(f, mask, mode)
    for i, nsw in enumerate(f["nsw"]):
        assert np.array_equal(rm[i, :nsw], pm[i, :nsw]), (case, i)
        assert np.array_equal(rr[i, :nsw], pr[i, :nsw]), (case, i)
        assert np.isneginf(rm[i, nsw:]).all() and not rr[i, nsw:].any()
    picked = k.pick_rows(_t(rm), _t(rr), n_rows=N_ROWS)
    assert torch.equal(picked, _picked_plain(f, bits, mode))
    assert np.isfinite(rm).any()
    if case in FEATURES:
        assert FEATURES[case](st, f, mode), (case, mode, st)


@pytest.mark.parametrize("case", ["three", "qc8", "skip"])
def test_fused_sweep_emulation_matches_reference(case):
    """The emulated cluster kernel's rows of each partition equal the
    reference's K2 (Pallas, interpreted) on that partition."""
    f = fused_inputs(case)
    rm, rr = emulate_fused_sweep(f["qscale"], f["wq"], f["hi"], f["lo"],
                                 f["live"], f["nsw"])
    for i, nsw in enumerate(f["nsw"]):
        hpt = f["hi"][i].shape[1]
        wm, wr = ref_k.sweep_rowmax(
            jnp.asarray(f["qscale"][i]), jnp.asarray(f["hi"][i]),
            jnp.asarray(f["lo"][i]),
            jnp.asarray(np.ascontiguousarray(f["wq"][i, :, :, :hpt])),
            jnp.asarray(f["live"][i]), QC=f["wq"].shape[2], nsw=nsw)
        assert np.array_equal(rm[i, :nsw], np.asarray(wm))
        assert np.array_equal(rr[i, :nsw], np.asarray(wr))


@pytest.mark.parametrize("case", ["three", "filters"])
def test_fused_sweep_conj_emulation_matches_reference(case):
    """F2's order: the emulated cluster kernel's rows of each partition
    equal the reference's K7 (Pallas, interpreted) on that partition; the
    FUSED_CASES entry and a FUSED_CONJ_CASES one (coverage-only filters,
    queries with no score weight)."""
    f = fused_inputs(case) if case in FUSED_CASES else fused_conj_inputs(case)
    rm, rr = _emulate(f, None, "conj")
    qc = f["wq"].shape[2]
    for i, nsw in enumerate(f["nsw"]):
        hpt = f["hi"][i].shape[1]
        wm, wr = ref_k.sweep_rowmax_conj(
            jnp.asarray(f["qscale"][i]), jnp.asarray(f["nreq"][i]),
            jnp.asarray(f["hi"][i]), jnp.asarray(f["lo"][i]),
            jnp.asarray(np.ascontiguousarray(f["wq"][i, :, :, :hpt])),
            jnp.asarray(np.ascontiguousarray(f["wp"][i, :, :hpt])),
            jnp.asarray(f["live"][i]), QC=qc, nsw=nsw)
        assert np.array_equal(rm[i, :nsw], np.asarray(wm))
        assert np.array_equal(rr[i, :nsw], np.asarray(wr))


@pytest.mark.parametrize("cap", [6, 12, 40, 255])
def test_fused_batches_plan(cap):
    """The planner's batches of the union case's lists: every query once,
    in order, consecutive, each batch's union within cap (a query a batch
    when no k up to FUSED_KMAX fits), one batch when the whole union
    fits."""
    f = fused_inputs("union")
    wq = f["wq"][0]
    lists = [np.nonzero((wq[0, q] != 0) | (wq[1, q] != 0))[0]
             for q in range(wq.shape[1]) if (wq[:, q] != 0).any()]
    batches = fused_batches(lists, cap)
    assert [t for b in batches for t in b] == list(range(len(lists)))
    for b in batches:
        assert b == list(range(b[0], b[-1] + 1))
        assert len(set().union(*(set(lists[t]) for t in b))) <= cap
    whole = len(set().union(*(set(x) for x in lists)))
    assert (len(batches) == 1) == (whole <= cap)
    plan = fused_plan_of("union")
    assert 0 < plan["slot_cap"] <= 255
    assert plan["ring_slots"] >= 2 * plan["slot_cap"]
    assert plan["smem"] <= 232448


def _plain_rows(f, mask, mode):
    """Each partition's plain K2 / K7 / K6 rows, as F1 / F2 / F3's sweep
    stacks them, padding -inf / 0 past its nsw."""
    S, qc = len(f["hi"]), f["wq"].shape[2]
    nsw_max = max(f["nsw"])
    rm = np.full((S, nsw_max, qc, k.CAND_PAD), -np.inf, np.float32)
    rr = np.zeros((S, nsw_max, qc, k.CAND_PAD), np.int32)
    for i, nsw in enumerate(f["nsw"]):
        hpt = f["hi"][i].shape[1]
        a = (_t(f["qscale"][i]), _t(f["hi"][i]), _t(f["lo"][i]),
             _t(f["wq"][i, :, :, :hpt]))
        if mode == "disj":
            pm, pr = k.sweep_rowmax_plain(*a, _t(f["live"][i]), nsw=nsw)
        elif mode == "conj":
            pm, pr = k.sweep_rowmax_conj_plain(
                _t(f["qscale"][i]), _t(f["nreq"][i]), _t(f["hi"][i]),
                _t(f["lo"][i]), _t(f["wq"][i, :, :, :hpt]),
                _t(f["wp"][i, :, :hpt]), _t(f["live"][i]), nsw=nsw)
        else:
            pm, pr = k.sweep_rowmax_bitset_plain(
                *a, _t(mask[i, :, :nsw * k.SW_WORD_ROWS]), _t(f["live"][i]),
                nsw=nsw)
        rm[i, :nsw], rr[i, :nsw] = pm.numpy(), pr.numpy()
    return rm, rr


MIN_QC = {"disj": k.FUSED_MIN_QC, "bitset": k.FUSED_MIN_QC_BITSET,
          "conj": k.FUSED_MIN_QC_CONJ}


def _group_rows(f, mask, mode):
    """sweep_group_kernel's rows on each partition with a fused launch's
    list capacity (that of its widest cache), stacked as the fused
    output."""
    S, nsw_max, qc = len(f["hi"]), max(f["nsw"]), f["wq"].shape[2]
    hpt_max = max(h.shape[1] for h in f["hi"])
    rm = np.full((S, nsw_max, qc, k.CAND_PAD), -np.inf, np.float32)
    rr = np.zeros((S, nsw_max, qc, k.CAND_PAD), np.int32)
    for i, nsw in enumerate(f["nsw"]):
        hpt = f["hi"][i].shape[1]
        conj = ({"wp": np.ascontiguousarray(f["wp"][i, :, :hpt]),
                 "nreq": f["nreq"][i]} if mode == "conj" else {})
        rm[i, :nsw], rr[i, :nsw] = emulate_sweep_group(
            f["qscale"][i], f["hi"][i], f["lo"][i],
            np.ascontiguousarray(f["wq"][i, :, :, :hpt]), f["live"][i],
            nsw, cap=k.sweep_list_cap(hpt_max),
            mask=None if mask is None
            else mask[i, :, :nsw * k.SW_WORD_ROWS], **conj)
    return rm, rr


@pytest.mark.parametrize("mode", ["disj", "bitset", "conj"])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_sweep_route_emulated(case, mode):
    """The kernel a launch runs at each case's QC, as the plan says:
    below FUSED_MIN_QC (F3: FUSED_MIN_QC_BITSET, F2: FUSED_MIN_QC_CONJ)
    sweep_group_kernel on each partition with the launch's list capacity
    (that of its widest cache), else the cluster kernel; either one
    bitwise the plain rows."""
    f = fused_inputs(case)
    mask = _masks(f)[0] if mode == "bitset" else None
    qc = f["wq"].shape[2]
    hpt_max = max(h.shape[1] for h in f["hi"])
    plan = k.fused_sweep_plan(qc, hpt_max, mode)
    assert plan["cluster"] == (qc >= MIN_QC[mode])
    rm, rr = (_emulate(f, mask, mode) if plan["cluster"]
              else _group_rows(f, mask, mode))
    pm, pr = _plain_rows(f, mask, mode)
    assert np.array_equal(rm, pm) and np.array_equal(rr, pr)


@pytest.mark.parametrize("mode", ["disj", "bitset", "conj"])
@pytest.mark.parametrize("case", ["qc1", "qc8", "skip", "intpath"])
def test_fused_sweep_cluster_order_padded(case, mode):
    """The small-QC edges padded with inert queries to the QC from which a
    launch runs the cluster kernel (as the card test pads them): the
    cluster kernel's order gives the plain rows bitwise, the inert queries
    -inf rows, and they take no room in its batches."""
    bitset = mode == "bitset"
    pad = MIN_QC[mode]
    f = fused_inputs(case, pad_qc=pad)
    base = fused_inputs(case)
    assert f["wq"].shape[2] == pad
    assert np.array_equal(f["wq"][:, :, :base["wq"].shape[2]], base["wq"])
    mask = _masks(f)[0] if bitset else None
    assert fused_plan_of(case, mode)["gq"] <= pad
    assert k.fused_sweep_plan(pad, max(h.shape[1] for h in f["hi"]),
                              mode)["cluster"]
    st, st0 = {}, {}
    rm, rr = _emulate(f, mask, mode, st)
    _emulate(base, _masks(base)[0] if bitset else None, mode, st0)
    pm, pr = _plain_rows(f, mask, mode)
    assert np.array_equal(rm, pm) and np.array_equal(rr, pr)
    assert np.isneginf(rm[:, :, base["wq"].shape[2]:]).all()
    assert st["staged"] == st0["staged"] and st["direct"] == st0["direct"]


# what each F2 edge must reach in the kernel's order
CONJ_FEATURES = {
    "filters": lambda st, f: st["staged"] > 0,
    "int_path": lambda st, f: st["direct"] > 0,
    "padding": lambda st, f: st["staged"] > 0,
    "cover_union": lambda st, f: st["batches"] > 2 * sum(f["nsw"]),
}


@pytest.mark.parametrize("case", FUSED_CONJ_CASES)
def test_fused_conj_edges_emulated(case):
    """F2's edges (coverage-only filters, queries with coverage weight but
    no score weight, a must_not in every doc of a query's top row, nreq 0,
    integer-path queries and a qscale <= 0, QC 256 with 128 padding
    queries, a tile whose score slots fit one batch and whose score and
    coverage slots do not), padded with inert queries to
    FUSED_MIN_QC_CONJ where below it: the cluster kernel's order gives
    each partition's plain K7 rows and the plain F2's picked rows bitwise;
    unpadded, the launch's kernel (sweep_group_kernel below the threshold)
    gives them too."""
    base = fused_conj_inputs(case)
    qc = base["wq"].shape[2]
    f = fused_conj_inputs(case, pad_qc=max(qc, k.FUSED_MIN_QC_CONJ))
    st = {}
    rm, rr = _emulate(f, None, "conj", st)
    pm, pr = _plain_rows(f, None, "conj")
    assert np.array_equal(rm, pm) and np.array_equal(rr, pr)
    picked = k.pick_rows(_t(rm), _t(rr), n_rows=N_ROWS)
    assert torch.equal(picked, _picked_plain(f, None, "conj"))
    assert np.isfinite(rm).any()
    if case in CONJ_FEATURES:
        assert CONJ_FEATURES[case](st, f), (case, st)
    if case == "cover_union":   # the score slots alone fit one batch
        wq = f["wq"][0]
        slot_cap = k.fused_sweep_plan(qc, max(h.shape[1] for h in f["hi"]),
                                      "conj")["slot_cap"]
        lists = [np.nonzero((wq[:, q] != 0).any(axis=0))[0]
                 for q in range(qc) if (wq[:, q] != 0).any()]
        assert len(fused_batches(lists, slot_cap)) == 1
    hpt_max = max(h.shape[1] for h in base["hi"])
    brm, brr = (_emulate(base, None, "conj")
                if k.fused_sweep_plan(qc, hpt_max, "conj")["cluster"]
                else _group_rows(base, None, "conj"))
    assert np.array_equal(brm, rm[:, :, :qc])
    assert np.array_equal(brr, rr[:, :, :qc])
