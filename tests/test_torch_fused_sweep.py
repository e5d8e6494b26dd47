"""F1 and F3's sweep as the cluster kernel runs it, on the CPU.

sweep_rowmax.cu's fused_sweep_kernel (F1 `es_fused_sweep_rowmax`, F3's
second launch `es_fused_sweep_rowmax_bitset`) splits a superwindow's 512
rows over a cluster of FUSED_CLUSTER blocks, takes a tile's queries into
one block, stages the union of their slots in shared memory a row group at
a time (in batches whose union fits the ring), scores the staged queries
on an exact int32 path and the others as sweep_group_kernel does, and
picks each query's top rows over the cluster's row maxima. Its order is
emulated in numpy (`emulate_fused_sweep`, tests/torch_kernel_cases.py,
with the plan mirrored by `kernels.fused_sweep_plan`) and held bitwise
against the plain F1 and F3 on every FUSED_CASES entry, and against the
reference's K2 on some; the card test `test_fused_sweep_plan_matches_kernel`
holds the mirror to the built kernel. Below the plan's QC for it
(`kernels.FUSED_MIN_QC`, F3 `FUSED_MIN_QC_BITSET`) a launch runs
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
    FUSED_CASES, emulate_fused_sweep, emulate_sweep_group, fused_batches,
    fused_inputs, fused_plan_of,
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


# what each edge case must reach in the kernel's order (emulation counts)
FEATURES = {
    "union": lambda st, f, mode: st["batches"] > sum(f["nsw"]),
    "lists": lambda st, f, mode: st["direct"] > 0,
    "wide": lambda st, f, mode: st["direct"] > 0,
    "intpath": lambda st, f, mode: st["direct"] > 0,
    "skip": lambda st, f, mode: mode == "disj" or st["skipped_stages"] > 0,
}


@pytest.mark.parametrize("mode", ["disj", "bitset"])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_sweep_cluster_order_emulated(case, mode):
    """The cluster kernel's order (tiles, rank-owned lists, staged and
    direct queries, batches by union, the row split, the selection over
    the cluster's rows) gives each partition's plain K2 / K6 rows on its
    own superwindows, dead padding past them, and the plain F1 / F3's
    picked rows, bitwise."""
    f = fused_inputs(case)
    mask, bits = _masks(f) if mode == "bitset" else (None, None)
    st = {}
    rm, rr = emulate_fused_sweep(f["qscale"], f["wq"], f["hi"], f["lo"],
                                 f["live"], f["nsw"], mask=mask, stats=st)
    for i, nsw in enumerate(f["nsw"]):
        hpt = f["hi"][i].shape[1]
        a = (_t(f["qscale"][i]), _t(f["hi"][i]), _t(f["lo"][i]),
             _t(f["wq"][i, :, :, :hpt]))
        if mode == "disj":
            pm, pr = k.sweep_rowmax_plain(*a, _t(f["live"][i]), nsw=nsw)
        else:
            pm, pr = k.sweep_rowmax_bitset_plain(
                *a, _t(mask[i, :, :nsw * k.SW_WORD_ROWS]), _t(f["live"][i]),
                nsw=nsw)
        assert np.array_equal(rm[i, :nsw], pm.numpy()), (case, i)
        assert np.array_equal(rr[i, :nsw], pr.numpy()), (case, i)
        assert np.isneginf(rm[i, nsw:]).all() and not rr[i, nsw:].any()
    picked = k.pick_rows(_t(rm), _t(rr), n_rows=N_ROWS)
    cols = ([_t(a) for a in f[n]] for n in ("hi", "lo", "live"))
    hi, lo, live = cols
    if mode == "disj":
        want = k.fused_sweep_rowmax_plain(
            _t(f["qscale"]), hi, lo, _t(f["wq"]), live, nsw=f["nsw"],
            n_rows=N_ROWS)
    else:
        want, _ = k.fused_sweep_rowmax_bitset_plain(
            _t(f["qscale"]), _t(f["q_slots"]), _t(f["q_neg"]), bits, hi, lo,
            _t(f["wq"]), live, nsw=f["nsw"], n_rows=N_ROWS)
    assert torch.equal(picked, want)
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
    """Each partition's plain K2 / K6 rows, as F1 / F3's sweep stacks
    them, padding -inf / 0 past its nsw."""
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
        else:
            pm, pr = k.sweep_rowmax_bitset_plain(
                *a, _t(mask[i, :, :nsw * k.SW_WORD_ROWS]), _t(f["live"][i]),
                nsw=nsw)
        rm[i, :nsw], rr[i, :nsw] = pm.numpy(), pr.numpy()
    return rm, rr


@pytest.mark.parametrize("mode", ["disj", "bitset"])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_sweep_route_emulated(case, mode):
    """The kernel a launch runs at each case's QC, as the plan says:
    below FUSED_MIN_QC (F3: FUSED_MIN_QC_BITSET) sweep_group_kernel on
    each partition with the launch's list capacity (that of its widest
    cache), else the cluster kernel; either one bitwise the plain rows."""
    f = fused_inputs(case)
    mask = _masks(f)[0] if mode == "bitset" else None
    qc = f["wq"].shape[2]
    hpt_max = max(h.shape[1] for h in f["hi"])
    plan = k.fused_sweep_plan(qc, hpt_max, mode == "bitset")
    assert plan["cluster"] == (qc >= (k.FUSED_MIN_QC_BITSET
                                      if mode == "bitset"
                                      else k.FUSED_MIN_QC))
    if plan["cluster"]:
        rm, rr = emulate_fused_sweep(f["qscale"], f["wq"], f["hi"], f["lo"],
                                     f["live"], f["nsw"], mask=mask)
    else:
        S, nsw_max = len(f["hi"]), max(f["nsw"])
        rm = np.full((S, nsw_max, qc, k.CAND_PAD), -np.inf, np.float32)
        rr = np.zeros((S, nsw_max, qc, k.CAND_PAD), np.int32)
        for i, nsw in enumerate(f["nsw"]):
            hpt = f["hi"][i].shape[1]
            rm[i, :nsw], rr[i, :nsw] = emulate_sweep_group(
                f["qscale"][i], f["hi"][i], f["lo"][i],
                np.ascontiguousarray(f["wq"][i, :, :, :hpt]), f["live"][i],
                nsw, cap=k.sweep_list_cap(hpt_max),
                mask=None if mask is None
                else mask[i, :, :nsw * k.SW_WORD_ROWS])
    pm, pr = _plain_rows(f, mask, mode)
    assert np.array_equal(rm, pm) and np.array_equal(rr, pr)


@pytest.mark.parametrize("mode", ["disj", "bitset"])
@pytest.mark.parametrize("case", ["qc1", "qc8", "skip", "intpath"])
def test_fused_sweep_cluster_order_padded(case, mode):
    """The small-QC edges padded with inert queries to the QC from which a
    launch runs the cluster kernel (as the card test pads them): the
    cluster kernel's order gives the plain rows bitwise, the inert queries
    -inf rows, and they take no room in its batches."""
    bitset = mode == "bitset"
    pad = k.FUSED_MIN_QC_BITSET if bitset else k.FUSED_MIN_QC
    f = fused_inputs(case, pad_qc=pad)
    base = fused_inputs(case)
    assert f["wq"].shape[2] == pad
    assert np.array_equal(f["wq"][:, :, :base["wq"].shape[2]], base["wq"])
    mask = _masks(f)[0] if bitset else None
    assert fused_plan_of(case, bitset)["gq"] <= pad
    assert k.fused_sweep_plan(pad, max(h.shape[1] for h in f["hi"]),
                              bitset)["cluster"]
    st, st0 = {}, {}
    rm, rr = emulate_fused_sweep(f["qscale"], f["wq"], f["hi"], f["lo"],
                                 f["live"], f["nsw"], mask=mask, stats=st)
    emulate_fused_sweep(base["qscale"], base["wq"], base["hi"], base["lo"],
                        base["live"], base["nsw"],
                        mask=_masks(base)[0] if bitset else None, stats=st0)
    pm, pr = _plain_rows(f, mask, mode)
    assert np.array_equal(rm, pm) and np.array_equal(rr, pr)
    assert np.isneginf(rm[:, :, base["wq"].shape[2]:]).all()
    assert st["staged"] == st0["staged"] and st["direct"] == st0["direct"]
