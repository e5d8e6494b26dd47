"""The plain versions of K10 `lane_topk` and K11 `weighted_block_scatter`
against numpy statements of their contracts, on the CPU, and the wrappers'
argument checks. (tests/test_torch_blockmax.py holds them against the
reference's programs; tests/test_torch_kernels_cuda.py holds the kernels
against them on the card.) K10's plain version is bitwise equal to a
per-doc dict that adds each doc's weighted lane scores in run order."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.parallel import kernels as k
from torch_kernel_cases import (
    LANE_TOPK_MODES, lane_topk_brute, lane_topk_inputs,
    weighted_scatter_inputs,
)

torch.set_num_threads(1)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _lane_args(name, mode, seed=0):
    bd, bs, live, qb, qw, ts, kk, extra = lane_topk_inputs(name, mode, seed)
    args = [_t(a) for a in (bd, bs, live, qb, qw, ts)]
    kw = {key: _t(v) for key, v in extra.items()}
    return args, kk, kw, (bd, bs, live, qb, qw, ts, kk, extra)


@pytest.mark.parametrize("mode", LANE_TOPK_MODES)
@pytest.mark.parametrize("name", ["ties", "big_k", "edges"])
def test_lane_topk_plain_matches_brute(name, mode):
    args, kk, kw, raw = _lane_args(name, mode)
    got_s, got_d = k.lane_topk(*args, k=kk, **kw)      # CPU: plain version
    bd, bs, live, qb, qw, ts, _, extra = raw
    want_s, want_d = lane_topk_brute(bd, bs, live, qb, qw, ts, kk, **extra)
    assert np.array_equal(got_s.numpy(), want_s)
    assert np.array_equal(got_d.numpy(), want_d)
    assert (got_s.numpy() > 0).any()
    assert k.LAUNCHES["lane_topk"] == 0


def test_lane_topk_checks_arguments():
    args, kk, kw, _ = _lane_args("edges", "bool")
    bd, bs, live, qb, qw, ts = args
    with pytest.raises(TypeError):
        k.lane_topk(bd.long(), bs, live, qb, qw, ts, k=kk, **kw)
    with pytest.raises(ValueError):
        k.lane_topk(bd, bs, live, qb, qw[:, :, :-1].contiguous(), ts, k=kk,
                    **kw)
    with pytest.raises(ValueError):
        k.lane_topk(bd, bs, live, qb, qw, ts, k=kk, qf=kw["qf"])
    with pytest.raises(ValueError):
        k.lane_topk(bd, bs, live, qb, qw, ts, k=kk, hp=kw["hp"])
    with pytest.raises(ValueError):
        k.lane_topk(bd, bs, live, qb, qw, ts[:, :, :1].contiguous(), k=kk)
    with pytest.raises(ValueError):
        k.lane_topk(bd, bs, live, qb, qw, ts, k=0)
    assert k.lane_topk_cap(10) == 2048 and k.lane_topk_cap(1100) == 4096


@pytest.mark.parametrize("name", ["columns", "outside"])
def test_weighted_block_scatter_plain_matches_numpy(name):
    acc, ids, w, rows, bd, bs = weighted_scatter_inputs(name)
    want = acc.copy()
    S, R, D = acc.shape
    T = bd.shape[1]
    for s in range(S):
        for c in range(ids.shape[1]):
            b, r = ids[s, c], 0 if rows is None else rows[s, c]
            if not (0 <= b < T and 0 <= r < R):
                continue
            sc = bs[s, b]
            d = bd[s, b]
            m = (sc > 0) & (d >= 0) & (d < D)
            want[s, r, d[m]] = want[s, r, d[m]] + np.float32(w[s, c]) * sc[m]
    got = _t(acc.copy())
    out = k.weighted_block_scatter(got, _t(ids), _t(w), _t(bd), _t(bs),
                                   rows=_t(rows))
    assert out is got
    assert np.array_equal(got.numpy(), want)
    assert k.LAUNCHES["weighted_block_scatter"] == 0


def test_weighted_block_scatter_checks_arguments():
    acc, ids, w, rows, bd, bs = weighted_scatter_inputs("outside")
    a = _t(acc)
    with pytest.raises(TypeError):
        k.weighted_block_scatter(a, _t(ids).long(), _t(w), _t(bd), _t(bs))
    with pytest.raises(ValueError):
        k.weighted_block_scatter(a, _t(ids), _t(w[:, :-1]), _t(bd), _t(bs))
    with pytest.raises(ValueError):
        k.weighted_block_scatter(a, _t(ids), _t(w), _t(bd), _t(bs),
                                 rows=_t(rows[:, :-1]))
