"""The plain versions of K10 `lane_topk` and K11 `weighted_block_scatter`
against numpy statements of their contracts, on the CPU, and the wrappers'
argument checks. (tests/test_torch_blockmax.py holds them against the
reference's programs; tests/test_torch_kernels_cuda.py holds the kernels
against them on the card.) K10's plain version is bitwise equal to a
per-doc dict that adds each doc's weighted lane scores in run order, and
to a numpy statement of the tiled kernel's algorithm; the wrapper's tiling
plan is held to its rules."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.parallel import kernels as k
from torch_kernel_cases import (
    LANE_TOPK_MODES, emulate_lane_topk, lane_topk_brute, lane_topk_inputs,
    weighted_scatter_inputs, weighted_scatter_numpy,
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
@pytest.mark.parametrize("name", ["ties", "big_k", "edges", "runs100"])
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
    assert k.lane_topk_cap(10) == 1024 and k.lane_topk_cap(1100) == 2048
    assert k.lane_topk_cap(15360) * 8 == k._LANE_TOPK_BUF_MAX


@pytest.mark.parametrize("S,Q,B,kk,want", [
    (1, 32, 8, 10, (64, 1)),          # pass A: one tile, no merge launch
    (1, 14, 32, 10, (64, 1)),
    (1, 8, 8192, 10, (64, 128)),      # the head shape
    (1, 16, 32768, 10, (64, 512)),    # the forced bool group
    (4, 14, 2048, 10, (64, 32)),      # spmd
    (2, 8, 512, 300, (64, 8)),        # 64 x 128 lanes >= 4 x 300
    (2, 8, 512, 2049, (128, 4)),
    (1, 2, 2048, 15360, (512, 4)),
    (1, 512, 32768, 15360, (32768, 1)),   # the scratch budget: one tile
    (1, 64, 32768, 15360, (4096, 8)),
])
def test_lane_topk_plan(S, Q, B, kk, want):
    """K10's tiling (the wrapper's host planning, which the kernel takes
    as arguments): C from 64 blocks, doubled while a tile's lanes are under
    4k and while the tiles' pairs exceed the scratch budget; tiles =
    ceil(B / C)."""
    C, tiles = k.lane_topk_plan(S, Q, B, kk)
    assert (C, tiles) == want
    assert tiles == max(-(-B // C), 1)
    assert C * 128 >= 4 * kk
    if tiles > 1:
        assert S * Q * tiles * kk * 8 <= k._LANE_TOPK_SCRATCH_MAX
        # C is the least such: half of it breaks a rule
        h = C // 2
        assert (h < k.LANE_TOPK_TILE_BLOCKS or h * 128 < 4 * kk
                or S * Q * -(-B // h) * kk * 8 > k._LANE_TOPK_SCRATCH_MAX)


@pytest.mark.parametrize("name,mode,tile_blocks,nb,chunk,sort_lanes", [
    ("edges", "lane", 2, 6, 64, 4096),
    ("edges", "hybrid", 2, 6, 64, 4096),
    ("edges", "bool", 2, 6, 64, 4096),
    ("ties", "lane", 2, 6, 64, 4096),
    ("big_k", "bool", 2, 6, 64, 4096),
    ("big_k", "hybrid", None, 96, 64, 4096),
    ("edges", "bool", 2, 6, 2, 0),
    ("ties", "hybrid", 2, 6, 1, 0),
    ("big_k", "lane", 2, 6, 3, 0),
    ("edges", "hybrid", 2, 6, 1, 16),
    ("ties", "bool", 2, 6, 2, 32),
    ("big_k", "lane", 2, 6, 1, 64),
    ("runs100", "bool", None, 96, 64, 4096),
])
def test_lane_topk_tiling_matches_plain(name, mode, tile_blocks, nb, chunk,
                                        sort_lanes):
    """The tiled kernel's algorithm (emulate_lane_topk) bitwise equal to the
    plain version. Rows of up to `chunk` runs: tiles cut at the longest
    run's blocks, blocks that straddle a cut read by both tiles, passes
    that halve a tile's doc range until its blocks fit the staging room,
    searches in the staged blocks, the first-run rule, each tile's ranked k
    and their merge; C = 2 and 6 staged blocks force many tiles and passes
    on small rows. Rows of more runs: the sorted tiles (even doc cuts,
    passes of at most `sort_lanes` lanes, each sorted by (doc, run)), or
    with `sort_lanes` 0 the runs in chunks, searching the runs of other
    chunks over the whole run; "runs100" is the kernel's own setting for a
    row of 100 runs."""
    bd, bs, live, qb, qw, ts, kk, extra = lane_topk_inputs(name, mode)
    stats = {}
    got_s, got_d = emulate_lane_topk(bd, bs, live, qb, qw, ts, kk, **extra,
                                     tile_blocks=tile_blocks, nb=nb,
                                     chunk=chunk, sort_lanes=sort_lanes,
                                     stats=stats)
    args, _, kw, _ = _lane_args(name, mode)
    want_s, want_d = k.lane_topk_plain(*args, k=kk, **kw)
    assert np.array_equal(got_s.view(np.int32), want_s.numpy().view(np.int32))
    assert np.array_equal(got_d, want_d.numpy())
    R = ts.shape[2] - 1
    if chunk < R <= sort_lanes:                 # the sorted tiles
        assert stats["tiles"] > 1 and stats["sorted_passes"] > 1
    elif tile_blocks is not None:
        assert stats["tiles"] > 3
        assert stats["passes"] > 1 or chunk < 64   # a small chunk fits
        assert (stats["chunks"] > 1) == (chunk < R)


@pytest.mark.parametrize("name", ["columns", "outside", "multi", "runs100",
                                  "mixed", "runs2500", "wide"])
def test_weighted_block_scatter_plain_matches_numpy(name):
    """The plain version, runs and all, bitwise equal to a numpy loop over
    the runs in order (weighted_scatter_numpy)."""
    acc, ids, w, rows, bd, bs, runs = weighted_scatter_inputs(name)
    want = weighted_scatter_numpy(acc, ids, w, rows, bd, bs, runs)
    got = _t(acc.copy())
    out = k.weighted_block_scatter(got, _t(ids), _t(w), _t(bd), _t(bs),
                                   rows=_t(rows), runs=runs)
    assert out is got
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert k.LAUNCHES["weighted_block_scatter"] == 0


@pytest.mark.parametrize("name", ["multi", "runs100", "mixed", "wide"])
def test_weighted_block_scatter_runs_share_docs(name):
    """The multi-run cases put several runs on one (partition, row, doc):
    their sums differ from the same lanes added in one vectorised step
    (where one writer of a target wins), so the run order is what the
    numpy statement checks."""
    acc, ids, w, rows, bd, bs, runs = weighted_scatter_inputs(name)
    one = _t(acc.copy())
    k.weighted_block_scatter_plain(one, _t(ids), _t(w), _t(bd), _t(bs),
                                   rows=_t(rows))
    got = _t(acc.copy())
    k.weighted_block_scatter_plain(got, _t(ids), _t(w), _t(bd), _t(bs),
                                   rows=_t(rows), runs=_t(runs))
    assert not torch.equal(one, got)


@pytest.mark.parametrize("name", ["overflow", "columns", "outside"])
def test_weighted_block_scatter_one_run(name):
    """runs=None is one run: the same bits as runs [0, C], as a host list
    or a CPU tensor, and as the one-step scatter of the one-run contract."""
    acc, ids, w, rows, bd, bs, runs = weighted_scatter_inputs(name)
    assert runs is None
    args = [_t(a) for a in (ids, w, bd, bs)]
    outs = []
    for r in (None, [0, ids.shape[1]],
              torch.tensor([0, ids.shape[1]], dtype=torch.int32)):
        a = _t(acc.copy())
        k.weighted_block_scatter(a, *args, rows=_t(rows), runs=r)
        outs.append(a)
    # the one-step scatter the plain version took before runs
    S, R, D = acc.shape
    T = bd.shape[1]
    ids_t = args[0].long()
    r_t = torch.zeros_like(ids_t) if rows is None else _t(rows).long()
    valid = (ids_t >= 0) & (ids_t < T) & (r_t >= 0) & (r_t < R)
    idc = ids_t.clamp(0, T - 1)
    part = torch.arange(S)[:, None]
    docs = args[2][part, idc].long()
    sc = args[3][part, idc]
    keep = valid[:, :, None] & (sc > 0) & (docs >= 0) & (docs < D)
    flat = ((part[:, :, None] * R + r_t[:, :, None]) * D + docs)[keep]
    want = _t(acc.copy()).view(-1)
    want[flat] = want[flat] + (args[1][:, :, None] * sc)[keep]
    for o in outs:
        assert torch.equal(o.view(-1).view(torch.int32),
                           want.view(torch.int32))


def test_weighted_block_scatter_checks_arguments():
    acc, ids, w, rows, bd, bs, _ = weighted_scatter_inputs("outside")
    a = _t(acc)
    with pytest.raises(TypeError):
        k.weighted_block_scatter(a, _t(ids).long(), _t(w), _t(bd), _t(bs))
    with pytest.raises(ValueError):
        k.weighted_block_scatter(a, _t(ids), _t(w[:, :-1]), _t(bd), _t(bs))
    with pytest.raises(ValueError):
        k.weighted_block_scatter(a, _t(ids), _t(w), _t(bd), _t(bs),
                                 rows=_t(rows[:, :-1]))


@pytest.mark.parametrize("bad", [
    [0, 5, 3, None], [0, 4, None, "past"], [1, None], [0, 3, 3, "short"],
    "float", "2d"])
def test_weighted_block_scatter_refuses_bad_runs(bad):
    """runs must be 1-D integers ascending from 0 to C: a descent, an end
    past C or short of it, a start past 0, floats and a 2-D table raise
    before anything is added."""
    acc, ids, w, rows, bd, bs, runs = weighted_scatter_inputs("mixed")
    C = ids.shape[1]
    if bad == "float":
        r, err = runs.astype(np.float32), TypeError
    elif bad == "2d":
        r, err = runs[None, :], TypeError
    else:
        r = [C if x is None else C + 1 if x == "past" else
             C - 1 if x == "short" else x for x in bad]
        err = ValueError
    a = _t(acc.copy())
    for fn in (k.weighted_block_scatter, k.weighted_block_scatter_plain):
        with pytest.raises(err):
            fn(a, _t(ids), _t(w), _t(bd), _t(bs), rows=_t(rows), runs=r)
    assert np.array_equal(a.numpy(), acc)
