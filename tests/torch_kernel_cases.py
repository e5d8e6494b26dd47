"""Seeded kernel inputs shared by the CPU differential tests
(test_torch_kernels.py) and the card tests (test_torch_kernels_cuda.py).
Not a test module: it imports neither jax nor the reference."""

import numpy as np

from elasticsearch_tpu_torch.parallel import kernels as k

TILE = k.TILE


def lanes_and_groups(seed, n_groups, rows_per_group, dense):
    """Posting-lane arrays and build groups like TurboBM25's: each group's
    docs are distinct and lie in its tile; the last row of a group is only
    partly filled and its padding lanes are (doc 0, score 0), as a term's
    last block row is. `dense` fills whole tiles with uniform scores, which
    exercises the quantizer's fused multiply-add rounding."""
    rng = np.random.default_rng(seed)
    n_rows = n_groups * rows_per_group
    docs = np.zeros((n_rows + k.MAX_GROUP_ROWS, 128), np.int32)
    scores = np.zeros_like(docs, dtype=np.float32)
    g_rows, g_nrows, g_base, g_slot = [], [], [], []
    for g in range(n_groups):
        tile = g % 4
        n_lanes = rows_per_group * 128 - (0 if dense else 37)
        d = np.sort(rng.permutation(TILE)[:n_lanes]) + tile * TILE
        v = rng.uniform(0.0, 2.2, size=n_lanes).astype(np.float32)
        v[rng.random(n_lanes) < 0.05] = np.float32(1e-3)   # hi = lo = 0
        r0 = g * rows_per_group
        docs[r0:r0 + rows_per_group].reshape(-1)[:n_lanes] = d
        scores[r0:r0 + rows_per_group].reshape(-1)[:n_lanes] = v
        g_rows.append(r0)
        g_nrows.append(rows_per_group)
        g_base.append(tile * TILE)
        g_slot.append(g // 4)
    # one zero group (an evicted term's tile) and one scratch-slot group
    g_rows += [0, 0]
    g_nrows += [0, 0]
    g_base += [TILE, 0]
    g_slot += [n_groups // 4 + 1, n_groups // 4 + 2]
    arr = lambda x: np.asarray(x, np.int32)   # noqa: E731
    return docs, scores, arr(g_rows), arr(g_nrows), arr(g_base), arr(g_slot)


def sweep_inputs(seed, qc, hpt, nsw):
    """Columns with few distinct values (so row maxima tie often), sparse
    query weights, one all-zero query and a live mask with holes."""
    rng = np.random.default_rng(seed)
    dpc = nsw * k.N_CHUNKS
    hi = rng.integers(0, 3, size=(dpc, hpt, 16, 128)).astype(np.int8)
    lo = rng.integers(-2, 4, size=(dpc, hpt, 16, 128)).astype(np.int8)
    hi[rng.random(hi.shape) < 0.7] = 0
    wq = np.zeros((2, qc, hpt), np.int8)
    for q in range(qc - 1):
        slots = rng.choice(hpt, size=1 + q % 3, replace=False)
        wq[0, q, slots] = rng.integers(1, 128, size=len(slots))
        wq[1, q, slots] = rng.integers(-127, 128, size=len(slots))
    qscale = rng.uniform(1e-5, 1e-3, size=(qc, 1)).astype(np.float32)
    live = (rng.random((nsw * k.SW_ROWS, 128)) > 0.1).astype(np.float32)
    return qscale, hi, lo, wq, live


SWEEP_EDGE_CASES = ("qc7", "qc24", "qc257", "qc8_nsw3", "all_slots",
                    "zero_queries", "dead_sw", "ties")


def sweep_edge_inputs(case, all_slots_hpt=700):
    """sweep_inputs at the edges of K2's group design: QC not a multiple
    of its group size (7, 24, 257), QC 8 on three superwindows, 16 queries that weight
    every one of `all_slots_hpt` slots (the integer path, long lists),
    all-zero queries (and a negative and a zero
    qscale), an all-dead superwindow, and
    rows tied on their max (one value per layer). Returns (qscale, hi, lo,
    wq, live, nsw)."""
    shapes = {"qc7": (7, 33, 2), "qc24": (24, 33, 1), "qc257": (257, 33, 1),
              "qc8_nsw3": (8, 33, 3), "all_slots": (24, all_slots_hpt, 1),
              "zero_queries": (20, 33, 2), "dead_sw": (12, 33, 2),
              "ties": (18, 12, 1)}
    qc, hpt, nsw = shapes[case]
    seed = 20 + SWEEP_EDGE_CASES.index(case)
    qscale, hi, lo, wq, live = sweep_inputs(seed, qc=qc, hpt=hpt, nsw=nsw)
    rng = np.random.default_rng(seed + 100)
    if case == "all_slots":
        wq[0, :16] = rng.integers(1, 128, size=(16, hpt))
        wq[1, :16] = rng.integers(-127, 128, size=(16, hpt))
    elif case == "zero_queries":
        wq[:, ::2] = 0
        wq[:, -3:] = 0
        qscale[1] = -qscale[1]          # the integer path's qscale <= 0
        qscale[3] = 0.0
    elif case == "dead_sw":
        live[k.SW_ROWS:] = 0.0
    elif case == "ties":
        hi[hi != 0] = 2
        lo[:] = np.where(hi != 0, 1, 0)
        qscale[:] = np.float32(1e-4)
    return qscale, hi, lo, wq, live, nsw


def plan_sweep_batches(cnt, cap):
    """sweep_rowmax.cu's batches of one group's queries (cnt[j] list
    entries): runs of consecutive queries whose lists together fit cap
    entries (cap >= every cnt). Returns [[query, ...], ...]."""
    batches, cur, used = [], [], 0
    for j, n in enumerate(cnt):
        if cur and used + n > cap:
            batches.append(cur)
            cur, used = [], 0
        cur.append(j)
        used += n
    if cur:
        batches.append(cur)
    return batches


def sweep_list(q, wh, wl, wc=None):
    """One query's list in the block, as slots: K2's nonzero score slots;
    K7's (wc: the coverage weights) score-only slots, then those with
    score and coverage weight, then the coverage-only ones, and empty for a
    query with no score weight. Returns (slots, n_score, c0): scores read
    slots[:n_score], coverage slots[c0:]."""
    sc = (wh[q] != 0) | (wl[q] != 0)
    if wc is None:
        slots = np.nonzero(sc)[0]
        return slots, len(slots), len(slots)
    if not sc.any():
        return np.zeros(0, np.int64), 0, 0
    cv = wc[q] != 0
    parts = [np.nonzero(sc & ~cv)[0], np.nonzero(sc & cv)[0],
             np.nonzero(~sc & cv)[0]]
    return (np.concatenate(parts), len(parts[0]) + len(parts[1]),
            len(parts[0]))


def emulate_sweep_group(qscale, hi, lo, wq, live, nsw, cap=None, wp=None,
                        nreq=None, mask=None):
    """numpy emulation of csrc/sweep_rowmax.cu's group block, K2's, K7's
    (wp, nreq given) or K6's (mask given), block by block: groups of
    k.SWEEP_GROUP queries, each query's list (sweep_list), batched as
    plan_sweep_batches says (cap: the kernel's list capacity unless
    given), each query's rows (the gate ANDed into live first: K7's
    coverage over the list's coverage part, cov = sum wp * ((hi | lo) !=
    0) == nreq per doc; K6's bit row % 32 of the doc's mask word; then
    _row_bits over the list's score part: the float path or the integer
    path, the row max as the bits of val), then the warp selection: each
    lane holds rows lane + 32 t, a round takes the largest value and the
    lowest row holding it. Returns (rowmax, rows) like sweep_rowmax."""
    g_size, qc, hpt = k.SWEEP_GROUP, wq.shape[1], hi.shape[1]
    if cap is None:
        cap = k.sweep_list_cap(hpt)
    rm = np.full((nsw, qc, k.CAND_PAD), -np.inf, np.float32)
    rr = np.zeros((nsw, qc, k.CAND_PAD), np.int32)
    wh, wl = wq[0].astype(np.int64), wq[1].astype(np.int64)
    wc = None if wp is None else wp.astype(np.int64)
    lanes = np.arange(32)
    for sw in range(nsw):
        alive = live[sw * k.SW_ROWS:(sw + 1) * k.SW_ROWS] > 0      # [512, 128]
        cs = slice(sw * k.N_CHUNKS, (sw + 1) * k.N_CHUNKS)
        h_sw = hi[cs].transpose(1, 0, 2, 3).reshape(hpt, k.SW_ROWS, 128)
        l_sw = lo[cs].transpose(1, 0, 2, 3).reshape(hpt, k.SW_ROWS, 128)
        for q0 in range(0, qc, g_size):
            qs_ = list(range(q0, min(qc, q0 + g_size)))
            lists = [sweep_list(q, wh, wl, wc) for q in qs_]
            batches = plan_sweep_batches([len(x[0]) for x in lists], cap)
            assert sorted(j for b in batches for j in b) == list(
                range(len(qs_)))
            for j in (j for b in batches for j in b if len(lists[j][0])):
                q = qs_[j]
                slots, n_score, c0 = lists[j]
                gate = alive
                if mask is not None:
                    words = mask[q, sw * k.SW_WORD_ROWS:
                                 (sw + 1) * k.SW_WORD_ROWS].view(np.uint32)
                    bit = np.arange(k.SW_ROWS) % 32
                    gate = alive & (((words[np.arange(k.SW_ROWS) // 32]
                                      >> bit[:, None].astype(np.uint32))
                                     & 1) != 0)
                if wc is not None:
                    cov_s = slots[c0:]
                    present = (h_sw[cov_s] != 0) | (l_sw[cov_s] != 0)
                    cov = np.tensordot(wc[q][cov_s], present.astype(np.int64),
                                       1)
                    gate = alive & (cov == int(nreq[q, 0]))
                rb = _row_bits(q, slots[:n_score], wh, wl, h_sw, l_sw, gate,
                               qscale[q, 0])
                v = rb.reshape(k.SW_ROWS // 32, 32).copy()       # [t, lane]
                for p in range(k.NCAND):
                    bt = v.argmax(axis=0)               # first t among ties
                    best = v[bt, lanes]
                    m = best.max()
                    if m == 0:
                        break
                    c = np.where(best == m, k.SW_ROWS - (lanes + 32 * bt), 0)
                    row = k.SW_ROWS - int(c.max())
                    rm[sw, q, p] = np.uint32(m).view(np.float32)
                    rr[sw, q, p] = row + sw * k.SW_ROWS
                    v[row >> 5, row & 31] = 0
    return rm, rr


def _row_bits(q, slots, wh, wl, h_sw, l_sw, alive, qs):
    """One query's 512 row maxima in one superwindow, as bits (0: none),
    on the kernel's float path where its weights allow it (Y = 16384 hh +
    128 (hl + lh) and ll summed exactly in f32, the bytes of docs that
    `alive` (live, and K7's gate) drops masked to 0, the max pre-scale
    value multiplied once) and on its integer path else."""
    f = np.float32
    a, b = wh[q][slots] * 1.0, wl[q][slots] * 1.0
    h = h_sw[slots].astype(np.float64)
    lw = l_sw[slots].astype(np.float64)
    fast = 16512 * np.abs(a).sum() + 128 * np.abs(b).sum() < 2 ** 24 \
        and qs > 0
    if fast:
        # dead docs' bytes are masked to 0 (pre 0, never counted); every
        # partial sum is exact in f32 (what the fmas rely on)
        h, lw = h * alive, lw * alive
        y = np.tensordot(16384 * a + 128 * b, h, 1) \
            + np.tensordot(128 * a, lw, 1)
        z = np.tensordot(b, lw, 1)
        assert np.abs(y).max() < 2 ** 31 and np.abs(z).max() < 2 ** 24
        pre = (y.astype(f) + z.astype(f)).astype(f)
        m = np.maximum(pre.max(axis=1), f(0))
        best = np.where(m > 0, m.view(np.uint32), np.uint32(0))
        val = (best.view(f) * qs).astype(f)
        return np.where((best != 0) & (val > 0), val.view(np.uint32),
                        np.uint32(0))

    # float64 sums are exact here; int32 wraps as the kernel's
    def s32(x):
        return x.astype(np.int64).astype(np.int32)

    hh = s32(np.tensordot(a, h, 1))
    hl = s32(np.tensordot(a, lw, 1))
    lh = s32(np.tensordot(b, h, 1))
    ll = s32(np.tensordot(b, lw, 1))
    v = (f(16384.0) * hh.astype(f) + f(128.0) * (hl + lh).astype(f))
    v = ((v + ll.astype(f)) * qs).astype(f)
    bits = np.where(alive & (v > 0), v.view(np.uint32), np.uint32(0))
    return bits.max(axis=1)


def sparse_inputs(seed, n_terms, n_tiles):
    """A granule pool of cold-term slices (distinct sorted docs per term,
    uint8 impacts, zero padding lanes) and a dispatch over them in the
    reference's layout, with overlapping docs across terms and padding
    chunks."""
    rng = np.random.default_rng(seed)
    grans = [np.zeros((8, 128), np.int32)]            # granule 0: zeros
    coff, cw, ct0, ct1 = [], [], [], []
    for t in range(n_terms):
        df = int(rng.integers(50, 2500))
        docs = np.sort(rng.choice(n_tiles * TILE, size=df, replace=False))
        imp = rng.integers(1, 256, size=df)
        w = np.float32(rng.uniform(0.01, 0.2))
        n_g = -(-df // k.SPARSE_GRAN)
        buf = np.zeros(n_g * k.SPARSE_GRAN, np.int64)
        buf[:df] = (docs.astype(np.int64) << 8) | imp
        for j in range(n_g):
            coff.append(len(grans))
            grans.append(buf[j * 1024:(j + 1) * 1024].astype(np.int32)
                         .reshape(8, 128))
            cw.append(w)
            e = min((j + 1) * 1024, df)
            ct0.append(int(docs[j * 1024]) // TILE)
            ct1.append(int(docs[e - 1]) // TILE)
    pad = 16 - len(coff)
    coff += [0] * pad
    cw += [0.0] * pad
    ct0 += [1] * pad
    ct1 += [0] * pad
    return (np.asarray(coff, np.int32), np.asarray(cw, np.float32),
            np.asarray(ct0, np.int32), np.asarray(ct1, np.int32),
            np.stack(grans))


class _SlicePool:
    """Granules of cold-term slices packed as TurboBM25._ensure_sparse
    packs them (sorted distinct docs, then zero lanes) and their chunks."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.grans = [np.zeros((8, 128), np.int32)]    # granule 0: zeros
        self.chunks = []                                # per term

    def term(self, docs):
        docs = np.unique(np.asarray(docs, np.int64))
        imp = self.rng.integers(1, 256, size=len(docs))
        buf = np.zeros(-(-len(docs) // k.SPARSE_GRAN) * k.SPARSE_GRAN,
                       np.int64)
        buf[:len(docs)] = (docs << 8) | imp
        ch = []
        for j in range(len(buf) // k.SPARSE_GRAN):
            e = min((j + 1) * k.SPARSE_GRAN, len(docs))
            ch.append((len(self.grans), int(docs[j * k.SPARSE_GRAN]) // TILE,
                       int(docs[e - 1]) // TILE))
            self.grans.append(buf[j * k.SPARSE_GRAN:(j + 1) * k.SPARSE_GRAN]
                              .astype(np.int32).reshape(8, 128))
        self.chunks.append(ch)
        return len(self.chunks) - 1

    def query(self, terms, pad=0):
        """[(coff, cw, ct0, ct1)] of a query's (term, weight) list, plus
        `pad` padding chunks (granule 0, weight 0, range (1, 0))."""
        rows = []
        for t, w in terms:
            rows += [(g, np.float32(w), a, b) for g, a, b in self.chunks[t]]
        return rows + [(0, np.float32(0.0), 1, 0)] * pad


SPARSE_BATCH_CASES = ("shared_docs", "boundary_same_doc",
                      "tiles_meet_no_shared_doc", "narrow_tile_range",
                      "past_n_tiles", "empty_query_middle", "duplicate_term",
                      "q1", "empty_batch")


def sparse_batch_inputs(case, seed=0):
    """A batched K3 dispatch: (coff, cw, ct0, ct1, qoff, pool, n_tiles).

    shared_docs: three terms drawn from one doc set, in two queries;
    boundary_same_doc: two terms whose first chunks both end at the same
        doc and whose second chunks both start at the same doc;
    tiles_meet_no_shared_doc: even docs against odd docs in the same tiles;
    narrow_tile_range: chunks whose [ct0, ct1] is narrower than their docs;
    past_n_tiles: docs at and past the grid's last tile;
    empty_query_middle: an empty query between two, padding chunks too;
    duplicate_term: one term twice in a query (its chunks dispatched twice);
    q1: one query, padded as the serving path padded per query;
    empty_batch: no query at all."""
    sp = _SlicePool(seed)
    rng = sp.rng
    n_tiles = 4
    w = lambda: float(np.float32(rng.uniform(0.01, 0.2)))   # noqa: E731
    span = n_tiles * TILE
    queries = []
    if case in ("shared_docs", "narrow_tile_range", "empty_query_middle",
                "duplicate_term", "q1"):
        base = rng.choice(span, size=3000, replace=False)
        a, b, c = (sp.term(base[rng.random(3000) < 0.7]) for _ in range(3))
        if case == "shared_docs":
            queries = [sp.query([(a, w()), (b, w()), (c, w())]),
                       sp.query([(c, w()), (a, w())])]
        elif case == "narrow_tile_range":
            q = sp.query([(a, w()), (b, w()), (c, w())])
            na, nb = len(sp.chunks[a]), len(sp.chunks[b])
            for i in (0, na):         # first chunk of a and of b
                g, cw, t0, t1 = q[i]
                q[i] = (g, cw, t0 + 1, t1) if t0 < t1 else (g, cw, t0, t1 - 1)
            g, cw, t0, t1 = q[na + nb]      # first chunk of c
            q[na + nb] = (g, cw, t0, max(t0, t1 - 1))
            queries = [q, sp.query([(b, w()), (a, w())])]
        elif case == "empty_query_middle":
            queries = [sp.query([(a, w()), (b, w())]), [],
                       sp.query([(c, w())], pad=3), [],
                       sp.query([(b, w()), (c, w())])]
        elif case == "duplicate_term":
            wa = w()
            queries = [sp.query([(a, wa), (a, wa), (b, w())]),
                       sp.query([(c, w()), (c, w())])]
        else:
            queries = [sp.query([(a, w()), (b, w()), (c, w())], pad=7)]
    elif case == "boundary_same_doc":
        x, y = 20000, 20001
        lo = np.arange(0, x)
        hi = np.arange(y + 1, 3 * TILE)
        da = np.concatenate([rng.choice(lo, 1023, replace=False), [x, y],
                             rng.choice(hi, 1100, replace=False)])
        db = np.concatenate([rng.choice(lo, 1023, replace=False), [x, y],
                             rng.choice(hi, 600, replace=False)])
        a, b = sp.term(da), sp.term(db)
        queries = [sp.query([(a, w()), (b, w())]),
                   sp.query([(b, w()), (a, w())])]
    elif case == "tiles_meet_no_shared_doc":
        ev = np.arange(TILE, 3 * TILE, 2)
        a = sp.term(rng.choice(ev, 1800, replace=False))
        b = sp.term(rng.choice(ev + 1, 1500, replace=False))
        queries = [sp.query([(a, w()), (b, w())])]
    elif case == "past_n_tiles":
        n_tiles = 3
        a = sp.term(rng.choice(4 * TILE, 2500, replace=False))
        b = sp.term(rng.choice(np.arange(2 * TILE, 4 * TILE), 1500,
                               replace=False))
        queries = [sp.query([(a, w()), (b, w())])]
    elif case != "empty_batch":
        raise ValueError(case)
    rows = [r for q in queries for r in q]
    qoff = np.cumsum([0] + [len(q) for q in queries]).astype(np.int32)
    col = lambda i, dt: np.asarray([r[i] for r in rows], dt)   # noqa: E731
    return (col(0, np.int32), col(1, np.float32), col(2, np.int32),
            col(3, np.int32), qoff, np.stack(sp.grans), n_tiles)


def emulate_sparse_gather(coff, cw, ct0, ct1, qoff, pool, n_tiles):
    """numpy emulation of csrc/sparse_gather.cu, lane by lane: the same
    block doc range, candidate staging in rc order, per-lane walk, ten-step
    binary search and f32 multiply-then-add order. Returns [n_rc, 8, 128]
    f32."""
    gran = k.SPARSE_GRAN
    threads = 256
    imax = np.iinfo(np.int32).max
    n_rc = len(coff)
    n_gran = pool.shape[0]
    flat = pool.reshape(n_gran, gran).view(np.uint32)
    out = np.zeros((n_rc, gran), np.float32)
    if qoff is None:
        qoff = np.asarray([0, n_rc], np.int32)

    def key(v):
        return int(v >> 8) if v & 255 else imax

    for c in range(n_rc):
        q = int(np.searchsorted(qoff[1:], c, side="right"))
        q0, q1 = int(qoff[q]), int(qoff[q + 1])
        g = int(coff[c])
        for part in range(gran // threads):
            lanes = np.zeros(threads, np.uint32)
            if 0 <= g < n_gran:
                lanes = flat[g, part * threads:(part + 1) * threads]
            docs = (lanes >> 8).astype(np.int64)
            tiles = docs >> 14
            live = ((lanes & 255) > 0) & (tiles >= ct0[c]) \
                & (tiles <= ct1[c]) & (tiles < n_tiles)
            if not live.any():
                continue
            blo, bhi = int(docs[live].min()), int(docs[live].max())
            btlo, bthi = blo >> 14, bhi >> 14
            cand = []
            for i in range(q0, q1):
                gg, a, b = int(coff[i]), int(ct0[i]), int(ct1[i])
                if not (0 <= gg < n_gran and a <= bthi and b >= btlo
                        and a <= b):
                    continue
                d0 = key(flat[gg, 0])
                last = flat[gg, gran - 1]
                d1 = int(last >> 8) if last & 255 else imax - 1
                if d0 <= bhi and d1 >= blo:
                    cand.append((gg, np.float32(cw[i]), a, b, d0, d1))
            for t in np.nonzero(live)[0]:
                d, tile = int(docs[t]), int(tiles[t])
                acc = np.float32(0.0)
                for gg, w, a, b, d0, d1 in cand:
                    if not (a <= tile <= b and d0 <= d <= d1):
                        continue
                    p, hv, s = 0, flat[gg, 0], gran // 2
                    while s >= 1:
                        x = flat[gg, p + s]
                        if key(x) <= d:
                            p, hv = p + s, x
                        s //= 2
                    if key(hv) == d:
                        acc = np.float32(acc + np.float32(
                            np.float32(hv & 255) * w))
                out[c, part * threads + t] = acc
    return out.reshape(n_rc, 8, 128)


def sparse_group(seed, n_queries, n_tiles=6):
    """A serving-sized group: n_queries queries of one to three terms of
    varied df over one shared pool, as a batch's cold sides (one empty)."""
    sp = _SlicePool(seed)
    rng = sp.rng
    terms = [sp.term(rng.choice(n_tiles * TILE, int(df), replace=False))
             for df in rng.integers(20, 5000, size=48)]
    queries = []
    for q in range(n_queries):
        if q == n_queries // 2:
            queries.append([])
            continue
        pick = rng.choice(len(terms), size=1 + q % 3, replace=False)
        queries.append(sp.query([(int(t), float(np.float32(
            rng.uniform(0.01, 2.0)))) for t in pick]))
    rows = [r for q in queries for r in q]
    qoff = np.cumsum([0] + [len(q) for q in queries]).astype(np.int32)
    col = lambda i, dt: np.asarray([r[i] for r in rows], dt)   # noqa: E731
    return (col(0, np.int32), col(1, np.float32), col(2, np.int32),
            col(3, np.int32), qoff, np.stack(sp.grans), n_tiles)


def conj_inputs(seed, qc, hpt, nsw):
    """sweep_inputs with sparser presence and coverage weights as
    TurboBM25._bool_weights makes them: +1 on required slots (scored or
    not), -(n_req + 1) on must_not slots. The last two rows have n_req = 0
    (one with score weights, one all zero)."""
    qscale, hi, lo, wq, live = sweep_inputs(seed, qc, hpt, nsw)
    rng = np.random.default_rng(seed + 1)
    absent = rng.random(hi.shape) < 0.5
    hi[absent] = 0
    lo[absent] = 0
    wp = np.zeros((qc, hpt), np.int8)
    nreq = np.zeros((qc, 1), np.int32)
    for q in range(qc - 2):
        scored = np.nonzero(wq[:, q].any(axis=0))[0]
        req = set(scored[: 1 + q % 2].tolist())
        req.update(rng.choice(hpt, size=q % 3, replace=False).tolist())
        neg = [s for s in rng.choice(hpt, size=1 + q % 2, replace=False)
               if s not in req]
        wp[q, sorted(req)] = 1
        wp[q, neg] = -(len(req) + 1)
        nreq[q, 0] = len(req)
    return qscale, nreq, hi, lo, wq, wp, live


CONJ_EDGE_CASES = ("filters", "must_not_top", "nreq0", "int_path", "qc7",
                   "qc257", "padding", "all_slots", "ties")


def conj_edge_inputs(case, all_slots_hpt=700):
    """conj_inputs at the edges of K7's group block: required slots with no
    score weight (filters: coverage-only list entries), a must_not slot
    present in every doc of each query's disjunctive top row of the first
    superwindow, nreq = 0 everywhere, weights outside the float path's
    range (the integer path, and a qscale <= 0), QC 7 and 257 (not a
    multiple of the group), 128 padding queries of 256 (the engine's
    chunk), 16 queries where every one of `all_slots_hpt` slots carries
    wp or wq (lists past the list capacity), and rows tied on their max.
    Returns (qscale, nreq, hi, lo, wq, wp, live, nsw)."""
    shapes = {"filters": (20, 33, 2), "must_not_top": (12, 33, 1),
              "nreq0": (12, 33, 2), "int_path": (18, 60, 1),
              "qc7": (7, 33, 2), "qc257": (257, 33, 1),
              "padding": (256, 33, 1), "all_slots": (24, all_slots_hpt, 1),
              "ties": (18, 12, 1)}
    qc, hpt, nsw = shapes[case]
    seed = 40 + CONJ_EDGE_CASES.index(case)
    qscale, nreq, hi, lo, wq, wp, live = conj_inputs(seed, qc=qc, hpt=hpt,
                                                     nsw=nsw)
    rng = np.random.default_rng(seed + 100)
    if case == "filters":
        for q in range(qc - 2):
            # two extra required slots that carry no score weight
            free = np.nonzero(~wq[:, q].any(axis=0) & (wp[q] == 0))[0]
            extra = rng.choice(free, size=2, replace=False)
            wp[q, wp[q] < 0] -= 2
            wp[q, extra] = 1
            nreq[q, 0] += 2
            # a dense filter column, so some docs pass
            for s in extra:
                hi[:, s] = np.where(rng.random(hi[:, s].shape) < 0.8, 1, 0)
        wq[:, ::5] = 0                 # queries with filters only
    elif case == "must_not_top":
        wp[:] = 0
        nreq[:] = 0
        disj = _disjunctive_top_rows(qscale, hi, lo, wq, live)
        for q in range(qc):
            free = np.nonzero(~wq[:, q].any(axis=0))[0]
            s = free[q % len(free)]
            wp[q, s] = -1
            r = disj[q]
            c, rr_ = r // k.CHUNK_ROWS, r % k.CHUNK_ROWS
            hi[c, s, rr_] = 1          # present in every doc of the top row
    elif case == "nreq0":
        wp[wp > 0] = 0
        wp[wp < 0] = -1
        nreq[:] = 0
    elif case == "int_path":
        for q in range(0, qc - 2, 2):
            slots = rng.choice(hpt, size=30, replace=False)
            wq[0, q, slots] = rng.integers(100, 128, size=30)
            wq[1, q, slots] = rng.integers(-127, 128, size=30)
            wp[q, slots[:2]] = 1
            wp[q, wp[q] < 0] = 0
            nreq[q, 0] = int((wp[q] > 0).sum())
        qscale[1] = -qscale[1]
        qscale[3] = 0.0
    elif case == "padding":
        wq[:, 128:] = 0
        wp[128:] = 0
        nreq[128:] = 0
        qscale[128:] = 1.0
    elif case == "all_slots":
        wq[0, :16] = rng.integers(1, 128, size=(16, hpt))
        wq[1, :16] = rng.integers(-127, 128, size=(16, hpt))
        # queries 8-15 on the float path: small weights
        wq[0, 8:16] = rng.integers(1, 3, size=(8, hpt))
        wq[1, 8:16] = rng.integers(-1, 2, size=(8, hpt))
        off = rng.random((16, hpt)) < 0.5      # half coverage-only
        wq[:, :16][:, off] = 0
        wq[0, :16, 0] = 5                      # each keeps a score weight
        wp[:16] = 0
        wp[:16][off] = 1
        wp[:16, 1] = -1
        nreq[:16, 0] = (wp[:16] > 0).sum(axis=1)
        hi[:, :] = np.where(hi != 0, hi, 1)    # every slot present
        hi[:, 1] = 0
        lo[:, 1] = 0
        hi[0, 1, 0, :64] = 1                   # the must_not in 64 docs
    elif case == "ties":
        hi[hi != 0] = 2
        lo[:] = np.where(hi != 0, 1, 0)
        qscale[:] = np.float32(1e-4)
    return qscale, nreq, hi, lo, wq, wp, live, nsw


def _disjunctive_top_rows(qscale, hi, lo, wq, live):
    """Each query's top row of superwindow 0 under the disjunctive sweep
    (the plain K2 on the CPU)."""
    import torch

    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (qscale, hi, lo, wq, live)]
    _, rows = k.sweep_rowmax_plain(*t, nsw=1)
    return rows[0, :, 0].numpy()


def bitset_edge_inputs(case, all_slots_hpt=700):
    """K2's edge cases (sweep_edge_inputs) with mask_inputs' masks: K6's
    group block at QC 7, 24 and 257, QC 8 on three superwindows, a group
    weighting every slot (the integer path, long lists), all-zero queries,
    a dead superwindow and tied rows; in each, query 0's first
    superwindow is masked out, the last query's mask is all zero and
    chunks have an empty 16-bit half. Returns (qscale, hi, lo, wq, mask,
    live, nsw)."""
    qscale, hi, lo, wq, live, nsw = sweep_edge_inputs(case, all_slots_hpt)
    mask = mask_inputs(60 + SWEEP_EDGE_CASES.index(case), wq.shape[1], nsw)
    return qscale, hi, lo, wq, mask, live, nsw


def mask_inputs(seed, qc, nsw):
    """Random intersected masks [QC, nsw * 16, 128] i32 (about a quarter of
    the bits set) with zeroed 16-bit halves (chunks that skip), one query
    whose first superwindow is empty and one with an all-zero mask."""
    rng = np.random.default_rng(seed)
    shape = (qc, nsw * k.SW_WORD_ROWS, 128)
    a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    mask = (a & b).astype(np.uint32).view(np.int32)
    g = rng.random(shape[:2]) < 0.3
    mask[g] &= np.int32(-65536)                  # chunk 2g empty
    g = rng.random(shape[:2]) < 0.3
    mask[g] &= np.int32(0xFFFF)                  # chunk 2g + 1 empty
    mask[0, : k.SW_WORD_ROWS] = 0
    mask[-1] = 0
    return mask


def bitset_inputs(seed, n_slots, nsw):
    """Packed bitsets [n_slots + 2, nsw * 16, 128] i32 with the zero and
    ones sentinels in the last two slots, as pack_presence_bits makes
    them."""
    rng = np.random.default_rng(seed)
    shape = (n_slots + 2, nsw * k.SW_WORD_ROWS, 128)
    a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    bits = (a | b).astype(np.uint32).view(np.int32)    # 3/4 of bits set
    bits[rng.random(shape[:2]) < 0.2] = 0                  # empty blocks
    bits[n_slots] = 0
    bits[n_slots + 1] = -1
    return bits


def clause_slots(seed, qc, n_slots):
    """(q_slots [QC, 8], q_neg [QC, 4]) i32 as TurboBM25._bitset_prefetch
    pads them, plus edge rows: an inactive row (zero sentinel), a row with
    no required clause (ones sentinel), 8 distinct clauses, a must_not that
    repeats a clause, and the ones sentinel as a must_not."""
    rng = np.random.default_rng(seed)
    zero_s, ones_s = n_slots, n_slots + 1
    q_slots = np.full((qc, k.BITSET_CLAUSES), zero_s, np.int32)
    q_neg = np.full((qc, k.BITSET_NEGS), zero_s, np.int32)
    for q in range(1, qc):
        n_req = [0, 8, 1][q - 1] if q <= 3 else 1 + q % 4
        req = rng.choice(n_slots, size=n_req, replace=False)
        if n_req:
            q_slots[q] = [req[j] if j < n_req else req[0]
                          for j in range(k.BITSET_CLAUSES)]
        else:
            q_slots[q] = ones_s
        neg = rng.choice(n_slots, size=q % 5, replace=False)
        q_neg[q, : len(neg)] = neg
    q_neg[4, 0] = q_slots[4, 0]
    q_neg[5, 1] = ones_s
    return q_slots, q_neg


def knn_inputs(seed, qc, nw, dims, masked=False, n_parts=1, pad=128,
               dups=False):
    """K9 inputs as KnnEngine makes them, doc-major q8 [P, nw, KNN_W,
    dimsP]: queries and rows quantized per row to int8 with their meta,
    plus dead rows (okf 0), a window with no live row, windows the IVF
    probe left inactive for some queries, exact ties (copies of one row at
    several positions, across windows too) and, if masked, a filter with
    about half the docs set. dims is zero-padded to a multiple of `pad`;
    `dups` makes every row a copy of one of 3 rows (ties far beyond the
    32 kept, more than K9's candidate list holds). Leading partition axes are dropped when n_parts == 1."""
    rng = np.random.default_rng(seed)
    W = k.KNN_W
    dims_p = -(-dims // pad) * pad
    n = nw * W
    v = rng.standard_normal((n_parts, n, dims)).astype(np.float32)
    for p in range(n_parts):
        v[p, 1::97] = v[p, 5]                         # exact ties
        v[p, W + 3:: W] = v[p, 5]                     # across windows
        if dups:
            v[p] = v[p, rng.integers(0, 3, size=n)]
    s_r = np.maximum(np.abs(v).max(axis=2), 1e-12) / 127.0
    v8 = np.clip(np.round(v / s_r[..., None]), -127, 127).astype(np.int8)
    q8 = np.zeros((n_parts, n, dims_p), np.int8)
    q8[..., :dims] = v8
    meta = np.zeros((n_parts, 4, n), np.float32)
    meta[:, 0] = s_r
    meta[:, 1] = s_r * np.abs(v8.astype(np.float32)).sum(axis=2)
    meta[:, 2] = np.linalg.norm(v, axis=2)
    meta[:, 3] = rng.random((n_parts, n)) > 0.1      # dead rows
    meta[:, 3, n - W:] = 0                           # a window with none live
    q = rng.standard_normal((qc, dims)).astype(np.float32)
    sq = np.maximum(np.abs(q).max(axis=1), 1e-12) / 127.0
    qi8 = np.zeros((qc, dims_p), np.int8)
    qi8[:, :dims] = np.clip(np.round(q / sq[:, None]), -127, 127)
    ql1 = sq * np.abs(qi8.astype(np.float32)).sum(axis=1)
    qn = np.linalg.norm(q, axis=1)
    qmeta = np.zeros((qc, 8), np.float32)
    qmeta[:, 0] = sq
    qmeta[:, 1] = 0.5 * ql1 + dims * sq / 4.0
    qmeta[:, 2] = qn
    qmeta[:, 3] = qn * qn
    qmeta[:, 4] = 1.0 / np.maximum(qn, 1e-20)
    qmeta[:, 5] = 0.5 * sq
    act = (rng.random((n_parts, qc, nw)) > 0.2).astype(np.float32)
    act[:, 0] = 1.0
    fmask = None
    if masked:
        fmask = (rng.random((n_parts, qc, nw, W)) > 0.5).astype(np.int8)
    out = [qi8, qmeta, q8.reshape(n_parts, nw, W, dims_p),
           meta.reshape(n_parts, 4, nw, W), act, fmask]
    if n_parts == 1:
        out = out[:2] + [None if a is None else a[0] for a in out[2:]]
    return tuple(out)


def merge_inputs(seed, q, n_parts, kk):
    """K4 inputs [Q, S*k] as KnnEngine lays its per-partition top-k
    partition-major: descending scores from a few distinct values (ties
    within and across partitions), distinct ords per partition, the same
    ord in several partitions, empty slots (0 or negative) at the end, and a
    last query whose lanes are all empty."""
    rng = np.random.default_rng(seed)
    vals = np.float32([0.9, 0.75, 0.75, 0.6, 0.5, 0.31])
    s = np.zeros((q, n_parts, kk), np.float32)
    o = np.zeros((q, n_parts, kk), np.int32)
    for qi in range(q):
        for p in range(n_parts):
            m = int(rng.integers(0, kk + 1))
            s[qi, p, :m] = -np.sort(-rng.choice(vals, size=m))
            o[qi, p, :m] = rng.choice(max(40, 2 * kk), size=m, replace=False)
            if m < kk and rng.random() < 0.3:
                s[qi, p, m] = -0.25
    s[-1] = 0                                        # a query with no hit
    return s.reshape(q, n_parts * kk), o.reshape(q, n_parts * kk)


def agg_section(rng, n_docs, n_segments, n_pairs, *, grouped=True, oob=0,
                pad_chunks=0, head=0.0):
    """One K8 blob section [doc(p) | seg(p) | ct0 | ct1] as agg_device's
    _pack_pairs packs it: pairs grouped by bucket (terms layouts) or in
    doc order (histogram ranks), the last chunk padded with (doc 0, bucket
    -1) and `pad_chunks` whole pad chunks carrying the range (1, 0).
    `head` gives that share of the pairs to bucket 0 (a hot Zipf term);
    `oob` pairs get buckets at or past n_segments, some past the last
    tile."""
    gran, tile = k.AGG_PAIR_GRAN, k.AGG_SEG_TILE
    n_tiles = -(-n_segments // tile)
    docs = rng.integers(0, n_docs, size=n_pairs)
    segs = rng.integers(0, n_segments, size=n_pairs)
    segs[rng.random(n_pairs) < head] = 0
    if oob:
        at = rng.choice(n_pairs, size=oob, replace=False)
        segs[at] = rng.choice([n_segments, n_segments + 7,
                               n_tiles * tile - 1, n_tiles * tile + 5,
                               1 << 20], size=oob)
    order = np.lexsort((docs, segs)) if grouped else np.argsort(
        docs, kind="stable")
    docs, segs = docs[order], segs[order]
    p = (-(-n_pairs // gran) + pad_chunks) * gran
    d = np.zeros(p, np.int32)
    s = np.full(p, -1, np.int32)
    d[:n_pairs] = docs
    s[:n_pairs] = segs
    nc = p // gran
    ct0 = np.ones(nc, np.int32)
    ct1 = np.zeros(nc, np.int32)
    for c in range(nc):
        live = s[c * gran:(c + 1) * gran]
        live = live[live >= 0]
        if len(live):
            ct0[c] = int(live.min()) // tile
            ct1[c] = int(live.max()) // tile
    return d, s, ct0, ct1


def perturb_ranges(section, n_tiles):
    """Tile ranges that disagree with the pairs: a live chunk skipped
    (1, 0), a range cut to its first tile, one wider than the grid, and
    one that holds none of its chunk's tiles."""
    d, s, ct0, ct1 = (a.copy() for a in section)
    ct0[0], ct1[0] = 1, 0
    ct1[1] = ct0[1]
    ct0[2], ct1[2] = -3, n_tiles + 4
    ct0[3] = ct1[3] = ct1[3] + 1
    return d, s, ct0, ct1


def agg_masks(rng, q, n_docs, live_rows=None, density=0.3):
    """[q, n_docs] bool query masks; rows from `live_rows` on are all
    False, as agg_device pads a batch up to its rung."""
    m = rng.random((q, n_docs)) < density
    if live_rows is not None:
        m[live_rows:] = False
    return m


AGG_CASES = {
    # name: (seed, Q, live rows, n_docs, n_segments, sections)
    "pads": (0, 3, None, 5000, 40, [dict(n_pairs=2900, pad_chunks=2)]),
    "buckets_past_n_segments": (1, 2, None, 6000, 20000,
                                [dict(n_pairs=5000, oob=300)]),
    "unsorted_3_tiles": (2, 2, None, 8000, 40000,
                         [dict(n_pairs=6000, grouped=False)]),
    "inconsistent_ranges": (3, 2, None, 8000, 40000,
                            [dict(n_pairs=6000, grouped=False)]),
    "q_padded_to_rung": (4, 4, 1, 3000, 300,
                         [dict(n_pairs=4000, head=0.2)]),
    "two_level": (5, 2, None, 4000, 64,
                  [dict(n_pairs=3500, head=0.2),
                   dict(n_pairs=2600, pad_chunks=1)]),
}


def agg_inputs(name):
    """(mask [Q, n_docs] bool, blob i32, section pair counts, n_segments)
    of one AGG_CASES case."""
    seed, q, live, n_docs, n_seg, secs = AGG_CASES[name]
    rng = np.random.default_rng(seed)
    parts, ps = [], []
    for kw in secs:
        sec = agg_section(rng, n_docs, n_seg, **kw)
        if name == "inconsistent_ranges":
            sec = perturb_ranges(sec, -(-n_seg // k.AGG_SEG_TILE))
        parts += list(sec)
        ps.append(len(sec[0]))
    return agg_masks(rng, q, n_docs, live), np.concatenate(parts), ps, n_seg


# ---------------------------------------------------------------------------
# numpy models of the K8 and K4 designs (csrc/agg_counts.cu, merge_topk.cu)
# ---------------------------------------------------------------------------

AGG_HIST_BINS = 57344     # agg_counts.cu's HIST_BINS
AGG_PLANES = 8            # its carry-save planes (a run flushes at 255)
AGG_PPL = 4               # its pairs a lane takes a step, 32 apart


def byte_perm(x, y, s):
    """CUDA's __byte_perm(x, y, s) on Python ints."""
    b = [(x >> (8 * i)) & 255 for i in range(4)] + \
        [(y >> (8 * i)) & 255 for i in range(4)]
    return sum(b[(s >> (4 * n)) & 7] << (8 * n) for n in range(4))


def emulate_agg_bits(row):
    """agg_counts.cu's pack_bits_kernel (Q = 1): bit j of word w is
    row[32w + j], each nibble from four bool bytes as
    ((x & 0x01010101) * 0x01020408) >> 24."""
    n = len(row)
    m = np.zeros(-(-n // 32) * 32, np.uint8)
    m[:n] = row
    words = np.zeros(len(m) // 32, np.int64)
    for w in range(len(words)):
        word = 0
        for i in range(8):
            x = int.from_bytes(m[32 * w + 4 * i:32 * w + 4 * i + 4].tobytes(),
                               "little")
            word |= ((((x & 0x01010101) * 0x01020408) & 0xFFFFFFFF) >> 24) \
                << (4 * i)
        words[w] = word
    return words


def emulate_agg_pack(mask):
    """agg_counts.cu's pack_kernel, 4 docs at a time: [groups, n_pad] words
    (Python ints) with bit q of words[g][d] = mask[32g + q, d], built with
    the kernel's byte arithmetic and permutes."""
    q, n_docs = mask.shape
    qw = 8 if q <= 8 else 16 if q <= 16 else 32
    n_pad = -(-n_docs // 4) * 4
    groups = -(-q // 32)
    m = np.zeros((q, n_pad), np.uint8)
    m[:, :n_docs] = mask
    words = np.zeros((groups, n_pad), np.int64)
    for g in range(groups):
        qg = min(qw, q - 32 * g)
        for d4 in range(0, n_pad, 4):
            acc = [0] * (qw // 8)
            for j in range(qg):
                x = int.from_bytes(m[32 * g + j, d4:d4 + 4].tobytes(),
                                   "little")
                acc[j >> 3] |= (x & 0x01010101) << (j & 7)
            if qw == 8:
                out = [(acc[0] >> (8 * i)) & 255 for i in range(4)]
            elif qw == 16:
                lo = byte_perm(acc[0], acc[1], 0x5140)
                hi = byte_perm(acc[0], acc[1], 0x7362)
                out = [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]
            else:
                t0 = byte_perm(acc[0], acc[1], 0x5140)
                t1 = byte_perm(acc[0], acc[1], 0x7362)
                t2 = byte_perm(acc[2], acc[3], 0x5140)
                t3 = byte_perm(acc[2], acc[3], 0x7362)
                out = [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
                       byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]
            words[g, d4:d4 + 4] = out
    return words


def _emulate_count_part(words, n_docs, doc, seg, ct0, ct1, lo, hi, b0, wlen,
                        qg, hist, threads):
    """count_part of agg_counts.cu: each lane takes AGG_PPL pairs a step,
    32 apart (a warp's 32 * AGG_PPL consecutive pairs), and keeps one
    run (bucket, count or carry-save planes) in registers."""
    one = qg == 0                              # the Q = 1 doc-bit path
    tlo, thi = b0 >> 14, (b0 + wlen - 1) >> 14
    run_max = 0xFFFFFFFF if one else (1 << AGG_PLANES) - 1
    for warp in range(threads // 32):
        for lane in range(32):
            st = {"b": -1, "n": 0, "seen": 0, "pl": [0] * AGG_PLANES}

            def flush():
                if st["n"] == 0:
                    return
                rel = st["b"] - b0
                if one:
                    hist[0, rel] += st["n"]
                else:
                    m = st["seen"]
                    while m:
                        q = (m & -m).bit_length() - 1
                        m &= m - 1
                        hist[q, rel] += sum(((st["pl"][i] >> q) & 1) << i
                                            for i in range(AGG_PLANES))
                    st["pl"] = [0] * AGG_PLANES
                    st["seen"] = 0
                st["n"] = 0

            base = lo * 1024 + warp * 32 * AGG_PPL + lane
            while base < hi * 1024:
                c = base // 1024
                t0, t1 = int(ct0[c]), int(ct1[c])
                if max(t0, tlo) <= min(t1, thi):
                    for j in range(AGG_PPL):
                        at = base + 32 * j
                        d, g = int(doc[at]), int(seg[at])
                        t = g >> 14
                        ok = (0 <= g - b0 < wlen and t0 <= t <= t1
                              and 0 <= d < n_docs)
                        if not ok:
                            w = 0
                        elif one:           # doc bits, 32 docs a word
                            w = (int(words[d >> 5]) >> (d & 31)) & 1
                        else:
                            w = int(words[d])
                        if not w:
                            continue
                        if g != st["b"]:
                            flush()
                            st["b"] = g
                        if not one:
                            carry = w
                            for i in range(AGG_PLANES):
                                t_ = st["pl"][i] & carry
                                st["pl"][i] ^= carry
                                carry = t_
                            st["seen"] |= w
                        st["n"] += 1
                        if st["n"] == run_max:
                            flush()
                base += threads * AGG_PPL
            flush()


def agg_group_plan(q, g, n_segments, hist_bins=AGG_HIST_BINS):
    """agg_counts.cu's group_plan: (Qg, W, passes) of word group g."""
    qg = min(32, q - 32 * g)
    width = min(n_segments, hist_bins // qg)
    return qg, width, -(-n_segments // width)


def agg_plan(q, n_segments, hist_bins=AGG_HIST_BINS):
    """agg_counts.cu's es_agg_plan: (word groups, W and passes of the first
    group, passes summed over the groups); 8- and 16-bit words are one
    group."""
    groups = -(-q // 32) if q > 16 else 1
    plans = [agg_group_plan(q, g, n_segments, hist_bins)
             for g in range(groups)]
    return groups, plans[0][1], plans[0][2], sum(p[2] for p in plans)


def emulate_agg_counts(mask, blob, ps, n_segments, *, blocks=5, threads=64,
                       hist_bins=AGG_HIST_BINS):
    """numpy model of the whole C entry (csrc/agg_counts.cu): the mask pack
    (doc bits at Q = 1, query words above), then per group of 32 queries a
    persistent grid of `blocks` blocks over the concatenated chunks of the
    sections, the histogram in ceil(n_segments / W) passes of W =
    min(n_segments, hist_bins / Qg) buckets, and each block's nonzero bins
    added to the outputs. Returns one [Q, n_segments] i64 array per
    section."""
    q, n_docs = mask.shape
    secs, off = [], 0
    for p in ps:
        nc = p // 1024
        secs.append((blob[off:off + p], blob[off + p:off + 2 * p],
                     blob[off + 2 * p:off + 2 * p + nc],
                     blob[off + 2 * p + nc:off + 2 * p + 2 * nc], nc))
        off += 2 * p + 2 * nc
    outs = [np.zeros((q, n_segments), np.int64) for _ in ps]
    if q == 1:
        # (words, q0, packed, qg)
        groups = [(emulate_agg_bits(mask[0]), 0, 0, 1)]
    else:
        words = emulate_agg_pack(mask)
        groups = [(words[g], 32 * g, 1, min(32, q - 32 * g))
                  for g in range(words.shape[0])]
    nc_all = sum(s[4] for s in secs)
    grid = min(nc_all, blocks)
    for g, (words, q0, packed, qg) in enumerate(groups):
        _, width, passes = agg_group_plan(q, g, n_segments, hist_bins)
        for b in range(grid):
            c_begin, c_end = nc_all * b // grid, nc_all * (b + 1) // grid
            for pss in range(passes):
                b0 = pss * width
                wlen = min(width, n_segments - b0)
                cbase = 0
                for si, (d, s, ct0, ct1, nc) in enumerate(secs):
                    lo = max(c_begin, cbase) - cbase
                    hi = min(c_end, cbase + nc) - cbase
                    cbase += nc
                    if lo >= hi:
                        continue
                    hist = np.zeros((qg, wlen), np.int64)
                    _emulate_count_part(words, n_docs, d, s, ct0, ct1, lo,
                                        hi, b0, wlen, qg if packed else 0,
                                        hist, threads)
                    outs[si][q0:q0 + qg, b0:b0 + wlen] += hist
    return outs


def emulate_merge_rank(scores, ords, k):
    """numpy model of csrc/merge_topk.cu's one-pass rank merge: leaders
    (positive lanes with no equal (score, ord) lower in their partition),
    each leader's rank among the leaders by (score desc, partition asc, ord
    asc), slot rank for rank < k, (0, 0, 0) past the leaders."""
    q, L = scores.shape
    out_s = np.full((q, k), np.nan, np.float32)
    out_p = np.full((q, k), -1, np.int32)
    out_o = np.full((q, k), -1, np.int32)
    for qi in range(q):
        v = np.where(scores[qi] > 0, scores[qi], np.float32(0))
        o = ords[qi]
        lv = np.zeros(L, np.float32)
        for i in range(L):
            lead = v[i] > 0
            for j in range(i - i % k, i):
                if v[j] == v[i] and o[j] == o[i]:
                    lead = False
            lv[i] = v[i] if lead else 0
        leaders = int((lv > 0).sum())
        for i in range(L):
            if not lv[i] > 0:
                continue
            pi = i // k
            rank = sum(1 for j in range(L)
                       if lv[j] > lv[i] or (lv[j] == lv[i] and (
                           j // k < pi or (j // k == pi and o[j] < o[i]))))
            if rank < k:
                out_s[qi, rank], out_p[qi, rank], out_o[qi, rank] = \
                    lv[i], pi, o[i]
        out_s[qi, leaders:], out_p[qi, leaders:], out_o[qi, leaders:] = 0, 0, 0
    return out_s, out_p, out_o


# K4 edges of the rank merge: name -> (seed, q, n_parts, kk, edit)
MERGE_EDGE_CASES = ("dup_triples", "equal_across_parts", "nan_negzero_neg",
                    "few_positive", "lanes_not_32")


def merge_edge_inputs(case):
    """K4 inputs at the edges of the one-pass rank merge: duplicate
    triples within a partition (the cascade clears every copy), one score
    in every partition (partition, then ord decide), NaN, -0.0, -inf and
    negative lanes among positive ones, fewer positive lanes than k, and
    L = 3 x 7 = 21 lanes (not a multiple of 32). Returns (scores, ords,
    k)."""
    rng = np.random.default_rng(MERGE_EDGE_CASES.index(case) + 70)
    if case == "dup_triples":
        q, S, kk = 9, 3, 10
        s = rng.choice(np.float32([0.8, 0.5, 0.3]), size=(q, S, kk))
        o = rng.integers(0, 4, size=(q, S, kk)).astype(np.int32)
        s[0, 1, :] = 0.5          # one triple copied over a whole partition
        o[0, 1, :] = 2
    elif case == "equal_across_parts":
        q, S, kk = 6, 4, 10
        s = np.full((q, S, kk), np.float32(0.625))
        o = rng.integers(0, 12, size=(q, S, kk)).astype(np.int32)
        s[:, :, 5:] = np.float32(0.25)
    elif case == "nan_negzero_neg":
        q, S, kk = 8, 4, 10
        s = rng.choice(np.float32([0.9, 0.4, 0.4, 0.1]), size=(q, S, kk))
        o = rng.integers(0, 30, size=(q, S, kk)).astype(np.int32)
        bad = np.float32([np.nan, -0.0, -np.inf, -0.5, 0.0])
        at = rng.random((q, S, kk)) < 0.4
        s[at] = rng.choice(bad, size=int(at.sum()))
        s[1] = np.nan
        s[2] = np.float32(-0.0)
    elif case == "few_positive":
        q, S, kk = 7, 4, 10
        s = np.zeros((q, S, kk), np.float32)
        o = rng.integers(0, 50, size=(q, S, kk)).astype(np.int32)
        for qi in range(q):
            at = rng.choice(S * kk, size=qi, replace=False)
            s.reshape(q, -1)[qi, at] = rng.choice(np.float32([0.7, 0.2]),
                                                  size=qi)
    else:                         # lanes_not_32: L = 21
        q, S, kk = 11, 3, 7
        s = rng.choice(np.float32([0.9, 0.6, 0.6, 0.3, 0.0]),
                       size=(q, S, kk))
        o = rng.integers(0, 9, size=(q, S, kk)).astype(np.int32)
    return (s.reshape(q, S * kk).astype(np.float32),
            o.reshape(q, S * kk).astype(np.int32), kk)


# K8 edges of the word pack and run-length count:
# name -> (seed, Q, live rows, n_docs, n_segments, sections)
AGG_WORD_CASES = {
    "q5": (10, 5, None, 3000, 300, [dict(n_pairs=3000, head=0.2)]),
    "q9": (11, 9, None, 3001, 300, [dict(n_pairs=3000, head=0.2)]),
    "q17": (12, 17, None, 3002, 300, [dict(n_pairs=2500)]),
    "q33": (13, 33, None, 2003, 120, [dict(n_pairs=2000, head=0.3)]),
    "q40_padded": (14, 40, 23, 2000, 120,
                   [dict(n_pairs=1800), dict(n_pairs=1500, grouped=False)]),
    "runs_cross_chunks": (15, 4, None, 5000, 3,
                          [dict(n_pairs=5000, head=0.5)]),
    "run_across_tile": (16, 6, None, 4000, 16390,
                        [dict(n_pairs=4000, near_tile=True)]),
    "inconsistent_ranges_q": (17, 9, None, 6000, 40000,
                              [dict(n_pairs=6000, grouped=False)]),
    "wide_buckets_q": (18, 12, None, 5000, 33000,
                       [dict(n_pairs=4000, grouped=False)]),
}


def agg_word_inputs(name):
    """(mask, blob, section pair counts, n_segments) of one AGG_WORD_CASES
    case: Q of 5, 9, 17, 33 and 40 (every word width, two query groups,
    padding rows left all False), bucket runs longer than a chunk (3
    buckets over 5 chunks), buckets on both sides of the first tile
    boundary (16383 and 16384 alternate in one run of pairs), tile ranges
    that disagree with the pairs at Q = 9, and 33,000 buckets (three
    tiles) at Q = 12."""
    seed, q, live, n_docs, n_seg, secs = AGG_WORD_CASES[name]
    rng = np.random.default_rng(seed)
    parts, ps = [], []
    for kw in secs:
        kw = dict(kw)
        near = kw.pop("near_tile", False)
        sec = agg_section(rng, n_docs, n_seg, **kw)
        if near:
            d, s, ct0, ct1 = (a.copy() for a in sec)
            n = kw["n_pairs"]
            s[:n] = np.where(np.arange(n) % 3 == 0, 16384, 16383)
            s[: n // 4] = 16383          # a long run, then the alternation
            for c in range(len(ct0)):
                live_s = s[c * 1024:(c + 1) * 1024]
                live_s = live_s[live_s >= 0]
                if len(live_s):
                    ct0[c], ct1[c] = live_s.min() >> 14, live_s.max() >> 14
            sec = (d, s, ct0, ct1)
        if name == "inconsistent_ranges_q":
            sec = perturb_ranges(sec, -(-n_seg // k.AGG_SEG_TILE))
        parts += list(sec)
        ps.append(len(sec[0]))
    return (agg_masks(rng, q, n_docs, live, density=0.2),
            np.concatenate(parts), ps, n_seg)


# ---- the bitset pack (csrc/pack_bits.cu) and K5's counts ----

PACK_CASES = ("random", "lo_only", "minus128", "zero_slot", "nsw3", "dpc2")


def pack_inputs(case):
    """Column layers [dpc, Hp+1, 16, 128] i8 for the pack: random sparse
    columns, columns where only lo is set, bytes of -128 (the sign bit
    alone) in either layer, an all-zero slot beside full ones, three
    superwindows (odd nsw), and the smallest cache (two chunks, one
    slot)."""
    seed = PACK_CASES.index(case)
    rng = np.random.default_rng(70 + seed)
    nsw, hp1 = {"nsw3": (3, 5), "dpc2": (None, 1)}.get(case, (1, 11))
    dpc = 2 if case == "dpc2" else nsw * k.N_CHUNKS
    shape = (dpc, hp1, 16, 128)
    hi = rng.integers(-127, 128, size=shape).astype(np.int8)
    lo = rng.integers(-127, 128, size=shape).astype(np.int8)
    hi[rng.random(shape) < 0.8] = 0
    lo[rng.random(shape) < 0.8] = 0
    if case == "lo_only":
        hi[:] = 0
    elif case == "minus128":
        hi[:] = 0
        lo[:] = 0
        hi[rng.random(shape) < 0.1] = -128
        lo[rng.random(shape) < 0.1] = -128
    elif case == "zero_slot":
        hi[:, 3] = 0
        lo[:, 3] = 0
        hi[:, 5] = -1                       # every cell present
    hi[:, -1] = 0                           # the scratch slot Hp
    lo[:, -1] = 0
    return hi, lo


def _byte_perm_np(x, y, s):
    """__byte_perm(x, y, s) on uint32 arrays, s a Python constant."""
    b = [(x >> np.uint32(8 * i)) & np.uint32(255) for i in range(4)] + \
        [(y >> np.uint32(8 * i)) & np.uint32(255) for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= b[(s >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def emulate_pack_bits(hi, lo):
    """numpy model of csrc/pack_bits.cu: per (slot, word row, 4 lanes) the
    32 rows' 4-byte words, __vcmpne4(h | l, 0) & 0x01010101, eight rows'
    0/1 bytes summed into a word, then the 4x4 byte transpose. Returns
    bits [Hp+2, dpc // 2, 128] i32."""
    dpc, hp1 = hi.shape[:2]
    wgr = dpc // 2
    h = np.ascontiguousarray(hi).view(np.uint32)    # [dpc, hp1, 16, 32]
    l_ = np.ascontiguousarray(lo).view(np.uint32)
    v = (h | l_).reshape(wgr, 2, hp1, 16, 32).transpose(2, 0, 1, 3, 4)
    v = v.reshape(hp1, wgr, 32, 32)                 # [s, g, row j, t]
    nz = v.view(np.uint8).reshape(hp1, wgr, 32, 32, 4) != 0
    m = (nz.astype(np.uint32) << (np.arange(4, dtype=np.uint32) * 8)).sum(
        axis=-1, dtype=np.uint32)                   # vcmpne4 & 0x01010101
    a = [np.zeros((hp1, wgr, 32), np.uint32) for _ in range(4)]
    for kk in range(4):
        for i in range(8):
            a[kk] |= m[:, :, 8 * kk + i] << np.uint32(i)
    t0 = _byte_perm_np(a[0], a[1], 0x5140)
    t1 = _byte_perm_np(a[2], a[3], 0x5140)
    t2 = _byte_perm_np(a[0], a[1], 0x7362)
    t3 = _byte_perm_np(a[2], a[3], 0x7362)
    words = np.stack([_byte_perm_np(t0, t1, 0x5410),
                      _byte_perm_np(t0, t1, 0x7632),
                      _byte_perm_np(t2, t3, 0x5410),
                      _byte_perm_np(t2, t3, 0x7632)], axis=-1)
    bits = np.full((hp1 + 1, wgr, 128), 0xFFFFFFFF, np.uint32)
    bits[:hp1] = words.reshape(hp1, wgr, 128)
    return bits.view(np.int32)


K5_THREADS = 256          # intersect_bitset.cu's THREADS: a block's threads


def _k5_lists(slots, negs, n_slots):
    """intersect_bitset.cu's per-query slot lists: (pos, neg) to read, or
    None for a block that is zero without a read."""
    zero_s, ones_s = n_slots - 2, n_slots - 1
    pos, neg, empty = [], [], False
    for s in slots:
        empty |= s == zero_s
        if s not in (zero_s, ones_s) and s not in pos:
            pos.append(s)
    for s in negs:
        empty |= s == ones_s
        if s not in (zero_s, ones_s) and s not in neg:
            neg.append(s)
    return None if empty else (pos, neg)


def emulate_mask_counts(mask):
    """numpy model of the counts of csrc/intersect_bitset.cu over a mask
    [QC, nsw * 16, 128] i32: in each (query, superwindow) block, thread t
    owns the 16-byte words t + 256v (v < 2); warp w ballots (x & 0xFFFF)
    != 0 and (x >> 16) != 0 over its threads' x (the OR of a thread's four
    uint32 lanes, shifted as unsigned) for each v, so its flags count the
    nonzero chunk halves of word rows w + 8v; __syncthreads_count over
    (lane < flags) sums the warps' flags, and the block adds the total to
    counts[q]. Returns counts [QC] i32."""
    qc, wgr, _ = mask.shape
    nsw = wgr // k.SW_WORD_ROWS
    vec = mask.view(np.uint32).reshape(qc, nsw, k.SW_WORD_ROWS * 32, 4)
    x = np.bitwise_or.reduce(vec, axis=-1)        # [q, sw, 16-byte word]
    vpt = k.SW_WORD_ROWS * 32 // K5_THREADS
    counts = np.zeros(qc, np.int64)
    for q in range(qc):
        for sw in range(nsw):
            total = 0
            for w in range(K5_THREADS // 32):
                flags = 0
                for v in range(vpt):
                    t0 = v * K5_THREADS + 32 * w
                    xs = x[q, sw, t0:t0 + 32]
                    flags += int(((xs & np.uint32(0xFFFF)) != 0).any())
                    flags += int(((xs >> np.uint32(16)) != 0).any())
                total += sum(lane < flags for lane in range(32))
            counts[q] += total
    return counts.astype(np.int32)


def emulate_intersect_counts(q_slots, q_neg, bits, nsw):
    """numpy model of csrc/intersect_bitset.cu: a block per (query,
    superwindow), its mask read only from the query's distinct,
    non-sentinel slots (a zero sentinel in the AND list or a ones sentinel
    in the AND-NOT list leaves the block zero unread), the counts as
    emulate_mask_counts. Returns (mask i32, counts i32)."""
    qc = q_slots.shape[0]
    n_slots = bits.shape[0]
    b = bits.view(np.uint32)
    mask = np.zeros((qc, nsw * k.SW_WORD_ROWS, 128), np.uint32)
    for q in range(qc):
        lists = _k5_lists(q_slots[q], q_neg[q], n_slots)
        if lists is None:
            continue
        for sw in range(nsw):
            rows = slice(sw * k.SW_WORD_ROWS, (sw + 1) * k.SW_WORD_ROWS)
            acc = np.full((k.SW_WORD_ROWS, 128), 0xFFFFFFFF, np.uint32)
            for s in lists[0]:
                acc &= b[s, rows]
            for s in lists[1]:
                acc &= ~b[s, rows]
            mask[q, rows] = acc
    mask = mask.view(np.int32)
    return mask, emulate_mask_counts(mask)


COUNT_MASK_CASES = ("random", "high_only", "low_only", "sign_bit", "empty")


def count_mask_inputs(case, qc=6, nsw=2):
    """Masks for the count scheme: mask_inputs' random ones, words with
    only high-half bits, only low-half bits, only the sign bit (the
    arithmetic shift's trap), and all zero."""
    mask = mask_inputs(80 + COUNT_MASK_CASES.index(case), qc, nsw)
    rng = np.random.default_rng(90 + COUNT_MASK_CASES.index(case))
    if case == "high_only":
        mask &= np.int32(-65536)
    elif case == "low_only":
        mask &= np.int32(0xFFFF)
    elif case == "sign_bit":
        mask[:] = 0
        mask[rng.random(mask.shape) < 0.01] = np.int32(-2 ** 31)
    elif case == "empty":
        mask[:] = 0
    return mask


def overflow_slots(seed, qc, n_slots, n_req=11, n_neg=6):
    """Queries past K5's fan-in: each has n_req required and n_neg
    prohibited slots (disjoint, drawn at random), truncated to the first
    BITSET_CLAUSES / BITSET_NEGS as TurboBM25._bitset_slots keeps the
    rarest. Returns (q_slots, q_neg, full required lists, full must_not
    lists)."""
    rng = np.random.default_rng(seed)
    q_slots = np.zeros((qc, k.BITSET_CLAUSES), np.int32)
    q_neg = np.zeros((qc, k.BITSET_NEGS), np.int32)
    reqs, negs = [], []
    for q in range(qc):
        pick = rng.choice(n_slots, size=n_req + n_neg, replace=False)
        req, neg = pick[:n_req], pick[n_req:]
        q_slots[q] = req[: k.BITSET_CLAUSES]
        q_neg[q] = neg[: k.BITSET_NEGS]
        reqs.append(req)
        negs.append(neg)
    return q_slots, q_neg, reqs, negs


# --------------------------------------------------------------------------
# block scatter (ops/scoring.py's bm25_scatter_scores / constant_scatter_mask)
# --------------------------------------------------------------------------

SCATTER_CASES = ("head", "mid", "rare", "head_boosted")


def scatter_postings(seed=0, n_docs=40_000, n_terms=2_000):
    """A text field's block postings (the port's build_field_postings) over
    Zipf-like tokens: a head term in most docs, mid and rare ones, 5% of
    docs empty (doc_len 0), lengths up to 60. Returns (FieldPostings,
    avgdl)."""
    from elasticsearch_tpu_torch.index.segment import build_field_postings

    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 60, size=n_docs)
    lens[rng.random(n_docs) < 0.05] = 0
    p = 1.0 / np.arange(1, n_terms + 1) ** 1.1
    p /= p.sum()
    toks = rng.choice(n_terms, size=int(lens.sum()), p=p)
    docs = np.repeat(np.arange(n_docs), lens)
    fp = build_field_postings("body", lens, docs, toks,
                              [f"t{i:05d}" for i in range(n_terms)])
    return fp, float(fp.sum_doc_len) / max(int((lens > 0).sum()), 1)


def scatter_case(fp, case):
    """(padded block ids i32, per-row idf f32) of one term of `fp` as the
    executor builds them (pad_block_ids: rows padded with 0 to a power of
    two, idf 0 there), by case: the head term, a mid term (df near 1%) with
    a boost of 1.5 folded into its idf, the rarest term, and the head term
    with a boost of 2.5."""
    df = fp.doc_freq
    order = np.argsort(-df, kind="stable")
    if case in ("head", "head_boosted"):
        o = int(order[0])
    elif case == "mid":
        o = int(order[np.argmin(np.abs(df[order] - len(fp.doc_len) // 100))])
    else:
        o = int(order[np.count_nonzero(df) - 1])
    ids = np.arange(fp.block_start[o], fp.block_start[o] + fp.block_count[o],
                    dtype=np.int32)
    b = 8 if len(ids) <= 8 else 1 << (len(ids) - 1).bit_length()
    padded = np.zeros(b, np.int32)
    padded[:len(ids)] = ids
    n = len(fp.doc_len)
    idf = np.float32(np.log(1.0 + (n - df[o] + 0.5) / (df[o] + 0.5)))
    w = np.zeros(b, np.float32)
    boost = {"mid": 1.5, "head_boosted": 2.5}.get(case, 1.0)
    w[:len(ids)] = idf * np.float32(boost)
    return padded, w


SCATTER_EDGE_CASES = ("shuffled", "ragged", "row0_live")


def scatter_edge_case(fp, case, seed=0):
    """(fp, ids, idf) of a block-scatter edge on the head term of `fp`, as
    scatter_case makes it: its padded rows shuffled, the pad rows among
    them (any order is in the contract); its real rows alone, a count
    that is not a whole number of the kernel's block ids a step; its real
    rows after the reserved row 0, given live lanes (docs the term does
    not hold, tf > 0, a tail of pad lanes) and an idf, so row 0 is scored
    like any row, not skipped as padding. Returns a copy of `fp` where it
    edits the blocks."""
    import copy

    ids, idf = scatter_case(fp, "head")
    n_real = int(np.count_nonzero(idf))
    if case == "shuffled":
        perm = np.random.default_rng(seed).permutation(len(ids))
        return fp, ids[perm], idf[perm]
    if case == "ragged":
        n_real -= n_real % 32 == 0        # never a whole number of steps
        return fp, ids[:n_real], idf[:n_real]
    fp = copy.copy(fp)
    docs, tfs = fp.block_docs.copy(), fp.block_tfs.copy()
    rows = ids[:n_real]
    free = np.setdiff1d(np.arange(len(fp.doc_len)),
                        docs[rows][tfs[rows] > 0])
    docs[0] = free[:128]
    tfs[0] = np.random.default_rng(seed).integers(1, 4, 128)
    tfs[0, 100:] = 0
    fp.block_docs, fp.block_tfs = docs, tfs
    return (fp, np.concatenate([[0], rows]).astype(np.int32),
            np.concatenate([[0.7], idf[:n_real]]).astype(np.float32))


def scatter_ladder(n_rows, seed=0):
    """One term's blocks of `n_rows` rows, made directly (no postings
    build), for a block-scatter launch of any row count: block row 0
    reserved (zeros), row r >= 1 holds docs (r - 1) * 128 + lane in
    order, a quarter of the lanes dead (tf 0); n_docs = n_rows * 128 + 3,
    not a multiple of 4, the last 3 docs in no row. Returns (docs [n_rows + 1, 128] i32, tfs f32, doc_len
    [n_docs] f32, ids [n_rows] i32 = 1..n_rows, idf [n_rows] f32,
    avgdl)."""
    rng = np.random.default_rng(seed)
    n_docs = n_rows * 128 + 3
    docs = np.zeros((n_rows + 1, 128), np.int32)
    docs[1:] = np.arange(n_rows * 128, dtype=np.int32).reshape(n_rows, 128)
    tfs = np.zeros((n_rows + 1, 128), np.float32)
    tfs[1:] = rng.integers(0, 4, (n_rows, 128))
    doc_len = rng.integers(0, 60, n_docs).astype(np.float32)
    ids = np.arange(1, n_rows + 1, dtype=np.int32)
    idf = rng.uniform(0.1, 6.0, n_rows).astype(np.float32)
    avgdl = float(doc_len.sum() / max(np.count_nonzero(doc_len), 1))
    return docs, tfs, doc_len, ids, idf, avgdl


def presence_ids(fp, n_terms=12):
    """Padded block ids of several terms concatenated (a terms / prefix
    filter: docs repeat across terms)."""
    parts = [np.arange(fp.block_start[o], fp.block_start[o] + fp.block_count[o],
                       dtype=np.int32) for o in range(n_terms)]
    ids = np.concatenate(parts)
    b = 1 << (len(ids) - 1).bit_length()
    out = np.zeros(b, np.int32)
    out[:len(ids)] = ids
    return out


# ---------------------------------------------------------------------------
# K10 lane top-k and K11 weighted block scatter (BlockMax, spmd)
# ---------------------------------------------------------------------------

# name -> (partitions, rows Q, block bucket B, terms a row, docs, term dfs
# (lo, hi), k): the four (bucket, Qc) shapes of blockmax._GROUP_SHAPES, then
# edges, then the tiled kernel's cases: a row over many tiles with tied
# scores ("tiles", "k1"), a narrow dense run beside a sparse one, so that
# one tile's blocks outgrow its staging room ("skew"), rows of one tile
# beside rows of many ("mixed"), the largest k the kernel takes, and rows
# of 100 runs, more than a pass stages, beside a dense run over many tiles
# ("runs100", the sorted tiles), and rows of 2,800 runs at the largest k,
# more than the sorted tiles' shared memory holds ("runs2800", the chunks)
LANE_TOPK_SHAPES = {
    "g32": (2, 512, 32, 3, 60_000, (200, 1_200), 10),
    "g512": (2, 64, 512, 3, 400_000, (2_000, 20_000), 10),
    "g8192": (1, 8, 8192, 3, 4_000_000, (100_000, 300_000), 10),
    "g32768": (1, 4, 32768, 3, 8_000_000, (1_300_000, 1_400_000), 10),
    "ties": (2, 16, 64, 3, 20_000, (500, 2_000), 10),
    "big_k": (2, 8, 64, 4, 20_000, (500, 2_000), 300),
    "edges": (3, 12, 48, 3, 10_000, (100, 1_500), 10),
    "tiles": (2, 4, 2048, 3, 400_000, (20_000, 60_000), 10),
    "k1": (2, 4, 2048, 3, 400_000, (20_000, 60_000), 1),
    "skew": (1, 4, 512, 2, 1_000_000, (25_000, 30_000), 10),
    "mixed": (2, 8, 512, 3, 100_000, (10_000, 30_000), 10),
    "k15360": (1, 2, 2048, 2, 400_000, (100_000, 150_000), 15360),
    "runs100": (1, 4, 2048, 100, 100_000, (500, 3_000), 10),
    "runs2800": (1, 1, 4096, 2800, 20_000, (5, 40), 15360),
}
LANE_TOPK_MODES = ("lane", "hybrid", "bool")
# "skew"'s dense term: every doc of [SKEW_LO, SKEW_LO + SKEW_SPAN) but a
# twentieth, about 149 blocks in a doc range where the sparse terms hold 4;
# "runs100"'s: 95% of the docs of [0, 30,000), about 223 blocks
SKEW_LO, SKEW_SPAN = 500_000, 20_000
DENSE_SPANS = {"skew": (SKEW_LO, SKEW_SPAN), "runs100": (0, 30_000)}


def _term_blocks(rng, n_docs, df, tie, span=None):
    """One term's postings blocks: sorted docs of rate df / n_docs (or,
    given `span` (lo, n), 95% of the docs of [lo, lo + n)), lane scores in
    (0.2, 2.2] (rounded to 0.25 when `tie`), pad lanes doc 0 with score
    0."""
    if span is None:
        docs = np.nonzero(rng.random(n_docs) < df / n_docs)[0]
    else:
        docs = span[0] + np.nonzero(rng.random(span[1]) < 0.95)[0]
    docs = docs.astype(np.int32)
    sc = rng.uniform(0.2, 2.2, len(docs)).astype(np.float32)
    if tie:
        sc = np.ceil(sc * 4).astype(np.float32) / 4
    nb = -(-len(docs) // 128)
    bd = np.zeros((nb, 128), np.int32)
    bs = np.zeros((nb, 128), np.float32)
    bd.ravel()[: len(docs)] = docs
    bs.ravel()[: len(docs)] = sc
    return bd, bs


def lane_topk_inputs(name, mode, seed=0):
    """Seeded K10 inputs for a case of LANE_TOPK_SHAPES in a mode of
    LANE_TOPK_MODES, as numpy arrays: (block_docs, block_scores, live,
    qblocks, qw, tstart, k, extra) where extra holds addend / qf / hp / nm
    for the mode. Each row takes `terms` of the partition's terms (the
    same term twice in some rows of "edges"), each term's kept blocks a
    random subset in doc order, truncated to the bucket; "edges" also has
    rows with no blocks, rows whose every run is empty, dead docs and an
    all-dead partition row. In "skew" and "runs100" every row takes term 0,
    the dense narrow one, in a random run; in "mixed" the even rows keep at
    most 12 blocks a run (one tile); in rows of many runs two terms are
    required on average (bool mode)."""
    S, Q, B, nt, n_docs, (lo, hi), kk = LANE_TOPK_SHAPES[name]
    rng = np.random.default_rng(seed)
    tie = name in ("ties", "tiles", "k1")
    n_terms = 2 * nt + 2
    parts = []
    for _ in range(S):
        rows_d, rows_s, spans = [np.zeros((1, 128), np.int32)], \
            [np.zeros((1, 128), np.float32)], []
        start = 1
        for t in range(n_terms):
            span = DENSE_SPANS.get(name) if t == 0 else None
            bd, bs = _term_blocks(rng, n_docs, int(rng.integers(lo, hi)), tie,
                                  span)
            rows_d.append(bd)
            rows_s.append(bs)
            spans.append((start, len(bd)))
            start += len(bd)
        parts.append((np.concatenate(rows_d), np.concatenate(rows_s), spans))
    T = max(len(p[0]) for p in parts)
    block_docs = np.zeros((S, T, 128), np.int32)
    block_scores = np.zeros((S, T, 128), np.float32)
    for s, (bd, bs, _) in enumerate(parts):
        block_docs[s, : len(bd)] = bd
        block_scores[s, : len(bs)] = bs
    live = rng.random((S, n_docs)) > 0.1
    qblocks = np.zeros((Q, S, B), np.int32)
    qw = np.zeros((Q, S, B), np.float32)
    qf = np.zeros((Q, S, B), np.float32)
    R = nt + (1 if name == "edges" else 0)
    tstart = np.zeros((Q, S, R + 1), np.int32)
    n_req = np.zeros(Q, np.float32)
    for q in range(Q):
        terms = list(rng.choice(n_terms, size=nt, replace=False))
        if name in DENSE_SPANS and 0 not in terms:
            terms[int(rng.integers(nt))] = 0
        if name == "edges" and q % 4 == 1:
            terms.append(terms[0])             # a term in two runs
        ws = (np.full(len(terms), 1.5, np.float32) if tie else
              rng.uniform(0.3, 3.0, len(terms)).astype(np.float32))
        req = rng.random(len(terms)) < (2 / nt if nt > 10 else 0.6)
        n_req[q] = req.sum()
        keep_p = 1.0 if name in ("g32768", "skew") else 0.7
        for s in range(S):
            off = 0
            for r, (t, w, rq) in enumerate(zip(terms, ws, req)):
                tstart[q, s, r] = off
                if name == "edges" and (q % 4 == 2 or (q % 4 == 3 and r)):
                    continue                   # empty runs
                st, cnt = parts[s][2][t]
                ids = np.arange(st, st + cnt, dtype=np.int32)
                ids = ids[rng.random(cnt) < keep_p]
                if name == "mixed" and q % 2 == 0:
                    ids = ids[:12]
                ids = ids[: B - off]
                qblocks[q, s, off: off + len(ids)] = ids
                qw[q, s, off: off + len(ids)] = w
                qf[q, s, off: off + len(ids)] = float(rq)
                off += len(ids)
            tstart[q, s, len(terms):] = off
    if name == "edges":
        live[0, :] = False
        qblocks[Q - 1, :, :] = 0
        tstart[Q - 1] = 0
    extra = {}
    if mode in ("hybrid", "bool"):
        add = rng.uniform(0.0, 3.0, (S, Q, n_docs)).astype(np.float32)
        add[rng.random((S, Q, n_docs)) < 0.7] = 0.0
        if tie:
            add = np.ceil(add * 4) / 4
        extra["addend"] = add.astype(np.float32)
    if mode == "bool":
        hp = (rng.random((S, Q, n_docs)) < 0.4).astype(np.float32)
        extra["qf"] = qf
        extra["hp"] = hp
        extra["nm"] = n_req + (rng.random(Q) < 0.5)
    return (block_docs, block_scores, live, qblocks, qw, tstart, kk, extra)


def emulate_lane_topk(block_docs, block_scores, live, qblocks, qw, tstart, kk,
                      addend=None, qf=None, hp=None, nm=None, *,
                      tile_blocks=None, nb=96, chunk=64, sort_lanes=4096,
                      stats=None):
    """lane_topk.cu's algorithm in numpy, for the CPU tests: per row, the
    tiles (C from kernels.lane_topk_plan unless given), each tile's ranked
    k pairs (pads (-inf, -1)) and their merge; one tile writes the row
    itself. Rows of up to `chunk` (RUN_CHUNK) runs, or of more than
    `sort_lanes` (SORT_LANES): tiles cut at every C-th block of the longest
    run (rows of more than `chunk` runs: even cuts of [0, D), ceil(the
    row's positions / (C / 2)) tiles); in each tile the runs in chunks of
    `chunk`, each chunk's passes
    (its doc range halved until the chunk's blocks in it fit `nb` staged
    rows), the searches (first doc of a block, then its lanes; pad lanes,
    doc 0 past lane 0, last) in the staged blocks for runs of the chunk and
    over the whole run for the others, the first-run rule and the in-order
    f32 sums. Other rows: the sorted tiles (_sorted_tile). `stats`, a dict,
    gets the most tiles, passes (of a chunk) and chunks a row took, and the
    sorted tiles' most passes."""
    S, T, _ = block_docs.shape
    Q, _, B = qblocks.shape
    R = tstart.shape[2] - 1
    D = live.shape[1]
    C, tiles = k_plan = k.lane_topk_plan(S, Q, B, kk)
    if tile_blocks is not None:
        C, tiles = tile_blocks, max(-(-B // tile_blocks), 1)
    assert min(R, chunk) <= nb, (R, chunk, nb)
    bool_mode = qf is not None
    out_s = np.full((S, Q, kk), -np.inf, np.float32)
    out_d = np.zeros((S, Q, kk), np.int32)
    st = stats if stats is not None else {}
    st.setdefault("tiles", 0)
    st.setdefault("passes", 0)
    st.setdefault("chunks", 0)
    st.setdefault("sorted_passes", 0)
    st.setdefault("plan", k_plan)
    f32 = np.float32
    for s in range(S):
        bd, bs, lv = block_docs[s], block_scores[s], live[s]
        for q in range(Q):
            qb, w = qblocks[q, s], qw[q, s]
            rs = [0] + [min(max(int(x), 0), B) for x in tstart[q, s, 1:]]
            lens = [rs[r + 1] - rs[r] for r in range(R)]
            m = int(np.argmax(lens)) if max(lens) > 0 else 0
            n_tiles = -(-lens[m] // C) if lens[m] > 0 else 1
            even = R > chunk          # even cuts of [0, D)
            if even:
                n_tiles = min(max(-(-2 * sum(max(x, 0) for x in lens) // C),
                                  1), tiles)
            if chunk < R <= sort_lanes:
                pairs = []
                for t in range(n_tiles):
                    best = _sorted_tile(
                        bd, bs, lv, qb, w, None if qf is None else qf[q, s],
                        rs, D * t // n_tiles, D * (t + 1) // n_tiles, D,
                        sort_lanes, st,
                        lambda d, acc, cnt: _judge(addend, hp, nm, lv, s, q,
                                                   d, acc, cnt))[:kk]
                    pairs += best + [(-np.inf, -1)] * (kk - len(best))
                if tiles > 1:
                    pairs.sort(key=lambda x: (-x[0], x[1]))
                for j, (v, d) in enumerate([x for x in pairs
                                            if x[1] >= 0][:kk]):
                    out_s[s, q, j] = v
                    out_d[s, q, j] = d
                st["tiles"] = max(st["tiles"], n_tiles)
                continue
            assert n_tiles <= tiles
            st["tiles"] = max(st["tiles"], n_tiles)

            def first(p):
                return int(bd[qb[p], 0])

            def ub(a, e, x):         # first p in [a, e) with first(p) > x
                while a < e:
                    mid = (a + e) // 2
                    if first(mid) <= x:
                        a = mid + 1
                    else:
                        e = mid
                return a

            whole = [list(range(rs[r], max(rs[r + 1], rs[r])))
                     for r in range(R)]
            st["chunks"] = max(st["chunks"], -(-R // chunk))
            pairs = []
            for t, c0 in ((t, c0) for t in range(n_tiles)
                          for c0 in range(0, R, chunk)):
                if c0 == 0:
                    cands = []
                a0 = rs[m] + t * C
                if even:
                    lo, hi = D * t // n_tiles, D * (t + 1) // n_tiles
                else:
                    lo = 0 if t == 0 else first(a0)
                    hi = D if t == n_tiles - 1 else first(a0 + C)
                runs = range(c0, min(R, c0 + chunk))
                plo, n_pass = lo, 0
                while plo < hi:
                    ra = {r: rs[r] if plo <= 0 or rs[r + 1] <= rs[r]
                          else max(rs[r], ub(rs[r], rs[r + 1], plo) - 1)
                          for r in runs}
                    phi = hi
                    while True:
                        ends = {r: max(rs[r + 1], rs[r]) if phi >= D or
                                ra[r] == max(rs[r + 1], rs[r]) else
                                ub(ra[r], max(rs[r + 1], rs[r]), phi - 1)
                                for r in runs}
                        if sum(ends[r] - ra[r] for r in runs) <= nb:
                            break
                        assert phi - plo > 1
                        phi = plo + (phi - plo) // 2
                    n_pass += 1
                    staged = {r: list(range(ra[r], ends[r])) for r in runs}
                    for r in runs:
                        for p in staged[r]:
                            for j in range(128):
                                d, sc = int(bd[qb[p], j]), bs[qb[p], j]
                                if not (sc > 0 and plo <= d < phi and d < D):
                                    continue
                                ok, acc, cnt = True, f32(0), f32(0)
                                for u in range(R):
                                    if u == r:
                                        p2, s2 = p, sc
                                    else:
                                        p2 = _find_staged(
                                            bd, bs, qb,
                                            staged.get(u, whole[u]), d)
                                        if p2 is None:
                                            continue
                                        p2, s2 = p2
                                        if u < r:
                                            ok = False
                                            break
                                    acc = f32(acc + f32(w[p2] * s2))
                                    if bool_mode:
                                        cnt = f32(cnt + qf[q, s, p2])
                                if not ok:
                                    continue
                                if bool_mode:
                                    val = f32(acc + addend[s, q, d])
                                    cov = f32(cnt + hp[s, q, d])
                                    keep = (lv[d] and abs(f32(cov - nm[q]))
                                            < 0.5 and val > 0)
                                else:
                                    keep = acc > 0 and lv[d]
                                    val = acc if addend is None else \
                                        f32(acc + addend[s, q, d])
                                if keep:
                                    cands.append((val, d))
                    plo = phi
                st["passes"] = max(st["passes"], n_pass)
                if c0 + chunk < R:
                    continue           # the tile's next chunk of runs
                cands.sort(key=lambda x: (-x[0], x[1]))
                best = cands[:kk]
                pairs += best + [(-np.inf, -1)] * (kk - len(best))
            if tiles > 1:
                pairs = [x for x in pairs if x[1] >= 0]
                pairs.sort(key=lambda x: (-x[0], x[1]))
            for j, (v, d) in enumerate([x for x in pairs if x[1] >= 0][:kk]):
                out_s[s, q, j] = v
                out_d[s, q, j] = d
    return out_s, out_d


def _judge(addend, hp, nm, lv, s, q, d, acc, cnt):
    """lane_topk.cu's judge: (whether doc d is a candidate, its value)
    from its total `acc` and its runs' must flags `cnt`, by the mode's
    rule."""
    f32 = np.float32
    if hp is not None:
        val = f32(acc + addend[s, q, d])
        return (bool(lv[d]) and abs(f32(f32(cnt + hp[s, q, d]) - nm[q])) < 0.5
                and val > 0), val
    keep = acc > 0 and bool(lv[d])
    return keep, (f32(acc + addend[s, q, d]) if addend is not None and keep
                  else acc)


def _sorted_tile(bd, bs, lv, qb, w, qf, rs, tlo, thi, D, L, st, judge):
    """sort_tile_kernel's tile [tlo, thi) of one row, ranked (value,
    doc) candidates: passes of at most L lanes (phi cut in proportion, to
    7/8 of L), each run's lanes of the pass a span of its blocks' lanes
    (lane_lb), gathered, sorted by (doc, run), each doc's first summing its
    w * score values in run order."""
    f32 = np.float32
    R = len(rs) - 1
    big = np.iinfo(np.int32).max

    def lane_lb(r, x):
        a = rs[r]
        lo, hi = a, max(rs[r + 1], a)
        while lo < hi:
            mid = (lo + hi) // 2
            if int(bd[qb[mid], 0]) < x:
                lo = mid + 1
            else:
                hi = mid
        if lo - 1 < a:
            return a * 128
        row = bd[qb[lo - 1]]
        keys = np.where((np.arange(128) > 0) & (row == 0), big, row)
        return (lo - 1) * 128 + int(np.searchsorted(keys, x, "left"))

    cands = []
    lo = [lane_lb(r, tlo) for r in range(R)]
    plo, n_pass = tlo, 0
    while plo < thi:
        phi = thi
        while True:
            hi = [lane_lb(r, phi) for r in range(R)]
            total = sum(max(h - l, 0) for l, h in zip(lo, hi))
            if total <= L or phi - plo <= 1:
                break
            phi = plo + max(1, (phi - plo) * (L - L // 8) // total)
        n_pass += 1
        items = []
        for r in range(R):
            for at in range(lo[r], hi[r]):
                p, j = divmod(at, 128)
                d, sc = int(bd[qb[p], j]), bs[qb[p], j]
                if sc > 0 and plo <= d < phi and 0 <= d < D:
                    items.append((d, r, f32(w[p] * sc),
                                  f32(0) if qf is None else qf[p]))
        assert len(items) <= L
        items.sort(key=lambda x: (x[0], x[1]))
        for i, (d, _, _, _) in enumerate(items):
            if i and items[i - 1][0] == d:
                continue
            acc, cnt = f32(0), f32(0)
            for d2, _, v, fl in items[i:]:
                if d2 != d:
                    break
                acc = f32(acc + v)
                cnt = f32(cnt + fl)
            keep, val = judge(d, acc, cnt)
            if keep:
                cands.append((val, d))
        lo = hi
        plo = phi
    st["sorted_passes"] = max(st["sorted_passes"], n_pass)
    return sorted(cands, key=lambda x: (-x[0], x[1]))


def _find_staged(bd, bs, qb, staged, d):
    """The kernel's find_staged (or find_global) over one run's staged
    positions (or all of them): the last block whose first doc is <= d,
    then d's lane (pad lanes last); (position, lane score) when it holds d
    with a score > 0, else None."""
    lo, hi = 0, len(staged)
    while lo < hi:
        mid = (lo + hi) // 2
        if int(bd[qb[staged[mid]], 0]) <= d:
            lo = mid + 1
        else:
            hi = mid
    if lo == 0:
        return None
    p = staged[lo - 1]
    row = bd[qb[p]]
    key = np.where((np.arange(128) > 0) & (row == 0), np.iinfo(np.int32).max,
                   row)
    j = int(np.searchsorted(key, d, "left"))
    if j == 128 or int(row[j]) != d or not bs[qb[p], j] > 0:
        return None
    return p, bs[qb[p], j]


def lane_topk_brute(block_docs, block_scores, live, qblocks, qw, tstart, k,
                    addend=None, qf=None, hp=None, nm=None):
    """A dict-per-row numpy statement of K10's contract (no sort-and-sum
    trick): per (partition, query) row, each doc's weighted lane scores
    summed in run order from 0, the addend last, the mode's gate, then
    (score desc, doc asc); padded with (-inf, 0)."""
    S = block_docs.shape[0]
    Q = qblocks.shape[0]
    R = tstart.shape[2] - 1
    out_s = np.full((S, Q, k), -np.inf, np.float32)
    out_d = np.zeros((S, Q, k), np.int32)
    for q in range(Q):
        for s in range(S):
            ts = tstart[q, s]
            docs = {}
            for r in range(R):
                for p in range(ts[r], ts[r + 1]):
                    b = qblocks[q, s, p]
                    for j in range(128):
                        sc = block_scores[s, b, j]
                        if not sc > 0:
                            continue
                        d = int(block_docs[s, b, j])
                        tot, cnt = docs.get(d, (np.float32(0), 0.0))
                        tot = np.float32(tot + np.float32(qw[q, s, p] * sc))
                        if qf is not None:
                            cnt += float(qf[q, s, p])
                        docs[d] = (tot, cnt)
            cand = []
            for d, (tot, cnt) in docs.items():
                if qf is not None:
                    v = np.float32(tot + addend[s, q, d])
                    cov = np.float32(np.float32(cnt) + hp[s, q, d])
                    if live[s, d] and abs(cov - nm[q]) < 0.5 and v > 0:
                        cand.append((v, d))
                elif tot > 0 and live[s, d]:
                    v = tot if addend is None else \
                        np.float32(tot + addend[s, q, d])
                    cand.append((v, d))
            cand.sort(key=lambda x: (-x[0], x[1]))
            for j, (v, d) in enumerate(cand[:k]):
                out_s[s, q, j] = v
                out_d[s, q, j] = d
    return out_s, out_d


# name -> (partitions S, rows R of acc, docs, terms, blocks of a one-run
# term (None: drawn), with ids / rows outside the arrays, pool): one run
# when pool is None ("overflow": one term of 8,192 blocks, which the grid
# walks in several steps; "columns": a term a destination row); else a
# run a term, the terms' docs drawn from the first `pool` docs so that
# runs into one row share docs ("multi": one row, dense terms; "runs100":
# 100 rare terms; "mixed": runs into 4 rows, a row's runs sharing docs;
# "runs2500": 2,500 short runs; "wide": a few runs of about a thousand
# blocks)
WEIGHTED_SCATTER_CASES = {
    "overflow": (2, 1, 2_000_000, 1, 8192, False, None),
    "columns": (3, 9, 50_000, 8, None, False, None),
    "outside": (2, 4, 20_000, 3, None, True, None),
    "multi": (2, 1, 30_000, 6, None, False, 30_000),
    "runs100": (2, 1, 200_000, 100, None, False, 4_000),
    "mixed": (3, 4, 20_000, 10, None, True, 12_000),
    "runs2500": (1, 2, 10_000, 2500, None, False, 2_000),
    "wide": (2, 1, 400_000, 4, None, False, 400_000),
}


def weighted_scatter_inputs(name, seed=0):
    """Seeded K11 inputs: (acc [S, R, D] f32 with nonzero starting values,
    block_ids [S, C] i32, weights [S, C] f32, rows [S, C] i32 or None,
    block_docs [S, T, 128], block_scores, runs). Without a pool: one run
    (runs None), one term a destination row, the terms' blocks back to
    back, 5 pad slots (block 0) at the end. With one: a run a term, in
    term order, as the overflow path builds them (each term's span as
    wide as its most blocks in a partition, the rest padded with block 0
    at its weight), runs = the spans' offsets. "outside" cases add ids
    past T and negative, and rows outside [0, R)."""
    S, R, n_docs, n_terms, width, outside, pool = \
        WEIGHTED_SCATTER_CASES[name]
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(S):
        rows_d, rows_s, spans = [np.zeros((1, 128), np.int32)], \
            [np.zeros((1, 128), np.float32)], []
        start = 1
        for t in range(n_terms):
            if pool is None:
                df = (width * 128 - 300 if width else
                      int(rng.integers(200, n_docs // 4)))
                bd, bs = _term_blocks(rng, n_docs, df, False)
            else:
                df = int(rng.integers(1, max(2, pool // 3)))
                docs = np.sort(rng.choice(pool, df, replace=False))
                bd = np.zeros((-(-df // 128), 128), np.int32)
                bs = np.zeros(bd.shape, np.float32)
                bd.ravel()[:df] = docs
                bs.ravel()[:df] = rng.uniform(0.2, 2.2, df)
            rows_d.append(bd)
            rows_s.append(bs)
            spans.append((start, len(bd)))
            start += len(bd)
        parts.append((np.concatenate(rows_d), np.concatenate(rows_s), spans))
    T = max(len(p[0]) for p in parts)
    block_docs = np.zeros((S, T, 128), np.int32)
    block_scores = np.zeros((S, T, 128), np.float32)
    for s, (bd, bs, _) in enumerate(parts):
        block_docs[s, : len(bd)] = bd
        block_scores[s, : len(bs)] = bs
    tw = rng.uniform(0.2, 4.0, n_terms).astype(np.float32)
    if pool is None:
        runs = None
        C = max(sum(cnt for _, cnt in p[2]) for p in parts) + 5
        offs = None
    else:
        widths = [max(p[2][t][1] for p in parts) for t in range(n_terms)]
        runs = np.cumsum([0] + widths).astype(np.int32)
        C = int(runs[-1])
    ids = np.zeros((S, C), np.int32)
    w = np.zeros((S, C), np.float32)
    rows = np.zeros((S, C), np.int32)
    for s, (_, _, spans) in enumerate(parts):
        off = 0
        for t, (st, cnt) in enumerate(spans):
            if runs is not None:
                off = int(runs[t])
                w[s, off: runs[t + 1]] = tw[t]
                rows[s, off: runs[t + 1]] = t % R
            ids[s, off: off + cnt] = np.arange(st, st + cnt)
            w[s, off: off + cnt] = tw[t]
            rows[s, off: off + cnt] = t % R
            off += cnt
    if outside:
        ids[:, -3:] = [T, T + 1000, -5]
        rows[:, :4] = [R, -1, R + 7, 0]
    acc = rng.uniform(0.0, 2.0, (S, R, n_docs)).astype(np.float32)
    return (acc, ids, w, None if R == 1 else rows, block_docs, block_scores,
            runs)


def weighted_scatter_numpy(acc, ids, w, rows, bd, bs, runs):
    """K11's contract as numpy statements: the runs in order, each slot's
    live lanes (score > 0, doc in [0, D), id in [0, T), row in [0, R))
    added to acc one slot after another, acc + w * score rounded to f32
    at each step. Returns the updated copy."""
    want = acc.copy()
    S, R, D = acc.shape
    T = bd.shape[1]
    offs = [0, ids.shape[1]] if runs is None else list(runs)
    for a, b in zip(offs[:-1], offs[1:]):
        for s in range(S):
            for c in range(a, b):
                blk, r = ids[s, c], 0 if rows is None else rows[s, c]
                if not (0 <= blk < T and 0 <= r < R):
                    continue
                sc = bs[s, blk]
                d = bd[s, blk]
                m = (sc > 0) & (d >= 0) & (d < D)
                want[s, r, d[m]] = (want[s, r, d[m]]
                                    + np.float32(w[s, c]) * sc[m])
    return want


class _Partition:
    """The partition shape build_stacked_bm25 reads: n_docs and postings."""

    def __init__(self, n_docs, fp):
        self.n_docs = n_docs
        self.postings = {"body": fp}


def blockmax_partitions(n_parts=2, n_docs=6000, vocab=400, seed=67):
    """Seeded BlockMax partitions of Zipf(1.07) docs of 4-40 terms over
    `vocab` terms, as tests/test_torch_blockmax.py draws its corpus: a few
    hot terms (df over an eighth of the docs) and many rare ones. Returns
    (partitions, the term names)."""
    from elasticsearch_tpu_torch.index.segment import build_field_postings

    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1) ** 1.07
    p /= p.sum()
    names = [f"t{i}" for i in range(vocab)]
    parts = []
    for _ in range(n_parts):
        lens = rng.integers(4, 40, n_docs).astype(np.int64)
        toks = rng.choice(vocab, int(lens.sum()), p=p).astype(np.int64)
        docs = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
        parts.append(_Partition(n_docs, build_field_postings(
            "body", lens, docs, toks, names)))
    return parts, names


# F1-F3, the fused sweeps: partitions of their own (nsw, Hpt), one QC.
# The last six are the edges of F1 and F3's cluster kernel: QC 1 and 8
# (with dead padding), a tile's union past one batch (the planner splits
# it), staged lists past the tile's FUSED_LIST (the rest direct), row
# groups no query keeps (zero columns: empty bitsets, every mask word 0),
# and integer-path queries (a negative qscale, weights past fast_query)
FUSED_CASES = {
    "three": (8, ((2, 33), (1, 9), (2, 17))),
    "qc24": (24, ((1, 33), (3, 40))),       # QC not a multiple of G
    "wide": (16, ((1, 700), (2, 33))),      # a cache past the list floor
    "many": (8, ((1, 9),) * 70),            # past MAX_FUSED_PARTS
    "qc1": (1, ((2, 33), (1, 17))),
    "qc8": (8, ((3, 40), (1, 9), (2, 97))),
    "union": (64, ((1, 300), (1, 41))),
    "lists": (24, ((1, 200),)),
    "skip": (12, ((2, 33), (1, 17))),
    "intpath": (12, ((2, 33),)),
}


def fused_inputs(case, pad_qc=None):
    """One fused launch's inputs: per partition sweep_inputs' columns and
    live mask, its weights stacked on a partition axis padded to the widest
    cache, K7's nreq / wp (a required slot and a must_not among a query's
    weighted slots), and K5's clause slots (clause_slots, partition-local,
    over each partition's Hp = Hpt - 1; slot Hp zero, as the engine keeps
    it). `pad_qc` appends inert queries up to that QC (no weight, qscale
    1, the zero sentinel as every clause), as the engine pads a batch.
    Returns a dict of numpy arrays:
    qscale [S, QC, 1], wq [S, 2, QC, Hw], nreq [S, QC, 1], wp [S, QC, Hw],
    q_slots [S, QC, 8], q_neg [S, QC, 4], and lists hi, lo, live, nsw."""
    qc, parts = FUSED_CASES[case]
    if pad_qc is not None and pad_qc > qc:
        out = fused_inputs(case)
        n = pad_qc - qc
        S = len(parts)
        for name, fill in (("qscale", 1), ("wq", 0), ("nreq", 0), ("wp", 0)):
            a = out[name]
            ax = 2 if name == "wq" else 1
            shape = list(a.shape)
            shape[ax] = n
            out[name] = np.concatenate([a, np.full(shape, fill, a.dtype)],
                                       axis=ax)
        for name in ("q_slots", "q_neg"):
            a = out[name]
            zero = np.array([h - 1 for _, h in parts], np.int32)
            extra = np.broadcast_to(zero[:, None, None],
                                    (S, n, a.shape[2]))
            out[name] = np.concatenate([a, extra], axis=1)
        return out
    seed = 60 + list(FUSED_CASES).index(case)
    rng = np.random.default_rng(seed)
    S, hw = len(parts), max(h for _, h in parts)
    out = {"qscale": np.ones((S, qc, 1), np.float32),
           "wq": np.zeros((S, 2, qc, hw), np.int8),
           "nreq": np.zeros((S, qc, 1), np.int32),
           "wp": np.zeros((S, qc, hw), np.int8),
           "q_slots": np.zeros((S, qc, k.BITSET_CLAUSES), np.int32),
           "q_neg": np.zeros((S, qc, k.BITSET_NEGS), np.int32),
           "hi": [], "lo": [], "live": [], "nsw": []}
    for i, (nsw, hpt) in enumerate(parts):
        qs, hi, lo, wq, live = sweep_inputs(seed * 100 + i, qc=qc, hpt=hpt,
                                            nsw=nsw)
        if case == "wide" and i == 0:
            wq[:, :4] = rng.integers(-127, 128, size=(2, 4, hpt))
        elif case in ("union", "lists") and i == 0:
            # fast queries of many slots: small hi weights
            n_sl = 6 if case == "union" else 60
            wq[:] = 0
            for q in range(qc - 1):
                sl = rng.choice(hpt - 1, size=n_sl, replace=False)
                wq[0, q, sl] = rng.integers(1, 9, size=n_sl)
                wq[1, q, sl] = rng.integers(-127, 128, size=n_sl)
        elif case == "qc1":
            # sweep_inputs leaves the last query without weights
            sl = rng.choice(hpt - 1, size=2, replace=False)
            wq[0, 0, sl] = rng.integers(1, 128, size=2)
            wq[1, 0, sl] = rng.integers(-127, 128, size=2)
        elif case == "skip":
            hi[5:20] = 0              # chunks 5-19: no term, no bit
            lo[5:20] = 0
        elif case == "intpath":
            qs[1] = -qs[1]
            sl = rng.choice(hpt - 1, size=20, replace=False)
            wq[0, 2, sl] = 127
            wq[1, 2, sl] = rng.integers(-127, 128, size=20)
        # slot Hp is the engine's scratch slot, always zero: the bitsets'
        # zero sentinel, which K5 takes as empty without reading it
        hi[:, hpt - 1] = 0
        lo[:, hpt - 1] = 0
        wq[:, :, hpt - 1] = 0
        out["qscale"][i] = qs
        out["wq"][i, :, :, :hpt] = wq
        for q in range(qc):
            slots = np.nonzero(wq[0, q])[0]
            if len(slots):
                out["wp"][i, q, slots[0]] = 1
                out["nreq"][i, q, 0] = 1
            other = int(rng.integers(0, hpt - 1))
            if not len(slots) or other != slots[0]:
                out["wp"][i, q, other] = -2
        q_slots, q_neg = clause_slots(seed * 100 + i, max(qc, 6), hpt - 1)
        if case == "qc1":
            q_slots[0] = 0             # not the inactive row
        elif case == "skip":
            q_slots[1] = 1             # no query keeps every row
        out["q_slots"][i], out["q_neg"][i] = q_slots[:qc], q_neg[:qc]
        for name, a in (("hi", hi), ("lo", lo), ("live", live)):
            out[name].append(a)
        out["nsw"].append(nsw)
    return out


def fused_plan_of(case, mode="disj"):
    """kernels.fused_sweep_plan for a FUSED_CASES entry."""
    qc, parts = FUSED_CASES[case]
    return k.fused_sweep_plan(qc, max(h for _, h in parts), mode)


# F2's edges for the fused sweeps: conj_edge_inputs' cases (coverage-only
# filters and queries with no score weight, a must_not in every doc of a
# query's top row, nreq 0, the integer path and a qscale <= 0, QC 256 of
# which 128 are padding), each a partition beside a conj_inputs partition
# of another (nsw, Hpt); and cover_union, a tile whose score slots fit one
# batch but whose score and coverage slots do not
FUSED_CONJ_CASES = ("filters", "must_not_top", "nreq0", "int_path",
                    "padding", "cover_union")


def _cover_union_partition(seed, qc=64, hpt=250, n_score=40):
    """One partition of cover_union: qc - 1 fast conjunctions, each two
    score slots among the first n_score (+1 coverage each) and three
    coverage-only filters among the rest (dense columns), nreq 5; the last
    query inert."""
    qscale, nreq, hi, lo, wq, wp, live = conj_inputs(seed, qc, hpt, 1)
    rng = np.random.default_rng(seed + 7)
    wq[:] = 0
    wp[:] = 0
    nreq[:] = 0
    for q in range(qc - 1):
        sc = rng.choice(n_score, size=2, replace=False)
        wq[0, q, sc] = rng.integers(1, 9, size=2)
        wq[1, q, sc] = rng.integers(-127, 128, size=2)
        filt = n_score + rng.choice(hpt - n_score - 1, size=3, replace=False)
        wp[q, sc] = 1
        wp[q, filt] = 1
        nreq[q, 0] = 5
    dense = rng.random(hi[:, n_score:].shape) < 0.8
    hi[:, n_score:] = np.where(dense, 1, 0)
    return qscale, nreq, hi, lo, wq, wp, live, 1


def fused_conj_inputs(case, pad_qc=None):
    """One F2 launch's inputs for a FUSED_CONJ_CASES entry, as
    fused_inputs returns them (qscale, wq, nreq, wp stacked on a partition
    axis padded to the widest cache; lists hi, lo, live, nsw); `pad_qc`
    appends inert queries up to that QC."""
    i = FUSED_CONJ_CASES.index(case)
    if case == "cover_union":
        parts = [_cover_union_partition(90), _cover_union_partition(91,
                                                                   hpt=120)]
    else:
        first = conj_edge_inputs(case)
        qc = first[4].shape[1]
        second = conj_inputs(80 + i, qc, (17, 40, 9, 33, 25)[i],
                             (1, 2, 1, 1, 2)[i]) + ((1, 2, 1, 1, 2)[i],)
        if case == "padding":         # the engine pads every partition
            second[4][:, 128:] = 0
            second[5][128:] = 0
            second[1][128:] = 0
            second[0][128:] = 1.0
        parts = [first, second]
    qc = parts[0][4].shape[1]
    hw = max(p[2].shape[1] for p in parts)
    S = len(parts)
    out = {"qscale": np.stack([p[0] for p in parts]),
           "nreq": np.stack([p[1] for p in parts]),
           "wq": np.zeros((S, 2, qc, hw), np.int8),
           "wp": np.zeros((S, qc, hw), np.int8),
           "hi": [p[2] for p in parts], "lo": [p[3] for p in parts],
           "live": [p[6] for p in parts], "nsw": [p[7] for p in parts]}
    for z, p in enumerate(parts):
        out["wq"][z, :, :, :p[4].shape[2]] = p[4]
        out["wp"][z, :, :p[5].shape[1]] = p[5]
    if pad_qc is not None and pad_qc > qc:
        n = pad_qc - qc
        for name, fill, ax in (("qscale", 1, 1), ("nreq", 0, 1),
                               ("wq", 0, 2), ("wp", 0, 1)):
            a = out[name]
            shape = list(a.shape)
            shape[ax] = n
            out[name] = np.concatenate(
                [a, np.full(shape, fill, a.dtype)], axis=ax)
    return out


def _staged_row_bits(slots, wh, wl, h_sw, l_sw, gate, qs):
    """One staged query's 512 row values in one superwindow as the cluster
    kernel forms them: T = sum W (128 h + l), W = 128 wh + wl, exact in
    int64 (int32 on the card: fast_query bounds it below 2^31), over the
    docs `gate` keeps (a dropped doc's T is 0); the row's max T, m, as
    fl(fl(m) * qs) where m > 0 and that is > 0. Returns bits (0: none)."""
    f = np.float32
    w = 128 * wh[slots] + wl[slots]                              # [n]
    c = 128 * h_sw[slots].astype(np.int64) + l_sw[slots]       # [n, 512, 128]
    t = np.tensordot(w, c, 1) * gate                             # [512, 128]
    m = np.maximum(t.max(axis=1), 0)
    assert np.abs(t).max() < 2 ** 31
    val = (m.astype(f) * f(qs)).astype(f)
    return np.where((m > 0) & (val > 0), val.view(np.uint32), np.uint32(0))


# the cluster kernel's batch planner, mirrored in kernels
fused_batches = k.fused_batches


def emulate_fused_sweep(qscale, wq, hi, lo, live, nsw, mask=None,
                        stats=None, nreq=None, wp=None):
    """numpy emulation of sweep_rowmax.cu's fused_sweep_kernel (F1; F3's
    sweep with `mask`, each partition's K5 output [QC, nsw_max * 16, 128]
    stacked; F2 with `nreq` [S, QC, 1] and `wp` [S, QC, ws]), cluster by
    cluster: tiles of the plan's gq queries; each rank's own queries (j =
    rank mod FUSED_CLUSTER) with their counts, their lists (sweep_list:
    F2's score-only, score and coverage, then coverage-only slots, empty
    for a query with no score weight) while the rank's lc holds them, the
    staged ones (fast, a list within slot_cap, the tile's candidates' lists
    within lc) in order then the direct ones; the staged ones in
    fused_batches over their whole lists (F2: the union of score and
    coverage slots), each batch's union staged a row group at a time (F3:
    only the row groups a query of the batch keeps); each query's gate
    (live; F3 its mask's bits; F2 cov = sum wp * ((hi | lo) != 0) over the
    list's coverage part == nreq, from the staged bytes), then its score
    part scored by _staged_row_bits, the direct ones by _row_bits
    (sweep_group_kernel's paths); each rank's 64 rows, and the selection
    over the 512 with lane l holding rows l + 32 k of rank k / 2. `stats`
    (a dict) counts batches, staged and direct queries, stages copied and
    skipped, and F2's dead stages (no query of the batch keeps a doc of
    the row group). Returns (rowmax, rows) [S, nsw_max, QC, CAND_PAD]."""
    S, qc = wq.shape[0], wq.shape[2]
    hpts = [h.shape[1] for h in hi]
    mode = "bitset" if mask is not None else "conj" if wp is not None \
        else "disj"
    plan = k.fused_sweep_plan(qc, max(hpts), mode)
    cl, rb, r = k.FUSED_CLUSTER, k.SW_ROWS // k.FUSED_CLUSTER, \
        k.FUSED_STAGE_ROWS
    nsw_max = max(nsw)
    rm = np.full((S, nsw_max, qc, k.CAND_PAD), -np.inf, np.float32)
    rr = np.zeros((S, nsw_max, qc, k.CAND_PAD), np.int32)
    st = stats if stats is not None else {}
    for key in ("batches", "direct", "staged", "stages", "skipped_stages",
                "dead_stages"):
        st.setdefault(key, 0)
    lanes = np.arange(32)
    for z in range(S):
        hpt = hpts[z]
        wh = wq[z, 0, :, :hpt].astype(np.int64)
        wl = wq[z, 1, :, :hpt].astype(np.int64)
        wc = None if wp is None else wp[z, :, :hpt].astype(np.int64)
        for sw in range(nsw[z]):
            alive = live[z][sw * k.SW_ROWS:(sw + 1) * k.SW_ROWS] > 0
            cs = slice(sw * k.N_CHUNKS, (sw + 1) * k.N_CHUNKS)
            h_sw = hi[z][cs].transpose(1, 0, 2, 3).reshape(hpt, k.SW_ROWS, 128)
            l_sw = lo[z][cs].transpose(1, 0, 2, 3).reshape(hpt, k.SW_ROWS, 128)
            for w0 in range(0, qc, plan["gq"]):
                ng = min(plan["gq"], qc - w0)
                info = []
                for j in range(ng):
                    q = w0 + j
                    slots, n_score, c0 = sweep_list(q, wh, wl, wc)
                    qs = float(qscale[z, q, 0])
                    fast = (16512 * np.abs(wh[q]).sum()
                            + 128 * np.abs(wl[q]).sum() < 2 ** 24
                            and qs > 0)
                    info.append((q, slots, qs, fast, n_score, c0))
                # each rank's own offsets: candidates in its order while
                # their lists add up to lc
                own_ok = {}
                for rank in range(cl):
                    e = 0
                    for j in range(rank, ng, cl):
                        n = len(info[j][1])
                        ln = n if info[j][3] and 0 < n <= plan["slot_cap"] \
                            else 0
                        e += ln
                        own_ok[j] = ln > 0 and e <= plan["lc"]
                staged, e = [], 0
                for j in range(ng):
                    ln = len(info[j][1]) if own_ok[j] else 0
                    e += ln
                    if ln and e <= plan["lc"]:
                        staged.append(j)
                direct = [j for j in range(ng)
                          if len(info[j][1]) and j not in staged]
                order = staged + direct
                st["staged"] += len(staged)
                st["direct"] += len(direct)
                vals = np.zeros((len(order), k.SW_ROWS), np.uint32)
                keep = np.ones((len(order), k.SW_ROWS), bool)
                gates = {}
                for t, j in enumerate(order):
                    q, slots, _, _, _, c0 = info[j]
                    g = alive
                    if mask is not None:
                        words = mask[z, q, sw * k.SW_WORD_ROWS:
                                     (sw + 1) * k.SW_WORD_ROWS].view(np.uint32)
                        bit = (np.arange(k.SW_ROWS) % 32).astype(np.uint32)
                        kept = ((words[np.arange(k.SW_ROWS) // 32]
                                 >> bit[:, None]) & 1) != 0
                        keep[t] = kept.any(axis=1)
                        g = alive & kept
                    if wc is not None:
                        cov_s = slots[c0:]
                        present = (h_sw[cov_s] != 0) | (l_sw[cov_s] != 0)
                        cov = np.tensordot(wc[q][cov_s],
                                           present.astype(np.int64), 1)
                        g = alive & (cov == int(nreq[z, q, 0]))
                    gates[t] = g
                batches = fused_batches([info[j][1] for j in staged],
                                        plan["slot_cap"])
                st["batches"] += len(batches)
                for b in batches:
                    doc_kept = np.stack([gates[t].any(axis=1) for t in b])
                    for rank in range(cl):
                        for g0 in range(rank * rb, (rank + 1) * rb, r):
                            rows = slice(g0, g0 + r)
                            if not keep[b][:, rows].any():
                                st["skipped_stages"] += 1
                                continue
                            st["stages"] += 1
                            st["dead_stages"] += int(
                                not doc_kept[:, rows].any())
                    for t in b:
                        q, slots, qs, _, n_score, _ = info[order[t]]
                        v = _staged_row_bits(slots[:n_score], wh[q], wl[q],
                                             h_sw, l_sw, gates[t], qs)
                        vals[t] = np.where(keep[t], v, 0)
                for t in range(len(staged), len(order)):
                    q, slots, qs, _, n_score, _ = info[order[t]]
                    vals[t] = _row_bits(q, slots[:n_score], wh, wl, h_sw,
                                        l_sw, gates[t], qs)
                tof = {j: t for t, j in enumerate(order)}
                for j in range(ng):
                    q = w0 + j
                    if j not in tof:
                        continue                # -inf rows, row 0
                    # lane l: rows l + 32 k, rank k // 2's local row
                    # l + 32 (k & 1)
                    v = vals[tof[j]].reshape(k.SW_ROWS // 32, 32).copy()
                    for p in range(k.NCAND):
                        bt = v.argmax(axis=0)
                        best = v[bt, lanes]
                        m = best.max()
                        if m == 0:
                            break
                        c = np.where(best == m,
                                     k.SW_ROWS - (lanes + 32 * bt), 0)
                        row = k.SW_ROWS - int(c.max())
                        rm[z, sw, q, p] = np.uint32(m).view(np.float32)
                        rr[z, sw, q, p] = row + sw * k.SW_ROWS
                        v[row >> 5, row & 31] = 0
    return rm, rr
