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
