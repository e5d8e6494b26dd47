"""Block-max culled BM25 serving, the engine for indexes whose Turbo columns
exceed the device budget (the port of elasticsearch_tpu/parallel/blockmax.py).

Device memory holds the postings themselves — O(postings), not O(terms x
docs) like a dense column cache — and every query batch runs two passes:

  pass A  score each term's single best block (by block-max) -> partial
          top-k -> theta[q] = the k-th partial score, a LOWER bound on the
          true k-th total score (partial sums understate totals).
  select  host-side: keep block b of term i iff
              idf_i * block_max[b] + sum_{j != i} term_max_j >= theta
          Any doc whose contribution from some term was dropped provably
          cannot reach theta, so scoring only kept blocks is EXACT.
  pass B  score the kept blocks' lanes per doc, top-k.

Terms with df > total_docs/8 ("hot") also keep a dense impact column on the
device; their contribution `W @ hot_cols` (an ordered f32 sum, `_dense`) is
added to each doc's lane total, and the final top-k merges the dense-only
candidates with the lane candidates, deduplicating by doc.

The host code (term metadata, hot columns, assembly, culling, grouping, the
host bool and phrase paths) is the reference's. The device programs are
torch code on the one card, partitions stacked (no mesh, no dp), with two
hand kernels where no single torch call does the work: K10 `lane_topk`
scores and ranks each (partition, query) row's lanes, where the reference
sorts them by doc and sums runs with a log-step scan; K11
`weighted_block_scatter` is the overflow path's accumulate step. Partitions
merge through K4. Rows are not padded to a dispatch size (the reference pads
them for XLA's compile cache); the compile telemetry keeps the padded size
in its shape key. Empty result slots are (0, 0, 0), K4's, where the
reference's device programs leave -inf scores.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common import faults, hbm_ledger, integrity
from elasticsearch_tpu_torch.common.health import EngineHealth
from elasticsearch_tpu_torch.ops import bm25_idf, next_bucket

HOT_DF_FRACTION = 8     # df > total_docs/8 -> dense column
PASS_A_BLOCKS = 8       # blocks per query in the theta-estimation pass
_HOST_CONJ_DF = 1 << 16  # rarest required term below this -> host conjunction

# (block-bucket B, queries per dispatch Qc): lane work per dispatch stays
# ~bounded (B*128*Qc lanes) so a handful of heavy queries can't inflate the
# work of thousands of light ones
_GROUP_SHAPES = [(32, 512), (512, 64), (8192, 8), (32768, 4)]
_MAX_BUCKET = _GROUP_SHAPES[-1][0]


def _group_shape(n_blocks: int):
    for b, qc in _GROUP_SHAPES:
        if n_blocks <= b:
            return b, qc
    return _GROUP_SHAPES[-1]


@dataclass
class _ShardBlocks:
    """One term's block metadata on one partition (all host arrays)."""

    ids: np.ndarray        # [nb] i32 block rows, doc order
    ub: np.ndarray         # [nb] f32 idf-free block-max scores
    lo: np.ndarray         # [nb] i32 first doc ord per block
    hi: np.ndarray         # [nb] i32 last doc ord per block
    docs: np.ndarray       # [df] i32 sorted doc ords (view into post_doc)
    smax: float            # max ub on this partition
    scores: np.ndarray | None = None   # [df] f32 lane scores, built lazily
    #   for the host conjunction


_EMPTY_BLOCKS = _ShardBlocks(np.empty(0, np.int32), np.empty(0, np.float32),
                             np.empty(0, np.int32), np.empty(0, np.int32),
                             np.empty(0, np.int32), 0.0)


@dataclass
class _TermMeta:
    """Host metadata for one (global) term across partitions."""

    idf: float
    hot_slot: int                       # -1 if not hot
    blocks: List[_ShardBlocks]          # per partition
    max_ub: float                       # max idf-free block-max over partitions


def _pack(top_s, top_p, top_o) -> np.ndarray:
    """K4's device outputs -> host [Q, 3, k] f32 rows (score, partition,
    ord); ids < 2^24 are exact as f32 values."""
    return torch.stack([top_s, top_p.float(), top_o.float()],
                       dim=1).cpu().numpy()


def _ids(a: np.ndarray) -> np.ndarray:
    return a.astype(np.int32)


class BlockMaxBM25:
    """Serving-path executor for one text field over stacked partitions
    (a StackedBM25 built with device_arrays=True) on `device`."""

    kind = "blockmax"

    def __init__(self, stacked, device=None):
        from elasticsearch_tpu_torch import device as _device

        assert stacked.block_max_scores is not None, \
            "StackedBM25 built without device_arrays"
        self.stacked = stacked
        self.device = _device.resolve(device if device is not None
                                      else stacked.device)
        if stacked.device != self.device:
            raise ValueError(f"the stacked arrays are on {stacked.device}, "
                             f"not {self.device}")
        self.S = stacked.n_shards
        self.D = stacked.max_docs
        # cap for programs that materialize [Qc, D] dense intermediates
        # (hot matmul + top-k temporaries, ~12 bytes/element)
        cap = int(4e9 / (12.0 * max(self.D, 1)))
        self._qc_dense_cap = 8
        while self._qc_dense_cap * 2 <= min(cap, 512):
            self._qc_dense_cap *= 2
        self._terms: Dict[str, _TermMeta] = {}
        # circuit state lives here, enforced by the serving layer (this
        # engine has no internal host tier — the dense executor is its
        # fallback)
        self.health = EngineHealth("blockmax")
        self._build_hot_columns()
        # device-memory ledger: regions mirror hbm_bytes() exactly
        self._hbm = hbm_ledger.register_engine(self, "blockmax")
        self._hbm.set_region("block_docs", _nbytes(stacked.block_docs))
        self._hbm.set_region("block_scores", _nbytes(stacked.block_scores))
        self._hbm.set_region("live", _nbytes(stacked.live))
        self._hbm.set_region("hot_cols", _nbytes(self.hot_cols))
        # integrity plane: hot_cols is this engine's own upload — scrub it
        # against a per-epoch baseline and repair by a deterministic
        # rebuild from host postings; repeated mismatches trip `health`.
        # The scrubber reads host bytes, so the callable hands it a copy.
        integrity.register_scrub_region(
            self, "hot_cols", lambda o: o.hot_cols.cpu().numpy(),
            epoch=lambda o: id(o.hot_cols),
            repair=lambda o: o._build_hot_columns())
        integrity.attach_scrub_health(self, self.health)

    # ---------------- build ----------------

    def _term_meta(self, term: str) -> _TermMeta | None:
        meta = self._terms.get(term)
        if meta is not None:
            return meta
        st = self.stacked
        df = 0
        blocks: List[_ShardBlocks] = []
        max_ub = 0.0
        for s in range(self.S):
            fp = st.postings[s]
            o = fp.ord(term)
            if o < 0:
                blocks.append(_EMPTY_BLOCKS)
                continue
            df += int(fp.doc_freq[o])
            start, cnt = int(fp.block_start[o]), int(fp.block_count[o])
            ids = np.arange(start, start + cnt, dtype=np.int32)
            ub = st.block_max_scores[s][start: start + cnt]
            docs = fp.post_doc[int(fp.post_start[o]): int(fp.post_start[o + 1])]
            # block doc ranges: docs ascend within a term; trailing pad lanes
            # are zeros so the row max is the true last doc
            bd = fp.block_docs[start: start + cnt]
            smax = float(ub.max()) if cnt else 0.0
            blocks.append(_ShardBlocks(
                ids=ids, ub=ub, lo=bd[:, 0].copy(),
                hi=bd.max(axis=1), docs=docs, smax=smax))
            max_ub = max(max_ub, smax)
        if df == 0:
            return None
        idf = bm25_idf(st.total_docs, df)
        meta = _TermMeta(idf=idf, hot_slot=self._hot_slots.get(term, -1),
                         blocks=blocks, max_ub=max_ub)
        self._terms[term] = meta
        return meta

    def _build_hot_columns(self) -> None:
        """Dense idf-free impact columns for stopword-grade terms."""
        st = self.stacked
        threshold = max(st.total_docs // HOT_DF_FRACTION, 1)
        # global df per term over partitions
        df_by_term: Dict[str, int] = {}
        for fp in st.postings:
            for t, o in fp.term_to_ord.items():
                df_by_term[t] = df_by_term.get(t, 0) + int(fp.doc_freq[o])
        hot = sorted(t for t, df in df_by_term.items() if df > threshold)
        self._hot_slots = {t: i for i, t in enumerate(hot)}
        H = next_bucket(max(len(hot), 1), minimum=4)
        cols = torch.zeros((self.S, H, self.D), dtype=torch.float32,
                           device=self.device)
        for s in range(self.S):
            fp = st.postings[s]
            bs = self._host_bs(s)
            for t in hot:
                o = fp.ord(t)
                if o < 0:
                    continue
                start, cnt = int(fp.block_start[o]), int(fp.block_count[o])
                docs = fp.block_docs[start: start + cnt].ravel()
                vals = bs[start: start + cnt].ravel()
                real = vals > 0
                cols[s, self._hot_slots[t],
                     torch.from_numpy(docs[real].astype(np.int64)).to(
                         self.device)] = torch.from_numpy(vals[real]).to(
                             self.device)
        self.hot_cols = cols
        self.n_hot_slots = H

    # ---------------- query assembly (host) ----------------

    def _assemble(self, queries: List[List[Tuple[str, float]]],
                  selections: List[Dict[str, List[np.ndarray] | None]] | None,
                  bucket: int, flags: bool = False):
        """Build (W [Q,H], qblocks [Q,S,B], qidf [Q,S,B], tstart
        [Q,S,R+1]) for a query group; tstart holds each (query, partition)
        row's term runs for K10 (a term's kept blocks, in doc order).

        queries: per query, list of (term, boost) with unique terms. When
        selections is None, pass-A assembly: each sparse term contributes its
        single best block per partition. Otherwise selections[q][term] is a
        per-partition list of keep masks (None = keep all blocks)."""
        Q = len(queries)
        W = np.zeros((Q, self.n_hot_slots), np.float32)
        qblocks = np.zeros((Q, self.S, bucket), np.int32)
        qidf = np.zeros((Q, self.S, bucket), np.float32)
        R = max([sum(1 for t, _ in terms
                     if (m := self._terms.get(t)) is not None
                     and m.hot_slot < 0) for terms in queries] + [1])
        tstart = np.zeros((Q, self.S, R + 1), np.int32)
        for qi, terms in enumerate(queries):
            offs = [0] * self.S
            r = 0
            for term, boost in terms:
                meta = self._terms.get(term)
                if meta is None:
                    continue
                w = meta.idf * boost
                if meta.hot_slot >= 0:
                    W[qi, meta.hot_slot] += w
                    continue
                tstart[qi, :, r] = offs
                for s in range(self.S):
                    sb = meta.blocks[s]
                    if not len(sb.ids):
                        continue
                    if selections is None:
                        j = int(np.argmax(sb.ub))
                        b = sb.ids[j: j + 1]
                    else:
                        masks = selections[qi].get(term)
                        mask = masks[s] if masks is not None else None
                        b = sb.ids if mask is None else sb.ids[mask]
                    n = len(b)
                    if offs[s] + n > bucket:
                        if selections is not None:
                            # pass-B truncation would drop blocks the culling
                            # proof requires — such queries must take the
                            # overflow path
                            raise RuntimeError(
                                f"blockmax bucket overflow: {offs[s] + n} kept "
                                f"blocks > bucket {bucket}; query should have "
                                "been routed to the exhaustive overflow path")
                        # pass-A truncation only weakens theta (a smaller
                        # partial top-k lower bound), never exactness
                        n = bucket - offs[s]
                        b = b[:n]
                    qblocks[qi, s, offs[s]: offs[s] + n] = b
                    qidf[qi, s, offs[s]: offs[s] + n] = w
                    offs[s] += n
                r += 1
            tstart[qi, :, r:] = np.asarray(offs, np.int32)[:, None]
        return W, qblocks, qidf, tstart

    def _select(self, queries: List[List[Tuple[str, float]]],
                theta: np.ndarray, check=None,
                ) -> Tuple[List[Dict[str, List[np.ndarray] | None]], int]:
        """Block-max culling with doc-range refinement (the BlockMaxWAND
        bound): block b of sparse term i survives iff

            w_i*ub_i(b) + sum_{j != i} [range(b) hits term j] * w_j*smax_j(s)
                >= theta

        Any doc whose term-i contribution was dropped then satisfies
        total < theta <= true k-th score, so pass B stays EXACT.
        Partitions split docs, so all bounds are per-partition. Returns keep
        masks plus the max per-(query, partition) surviving count."""
        sel: List[Dict[str, List[np.ndarray] | None]] = []
        max_total = 1
        for qi, terms in enumerate(queries):
            if check is not None and qi % 64 == 0:
                check()   # cooperative cancellation inside the host loop
            entries = [(t, b, self._terms.get(t)) for t, b in terms]
            entries = [(t, b, m) for t, b, m in entries if m is not None]
            th = float(theta[qi])
            keep_q: Dict[str, List[np.ndarray] | None] = {}
            totals = np.zeros(max(self.S, 1), np.int64)
            for t, boost, m in entries:
                if m.hot_slot >= 0:
                    continue
                w = m.idf * boost
                if not np.isfinite(th) or w <= 0:
                    keep_q[t] = None
                    for s in range(self.S):
                        totals[s] += len(m.blocks[s].ids)
                    continue
                masks: List[np.ndarray] = []
                for s in range(self.S):
                    sb = m.blocks[s]
                    if not len(sb.ids):
                        masks.append(np.empty(0, bool))
                        continue
                    bound = w * sb.ub.astype(np.float64)
                    for t2, b2, m2 in entries:
                        if t2 == t:
                            continue
                        w2 = m2.idf * b2
                        if m2.hot_slot >= 0:
                            bound = bound + w2 * m2.max_ub
                            continue
                        sb2 = m2.blocks[s]
                        if not len(sb2.docs):
                            continue
                        pres = (np.searchsorted(sb2.docs, sb.hi, "right")
                                > np.searchsorted(sb2.docs, sb.lo, "left"))
                        bound = bound + pres * (w2 * sb2.smax)
                    mask = bound >= th * (1.0 - 1e-6) - 1e-6
                    masks.append(mask)
                    totals[s] += int(mask.sum())
                keep_q[t] = masks
            sel.append(keep_q)
            max_total = max(max_total, int(totals.max()))
        return sel, max_total

    # ---------------- device programs ----------------

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _dense(self, W: np.ndarray) -> torch.Tensor:
        """[S, Qc, D] hot-term scores W @ hot_cols in full f32 (the
        reference asks for Precision.HIGHEST), as an ordered sum: each
        row adds its nonzero weights' products w * col in slot order,
        multiply and add rounded apart. A row's bits then depend on
        nothing else in its batch, so batched rows equal solo rows, as the
        reference's do; torch.matmul's CPU kernels fuse multiply-adds by
        batch size, and TF32 would move scores by about 1e-3 relative."""
        Q = W.shape[0]
        nz = W != 0
        J = max(int(nz.sum(axis=1).max(initial=0)), 1)
        idx = np.zeros((Q, J), np.int64)
        val = np.zeros((Q, J), np.float32)   # pads add 0 * col = +0
        for q in range(Q):
            h = np.nonzero(nz[q])[0]
            idx[q, : len(h)] = h
            val[q, : len(h)] = W[q, h]
        idx_t, val_t = self._t(idx), self._t(val)
        dense = None
        for j in range(J):
            term = self.hot_cols[:, idx_t[:, j], :]
            term.mul_(val_t[None, :, j, None])
            if dense is None:
                dense = term
            else:
                dense.add_(term)
                del term
        return dense

    def _topk_parts(self, cand1, cand2, k: int):
        """Per partition: merge the dense-only candidates and the lane
        candidates ([S, Q, k] each), dedup by doc keeping the larger
        score, rank by (score desc, doc asc), keep k."""
        ms = torch.cat([cand1[0], cand2[0]], dim=2)
        md = torch.cat([cand1[1].to(torch.int32), cand2[1]], dim=2)
        # order by (doc asc, score desc)
        o = torch.sort(ms, dim=2, descending=True, stable=True).indices
        ms, md = ms.gather(2, o), md.gather(2, o)
        o = torch.sort(md, dim=2, stable=True).indices
        ms, md = ms.gather(2, o), md.gather(2, o)
        first = torch.ones_like(md, dtype=torch.bool)
        first[:, :, 1:] = md[:, :, 1:] != md[:, :, :-1]
        fin = torch.where(first & (ms > float("-inf")), ms,
                          torch.full_like(ms, float("-inf")))
        # final rank by (score desc, doc asc): md is doc-ascending already
        o = torch.sort(fin, dim=2, descending=True, stable=True).indices[
            :, :, :k]
        return fin.gather(2, o), md.gather(2, o)

    def _dense_cands(self, masked: torch.Tensor, k: int):
        """[S, Q, k] top-k of masked dense scores, ties to the lower doc
        (`lax.top_k`'s order, as `_dense_topk_tiebreak`)."""
        from elasticsearch_tpu_torch.ops.knn import topk_lowest_index

        S, Q, D = masked.shape
        v, i = topk_lowest_index(masked.reshape(S * Q, D), k)
        return v.reshape(S, Q, k), i.reshape(S, Q, k)

    def _hybrid_program(self, W, qb, qw, ts, k: int) -> np.ndarray:
        """dense hot matmul + lane candidates -> exact merged top-k, packed
        [Q, 3, k] (`_hybrid_program` :1104)."""
        from elasticsearch_tpu_torch.parallel.kernels import lane_topk
        from elasticsearch_tpu_torch.parallel.spmd import merge_parts

        if not W.any():     # no hot term: the addend would be all zeros
            return self._lane_program(qb, qw, ts, k)
        st = self.stacked
        dense = self._dense(W)                                   # [S, Q, D]
        cand2 = lane_topk(st.block_docs, st.block_scores, st.live,
                          self._t(qb), self._t(qw), self._t(ts), k=k,
                          addend=dense)
        masked = torch.where(st.live[:, None, :] & (dense > 0), dense,
                             torch.full_like(dense, float("-inf")))
        del dense
        cand1 = self._dense_cands(masked, k)
        del masked
        return _pack(*merge_parts(*self._topk_parts(cand1, cand2, k), k))

    def _lane_program(self, qb, qw, ts, k: int) -> np.ndarray:
        """Pass B for query groups with no hot terms (`_lane_program`
        :1154): the lane top-k alone, then K4."""
        from elasticsearch_tpu_torch.parallel.kernels import lane_topk
        from elasticsearch_tpu_torch.parallel.spmd import merge_parts

        st = self.stacked
        ps, pd = lane_topk(st.block_docs, st.block_scores, st.live,
                           self._t(qb), self._t(qw), self._t(ts), k=k)
        return _pack(*merge_parts(ps, pd, k))

    def _bool_program(self, W, Wp, qb, qw, qf, ts, nm, k: int) -> np.ndarray:
        """Exact bool (conjunction + optional scorers), packed [Q, 3, k]
        (`_bool_program` :1054)."""
        from elasticsearch_tpu_torch.parallel.kernels import lane_topk
        from elasticsearch_tpu_torch.parallel.spmd import merge_parts

        st = self.stacked
        dense = self._dense(W)                                   # [S, Q, D]
        pres = torch.matmul(self._t(Wp), (self.hot_cols > 0).float())
        nm_t = self._t(nm)
        cand2 = lane_topk(st.block_docs, st.block_scores, st.live,
                          self._t(qb), self._t(qw), self._t(ts), k=k,
                          addend=dense, qf=self._t(qf), hp=pres, nm=nm_t)
        # dense-only candidates: all required terms hot-present, score > 0
        ok1 = (st.live[:, None, :] & (dense > 0)
               & ((pres - nm_t[None, :, None]).abs() < 0.5))
        del pres
        cand1 = self._dense_cands(
            torch.where(ok1, dense, torch.full_like(dense, float("-inf"))), k)
        del ok1, dense
        return _pack(*merge_parts(*self._topk_parts(cand1, cand2, k), k))

    # ---------------- search ----------------

    def search(self, queries: List[List[str]] | List[List[Tuple[str, float]]],
               k: int = 10):
        """Batched exact BM25 top-k. Returns (scores, partition, ord) [Q, k]."""
        return self.search_many([queries], k)[0]

    def search_many(self, batches: Sequence[List], k: int = 10,
                    check=None, fault_log=None):
        """Many query batches through the two-pass executor: every pass-A
        chunk, the thetas read back, the culling, then pass-B groups formed
        GLOBALLY across batches by surviving-block bucket (see
        _GROUP_SHAPES), so a heavy query rides a small dispatch with a few
        peers. Returns per batch: (scores [Q,k], partition [Q,k],
        ord [Q,k]). Wall-clock per phase lands in self.last_timing
        (seconds)."""
        import time as _time

        faults.fault_point("blockmax_pass")

        timing = {"assemble_a": 0.0, "theta_fetch": 0.0, "select": 0.0,
                  "assemble_dispatch_b": 0.0, "result_fetch": 0.0,
                  "overflow": 0.0, "n_queries": 0, "n_overflow": 0}
        self.last_timing = timing
        flat: List[List[Tuple[str, float]]] = []   # all queries, all batches
        spans = []                                 # (batch_idx, start, n)
        for bi, queries in enumerate(batches):
            spans.append((bi, len(flat), len(queries)))
            for q in queries:
                # unique (term, boost): duplicate terms merge their boosts
                agg: Dict[str, float] = {}
                for t in q:
                    t, b = (t, 1.0) if isinstance(t, str) else t
                    agg[t] = agg.get(t, 0.0) + b
                norm = list(agg.items())
                for t, _ in norm:
                    self._term_meta(t)
                flat.append(norm)
        if not flat:
            return []

        timing["n_queries"] = len(flat)
        # ---- pass A: each term's best block, in chunks of the dense cap ----
        t0 = _time.monotonic()
        qa_max = min(_GROUP_SHAPES[0][1], self._qc_dense_cap)
        thetas = np.zeros(len(flat), np.float32)
        for off in range(0, len(flat), qa_max):
            chunk = flat[off: off + qa_max]
            W, qb, qi_, ts = self._assemble(chunk, None, PASS_A_BLOCKS)
            packed = self._hybrid_program(W, qb, qi_, ts, k)
            thetas[off: off + len(chunk)] = packed[:, 0, k - 1]
        t1 = _time.monotonic()
        timing["assemble_a"] = t1 - t0
        t2 = _time.monotonic()
        timing["theta_fetch"] = t2 - t1

        # ---- selection, then global grouping by bucket ----
        selections, _ = self._select(flat, thetas, check=check)
        timing["select"] = _time.monotonic() - t2
        totals = np.zeros(len(flat), np.int64)
        for qi, terms in enumerate(flat):
            per_shard = np.zeros(max(self.S, 1), np.int64)
            for t, _ in terms:
                m = self._terms.get(t)
                if m is None or m.hot_slot >= 0:
                    continue
                masks = selections[qi].get(t)
                for s in range(self.S):
                    nb = len(m.blocks[s].ids)
                    if masks is not None and len(masks[s]):
                        nb = int(masks[s].sum())
                    per_shard[s] += nb
            totals[qi] = per_shard.max()

        # group key: (bucket shape, query-has-hot-terms) — lane-only groups
        # dispatch a program without the dense matmul / dense top-k
        groups: Dict[Tuple[Tuple[int, int], bool], List[int]] = {}
        overflow: List[int] = []
        for qi, tot in enumerate(totals):
            if int(tot) > _MAX_BUCKET:
                # more surviving blocks than the largest dispatch bucket:
                # take the chunked scatter-add path instead
                overflow.append(qi)
            else:
                has_hot = any(
                    (m := self._terms.get(t)) is not None and m.hot_slot >= 0
                    for t, _ in flat[qi])
                groups.setdefault((_group_shape(int(tot)), has_hot),
                                  []).append(qi)

        t3 = _time.monotonic()
        out_all = np.zeros((len(flat), 3, k), np.float32)
        for ((bucket, qc_max), has_hot), members in sorted(groups.items()):
            if has_hot:   # dense [Qc, D] intermediates: respect the cap
                qc_max = min(qc_max, self._qc_dense_cap)
            for off in range(0, len(members), qc_max):
                grp = members[off: off + qc_max]
                if check is not None:
                    check()
                W, qb, qi_, ts = self._assemble(
                    [flat[qi] for qi in grp], [selections[qi] for qi in grp],
                    bucket)
                # compile telemetry: (block bucket, the reference's padded
                # Qc, program flavor)
                qc = 8 if len(grp) <= 8 else qc_max
                shape_key = (bucket, qc, "hot" if has_hot else "lane")
                first_trace = hbm_ledger.note_dispatch("blockmax", shape_key)
                tb0 = _time.monotonic()
                if has_hot:
                    packed = self._hybrid_program(W, qb, qi_, ts, k)
                else:
                    packed = self._lane_program(qb, qi_, ts, k)
                if first_trace:
                    hbm_ledger.note_compile_done(
                        "blockmax", shape_key, _time.monotonic() - tb0)
                out_all[grp] = packed
        t4 = _time.monotonic()
        timing["assemble_dispatch_b"] = t4 - t3
        t5 = _time.monotonic()
        timing["result_fetch"] = t5 - t4
        timing["n_overflow"] = len(overflow)
        for qi in overflow:
            out_all[qi] = self._exhaustive_topk(flat[qi], selections[qi], k)
        timing["overflow"] = _time.monotonic() - t5

        results = []
        for bi, start, n in spans:
            packed = out_all[start: start + n]
            results.append((packed[:, 0].copy(), _ids(packed[:, 1]),
                            _ids(packed[:, 2])))
        return results

    def _exhaustive_topk(self, terms: List[Tuple[str, float]],
                         selection: Dict[str, List[np.ndarray] | None],
                         k: int) -> np.ndarray:
        """Exact fallback for block-heavy queries: every kept block's lanes
        scatter-added (K11) into a per-partition dense [D] accumulator in
        one call: the non-hot terms' kept blocks, one run a term in term
        order (each padded across partitions with block 0), so that a doc
        sums its terms in order, as the reference's scatter adds its chunk;
        then the hot matmul and one top-k. Returns packed [3, k] (score,
        partition, ord)."""
        from elasticsearch_tpu_torch.parallel.kernels import (
            weighted_block_scatter,
        )
        from elasticsearch_tpu_torch.parallel.spmd import merge_parts

        S = self.S
        st = self.stacked
        W = np.zeros((1, self.n_hot_slots), np.float32)
        kept: List[Tuple[List[np.ndarray], float]] = []   # a run a term
        for t, boost in terms:
            m = self._terms.get(t)
            if m is None:
                continue
            w = m.idf * boost
            if m.hot_slot >= 0:
                W[0, m.hot_slot] += w
                continue
            masks = selection.get(t)
            per: List[np.ndarray] = []
            for s in range(S):
                sb = m.blocks[s]
                mask = None if masks is None or not len(sb.ids) else masks[s]
                per.append(sb.ids if mask is None else sb.ids[mask])
            if max(len(b) for b in per):
                kept.append((per, w))
        acc = torch.zeros((S, 1, self.D), dtype=torch.float32,
                          device=self.device)
        if kept:
            offs = np.cumsum([0] + [max(len(b) for b in per)
                                    for per, _ in kept])
            qb = np.zeros((S, int(offs[-1])), np.int32)
            qw = np.empty((S, int(offs[-1])), np.float32)
            for (per, w), a, b in zip(kept, offs[:-1], offs[1:]):
                qw[:, a:b] = np.float32(w)
                for s, ids in enumerate(per):
                    qb[s, a: a + len(ids)] = ids
            weighted_block_scatter(acc, self._t(qb), self._t(qw),
                                   st.block_docs, st.block_scores,
                                   runs=offs if len(kept) > 1 else None)
        acc = acc[:, 0, :]
        dense = self._dense(W)[:, 0, :]                          # [S, D]
        tot = acc + dense
        ok = st.live & ((acc > 0) | (dense > 0))
        cand = self._dense_cands(
            torch.where(ok, tot, torch.full_like(tot, float("-inf")))[
                :, None, :], k)
        return _pack(*merge_parts(cand[0], cand[1], k))[0]

    def search_bool(self, queries: Sequence[dict], k: int = 10,
                    check=None, fault_log=None):
        """Batched exact `bool` top-k (BASELINE config 2).

        Each query is {"must": [(term, boost)...], "should": [...],
        "filter": [terms...]}: a hit must contain EVERY must and filter
        term; its score sums the BM25 contributions of the matching must +
        should terms (filters score 0). Device execution: all terms'
        blocks go through K10's bool mode, whose per-run must flags count
        each doc's coverage alongside its score; hot terms contribute
        through the dense column matmul, with a presence matmul
        (Wp @ (col>0)) supplying their coverage counts.

        Returns (scores [Q,k], partition [Q,k], ord [Q,k]), doc-id
        tie-break.

        Executor choice per query mirrors Lucene's lead-cost logic: when the
        rarest REQUIRED term is selective, a host sparse intersection
        (`_bool_host`) beats shipping every block to the device; heavy
        conjunctions (stopword-grade musts) go to the device program."""
        faults.fault_point("blockmax_pass")
        Q = len(queries)
        out = np.zeros((Q, 3, k), np.float32)
        specs = []
        totals = np.zeros(Q, np.int64)
        host_path: List[int] = []
        for qi_, spec in enumerate(queries):
            rows, nm, min_req_df, tot = self._bool_spec_rows(spec)
            specs.append((rows, nm))
            totals[qi_] = tot
            if nm > sum(1 for _, _, req, _ in rows if req):
                # a required term is missing globally: provably empty
                continue
            host_cut = max(_HOST_CONJ_DF, self.stacked.total_docs // 4)
            if nm > 0 and (min_req_df or 0) <= host_cut:
                # conjunction output is bounded by the rarest required term:
                # the sparse host merge beats shipping every block
                host_path.append(qi_)

        for qi_ in host_path:
            out[qi_] = self._bool_host(*specs[qi_], k)

        host_set = set(host_path)
        groups: Dict[Tuple[int, int], List[int]] = {}
        overflow: List[int] = []
        for qi_, tot in enumerate(totals):
            rows, nm = specs[qi_]
            if qi_ in host_set or nm > sum(
                    1 for _, _, req, _ in rows if req):
                continue
            if int(tot) > _MAX_BUCKET:
                overflow.append(qi_)
            else:
                groups.setdefault(_group_shape(int(tot)), []).append(qi_)
        for qi_ in overflow:
            out[qi_] = self._bool_exhaustive(*specs[qi_], k)
        for (bucket, qc), members in sorted(groups.items()):
            # the bool program holds TWO [Qc, D] dense intermediates
            qc = min(qc, max(self._qc_dense_cap // 2, 8))
            for off in range(0, len(members), qc):
                if check is not None:
                    check()
                grp = members[off: off + qc]
                out[grp] = self._bool_group([specs[qx] for qx in grp],
                                            bucket, k)
        return out[:, 0].copy(), _ids(out[:, 1]), _ids(out[:, 2])

    def _bool_spec_rows(self, spec: dict):
        """(rows, nm, min required df, sparse blocks of the busiest
        partition) of a bool spec: rows (term, boost, required, meta) of
        its must, filter (boost 0) and should terms present in the index,
        nm its required-term count."""
        must = [(t, b, True) for t, b in spec.get("must", ())]
        must += [(t, 0.0, True) for t in spec.get("filter", ())]
        should = [(t, b, False) for t, b in spec.get("should", ())]
        rows = []
        nm = 0
        min_req_df = None
        per_shard = np.zeros(max(self.S, 1), np.int64)
        for t, b, required in must + should:
            m = self._term_meta(t)
            if required:
                nm += 1
            if m is None:
                continue
            rows.append((t, b, required, m))
            if required:
                df = sum(len(m.blocks[s].docs) for s in range(self.S))
                min_req_df = df if min_req_df is None else min(min_req_df, df)
            if m.hot_slot < 0:
                for s in range(self.S):
                    per_shard[s] += len(m.blocks[s].ids)
        return rows, nm, min_req_df, int(per_shard.max())

    def _bool_group(self, specs, bucket: int, k: int) -> np.ndarray:
        """One device dispatch of bool specs ((rows, nm) each): every kept
        block of their sparse terms, must flags per block, hot weights and
        must-hot counts; packed [n, 3, k]."""
        n = len(specs)
        W = np.zeros((n, self.n_hot_slots), np.float32)
        Wp = np.zeros((n, self.n_hot_slots), np.float32)
        nm_arr = np.zeros(n, np.float32)
        qb = np.zeros((n, self.S, bucket), np.int32)
        qi = np.zeros((n, self.S, bucket), np.float32)
        qf = np.zeros((n, self.S, bucket), np.float32)
        R = max([sum(1 for *_, m in rows if m.hot_slot < 0)
                 for rows, _ in specs] + [1])
        ts = np.zeros((n, self.S, R + 1), np.int32)
        for row_i, (rows, nm) in enumerate(specs):
            nm_arr[row_i] = nm
            offs = [0] * self.S
            r = 0
            for t, b, required, m in rows:
                w = m.idf * b
                if m.hot_slot >= 0:
                    W[row_i, m.hot_slot] += w
                    if required:
                        # += : a term required twice (must + filter) must
                        # contribute 2 toward coverage == nm
                        Wp[row_i, m.hot_slot] += 1.0
                    continue
                ts[row_i, :, r] = offs
                for s in range(self.S):
                    sb = m.blocks[s]
                    nbk = len(sb.ids)
                    if not nbk:
                        continue
                    qb[row_i, s, offs[s]: offs[s] + nbk] = sb.ids
                    qi[row_i, s, offs[s]: offs[s] + nbk] = w
                    if required:
                        qf[row_i, s, offs[s]: offs[s] + nbk] = 1.0
                    offs[s] += nbk
                r += 1
            ts[row_i, :, r:] = np.asarray(offs, np.int32)[:, None]
        return self._bool_program(W, Wp, qb, qi, qf, ts, nm_arr, k)

    def _host_bs(self, s: int) -> np.ndarray:
        """Partition s's idf-free host lane scores (the stacked build's)."""
        return self.stacked.host_block_scores[s]

    def _term_impacts(self, m: _TermMeta, s: int) -> np.ndarray:
        """Per-posting idf-free impact scores aligned with blocks[s].docs."""
        sb = m.blocks[s]
        if sb.scores is None:
            bs = self._host_bs(s)
            sb.scores = bs[sb.ids].ravel()[: len(sb.docs)]
        return sb.scores

    def _bool_host(self, rows, nm: int, k: int) -> np.ndarray:
        """Selective conjunction on host: sorted-posting intersection of the
        required terms, vectorized score lookups for every clause. Exact;
        cost O(df of the rarest required term)."""
        cand_out: List[Tuple[float, int, int]] = []
        lh = self.stacked.live_host
        for s in range(self.S):
            req = [m.blocks[s].docs for _, _, r, m in rows if r]
            if any(len(docs) == 0 for docs in req) or not req:
                continue
            req.sort(key=len)
            cand = req[0]
            for docs in req[1:]:
                cand = cand[np.isin(cand, docs, assume_unique=True)]
                if not len(cand):
                    break
            if not len(cand):
                continue
            if lh is not None and not lh[s].all():
                cand = cand[lh[s][cand]]
                if not len(cand):
                    continue
            scores = np.zeros(len(cand), np.float64)
            for t, b, req_, m in rows:
                sb = m.blocks[s]
                if not len(sb.docs):
                    continue
                imp = self._term_impacts(m, s)
                j = np.searchsorted(sb.docs, cand)
                present = j < len(sb.docs)
                present[present] = sb.docs[j[present]] == cand[present]
                w = m.idf * b
                scores += np.where(present, w * imp[np.minimum(j, len(imp) - 1)], 0.0)
            keep = scores > 0
            cand, scores = cand[keep], scores[keep]
            if len(cand) > k:
                sel = np.lexsort((cand, -scores))[:k]
                cand, scores = cand[sel], scores[sel]
            cand_out.extend((float(scores[i]), s, int(cand[i]))
                            for i in range(len(cand)))
        cand_out.sort(key=lambda x: (-x[0], x[1], x[2]))
        packed = np.zeros((3, k), np.float32)
        for j, (sc, s, d) in enumerate(cand_out[:k]):
            packed[0, j] = sc
            packed[1, j] = s
            packed[2, j] = d
        return packed

    def _bool_exhaustive(self, rows, nm: int, k: int) -> np.ndarray:
        """Host fallback for block-heavy bool queries (> _MAX_BUCKET blocks
        per partition): dense [D] score+coverage accumulators per partition
        via bincount — exact for any block count. Returns packed [3, k]."""
        hot_np = None
        cand: List[Tuple[float, int, int]] = []
        for s in range(self.S):
            scores = np.zeros(self.D, np.float32)
            cover = np.zeros(self.D, np.int32)
            fp = self.stacked.postings[s]
            bs = self._host_bs(s)
            for t, b, required, m in rows:
                w = m.idf * b
                if m.hot_slot >= 0:
                    if hot_np is None:
                        hot_np = self.hot_cols.cpu().numpy()
                    col = hot_np[s, m.hot_slot]
                    scores += (w * col).astype(np.float32)
                    if required:
                        cover += (col > 0)
                    continue
                sb = m.blocks[s]
                if not len(sb.ids):
                    continue
                docs = fp.block_docs[sb.ids].ravel()
                vals = bs[sb.ids].ravel()
                nz = vals > 0
                scores += np.bincount(docs[nz], weights=w * vals[nz],
                                      minlength=self.D).astype(np.float32)
                if required:
                    cover[docs[nz]] += 1
            live = np.zeros(self.D, bool)
            lh = self.stacked.live_host[s]
            live[: len(lh)] = lh
            ok = (cover == nm) & live & (scores > 0)
            docs = np.nonzero(ok)[0]
            if len(docs):
                sel = np.lexsort((docs, -scores[docs]))[:k]
                cand.extend((float(scores[docs[i]]), s, int(docs[i]))
                            for i in sel)
        cand.sort(key=lambda x: (-x[0], x[1], x[2]))
        packed = np.zeros((3, k), np.float32)
        for j, (sc, s, d) in enumerate(cand[:k]):
            packed[0, j] = sc
            packed[1, j] = s
            packed[2, j] = d
        return packed

    def search_phrase(self, phrases: Sequence[List[str]], k: int = 10,
                      slop: int = 0,
                      live_host: Sequence[np.ndarray] | None = None):
        """Batched exact match_phrase top-k (BASELINE config 3).

        The conjunction + positional verify runs as columnar host passes
        (index/positions.py), scoring is BM25 over the phrase frequency
        with summed idf, matching the dense executor's phrase semantics
        exactly. Returns (scores [Q,k], partition [Q,k], ord [Q,k]) with
        doc-order tie-break."""
        from elasticsearch_tpu_torch.index.positions import phrase_freqs
        from elasticsearch_tpu_torch.parallel.spmd import B, K1

        st = self.stacked
        Q = len(phrases)
        out_s = np.zeros((Q, k), np.float32)
        out_shard = np.zeros((Q, k), np.int32)
        out_ord = np.zeros((Q, k), np.int32)
        for qi, terms in enumerate(phrases):
            idf_sum = 0.0
            for t in terms:
                df_t = sum(
                    int(fp.doc_freq[fp.term_to_ord[t]]) if t in fp.term_to_ord else 0
                    for fp in st.postings)
                if df_t:
                    idf_sum += bm25_idf(st.total_docs, df_t)
            all_s: List[np.ndarray] = []
            all_shard: List[np.ndarray] = []
            all_ord: List[np.ndarray] = []
            for s in range(self.S):
                fp = st.postings[s]
                docs, pf = phrase_freqs(fp, list(terms), slop=slop)
                if live_host is not None and len(docs):
                    keep = live_host[s][docs]
                    docs, pf = docs[keep], pf[keep]
                if not len(docs):
                    continue
                dl = fp.doc_len[docs]
                denom = pf + K1 * (1.0 - B + B * dl / max(st.avgdl, 1e-9))
                sc = (idf_sum * pf * (K1 + 1.0) / denom).astype(np.float32)
                if len(sc) > k:
                    # stable (score desc, doc asc) selection so tied scores
                    # keep the lowest doc ords
                    part = np.lexsort((docs, -sc))[:k]
                    docs, sc = docs[part], sc[part]
                all_s.append(sc)
                all_shard.append(np.full(len(sc), s, np.int32))
                all_ord.append(docs.astype(np.int32))
            if not all_s:
                continue
            sc = np.concatenate(all_s)
            sh = np.concatenate(all_shard)
            od = np.concatenate(all_ord)
            order = np.lexsort((od, sh, -sc))[:k]
            out_s[qi, : len(order)] = sc[order]
            out_shard[qi, : len(order)] = sh[order]
            out_ord[qi, : len(order)] = od[order]
        return out_s, out_shard, out_ord

    def _is_sparse(self, term: str) -> bool:
        meta = self._terms.get(term)
        return meta is not None and meta.hot_slot < 0

    def hbm_bytes(self) -> int:
        st = self.stacked
        return (_nbytes(st.block_docs) + _nbytes(st.block_scores)
                + _nbytes(st.live) + _nbytes(self.hot_cols))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host_block_scores(fp, avgdl: float) -> np.ndarray:
    """Idf-free lane scores on host (same formula as build_stacked_bm25)."""
    from elasticsearch_tpu_torch.parallel.spmd import B as B_, K1

    dl = fp.doc_len[fp.block_docs]
    denom = fp.block_tfs + K1 * (1.0 - B_ + B_ * dl / max(avgdl, 1e-9))
    return np.where(fp.block_tfs > 0,
                    fp.block_tfs * (K1 + 1.0) / denom, 0.0).astype(np.float32)
