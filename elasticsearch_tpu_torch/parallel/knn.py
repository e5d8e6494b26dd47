"""Quantized kNN engine: int8 first pass + exact rescore (the port of
elasticsearch_tpu/parallel/knn.py).

* **int8 first pass with a tracked bound.** Each partition's rows are
  quantized per row to int8 (one f32 scale per row; cosine rows are
  normalized first), stored DOC-major in 2048-doc windows ([nw, 2048,
  dimsP]: each row's dims contiguous, where the reference keeps them
  window-transposed) and scored by the K9 kernel
  (kernels.knn_int8_window_topc), which adds the quantization slack to
  every doc's descaled dot, pushes it through the similarity transform and
  keeps each window's top KNN_CANDW. The candidates are a superset of the
  true top-k whenever the certificate below holds.
* **Exact rescore.** The C = k * ES_TPU_KNN_RESCORE_MULT best candidates
  per query are gathered on the host from the partition's f32 rows,
  uploaded and rescored in one 2D gemm over the flattened [Q*C, dims]
  matrix with the arithmetic of ops.knn (bf16-rounded operands, f32
  accumulation). The k-th rescored score must lie strictly above the
  exclusion bound u_excl (the first dropped candidate's optimistic score,
  or a window's truncation tail); a query that fails re-runs on the dense
  route (a lazily uploaded bf16 mirror), counted in `knn_uncertified`.
  Torch and XLA sum floats in different orders, so the contract with the
  reference is ids and order plus a score bound (ROADMAP W1).
* **IVF coarse pruning (ES_TPU_KNN_NPROBE).** Partitions of at least
  KNN_IVF_MIN_DOCS rows build k-means centroids (numpy, as the reference)
  and store rows cluster-grouped; a probe activates only the windows the
  nprobe nearest clusters overlap. nprobe = 0 (the default) is exact.
* **Stacked partitions.** With `stacked=True` and S > 1 the partitions'
  tensors stack as [S, ...] on the one card — the counterpart of the
  reference's one-device 'shard' mesh: one K9 launch scores every
  partition (a grid axis), and the partitions' top-k merge on the device
  through K4 (spmd.merge_partition_topk). Otherwise partitions run one
  after another and merge on the host; both merges give the same order.
* **Containment.** `knn_score` / `knn_rescore` faults fall back to a
  host-exact f64 scorer for the faulted partition (`knn_host_fallbacks`),
  and an EngineHealth circuit routes everything to the host while open.
  Regions are charged to the HBM ledger, equal to `hbm_bytes()`.
* **Integrity.** The engine keeps host copies of its int8 shards, row
  meta and centroids (about 1.5 GB of host memory at 2M x 768 rows) and
  registers them with the HBM scrubber as `knn_shards`, `knn_meta` and
  `knn_centroids`; a mismatch uploads the copy again, and repeated ones
  trip the engine's health circuit.

`search_many` returns per batch (scores [Q, k] f32, parts [Q, k] i32,
ords [Q, k] i32) merged by (score desc, partition asc, ord asc); empty slots
are (0, 0, 0) and a non-positive score marks an empty slot.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch import device as _device
from elasticsearch_tpu_torch.common import (
    faults, hbm_ledger, integrity, metrics,
)
from elasticsearch_tpu_torch.common.errors import DeviceFaultError
from elasticsearch_tpu_torch.common.faults import FaultRecord
from elasticsearch_tpu_torch.common.health import EngineHealth
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.ops.knn import (
    bf16_dots, knn_scores, similarity_scores, sqrt_rn, topk_lowest_index,
)
from elasticsearch_tpu_torch.parallel.kernels import (
    KNN_CANDW, KNN_W, knn_int8_window_topc,
)
from elasticsearch_tpu_torch.parallel.spmd import merge_partition_topk

KNN_IVF_MIN_DOCS = 4096    # partitions below this skip the k-means build
KNN_KMEANS_ITERS = 5
KNN_KMEANS_SAMPLE = 65536  # rows sampled for the Lloyd iterations
DEFAULT_QC_SIZES = (8, 32, 128)
_MERGE_ORD_MAX = 1 << 24   # the reference's device merge packs 24-bit ords
_QUANT_ROWS = 1 << 18      # rows quantized at a time (bounds temporaries)
_NINF = float("-inf")


# --------------------------------------------------------------------------
# node counters (the tpu_knn section of GET /_nodes/stats)
# --------------------------------------------------------------------------

_COUNTS_LOCK = threading.Lock()
_COUNTS = {"knn_queries": 0, "knn_int8_dispatches": 0,
           "knn_rescore_docs": 0, "knn_host_fallbacks": 0,
           "knn_bytes": 0, "knn_uncertified": 0}   # guarded by: _COUNTS_LOCK

_ENGINES: "weakref.WeakSet[KnnEngine]" = weakref.WeakSet()


def _count(key: str, n: int = 1) -> None:
    with _COUNTS_LOCK:
        _COUNTS[key] += n
    metrics.counter_add(key, n)


def knn_node_stats() -> dict:
    """The `tpu_knn` section of GET /_nodes/stats."""
    with _COUNTS_LOCK:
        out = dict(_COUNTS)
    out["enabled"] = bool(knob("ES_TPU_KNN_INT8"))
    out["nprobe"] = int(knob("ES_TPU_KNN_NPROBE"))
    engines = list(_ENGINES)
    out["engines"] = len(engines)
    out["hbm_bytes"] = sum(e.hbm_bytes() for e in engines)
    return out


def reset_for_tests() -> None:
    with _COUNTS_LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


# --------------------------------------------------------------------------
# host-side IVF build: k-means + cluster-grouped row permutation
# (copied from the reference)
# --------------------------------------------------------------------------

def _nearest(x: np.ndarray, cent: np.ndarray) -> np.ndarray:
    """Chunked nearest-centroid assignment by squared l2 (the x^2 term is
    constant per row and dropped)."""
    cc = (cent * cent).sum(axis=1)[None, :]
    out = np.empty(len(x), np.int64)
    for o in range(0, len(x), 8192):
        xb = x[o:o + 8192]
        out[o:o + len(xb)] = np.argmin(cc - 2.0 * (xb @ cent.T), axis=1)
    return out


def _kmeans(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Centroids + full-row labels. NC ~ sqrt(n) capped at 1024; Lloyd
    iterations run on a fixed-seed sample so the build is deterministic
    and bounded regardless of partition size."""
    n = len(v)
    nc = min(1024, max(8, int(round(n ** 0.5))))
    rng = np.random.default_rng(0x5EED)
    sample = v[rng.choice(n, size=min(n, KNN_KMEANS_SAMPLE), replace=False)]
    cent = sample[rng.choice(len(sample), size=nc, replace=False)].copy()
    for _ in range(KNN_KMEANS_ITERS):
        lab = _nearest(sample, cent)
        sums = np.zeros_like(cent)
        np.add.at(sums, lab, sample)
        cnt = np.bincount(lab, minlength=nc).astype(np.float32)
        nz = cnt > 0
        cent[nz] = sums[nz] / cnt[nz, None]
    return cent, _nearest(v, cent)


# --------------------------------------------------------------------------
# device programs (torch; the reference's jit programs)
# --------------------------------------------------------------------------

def _window_activity(qf, cent, cvalid, overlap, similarity: str,
                     nprobe: int):
    """IVF window activity: act [P, QC, nw] f32 and the probed share of the
    live windows frac [P, QC], for P stacked partitions (cent [P, NCp,
    dimsP], cvalid [P, NCp], overlap [P, NCp, nw])."""
    P, _, nw = overlap.shape
    QC = qf.shape[0]
    dev = qf.device
    if nprobe <= 0:
        return (torch.ones((P, QC, nw), dtype=torch.float32, device=dev),
                torch.ones((P, QC), dtype=torch.float32, device=dev))
    dims = qf.shape[1]
    cs = torch.matmul(qf[None], cent[:, :, :dims].transpose(1, 2))
    if similarity == "cosine":
        cn = sqrt_rn(torch.sum(cent * cent, dim=2))[:, None, :]
        cs = cs / torch.clamp(cn, min=1e-20)
    elif similarity == "l2_norm":
        qq = torch.sum(qf * qf, dim=1, keepdim=True)[None]
        cc = torch.sum(cent * cent, dim=2)[:, None, :]
        cs = -(qq + cc - 2.0 * cs)
    valid = (cvalid > 0)[:, None, :]
    cs = torch.where(valid, cs, torch.full_like(cs, _NINF))
    npb = min(int(nprobe), cs.shape[2])
    thr = torch.topk(cs, npb, dim=2).values[:, :, -1:]
    probed = ((cs >= thr) & valid).float()
    act = (torch.matmul(probed, overlap) > 0).float()      # [P, QC, nw]
    livew = (overlap.amax(dim=1) > 0).float()[:, None, :]  # [P, 1, nw]
    frac = (torch.sum(act * livew, dim=2)
            / torch.clamp(torch.sum(livew, dim=2), min=1.0))
    return act, frac


def _pass1(qf, qi8, qmeta, q8, meta, cent, cvalid, overlap, fmask, *,
           similarity: str, C: int, nprobe: int):
    """The first pass of P stacked partitions (q8 [P, nw, KNN_W, dimsP]):
    IVF window activity, one K9 launch, candidate selection. Returns
    (cand_r [P, QC, C] stored-row ids, cand_ok [P, QC, C], u_excl [P, QC]
    exclusion bound, frac [P, QC])."""
    P, nw = q8.shape[0], q8.shape[1]
    QC = qf.shape[0]
    act, frac = _window_activity(qf, cent, cvalid, overlap, similarity,
                                 nprobe)
    out_s, out_r = knn_int8_window_topc(qi8, qmeta, q8, meta, act, fmask,
                                        similarity=similarity)
    fs = out_s.transpose(1, 2).reshape(P, QC, nw * KNN_CANDW)
    fr = out_r.transpose(1, 2).reshape(P, QC, nw * KNN_CANDW)
    # 2-key sort (optimistic desc, stored row asc), as the reference's
    # lax.sort((-fs, fr)): a stable sort by row, then a stable descending
    # sort by score; -inf empties sink
    o = torch.sort(fr, dim=2, stable=True).indices
    fs, fr = fs.gather(2, o), fr.gather(2, o)
    ns, o = torch.sort(fs, dim=2, descending=True, stable=True)
    nr = fr.gather(2, o)
    cand_r = nr[:, :, :C]
    cand_ok = ns[:, :, :C] > _NINF
    # a doc missing from the candidate set is bounded by either the first
    # dropped candidate or, if its window truncated at KNN_CANDW, that
    # window's last kept value — both optimistic
    tail = out_s[:, :, :, KNN_CANDW - 1].amax(dim=1)       # [P, QC]
    u_excl = torch.maximum(ns[:, :, C], tail)
    return cand_r, cand_ok, u_excl, frac


def _rescore(qf, rows, nrmg, okg, ordg, u_excl, *, similarity: str, C: int,
             k: int):
    """Exact rescore of the gathered candidate rows + the certificate: ONE
    2D gemm over the flattened [Q*C, dims] candidate matrix (as the
    reference, so each column sums as the dense route's full product
    does), each query keeping its own C columns, then the transform of
    ops.knn, the (score desc, ord asc) order and the STRICT certificate."""
    Q = qf.shape[0]
    dev = qf.device
    dots_all = bf16_dots(qf, rows)                          # [Q, Q*C]
    idx = (torch.arange(Q, device=dev)[:, None] * C
           + torch.arange(C, device=dev)[None, :])
    dots = dots_all.gather(1, idx)                          # [Q, C]
    sc = similarity_scores(dots, qf, nrmg, similarity)
    sc = torch.where(okg, sc, torch.full_like(sc, _NINF))
    o = torch.sort(ordg, dim=1, stable=True).indices
    sc, ordg = sc.gather(1, o), ordg.gather(1, o)
    top_s, o = torch.sort(sc, dim=1, descending=True, stable=True)
    top_s = top_s[:, :k]
    top_o = ordg.gather(1, o)[:, :k]
    # STRICT: a tie at the bound could hide an excluded doc with an equal
    # exact score and a lower ordinal, which the reference would prefer
    certified = (top_s[:, k - 1] > u_excl) | torch.isneginf(u_excl)
    valid = top_s > _NINF
    return (torch.where(valid, top_s, torch.zeros_like(top_s)),
            torch.where(valid, top_o, torch.zeros_like(top_o)), certified)


def _dense_topk(qf, vectors, norms, exists, qmask, *, similarity: str,
                k: int):
    """The f32 brute-force route (ES_TPU_KNN_INT8=0 A/B and uncertified
    re-runs): ops.knn.knn_scores + per-query mask ([QC, n] or [1, n]) +
    the top k, lower ordinal first on ties."""
    sc = knn_scores(qf, vectors, norms, exists, similarity=similarity)
    sc = torch.where(qmask, sc, torch.full_like(sc, _NINF))
    ts, to = topk_lowest_index(sc, k)
    valid = ts > _NINF
    return (torch.where(valid, ts, torch.zeros_like(ts)),
            torch.where(valid, to, torch.zeros_like(to)))


# --------------------------------------------------------------------------
# the work unit
# --------------------------------------------------------------------------

class KnnWork:
    """One kNN query: the query vector plus an optional per-partition doc
    filter (bool mask over the partition's ordinals; None = unfiltered)."""

    __slots__ = ("vector", "filters")

    def __init__(self, vector: np.ndarray,
                 filters: Optional[Sequence[Optional[np.ndarray]]] = None):
        self.vector = np.asarray(vector, np.float32)
        self.filters = filters


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

class KnnEngine:
    """Quantized kNN over one vector field's partitions.

    columns: per-partition vector columns (index.segment.VectorColumn:
    .vectors [n, dims], .norms [n], .exists [n], .similarity). lives:
    optional per-partition live masks (deletes). stacked: with S > 1, stack
    the partitions on the card and serve them with one K9 launch per chunk
    and the K4 device merge; otherwise a per-partition loop. device: the
    card unless "cpu" is asked for."""

    kind = "knn"

    def __init__(self, columns: Sequence, lives: Optional[Sequence] = None,
                 stacked: bool = False,
                 qc_sizes: Sequence[int] = DEFAULT_QC_SIZES, *, device=None):
        cols = list(columns)
        if not cols:
            raise ValueError("KnnEngine needs at least one partition")
        sims = {c.similarity for c in cols}
        if len(sims) != 1:
            raise ValueError(f"mixed similarities {sims}")
        self.device = _device.resolve(device)
        if self.device.type == "cuda":
            from elasticsearch_tpu_torch.parallel.cuda_build import build_all

            build_all()          # a build failure surfaces here, not mid-query
        self.similarity = cols[0].similarity
        S = len(cols)
        self.S = S
        self.dims = int(cols[0].vectors.shape[1])
        self.dimsP = -(-self.dims // 128) * 128
        self._fused = bool(stacked) and S > 1
        self.qc_sizes = tuple(sorted({int(s) for s in qc_sizes}))

        self.n_docs: List[int] = []
        self._vecs: List[np.ndarray] = []     # stored f32 rows (rescore src)
        self._norms: List[np.ndarray] = []    # RAW row norms (l2 rescore)
        self._exists: List[np.ndarray] = []
        self._ok: List[np.ndarray] = []       # exists & live
        self._perm: List[np.ndarray] = []     # [nw*KNN_W] stored -> ord
        preps = []
        for i, col in enumerate(cols):
            n = int(col.vectors.shape[0])
            norms = np.asarray(col.norms, np.float32)
            if self.similarity == "cosine":
                # the reference's host expression, rows normalized once
                v = (np.asarray(col.vectors, np.float32)
                     / np.maximum(norms, 1e-20)[:, None])
            else:
                v = np.array(col.vectors, dtype=np.float32, order="C")
            exists = np.asarray(col.exists, bool)
            live = (np.asarray(lives[i], bool)
                    if lives is not None and lives[i] is not None
                    else np.ones(n, bool))
            if n >= KNN_IVF_MIN_DOCS:
                cent, labels = _kmeans(v)
                order = np.argsort(labels, kind="stable")
                counts = np.bincount(labels, minlength=len(cent))
            else:
                # no IVF: one dummy centroid covering every window, so a
                # probed first pass degrades to the exact sweep here
                cent = np.zeros((1, self.dims), np.float32)
                order = np.arange(n)
                counts = np.asarray([n])
            self.n_docs.append(n)
            self._vecs.append(v)
            self._norms.append(norms)
            self._exists.append(exists)
            self._ok.append(exists & live)
            preps.append((cent, order, counts))

        self.nw = max(1, max(-(-n // KNN_W) for n in self.n_docs))
        self.NCp = -(-max(len(c) for c, _, _ in preps) // 8) * 8
        DPg = self.nw * KNN_W
        # stored rows doc-major: [S, nw, KNN_W, dimsP]
        q8h = np.zeros((S, DPg, self.dimsP), np.int8)
        metah = np.zeros((S, 4, DPg), np.float32)
        centh = np.zeros((S, self.NCp, self.dimsP), np.float32)
        cvalh = np.zeros((S, self.NCp), np.float32)
        ovh = np.zeros((S, self.NCp, self.nw), np.float32)
        for i, (cent, order, counts) in enumerate(preps):
            n = self.n_docs[i]
            perm = np.zeros(DPg, np.int32)
            perm[:n] = order
            self._perm.append(perm)
            nc = len(cent)
            centh[i, :nc, :self.dims] = cent
            cvalh[i, :nc] = 1.0
            starts = np.concatenate([[0], np.cumsum(counts)])
            for c in range(nc):
                s0, s1 = int(starts[c]), int(starts[c + 1])
                if s1 > s0:
                    ovh[i, c, s0 // KNN_W:(s1 - 1) // KNN_W + 1] = 1.0
            okf = self._ok[i][order].astype(np.float32)
            for o0 in range(0, n, _QUANT_ROWS):
                # the reference's per-row expressions, a block of rows at a
                # time (every reduction is per row, so the bits agree)
                o1 = min(n, o0 + _QUANT_ROWS)
                vi = self._vecs[i][order[o0:o1]]               # stored order
                s_r = np.maximum(np.abs(vi).max(axis=1), 1e-12) / 127.0
                vi8 = np.clip(np.round(vi / s_r[:, None]), -127, 127) \
                    .astype(np.int8)
                row_l1 = s_r * np.abs(vi8.astype(np.float32)).sum(axis=1)
                q8h[i, o0:o1, :self.dims] = vi8
                metah[i, 0, o0:o1] = s_r.astype(np.float32)
                metah[i, 1, o0:o1] = row_l1.astype(np.float32)
                metah[i, 2, o0:o1] = np.linalg.norm(vi, axis=1)
                metah[i, 3, o0:o1] = okf[o0:o1]
        # the host copies the scrubber holds the device regions to, in the
        # device layout (q8 [S, nw, KNN_W, dimsP], meta [S, 4, nw, KNN_W])
        self._q8_host = q8h.reshape(S, self.nw, KNN_W, self.dimsP)
        self._meta_host = metah.reshape(S, 4, self.nw, KNN_W)
        self._cent_host = centh
        self._cvalid_host = cvalh
        self._overlap_host = ovh
        # translation only (device_errors, no fault_point): construction
        # runs outside the serving containment ladder
        with faults.device_errors("column_upload"):
            self.d_q8 = self._upload(self._q8_host)
            self.d_meta = self._upload(self._meta_host)
            self.d_cent = self._upload(centh)
            self.d_cvalid = self._upload(cvalh)
            self.d_overlap = self._upload(ovh)
        self._dense: List[Optional[tuple]] = [None] * S

        self.health = EngineHealth("knn")
        self._hbm = hbm_ledger.register_engine(self, "knn")
        self._register_hbm_regions()
        self._register_scrub_regions()
        integrity.attach_scrub_health(self, self.health)
        _count("knn_bytes", self.hbm_bytes())
        _ENGINES.add(self)

    # ---------------- residency / integrity ----------------

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """A device copy of a host array, never a view of it (on the CPU
        too): the scrubber holds the device side to the host copy."""
        return torch.from_numpy(host).to(self.device, copy=True)

    def _mirror_bytes(self) -> int:
        return sum(sum(a.nbytes for a in d)
                   for d in self._dense if d is not None)

    def _register_hbm_regions(self) -> None:
        self._hbm.set_region("knn_shards", self.d_q8.nbytes)
        self._hbm.set_region("knn_meta", self.d_meta.nbytes)
        self._hbm.set_region("knn_centroids",
                             self.d_cent.nbytes + self.d_cvalid.nbytes
                             + self.d_overlap.nbytes)
        self._hbm.set_region("knn_dense_mirror", self._mirror_bytes())

    def hbm_bytes(self) -> int:
        return (self.d_q8.nbytes + self.d_meta.nbytes + self.d_cent.nbytes
                + self.d_cvalid.nbytes + self.d_overlap.nbytes
                + self._mirror_bytes())

    def _register_scrub_regions(self) -> None:
        """The HBM scrubber's regions (reference knn.py:491), each against
        its host copy; a repair uploads the copy again."""
        integrity.register_scrub_region(
            self, "knn_shards", lambda o: o.d_q8,
            expected=lambda o: o._q8_host,
            repair=lambda o: o._repair_shards())
        integrity.register_scrub_region(
            self, "knn_meta", lambda o: o.d_meta,
            expected=lambda o: o._meta_host,
            repair=lambda o: o._repair_meta())
        integrity.register_scrub_region(
            self, "knn_centroids", lambda o: o.d_cent,
            expected=lambda o: o._cent_host,
            repair=lambda o: o._repair_centroids())

    def _repair_shards(self) -> None:
        # translation only (device_errors, no fault_point): repairs must
        # not be separately injectable rungs
        with faults.device_errors("column_upload"):
            self.d_q8 = self._upload(self._q8_host)

    def _repair_meta(self) -> None:
        with faults.device_errors("column_upload"):
            self.d_meta = self._upload(self._meta_host)

    def _repair_centroids(self) -> None:
        with faults.device_errors("column_upload"):
            self.d_cent = self._upload(self._cent_host)
            self.d_cvalid = self._upload(self._cvalid_host)
            self.d_overlap = self._upload(self._overlap_host)

    def _ensure_dense(self, i: int) -> None:
        """Lazily upload partition i's bf16 mirror for the dense route (the
        INT8=0 A/B path and uncertified re-runs): the same host f32 rows
        cast to bf16 on the device, a block of rows at a time."""
        if self._dense[i] is not None:
            return
        dev = self.device
        v = self._vecs[i]
        with faults.device_errors("column_upload"):
            vb = torch.empty((len(v), self.dims), dtype=torch.bfloat16,
                             device=dev)
            for o in range(0, len(v), _QUANT_ROWS):
                vb[o:o + _QUANT_ROWS] = torch.from_numpy(
                    v[o:o + _QUANT_ROWS]).to(dev).to(torch.bfloat16)
            trip = (vb, torch.from_numpy(self._norms[i]).to(dev),
                    torch.from_numpy(self._exists[i]).to(dev))
        self._dense[i] = trip
        _count("knn_bytes", sum(a.nbytes for a in trip))
        self._register_hbm_regions()

    def set_live(self, i: int, live: np.ndarray) -> None:
        """Refresh one partition's live mask (deletes): one device copy of
        the okf row, under the column_upload containment site like every
        other engine refresh."""
        n = self.n_docs[i]
        ok = self._exists[i] & np.asarray(live, bool)
        self._ok[i] = ok
        okf = np.zeros(self.nw * KNN_W, np.float32)
        if n:
            okf[:n] = ok[self._perm[i][:n]].astype(np.float32)
        okw = okf.reshape(self.nw, KNN_W)
        self._meta_host[i, 3] = okw
        with faults.device_dispatch("column_upload", part=i):
            self.d_meta[i, 3] = torch.from_numpy(okw).to(self.device)

    # ---------------- scheduler hooks ----------------

    def extend_qc_sizes(self, sizes) -> None:
        self.qc_sizes = tuple(sorted(set(self.qc_sizes)
                                     | {int(s) for s in sizes}))
        hbm_ledger.note_primed("knn", self.qc_sizes)
        hbm_ledger.note_primed("knn_dense", self.qc_sizes)

    # ---------------- host tiers ----------------

    def _host_exact(self, i: int, wk: KnnWork, k: int):
        """f64 host-exact scorer — the containment fallback when a
        partition's device dispatch faults. Correctness-equal (not
        bitwise: numpy f64 vs the device's bf16 operands)."""
        n = self.n_docs[i]
        if n == 0:
            return np.zeros(k, np.float32), np.zeros(k, np.int32)
        q = wk.vector.astype(np.float64)
        dots = self._vecs[i].astype(np.float64) @ q
        if self.similarity == "cosine":
            sc = (1.0 + dots / max(float(np.linalg.norm(q)), 1e-20)) / 2.0
        elif self.similarity == "dot_product":
            sc = (1.0 + dots) / 2.0
        else:
            nrm = self._norms[i].astype(np.float64)
            d2 = np.maximum(float(q @ q) + nrm * nrm - 2.0 * dots, 0.0)
            sc = 1.0 / (1.0 + np.sqrt(d2))
        mask = self._ok[i].copy()
        if wk.filters is not None and wk.filters[i] is not None:
            mask &= np.asarray(wk.filters[i], bool)
        sc = np.where(mask, sc, -np.inf)
        order = np.lexsort((np.arange(n), -sc))[:k]
        order = order[sc[order] > -np.inf]
        s = np.zeros(k, np.float32)
        o = np.zeros(k, np.int32)
        s[:len(order)] = sc[order]
        o[:len(order)] = order
        return s, o

    def _host_chunk(self, i: int, chunk, k: int):
        s = np.zeros((len(chunk), k), np.float32)
        o = np.zeros((len(chunk), k), np.int32)
        for j, wk in enumerate(chunk):
            s[j], o[j] = self._host_exact(i, wk, k)
        return s, o

    # ---------------- device routes ----------------

    def _quantize_queries(self, qf: np.ndarray):
        QC, dims = qf.shape
        sq = np.maximum(np.abs(qf).max(axis=1), 1e-12) / 127.0
        qi8 = np.zeros((QC, self.dimsP), np.int8)
        qi8[:, :dims] = np.clip(np.round(qf / sq[:, None]), -127, 127)
        ql1 = sq * np.abs(qi8.astype(np.float32)).sum(axis=1)
        qn = np.linalg.norm(qf, axis=1)
        qm = np.zeros((QC, 8), np.float32)
        qm[:, 0] = sq
        qm[:, 1] = 0.5 * ql1 + dims * sq / 4.0
        qm[:, 2] = qn
        qm[:, 3] = qn * qn
        qm[:, 4] = 1.0 / np.maximum(qn, 1e-20)
        qm[:, 5] = 0.5 * sq
        return qi8, qm

    def _filter_mask(self, i: int, chunk, QC: int) -> np.ndarray:
        """Per-query doc filters permuted to STORED row order, [QC, nw,
        KNN_W] i8. Pad rows may alias doc 0 through the pad permutation
        entries — the kernel's okf gate keeps them dead regardless."""
        n = self.n_docs[i]
        fm = np.ones((QC, self.nw * KNN_W), np.int8)
        perm_c = np.minimum(self._perm[i], max(n - 1, 0))
        for j, wk in enumerate(chunk):
            flt = wk.filters[i] if wk.filters is not None else None
            if flt is None or n == 0:
                continue
            fm[j] = np.asarray(flt, bool)[perm_c].astype(np.int8)
        return fm.reshape(QC, self.nw, KNN_W)

    def _dense_chunk(self, i: int, qf: np.ndarray, chunk, QC: int, k: int):
        """The f32 brute-force route for one partition. An unfiltered chunk
        broadcasts the partition's live mask instead of one row per
        query."""
        self._ensure_dense(i)
        n = self.n_docs[i]
        dev = self.device
        if any(wk.filters is not None and wk.filters[i] is not None
               for wk in chunk):
            qmask = np.zeros((QC, max(n, 1)), bool)
            for j, wk in enumerate(chunk):
                m = self._ok[i]
                if wk.filters is not None and wk.filters[i] is not None:
                    m = m & np.asarray(wk.filters[i], bool)
                qmask[j, :n] = m
        else:
            qmask = np.zeros((1, max(n, 1)), bool)
            qmask[0, :n] = self._ok[i]
        v, nrm, ex = self._dense[i]
        with faults.device_dispatch("knn_score", part=i):
            ts, to = _dense_topk(torch.from_numpy(qf).to(dev), v, nrm, ex,
                                 torch.from_numpy(qmask).to(dev),
                                 similarity=self.similarity, k=k)
            return ts.cpu().numpy(), to.cpu().numpy().astype(np.int32)

    def _run_chunk(self, chunk, QC: int, k: int, local_faults: List,
                   check=None):
        """One padded query chunk across all partitions. Returns
        (s [S, n, k], o [S, n, k]) per-partition numpy results."""
        n = len(chunk)
        S = self.S
        dev = self.device
        use_int8 = bool(knob("ES_TPU_KNN_INT8"))
        nprobe = max(0, int(knob("ES_TPU_KNN_NPROBE")))
        mult = max(1, int(knob("ES_TPU_KNN_RESCORE_MULT")))
        C = min(k * mult, self.nw * KNN_CANDW - 1)
        qf = np.zeros((QC, self.dims), np.float32)
        for j, wk in enumerate(chunk):
            qf[j, :len(wk.vector)] = wk.vector
        s_out = np.zeros((S, n, k), np.float32)
        o_out = np.zeros((S, n, k), np.int32)

        if not use_int8 or k > C:
            # the f32 brute-force A/B path, per partition
            t0 = time.monotonic()
            first = hbm_ledger.note_dispatch("knn_dense", QC)
            for i in range(S):
                try:
                    ds, do = self._dense_chunk(i, qf, chunk, QC, k)
                    s_out[i], o_out[i] = ds[:n], do[:n]
                except DeviceFaultError as e:
                    local_faults.append(FaultRecord.from_error(e, partition=i))
                    _count("knn_host_fallbacks", n)
                    self.health.record_fallback(n)
                    s_out[i], o_out[i] = self._host_chunk(i, chunk, k)
            if first:
                hbm_ledger.note_compile_done(
                    "knn_dense", QC, time.monotonic() - t0)
            return s_out, o_out

        _count("knn_int8_dispatches", 1)
        qi8, qmeta = self._quantize_queries(qf)
        masked = any(wk.filters is not None for wk in chunk)
        t0 = time.monotonic()
        first = hbm_ledger.note_dispatch("knn", QC)
        qfd = torch.from_numpy(qf).to(dev)
        qi8d = torch.from_numpy(qi8).to(dev)
        qmd = torch.from_numpy(qmeta).to(dev)
        pass1: Dict[int, tuple] = {}
        failed: Dict[int, DeviceFaultError] = {}
        if self._fused:
            fmasks = None
            if masked:
                fmasks = torch.from_numpy(np.stack(
                    [self._filter_mask(i, chunk, QC) for i in range(S)]
                )).to(dev)
            try:
                with faults.device_dispatch("knn_score"):
                    rr = _pass1(qfd, qi8d, qmd, self.d_q8, self.d_meta,
                                self.d_cent, self.d_cvalid, self.d_overlap,
                                fmasks, similarity=self.similarity, C=C,
                                nprobe=nprobe)
                    cr, cok, ux, fr = (a.cpu().numpy() for a in rr)
                for i in range(S):
                    pass1[i] = (cr[i], cok[i], ux[i], fr[i])
            except DeviceFaultError as e:
                # a fault of the stacked dispatch host-routes the whole
                # chunk, every partition, as the reference's fused route
                local_faults.append(FaultRecord.from_error(e))
                _count("knn_host_fallbacks", n * S)
                self.health.record_fallback(n * S)
                for i in range(S):
                    s_out[i], o_out[i] = self._host_chunk(i, chunk, k)
                if first:
                    hbm_ledger.note_compile_done(
                        "knn", QC, time.monotonic() - t0)
                return s_out, o_out
        else:
            for i in range(S):
                fmask = (torch.from_numpy(self._filter_mask(i, chunk, QC))
                         .to(dev)[None] if masked else None)
                sl = slice(i, i + 1)
                try:
                    with faults.device_dispatch("knn_score", part=i):
                        rr = _pass1(qfd, qi8d, qmd, self.d_q8[sl],
                                    self.d_meta[sl], self.d_cent[sl],
                                    self.d_cvalid[sl], self.d_overlap[sl],
                                    fmask, similarity=self.similarity, C=C,
                                    nprobe=nprobe)
                        pass1[i] = tuple(a[0].cpu().numpy() for a in rr)
                except DeviceFaultError as e:
                    failed[i] = e
        if first:
            hbm_ledger.note_compile_done("knn", QC, time.monotonic() - t0)

        cand_hist = np.zeros(n, np.int64)
        frac_hist = np.zeros(n, np.float64)
        for i in range(S):
            if check is not None:
                check()
            if i in failed:
                local_faults.append(
                    FaultRecord.from_error(failed[i], partition=i))
                _count("knn_host_fallbacks", n)
                self.health.record_fallback(n)
                s_out[i], o_out[i] = self._host_chunk(i, chunk, k)
                continue
            if self.n_docs[i] == 0:
                continue
            cand_r, cand_ok, u_excl, frac = pass1[i]
            cand_hist += cand_ok[:n].sum(axis=1)
            frac_hist += frac[:n]
            ords = self._perm[i][cand_r]
            ords = np.where(cand_ok, ords, 0).astype(np.int32)
            _count("knn_rescore_docs", int(cand_ok[:n].sum()))
            try:
                rows = self._vecs[i][ords.reshape(-1)]
                nrmg = self._norms[i][ords]
                with faults.device_dispatch("knn_rescore", part=i):
                    ts, to, cert = _rescore(
                        qfd, torch.from_numpy(rows).to(dev),
                        torch.from_numpy(nrmg).to(dev),
                        torch.from_numpy(cand_ok).to(dev),
                        torch.from_numpy(ords).to(dev),
                        torch.from_numpy(u_excl).to(dev),
                        similarity=self.similarity, C=C, k=k)
                    ts, to, cert = (ts.cpu().numpy(), to.cpu().numpy(),
                                    cert.cpu().numpy())
            except DeviceFaultError as e:
                local_faults.append(FaultRecord.from_error(e, partition=i))
                _count("knn_host_fallbacks", n)
                self.health.record_fallback(n)
                s_out[i], o_out[i] = self._host_chunk(i, chunk, k)
                continue
            s_out[i], o_out[i] = ts[:n], to[:n]
            bad = np.nonzero(~cert[:n])[0]
            if len(bad):
                # certificate miss: the candidate set may not cover the
                # true top-k — re-run those queries on the dense route
                _count("knn_uncertified", len(bad))
                try:
                    ds, do = self._dense_chunk(i, qf, chunk, QC, k)
                    s_out[i][bad] = ds[bad]
                    o_out[i][bad] = do[bad]
                except DeviceFaultError as e:
                    local_faults.append(
                        FaultRecord.from_error(e, partition=i))
                    _count("knn_host_fallbacks", len(bad))
                    self.health.record_fallback(len(bad))
                    hs, ho = self._host_chunk(i, chunk, k)
                    s_out[i][bad] = hs[bad]
                    o_out[i][bad] = ho[bad]
        for j in range(n):
            metrics.observe("knn_candidates_per_query", float(cand_hist[j]))
            metrics.observe("knn_nprobe_ratio",
                            float(frac_hist[j]) / max(1, S - len(failed)))
        return s_out, o_out

    # ---------------- merge ----------------

    def _merge(self, s_all: np.ndarray, o_all: np.ndarray, k: int):
        """(score desc, partition asc, ord asc) merge of the per-partition
        top-k — on the device through K4 when stacked, host lexsort
        otherwise; both orders are identical by construction."""
        if (self._fused and self.S > 1
                and max(self.n_docs) < _MERGE_ORD_MAX):
            try:
                with faults.device_dispatch("merge_kernel"):
                    return merge_partition_topk(s_all, o_all, k,
                                                device=self.device)
            except DeviceFaultError:
                pass        # the host merge gives the same order
        S, Q, kk = s_all.shape
        ms = np.zeros((Q, k), np.float32)
        mp = np.zeros((Q, k), np.int32)
        mo = np.zeros((Q, k), np.int32)
        parts = np.repeat(np.arange(S, dtype=np.int32), kk)
        for qi in range(Q):
            s = s_all[:, qi, :].ravel()
            o = o_all[:, qi, :].ravel()
            keep = s > 0
            s, o, p = s[keep], o[keep], parts[keep]
            order = np.lexsort((o, p, -s))[:k]
            ms[qi, :len(order)] = s[order]
            mp[qi, :len(order)] = p[order]
            mo[qi, :len(order)] = o[order]
        return ms, mp, mo

    # ---------------- the serving entry ----------------

    def search_many(self, batches: Sequence[List[KnnWork]], k: int = 10,
                    check=None, fault_log=None):
        """Per batch: merged (scores [Q, k] f32, parts [Q, k] i32,
        ords [Q, k] i32); empty slots are (0, 0, 0). Chunks ride the
        qc_sizes ladder; contained faults append FaultRecords and feed
        the health circuit (open circuit = host tier)."""
        spans = []
        flat: List[KnnWork] = []
        for b in batches:
            spans.append((len(flat), len(b)))
            flat.extend(b)
        Q = len(flat)
        if Q == 0:
            return [(np.zeros((nn, k), np.float32),
                     np.zeros((nn, k), np.int32),
                     np.zeros((nn, k), np.int32)) for _, nn in spans]
        _count("knn_queries", Q)
        local_faults: List[FaultRecord] = []
        s_all = np.zeros((self.S, Q, k), np.float32)
        o_all = np.zeros((self.S, Q, k), np.int32)
        if not self.health.allow_device():
            # circuit open: the whole batch serves from the host tier
            _count("knn_host_fallbacks", Q * self.S)
            self.health.record_fallback(Q * self.S)
            for i in range(self.S):
                s_all[i], o_all[i] = self._host_chunk(i, flat, k)
            ms, mp, mo = self._merge(s_all, o_all, k)
        else:
            off = 0
            while off < Q:
                rem = Q - off
                take = next((s for s in self.qc_sizes if s >= rem),
                            self.qc_sizes[-1])
                chunk = flat[off:off + take]
                if check is not None:
                    check()
                cs, co = self._run_chunk(chunk, take, k, local_faults,
                                         check=check)
                s_all[:, off:off + len(chunk)] = cs
                o_all[:, off:off + len(chunk)] = co
                off += len(chunk)
            if local_faults:
                self.health.record_fault(local_faults[-1].error)
            else:
                self.health.record_success()
            ms, mp, mo = self._merge(s_all, o_all, k)
        if fault_log is not None:
            fault_log.extend(local_faults)
        return [(ms[o:o + nn], mp[o:o + nn], mo[o:o + nn])
                for o, nn in spans]

    def stats(self) -> dict:
        out = {"partitions": self.S, "fused": int(self._fused),
               "nw": self.nw, "hbm_bytes": self.hbm_bytes()}
        out.update(self.health.flat_stats())
        return out


def build_knn_engine(columns: Sequence, lives: Optional[Sequence] = None,
                     stacked: bool = False, *, device=None) -> KnnEngine:
    """Constructor seam for serving: one engine per (snapshot, field)."""
    return KnnEngine(columns, lives=lives, stacked=stacked, device=device)
