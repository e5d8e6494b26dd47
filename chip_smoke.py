#!/usr/bin/env python3
"""Quickest proof that the PyTorch + CUDA port serves on an NVIDIA H100.

    python3 chip_smoke.py            # one card; exits 0 only if every check holds
    python3 chip_smoke.py --docs N   # cut the index to N docs (the cut is printed)

It drives the port's main path (elasticsearch_tpu_torch only; it imports
nothing of JAX or of elasticsearch_tpu) the way bench.py drives config 1 of
BASELINE.md, at the size of one primary shard of the 33M-doc Wikipedia-EN
target:

1. builds the three CUDA kernels (K1 build_columns, K2 sweep_rowmax,
   K3 sparse_gather) from parallel/csrc with nvcc;
2. builds one 8,000,000-doc shard on the host: docs of 8-40 terms over a
   500k-term Zipf(1.07) vocabulary, seeded as bench.py does;
3. selects the engine with `select_bm25_engine(device="cuda")` (cold_df
   65536, 7 GiB column budget, bench.py's settings) at the widened slice
   ladder below, prebuilds every column (K1 at full width) and serves two
   batches of 256 two-term Zipf queries and a batch of `match` DSL bodies
   through `extract_plan` (K2 at QC = 256, K3 for the cold terms), with
   every kernel's launch count set to 0 just before and read just after;
4. requires no fault record, host-tier fallback, sparse fallback or
   degraded column, at most MAX_CERT_FALLBACK_SHARE of the queries failing
   their certificate (the algorithm's own exact path for heavily tied
   queries), and holds every query's top-10 (scores, ords) bitwise against
   the port's own host-exact tier, and a few against an independent numpy
   scorer;
5. runs each kernel and its plain torch version on the same inputs at the
   path's shapes, requires bitwise agreement, and times both (CUDA events,
   median), with one PyTorch library call beside K2 and K3 as a yardstick;
   K3 is also timed at every dispatch of the first batch;
6. serves the first batch again on a fresh engine at the default slice
   ladder and reports its sparse fallbacks, holding its answers too;
7. prints the card's name and power limit and a `kernels` JSON line, and
   last `{"ok": true, "device": {...}}`.

Any failed check raises: the script then exits nonzero and prints no
result. Without CUDA, or without the package beside it, it exits 2.

The main path runs at a slice-width ladder extended to 65536
(ES_TPU_SPARSE_WIDTHS=1024,4096,16384,65536), not the default
1024,4096,16384, so every cold term (df < cold_df = 65536) gets a device
slice: with the default ladder a query with a cold term of df 16385-65535
has its whole cold side scored on the host (a sparse fallback), which the
main path refuses. Phase 6 measures how often that happens at the default.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

FULL_DOCS = 8_000_000
VOCAB = 500_000
COLD_DF = 65536
TURBO_HBM = 7 << 30
K = 10
WIDE_LADDER = f"1024,4096,16384,{COLD_DF}"
# certificate fallbacks allowed on the main path, as a share of its queries
# (5 of 520 on the full-size index: hot Zipf terms tie on thousands of docs)
MAX_CERT_FALLBACK_SHARE = 0.02
# H100 SXM published peaks (NVIDIA datasheet): bytes/s, int8 op/s,
# f32 op/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.time() - T0:7.1f}s] {msg}", flush=True)


T0 = time.time()


class _Seg:
    """The partition shape select_bm25_engine reads (as bench.py's shim)."""

    def __init__(self, n_docs, fp):
        self.n_docs = n_docs
        self.postings = {"body": fp}


def zipf_probs(vocab: int) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** 1.07
    return p / p.sum()


def build_index(n_docs: int, vocab: int):
    from elasticsearch_tpu_torch.index.segment import build_field_postings

    rng = np.random.default_rng(42)
    lens = rng.integers(8, 40, size=n_docs).astype(np.int64)
    tokens = rng.choice(vocab, size=int(lens.sum()), p=zipf_probs(vocab))
    tok_docs = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    fp = build_field_postings("body", lens, tok_docs, tokens,
                              [f"t{i}" for i in range(vocab)])
    return fp, int(lens.sum())


def draw_batches(n_batches: int, n: int, vocab: int):
    rng = np.random.default_rng(43)
    probs = zipf_probs(vocab)
    out = []
    for _ in range(n_batches):
        t = rng.choice(vocab, size=(n, 2), p=probs)
        t[:, 1] = np.where(t[:, 1] == t[:, 0], (t[:, 1] + 1) % vocab, t[:, 1])
        out.append([[f"t{a}", f"t{b}"] for a, b in t])
    return out


DSL_BODIES = [
    {"query": {"match": {"body": "t3 t1200"}}},
    {"query": {"match": {"body": "T17 t40000 t9"}}},
    {"query": {"term": {"body": {"value": "t250", "boost": 2.0}}}},
    {"query": {"bool": {"should": [{"match": {"body": "t5 t70"}},
                                   {"term": {"body": "t123456"}}]}}},
    {"query": {"match": {"body": "t0 t1 t2 t3"}}, "size": 10},
    {"query": {"match": {"body": "t99999"}}},
    {"query": {"bool": {"should": [{"term": {"body": "t60"}},
                                   {"term": {"body": "t61"}}]}}},
    {"query": {"match": {"body": "t8 t8 t31"}}},
]


def brute_topk(fp, total_docs, terms, k=K):
    """Independent numpy scorer: term-at-a-time f32 BM25 over the postings,
    (score desc, doc asc) — the accumulation order of the reference scorer."""
    import math

    n_field = int(np.count_nonzero(fp.doc_len))
    avgdl = fp.sum_doc_len / n_field
    dense = np.zeros(len(fp.doc_len), np.float32)
    for t, boost in terms:
        o = fp.term_to_ord.get(t, -1)
        if o < 0:
            continue
        df = int(fp.doc_freq[o])
        idf = math.log(1.0 + (total_docs - df + 0.5) / (df + 0.5))
        lo, hi = int(fp.post_start[o]), int(fp.post_start[o + 1])
        docs = fp.post_doc[lo:hi]
        rows = slice(int(fp.block_start[o]),
                     int(fp.block_start[o]) + int(fp.block_count[o]))
        tf = fp.block_tfs[rows].ravel()[: hi - lo]
        dl = fp.doc_len[fp.block_docs[rows].ravel()[: hi - lo]]
        denom = tf + 1.2 * (1.0 - 0.75 + 0.75 * dl / max(avgdl, 1e-9))
        lane = np.where(tf > 0, tf * (1.2 + 1.0) / denom,
                        0.0).astype(np.float32)
        dense[docs] = dense[docs] + np.float32(idf * boost) * lane
    docs = np.nonzero(dense > 0)[0]
    sel = np.lexsort((docs, -dense[docs]))[:k]
    return dense[docs[sel]], docs[sel].astype(np.int32)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn over reps runs (CUDA events), after one
    warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def max_abs_err(a, b) -> float:
    import torch

    diff = a != b            # equal -inf entries count as equal
    if not bool(diff.any()):
        return 0.0
    return float((a[diff].double() - b[diff].double()).abs().max())


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bound(nbytes: float, ops: float, op_rate: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k1(turbo, launches):
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    dev = turbo.device
    parts = [turbo._term_groups(turbo._term(t), s)
             for t, s in turbo._slot_of.items()]
    g = [torch.from_numpy(np.concatenate([p[i] for p in parts])).to(dev)
         for i in range(4)]
    ng = int(g[0].shape[0])
    hi_k, lo_k = torch.zeros_like(turbo.cols_hi), torch.zeros_like(turbo.cols_lo)

    def kern():
        k.build_columns(*g, turbo.lane_docs, turbo.lane_scores, hi_k, lo_k)

    ms = cuda_ms(kern, 5)
    require(torch.equal(hi_k, turbo.cols_hi) and torch.equal(lo_k, turbo.cols_lo),
            "K1: rebuilt columns differ from the main path's")
    hi_p, lo_p = torch.zeros_like(hi_k), torch.zeros_like(lo_k)
    t = time.time()
    plain_ms = cuda_ms(lambda: k.build_columns_plain(
        *g, turbo.lane_docs, turbo.lane_scores, hi_p, lo_p), 1)
    log(f"K1 plain version took {time.time() - t:.1f}s wall")
    err = max(max_abs_err(hi_k, hi_p), max_abs_err(lo_k, lo_p))
    require(err == 0.0, f"K1 kernel vs plain: max_abs_err {err}")
    lanes = int(g[1].long().sum()) * 128
    nbytes = lanes * 8 + ng * 16 + ng * k.TILE * 2
    b_ms, b_by = bound(nbytes, ng * k.TILE * 8, PEAK_F32)
    del hi_k, lo_k, hi_p, lo_p
    return {"name": "build_columns", "route": "cuda",
            "source": "elasticsearch_tpu_torch/parallel/csrc/build_columns.cu",
            "replaces": "elasticsearch_tpu/parallel/kernels.py:780",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": {"groups": ng, "lanes": lanes}}


def check_k2(turbo, batch, launches):
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k
    from elasticsearch_tpu_torch.parallel.turbo import _flatten_queries

    dev = turbo.device
    flat, _ = _flatten_queries([batch])
    qc = 256
    wq_np, qs_np = turbo._sweep_weights(flat[:qc], qc)
    wq = torch.from_numpy(wq_np).to(dev)
    qs = torch.from_numpy(qs_np).to(dev)
    args = (qs, turbo.cols_hi, turbo.cols_lo, wq, turbo.live)
    out = {}

    def kern():
        out["k"] = k.sweep_rowmax(*args, nsw=turbo.nsw)

    ms = cuda_ms(kern, 10)
    plain_ms = cuda_ms(lambda: out.__setitem__(
        "p", k.sweep_rowmax_plain(*args, nsw=turbo.nsw)), 1)
    (km, kr), (pm, pr) = out["k"], out["p"]
    err = max(max_abs_err(km, pm), max_abs_err(kr, pr))
    require(err == 0.0 and torch.equal(km, pm) and torch.equal(kr, pr),
            f"K2 kernel vs plain: max_abs_err {err}")
    nz = (wq_np != 0).any(axis=0)                     # [QC, Hpt]
    n_union = int(nz.any(axis=0).sum())
    nnz = int(nz.sum())
    dp = turbo.Dp
    nbytes = (n_union * 2 * dp + dp * 4 + wq_np.nbytes + qs_np.nbytes
              + 2 * turbo.nsw * qc * k.CAND_PAD * 4)
    b_ms, b_by = bound(nbytes, nnz * 4 * 2 * dp, PEAK_INT8)
    # yardstick: the four int8 products as one cuBLASLt int8 GEMM over the
    # dense slots, [wh; wl] @ [cols_hi | cols_lo] (the port never calls it)
    hpt = turbo.cols_hi.shape[1]
    k8 = -(-hpt // 8) * 8
    a = torch.zeros((2 * qc, k8), dtype=torch.int8, device=dev)
    a[:, :hpt] = wq.reshape(2 * qc, hpt)
    b = torch.zeros((k8, 2 * dp), dtype=torch.int8, device=dev)
    b[:hpt, :dp] = turbo.cols_hi.permute(1, 0, 2, 3).reshape(hpt, dp)
    b[:hpt, dp:] = turbo.cols_lo.permute(1, 0, 2, 3).reshape(hpt, dp)
    lib_ms = cuda_ms(lambda: torch._int_mm(a, b), 3)
    del a, b
    torch.cuda.empty_cache()
    return {"name": "sweep_rowmax", "route": "cuda",
            "source": "elasticsearch_tpu_torch/parallel/csrc/sweep_rowmax.cu",
            "replaces": "elasticsearch_tpu/parallel/kernels.py:190",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms,
            "shape": {"QC": qc, "Hpt": hpt, "nsw": turbo.nsw,
                      "union_slots": n_union, "nonzero_weights": nnz}}


def check_k3(turbo, batch, launches):
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k
    from elasticsearch_tpu_torch.parallel.turbo import _flatten_queries

    dev = turbo.device
    flat, _ = _flatten_queries([batch])
    preps = []
    for terms in flat:
        cold = [(t, b, turbo._term(t)) for t, b in terms
                if turbo._term(t) is not None and t not in turbo._slot_of]
        if not cold:
            continue
        prep = turbo._sparse_dispatch_args(cold)
        require(prep is not None, "K3: a cold side exceeded the chunk buckets")
        preps.append(prep[0])
    require(preps, "K3: no query had a cold term")
    n_tiles = turbo.Dp // k.TILE
    pool = turbo._sp_pool
    # every dispatch of the batch, timed on its own
    per = []
    for arrays in preps:
        a = [torch.from_numpy(x).to(dev) for x in arrays]
        per.append(cuda_ms(lambda: k.sparse_gather(*a, pool, n_tiles=n_tiles),
                           3))
    live = [int((arrays[0] > 0).sum()) for arrays in preps]
    big = max(range(len(preps)), key=lambda i: live[i])
    coff, cw, ct0, ct1 = (torch.from_numpy(x).to(dev) for x in preps[big])
    out = {}
    ms = cuda_ms(lambda: out.__setitem__("k", k.sparse_gather(
        coff, cw, ct0, ct1, pool, n_tiles=n_tiles)), 20)
    plain_ms = cuda_ms(lambda: out.__setitem__("p", k.sparse_gather_plain(
        coff, cw, ct0, ct1, pool, n_tiles=n_tiles)), 3)
    err = max_abs_err(out["k"], out["p"])
    require(err == 0.0 and torch.equal(out["k"], out["p"]),
            f"K3 kernel vs plain: max_abs_err {err}")
    # the wrapper's granule-range check (a read-back before the launch) is
    # inside `ms`; its own time alone
    n_gran = int(pool.shape[0])
    check_ms = cuda_ms(lambda: bool(((coff < 0) | (coff >= n_gran)).any()), 20)
    n_rc = int(coff.shape[0])
    v = pool[coff.long()].reshape(n_rc, -1)
    imp = v & 255
    ok = imp > 0
    docs = ((v >> 8) & 0xFFFFFF).long()[ok]
    vals = (imp.float() * cw[:, None])[ok]
    acc = torch.zeros(n_tiles * k.TILE, dtype=torch.float32, device=dev)
    # yardstick: the scatter half as one index_add_ (the port never calls it)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, docs, vals), 20)
    nbytes = n_rc * (k.SPARSE_GRAN * 4 * 2 + 16)
    b_ms, b_by = bound(nbytes, int(ok.sum()) * 2, PEAK_F32)
    q = np.percentile(per, [0, 50, 90, 100])
    return {"name": "sparse_gather", "route": "cuda",
            "source": "elasticsearch_tpu_torch/parallel/csrc/sparse_gather.cu",
            "replaces": "elasticsearch_tpu/parallel/kernels.py:901",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "range_check_ms": check_ms,
            "shape": {"n_rc": n_rc, "live_chunks": live[big],
                      "lanes": int(ok.sum()), "n_tiles": n_tiles},
            "batch_dispatches": {
                "n": len(per), "sum_ms": float(np.sum(per)),
                "min_ms": q[0], "p50_ms": q[1], "p90_ms": q[2], "max_ms": q[3],
                "live_chunks_min": min(live), "live_chunks_p50":
                    float(np.median(live)), "live_chunks_max": max(live)}}


def default_ladder(fp, n_docs, batch, held):
    """The first batch again, on a fresh engine at the default slice ladder:
    its sparse fallbacks, latency and answers (held bitwise against the
    host-exact answers of the main path's hold)."""
    import torch

    from elasticsearch_tpu_torch.search.serving import select_bm25_engine

    saved = os.environ.pop("ES_TPU_SPARSE_WIDTHS")
    try:
        eng = select_bm25_engine([_Seg(n_docs, fp)], "body", device="cuda",
                                 hbm_budget_bytes=TURBO_HBM, cold_df=COLD_DF)
        eng.prebuild_columns()
        torch.cuda.synchronize()
        fault_log = []
        t = time.time()
        s, _, o = eng.search_many([batch], k=K, fault_log=fault_log)[0]
        lat = time.time() - t
    finally:
        os.environ["ES_TPU_SPARSE_WIDTHS"] = saved
    st = eng.stats
    require(not fault_log and st["health_fallback_queries"] == 0,
            f"default ladder: fault records {fault_log}")
    require(np.array_equal(s, held[0]) and np.array_equal(o, held[1]),
            "default ladder: answers differ from the host-exact tier")
    out = {"widths": "1024,4096,16384", "queries": len(batch),
           "batch_latency_s": lat, "sparse_queries": st["sparse_queries"],
           "sparse_fallbacks": st["sparse_fallbacks"],
           "certificate_fallbacks": st["fallbacks"]}
    log(f"default ladder: {out}")
    return out


def run(n_docs: int, n_batches: int, batch: int) -> dict:
    import torch

    from elasticsearch_tpu_torch.common import hbm_ledger
    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.parallel import cuda_build, kernels
    from elasticsearch_tpu_torch.search.serving import (
        extract_plan, select_bm25_engine,
    )

    log("building kernels with nvcc")
    t = time.time()
    cuda_build.build_all()
    build_s = time.time() - t
    for name, text in sorted(cuda_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"kernels built in {build_s:.1f}s")

    if n_docs < FULL_DOCS:
        log(f"CUT: index cut from {FULL_DOCS} to {n_docs} docs")
    t = time.time()
    fp, n_tokens = build_index(n_docs, VOCAB)
    log(f"index: {n_docs} docs, {n_tokens} tokens, "
        f"{len(fp.post_doc)} postings in {time.time() - t:.1f}s")

    t = time.time()
    eng = select_bm25_engine([_Seg(n_docs, fp)], "body", device="cuda",
                             hbm_budget_bytes=TURBO_HBM, cold_df=COLD_DF)
    turbo = eng.turbos[0]
    log(f"engine: Dp={turbo.Dp} nsw={turbo.nsw} Hp={turbo.Hp} "
        f"device bytes={eng.hbm_bytes()} in {time.time() - t:.1f}s")
    require(turbo._sp_ok, "sparse tier is off (Dp > 2^23)")

    batches = draw_batches(n_batches, batch, VOCAB)
    mapper = MapperService({"properties": {"body": {"type": "text"}}})
    plans = [extract_plan(b, mapper) for b in DSL_BODIES]
    require(all(p is not None and p.is_disjunctive for p in plans),
            "a DSL body did not flatten to a disjunction")
    dsl = [p.disj for p in plans]

    # ---- the main path, with every launch count read around it ----
    fault_log = []
    kernels.reset_launches()
    t = time.time()
    n_cols = eng.prebuild_columns()
    torch.cuda.synchronize()
    prebuild_s = time.time() - t
    results, lat, cert_fb, k3_per = [], [], [], []
    for b in batches + [dsl]:
        fb0 = eng.stats["fallbacks"]
        k30 = kernels.LAUNCHES["sparse_gather"]
        t = time.time()
        results.append(eng.search_many([b], k=K, fault_log=fault_log)[0])
        lat.append(time.time() - t)
        cert_fb.append(eng.stats["fallbacks"] - fb0)
        k3_per.append(kernels.LAUNCHES["sparse_gather"] - k30)
    launches = dict(kernels.LAUNCHES)
    log(f"main path: {n_cols} columns prebuilt in {prebuild_s:.2f}s; "
        f"batch latencies {[round(x, 4) for x in lat]}s; launches {launches}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path never launched: {launches}")
    st = eng.stats
    require(not fault_log, f"fault records: {fault_log}")
    for key in ("sparse_fallbacks", "degraded", "cold_queries",
                "health_device_faults", "health_fallback_queries"):
        require(st[key] == 0, f"{key} = {st[key]}")
    # a failed certificate is the algorithm's own exact path: heavily tied
    # hot-term queries fill the collected rows with equal scores
    # (tests/test_torch_turbo.py's tie_heavy_fallback case shows the
    # reference failing the same certificates). Their answers come from the
    # exact merge; their sweeps are among those K2 is held on below.
    n_main = sum(len(b) for b in batches + [dsl])
    log(f"certificate fallbacks: {st['fallbacks']} of {n_main} queries")
    require(st["fallbacks"] <= MAX_CERT_FALLBACK_SHARE * n_main,
            f"certificate fallbacks {st['fallbacks']} exceed "
            f"{MAX_CERT_FALLBACK_SHARE} of {n_main} queries")
    require(st["sparse_queries"] > 0, "no query took the sparse tier")

    # ---- hold: every top-10 against the host-exact tier ----
    t = time.time()
    n_q = 0
    held = []
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        for b, (s, p, o) in zip(batches + [dsl], results):
            require(s.shape == (len(b), K) and np.isfinite(s).all(),
                    "result shape or finiteness")
            require(not p.any(), "partition ids on a one-partition engine")
            parts = [b[i:i + 16] for i in range(0, len(b), 16)]
            host = list(ex.map(lambda q: turbo.search_many_host([q], k=K)[0],
                               parts))
            hs = np.concatenate([h[0] for h in host])
            ho = np.concatenate([h[1] for h in host])
            ho[hs <= 0] = 0
            require(np.array_equal(s, hs) and np.array_equal(o, ho),
                    "device route differs from the host-exact tier")
            held.append((hs, ho))
            n_q += len(b)
    log(f"host-exact hold: {n_q} queries bitwise equal in "
        f"{time.time() - t:.1f}s")
    for qi in range(4):
        for b, (s, _, o) in ((batches[0], results[0]), (dsl, results[-1])):
            terms = [(x, 1.0) if isinstance(x, str) else x for x in b[qi]]
            agg = {}
            for x, w in terms:
                agg[x] = agg.get(x, 0.0) + w
            bs, bd = brute_topk(fp, n_docs, list(agg.items()))
            require(np.array_equal(o[qi][:len(bd)], bd)
                    and np.array_equal(s[qi][:len(bs)], bs),
                    f"query {b[qi]} differs from the numpy scorer")
    log("numpy scorer agrees on 8 queries")

    # ---- each kernel against its plain version at the path's shapes ----
    rows = [check_k1(turbo, launches["build_columns"])]
    torch.cuda.empty_cache()
    rows.append(check_k2(turbo, batches[0], launches["sweep_rowmax"]))
    rows.append(check_k3(turbo, batches[0], launches["sparse_gather"]))
    for r in rows:
        log(f"{r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
            f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{r['library_ms']}, launches {r['launches']}")

    peak = torch.cuda.max_memory_allocated()
    ledger = hbm_ledger.hbm_stats()
    del eng, turbo
    torch.cuda.empty_cache()
    default = default_ladder(fp, n_docs, batches[0], held[0])

    serving = {"docs": n_docs, "cut": n_docs < FULL_DOCS,
               "sparse_widths": WIDE_LADDER,
               "queries": n_q, "batch_latency_s": lat,
               "qps_per_batch": [len(b) / x for b, x in
                                 zip(batches + [dsl], lat)],
               "prebuild_s": prebuild_s, "columns": n_cols,
               "certificate_fallbacks_per_batch": cert_fb,
               "certificate_fallback_limit": MAX_CERT_FALLBACK_SHARE,
               "k3_launches_per_batch": k3_per,
               "default_ladder": default,
               "hbm_ledger": ledger,
               "kernel_build_s": build_s,
               "peak_device_bytes": peak}
    return {"kernels": rows, "serving": serving}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=FULL_DOCS,
                    help="index size (default: one 8M-doc shard)")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    os.environ["ES_TPU_SPARSE_WIDTHS"] = WIDE_LADDER
    try:
        import elasticsearch_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 2
    out = run(args.docs, args.batches, args.batch)
    print(json.dumps({"serving": out["serving"]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": out["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
