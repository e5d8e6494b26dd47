#!/usr/bin/env python3
"""Quickest proof that the PyTorch + CUDA port serves on an NVIDIA H100.

    python3 chip_smoke.py            # one card; exits 0 only if every check holds
    python3 chip_smoke.py --docs N   # cut the index (and the dense phase) to N docs
    python3 chip_smoke.py --knn-docs N   # cut the kNN column to N vectors
    python3 chip_smoke.py --agg-docs N   # cut the agg leaf to N docs
    python3 chip_smoke.py --k2-parent OLD.cu   # time earlier sweeps beside them
    python3 chip_smoke.py --k8-parent OLD.cu --k4-parent OLD.cu   # and K8, K4
    python3 chip_smoke.py --k5-parent OLD.cu   # and K5's stage
    python3 chip_smoke.py --scatter-parent OLD.cu   # and the block scatter
    python3 chip_smoke.py --lane-topk-parent OLD.cu   # and K10 lane_topk
    python3 chip_smoke.py --weighted-scatter-parent OLD.cu   # and K11
    python3 chip_smoke.py --serving-only --docs N   # step 8 alone, no ok line
    python3 chip_smoke.py --admin-only --docs N     # step 8's admin phase alone
    python3 chip_smoke.py --blockmax-only --docs N  # step 9 alone
    python3 chip_smoke.py --fused-only --docs N     # step 6b alone

It drives the port's main path (elasticsearch_tpu_torch only; it imports
nothing of JAX or of elasticsearch_tpu) the way bench.py drives config 1 of
BASELINE.md, at the size of one primary shard of the 33M-doc Wikipedia-EN
target, then the kNN path the way bench.py drives config 4 and the
aggregation path the way bench.py drives config 6:

1. builds the CUDA kernels (K1 build_columns, K2 sweep_rowmax,
   K3 sparse_gather, K5 intersect_bitset, K6 sweep_rowmax_bitset,
   K7 sweep_rowmax_conj, K4 merge_topk, K9 knn_int8_window_topc,
   K8 agg_counts, the bitset pack pack_presence_bits, the dense
   executor's block scatter, bm25_block_scatter and block_presence,
   BlockMax's K10 lane_topk and K11 weighted_block_scatter, and the fused
   S > 1 sweeps F1-F3) from parallel/csrc with nvcc, one process per
   source, all at once;
2. builds one 8,000,000-doc shard with positions on the host: docs of 8-40
   terms over a 500k-term Zipf(1.07) vocabulary, seeded as bench.py does;
3. selects the engine with `select_bm25_engine(device="cuda")` (cold_df
   65536, 7 GiB column budget, bench.py's settings) at the widened slice
   ladder below, prebuilds every column (K1 at full width) and serves two
   batches of 256 two-term Zipf queries and a batch of `match` DSL bodies
   through `extract_plan` (K2 at QC = 256, K3 once per group of a sweep
   chunk's cold sides), with every kernel's launch count set to 0 just
   before and read just after;
4. requires no fault record, host-tier fallback, sparse fallback or
   degraded column, at most MAX_CERT_FALLBACK_SHARE of the queries failing
   their certificate (the algorithm's own exact path for heavily tied
   queries), and holds the top-10 (scores, ords) of the DSL bodies and of
   the first HOLD_PER_BATCH queries of each batch bitwise against the
   port's own host-exact tier, and a few against an independent numpy
   scorer;
5. runs each kernel and its plain torch version on the same inputs at the
   path's shapes, requires bitwise agreement, and times both (CUDA events,
   median), with one PyTorch library call beside K2 and K3 as a yardstick;
   K3 is held on every group the path launched (each recorded with a copy
   of the slice pool it read), and on the first batch also timed query by
   query as the old one-launch-per-query pattern ran it, this tree's
   kernel and, given --k3-parent, the parent commit's; the sweeps (K2,
   and K6 and K7 in step 6) are also timed alone (torch.profiler's kernel
   events) and, given --k2-parent (a whole earlier sweep_rowmax.cu),
   beside the parent commit's on the same inputs, in turns, each held
   bitwise on outputs filled with NaN first; so are K1 (its tiles filled
   with a nonzero byte pattern, a zero group for each tile of a free slot
   added), K3, and in step 6 K5, on outputs filled so by
   kernels.poisoned;
6. on the same engine, serves config 2 (256 bool queries drawn as
   bench.py's draw_bool, plus bool DSL bodies through extract_plan and
   _turbo_bool_spec) on both sweeps: ES_TPU_BITSET=1 (K5 + K6) and
   ES_TPU_BITSET=0 (K7), counts set to 0 before each; then config 3 (256
   slop-0 phrases drawn as bench.py's draw_phrases, in batches of 64 so
   none degrades, K1 building their adjacency columns; two head-term
   phrases that take the device sweep) and one slop-2 match_phrase body
   (the exact host route). Every answer is held bitwise against
   search_bool_host and some against a numpy scorer; certificate
   fallbacks that a numpy check of exact scores does not explain are
   held to MAX_CERT_FALLBACK_SHARE; no plain version runs on either
   route (the bitset pack and K5's chunk counts are kernels there); the
   bitset pack is held bitwise against its plain version on the shard's
   whole column cache and timed, with the repack's peak device memory;
   K5-K7 are held against their plain versions on the bitset route's
   device chunk and timed, K5 (mask and chunk counts in one launch) also
   alone, from a CUDA graph and for its host enqueue, and given
   --k5-parent beside the parent commit's K5 and the torch
   mask_chunk_counts after it, in turns; K3 on every group of cold SHOULD
   sides each route launched; each K1 launch of the phrase phase is timed
   again on its recorded groups beside its bound;
6b. cuts the shard by doc range into four 2,000,000-doc segments (its
   postings split, no new draw) and serves them through
   select_bm25_engine(device="cuda"), the fused route of an index of
   several segments (fused_phase): both config-1 batches and the DSL
   plans, config 2 on both sweeps and the first 64 slop-0 phrases with the
   two head-term ones, one F1, F2 or F3 launch per query chunk for all
   four partitions, no K2 / K5-K7 launch, K4 on every merge; every top-10
   bitwise the sequential route's on the same partitions, and the
   single-segment rows' (doc ids mapped), so the host-exact tier's; then
   F1-F3 held bitwise against their plain versions at every launch shape,
   also poisoned, timed by events, by CUDA graph and alone beside the S
   separate K2 / K7 / K5 + K6 launches on the same inputs, torch._int_mm
   and their byte bounds;
7. on the same shard as one port Segment on the card (the `body`
   postings, `views` / `price` / `published` / `tags` columns drawn with
   numpy seed 46, `_source` built on access, 1% of the docs deleted),
   drives the dense search path, `search.execute_search` (the query phase
   over the QueryExecutor, the fetch phase, highlight, aggs), with 25
   `_search` bodies of shapes the Turbo route declines (bool filters and
   must_not, minimum_should_match, operator and, prefix / wildcard /
   terms / range / exists, function_score log1p, constant_score, sort
   with search_after, from / size, track_total_hits, _source includes,
   highlight, min_score, terms + avg aggs, profile), each once warm and
   5 times timed; no plain version may run. Every card response is held
   against the port's own CPU response on the same segment (equal;
   scores bit for bit, within DENSE_SCORE_ULPS through log1p), the pure
   `match` bodies also against brute_topk; both block-scatter kernels are
   held bitwise against their plain versions (also on poisoned outputs)
   on a head, a mid and a rare term, and presence on a `tags` term and
   the `tag1` prefix's terms, and timed by events, alone and by CUDA
   graph, beside their plain versions and `index_put_`, and given
   --scatter-parent beside the parent commit's kernel in turns;
8. serves the product's entry point on the same segment, all live
   (serving_phase): a one-shard port IndexService on the card, with the
   main path's knobs, takes IndexService.msearch of both config-1
   batches as DSL bodies and of the DSL bodies (one _disjunctive_batch
   each), the first batch again as single IndexService.search calls from
   32 threads at once (the adaptive scheduler's lanes) and one at a time
   with ES_TPU_COALESCE_US=0, config 2's 256 bool bodies and config 3's
   first 64 slop-0 phrases one at a time (_conjunctive -> search_bool),
   the 25 dense bodies, 16 size-0 aggregation bodies from 16 threads at
   once (K8 on the bulk tier at Q > 1), and on a second service of two
   131,072-row segments (config 4's generator, cut from 2M to fit the
   clock) the 8 kNN bodies through _knn_batch (K9, K4). Its rows equal
   the main path's bitwise, every fast-path response the dense
   executor's within tests/test_serving.py's bound, the aggregations the
   host aggregators', the kNN ids and order the KnnEngine's dense
   route's within KNN_GAMMA; no fault, timeout, BlockMax decline or
   plain version, every kernel of the path launched. Then K2, K3, K4,
   K5, K6 and K9 are held bitwise against their plain versions (also on
   poisoned outputs) at every launch shape the path gave them, on the
   first such launch's inputs, K2 and K6 timed by CUDA graph beside their
   bounds, and K8 is timed at its largest Q. Then the REST node
   (rest_phase): `python -m elasticsearch_tpu_torch`'s Node on the card
   with both services installed and an HttpServer on a free port takes
   the same traffic over HTTP from 127.0.0.1 (_msearch of batch 0 and of
   the DSL bodies, batch 0's singles from 32 threads and one at a time,
   the bool and phrase bodies as _msearch, the dense bodies, the 16 agg
   bodies from 16 threads with the request cache emptied, the kNN bodies
   as _msearch) and the node's own endpoints; every search response
   equals the serving phase's for the same body but for `took`, scores
   bitwise; a 429 is retried after its Retry-After and counted, any
   other status fails; every new launch shape is held as above. Then the
   rest of the REST node (admin_phase): a second Node with
   xpack.security.enabled takes batch 0 as an authenticated _msearch (a
   user, an API key; 401 without credentials, 403 for a role without the
   index) and as authenticated singles, _search/template of 32 queries,
   _async_search of bool and agg bodies with _tasks listing them, a
   snapshot of the kNN index and of a 1,000,000-doc BM25 index and their
   restore under new names (the restored indices answer batch 0 and the
   kNN bodies as the originals do; K1 builds their columns), a
   10,000-doc index through _bulk, _rollover, _close / _open and _split,
   and _field_caps, _explain, _termvectors, _rank_eval, the _tpu routes,
   hot threads and eight _cat tables; every answer held as above, every
   new launch shape held;
9. serves the same shard where the reference selects BlockMax
   (blockmax_phase): a one-shard port IndexService with ES_TPU_TURBO_HBM
   far below the shard's Turbo columns, so the snapshot's engine is
   BlockMaxBM25 (routing reason exceeds_hbm_budget); both config-1
   batches through IndexService.msearch (K10 `lane_topk` in its lane and
   hybrid modes, K4), then 4 pasted-text `match` bodies of 100 rare terms
   (K10 rows of 100 runs) and 2 `match` bodies of mid terms whose blocks
   pass the largest bucket (the overflow path's traffic; whether msearch
   sent them there is counted), config 2's 256 bool specs through search_bool (the
   host conjunction, the device program, the host overflow; routes
   counted) and 16 heavy ones as one device group (K10's bool mode), and
   the overflow path on 8 batch-0 queries, the 4 long bodies and the 2
   large ones with every block kept (K11 `weighted_block_scatter`, one
   call a query: a run a non-hot term), every answer held to the
   host-exact rows (the long and large bodies to the numpy scorer) under
   tests/test_blockmax.py's rule (scores
   within 2e-5, ids and order but across near-ties); then the spmd
   programs at a cut (4 stacked
   partitions of 250,000 docs, 64 queries): sharded_bm25_topk,
   Bm25ColumnCache and sharded_knn_topk, held to numpy rankings; every
   K10, K11 and K4 launch shape of both held bitwise against its plain
   version, also poisoned, and timed beside its bound and a library
   yardstick (torch.sort of K10's lanes, index_add_ of K11's), K10 also
   beside the parent commit's kernel where --lane-topk-parent names it,
   and K11 on each overflow query beside the parent commit's launch a run
   where --weighted-scatter-parent names it (by CUDA graph, and by events
   with the host copies); then the cluster path (cluster_phase): three
   ClusterNodes of form_local_cluster(device="cuda") sharing the card,
   the earlier phases' engines freed first; a serving index of one
   primary shard whose engine holds the same segment, all live, takes
   batch 0's 256 `match` bodies, 128 of config 2's bool bodies and the
   64 slop-0 phrase bodies from 16 threads through ClusterNode.search on
   another node (the transport fan-out, the shard query phase on the data
   node's ServingContext: K1, K2, K3, K5, K6 launched, counted around the
   traffic; the fetch; the reduce), every top-10 bitwise the serving
   phase's for the same body and every new launch shape held against its
   plain version; then a replicated index of 20,000 docs (CUT from 8M for
   Python ingest: two primaries, a replica each, through the cluster's
   _bulk) is held to the dense route (ES_TPU_DISABLE_SHARD_SERVING=1), a
   primary relocates with the warm handoff (cold-term slices pre-built
   on the target, no warm failure), a node holding a primary dies (a
   replica promoted, the lost copies recovered from the new primaries),
   the answers bitwise equal after each step; the phase's peak device
   memory printed;
10. serves the first batch again on a fresh engine at the default slice
   ladder and reports its sparse fallbacks, holding the answers that step
   4 held;
11. frees the BM25 index and serves quantized kNN (config 4: 768-d cosine
   rows drawn as bench.py draws them, 128 of its 256 queries with 16
   planted near-duplicate rows each) through `select_knn_engine` ->
   `KnnEngine.search_many`, first on one partition, then, after freeing
   it, on the same rows stacked as 4 partitions (one K9 launch for all,
   the K4 device merge): the int8 route, the dense route
   (ES_TPU_KNN_INT8=0), 256 filtered queries (50% and 2% masks, K9's
   masked variant) on both, 8 `knn` DSL bodies through extract_knn_plan
   (4 filtered on a keyword tag) on both, and a batch at
   ES_TPU_KNN_NPROBE=24. It requires no fault record and no host
   fallback, the int8 route's ids and order equal to the dense route's
   (a near-tie swap inside the score bound is counted), every score within
   the bound of two f32 summation orders (KNN_GAMMA), recall@10 >= 0.99
   against exact f32 scores on 32 queries, the stacked engine's planted
   answers equal to one partition's, and K9 (both variants, both engines,
   and on 16 of the queries) and K4 bitwise equal to their plain versions
   on the path's inputs, K9 timed with its score and selection passes
   apart;
12. serves config 6 (analytics) at bench.py's 10,000,000 docs: a leaf drawn
   as bench.py's _synth_agg_leaf (Zipf tags, a 90-day timestamp, prices
   with gaps), AGG_BENCH_SPEC (terms + stats, 7d date_histogram + sum)
   over 8 masks at 5% through parse_aggs -> collect_leaf ->
   reduce_partials -> finalize_aggs on the default AggDeviceEngine (K8),
   one warm request building the layouts first. It requires every
   collect on the device with no host fallback, K8 launched once per
   dispatch, ledger bytes equal to the engine's; times the 8 requests
   again with the bulk tier's wait at 0 (ES_TPU_SCHED_BULK_US=0, its
   answers equal); holds two requests and
   the reference suite's shapes (terms, terms with four metrics,
   histogram, three date_histograms) on 5%, 2%, 90% and empty masks
   against the port's host path (==); hands the 8 works to one
   search_many call and holds each against its own dispatch; and holds
   K8 bitwise against its plain version on the path's layouts at Q = 1,
   4, 16 and 64 and on a synthetic four-tile one, timed by events, alone
   and beside the parent commit's kernel given --k8-parent (K4 likewise
   in step 11, given --k4-parent, with its host enqueue), K9 and K4 also on
   outputs filled with NaN / -1 first;
13. prints the card's name and power limit and a `kernels` JSON line, and
   last `{"ok": true, "device": {...}}`.

The integrity plane runs on engines the phases already built
(`integrity_phase`): the main path's TurboBM25 at the end of step 6 (before
the fused phase frees it), knn_phase's S = 1 engine and agg_phase's
layouts. Each gets one full HBM scrub cycle (every region downloaded once
and hashed, each region's bytes and seconds logged; all clean or
baselined), an injected `hbm_region#<region>` flip and an in-place flip of
one device tensor through .copy_() (Turbo's column cache, whose repair
drops the cache so K1 rebuilds), each found and repaired; then the
engine's held answers again, bitwise (K1-K3, K9, K8 launched after the
repairs; kNN also within KNN_GAMMA of the dense route), and, where the
engine has a health circuit (Turbo, kNN), ES_TPU_HEALTH_TRIP_N injected
mismatches open it and a search after the backoff closes it. The cluster
phase runs its replicated index with ES_TPU_CHECK_ON_STARTUP on, then
`startup_scan_step`: four CrashRestartCluster nodes with data paths, a
recovered copy whose startup scan reads a flipped blob is failed before
it starts and recovered again.

The kNN column is cut from bench.py's 10M vectors to 2,000,000: at 10M a
single run would hold three 30 GB host copies of the column, assign 10M
rows to 1024 k-means centroids on the host and upload a 15 GB dense
mirror. bench.py's shapes are kept: 768 dims, cosine, k = 10, 256 queries.

Any failed check raises: the script then exits nonzero and prints no
result. Without CUDA, or without the package beside it, it exits 2.

The main path runs at a slice-width ladder extended to 65536
(ES_TPU_SPARSE_WIDTHS=1024,4096,16384,65536), not the default
1024,4096,16384, so every cold term (df < cold_df = 65536) gets a device
slice: with the default ladder a query with a cold term of df 16385-65535
has its whole cold side scored on the host (a sparse fallback), which the
main path refuses. Step 10 measures how often that happens at the default.
"""

from __future__ import annotations

import argparse
import contextlib
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
# certificate fallbacks allowed, as a share of a path's queries. A fallback
# is the algorithm's own exact route on a tied query, not a fault: hot Zipf
# terms tie on thousands of docs, more than the collected rows hold. The
# disjunctive path: 5 of 520 at full size. The bool and phrase paths,
# counted separately per route, count only the fallbacks that
# fallback_explained() does not explain from exact scores.
MAX_CERT_FALLBACK_SHARE = 0.02
# where the K3 A/B looks for the parent kernel's source by default (the
# gitignored build directory): write it there with
#   git show HEAD~1:elasticsearch_tpu_torch/parallel/csrc/sparse_gather.cu
K3_PARENT = "elasticsearch_tpu_torch/parallel/csrc/build/k3_parent.cu"
# and the sweeps' A/B parent (check_k2, check_k6, check_k7: its three
# entries), written there with
#   git show HEAD~1:elasticsearch_tpu_torch/parallel/csrc/sweep_rowmax.cu
K2_PARENT = "elasticsearch_tpu_torch/parallel/csrc/build/k2_parent.cu"
# and K8's and K4's (check_k8, check_k4), written there with
#   git show HEAD~1:elasticsearch_tpu_torch/parallel/csrc/agg_counts.cu
#   git show HEAD~1:elasticsearch_tpu_torch/parallel/csrc/merge_topk.cu
K8_PARENT = "elasticsearch_tpu_torch/parallel/csrc/build/k8_parent.cu"
K4_PARENT = "elasticsearch_tpu_torch/parallel/csrc/build/k4_parent.cu"
# and K5's (check_k5: its mask-only C entry, timed with the torch
# mask_chunk_counts after it), written there with
#   git show HEAD~1:elasticsearch_tpu_torch/parallel/csrc/intersect_bitset.cu
K5_PARENT = "elasticsearch_tpu_torch/parallel/csrc/build/k5_parent.cu"
# and the block scatter's (check_block_scatter: the one-thread-a-lane
# kernel, with the same C entries as this tree's), written there with
#   git show HEAD~1:elasticsearch_tpu_torch/parallel/csrc/block_scatter.cu
SCATTER_PARENT = ("elasticsearch_tpu_torch/parallel/csrc/build/"
                  "scatter_parent.cu")
# and K10's (check_path_shapes at every BlockMax and spmd launch shape: the
# one-block-a-row kernel, its C entry without the tile scratch), written
# there with
#   git show HEAD~1:elasticsearch_tpu_torch/parallel/csrc/lane_topk.cu
LANE_TOPK_PARENT = ("elasticsearch_tpu_torch/parallel/csrc/build/"
                    "lane_topk_parent.cu")
# and K11's (weighted_ab on every overflow query: a wrapper call per run,
# its C entry without the run offsets), written there with
#   git show HEAD~1:elasticsearch_tpu_torch/parallel/csrc/block_scatter.cu
WEIGHTED_PARENT = ("elasticsearch_tpu_torch/parallel/csrc/build/"
                   "weighted_parent.cu")
# blocks a call of the parent's overflow path took at most (its caller's
# _OVERFLOW_CHUNK), which the K11 A/B cuts a run into
PARENT_OVERFLOW_CHUNK = 8192
# CUDA-graph replays a K10 timing averages over in the A/B (lane_ab): its
# pass-A launches take about 0.01 ms
GRAPH_REPS_K10 = 200
# CUDA-graph replays a block-scatter timing averages over: a mid or rare
# term's call is about 0.01 ms, and 20 replays left its graph time to the
# events' resolution and the clock's ramp
SCATTER_GRAPH_REPS = 200
# queries of each config-1 batch held against the host-exact tier (the DSL
# bodies are held in full): the hold is host work, about 0.6 s a query on
# the chip machine's 8 cores, and the cut keeps the whole run, kNN and agg
# phases included, well inside its time limit
HOLD_PER_BATCH = 80
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


def zipf_tokens(rng, n: int, vocab: int) -> np.ndarray:
    """rng.choice(vocab, size=n, p=zipf_probs(vocab)), bit for bit: numpy's
    Generator.choice draws rng.random(n) and searches the normalised CDF
    (zipf_tokens_match holds the two equal); the search runs here in
    threads, a slice each (searchsorted releases the GIL)."""
    cdf = zipf_probs(vocab).cumsum()
    cdf /= cdf[-1]
    u = rng.random(n)
    out = np.empty(n, np.int64)
    step = max(1, -(-n // (os.cpu_count() or 1)))

    def part(o):
        out[o:o + step] = cdf.searchsorted(u[o:o + step], side="right")

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        list(ex.map(part, range(0, n, step)))
    return out


def zipf_tokens_match() -> None:
    """zipf_tokens equals this numpy's Generator.choice on a fresh draw."""
    a = np.random.default_rng(1).choice(VOCAB, size=100_000,
                                        p=zipf_probs(VOCAB))
    require(np.array_equal(zipf_tokens(np.random.default_rng(1), 100_000,
                                       VOCAB), a),
            "zipf_tokens differs from Generator.choice")


def prefetch(fn, *args, **kw):
    """fn(*args, **kw) started now in a thread of its own (numpy releases
    the GIL in its draws); the returned future's result() joins it."""
    ex = ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(fn, *args, **kw)
    ex.shutdown(wait=False)
    return fut


def build_index(n_docs: int, vocab: int, seed: int = 42):
    """The corpus and its positional postings, as bench.py builds them;
    also returns the token stream and doc bounds (phrases are drawn from
    real adjacencies)."""
    from elasticsearch_tpu_torch.index.segment import build_field_postings

    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 40, size=n_docs).astype(np.int64)
    tokens = zipf_tokens(rng, int(lens.sum()), vocab)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    tok_docs = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    tok_pos = np.arange(len(tokens), dtype=np.int64) - bounds[tok_docs]
    fp = build_field_postings("body", lens, tok_docs, tokens,
                              [f"t{i}" for i in range(vocab)],
                              token_pos=tok_pos)
    return fp, tokens, bounds


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


def brute_topk(fp, total_docs, terms, k=K, live=None):
    """Independent numpy scorer: term-at-a-time f32 BM25 over the postings,
    (score desc, doc asc) — the accumulation order of the reference scorer;
    over the docs `live` marks, where given."""
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
    if live is not None:
        dense[~live] = 0
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


def graph_ms(fn, reps: int = 20):
    """Device time per call of fn's work with no host in the way: fn
    captured once into a CUDA graph (its allocations from the graph's own
    pool) and the graph replayed `reps` times between two CUDA events. It
    counts every kernel and fill the call makes, and does not depend on
    the profiler, which drops kernel events in a long run."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        g.replay()
    e.record()
    e.synchronize()
    ms = s.elapsed_time(e) / reps
    del g
    torch.cuda.empty_cache()
    return float(ms)


def kernel_alone(fn, names, reps: int = 3, per_call=None):
    """k9_ab.kernel_alone: (ms alone per call, {"ms", "events", "short"}),
    a count short of the launches printed as SHORT."""
    from elasticsearch_tpu_torch.tools.k9_ab import kernel_alone as alone

    return alone(fn, names, reps, per_call)


COL_POISON = 0x5A          # K1's int8 column tiles are filled with it first


def check_k1(turbo, launches):
    """K1 rebuilds every prebuilt column, plus a zero group (nrows = 0) for
    each tile of a free slot, into tiles filled with a nonzero byte pattern
    first (W15: a group left unwritten keeps the pattern): timed through
    the wrapper, then once more on freshly filled tiles. The groups' tiles
    must equal the main path's columns, the zero groups' tiles must be
    zeros, every other tile must keep the pattern, and the plain version
    (on the same pattern) must agree bitwise."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    dev = turbo.device
    parts = [turbo._term_groups(turbo._term(t), s)
             for t, s in turbo._slot_of.items()]
    require(turbo._free, "K1: no free slot for the zero groups")
    n_tiles = turbo.cols_hi.shape[0] // (k.TILE // k.CHUNK)
    zero = np.zeros(n_tiles, np.int32)
    parts.append((zero, zero, np.arange(n_tiles, dtype=np.int32) * k.TILE,
                  np.full(n_tiles, turbo._free[0], np.int32)))
    g = [torch.from_numpy(np.concatenate([p[i] for p in parts])).to(dev)
         for i in range(4)]
    ng = int(g[0].shape[0])
    hi_k, lo_k = (torch.empty_like(c).fill_(COL_POISON)
                  for c in (turbo.cols_hi, turbo.cols_lo))

    def kern():
        k.build_columns(*g, turbo.lane_docs, turbo.lane_scores, hi_k, lo_k)

    ms = cuda_ms(kern, 5)
    hi_k.fill_(COL_POISON)
    lo_k.fill_(COL_POISON)
    kern()
    hpt = turbo.cols_hi.shape[1]
    written = torch.zeros((n_tiles, hpt), dtype=torch.int8, device=dev)
    gn = g[1] > 0
    written[(g[2] // k.TILE).long(), g[3].long()] = torch.where(
        gn, 1, 2).to(torch.int8)          # 1: a term's tile, 2: a zero group
    w = written[:, None, :, None]
    for got, main in ((hi_k, turbo.cols_hi), (lo_k, turbo.cols_lo)):
        shape = (n_tiles, k.TILE // k.CHUNK, hpt, k.CHUNK)
        want = torch.where(w == 1, main.view(shape), torch.where(
            w == 2, torch.zeros((), dtype=torch.int8, device=dev),
            torch.full((), COL_POISON, dtype=torch.int8, device=dev)))
        require(torch.equal(got.view(shape), want),
                "K1 on poisoned tiles: rebuilt columns differ from the main "
                "path's, a zero group left its tile, or a tile outside the "
                "groups was written")
        del want
    hi_p, lo_p = (torch.empty_like(c).fill_(COL_POISON) for c in (hi_k, lo_k))
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
            "library_ms": None, "poisoned_run": "bitwise",
            "shape": {"groups": ng, "zero_groups": n_tiles, "lanes": lanes}}


def sweep_ab(label, wrapper, plain, args, nsw, parent=None):
    """One sweep held and timed on the same inputs: the wrapper (`wrapper`
    (*args, nsw=)) by CUDA events and alone (torch.profiler's kernel
    events) and, given the parent commit's source (`parent`, a runner from
    k2_ab.parent_runner), the parent's kernel in turns (parent, kernel,
    kernel, parent); the kernel held bitwise against the plain version,
    once more on outputs filled with NaN / -1 first (kernels.poisoned), so
    no result of an earlier call in reused memory can pass for its own,
    and the parent's outputs (filled so too) held the same way. Returns
    the row's timing and error keys."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    out = {}

    def kern():
        out["k"] = wrapper(*args, nsw=nsw)

    def par():
        parent(args, nsw)

    turns = {"parent": [], "kernel": []}
    for name in (["parent"] if parent else []) + ["kernel", "kernel"] + (
            ["parent"] if parent else []):
        turns[name].append(cuda_ms(kern if name == "kernel" else par, 10))
    ms = float(np.median(turns["kernel"]))
    kernel_ms, events = kernel_alone(kern, ("sweep",))
    parent_ms = parent_kernel_ms = parent_events = None
    if parent:
        parent_ms = turns["parent"]
        parent_kernel_ms, parent_events = kernel_alone(par, ("sweep",))
    plain_ms = cuda_ms(lambda: out.__setitem__("p", plain(*args, nsw=nsw)), 1)
    (km, kr), (pm, pr) = out["k"], out["p"]
    err = max(max_abs_err(km, pm), max_abs_err(kr, pr))
    require(err == 0.0 and torch.equal(km, pm) and torch.equal(kr, pr),
            f"{label} kernel vs plain: max_abs_err {err}")
    with k.poisoned():
        pm2, pr2 = wrapper(*args, nsw=nsw)
    require(torch.equal(pm2, pm) and torch.equal(pr2, pr),
            f"{label} kernel on poisoned outputs vs plain differ")
    if parent:
        pm3, pr3 = parent(args, nsw, poison=True)
        require(torch.equal(pm3, pm) and torch.equal(pr3, pr),
                f"{label} parent kernel on poisoned outputs vs plain differ")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "kernel_ms": kernel_ms, "kernel_events": events,
            "events_ms": turns["kernel"], "parent_ms": parent_ms,
            "parent_kernel_ms": parent_kernel_ms,
            "parent_kernel_events": parent_events}


def check_k2(turbo, batch, launches, parent=None):
    """K2 at QC 256 on the first batch's weights, held and timed by
    sweep_ab (the parent's K2 beside it when given)."""
    import torch

    from elasticsearch_tpu_torch.parallel import cuda_build
    from elasticsearch_tpu_torch.parallel import kernels as k
    from elasticsearch_tpu_torch.parallel.turbo import _flatten_queries
    from elasticsearch_tpu_torch.tools.k2_ab import sweep_work

    dev = turbo.device
    flat, _ = _flatten_queries([batch])
    qc = 256
    wq_np, qs_np = turbo._sweep_weights(flat[:qc], qc)
    wq = torch.from_numpy(wq_np).to(dev)
    qs = torch.from_numpy(qs_np).to(dev)
    args = (qs, turbo.cols_hi, turbo.cols_lo, wq, turbo.live)
    timing = sweep_ab("K2", k.sweep_rowmax, k.sweep_rowmax_plain,
                      args, turbo.nsw, parent)
    nbytes, ops, n_union, nnz = sweep_work(wq_np, turbo.Dp, turbo.nsw)
    b_ms, b_by = bound(nbytes, ops, PEAK_INT8)
    # G as the built kernel reports it, held to the wrapper's mirror
    group = cuda_build.kernel("sweep_group")()
    require(group == k.SWEEP_GROUP,
            f"K2 built with G {group}, kernels.SWEEP_GROUP {k.SWEEP_GROUP}")
    lib_ms = int_mm_ms(turbo, wq)
    hpt = turbo.cols_hi.shape[1]
    return {"name": "sweep_rowmax", "route": "cuda",
            "source": "elasticsearch_tpu_torch/parallel/csrc/sweep_rowmax.cu",
            "replaces": "elasticsearch_tpu/parallel/kernels.py:190",
            "launches": launches, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, **timing, "group": group,
            "shape": {"QC": qc, "Hpt": hpt, "nsw": turbo.nsw,
                      "union_slots": n_union, "nonzero_weights": nnz}}


def int_mm_ms(turbo, wq) -> float:
    """Yardstick of the sweeps: the four int8 score products as one
    cuBLASLt int8 GEMM over the dense slots, [wh; wl] @ [cols_hi | cols_lo]
    (the port never calls it)."""
    return int_mm_cols_ms(turbo.cols_hi, turbo.cols_lo, turbo.Dp, wq)


def int_mm_cols_ms(cols_hi, cols_lo, dp: int, wq) -> float:
    """int_mm_ms on one partition's columns (dp docs) and weights."""
    import torch

    qc, hpt = wq.shape[1], cols_hi.shape[1]
    k8 = -(-hpt // 8) * 8
    # cuBLASLt's int8 product refuses narrow row counts (16, 24): a narrow
    # chunk's weights are padded with zero rows to 64
    a = torch.zeros((max(2 * qc, 64), k8), dtype=torch.int8,
                    device=wq.device)
    a[:2 * qc, :hpt] = wq.reshape(2 * qc, hpt)
    b = torch.zeros((k8, 2 * dp), dtype=torch.int8, device=wq.device)
    b[:hpt, :dp] = cols_hi.permute(1, 0, 2, 3).reshape(hpt, dp)
    b[:hpt, dp:] = cols_lo.permute(1, 0, 2, 3).reshape(hpt, dp)
    ms = cuda_ms(lambda: torch._int_mm(a, b), 3)
    del a, b
    torch.cuda.empty_cache()
    return ms


@contextlib.contextmanager
def record_k3_groups(turbo):
    """Yields a list that collects every batched K3 launch of the engine
    while the block runs: its packed inputs (TurboBM25._sparse_group_args),
    its per-query chunk counts and a copy of the slice pool as the launch
    read it (later batches may evict and overwrite slices). Wraps
    _sparse_launch on this instance only; the copies launch no kernel."""
    groups = []
    launch = turbo._sparse_launch

    def spy(preps):
        meta, n_rc = turbo._sparse_group_args(preps)
        groups.append({"meta": meta, "n_rc": n_rc, "n_q": len(preps),
                       "chunks": [len(p[0][0]) for p in preps],
                       "pool": turbo._sp_pool.clone()})
        return launch(preps)

    turbo._sparse_launch = spy
    try:
        yield groups
    finally:
        del turbo._sparse_launch


def k3_device_ms(fn, reps: int = 5, launches: int = 1):
    """fn's K3 kernels alone per call (this tree's and the parent's are
    both named sparse_gather_kernel), `launches` a call: kernel_alone's
    (ms, info), without the host's time to enqueue them, which CUDA events
    around a small launch also count."""
    return kernel_alone(fn, ("sparse_gather_kernel",), reps,
                        {"sparse_gather_kernel": launches})


def host_enqueue_ms(fn, reps: int = 200) -> float:
    """Host wall time per call of fn without synchronising: what the
    wrapper costs the host to check its inputs and enqueue the launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    return dt


def k3_tensors(g, dev):
    """(coff, cw, ct0, ct1, qoff) of a recorded group, on the card."""
    import torch

    from elasticsearch_tpu_torch.parallel.turbo import _group_views

    return _group_views(torch.from_numpy(g["meta"]).to(dev), g["n_rc"],
                        g["n_q"])


def k3_parent(path):
    """The parent commit's K3 (one query per launch, a block per 16384-doc
    tile; its C entry has no qoff), built with nvcc from `path`. Returns
    run(coff, cw, ct0, ct1, pool, n_tiles) -> out, or None when `path` is
    not a file."""
    import ctypes

    import torch

    from elasticsearch_tpu_torch.tools.k9_ab import parent_entry

    p, i = ctypes.c_void_p, ctypes.c_int
    fn = parent_entry(path, "k3_parent", "es_sparse_gather",
                      [p, p, p, p, i, p, i, p, i, p])
    if fn is None:
        return None

    def run(coff, cw, ct0, ct1, pool, n_tiles):
        n = int(coff.shape[0])
        out = torch.zeros((n, 8, 128), dtype=torch.float32,
                          device=pool.device)
        rc = fn(coff.data_ptr(), cw.data_ptr(), ct0.data_ptr(),
                ct1.data_ptr(), n, pool.data_ptr(), int(pool.shape[0]),
                out.data_ptr(), n_tiles,
                torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"parent K3 launch failed: cudaError {rc}")
        return out

    return run


def k3_bound(coff, pool, n_q: int):
    """The K3 bound of one launch: each chunk's granule read once and its
    output written once, the metadata read once; one multiply and one add
    per live lane (a posting's addend). Returns (ms, by, live lanes)."""
    from elasticsearch_tpu_torch.parallel import kernels as k

    n_rc = int(coff.shape[0])
    lanes = int(((pool[coff.long()] & 255) > 0).sum()) if n_rc else 0
    nbytes = n_rc * (k.SPARSE_GRAN * 4 * 2 + 16) + (n_q + 1) * 4
    return bound(nbytes, lanes * 2, PEAK_F32) + (lanes,)


def k3_index_add_ms(coff, cw, pool, qoff, n_tiles):
    """Yardstick: the scatter half of K3 as one index_add_ over every query
    of a launch, each query's docs in its own n_tiles * 16384 range (the
    port never calls it). None when the accumulator would pass 12 GB."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    n_rc = int(coff.shape[0])
    span = n_tiles * k.TILE
    n_q = int(qoff.shape[0]) - 1
    if n_q * span * 4 > 12e9:
        return None
    q_of = torch.repeat_interleave(
        torch.arange(n_q, device=coff.device),
        (qoff[1:] - qoff[:-1]).long(), output_size=n_rc)
    v = pool[coff.long()].reshape(n_rc, -1)
    imp = v & 255
    ok = imp > 0
    keys = (((v >> 8) & 0xFFFFFF).long() + (q_of * span)[:, None])[ok]
    vals = (imp.float() * cw[:, None])[ok]
    acc = torch.zeros(n_q * span, dtype=torch.float32, device=coff.device)
    ms = cuda_ms(lambda: acc.index_add_(0, keys, vals), 10)
    del acc
    torch.cuda.empty_cache()
    return ms


def k3_hold_group(g, n_tiles, dev, reps=10):
    """One recorded group on the card: the batched launch timed (the
    serving call, host_checked), held bitwise against the plain version,
    also once more on outputs filled with NaN first (kernels.poisoned).
    Returns (row of numbers, launch args)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    coff, cw, ct0, ct1, qoff = a = k3_tensors(g, dev)
    pool = g["pool"]
    out = {}

    def kern():
        out["k"] = k.sparse_gather(coff, cw, ct0, ct1, pool, n_tiles=n_tiles,
                                   qoff=qoff, host_checked=True)

    ms = cuda_ms(kern, reps)
    kernel_ms, events = kernel_alone(kern, ("sparse_gather_kernel",), 5)
    plain_ms = cuda_ms(lambda: out.__setitem__("p", k.sparse_gather_plain(
        coff, cw, ct0, ct1, pool, n_tiles=n_tiles, qoff=qoff)), 1)
    err = max_abs_err(out["k"], out["p"])
    require(err == 0.0 and torch.equal(out["k"], out["p"]),
            f"K3 batched kernel vs plain: max_abs_err {err}")
    with k.poisoned():
        kern()
    require(torch.equal(out["k"], out["p"]),
            "K3 on poisoned outputs differs from the plain version")
    b_ms, b_by, lanes = k3_bound(coff, pool, g["n_q"])
    return {"queries": g["n_q"], "chunks": g["n_rc"], "lanes": lanes,
            "ms": ms, "kernel_ms": kernel_ms, "kernel_events": events,
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
            "kernel_bound_share": b_ms / kernel_ms if kernel_ms else None,
            "max_abs_err": err}, a


def k3_per_dispatch(groups, n_tiles, dev, parent):
    """The old call pattern on the same queries: each query's dispatch
    launched on its own (qoff None), this tree's kernel and the parent's,
    each timed alone with CUDA events (the glue and read-backs of each old
    dispatch not included), and the device time of all of them launched
    back to back (torch.profiler). Also the query with the most chunks.
    Returns sums and that largest dispatch's args."""
    from elasticsearch_tpu_torch.parallel import kernels as k

    cur, old, big, dispatches = [], [], None, []
    for g in groups:
        coff, cw, ct0, ct1, qoff = k3_tensors(g, dev)
        qo = [int(x) for x in qoff.cpu()]
        for a, b in zip(qo[:-1], qo[1:]):
            args = (coff[a:b].clone(), cw[a:b].clone(), ct0[a:b].clone(),
                    ct1[a:b].clone(), g["pool"])
            dispatches.append(args)
            cur.append(cuda_ms(lambda: k.sparse_gather(
                *args, n_tiles=n_tiles, host_checked=True), 3))
            if parent is not None:
                old.append(cuda_ms(lambda: parent(*args, n_tiles), 3))
            if big is None or b - a > int(big[0].shape[0]):
                big = args

    def each_new():
        for args in dispatches:
            k.sparse_gather(*args, n_tiles=n_tiles, host_checked=True)

    def each_parent():
        for args in dispatches:
            parent(*args, n_tiles)

    return {"dispatches": len(cur), "sum_ms": float(np.sum(cur)),
            "p50_ms": float(np.median(cur)) if cur else None,
            "kernel_sum_ms": k3_device_ms(each_new, 2, len(dispatches))[0],
            "parent_sum_ms": float(np.sum(old)) if old else None,
            "parent_p50_ms": float(np.median(old)) if old else None,
            "parent_kernel_sum_ms": (
                k3_device_ms(each_parent, 2, len(dispatches))[0]
                if parent is not None else None)}, big


def check_k3(groups, batch_groups, n_tiles, launches, parent):
    """K3 on the main path's own launches: every recorded group held
    bitwise against the plain version and timed; per batch its groups,
    chunks, time, bound and share, and the sum the old per-query pattern
    makes on the same queries (this kernel and the parent's). The row's
    numbers are the first batch's cold side (its groups summed); `q1` is
    its largest single dispatch, beside index_add_ and the parent."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    require(groups, "K3: the main path launched no group")
    dev = groups[0]["pool"].device
    held = [k3_hold_group(g, n_tiles, dev) for g in groups]
    batches = []
    for b, idx in enumerate(batch_groups):
        rows = [held[i][0] for i in idx]
        ms = float(sum(r["ms"] for r in rows))
        bms = float(sum(r["bound_ms"] for r in rows))
        batches.append({"groups": len(rows),
                        "queries_per_group": [r["queries"] for r in rows],
                        "chunks": [r["chunks"] for r in rows],
                        "ms": ms, "bound_ms": bms,
                        "bound_share": bms / ms if ms else None})
    first = [held[i] for i in batch_groups[0]]
    require(first, "K3: the first batch launched no group")
    lib = [k3_index_add_ms(a[0], a[1], groups[i]["pool"], a[4], n_tiles)
           for i, (_, a) in zip(batch_groups[0], first)]
    old, big = k3_per_dispatch([groups[i] for i in batch_groups[0]],
                               n_tiles, dev, parent)
    batches[0]["old_pattern"] = old
    # the largest single dispatch, Q = 1
    coff, cw, ct0, ct1, pool = big
    out = {}

    def q1_kern():
        out["k"] = k.sparse_gather(coff, cw, ct0, ct1, pool, n_tiles=n_tiles,
                                   host_checked=True)

    def q1_old():
        out["o"] = parent(coff, cw, ct0, ct1, pool, n_tiles)

    q1_ms = cuda_ms(q1_kern, 20)
    q1_dev, q1_events = k3_device_ms(q1_kern, 10)
    q1_host = host_enqueue_ms(q1_kern)
    q1_plain = cuda_ms(lambda: out.__setitem__("p", k.sparse_gather_plain(
        coff, cw, ct0, ct1, pool, n_tiles=n_tiles)), 3)
    err = max_abs_err(out["k"], out["p"])
    require(err == 0.0, f"K3 kernel vs plain at Q = 1: max_abs_err {err}")
    q1_parent = q1_parent_dev = None
    if parent is not None:
        q1_parent = cuda_ms(q1_old, 20)
        q1_parent_dev = k3_device_ms(q1_old, 10)[0]
        require(torch.equal(out["o"], out["p"]),
                "the parent K3 differs from the plain version")
    q1_lib = k3_index_add_ms(coff, cw, pool,
                             torch.tensor([0, int(coff.shape[0])],
                                          dtype=torch.int32, device=dev),
                             n_tiles)
    q1_b, q1_by, q1_lanes = k3_bound(coff, pool, 1)
    rows = [r for r, _ in first]
    ms = float(sum(r["ms"] for r in rows))
    b_ms = float(sum(r["bound_ms"] for r in rows))
    return {"name": "sparse_gather", "route": "cuda",
            "source": "elasticsearch_tpu_torch/parallel/csrc/sparse_gather.cu",
            "replaces": "elasticsearch_tpu/parallel/kernels.py:901",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r, _ in held),
            "ms": ms, "plain_ms": float(sum(r["plain_ms"] for r in rows)),
            "bound_ms": b_ms,
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": (float(sum(lib)) if all(x is not None for x in lib)
                           else None),
            "library_note": "index_add_ of the scatter half, every query's "
                            "docs in its own range",
            "shape": {"what": "the first config-1 batch's cold side",
                      "groups": len(rows),
                      "queries": sum(r["queries"] for r in rows),
                      "chunks": sum(r["chunks"] for r in rows),
                      "lanes": sum(r["lanes"] for r in rows),
                      "n_tiles": n_tiles},
            "batches": batches,
            "groups_held": len(held),
            "kernel_ms": (float(sum(r["kernel_ms"] for r in rows))
                          if all(r["kernel_ms"] for r in rows) else None),
            "q1": {"chunks": int(coff.shape[0]), "lanes": q1_lanes,
                   "ms": q1_ms, "kernel_ms": q1_dev,
                   "kernel_events": q1_events, "host_enqueue_ms": q1_host,
                   "plain_ms": q1_plain,
                   "bound_ms": q1_b, "bound_by": q1_by,
                   "library_ms": q1_lib, "parent_ms": q1_parent,
                   "parent_kernel_ms": q1_parent_dev}}


def check_k3_bool(route_groups, n_tiles, launches, parent):
    """K3 on the bool path's own launches (the cold SHOULD sides), per
    route: every group held bitwise against the plain version and timed,
    beside the old per-query pattern on the same queries."""
    out = {}
    for route, groups in route_groups.items():
        require(groups, f"K3: the bool {route} route launched no group")
        dev = groups[0]["pool"].device
        held = [k3_hold_group(g, n_tiles, dev)[0] for g in groups]
        old, _ = k3_per_dispatch(groups, n_tiles, dev, parent)
        ms = float(sum(r["ms"] for r in held))
        bms = float(sum(r["bound_ms"] for r in held))
        kms = [r["kernel_ms"] for r in held]
        out[route] = {"launches": launches[route], "groups": held,
                      "ms": ms, "bound_ms": bms,
                      "kernel_ms": float(sum(kms)) if all(kms) else None,
                      "bound_share": bms / ms if ms else None,
                      "max_abs_err": max((r["max_abs_err"] for r in held),
                                         default=0.0),
                      "old_pattern": old}
    return out


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
    m = len(held[0])
    require(np.array_equal(s[:m], held[0]) and np.array_equal(o[:m], held[1]),
            "default ladder: answers differ from the host-exact tier")
    out = {"widths": "1024,4096,16384", "queries": len(batch),
           "batch_latency_s": lat, "sparse_queries": st["sparse_queries"],
           "sparse_fallbacks": st["sparse_fallbacks"],
           "certificate_fallbacks": st["fallbacks"]}
    log(f"default ladder: {out}")
    return out


# ---------------------------------------------------------------------------
# bool and slop-0 phrase serving (BASELINE configs 2 and 3)
# ---------------------------------------------------------------------------

BOOL_BATCH = 256
PHRASES = 256
PHRASE_BATCH = 64      # distinct phrases per call: well under the 224 slots
#                        of the full-size shard, so none degrades to the host
#                        (a cut index has fewer slots: at most Hp / 2 then)
# head-term phrases: they match more docs than ES_TPU_BITSET_HOST_DF, so
# they take the device sweep (K5 + K6) where the drawn phrases gallop
HEAD_PHRASES = [["t0", "t1"], ["t2", "t0"]]

BOOL_DSL = [
    # must_not on a head term: its column is resident, K5's AND-NOT runs
    {"query": {"bool": {
        "must": [{"term": {"body": "t3"}}, {"term": {"body": "t10"}}],
        "must_not": [{"term": {"body": "t7"}}],
        "should": [{"match": {"body": "t500"}}]}}},
    # filter on a head term
    {"query": {"bool": {
        "must": [{"match": {"body": "t5"}}],
        "filter": [{"term": {"body": "t1"}}],
        "should": [{"term": {"body": "t2000"}}]}}},
    # more than 8 musts and more than 4 must_nots: the device mask is a
    # superset there, the exact rescore drops the spurious survivors
    {"query": {"bool": {
        "must": [{"match": {"body": {"query": "t0 t1 t2 t3 t4 t5 t6 t7 t8",
                                     "operator": "and"}}}],
        "must_not": [{"terms": {"body": ["t20", "t21", "t22", "t23", "t24",
                                         "t25"]}}]}}},
    {"query": {"match": {"body": {"query": "t2 t40", "operator": "and"}}}},
    {"query": {"bool": {
        "must": [{"term": {"body": {"value": "t12", "boost": 2.0}}},
                 {"term": {"body": "t60"}}],
        "must_not": [{"term": {"body": "t0"}}]}}},
    {"query": {"bool": {
        "must": [{"match_phrase": {"body": "t4 t9"}}],
        "should": [{"term": {"body": "t30"}}]}}},
]


def draw_bool(n: int, vocab: int):
    """bench.py's draw_bool (config 2): half selective conjunctions (a
    mid-rank must, which the host serves at cold_df 65536), half heavy ones
    (two head-term musts and a mid-rank should, served on the device with
    the should through the cold tier)."""
    rng = np.random.default_rng(44)
    h_hi = max(2, min(100, vocab // 100))
    m_hi = max(2 * h_hi + 2, min(20_000, vocab // 2))
    head = rng.integers(0, h_hi, size=(n, 2))
    mid = rng.integers(2 * h_hi, m_hi, size=(n, 2))
    tail = rng.integers(m_hi, vocab, size=(n, 1))
    out = []
    for i in range(n):
        if i % 2 == 0:
            out.append({
                "must": [(f"t{mid[i, 0]}", 1.0)],
                "should": [(f"t{head[i, 0]}", 1.0), (f"t{tail[i, 0]}", 1.0)],
                "filter": [f"t{mid[i, 1]}"] if i % 4 == 0 else [],
            })
        else:
            out.append({
                "must": [(f"t{head[i, 0]}", 1.0), (f"t{head[i, 1]}", 1.0)],
                "should": [(f"t{mid[i, 0]}", 1.0)],
            })
    return out


def draw_phrases(n: int, fp, tokens, bounds, max_df: int = 200_000):
    """bench.py's draw_phrases (config 3): two adjacent tokens of a random
    doc, both of df <= max_df."""
    rng = np.random.default_rng(45)
    n_docs = len(bounds) - 1
    out = []
    while len(out) < n:
        d = int(rng.integers(0, n_docs))
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        if hi - lo < 2:
            continue
        j = int(rng.integers(lo, hi - 1))
        a, b = int(tokens[j]), int(tokens[j + 1])
        if a == b:
            continue
        oa, ob = fp.term_to_ord[f"t{a}"], fp.term_to_ord[f"t{b}"]
        if max(fp.doc_freq[oa], fp.doc_freq[ob]) > max_df:
            continue
        out.append([f"t{a}", f"t{b}"])
    return out


def _dense_tf(fp, term):
    """(tf f32[n_docs], present bool[n_docs]) read straight off the
    postings."""
    n = len(fp.doc_len)
    tf = np.zeros(n, np.float32)
    present = np.zeros(n, bool)
    o = fp.term_to_ord.get(term, -1)
    if o >= 0:
        lo, hi = int(fp.post_start[o]), int(fp.post_start[o + 1])
        rows = slice(int(fp.block_start[o]),
                     int(fp.block_start[o]) + int(fp.block_count[o]))
        docs = fp.post_doc[lo:hi]
        tf[docs] = fp.block_tfs[rows].ravel()[: hi - lo]
        present[docs] = True
    return tf, present


def _dense_pf(fp, a: str, b: str):
    """Slop-0 frequency of the two-term phrase "a b" per doc: occurrences
    of a whose next position holds b, by set membership of (doc, position)
    keys (not the engine's searchsorted probe)."""
    def keys(t):
        o = fp.term_to_ord[t]
        lo, hi = int(fp.post_start[o]), int(fp.post_start[o + 1])
        cnt = fp.pos_start[lo + 1: hi + 1] - fp.pos_start[lo:hi]
        docs = np.repeat(fp.post_doc[lo:hi].astype(np.int64), cnt)
        pos = fp.pos_data[int(fp.pos_start[lo]): int(fp.pos_start[hi])]
        return docs, docs * 1024 + pos

    da, ka = keys(a)
    _, kb = keys(b)
    hit = np.isin(ka + 1, kb)
    return np.bincount(da[hit], minlength=len(fp.doc_len)).astype(np.float32)


def _bool_dense(fp, total_docs, spec):
    """(f32 score, match) of every doc for a bool spec: the reference's
    formula and f64 accumulation order (must, should, then phrases; one
    f32 rounding), tf and phrase freqs read off the postings by other
    means than the engine's."""
    import math

    def idf(t):
        df = int(fp.doc_freq[fp.term_to_ord[t]])
        return math.log(1.0 + (total_docs - df + 0.5) / (df + 0.5))

    n = len(fp.doc_len)
    avgdl = fp.sum_doc_len / int(np.count_nonzero(fp.doc_len))
    norm = 1.2 * (1.0 - 0.75 + 0.75 * fp.doc_len / max(avgdl, 1e-9))
    scores = np.zeros(n, np.float64)
    match = np.ones(n, bool)
    for t, w in spec.get("must", ()):
        tf, present = _dense_tf(fp, t)
        match &= present
        scores += w * idf(t) * tf * (1.2 + 1.0) / (tf + norm)
    for t in spec.get("filter", ()):
        match &= _dense_tf(fp, t)[1]
    for t, w in spec.get("should", ()):
        tf, present = _dense_tf(fp, t)
        contrib = w * idf(t) * tf * (1.2 + 1.0) / np.maximum(tf + norm, 1e-9)
        scores += np.where(present, contrib, 0.0)
    for terms, slop, boost in spec.get("phrases", ()):
        require(slop == 0 and len(terms) == 2, "numpy scorer: 2-term slop 0")
        pf = _dense_pf(fp, *terms)
        match &= pf > 0
        idf_sum = float(sum(idf(t) for t in terms))
        scores += boost * idf_sum * pf * (1.2 + 1.0) / (pf + norm)
    for t in spec.get("must_not", ()):
        match &= ~_dense_tf(fp, t)[1]
    return scores.astype(np.float32), match


def brute_bool(fp, total_docs, spec, k=K):
    """Independent numpy scorer for a bool spec over every doc."""
    s32, match = _bool_dense(fp, total_docs, spec)
    docs = np.nonzero(match & (s32 > 0))[0]
    sel = np.lexsort((docs, -s32[docs]))[:k]
    return s32[docs[sel]], docs[sel].astype(np.int32)


def exact_bound(s32, gate, nsw: int) -> float:
    """The certificate's bound on an uncollected row, computed as the sweep
    and the row pick compute it, but from exact scores: each 128-doc row's
    best gated score, each superwindow's top NCAND rows, and the larger of
    the first row past the collected ones and every superwindow's last
    listed row (-inf counting as 0)."""
    from elasticsearch_tpu_torch.parallel.kernels import NCAND, SW
    from elasticsearch_tpu_torch.parallel.turbo import _GLOBAL_ROWS

    score = np.full(nsw * SW, -np.inf)
    score[:len(s32)] = np.where(gate, s32, -np.inf)
    rowmax = score.reshape(nsw, SW // 128, 128).max(axis=2)
    top = -np.sort(-rowmax, axis=1)[:, :NCAND]
    listed = -np.sort(-top.ravel())
    n_rows = max(_GLOBAL_ROWS, K + 5)
    cands = list(top[:, NCAND - 1])
    if len(listed) > n_rows:
        cands.append(listed[n_rows])
    return float(max(x if np.isfinite(x) else 0.0 for x in cands))


def fallback_explained(fp, total_docs, rec, nsw: int, k=K) -> bool:
    """Whether exact scores alone explain one certificate fallback: the
    device's bound lies within the margin e_q of exact_bound() (the most the
    quantized sweep can misstate a score, so a bound off by more would be a
    fault), and the k-th exact score lies below bound + e_q, where the
    certificate must fail (a near-tie inside its margin). Only a query
    whose device gate is exact is explained: every required clause and
    must_not inside the bitset fan-in, or the coverage sweep."""
    if not rec["exact_gate"]:
        return False
    spec, res = rec["spec"], rec["resident"]
    # what the sweep scores and gates: resident SHOULD terms and must_nots
    dev = dict(spec, should=[(t, b) for t, b in spec["should"] if t in res],
               must_not=[t for t in spec["must_not"] if t in res])
    s_dev, gate = _bool_dense(fp, total_docs, dev)
    b, e_q = rec["bound"], rec["e_q"]
    if abs(b - exact_bound(s_dev, gate, nsw)) > e_q:
        return False
    s_all, match = ((s_dev, gate) if dev == spec
                    else _bool_dense(fp, total_docs, spec))
    hit = match & (s_all > 0)
    if int(hit.sum()) < k:
        return b > 0
    return float(np.partition(s_all[hit], -k)[-k]) < b + e_q


def _spec_of(r) -> dict:
    """A resolved bool query back as a spec (_resolve_bool's input)."""
    return {"must": [(t, b) for t, b, _ in r.conj],
            "filter": [t for t, _ in r.filters],
            "should": [(t, b) for t, b, _ in r.should],
            "must_not": [t for t, _ in r.must_not],
            "phrases": [(tuple(p[0]), p[1], p[2]) for p in r.phrases]}


@contextlib.contextmanager
def record_fallbacks(turbo, bits: bool):
    """Yields a list that collects, for every query whose device
    certificate fails while the block runs, its spec, the device's bound,
    e_q, its resident terms and whether the sweep's gate is exact (wraps
    the engine's _finish_bool on this instance only)."""
    from elasticsearch_tpu_torch.parallel.kernels import (
        BITSET_CLAUSES, BITSET_NEGS,
    )
    from elasticsearch_tpu_torch.parallel.turbo import _quant_error

    fell = []
    finish = turbo._finish_bool

    def spy(r, cand_docs, bound, k, cold, slots):
        n = turbo.stats["fallbacks"]
        scoring, req, neg = slots
        out = finish(r, cand_docs, bound, k, cold, slots)
        if turbo.stats["fallbacks"] > n:
            spec = _spec_of(r)
            terms = ([t for t, _ in spec["must"] + spec["should"]]
                     + spec["filter"] + spec["must_not"])
            fell.append({
                "spec": spec, "bound": float(bound),
                "e_q": _quant_error([w for _, w, _ in scoring]),
                "resident": {t for t in terms if t in turbo._slot_of},
                "exact_gate": not bits or (len(req) <= BITSET_CLAUSES
                                           and len(neg) <= BITSET_NEGS)})
        return out

    turbo._finish_bool = spy
    try:
        yield fell
    finally:
        del turbo._finish_bool


def hold_fallbacks(fp, total_docs, nsw, fell, n_fallbacks, n_q, label):
    """The path's certificate fallbacks: each one recorded, and those that
    fallback_explained() does not explain at most MAX_CERT_FALLBACK_SHARE
    of the path's queries. Returns the explained count."""
    require(len(fell) == n_fallbacks,
            f"{label}: {len(fell)} fallbacks recorded, {n_fallbacks} counted")
    explained = sum(fallback_explained(fp, total_docs, rec, nsw)
                    for rec in fell)
    require(n_fallbacks - explained <= MAX_CERT_FALLBACK_SHARE * n_q,
            f"{label}: {n_fallbacks - explained} certificate fallbacks not "
            f"explained by exact scores exceed {MAX_CERT_FALLBACK_SHARE} "
            f"of {n_q} queries")
    return explained


def hold_bool(turbo, specs, answers, label):
    """Every answer bitwise against the host-exact tier (computed once,
    in parallel) and each route's answers against it."""
    t = time.time()
    parts = [specs[i:i + 8] for i in range(0, len(specs), 8)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        host = list(ex.map(lambda q: turbo.search_bool_host(q, k=K), parts))
    hs = np.concatenate([h[0] for h in host])
    ho = np.concatenate([h[1] for h in host])
    ho[hs <= 0] = 0
    for route, (s, p, o) in answers.items():
        require(s.shape == (len(specs), K) and np.isfinite(s).all(),
                f"{label}/{route}: result shape or finiteness")
        require(not p.any(), "partition ids on a one-partition engine")
        require(np.array_equal(s, hs) and np.array_equal(o, ho),
                f"{label}/{route}: device route differs from the host tier")
    log(f"{label}: {len(specs)} answers x {len(answers)} routes bitwise "
        f"equal to the host-exact tier ({time.time() - t:.1f}s)")
    return hs, ho


def k5_parent(path):
    """The parent commit's K5 C entry (a block per (query, superwindow),
    the mask alone: es_intersect_bitset(q_slots, q_neg, bits, out, qc, nsw,
    rows, n_slots, stream)), built with nvcc from `path`, or None when
    `path` is not a file."""
    import ctypes

    from elasticsearch_tpu_torch.tools.k9_ab import parent_entry

    p, i = ctypes.c_void_p, ctypes.c_int
    return parent_entry(path, "k5_parent", "es_intersect_bitset",
                        [p, p, p, p, i, i, i, i, p])


def k5_stage(host, card, bits, nsw, parent=None):
    """K5's stage, mask and chunk counts, with the wrapper's allocations
    (kernels._out, so filled inside kernels.poisoned) and none of its
    checks: this tree's C entry on the slots on the host (`host`, CPU
    (q_slots, q_neg); one launch for both, QC <= 256), or given `parent`
    (from k5_parent) the parent's C entry on the slots on the card
    (`card`) and the torch mask_chunk_counts after it. Returns (mask,
    counts)."""
    import torch

    from elasticsearch_tpu_torch.parallel import cuda_build
    from elasticsearch_tpu_torch.parallel import kernels as k

    qc, dev = int(host[0].shape[0]), bits.device
    mask = k._out((qc, nsw * k.SW_WORD_ROWS, 128), torch.int32, dev)
    dims = (qc, nsw, int(bits.shape[1]), int(bits.shape[0]),
            torch.cuda.current_stream().cuda_stream)
    if parent is None:
        counts = k._out((qc,), torch.int32, dev)
        rc = cuda_build.kernel("intersect_bitset")(
            host[0].data_ptr(), host[1].data_ptr(), bits.data_ptr(),
            mask.data_ptr(), counts.data_ptr(), *dims)
    else:
        rc = parent(card[0].data_ptr(), card[1].data_ptr(), bits.data_ptr(),
                    mask.data_ptr(), *dims)
    require(rc == 0, f"K5 launch failed: cudaError {rc}")
    if parent is not None:
        counts = k.mask_chunk_counts(mask)
    return mask, counts


def check_k5(turbo, chunk, launches, parent=None):
    """K5 at QC 256 on the bitset route's device chunk: mask and chunk
    counts held bitwise against the plain version (intersect_bitset_plain,
    then mask_chunk_counts), the counts also against mask_chunk_counts of
    the kernel's own mask, once more on outputs filled with -1 first
    (kernels.poisoned: the counts too, which the C entry zeroes), with the
    slots from the host and from the card. Timed through the wrapper as
    the engine calls it (the slots from the host, in the launch's
    parameters) by CUDA events, alone (torch.profiler's kernel events),
    from a CUDA graph (graph_ms) and for the host's enqueue. Given the
    parent commit's C entry (`parent`, k5_parent), the parent's stage
    (its K5, then the torch mask_chunk_counts) and this tree's (one
    launch; the slots from the host, the parent's from the card) are
    called alike (k5_stage: no checks) in turns (parent, kernel, kernel,
    parent) and from a graph, the parent also alone, and the parent held
    the same way."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    dev, qc, nsw, bits = turbo.device, 256, turbo.nsw, turbo.bits
    qs_np, qn_np = turbo._bitset_prefetch(chunk, qc)
    qs_h, qn_h = torch.from_numpy(qs_np), torch.from_numpy(qn_np)
    q_slots, q_neg = qs_h.to(dev), qn_h.to(dev)
    out = {}

    def kern():
        out["k"] = k.intersect_bitset_counts(qs_h, qn_h, bits, nsw=nsw)

    host, card = (qs_h, qn_h), (q_slots, q_neg)
    runs = {"kernel": lambda: k5_stage(host, card, bits, nsw),
            "parent": lambda: k5_stage(host, card, bits, nsw, parent)}
    events = [cuda_ms(kern, 20), cuda_ms(kern, 20)]
    ms = float(np.median(events))
    turns = {"parent": [], "kernel": []}
    for name in (["parent"] if parent else []) + ["kernel", "kernel"] + (
            ["parent"] if parent else []):
        turns[name].append(cuda_ms(runs[name], 20))
    kernel_ms, kernel_events = kernel_alone(kern, ("intersect",), 20)
    device_ms = graph_ms(kern, 50)
    host_ms = host_enqueue_ms(kern)
    plain_ms = cuda_ms(lambda: out.__setitem__(
        "p", k.intersect_bitset_counts_plain(q_slots, q_neg, bits,
                                             nsw=nsw)), 3)
    (km, kc), (pm, pc) = out["k"], out["p"]
    err = max(max_abs_err(km, pm), max_abs_err(kc, pc))
    require(err == 0.0 and torch.equal(km, pm) and torch.equal(kc, pc),
            f"K5 kernel vs plain: max_abs_err {err}")
    require(torch.equal(kc, k.mask_chunk_counts(km)),
            "K5 counts differ from mask_chunk_counts of its own mask")
    with k.poisoned():
        again = [*k.intersect_bitset_counts(qs_h, qn_h, bits, nsw=nsw),
                 *k.intersect_bitset_counts(q_slots, q_neg, bits, nsw=nsw),
                 k.intersect_bitset(q_slots, q_neg, bits, nsw=nsw),
                 *runs["kernel"]()]
    require(all(torch.equal(a, b) for a, b in
                zip(again, (pm, pc, pm, pc, pm, pm, pc))),
            "K5 on outputs filled with -1 differs from the plain version")
    del again
    ab = None
    if parent:
        par_kernel_ms, par_events = kernel_alone(runs["parent"],
                                                 ("intersect",), 20)
        ab = {"stage_ms": turns["kernel"],
              "stage_device_ms": graph_ms(runs["kernel"], 50),
              "parent_stage_ms": turns["parent"],
              "parent_kernel_ms": par_kernel_ms,
              "parent_kernel_events": par_events,
              "parent_device_ms": graph_ms(runs["parent"], 50),
              "parent_counts_device_ms": graph_ms(
                  lambda: k.mask_chunk_counts(pm), 50)}
        with k.poisoned():
            again = runs["parent"]()
        require(torch.equal(again[0], pm) and torch.equal(again[1], pc),
                "the parent K5 differs from the plain version")
        del again
    # each distinct clause block read once (sentinels need no read), the
    # mask and the counts written once
    distinct = set(qs_np.ravel().tolist()) | set(qn_np.ravel().tolist())
    distinct -= {turbo.Hp, turbo.Hp + 1}
    block = k.SW_WORD_ROWS * 128 * 4
    nbytes = (len(distinct) * nsw * block + qc * nsw * block
              + qs_np.nbytes + qn_np.nbytes + qc * 4)
    b_ms, b_by = bound(nbytes, qc * nsw * block // 4 * 12, PEAK_F32)
    log(f"K5: events {events} ms, alone {kernel_ms} ms, graph "
        f"{device_ms:.4f} ms, host enqueue {host_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms; stage against the parent's in turns {ab}")
    return {"name": "intersect_bitset", "route": "cuda",
            "source": "elasticsearch_tpu_torch/parallel/csrc/intersect_bitset.cu",
            "replaces": "elasticsearch_tpu/parallel/kernels.py:432",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "library_note": "no single PyTorch call gathers and ANDs the "
                            "clause blocks", "poisoned_run": "bitwise",
            "counts": "bitwise (plain and mask_chunk_counts of its mask)",
            "events_ms": events, "kernel_ms": kernel_ms,
            "kernel_events": kernel_events, "device_ms": device_ms,
            "host_enqueue_ms": host_ms, "stage_ab": ab,
            "shape": {"QC": qc, "nsw": nsw, "active": len(chunk),
                      "distinct_slots": len(distinct)}}, km


def check_pack(turbo, launches):
    """The bitset pack on the shard's whole column cache: the engine's
    repack timed on the host clock with its peak device memory over what
    was allocated before it (the old bits are freed first), then the
    kernel timed by CUDA events, alone, from a CUDA graph and for the
    host's enqueue, held bitwise against pack_presence_bits_plain (whose
    own peak over its output is measured too) and against the engine's
    bits, once more on output filled with -1 first. Returns (row, the
    device's peak allocation before this check reset it)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    hi, lo = turbo.cols_hi, turbo.cols_lo
    dpc, hp1 = int(hi.shape[0]), int(hi.shape[1])
    read = 2 * dpc * hp1 * k.CHUNK
    bits_bytes = (hp1 + 1) * (dpc // 2) * 128 * 4
    prior_peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    turbo._repack_bits()
    torch.cuda.synchronize()
    repack_ms = (time.perf_counter() - t) * 1e3
    repack_extra = torch.cuda.max_memory_allocated() - base
    out = {}

    def kern():
        out["k"] = k.pack_presence_bits(hi, lo)

    events = [cuda_ms(kern, 5), cuda_ms(kern, 5)]
    ms = float(np.median(events))
    kernel_ms, kernel_events = kernel_alone(kern, ("pack_bits",), 5)
    device_ms = graph_ms(kern, 10)
    host_ms = host_enqueue_ms(kern, 20)
    out.pop("k")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plain_ms = cuda_ms(lambda: out.__setitem__(
        "p", k.pack_presence_bits_plain(hi, lo)), 1)
    plain_extra = torch.cuda.max_memory_allocated() - base - bits_bytes
    kern()
    err = max_abs_err(out["k"], out["p"])
    require(err == 0.0 and torch.equal(out["k"], out["p"]),
            f"bitset pack kernel vs plain: max_abs_err {err}")
    require(torch.equal(turbo.bits, out["p"]),
            "the engine's repacked bits differ from the plain pack")
    del out["k"]
    with k.poisoned():
        again = k.pack_presence_bits(hi, lo)
    require(torch.equal(again, out["p"]),
            "bitset pack on output filled with -1 differs from the plain "
            "version")
    del again, out["p"]
    b_ms, b_by = bound(read + bits_bytes, read, PEAK_F32)
    log(f"bitset pack: events {events} ms, alone {kernel_ms} ms, graph "
        f"{device_ms:.4f} ms, host enqueue {host_ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms; repack {repack_ms:.3f} ms "
        f"wall, its peak over the allocated before it {repack_extra} "
        f"bytes (the plain pack's over its output {plain_extra})")
    return {"name": "pack_presence_bits", "route": "cuda",
            "source": "elasticsearch_tpu_torch/parallel/csrc/pack_bits.cu",
            "replaces": "elasticsearch_tpu/parallel/kernels.py:358 "
                        "(XLA program)",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "library_note": "no single PyTorch call packs 32 presence rows "
                            "into a word", "poisoned_run": "bitwise",
            "events_ms": events, "kernel_ms": kernel_ms,
            "kernel_events": kernel_events, "device_ms": device_ms,
            "host_enqueue_ms": host_ms, "repack_wall_ms": repack_ms,
            "repack_peak_extra_bytes": int(repack_extra),
            "plain_peak_extra_bytes": int(plain_extra),
            "shape": {"dp_chunks": dpc, "slots": hp1 + 1,
                      "bits_bytes": bits_bytes}}, prior_peak


def check_k6(turbo, chunk, mask, launches, parent=None):
    """K6 at QC 256 on the bitset route's device chunk and K5's mask of it,
    held and timed by sweep_ab (the parent's K6 beside it when given)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k
    from elasticsearch_tpu_torch.tools.k2_ab import bitset_work

    dev, qc, nsw = turbo.device, 256, turbo.nsw
    wq_np, _, _, qs_np = turbo._bool_weights(chunk, qc)
    wq = torch.from_numpy(wq_np).to(dev)
    qs = torch.from_numpy(qs_np).to(dev)
    args = (qs, turbo.cols_hi, turbo.cols_lo, wq, mask, turbo.live)
    timing = sweep_ab("K6", k.sweep_rowmax_bitset,
                      k.sweep_rowmax_bitset_plain, args, nsw, parent)
    nbytes, ops, work = bitset_work(wq_np, mask, nsw)
    b_ms, b_by = bound(nbytes, ops, PEAK_INT8)
    return {"name": "sweep_rowmax_bitset", "route": "cuda",
            "source": "elasticsearch_tpu_torch/parallel/csrc/sweep_rowmax.cu",
            "replaces": "elasticsearch_tpu/parallel/kernels.py:581",
            "launches": launches, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": int_mm_ms(turbo, wq),
            "library_note": "torch._int_mm of the four score products over "
                            "all slots; the mask gate has no library call",
            **timing,
            "shape": {"QC": qc, "Hpt": int(turbo.cols_hi.shape[1]),
                      "nsw": nsw, **work}}


def check_k7(turbo, chunk, launches, parent=None):
    """K7 at QC 256 on the bitset route's device chunk (128 active), held
    and timed by sweep_ab (the parent's K7 beside it when given)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k
    from elasticsearch_tpu_torch.tools.k2_ab import sweep_work

    dev, qc, nsw = turbo.device, 256, turbo.nsw
    wq_np, wp_np, nr_np, qs_np = turbo._bool_weights(chunk, qc)
    wq, wp = (torch.from_numpy(x).to(dev) for x in (wq_np, wp_np))
    nreq, qs = (torch.from_numpy(x).to(dev) for x in (nr_np, qs_np))
    args = (qs, nreq, turbo.cols_hi, turbo.cols_lo, wq, wp, turbo.live)
    timing = sweep_ab("K7", k.sweep_rowmax_conj, k.sweep_rowmax_conj_plain,
                      args, nsw, parent)
    nbytes, ops, n_union, nnz = sweep_work(wq_np, turbo.Dp, nsw, wp_np,
                                           nr_np)
    b_ms, b_by = bound(nbytes, ops, PEAK_INT8)
    scored = (wq_np != 0).any(axis=(0, 2))
    return {"name": "sweep_rowmax_conj", "route": "cuda",
            "source": "elasticsearch_tpu_torch/parallel/csrc/sweep_rowmax.cu",
            "replaces": "elasticsearch_tpu/parallel/kernels.py:318",
            "launches": launches, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": int_mm_ms(turbo, wq),
            "library_note": "torch._int_mm of the four score products over "
                            "all slots; the coverage product has no library "
                            "call",
            **timing,
            "shape": {"QC": qc, "Hpt": int(turbo.cols_hi.shape[1]),
                      "nsw": nsw, "union_slots": n_union,
                      "nonzero_weights": nnz,
                      "scored_queries": int(scored.sum()),
                      "coverage_only_queries": int(
                          ((wp_np != 0).any(axis=1) & ~scored).sum())}}


def _delta(after: dict, before: dict, keys) -> dict:
    return {key: after[key] - before[key] for key in keys}


BOOL_STATS = ("bool_device", "bool_host", "fallbacks", "bitset_gallop",
              "bitset_blocks_skipped", "bitset_packs", "phrase_builds",
              "builds", "degraded", "sparse_queries", "sparse_fallbacks",
              "cold_queries", "health_device_faults",
              "health_fallback_queries")


@contextlib.contextmanager
def env_set(name: str, value: str):
    """Environment variable `name` set to value while the block runs, then
    restored."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


@contextlib.contextmanager
def plain_calls():
    """Yields a dict that counts the calls of every plain version in
    kernels (`*_plain`, and mask_chunk_counts, the plain K5's counts)
    while the block runs: on the card a path must call none of them."""
    from elasticsearch_tpu_torch.parallel import kernels

    names = [n for n in dir(kernels) if n.endswith("_plain")
             and callable(getattr(kernels, n))] + ["mask_chunk_counts"]
    calls = {n: 0 for n in names}
    saved = {n: getattr(kernels, n) for n in names}

    def counting(name):
        def call(*a, **kw):
            calls[name] += 1
            return saved[name](*a, **kw)
        return call

    for n in names:
        setattr(kernels, n, counting(n))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)


@contextlib.contextmanager
def record_k1_launches():
    """Yields a list that collects the arguments of every K1 launch
    (kernels.build_columns) while the block runs, references kept so each
    can be launched again on its own groups."""
    from elasticsearch_tpu_torch.parallel import kernels

    launches = []
    build = kernels.build_columns

    def spy(*args):
        launches.append(args[:6])
        return build(*args)

    kernels.build_columns = spy
    try:
        yield launches
    finally:
        kernels.build_columns = build


def check_k1_phrases(turbo, launches):
    """Each recorded K1 launch of the phrase phase again on its own groups
    and lanes, into scratch column tiles: by CUDA events and from a CUDA
    graph, beside its bound (lanes and groups read once, the groups' tiles
    written once)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    hi_s, lo_s = (torch.empty_like(c) for c in (turbo.cols_hi,
                                                 turbo.cols_lo))
    rows = []
    for args in launches:
        def kern(args=args):
            k.build_columns(*args, hi_s, lo_s)

        ng = int(args[0].shape[0])
        lanes = int(args[1].long().sum()) * 128
        nbytes = lanes * 8 + ng * 16 + ng * k.TILE * 2
        b_ms, b_by = bound(nbytes, ng * k.TILE * 8, PEAK_F32)
        ms = cuda_ms(kern, 5)
        device_ms = graph_ms(kern, 20)
        rows.append({"groups": ng, "zero_groups": int((args[1] == 0).sum()),
                     "lanes": lanes, "ms": ms, "device_ms": device_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_share": b_ms / device_ms if device_ms else None})
    del hi_s, lo_s
    torch.cuda.empty_cache()
    return rows


def serve_bool_routes(eng, turbo, fp, n_docs, batches):
    """The bool batches on both sweeps: ES_TPU_BITSET=1 (K5 + K6) and
    ES_TPU_BITSET=0 (K7), each with every launch count set to 0 just before
    and read just after. Returns {route: (answers per batch, report, K3
    groups)}."""
    from elasticsearch_tpu_torch.parallel import kernels

    out = {}
    for route, flag in (("bitset", "1"), ("coverage", "0")):
        st0 = dict(eng.stats)
        fault_log = []
        answers, lat = [], []
        with env_set("ES_TPU_BITSET", flag), \
                record_fallbacks(turbo, flag == "1") as fell, \
                record_k3_groups(turbo) as k3_groups, plain_calls() as pc:
            kernels.reset_launches()
            for specs in batches:
                t = time.time()
                answers.append(eng.search_bool(specs, k=K,
                                               fault_log=fault_log))
                lat.append(time.time() - t)
            launches = dict(kernels.LAUNCHES)
        d = _delta(eng.stats, st0, BOOL_STATS)
        n_q = sum(len(b) for b in batches)
        rep = {"batch_latency_s": lat, "queries": n_q,
               "launches": launches, **d}
        require(not any(pc.values()),
                f"bool {route}: a plain version ran on the card: {pc}")
        require(launches["pack_presence_bits"] == d["bitset_packs"],
                f"bool {route}: {d['bitset_packs']} repacks, "
                f"{launches['pack_presence_bits']} pack launches")
        log(f"bool route {route}: {rep}")
        require(not fault_log, f"bool {route}: fault records {fault_log}")
        for key in ("degraded", "sparse_fallbacks", "cold_queries",
                    "health_device_faults", "health_fallback_queries"):
            require(d[key] == 0, f"bool {route}: {key} = {d[key]}")
        require(d["bool_device"] > 0, f"bool {route}: no device query")
        rep["fallbacks_explained"] = hold_fallbacks(
            fp, n_docs, turbo.nsw, fell, d["fallbacks"], n_q,
            f"bool {route}")
        log(f"bool {route}: {rep['fallbacks_explained']} of "
            f"{d['fallbacks']} certificate fallbacks explained by exact "
            f"scores")
        need = (("pack_presence_bits", "intersect_bitset",
                 "sweep_rowmax_bitset")
                if route == "bitset" else ("sweep_rowmax_conj",))
        for name in need + ("sparse_gather",):
            require(launches[name] > 0,
                    f"bool {route}: {name} never launched: {launches}")
        require(len(k3_groups) == launches["sparse_gather"],
                f"bool {route}: {len(k3_groups)} K3 groups recorded, "
                f"{launches['sparse_gather']} launched")
        out[route] = (answers, rep, k3_groups)
    return out


def bool_phases(eng, turbo, fp, n_docs, tokens, bounds, mapper,
                k3_parent_run=None, k6_parent=None, k7_parent=None,
                k5_parent_fn=None):
    """Configs 2 and 3 on the main path's engine: the bool batches on both
    sweeps, K5-K7 held against their plain versions on the bitset route's
    dispatch, then slop-0 phrase batches and one slop-2 match_phrase body.
    Returns (kernel rows, serving report)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels
    from elasticsearch_tpu_torch.search.serving import (
        _turbo_bool_spec, extract_plan,
    )

    bool_qs = draw_bool(BOOL_BATCH, VOCAB)
    dsl = []
    for body in BOOL_DSL:
        plan = extract_plan(body, mapper)
        require(plan is not None and plan.is_conjunctive,
                f"bool body did not flatten: {body}")
        spec = _turbo_bool_spec(plan)
        require(spec is not None, f"no search_bool spec for {body}")
        dsl.append(spec)
    routes = serve_bool_routes(eng, turbo, fp, n_docs, [bool_qs, dsl])
    specs = bool_qs + dsl
    answers = {r: tuple(np.concatenate([a[i] for a in ans[0]])
                        for i in range(3)) for r, ans in routes.items()}
    hs, ho = hold_bool(turbo, specs, answers, "bool hold")
    # selective (host) and heavy (device) draws, and every DSL body
    checked = [0, 1, 2, 3, 5, 7] + list(range(BOOL_BATCH, len(specs)))
    for qi in checked:
        bs, bd = brute_bool(fp, n_docs, specs[qi])
        require(np.array_equal(ho[qi][:len(bd)], bd)
                and np.array_equal(hs[qi][:len(bs)], bs),
                f"bool {specs[qi]} differs from the numpy scorer")
    log(f"numpy scorer agrees on {len(checked)} bool queries")

    # ---- K5-K7, and K3 on the cold SHOULD sides, on the bitset route's
    # device chunk ----
    bit_l = routes["bitset"][1]["launches"]
    cov_l = routes["coverage"][1]["launches"]
    with env_set("ES_TPU_BITSET", "1"):
        resolved = [turbo._resolve_bool(q) for q in bool_qs]
        dev_idx, host_idx = turbo._bool_routes(resolved)
        dev_idx, _ = turbo._gallop_routes(resolved, dev_idx, host_idx)
        chunk = [resolved[i] for i in dev_idx[:256]]
        pack, prior_peak = check_pack(turbo, bit_l["pack_presence_bits"])
        torch.cuda.empty_cache()
        k5, mask = check_k5(turbo, chunk, bit_l["intersect_bitset"],
                            k5_parent_fn)
        rows = [pack, k5, check_k6(turbo, chunk, mask,
                             bit_l["sweep_rowmax_bitset"], k6_parent)]
        del mask
        rows.append(check_k7(turbo, chunk, cov_l["sweep_rowmax_conj"],
                             k7_parent))
        k3_bool = check_k3_bool(
            {r: routes[r][2] for r in routes}, turbo.Dp // kernels.TILE,
            {"bitset": bit_l["sparse_gather"],
             "coverage": cov_l["sparse_gather"]}, k3_parent_run)
    for r in rows:
        log(f"{r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
            f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{r['library_ms']}, launches {r['launches']}")
    log(f"sparse_gather on the bool chunk: {k3_bool}")

    # ---- slop-0 phrases (config 3), head-term phrases and one slop-2
    # match_phrase body ----
    phrases = draw_phrases(PHRASES, fp, tokens, bounds)
    slop2 = extract_plan({"query": {"match_phrase": {"body": {
        "query": " ".join(phrases[0]), "slop": 2}}}}, mapper)
    slop2 = _turbo_bool_spec(slop2)
    require(slop2 is not None and slop2["phrases"][0][1] == 2,
            "slop-2 body did not flatten")
    st0 = dict(eng.stats)
    fault_log = []
    p_ans, p_lat = [], []
    step = min(PHRASE_BATCH, turbo.Hp // 2)
    with record_fallbacks(turbo, True) as fell, plain_calls() as pc, \
            record_k1_launches() as k1_launches:
        kernels.reset_launches()
        for batch in ([phrases[i:i + step] for i in range(0, PHRASES, step)]
                      + [HEAD_PHRASES]):
            t = time.time()
            p_ans.append(eng.search_phrase(batch, k=K, slop=0,
                                           fault_log=fault_log))
            p_lat.append(time.time() - t)
        t = time.time()
        p_ans.append(eng.search_bool([slop2], k=K, fault_log=fault_log))
        p_lat.append(time.time() - t)
        p_launch = dict(kernels.LAUNCHES)
    pd = _delta(eng.stats, st0, BOOL_STATS)
    n_p = PHRASES + len(HEAD_PHRASES) + 1
    prep = {"batch_latency_s": p_lat, "phrases": PHRASES,
            "head_phrases": len(HEAD_PHRASES),
            "phrase_batch": step, "launches": p_launch, **pd}
    log(f"phrases: {prep}")
    require(not fault_log, f"phrases: fault records {fault_log}")
    require(not any(pc.values()),
            f"phrases: a plain version ran on the card: {pc}")
    require(len(k1_launches) == p_launch["build_columns"],
            f"phrases: {len(k1_launches)} K1 launches recorded, "
            f"{p_launch['build_columns']} counted")
    require(p_launch["pack_presence_bits"] == pd["bitset_packs"] > 0,
            f"phrases: {pd['bitset_packs']} repacks, "
            f"{p_launch['pack_presence_bits']} pack launches")
    for key in ("degraded", "health_device_faults",
                "health_fallback_queries"):
        require(pd[key] == 0, f"phrases: {key} = {pd[key]}")
    # at the default ES_TPU_BITSET_HOST_DF most drawn phrases match fewer
    # docs than the threshold and gallop to the host after K1 has built
    # their adjacency columns (the reference's order); the head-term
    # phrases take the device sweep
    require(pd["phrase_builds"] > 0 and p_launch["build_columns"] > 0,
            "phrases: no adjacency column built")
    require(pd["bool_device"] > 0, "phrases: no device query")
    for name in ("intersect_bitset", "sweep_rowmax_bitset"):
        require(p_launch[name] > 0, f"phrases: {name} never launched")
    prep["fallbacks_explained"] = hold_fallbacks(
        fp, n_docs, turbo.nsw, fell, pd["fallbacks"], n_p, "phrases")
    p_specs = [{"phrases": [(p, 0, 1.0)]}
               for p in phrases + HEAD_PHRASES] + [slop2]
    got = tuple(np.concatenate([a[i] for a in p_ans]) for i in range(3))
    phs, pho = hold_bool(turbo, p_specs, {"bitset": got}, "phrase hold")
    for qi in range(3):
        bs, bd = brute_bool(fp, n_docs, p_specs[qi])
        require(np.array_equal(pho[qi][:len(bd)], bd)
                and np.array_equal(phs[qi][:len(bs)], bs),
                f"phrase {phrases[qi]} differs from the numpy scorer")
    require((phs[:PHRASES + len(HEAD_PHRASES), 0] > 0).all(),
            "a drawn or head-term phrase matched nothing")
    log("numpy scorer agrees on 3 phrases")
    k1_phrase = check_k1_phrases(turbo, k1_launches)
    del k1_launches
    log(f"K1 launches of the phrase phase: {k1_phrase}")

    n_ph = PHRASES + len(HEAD_PHRASES)
    report = {"bool": {r: rep for r, (_, rep, _) in routes.items()},
              "answers": (bool_qs, hs[:BOOL_BATCH], ho[:BOOL_BATCH]),
              "phrase_answers": (phrases + HEAD_PHRASES, phs[:n_ph],
                                 pho[:n_ph]),
              "phrase": prep, "k1_phrase_launches": k1_phrase,
              "peak_device_bytes_before": prior_peak,
              "bitset_bytes": int(turbo.bits.nbytes),
              "unexplained_fallback_limit": MAX_CERT_FALLBACK_SHARE}
    return rows, report, k3_bool


# ---------------------------------------------------------------------------
# quantized kNN serving (BASELINE config 4, cut to 2M vectors)
# ---------------------------------------------------------------------------

KNN_DOCS = 2_000_000
KNN_DIMS = 768
KNN_PARTS = 4          # the stacked engine: a 4-shard kNN index on one card
KNN_QUERIES = 256
KNN_PLANTED = 128      # the first 128 queries get near-duplicate rows
KNN_DUPS = 16
KNN_FILTER_SHARES = (0.5, 0.02)
KNN_NPROBE = 24
KNN_RECALL_SAMPLE = 16  # planted and Gaussian queries each, held to f32
MIN_RECALL = 0.99
# An f32 sum of 768 exact products (bf16 x bf16 fits f32) taken in any order
# lies within gamma_767 * sum|q_i v_i| of the exact sum (Higham, Accuracy and
# Stability of Numerical Algorithms, eq. 3.5). The int8 route's rescore gemm
# and the dense route's gemm may sum in different orders, so their cosine
# scores (1 + dot/|q|)/2 differ by at most gamma_767 * |q_bf16| |v_bf16| /
# |q| (Cauchy-Schwarz; unit rows, |v_bf16| <= 1 + 2^-8) plus the transform's
# roundings, 4 ulp of a score below 2.
KNN_GAMMA = 767 * 2.0 ** -24 / (1 - 767 * 2.0 ** -24)
K9_SMALL_QC = 16          # check_k9's small query tile, beside QC 256
KNN_COUNTERS = ("knn_queries", "knn_int8_dispatches", "knn_rescore_docs",
                "knn_host_fallbacks", "knn_uncertified", "knn_bytes")
KNN_MAPPINGS = {"properties": {"tag": {"type": "keyword"},
                               "vec": {"type": "dense_vector",
                                       "dims": KNN_DIMS}}}


class _KnnSeg:
    """The partition shape select_knn_engine and _knn_filter_mask read."""

    def __init__(self, n_docs, offset, postings, vectors):
        self.n_docs = n_docs
        self.offset = offset           # first global row of the partition
        self.postings = postings
        self.vectors = vectors


def knn_data(n: int):
    """The config-4 column as bench.py draws it (default_rng(7), 768-d
    standard normal f32, cosine) and its 256 queries (bench.py's next draw
    from the same generator). Each of the first KNN_PLANTED queries gets
    KNN_DUPS near-duplicates, q + 0.33 |q| / sqrt(768) * noise (cosine about
    0.95), written over seeded distinct rows. A keyword tag per row (0 green,
    1 red) for the filtered DSL bodies."""
    krng = np.random.default_rng(7)
    vec = krng.standard_normal((n, KNN_DIMS), dtype=np.float32)
    qs = krng.standard_normal((KNN_QUERIES, KNN_DIMS)).astype(np.float32)
    prng = np.random.default_rng(8)
    at = prng.choice(n, size=(KNN_PLANTED, KNN_DUPS), replace=False)
    for i in range(KNN_PLANTED):
        noise = prng.standard_normal((KNN_DUPS, KNN_DIMS), dtype=np.float32)
        scale = np.float32(0.33 * np.linalg.norm(qs[i]) / np.sqrt(KNN_DIMS))
        vec[at[i]] = qs[i] + scale * noise
    norms = np.concatenate([np.linalg.norm(vec[o:o + (1 << 18)], axis=1)
                            for o in range(0, n, 1 << 18)]).astype(np.float32)
    tags = np.random.default_rng(9).integers(0, 2, size=n)
    return vec, norms, qs, tags


def knn_segments(vec, norms, tags, n_parts: int):
    """n_parts equal partitions of the column, each with its tag postings
    (built with the port's build_field_postings) and its VectorColumn."""
    from elasticsearch_tpu_torch.index.segment import (
        VectorColumn, build_field_postings,
    )

    n = len(vec)
    step = -(-n // n_parts)
    segs = []
    for off in range(0, n, step):
        m = min(step, n - off)
        fp = build_field_postings("tag", np.ones(m, np.int64),
                                  np.arange(m, dtype=np.int64),
                                  tags[off:off + m], ["green", "red"])
        col = VectorColumn(vec[off:off + m], norms[off:off + m],
                           np.ones(m, bool), KNN_DIMS, "cosine")
        segs.append(_KnnSeg(m, off, {"tag": fp}, {"vec": col}))
    return segs


def knn_bodies(qs):
    """8 `knn` DSL bodies (4 filtered on the keyword tag) with the global-row
    predicate each filter must select, and two bodies extract_knn_plan must
    decline (hybrid query + knn, boost != 1)."""
    def vec(i):
        return [float(x) for x in qs[i]]

    red, green = (lambda t: t == 1), (lambda t: t == 0)
    bodies = [
        ({"knn": {"field": "vec", "query_vector": vec(0), "k": 10}}, None),
        ({"knn": {"field": "vec", "query_vector": vec(128), "k": 10,
                  "num_candidates": 100}}, None),
        ({"knn": [{"field": "vec", "query_vector": vec(1), "k": 5}]}, None),
        ({"knn": {"field": "vec", "query_vector": vec(129), "k": 20},
          "size": 20}, None),
        ({"knn": {"field": "vec", "query_vector": vec(2), "k": 10,
                  "filter": {"term": {"tag": "red"}}}}, red),
        ({"knn": {"field": "vec", "query_vector": vec(130), "k": 10,
                  "filter": {"bool": {"must": [
                      {"term": {"tag": "green"}}]}}}}, green),
        ({"knn": {"field": "vec", "query_vector": vec(3), "k": 10,
                  "filter": {"bool": {"filter": [
                      {"terms": {"tag": ["red"]}}]}}}}, red),
        ({"knn": {"field": "vec", "query_vector": vec(131), "k": 10,
                  "filter": {"bool": {
                      "must": [{"terms": {"tag": ["red", "green"]}}],
                      "must_not": [{"term": {"tag": "red"}}]}}}}, green),
    ]
    declined = [
        {"query": {"term": {"tag": "red"}},
         "knn": {"field": "vec", "query_vector": vec(0), "k": 10}},
        {"knn": {"field": "vec", "query_vector": vec(0), "k": 10,
                 "boost": 2.0}},
    ]
    return bodies, declined


@contextlib.contextmanager
def knn_spy():
    """Records, while the block runs, each rescore's certificate [QC] (one
    per chunk and partition, in call order) and each device merge's
    per-partition inputs, by wrapping the engine module's _rescore and
    merge_partition_topk (the engine calls both through module globals)."""
    from elasticsearch_tpu_torch.parallel import knn as knn_mod

    rec = {"cert": [], "merge": []}
    rescore, merge = knn_mod._rescore, knn_mod.merge_partition_topk

    def rescore_spy(*a, **kw):
        out = rescore(*a, **kw)
        rec["cert"].append(out[2].cpu().numpy())
        return out

    def merge_spy(s, o, k, **kw):
        rec["merge"].append((np.array(s), np.array(o), k))
        return merge(s, o, k, **kw)

    knn_mod._rescore, knn_mod.merge_partition_topk = rescore_spy, merge_spy
    try:
        yield rec
    finally:
        knn_mod._rescore, knn_mod.merge_partition_topk = rescore, merge


def knn_score_bound(qs) -> np.ndarray:
    """Per query, the most two f32 summation orders can move a cosine score
    (KNN_GAMMA above)."""
    import torch

    qb = torch.from_numpy(qs).to(torch.bfloat16).double().numpy()
    qn = np.linalg.norm(qs.astype(np.float64), axis=1)
    return (KNN_GAMMA * np.linalg.norm(qb, axis=1) * (1 + 2.0 ** -8)
            / np.maximum(qn, 1e-20) + 4 * 2.0 ** -23)


def knn_agree(a, b, bound, label) -> dict:
    """The int8 route's answers `a` against the dense route's `b`: the same
    (partition, ord) in the same order, except a near-tie whose two docs'
    scores lie within the query's bound (counted as a swap); every score
    within the bound. Returns the counts."""
    (sa, pa, oa), (sb, pb, ob) = a, b
    require(sa.shape == sb.shape and np.isfinite(sa).all(),
            f"{label}: result shapes or finiteness")
    require(np.array_equal(sa > 0, sb > 0), f"{label}: empty slots differ")
    swaps, cells, worst = 0, 0, 0.0
    for qi in range(len(sa)):
        d = np.abs(sa[qi].astype(np.float64) - sb[qi])
        require((d <= bound[qi]).all(),
                f"{label}: query {qi} scores differ by {d.max()} > "
                f"{bound[qi]}")
        if not (np.array_equal(pa[qi], pb[qi])
                and np.array_equal(oa[qi], ob[qi])):
            swaps += 1
        cells += int((d > 0).sum())
        worst = max(worst, float(d.max()))
    return {"queries": len(sa), "swaps": swaps, "score_cells_differing": cells,
            "score_cells": int(sa.size), "max_score_diff": worst,
            "bound_max": float(bound.max())}


def knn_serve(eng, segs, qs, masks, tags, mapper, label):
    """The kNN batches on one engine, every launch count set to 0 just before
    and read just after: the 256 queries on the int8 route (twice: the first
    call uploads the dense mirror the uncertified queries re-run on), the
    same on the dense route (ES_TPU_KNN_INT8=0), the 256 filtered queries on
    both routes (K9's masked variant), the DSL bodies through
    extract_knn_plan on both routes, and one int8 batch at
    ES_TPU_KNN_NPROBE=24. Holds the int8 answers to the dense ones."""
    from elasticsearch_tpu_torch.parallel import kernels
    from elasticsearch_tpu_torch.parallel import knn as knn_mod
    from elasticsearch_tpu_torch.search.serving import (
        _knn_filter_mask, extract_knn_plan,
    )

    def parts_of(mask):
        return [mask[s.offset:s.offset + s.n_docs] for s in segs]

    works = [knn_mod.KnnWork(q) for q in qs]
    fworks = [knn_mod.KnnWork(q, parts_of(m)) for q, m in zip(qs, masks)]
    bodies, declined = knn_bodies(qs)
    for body in declined:
        require(extract_knn_plan(body, mapper) is None,
                f"extract_knn_plan accepted {list(body)}")
    dsl = []
    for body, pred in bodies:
        plan = extract_knn_plan(body, mapper)
        require(plan is not None, f"knn body did not flatten: {body['knn']}")
        flt = None
        if pred is not None:
            flt = [_knn_filter_mask(plan.filter_plan, s) for s in segs]
            require(np.array_equal(np.concatenate(flt), pred(tags)),
                    f"filter mask of {body['knn']['filter']} is wrong")
        dsl.append((knn_mod.KnnWork(np.asarray(plan.vector, np.float32),
                                    flt), plan.k))

    n0 = knn_mod.knn_node_stats()
    fault_log, ans, lat = [], {}, {}

    def serve(name, batch):
        t = time.time()
        ans[name] = eng.search_many([batch], k=K, fault_log=fault_log)[0]
        lat[name] = time.time() - t

    kernels.reset_launches()
    with knn_spy() as spy:
        serve("int8", works)
        certs = [c[:len(qs)] for c in spy["cert"]]
        serve("int8_warm", works)
        with env_set("ES_TPU_KNN_INT8", "0"):
            serve("dense", works)
        serve("filtered", fworks)
        with env_set("ES_TPU_KNN_INT8", "0"):
            serve("filtered_dense", fworks)
        for route, flag in (("dsl", "1"), ("dsl_dense", "0")):
            with env_set("ES_TPU_KNN_INT8", flag):
                t = time.time()
                ans[route] = [eng.search_many([[w]], k=kk,
                                              fault_log=fault_log)[0]
                              for w, kk in dsl]
                lat[route] = time.time() - t
        with env_set("ES_TPU_KNN_NPROBE", str(KNN_NPROBE)):
            serve("nprobe", works)
        merges = spy["merge"]
    launches = dict(kernels.LAUNCHES)
    n1 = knn_mod.knn_node_stats()
    d = {c: n1[c] - n0[c] for c in KNN_COUNTERS}
    log(f"knn {label}: latencies {lat}; launches {launches}; counters {d}")
    require(not fault_log, f"knn {label}: fault records {fault_log}")
    require(d["knn_host_fallbacks"] == 0,
            f"knn {label}: {d['knn_host_fallbacks']} host fallbacks")
    need = ["knn_int8_window_topc"] + (["merge_topk"] if eng.S > 1 else [])
    for name in need:
        require(launches[name] > 0,
                f"knn {label}: {name} never launched: {launches}")
    require(eng._hbm.total_bytes() == eng.hbm_bytes(),
            f"knn {label}: ledger {eng._hbm.total_bytes()} bytes, engine "
            f"{eng.hbm_bytes()}")

    bound = knn_score_bound(qs)
    agree = {"unfiltered": knn_agree(ans["int8"], ans["dense"], bound,
                                     f"knn {label} unfiltered"),
             "repeat": knn_agree(ans["int8_warm"], ans["int8"], bound,
                                 f"knn {label} repeat"),
             "filtered": knn_agree(ans["filtered"], ans["filtered_dense"],
                                   bound, f"knn {label} filtered")}
    qidx = [0, 128, 1, 129, 2, 130, 3, 131]
    dsl_agree = [knn_agree(a, b, bound[[qi]], f"knn {label} body {j}")
                 for j, (a, b, qi) in enumerate(zip(ans["dsl"],
                                                    ans["dsl_dense"], qidx))]
    agree["dsl"] = {key: sum(x[key] for x in dsl_agree)
                    for key in ("queries", "swaps", "score_cells_differing")}
    require((ans["int8"][0] > 0).all(), f"knn {label}: an empty top-10")
    offs = np.array([s.offset for s in segs], np.int64)

    def rows_of(s, p, o):
        return (offs[p] + o)[s > 0]

    s, p, o = ans["filtered"]
    for qi in range(len(qs)):
        require(masks[qi][rows_of(s[qi], p[qi], o[qi])].all(),
                f"knn {label}: filtered query {qi} returned a filtered-out "
                f"row")
    for (body, pred), (s, p, o) in zip(bodies, ans["dsl"]):
        if pred is not None:
            rows = rows_of(s[0], p[0], o[0])
            require(len(rows) and pred(tags[rows]).all(),
                    f"knn {label}: body {body['knn']['filter']} returned a "
                    f"row its filter excludes")

    def recall(got, truth):
        hit = tot = 0
        for qi in range(len(qs)):
            t = {(a, b) for s, a, b in zip(*(x[qi] for x in truth)) if s > 0}
            g = {(a, b) for s, a, b in zip(*(x[qi] for x in got)) if s > 0}
            hit += len(t & g)
            tot += len(t)
        return hit / max(tot, 1)

    nq = len(qs)
    unc = np.concatenate([~c[None] for c in certs])          # [calls, Q]
    rep = {"engine": label, "stats": eng.stats(),
           "batch_latency_s": lat,
           "qps": {key: nq / v for key, v in lat.items()
                   if not key.startswith("dsl")},
           "launches": launches, "counters": d,
           "uncertified_share_planted": float(unc[:, :KNN_PLANTED].mean()),
           "uncertified_share_gaussian": float(unc[:, KNN_PLANTED:].mean()),
           "agreement": agree,
           "nprobe": KNN_NPROBE,
           "nprobe_recall_vs_dense": recall(ans["nprobe"], ans["dense"]),
           "ledger_bytes": eng._hbm.total_bytes(),
           "hbm_bytes": eng.hbm_bytes()}
    log(f"knn {label}: {rep}")
    return ans, rep, merges, fworks


def exact_topk_rows(vec, norms, q_rows, k=K):
    """bench.py's cpu_knn on a set of queries: rows normalized in f32 on the
    host, f32 BLAS dots, (1 + dot / |q|) / 2, the top k by (score desc, row
    asc); a block of rows at a time."""
    n = len(vec)
    qn = np.maximum(np.linalg.norm(q_rows, axis=1).astype(np.float32),
                    np.float32(1e-20))
    sc = np.empty((len(q_rows), n), np.float32)
    for o in range(0, n, 1 << 18):
        vn = vec[o:o + (1 << 18)] / np.maximum(norms[o:o + (1 << 18)],
                                               np.float32(1e-20))[:, None]
        sc[:, o:o + len(vn)] = ((1.0 + (vn @ q_rows.T) / qn) / 2.0).T
    out = []
    for row in sc:
        sel = np.argpartition(-row, k)[:k]
        out.append(sel[np.lexsort((sel, -row[sel]))])
    return out


def check_k9(eng, qs, fworks):
    """K9 against its plain version on the engine's own first-pass inputs at
    QC = 256 (every window active at nprobe 0): the unmasked launch and the
    masked one with the filtered batch's masks, and the unmasked launch on
    the first 16 queries, each timed, with its score pass and selection
    pass apart (torch.profiler's kernel events, with their counts), its
    scratch bytes and its chunk count, and each held once more on outputs
    and scratch filled with NaN / -1 (kernels.poisoned); on the S = 1
    engine also torch._int_mm of the int8 product alone. Returns
    {variant: numbers}."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    dev, qc = eng.device, len(qs)
    qi8, qm = (torch.from_numpy(x).to(dev)
               for x in eng._quantize_queries(qs))
    stacked = eng.stats()["fused"] == 1
    if stacked:
        q8, meta = eng.d_q8, eng.d_meta
        act = torch.ones((eng.S, qc, eng.nw), dtype=torch.float32, device=dev)
        fm = torch.from_numpy(np.stack([eng._filter_mask(i, fworks, qc)
                                        for i in range(eng.S)])).to(dev)
    else:
        q8, meta = eng.d_q8[0], eng.d_meta[0]
        act = torch.ones((qc, eng.nw), dtype=torch.float32, device=dev)
        fm = torch.from_numpy(eng._filter_mask(0, fworks, qc)).to(dev)
    rows = sum(eng.n_docs)
    out = {}
    q16 = K9_SMALL_QC
    for variant, args in (
            ("unmasked", (qi8, qm, q8, meta, act, None)),
            ("masked", (qi8, qm, q8, meta, act, fm)),
            (f"unmasked_qc{q16}", (qi8[:q16], qm[:q16], q8, meta,
                                   act[..., :q16, :].contiguous(), None))):
        res = {}
        fmask, nq = args[5], int(args[0].shape[0])
        ms = cuda_ms(lambda: res.__setitem__("k", k.knn_int8_window_topc(
            *args, similarity="cosine")), 10)
        plain_ms = cuda_ms(lambda: res.__setitem__(
            "p", k.knn_int8_window_topc_plain(*args, similarity="cosine")), 1)
        (ks, kr), (ps, pr) = res["k"], res["p"]
        err = max(max_abs_err(ks, ps), max_abs_err(kr, pr))
        require(err == 0.0 and torch.equal(ks, ps) and torch.equal(kr, pr),
                f"K9 {variant} kernel vs plain: max_abs_err {err}")
        with k.poisoned():
            xs, xr = k.knn_int8_window_topc(*args, similarity="cosine")
        require(torch.equal(xs, ps) and torch.equal(xr, pr),
                f"K9 {variant} on outputs and scratch filled with NaN / -1 "
                f"differs from the plain version")
        del xs, xr
        nbytes = (q8.numel() + meta.numel() * 4 + args[0].numel()
                  + args[1].numel() * 4 + args[4].numel() * 4
                  + ks.numel() * 8 + (0 if fmask is None else fmask.numel()))
        b_ms, b_by = bound(nbytes, 2 * nq * KNN_DIMS * rows, PEAK_INT8)
        cw = k.knn_chunk_windows(eng.nw, nq, eng.S)
        n_chunks = len(k.knn_chunks(eng.nw, cw))
        passes = {}
        for name in ("knn_score_pass", "knn_select_pass"):
            passes[name] = kernel_alone(lambda: k.knn_int8_window_topc(
                *args, similarity="cosine"), (name,),
                per_call={name: n_chunks})
        out[variant] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                        "poisoned_run": "bitwise",
                        "bound_ms": b_ms, "bound_by": b_by, "QC": nq,
                        "candidates": int(torch.isfinite(ks).sum()),
                        "score_pass_ms": passes["knn_score_pass"][0],
                        "select_pass_ms": passes["knn_select_pass"][0],
                        "pass_events": {n: v[1]["events"][n]
                                        for n, v in passes.items()},
                        "chunk_windows": cw, "chunks": n_chunks,
                        "scratch_bytes": eng.S * cw * nq * k.KNN_W * 4}
        del res
    out["shape"] = {"QC": qc, "nw": eng.nw, "dimsP": eng.dimsP,
                    "partitions": eng.S, "rows": rows}
    if not stacked:
        b = q8.reshape(-1, eng.dimsP).t()
        out["library_ms"] = cuda_ms(lambda: torch._int_mm(qi8, b), 5)
    del fm
    torch.cuda.empty_cache()
    log(f"K9 on the {'stacked' if stacked else 'S = 1'} engine: {out}")
    return out


def k4_parent(path):
    """The parent commit's K4 C entry (one warp a query, k sequential argmax
    steps; the same signature as this tree's), built with nvcc from
    `path`, or None when `path` is not a file."""
    import ctypes

    from elasticsearch_tpu_torch.tools.k9_ab import parent_entry

    p, i = ctypes.c_void_p, ctypes.c_int
    return parent_entry(path, "k4_parent", "es_merge_topk",
                        [p, p, p, p, p, i, i, i, p])


def k4_raw(fn, s, o, kk):
    """One call of a K4 C entry `fn` (this tree's or the parent's) with the
    wrapper's allocations (kernels._out, so filled inside
    kernels.poisoned) and none of its checks: the A/B's like-for-like
    call. Returns (scores, parts, ords)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    q, lanes = int(s.shape[0]), int(s.shape[1])
    out = (k._out((q, kk), torch.float32, s.device),
           k._out((q, kk), torch.int32, s.device),
           k._out((q, kk), torch.int32, s.device))
    rc = fn(s.data_ptr(), o.data_ptr(), *(t.data_ptr() for t in out), q,
            lanes, kk, torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"K4 launch failed: cudaError {rc}")
    return out


def check_k4(merges, answer, dev, parent=None):
    """K4 against its plain version on the stacked engine's first int8
    merge ([S, Q, k] per-partition top-k laid partition-major as
    merge_partition_topk lays them), and against the answer the engine
    returned from it; once more on outputs filled with NaN / -1
    (kernels.poisoned). The wrapper timed by CUDA events, alone
    (torch.profiler's kernel events, and replayed from a CUDA graph,
    graph_ms) and for the host's enqueue. Given the parent commit's C
    entry (`parent`, from k4_parent), it and this tree's entry are called
    the same way (k4_raw) in turns (parent, kernel, kernel, parent), by
    events and for the host's enqueue, the parent also alone and from a
    graph, and the parent held the same way."""
    import torch

    from elasticsearch_tpu_torch.parallel import cuda_build
    from elasticsearch_tpu_torch.parallel import kernels as k

    s_all, o_all, kk = merges[0]
    S, Q, _ = s_all.shape
    s = torch.from_numpy(s_all).to(dev).permute(1, 0, 2).reshape(
        Q, S * kk).contiguous()
    o = torch.from_numpy(o_all).to(dev).permute(1, 0, 2).reshape(
        Q, S * kk).contiguous()
    res = {}

    def kern():
        res["k"] = k.merge_topk(s, o, k=kk)

    ms_turns = [cuda_ms(kern, 50), cuda_ms(kern, 50)]
    ms = float(np.median(ms_turns))
    turns = {"parent": [], "kernel": []}
    if parent:
        own = cuda_build.kernel("merge_topk")
        runs = {"kernel": lambda: k4_raw(own, s, o, kk),
                "parent": lambda: k4_raw(parent, s, o, kk)}
        for name in ("parent", "kernel", "kernel", "parent"):
            turns[name].append(cuda_ms(runs[name], 50))
    kernel_ms, events = kernel_alone(kern, ("merge_kernel",), 20)
    device_ms = graph_ms(kern, 50)
    host_ms = host_enqueue_ms(kern)
    plain_ms = cuda_ms(lambda: res.__setitem__(
        "p", k.merge_topk_plain(s, o, k=kk)), 3)
    err = max(max_abs_err(a, b) for a, b in zip(res["k"], res["p"]))
    require(err == 0.0 and all(torch.equal(a, b)
                               for a, b in zip(res["k"], res["p"])),
            f"K4 kernel vs plain: max_abs_err {err}")
    with k.poisoned():
        again = k.merge_topk(s, o, k=kk)
    require(all(torch.equal(a, b) for a, b in zip(again, res["p"])),
            "K4 on outputs filled with NaN / -1 differs from the plain "
            "version")
    require(all(np.array_equal(a.cpu().numpy(), b)
                for a, b in zip(res["k"], answer)),
            "K4: the rerun differs from the engine's merged answer")
    ab = None
    if parent:
        par_kernel_ms, par_events = kernel_alone(runs["parent"],
                                                 ("merge_kernel",), 20)
        ab = {"entry_ms": turns["kernel"], "entry_host_enqueue_ms":
              host_enqueue_ms(runs["kernel"]),
              "parent_ms": turns["parent"],
              "parent_kernel_ms": par_kernel_ms,
              "parent_kernel_events": par_events,
              "parent_device_ms": graph_ms(runs["parent"], 50),
              "parent_host_enqueue_ms": host_enqueue_ms(runs["parent"])}
        with k.poisoned():
            again = k4_raw(parent, s, o, kk)
        require(all(torch.equal(a, b) for a, b in zip(again, res["p"])),
                "the parent K4 differs from the plain version")
    b_ms, b_by = bound(s.numel() * 8 + Q * kk * 12, Q * kk * S * kk * 3,
                       PEAK_F32)
    log(f"K4: events {ms_turns} ms, alone {kernel_ms} ms, graph "
        f"{device_ms:.4f} ms, host enqueue {host_ms:.4f} ms; the two C "
        f"entries called alike {ab}")
    return {"name": "merge_topk", "route": "cuda",
            "source": "elasticsearch_tpu_torch/parallel/csrc/merge_topk.cu",
            "replaces": "elasticsearch_tpu/parallel/kernels.py:654",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_note": "no single PyTorch call merges by (score desc, "
                            "partition asc, ord asc)",
            "events_ms": ms_turns, "kernel_ms": kernel_ms,
            "kernel_events": events, "device_ms": device_ms,
            "host_enqueue_ms": host_ms,
            "entry_ab": ab, "poisoned_run": "bitwise",
            "shape": {"Q": Q, "S": S, "k": kk}}


def knn_phase(n: int, device="cuda", k4_parent_src=None,
              data=None) -> tuple:
    """Config 4 (quantized kNN, cosine, 768-d) on an S = 1 engine, then,
    after freeing it, on a stacked S = 4 engine over the same rows; each
    served as knn_serve says. Holds recall@10 of the S = 1 int8 answers
    against exact f32 scores, the stacked engine's planted answers against
    the S = 1 engine's, and K9 and K4 against their plain versions (K4
    beside the parent commit's source `k4_parent_src` when it is a file).
    `data`: knn_data(n) already started (prefetch), else drawn here.
    Returns (kernel rows, report)."""
    import gc

    import torch

    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.parallel import knn as knn_mod
    from elasticsearch_tpu_torch.search.serving import select_knn_engine

    if n < KNN_DOCS:
        log(f"CUT: kNN column cut from {KNN_DOCS} to {n} vectors")
    t = time.time()
    vec, norms, qs, tags = data.result() if data is not None \
        else knn_data(n)
    data_s = time.time() - t
    frng = np.random.default_rng(10)
    masks = [frng.random(n, dtype=np.float32)
             < KNN_FILTER_SHARES[i % len(KNN_FILTER_SHARES)]
             for i in range(KNN_QUERIES)]
    mapper = MapperService(KNN_MAPPINGS)
    log(f"knn data: {n} x {KNN_DIMS} in {data_s:.1f}s")

    report, k9, ans1 = {"vectors": n, "dims": KNN_DIMS, "cut": n < KNN_DOCS,
                        "data_s": data_s}, {}, None
    k4 = None
    for n_parts in (1, KNN_PARTS):
        label = f"S={n_parts}"
        segs = knn_segments(vec, norms, tags, n_parts)
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        eng = select_knn_engine(segs, "vec", device=device)
        require(eng is not None, f"knn {label}: no engine selected")
        eng.extend_qc_sizes([KNN_QUERIES, KNN_QUERIES // 2])
        torch.cuda.synchronize()
        build_s = time.time() - t
        require(eng.stats()["fused"] == int(n_parts > 1),
                f"knn {label}: stacked {eng.stats()['fused']}")
        ans, rep, merges, fworks = knn_serve(eng, segs, qs, masks, tags,
                                             mapper, label)
        rep["build_s"] = build_s
        rep["node_stats"] = knn_mod.knn_node_stats()
        rep["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        k9[label] = check_k9(eng, qs, fworks)
        if n_parts == 1:
            ans1 = ans
            pick = (list(range(KNN_RECALL_SAMPLE))
                    + list(range(KNN_PLANTED, KNN_PLANTED + KNN_RECALL_SAMPLE)))
            t = time.time()
            truth = exact_topk_rows(vec, norms, qs[pick])
            hits = [len(set(tr.tolist())
                        & set(ans["int8"][2][qi][ans["int8"][0][qi] > 0]
                              .tolist())) / K for tr, qi in zip(truth, pick)]
            rep["recall_at_10"] = float(np.mean(hits))
            rep["recall_at_10_planted"] = float(np.mean(hits[:len(hits) // 2]))
            rep["recall_at_10_gaussian"] = float(np.mean(hits[len(hits) // 2:]))
            log(f"knn recall@10 against exact f32 on {len(pick)} queries: "
                f"{rep['recall_at_10']} ({time.time() - t:.1f}s)")
            require(rep["recall_at_10"] >= MIN_RECALL,
                    f"knn recall@10 {rep['recall_at_10']} < {MIN_RECALL}")
            rep["integrity"] = knn_integrity(eng, qs, ans)
        else:
            k4 = check_k4(merges, ans["int8"], eng.device,
                          k4_parent(k4_parent_src))
            k4["launches"] = rep["launches"]["merge_topk"]
            s4, p4, o4 = ans["int8"]
            s1, _, o1 = ans1["int8"]
            offs = np.array([s.offset for s in segs], np.int64)
            rows4 = np.where(s4 > 0, offs[p4] + o4, 0)
            pl = slice(0, KNN_PLANTED)
            require(np.array_equal(rows4[pl], o1[pl]),
                    "knn: the stacked engine's planted answers differ from "
                    "the S = 1 engine's")
            d = np.abs(s4[pl].astype(np.float64) - s1[pl])
            bnd = knn_score_bound(qs)[pl]
            require((d <= bnd[:, None]).all(),
                    "knn: stacked scores beyond the bound of S = 1's")
            rep["planted_vs_s1"] = {"queries": KNN_PLANTED,
                                    "score_cells_differing":
                                        int((d > 0).sum())}
        report[label] = rep
        del eng, segs, ans, merges, fworks
        gc.collect()
        torch.cuda.empty_cache()
    one, four = k9["S=1"], k9[f"S={KNN_PARTS}"]
    launches = (report["S=1"]["launches"]["knn_int8_window_topc"]
                + report[f"S={KNN_PARTS}"]["launches"]["knn_int8_window_topc"])
    row = {"name": "knn_int8_window_topc", "route": "cuda",
           "source": "elasticsearch_tpu_torch/parallel/csrc/knn_window_topc.cu",
           "replaces": "elasticsearch_tpu/parallel/kernels.py:1210",
           "launches": launches,
           "max_abs_err": max(v[x]["max_abs_err"] for v in (one, four)
                              for x in ("unmasked", "masked",
                                        f"unmasked_qc{K9_SMALL_QC}")),
           "ms": one["unmasked"]["ms"], "plain_ms": one["unmasked"]["plain_ms"],
           "bound_ms": one["unmasked"]["bound_ms"],
           "bound_by": one["unmasked"]["bound_by"],
           "library_ms": one["library_ms"],
           "library_note": "torch._int_mm of the int8 product alone "
                           "[256, 768] x [768, rows]; no call adds the "
                           "epilogue and the window top-32",
           "shape": one["shape"], "unmasked": one["unmasked"],
           "masked": one["masked"],
           f"unmasked_qc{K9_SMALL_QC}": one[f"unmasked_qc{K9_SMALL_QC}"],
           "stacked": {x: four[x] for x in (
               "unmasked", "masked", f"unmasked_qc{K9_SMALL_QC}", "shape")},
           "launches_by_engine": {
               lbl: report[lbl]["launches"]["knn_int8_window_topc"]
               for lbl in ("S=1", f"S={KNN_PARTS}")}}
    return [row, k4], report


# ---------------------------------------------------------------------------
# config 6: device aggregations (the analytics tier, K8)
# ---------------------------------------------------------------------------

AGG_DOCS = 10_000_000   # bench.py's N_DOCS: the size config 6 runs at on a TPU
AGG_VOCAB = 256
AGG_REQUESTS = 8        # config-6 masks at 5% selectivity, default_rng(31)
AGG_HOLD = 2            # of them held against the host path
AGG_COUNTERS = ("agg_queries", "agg_device_dispatches", "agg_host_fallbacks",
                "agg_bytes")
# bench.py's AGG_BENCH_SPEC
AGG_SPEC = {
    "tags": {"terms": {"field": "tag", "size": 64},
             "aggs": {"rev": {"stats": {"field": "price"}}}},
    "weekly": {"date_histogram": {"field": "ts", "fixed_interval": "7d"},
               "aggs": {"p": {"sum": {"field": "price"}}}},
}
# the shapes of the reference's suite (tests/test_agg_device.py), each held
# against the host path on the masks named. Calendar bodies only on sparse
# masks: the host's calendar _key_of is a Python loop per value.
_ALL_MASKS = ("p05", "p02", "p90", "empty")
AGG_SHAPES = {
    "terms": ({"t": {"terms": {"field": "tag", "size": 50}}}, _ALL_MASKS),
    "terms_metrics": ({"t": {
        "terms": {"field": "tag", "size": 50},
        "aggs": {"p": {"stats": {"field": "price"}},
                 "a": {"avg": {"field": "price"}},
                 "lo": {"min": {"field": "price"}},
                 "nv": {"value_count": {"field": "price"}}}}}, _ALL_MASKS),
    "histogram_stats": ({"h": {
        "histogram": {"field": "price", "interval": 7.5},
        "aggs": {"s": {"stats": {"field": "price"}}}}}, _ALL_MASKS),
    "date_month_extended": ({"d": {
        "date_histogram": {"field": "ts", "calendar_interval": "month"},
        "aggs": {"s": {"extended_stats": {"field": "price"}}}}},
        ("p02", "empty")),
    "date_12h": ({"d": {"date_histogram": {
        "field": "ts", "fixed_interval": "12h"}}}, _ALL_MASKS),
    "date_7d_offset": ({"d": {"date_histogram": {
        "field": "ts", "fixed_interval": "7d", "offset": 10_800_000}}},
        _ALL_MASKS),
}
AGG_SYNTH_BUCKETS = 60_000   # the synthetic K8 check: four bucket tiles


def agg_leaf(n: int, seed: int = 29, vocab: int = AGG_VOCAB,
             device="cuda"):
    """Config 6's analytics leaf, drawn as bench.py's _synth_agg_leaf draws
    it (seed 29, vocab 256): 1-2 Zipf(1.1) keyword tags per doc (deduped,
    per-doc sorted CSR), a 90-day timestamp column and a price column with
    20% gaps, as the port's KeywordColumn / NumericColumn, on `device` (the
    agg tier's engine is the leaf's device's). Returns an AggContext."""
    from types import SimpleNamespace

    from elasticsearch_tpu_torch import device as _device

    from elasticsearch_tpu_torch.index.segment import (
        KeywordColumn, NumericColumn,
    )
    from elasticsearch_tpu_torch.search.aggregations import AggContext

    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    n_tags = 1 + (rng.random(n) < 0.33).astype(np.int64)
    doc_of = np.repeat(np.arange(n, dtype=np.int64), n_tags)
    draws = rng.choice(vocab, size=len(doc_of), p=probs).astype(np.int64)
    pair = np.unique(doc_of * vocab + draws)   # doc-major, ord asc, deduped
    all_ords = (pair % vocab).astype(np.int32)
    counts = np.bincount(pair // vocab, minlength=n)
    ord_start = np.concatenate([[0], np.cumsum(counts)])
    kc = KeywordColumn(
        terms=[f"t{i}" for i in range(vocab)],
        term_to_ord={f"t{i}": i for i in range(vocab)},
        ords=all_ords[ord_start[:-1]].astype(np.int32),
        max_ords=all_ords[ord_start[1:] - 1].astype(np.int32),
        exists=np.ones(n, bool), ord_start=ord_start, all_ords=all_ords)
    ts = (1_600_000_000_000
          + rng.integers(0, 90 * 86_400_000, size=n)).astype(np.float64)
    tcol = NumericColumn(values=ts, max_values=ts, exists=np.ones(n, bool),
                         value_start=np.arange(n + 1, dtype=np.int64),
                         all_values=ts)
    p_exists = rng.random(n) < 0.8
    price = np.round(rng.normal(40, 12, size=n), 2)
    pcol = NumericColumn(
        values=np.where(p_exists, price, 0.0),
        max_values=np.where(p_exists, price, 0.0), exists=p_exists,
        value_start=np.concatenate(
            [[0], np.cumsum(p_exists.astype(np.int64))]),
        all_values=price[p_exists])
    seg = SimpleNamespace(n_docs=n, keyword={"tag": kc},
                          numeric={"ts": tcol, "price": pcol}, _device={},
                          torch_device=_device.resolve(device))
    leaf = SimpleNamespace(segment=seg, n_docs=n)
    return AggContext(leaf=leaf, mapper=None, executor=None,
                      live=np.ones(n, bool))


def run_aggs(ctx, spec, masks):
    """The full agg pipeline per mask (parse_aggs -> collect_leaf ->
    reduce_partials -> finalize_aggs); (responses, host-clock seconds)."""
    from elasticsearch_tpu_torch.search.aggregations import (
        collect_leaf, finalize_aggs, parse_aggs, reduce_partials,
    )

    out, lat = [], []
    for m in masks:
        t = time.time()
        aggs, pipes = parse_aggs(spec)
        partial = collect_leaf(aggs, ctx, m)
        out.append(finalize_aggs(aggs, pipes,
                                 reduce_partials(aggs, [partial])))
        lat.append(time.time() - t)
    return out, lat


@contextlib.contextmanager
def agg_route(device: bool):
    """The device route (AGG_DEVICE_MIN_DOCS at its default, below the
    leaf) or the host path (the floor above any leaf)."""
    import elasticsearch_tpu_torch.search.aggregations as aggs_mod

    prev = aggs_mod.AGG_DEVICE_MIN_DOCS
    if not device:
        aggs_mod.AGG_DEVICE_MIN_DOCS = 1 << 60
    try:
        yield
    finally:
        aggs_mod.AGG_DEVICE_MIN_DOCS = prev


_HOST_JOBS: list = []     # (ctx, [(spec, mask)]) for the forked workers
_EXACT_JOBS: list = []    # (engine, [query part]) for the forked workers


def _host_exact_job(i: int):
    eng, parts = _EXACT_JOBS[0]
    return eng.search_many_host([parts[i]], k=K)[0]


def host_exact_runs(eng, parts):
    """eng.search_many_host of each part (a list of queries) in forked
    worker processes: the exact posting merge holds the GIL for most of its
    second a query at 8M docs, so threads overlap little (137 s for the
    main path's 168 queries on one host). The workers run numpy only,
    never the card, and exit with the pool."""
    import multiprocessing

    _EXACT_JOBS[:] = [(eng, parts)]
    try:
        with multiprocessing.get_context("fork").Pool(
                min(len(parts), os.cpu_count() or 1)) as pool:
            return pool.map(_host_exact_job, range(len(parts)), chunksize=1)
    finally:
        _EXACT_JOBS.clear()


def _agg_host_job(i: int):
    ctx, jobs = _HOST_JOBS[0]
    with agg_route(False):
        return run_aggs(ctx, jobs[i][0], [jobs[i][1]])


def agg_host_runs(ctx, jobs):
    """run_aggs of each (spec, mask) job on the host path, in forked worker
    processes: the host aggregators hold the GIL (a terms agg with metric
    sub-aggs loops over its buckets, 90 s at 10M docs), so threads do not
    overlap them. The workers run numpy only, never the card, and exit
    with the pool."""
    import multiprocessing

    _HOST_JOBS[:] = [(ctx, jobs)]
    try:
        with multiprocessing.get_context("fork").Pool(
                min(len(jobs), os.cpu_count() or 1)) as pool:
            return pool.map(_agg_host_job, range(len(jobs)), chunksize=1)
    finally:
        _HOST_JOBS.clear()


@contextlib.contextmanager
def agg_dispatch_timer(acc: list):
    """Host-clock seconds of each agg_device._dispatch call (mask upload,
    K8, read-back) appended to `acc`: the rest of a request is host work
    around the device (masks, metric refinement, bucket folding)."""
    from elasticsearch_tpu_torch.search import agg_device

    real = agg_device._dispatch

    def timed(seg, works):
        t = time.time()
        try:
            return real(seg, works)
        finally:
            acc.append(time.time() - t)

    agg_device._dispatch = timed
    try:
        yield
    finally:
        agg_device._dispatch = real


def agg_counts() -> dict:
    from elasticsearch_tpu_torch.search import agg_device

    with agg_device._COUNTS_LOCK:
        return {k: agg_device._COUNTS[k] for k in AGG_COUNTERS}


K8_QS = (1, 4, 16, 64)      # the engine's rungs that a 10M-doc mask fits


def k8_parent(path):
    """The parent commit's K8 (grid (chunk group, query, section), the mask
    gathered per query; its C entry has no word scratch and adds into
    outputs the caller zero-fills), built with nvcc from `path`. Returns
    run(mask, blob, ps, n_seg) -> [counts per section] with the old
    wrapper's allocations (one zero-filled output a section), or None when
    `path` is not a file."""
    import ctypes

    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k
    from elasticsearch_tpu_torch.tools.k9_ab import parent_entry

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = parent_entry(path, "k8_parent", "es_agg_counts",
                      [p, ll, i, p, ll, i, p, ll, i, p, i, i, p])
    if fn is None:
        return None

    def run(mask, blob, ps, n_seg):
        q = int(mask.shape[0])
        outs = [torch.zeros((q, n_seg), dtype=torch.int32,
                            device=blob.device) for _ in ps]
        p1, out1 = (ps[1], outs[1].data_ptr()) if len(ps) > 1 else (0, 0)
        rc = fn(mask.data_ptr(), int(mask.shape[1]), q, blob.data_ptr(), 0,
                ps[0], outs[0].data_ptr(), k._agg_section_len(ps[0]), p1,
                out1, len(ps), int(n_seg),
                torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"parent K8 launch failed: cudaError {rc}")
        return outs

    return run


def k8_histogram(q: int, n_seg: int) -> dict:
    """The count kernel's histogram plan as the built agg_counts.cu makes
    it (es_agg_plan): word groups (one count launch each), W buckets a pass
    and the passes over the block's pairs of the first group, and the
    passes over the pairs summed over the groups."""
    import ctypes

    from elasticsearch_tpu_torch.parallel import cuda_build

    plan = (ctypes.c_int * 4)()
    rc = cuda_build.kernel("agg_plan")(q, n_seg, plan)
    require(rc == 0, f"es_agg_plan({q}, {n_seg}) failed: {rc}")
    return {"groups": plan[0], "width": plan[1], "passes": plan[2],
            "pair_reads": plan[3]}


def k8_case(mask, blob, ps, n_seg, parent=None):
    """K8 on one (mask, blob) pair: held bitwise against its plain version,
    once more with its outputs and word scratch filled with -1 first
    (kernels.poisoned);
    timed by CUDA events in turns with the parent commit's kernel (parent,
    kernel, kernel, parent) when given, alone (torch.profiler: every K8
    kernel of the entry, the pack and each group's count, summed per call,
    with the events seen against those launched) and for the host's
    enqueue, and as the device time of the call's work replayed from a
    CUDA graph (graph_ms: the pack, which zeroes the outputs, and the
    counts); with its
    bound and the index_add_ yardstick (the scatter half
    alone, the mask pre-gathered at every in-range pair, into [sections *
    Q * n_segments]) where its index tensor stays under 4 GB."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    if len(ps) == 1:
        def kern():
            return [k.agg_segment_counts(mask, blob, p=ps[0],
                                         n_segments=n_seg)]

        def plain():
            return [k.agg_segment_counts_plain(mask, blob, p=ps[0],
                                               n_segments=n_seg)]
    else:
        def kern():
            return list(k.agg_two_level_counts(mask, blob, pd=ps[0],
                                               pm=ps[1], n_segments=n_seg))

        def plain():
            return list(k.agg_two_level_counts_plain(
                mask, blob, pd=ps[0], pm=ps[1], n_segments=n_seg))
    q, n_docs = int(mask.shape[0]), int(mask.shape[1])
    res = {}
    turns = {"parent": [], "kernel": []}
    for name in (["parent"] if parent else []) + ["kernel", "kernel"] + (
            ["parent"] if parent else []):
        if name == "kernel":
            turns[name].append(cuda_ms(lambda: res.__setitem__("k", kern()),
                                       20))
        else:
            turns[name].append(cuda_ms(lambda: res.__setitem__(
                "o", parent(mask, blob, ps, n_seg)), 10))
    ms = float(np.median(turns["kernel"]))
    hist = k8_histogram(q, n_seg)
    names = ("count_kernel", "pack_kernel" if q > 1 else "pack_bits_kernel")
    kernel_ms, events = kernel_alone(kern, names, 5,
                                     {"count_kernel": hist["groups"]})
    device_ms = graph_ms(kern)
    host_ms = host_enqueue_ms(kern, 50)
    plain_ms = cuda_ms(lambda: res.__setitem__("p", plain()), 3)
    err = max(max_abs_err(a, b) for a, b in zip(res["k"], res["p"]))
    require(err == 0.0 and all(torch.equal(a, b)
                               for a, b in zip(res["k"], res["p"])),
            f"K8 kernel vs plain: max_abs_err {err}")
    with k.poisoned():
        again = kern()
    require(all(torch.equal(a, b) for a, b in zip(again, res["p"])),
            "K8 on outputs and word scratch filled with -1 differs from the "
            "plain version")
    del again
    par = None
    if parent:
        require(all(torch.equal(a, b) for a, b in zip(res["o"], res["p"])),
                "the parent K8 differs from the plain version")
        par_kernel_ms, par_events = kernel_alone(
            lambda: parent(mask, blob, ps, n_seg), ("agg_counts_kernel",), 5)
        par = {"ms": turns["parent"], "kernel_ms": par_kernel_ms,
               "kernel_events": par_events,
               "device_ms": graph_ms(lambda: parent(mask, blob, ps, n_seg))}
    pairs = sum(ps)
    lib_ms, lib_note = None, None
    if len(ps) * q * pairs * 8 >= 4e9:
        lib_note = (f"not timed: its int64 index tensor would hold "
                    f"{len(ps) * q * pairs * 8 / 1e9:.1f} GB")
    else:
        idx, vals = [], []
        for si, (d, sg) in enumerate(k.agg_counted_pairs(blob, ps, n_seg,
                                                         n_docs)):
            rows = torch.arange(q, device=blob.device)[:, None]
            idx.append(((si * q + rows) * n_seg + sg[None, :]).reshape(-1))
            vals.append(mask[:, d].to(torch.int32).reshape(-1))
        idx, vals = torch.cat(idx), torch.cat(vals)
        acc = torch.zeros(len(ps) * q * n_seg, dtype=torch.int32,
                          device=blob.device)
        lib_ms = cuda_ms(lambda: acc.index_add_(0, idx, vals), 5)
        del idx, vals, acc
    b_ms, b_by = bound(blob.numel() * 4 + q * n_docs + len(ps) * q * n_seg * 4,
                       q * pairs, PEAK_F32)
    counted = sum(int(x.sum()) for x in res["k"])
    del res
    torch.cuda.empty_cache()
    return {"ms": ms, "events_ms": turns["kernel"], "kernel_ms": kernel_ms,
            "kernel_events": events, "device_ms": device_ms,
            "host_enqueue_ms": host_ms,
            "plain_ms": plain_ms, "max_abs_err": err,
            "poisoned_run": "bitwise", "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "library_note": lib_note, "parent": par,
            "histogram": hist,
            "shape": {"Q": q, "n_docs": n_docs, "pairs": list(ps),
                      "n_segments": n_seg,
                      "n_tiles": -(-n_seg // k.AGG_SEG_TILE),
                      "counted": counted}}


def k8_masks(sels, q: int, exists):
    """[q, n] bool K8 masks: the config-6 masks first, then further 5%
    masks (default_rng(32)) where q passes them, as a bulk tier would fill
    a rung with distinct works."""
    rows = list(sels[:q])
    rng = np.random.default_rng(32)
    while len(rows) < q:
        rows.append((rng.random(len(exists)) < 0.05) & exists)
    return np.stack(rows)


def check_k8(seg, sels, launches, device, parent=None):
    """K8 against its plain version on the card at the path's shapes, and
    beside the parent commit's kernel (`parent`, from k8_parent) on the
    same inputs: the terms_metric layout (config 6's tags + stats) at the
    engine's rungs Q = 1, 4, 16 and 64 (256 would need a 2.5 GB mask), the
    uniq layout of ts (the 7d date_histogram's 2,161 hour ranks, doc
    order) at Q = 1 and 16, and a synthetic layout of 10M doc-ordered
    pairs over AGG_SYNTH_BUCKETS buckets (four tiles, every chunk spanning
    them all) at Q = 1. Each case is k8_case's."""
    import torch

    from elasticsearch_tpu_torch.search import agg_device

    tm = seg._device["aggdev:termsm:tag:price"]
    uq = seg._device["aggdev:uniq:ts:3600000"]
    n = seg.n_docs
    qmax = max(K8_QS)
    t = time.time()
    rows = k8_masks(sels, qmax, seg.keyword["tag"].exists)
    log(f"K8 masks: {qmax} x {n} in {time.time() - t:.1f}s")
    cases = {}
    tm_ps = [tm.meta["pd"], tm.meta["pm"]]
    for q in K8_QS:
        m = torch.from_numpy(np.ascontiguousarray(rows[:q])).to(device)
        cases[f"terms_metric_q{q}"] = k8_case(m, tm.dev, tm_ps,
                                              tm.meta["n_segments"], parent)
        if q in (1, 16):
            cases[f"uniq_ts_q{q}"] = k8_case(m, uq.dev, [uq.meta["p"]],
                                             uq.meta["n_segments"], parent)
        del m
        torch.cuda.empty_cache()
    del rows
    one = torch.from_numpy(sels[0][None].copy()).to(device)
    rng = np.random.default_rng(41)
    d, s, ct0, ct1 = agg_device._pack_pairs(
        np.arange(n, dtype=np.int32),
        rng.integers(0, AGG_SYNTH_BUCKETS, size=n).astype(np.int32), n)
    blob = torch.from_numpy(np.concatenate([d, s, ct0, ct1])).to(device)
    cases["synthetic_4_tiles_q1"] = k8_case(one, blob, [len(d)],
                                            AGG_SYNTH_BUCKETS, parent)
    del blob, one
    torch.cuda.empty_cache()
    main = cases["terms_metric_q1"]
    row = {"name": "agg_counts", "route": "cuda",
           "source": "elasticsearch_tpu_torch/parallel/csrc/agg_counts.cu",
           "replaces": "elasticsearch_tpu/parallel/kernels.py:1007",
           "launches": launches,
           "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
           "ms": main["ms"], "plain_ms": main["plain_ms"],
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "library_ms": main["library_ms"],
           "library_note": "index_add_ of the mask pre-gathered at every "
                           "in-range pair (the scatter half)",
           "shape": main["shape"], "cases": cases}
    for label, c in cases.items():
        par = c["parent"]
        log(f"K8 {label}: kernel {c['ms']:.4f} ms (alone {c['kernel_ms']}, "
            f"graph {c['device_ms']:.4f}, host enqueue "
            f"{c['host_enqueue_ms']:.4f}), parent {par and par['ms']} (alone "
            f"{par and par['kernel_ms']}, graph {par and par['device_ms']}), "
            f"plain "
            f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']}), index_add_ {c['library_ms']}, "
            f"{c['histogram']}, {c['shape']}")
    return row


def agg_phase(n: int, device="cuda", k8_parent_src=None,
              leaf=None) -> tuple:
    """Config 6 (analytics) through the port's aggregation entry points
    (parse_aggs -> collect_leaf -> reduce_partials -> finalize_aggs, the
    device route through agg_device and K8) on a synthetic n-doc leaf:
    AGG_REQUESTS timed requests after one warm call, and again with the
    bulk tier's wait at 0, held against the host path; the reference
    suite's shapes held on sparse, dense and empty
    masks; a coalesced batch of works; K8 against its plain version (and
    the parent commit's source `k8_parent_src` when it is a file).
    `device` other than "cuda" puts the leaf, and so its agg engine,
    there (a CPU rehearsal). `leaf`: agg_leaf(n, device=device) already
    started (prefetch), else drawn here.
    Returns (kernel row, report)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels
    from elasticsearch_tpu_torch.search import agg_device

    if n < AGG_DOCS:
        log(f"CUT: agg leaf cut from {AGG_DOCS} to {n} docs")
    t = time.time()
    ctx = leaf.result() if leaf is not None else agg_leaf(n, device=device)
    seg = ctx.leaf.segment
    arng = np.random.default_rng(31)
    cmasks = [arng.random(n) < 0.05 for _ in range(AGG_REQUESTS)]
    srng = np.random.default_rng(5)          # dryrun_agg's selectivities
    extra = {sel: srng.random(n) < sel for sel in (0.05, 0.2, 0.5, 0.9, 0.02)}
    masks = {"p05": cmasks[0], "p02": extra[0.02], "p90": extra[0.9],
             "empty": np.zeros(n, bool)}
    data_s = time.time() - t
    kc = seg.keyword["tag"]
    log(f"agg leaf: {n} docs, {len(kc.all_ords)} (doc, tag) pairs, "
        f"{len(seg.numeric['price'].all_values)} prices in {data_s:.1f}s")

    eng = agg_device.default_engine(seg.torch_device)
    # ---- the main path: one warm request (the layout builds), then the
    # timed ones, every launch count set to 0 just before ----
    c0 = agg_counts()
    kernels.reset_launches()
    t = time.time()
    run_aggs(ctx, AGG_SPEC, cmasks[:1])
    warm_s = time.time() - t
    disp = []
    with agg_dispatch_timer(disp):
        dev_out, lat = run_aggs(ctx, AGG_SPEC, cmasks)
    launches = dict(kernels.LAUNCHES)
    c1 = agg_counts()
    d = {k: c1[k] - c0[k] for k in AGG_COUNTERS}
    log(f"config 6: warm request (layout builds) {warm_s:.2f}s, requests "
        f"{[round(x, 4) for x in lat]}s, counters {d}, launches {launches}")
    n_collects = len(AGG_SPEC) * (AGG_REQUESTS + 1)
    require(d["agg_host_fallbacks"] == 0,
            f"agg host fallbacks on the main path: {d}")
    require(d["agg_queries"] == n_collects
            and d["agg_device_dispatches"] == n_collects,
            f"not every collect took the device: {d}")
    require(launches["agg_counts"] == d["agg_device_dispatches"] > 0,
            f"K8 launches {launches['agg_counts']} != dispatches "
            f"{d['agg_device_dispatches']}")
    require(eng.hbm_bytes() == eng.ledger_bytes() > 0,
            f"agg hbm_bytes {eng.hbm_bytes()} != ledger "
            f"{eng.ledger_bytes()}")
    for r in dev_out:
        tags = r["tags"]["buckets"]
        require(0 < len(tags) <= 64 and all(
            np.isfinite(b["rev"]["sum"]) and b["rev"]["count"] > 0
            for b in tags), "config 6: malformed tags buckets")
        require(len(r["weekly"]["buckets"]) >= 13,
                "config 6: too few weekly buckets")

    # ---- the bulk tier's wait: the same requests once more with its
    # budget at 0, so a lone collect flushes at once (not counted) ----
    disp0 = []
    with env_set("ES_TPU_SCHED_BULK_US", "0"), agg_dispatch_timer(disp0):
        out0, lat0 = run_aggs(ctx, AGG_SPEC, cmasks)
    require(out0 == dev_out, "config 6 with no bulk wait differs")
    log(f"config 6 with ES_TPU_SCHED_BULK_US=0: requests "
        f"{[round(x, 4) for x in lat0]}s, dispatch "
        f"{sum(disp0) / len(lat0):.4f}s a request against "
        f"{sum(disp) / len(lat):.4f}s at the default budget")

    # ---- K8 against its plain version (and the parent's kernel) on the
    # path's layouts, before the holds fork their host workers ----
    sels = [m & kc.exists for m in cmasks]
    row = check_k8(seg, sels, launches["agg_counts"], eng.device,
                   k8_parent(k8_parent_src))

    # ---- holds against the host path: config 6 on AGG_HOLD masks, the
    # suite's shapes on their masks (device runs first, then the host runs
    # in parallel; the route is a module global) ----
    t = time.time()
    shape_dev = {(name, m): run_aggs(ctx, spec, [masks[m]])[0][0]
                 for name, (spec, mnames) in AGG_SHAPES.items()
                 for m in mnames}
    c2 = agg_counts()
    shapes_dev_s = time.time() - t
    require(c2["agg_host_fallbacks"] == c1["agg_host_fallbacks"],
            "agg host fallbacks on the shapes")
    jobs = [(AGG_SPEC, cmasks[i]) for i in range(AGG_HOLD)] + [
        (AGG_SHAPES[name][0], masks[m]) for name, m in shape_dev]
    # (pool.map hands jobs out in order: the AGG_SHAPES order puts the
    # costly terms shapes before the cheap histograms)
    t = time.time()
    host = agg_host_runs(ctx, jobs)
    hold_s = time.time() - t
    require(agg_counts() == c2, "the host path moved the device counters")
    host_lat = [h[1][0] for h in host[:AGG_HOLD]]
    for i in range(AGG_HOLD):
        require(dev_out[i] == host[i][0][0],
                f"config 6 request {i}: device differs from the host path")
    for (key, got), (h, _) in zip(shape_dev.items(), host[AGG_HOLD:]):
        require(got == h[0], f"agg shape {key}: device differs from the "
                             f"host path")
    log(f"agg holds: {AGG_HOLD} config-6 requests and {len(shape_dev)} "
        f"shape runs equal to the host path (device {shapes_dev_s:.1f}s, "
        f"host {hold_s:.1f}s in parallel)")

    # ---- a coalesced batch: the 8 config-6 works on the terms_metric
    # layout in one search_many call (Q = 8, padded to the 16 rung) ----
    lay = seg._device["aggdev:termsm:tag:price"]
    batch = [agg_device._AggWork(lay, s) for s in sels]
    l0 = kernels.LAUNCHES["agg_counts"]
    eng.search_many([batch], 1)
    require(kernels.LAUNCHES["agg_counts"] - l0 == 1,
            "the coalesced batch did not take one K8 launch")
    for i, (w, s) in enumerate(zip(batch, sels)):
        single = agg_device._AggWork(lay, s)
        eng.search_many([[single]], 1)
        require(w.error is None and single.error is None,
                f"coalesced work {i}: {w.error or single.error}")
        require(all(np.array_equal(a, b)
                    for a, b in zip(w.result, single.result)),
                f"coalesced work {i} differs from its Q = 1 result")
    log("coalesced batch: 8 works in one dispatch equal their Q = 1 results")

    integ = agg_integrity(ctx, lay, cmasks, dev_out)

    report = {
        "docs": n, "cut": n < AGG_DOCS, "data_s": data_s,
        "tag_pairs": int(len(kc.all_ords)),
        "cross_pairs": int(lay.meta["pm"]),
        "layouts": {name: {"bytes": lay_.nbytes, "kind": lay_.kind,
                           "n_segments": lay_.meta["n_segments"]}
                    for name, lay_ in seg._device.items()
                    if isinstance(lay_, agg_device._AggLayout)},
        "warm_request_s": warm_s, "request_latency_s": lat,
        "qps": len(lat) / sum(lat),
        "dispatch_s_per_request": sum(disp) / len(lat),
        "bulk_wait_0": {"request_latency_s": lat0,
                        "dispatch_s_per_request": sum(disp0) / len(lat0)},
        "host_request_latency_s": host_lat,
        "hbm_bytes": eng.hbm_bytes(), "ledger_bytes": eng.ledger_bytes(),
        "counters": d, "launches": launches,
        "shapes_held": len(shape_dev), "hold_host_s": hold_s,
        "coalesced": {"works": len(batch), "equal_to_q1": True},
        "integrity": integ}
    del batch, lay
    return row, report


# --------------------------------------------------------------------------
# the dense search path: execute_search over the config-1 shard
# --------------------------------------------------------------------------

DENSE_MAPPING = {"properties": {
    "body": {"type": "text"}, "views": {"type": "long"},
    "price": {"type": "double"}, "published": {"type": "date"},
    "tags": {"type": "keyword"}}}
DENSE_TAGS = 64
DENSE_DELETED = 0.01       # share of the shard's docs deleted (live mask)
DENSE_REPS = 5             # warm runs of each body, median reported
PUB_T0 = 1_546_300_800_000            # 2019-01-01T00:00:00Z
PUB_SPAN = 5 * 365 * 86_400_000       # five years of ms
# card against CPU on scores through log1p: torch's CUDA and CPU log1p are
# not correctly rounded and may differ by an ulp each, and the factor
# multiplies a BM25 score: bound 4 ulp of the CPU's f32 score
DENSE_SCORE_ULPS = 4
# the pure `match` bodies, held also against brute_topk (their analyzed
# terms, boost 1)
DENSE_MATCH = {
    "match_two": ["t3", "t1200"],
    "match_head": ["t0", "t1"],
    "match_three": ["t17", "t40000", "t9"],
    "match_one_mid": ["t250"],
}
DENSE_BODIES = {
    "match_two": {"query": {"match": {"body": "t3 t1200"}}},
    "match_head": {"query": {"match": {"body": "t0 t1"}}},
    "match_three": {"query": {"match": {"body": "T17 t40000 t9"}}},
    "match_one_mid": {"query": {"match": {"body": "t250"}}},
    "bool_must_filter": {"query": {"bool": {
        "must": [{"match": {"body": "t3 t40"}}],
        "filter": [{"range": {"views": {"gte": 2}}},
                   {"term": {"tags": "tag07"}}]}}},
    "must_not": {"query": {"bool": {
        "must": [{"match": {"body": "t10 t200"}}],
        "must_not": [{"term": {"tags": "tag00"}},
                     {"range": {"price": {"gt": 50}}}]}}},
    "should_msm": {"query": {"bool": {"should": [
        {"term": {"body": "t5"}}, {"term": {"body": "t17"}},
        {"term": {"body": "t300"}}], "minimum_should_match": 2}}},
    "match_and": {"query": {"match": {"body": {
        "query": "t2 t9 t50", "operator": "and"}}}},
    "prefix_tags": {"query": {"prefix": {"tags": "tag1"}}},
    "wildcard_tags": {"query": {"bool": {
        "must": [{"match": {"body": "t7"}}],
        "filter": [{"wildcard": {"tags": "tag*3"}}]}}},
    "terms_tags": {"query": {"terms": {"tags": ["tag05", "tag33", "tag60"]}}},
    "range_published": {"query": {"bool": {
        "must": [{"match": {"body": "t12 t4000"}}],
        "filter": [{"range": {"published": {
            "gte": "2021-01-01", "lt": "2022-01-01"}}}]}}},
    "exists_price": {"query": {"bool": {
        "must": [{"match": {"body": "t25"}}],
        "filter": [{"exists": {"field": "price"}}]}}},
    "function_score_log1p": {"query": {"function_score": {
        "query": {"match": {"body": "t30 t31"}},
        "functions": [{"field_value_factor": {
            "field": "views", "factor": 1.5, "modifier": "log1p"}}],
        "boost_mode": "multiply"}}},
    "constant_score": {"query": {"constant_score": {
        "filter": {"term": {"tags": "tag02"}}, "boost": 1.5}}},
    "sort_views_search_after": {
        "query": {"term": {"body": "t900"}},
        "sort": [{"views": "desc"}, {"_doc": "asc"}],
        "search_after": [40, 0], "size": 20},
    "sort_price_filtered": {
        "query": {"bool": {"filter": [{"term": {"body": "t2000"}},
                                      {"range": {"views": {"gte": 1}}}]}},
        "sort": [{"price": "asc"}]},
    "sort_tags_desc": {"query": {"match": {"body": "t5000"}},
                       "sort": [{"tags": "desc"}, {"views": "asc"}],
                       "size": 15},
    "from_size_100": {"query": {"match": {"body": "t44 t45"}},
                      "from": 90, "size": 10},
    "track_total_head": {"query": {"match": {"body": "t0"}},
                         "track_total_hits": True},
    "source_includes": {"query": {"match": {"body": "t77 t78"}},
                        "_source": {"includes": ["views", "tags"]}},
    "highlight_body": {"query": {"match": {"body": "t101 t102"}},
                       "highlight": {"fields": {"body": {}}}},
    "min_score": {"query": {"match": {"body": "t3 t900"}}, "min_score": 8.0},
    "aggs_terms_avg": {"query": {"match": {"body": "t6 t60"}},
                       "aggs": {"tags": {"terms": {"field": "tags"}},
                                "avg_price": {"avg": {"field": "price"}}}},
    "profile": {"query": {"bool": {
        "must": [{"match": {"body": "t8 t80"}}],
        "filter": [{"range": {"price": {"lte": 20}}}]}}, "profile": True},
}


class DenseSources:
    """Read-only `_source` of every doc of the dense phase's shard, built
    on access from the token stream and the drawn columns (the fetch phase
    and highlight read only the returned hits)."""

    def __init__(self, tokens, bounds, cols):
        self.tokens, self.bounds, self.cols = tokens, bounds, cols

    def __len__(self):
        return len(self.bounds) - 1

    def __iter__(self):
        """Every doc's `_source` in order (a snapshot lists them all): the
        same dicts as __getitem__, built from a chunk's columns as lists."""
        c = self.cols
        voc = [f"t{t}" for t in range(int(self.tokens.max()) + 1)]
        tag = [f"tag{o:02d}" for o in range(DENSE_TAGS)]
        step = 65536
        for c0 in range(0, len(self), step):
            c1 = min(c0 + step, len(self))
            bnd = self.bounds[c0:c1 + 1].tolist()
            toks = self.tokens[bnd[0]:bnd[-1]].tolist()
            ts = c["tag_start"][c0:c1 + 1].tolist()
            ords = c["tag_ords"][ts[0]:ts[-1]].tolist()
            views, pub = c["views"][c0:c1].tolist(), \
                c["published"][c0:c1].tolist()
            has, price = c["p_exists"][c0:c1].tolist(), \
                c["price"][c0:c1].tolist()
            for j in range(c1 - c0):
                src = {"body": " ".join(map(voc.__getitem__, toks[
                           bnd[j] - bnd[0]:bnd[j + 1] - bnd[0]])),
                       "views": int(views[j]), "published": int(pub[j]),
                       "tags": [tag[o] for o in ords[ts[j] - ts[0]:
                                                     ts[j + 1] - ts[0]]]}
                if has[j]:
                    src["price"] = price[j]
                yield src

    def __getitem__(self, i):
        c = self.cols
        i = int(i)
        lo, hi = int(self.bounds[i]), int(self.bounds[i + 1])
        a, b = int(c["tag_start"][i]), int(c["tag_start"][i + 1])
        src = {"body": " ".join(f"t{t}" for t in self.tokens[lo:hi]),
               "views": int(c["views"][i]),
               "published": int(c["published"][i]),
               "tags": [f"tag{o:02d}" for o in c["tag_ords"][a:b]]}
        if c["p_exists"][i]:
            src["price"] = float(c["price"][i])
        return src


def _single_column(v):
    from elasticsearch_tpu_torch.index.segment import NumericColumn

    n = len(v)
    return NumericColumn(values=v, max_values=v, exists=np.ones(n, bool),
                         value_start=np.arange(n + 1, dtype=np.int64),
                         all_values=v)


def dense_segment(fp, tokens, bounds, n: int, device):
    """The config-1 shard as one port Segment on `device`: the `body`
    postings with positions, and columns drawn with numpy seed 46 —
    `views` (long, Zipf-like), `price` (double, 20% missing), `published`
    (date over five years), `tags` (keyword, 64 values, 1-3 a doc, with its
    postings) — `_source` built on access, and a live mask with
    DENSE_DELETED of the docs deleted. Returns (segment, live, columns)."""
    from elasticsearch_tpu_torch.index.segment import (
        KeywordColumn, NumericColumn, Segment, build_field_postings,
    )

    rng = np.random.default_rng(46)
    views = (np.minimum(rng.zipf(1.6, n), 1_000_000) - 1).astype(np.float64)
    p_exists = rng.random(n) >= 0.2
    price = np.round(rng.lognormal(3.0, 1.0, n), 2)
    published = (PUB_T0 + rng.integers(0, PUB_SPAN, n)).astype(np.float64)
    n_tags = rng.integers(1, 4, n)
    probs = 1.0 / np.arange(1, DENSE_TAGS + 1)
    draws = rng.choice(DENSE_TAGS, size=int(n_tags.sum()),
                       p=probs / probs.sum())
    pair = np.unique(np.repeat(np.arange(n, dtype=np.int64), n_tags)
                     * DENSE_TAGS + draws)      # doc-major, deduped
    tag_ords = (pair % DENSE_TAGS).astype(np.int32)
    tag_docs = pair // DENSE_TAGS
    tag_start = np.concatenate(
        [[0], np.cumsum(np.bincount(tag_docs, minlength=n))])
    live = rng.random(n) >= DENSE_DELETED
    terms = [f"tag{i:02d}" for i in range(DENSE_TAGS)]
    tags_kc = KeywordColumn(
        terms=terms, term_to_ord={t: i for i, t in enumerate(terms)},
        ords=tag_ords[tag_start[:-1]], max_ords=tag_ords[tag_start[1:] - 1],
        exists=np.ones(n, bool), ord_start=tag_start, all_ords=tag_ords)
    tags_fp = build_field_postings("tags", np.zeros(n, np.int64), tag_docs,
                                   tag_ords, terms)
    pcol = NumericColumn(
        values=np.where(p_exists, price, 0.0),
        max_values=np.where(p_exists, price, 0.0), exists=p_exists,
        value_start=np.concatenate(
            [[0], np.cumsum(p_exists.astype(np.int64))]),
        all_values=price[p_exists])
    cols = {"views": views, "price": price, "p_exists": p_exists,
            "published": published, "tag_start": tag_start,
            "tag_ords": tag_ords}
    seg = Segment(
        seg_id=0, doc_ids=[f"d{i}" for i in range(n)],
        sources=DenseSources(tokens, bounds, cols),
        postings={"body": fp, "tags": tags_fp},
        numeric={"views": _single_column(views), "price": pcol,
                 "published": _single_column(published)},
        keyword={"tags": tags_kc}, vectors={},
        seq_nos=np.arange(n, dtype=np.int64), device=device)
    return seg, live, cols


def dense_close(got, want, ulps: int) -> float:
    """|got - want| of two response scores, bitwise (ulps 0) or within
    `ulps` of want's f32 spacing; raises otherwise."""
    if want is None or got is None:
        require(got is None and want is None, f"score {got} vs {want}")
        return 0.0
    g, w = np.float32(got), np.float32(want)
    if ulps == 0:
        require(g.view(np.int32) == w.view(np.int32),
                f"score {got!r} is not bitwise {want!r}")
        return 0.0
    d = float(abs(np.float64(g) - np.float64(w)))
    require(d <= ulps * float(np.spacing(np.abs(w))),
            f"score {got!r} beyond {ulps} ulp of {want!r}")
    return d


def dense_same(card: dict, cpu: dict, ulps: int, label: str) -> None:
    """The card's response equal to the CPU's: totals, relation, aggs,
    ids, order, `_source`, sort values, highlights; scores bitwise, or
    within `ulps` where the body's scores pass through log1p."""
    import copy

    a, b = copy.deepcopy(card), copy.deepcopy(cpu)
    for r in (a, b):
        r.pop("took")
    ha, hb = a["hits"].pop("hits"), b["hits"].pop("hits")
    dense_close(a["hits"].pop("max_score"), b["hits"].pop("max_score"), ulps)
    require(a == b, f"{label}: totals, aggs or envelope differ: {a} vs {b}")
    require([h["_id"] for h in ha] == [h["_id"] for h in hb],
            f"{label}: hit ids or order differ")
    for x, y in zip(ha, hb):
        dense_close(x.pop("_score"), y.pop("_score"), ulps)
        require(x == y, f"{label}: hit {x.get('_id')} differs")


def dense_vs_brute(resp, fp, n: int, terms, live, label: str) -> int:
    """A pure `match` body's top-10 against brute_topk's exact numpy
    ranking over the live docs: the same ids in the same order, except a
    near-tie whose two brute scores lie within 4 ulp (counted). Returns
    the near-tie swaps."""
    bs, bd = brute_topk(fp, n, [(t, 1.0) for t in terms], live=live)
    ids = [int(h["_id"][1:]) for h in resp["hits"]["hits"]]
    require(len(ids) == len(bd), f"{label}: {len(ids)} hits, brute "
            f"{len(bd)}")
    swaps = 0
    for i, (got, want) in enumerate(zip(ids, bd)):
        if got == int(want):
            continue
        j = int(np.flatnonzero(bd == got)[0]) if got in bd else -1
        require(j >= 0 and abs(float(bs[i]) - float(bs[j])) <= 4 * float(
            np.spacing(bs[i])), f"{label}: hit {i} is d{got}, brute d{want}")
        swaps += 1
    return swaps


def scatter_parent(path):
    """The parent commit's block-scatter C entries (one thread a lane; the
    same signatures as this tree's), built with nvcc from `path`: {"bm25":
    fn, "presence": fn}, or None when `path` is not a file."""
    import ctypes

    from elasticsearch_tpu_torch.tools.k9_ab import parent_entry

    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    bm25 = parent_entry(path, "scatter_parent", "es_bm25_block_scatter",
                        [p] * 5 + [i, ll, i] + [f] * 5 + [p, p])
    if bm25 is None:
        return None
    return {"bm25": bm25,
            "presence": parent_entry(path, "scatter_parent",
                                     "es_block_presence",
                                     [p, p, p, i, ll, i, p, p])}


def scatter_raw(e, bm25: bool, ids, idf, docs, tfs, doc_len, n: int,
                avgdl: float):
    """One block-scatter call through the C entries `e` (scatter_parent)
    with the wrapper's allocation (kernels._out, so filled inside
    kernels.poisoned) and none of its checks."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    out = k._out((n,), torch.float32 if bm25 else torch.bool, docs.device)
    nb, t = int(ids.shape[0]), int(docs.shape[0])
    stream = torch.cuda.current_stream().cuda_stream
    if bm25:
        rc = e["bm25"](ids.data_ptr(), idf.data_ptr(), docs.data_ptr(),
                       tfs.data_ptr(), doc_len.data_ptr(), nb, t, n,
                       k._f32(avgdl), *k.bm25_constants(1.2, 0.75),
                       out.data_ptr(), stream)
    else:
        rc = e["presence"](ids.data_ptr(), docs.data_ptr(), tfs.data_ptr(),
                           nb, t, n, out.data_ptr(), stream)
    require(rc == 0, f"block scatter launch failed: cudaError {rc}")
    return out


def scatter_cases(seg, n: int):
    """The block-scatter calls check_block_scatter holds and times, each
    as the executor makes it: one `body` term's rows (pad_block_ids, the
    term's idf, the shard's avgdl) for a head term (df in the millions), a
    mid and a rare one, both kernels; then presence alone on the `tags`
    field: the term nearest n / 32 docs (a term filter) and the terms of
    the prefix `tag1` (prefix_tags, its rows concatenated). Returns
    [(label, field, term, (docs, tfs, doc_len), ids, idf, df, rows,
    avgdl, modes)] on the segment's device."""
    import torch

    from elasticsearch_tpu_torch.ops import bm25_idf, pad_block_ids

    out = []
    fp = seg.postings["body"]
    arrays = seg.device("post:body")
    dev = arrays[0].device
    avgdl = float(np.float32(max(
        fp.sum_doc_len / max(int(np.count_nonzero(fp.doc_len)), 1), 1e-9)))
    df = fp.doc_freq
    order = np.argsort(-df, kind="stable")
    picks = {"head": int(order[0]),
             "mid": int(order[np.argmin(np.abs(df[order] - n // 100))]),
             "rare": int(order[np.argmin(np.abs(df[order] - 40))])}
    for label, o in picks.items():
        ids_np = pad_block_ids(fp.term_block_ids(fp.terms[o]))
        idf_np = np.zeros(len(ids_np), np.float32)
        idf_np[:int(fp.block_count[o])] = bm25_idf(n, int(df[o]))
        out.append((label, "body", fp.terms[o], arrays,
                    torch.from_numpy(ids_np).to(dev),
                    torch.from_numpy(idf_np).to(dev), int(df[o]),
                    int(fp.block_count[o]), avgdl,
                    ("bm25_block_scatter", "block_presence")))
    tp = seg.postings["tags"]
    arrays = seg.device("post:tags")
    tdf = tp.doc_freq
    term_o = int(np.argmin(np.abs(tdf - n // 32)))
    for label, ords in (("tag term", [term_o]),
                        ("tag prefix", [o for o, t in enumerate(tp.terms)
                                        if t.startswith("tag1")])):
        ids_np = pad_block_ids(np.concatenate(
            [np.arange(tp.block_start[o], tp.block_start[o]
                       + tp.block_count[o], dtype=np.int32) for o in ords]))
        out.append((label, "tags", ",".join(tp.terms[o] for o in ords),
                    arrays, torch.from_numpy(ids_np).to(dev), None,
                    int(tdf[ords].sum()),
                    int(tp.block_count[ords].sum()), 0.0,
                    ("block_presence",)))
    return out


def check_block_scatter(seg, n: int, launches: dict, parent=None):
    """Both block-scatter kernels on the scatter_cases of the segment.
    Each call held bitwise against its plain version, also on outputs
    filled with NaN / ones first, and timed by CUDA events and by CUDA
    graph (the zero fill and the kernel, SCATTER_GRAPH_REPS replays), and
    alone (the kernel's profiler events); the plain version's time and,
    for the scatter half, `index_put_` of the live lanes' scores into an
    [n_docs] vector. Given `parent` (scatter_parent), the parent's kernel
    is held and timed the same way on every case, events and graphs in
    turns with this tree's (parent, kernel, kernel, parent). The bound
    reads each distinct row in [0, T) once (a pad row repeated is read
    from L2). Returns the two kernel rows (the head term's numbers on
    top)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    per = {"bm25_block_scatter": [], "block_presence": []}
    worst = 0.0
    for (label, field, term, (docs, tfs, doc_len), ids, idf, live_l, rows_l,
         avgdl, modes) in scatter_cases(seg, n):
        uniq = torch.unique(ids)
        rows_read = int(((uniq >= 0) & (uniq < docs.shape[0])).sum())
        for name in modes:
            is_bm25 = name.startswith("bm25")
            if is_bm25:
                def kern():
                    return k.bm25_block_scatter(ids, idf, docs, tfs, doc_len,
                                                avgdl=avgdl, k1=1.2, b=0.75)

                def plain():
                    return k.bm25_block_scatter_plain(
                        ids, idf, docs, tfs, doc_len, avgdl=avgdl, k1=1.2,
                        b=0.75)
            else:
                def kern():
                    return k.block_presence(ids, docs, tfs, n_docs=n)

                def plain():
                    return k.block_presence_plain(ids, docs, tfs, n_docs=n)
            runs = {"kernel": kern}
            if parent:
                runs["parent"] = lambda m=is_bm25: scatter_raw(
                    parent, m, ids, idf, docs, tfs, doc_len, n, avgdl)
            want = plain()
            bits = (lambda t: t.view(torch.int32)) if is_bm25 else (
                lambda t: t)
            for r_name, fn in runs.items():
                got = fn()
                require(torch.equal(bits(got), bits(want)),
                        f"{name} {r_name} ({label} {field}:{term}) differs "
                        f"from its plain version")
                if is_bm25 and r_name == "kernel":
                    worst = max(worst, max_abs_err(got, want))
                with k.poisoned():
                    got = fn()
                require(torch.equal(bits(got), bits(want)),
                        f"{name} {r_name} ({label}) on a poisoned output "
                        f"differs")
            turns = (["parent"] if parent else []) + ["kernel", "kernel"] + (
                ["parent"] if parent else [])
            events = {x: [] for x in runs}
            graphs = {x: [] for x in runs}
            for x in turns:
                events[x].append(cuda_ms(runs[x], 10))
            for x in turns:
                graphs[x].append(graph_ms(runs[x], SCATTER_GRAPH_REPS))
            timed = {}
            for x, fn in runs.items():
                alone, alone_info = kernel_alone(
                    fn, ("block_scatter_kernel",) if x == "parent"
                    else ("block_scatter_rows",), 5)
                timed[x] = {"ms": float(np.median(events[x])),
                            "events_ms": events[x], "kernel_ms": alone,
                            "kernel_events": alone_info,
                            "device_ms": float(np.median(graphs[x])),
                            "graphs_ms": graphs[x]}
            plain_ms = cuda_ms(plain, 3)
            lib = None
            if is_bm25:
                nz = torch.nonzero(want).reshape(-1)
                vals = want[nz]
                dst = torch.zeros(n, dtype=torch.float32, device=docs.device)
                lib = cuda_ms(lambda: dst.index_put_((nz,), vals), 10)
                out_bytes, lane_bytes, ops = 4 * n, 8 * len(ids), 8
            else:
                out_bytes, lane_bytes, ops = n, 4 * len(ids), 1
            nbytes = (lane_bytes + 1024 * rows_read + out_bytes
                      + (4 * live_l if is_bm25 else 0))
            b_ms, b_by = bound(nbytes, ops * live_l, PEAK_F32)
            mine = timed.pop("kernel")
            per[name].append({
                "term": term, "field": field, "case": label, "df": live_l,
                "blocks": rows_l, "padded_blocks": len(ids),
                "rows_read": rows_read, **mine,
                "plain_ms": plain_ms, "index_put_ms": lib, "bound_ms": b_ms,
                "bound_by": b_by, "bytes": nbytes,
                "graph_share_of_bound": b_ms / mine["device_ms"],
                "others": timed})
            log(f"{name} {label} {field}:{term} (df {live_l}, {len(ids)} "
                f"rows, {rows_read} distinct): events {mine['events_ms']} "
                f"ms, alone {mine['kernel_ms']} ms, graph "
                f"{mine['graphs_ms']} ms ({b_ms / mine['device_ms']:.0%} of "
                f"bound), plain {plain_ms:.3f} ms, index_put_ {lib}, bound "
                f"{b_ms:.4f} ms ({b_by})")
            for x, v in timed.items():
                log(f"  {x}: events {v['events_ms']} ms, alone "
                    f"{v['kernel_ms']} ms, graph {v['graphs_ms']} ms "
                    f"({b_ms / v['device_ms']:.0%} of bound)")
    rows = []
    for name, line in (("bm25_block_scatter", 56), ("block_presence", 83)):
        head = per[name][0]
        parent = head["others"].get("parent", {})
        rows.append({
            "name": name, "route": "cuda",
            "source": "elasticsearch_tpu_torch/parallel/csrc/block_scatter.cu",
            "replaces": f"elasticsearch_tpu/ops/scoring.py:{line} "
                        f"(XLA program)",
            "launches": launches[name],
            "max_abs_err": worst if name.startswith("bm25") else 0.0,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["index_put_ms"],
            "library_note": ("index_put_ of the head term's live lanes "
                             "(the scatter half)" if name.startswith("bm25")
                             else "no single PyTorch call gathers the "
                                  "blocks and marks the docs"),
            "graph_ms": head["device_ms"], "kernel_ms": head["kernel_ms"],
            "parent_ms": parent.get("ms"),
            "parent_graph_ms": parent.get("device_ms"),
            "parent_kernel_ms": parent.get("kernel_ms"),
            "poisoned_run": "bitwise", "terms": per[name]})
    return rows


def lane_parent(path):
    """The parent commit's K10 C entry (a block a row; no tile scratch),
    built with nvcc from `path`, or None when `path` is not a file."""
    import ctypes

    from elasticsearch_tpu_torch.tools.k9_ab import parent_entry

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return parent_entry(path, "lane_topk_parent", "es_lane_topk",
                        [P] * 12 + [I, I, L, I, I, I, I, I, P])


def lane_parent_call(fn, args, kw):
    """One K10 call through the parent's C entry `fn` (lane_parent), with
    the wrapper's allocations (kernels._out, so filled inside
    kernels.poisoned) and none of its checks."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    bd, bs, live, qb, qw, ts = args
    S, T, _ = (int(x) for x in bd.shape)
    Q, _, B = (int(x) for x in qb.shape)
    kk = kw["k"]
    mode = 2 if kw.get("qf") is not None else (
        1 if kw.get("addend") is not None else 0)
    out_s = k._out((S, Q, kk), torch.float32, bd.device)
    out_d = k._out((S, Q, kk), torch.int32, bd.device)
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    rc = fn(bd.data_ptr(), bs.data_ptr(), live.data_ptr(), qb.data_ptr(),
            qw.data_ptr(), ts.data_ptr(), ptr(kw.get("addend")),
            ptr(kw.get("qf")), ptr(kw.get("hp")), ptr(kw.get("nm")),
            out_s.data_ptr(), out_d.data_ptr(), S, Q, T, B,
            int(ts.shape[2]) - 1, int(live.shape[1]), kk, mode,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the parent's lane_topk failed: cudaError {rc}")
    return out_s, out_d


def lane_ab(label, parent, args, kw, want) -> dict:
    """The parent's K10 (lane_parent) beside this tree's at one recorded
    launch: the parent's output, also poisoned, bitwise equal to `want`
    (the plain version's), this tree's run twice bitwise equal to it; then
    both by CUDA-graph replay in turns (this tree, parent, parent, this
    tree; GRAPH_REPS_K10 replays each)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    def same(got):
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want))

    require(same(lane_parent_call(parent, args, kw)),
            f"{label}: the parent's kernel differs from the plain version")
    with k.poisoned():
        require(same(lane_parent_call(parent, args, kw)),
                f"{label}: the parent's kernel on poisoned outputs differs")
    require(same(k.lane_topk(*args, **kw)) and same(k.lane_topk(*args, **kw)),
            f"{label}: this tree's kernel differs run to run")
    new = (lambda: k.lane_topk(*args, **kw))
    old = (lambda: lane_parent_call(parent, args, kw))
    turns = [graph_ms(new, GRAPH_REPS_K10), graph_ms(old, GRAPH_REPS_K10),
             graph_ms(old, GRAPH_REPS_K10), graph_ms(new, GRAPH_REPS_K10)]
    return {"graph_ms": (turns[0] + turns[3]) / 2,
            "parent_graph_ms": (turns[1] + turns[2]) / 2,
            "graph_turns": turns, "parent_bitwise": True,
            "run_to_run": "bitwise"}


def dense_phase(fp, tokens, bounds, n: int, device="cuda",
                scatter=None) -> tuple:
    """The dense search path (`search.execute_search`: query phase over the
    QueryExecutor, fetch phase, highlight, aggs) on the config-1 shard as
    one port Segment on the card: DENSE_BODIES, shapes the Turbo route
    declines, each run once warm and DENSE_REPS times timed (host clock,
    ending in the response dict) with every launch count set to 0 just
    before; no plain version may run. Each card response is held against
    the port's own CPU response on the same segment (the segment's arrays
    shared, its device cache its own), the pure `match` bodies also
    against brute_topk. Then check_block_scatter, with the parent's C
    entries `scatter` (scatter_parent) beside the kernel where given.
    Returns (kernel rows, report, the segment)."""
    import copy

    import torch

    from elasticsearch_tpu_torch.index.engine import (
        EngineSearcher, SegmentView,
    )
    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.parallel import kernels
    from elasticsearch_tpu_torch.search import execute_search

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    seg, live, _ = dense_segment(fp, tokens, bounds, n, device)
    build_s = time.time() - t0
    log(f"dense segment: {n} docs, {int((~live).sum())} deleted, "
        f"{len(seg.postings['tags'].post_doc)} tag postings in "
        f"{build_s:.1f}s")
    mapper = MapperService(copy.deepcopy(DENSE_MAPPING))
    card = EngineSearcher([SegmentView(segment=seg, live=live,
                                       live_epoch=0)], seg.torch_device)

    responses, lat = {}, {}
    kernels.reset_launches()
    t = time.time()
    with plain_calls() as plain:
        for name, body in DENSE_BODIES.items():
            responses[name] = execute_search(card, mapper,
                                             copy.deepcopy(body), "shard")
            times = []
            for _ in range(DENSE_REPS):
                s = time.perf_counter()
                r = execute_search(card, mapper, copy.deepcopy(body),
                                   "shard")
                times.append(time.perf_counter() - s)
            dense_same(r, responses[name], 0, f"{name} warm repeat")
            lat[name] = float(np.median(times))
    launches = dict(kernels.LAUNCHES)
    main_s = time.time() - t
    peak = torch.cuda.max_memory_allocated() - base
    require(not any(plain.values()),
            f"plain versions ran on the card: "
            f"{ {k: v for k, v in plain.items() if v} }")
    require(launches["bm25_block_scatter"] > 0
            and launches["block_presence"] > 0,
            f"a block-scatter kernel never launched: {launches}")
    for name, r in responses.items():
        require(r["hits"]["hits"] or name == "min_score",
                f"{name}: no hits")
    log(f"dense main path: {len(DENSE_BODIES)} bodies x "
        f"{1 + DENSE_REPS} in {main_s:.1f}s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; peak "
        f"{peak} bytes over the allocated before the phase")
    for name in DENSE_BODIES:
        log(f"dense {name}: median {lat[name] * 1e3:.2f} ms, total "
            f"{responses[name]['hits'].get('total')}")

    # ---- hold: the CPU's responses on the same segment ----
    t = time.time()
    cpu_seg = copy.copy(seg)               # arrays shared, cache its own
    cpu_seg.torch_device = torch.device("cpu")
    cpu = EngineSearcher([SegmentView(segment=cpu_seg, live=live,
                                      live_epoch=0)], cpu_seg.torch_device)
    for name, body in DENSE_BODIES.items():
        ulps = DENSE_SCORE_ULPS if "log1p" in repr(body) else 0
        dense_same(responses[name],
                   execute_search(cpu, mapper, copy.deepcopy(body), "shard"),
                   ulps, name)
    del cpu, cpu_seg
    cpu_s = time.time() - t
    swaps = {name: dense_vs_brute(responses[name], fp, n, terms, live, name)
             for name, terms in DENSE_MATCH.items()}
    log(f"dense holds: {len(DENSE_BODIES)} card responses equal to the "
        f"CPU's ({cpu_s:.1f}s); {len(DENSE_MATCH)} match bodies equal to "
        f"brute_topk (near-tie swaps {swaps})")

    rows = check_block_scatter(seg, n, launches, scatter)
    del card
    torch.cuda.empty_cache()
    report = {"docs": n, "deleted": int((~live).sum()),
              "segment_build_s": build_s, "main_path_s": main_s,
              "cpu_hold_s": cpu_s, "latency_median_s": lat,
              "reps": DENSE_REPS, "launches": {
                  k: v for k, v in launches.items() if v},
              "peak_device_bytes_over_base": int(peak),
              "brute_near_tie_swaps": swaps,
              "totals": {k: r["hits"].get("total")
                         for k, r in responses.items()}}
    return rows, report, seg


# --------------------------------------------------------------------------
# the serving entry point: IndexService.search / msearch
# --------------------------------------------------------------------------

SERVING_THREADS = 32       # concurrent single searches
AGG_THREADS = 16           # concurrent aggregation requests
SERVING_KNN_ROWS = 131_072  # rows of each of the kNN service's two segments
# the serving layer's own hold, tests/test_serving.py's assert_same_results
SERVE_RTOL = SERVE_ATOL = 2e-4
AGG_BODY = DENSE_BODIES["aggs_terms_avg"]["aggs"]


def install_segments(eng, segs) -> None:
    """Put (segment, live mask) pairs into an InternalEngine as
    InternalEngine.install_segment leaves them after decoding a blob
    (appended, a local seg id, live epoch 0) without its version map,
    which nothing on the search path reads."""
    with eng._lock:
        for seg, live in segs:
            seg.seg_id = eng._next_seg_id
            eng._segments.append(seg)
            eng._live.append(np.asarray(live, bool).copy())
            eng._live_epochs.append(0)
            eng._next_seg_id += 1


def serving_service(segs, mapping, name: str, device):
    """A one-shard port IndexService on `device` whose engine holds `segs`
    (segment, live mask) pairs, put there by install_segments: the
    segments are built from arrays, and the write path runs in the CPU
    tests."""
    import copy

    from elasticsearch_tpu_torch.cluster.state import IndexMetadata
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.index_service import IndexService

    svc = IndexService(IndexMetadata(index=name, uuid=name,
                                     settings=Settings({}),
                                     mappings=copy.deepcopy(mapping)),
                       device=device)
    install_segments(svc.shards[0], segs)
    return svc


def match_body(q) -> dict:
    """A config-1 query as a DSL body: bool.should of `term`s, `boost` on
    weighted terms."""
    should = []
    for x in q:
        t, w = (x, 1.0) if isinstance(x, str) else x
        should.append({"term": {"body": t if w == 1.0
                                else {"value": t, "boost": w}}})
    return {"query": {"bool": {"should": should}}}


def bool_body(spec) -> dict:
    """A config-2 bool spec as a DSL body."""
    def term(t, w=1.0):
        return {"term": {"body": t if w == 1.0 else {"value": t, "boost": w}}}
    b = {"must": [term(t, w) for t, w in spec["must"]],
         "should": [term(t, w) for t, w in spec.get("should", [])]}
    if spec.get("filter"):
        b["filter"] = [term(t) for t in spec["filter"]]
    return {"query": {"bool": b}}


def same_results(fast, dense, label: str) -> None:
    """The fast path's response against the dense executor's: the same ids,
    totals and `_source`, scores within SERVE_RTOL relative plus SERVE_ATOL."""
    fh, dh = fast["hits"]["hits"], dense["hits"]["hits"]
    require([h["_id"] for h in fh] == [h["_id"] for h in dh],
            f"{label}: ids differ from the dense executor's")
    for a, b in zip(fh, dh):
        require(abs(a["_score"] - b["_score"])
                <= SERVE_RTOL * abs(b["_score"]) + SERVE_ATOL,
                f"{label}: score {a['_score']} against {b['_score']}")
        require(a["_source"] == b["_source"], f"{label}: _source differs")
    require(fast["hits"].get("total") == dense["hits"].get("total"),
            f"{label}: total {fast['hits'].get('total')} against "
            f"{dense['hits'].get('total')}")


def hold_rows(resps, rows, label: str) -> None:
    """Served responses against the main phase's engine rows (scores
    [Q, k], ords [Q, k]) of the same queries: ids and f32 `_score` bitwise,
    nothing past the rows' last positive score."""
    s, o = rows
    for qi, r in enumerate(resps):
        hits = r["hits"]["hits"]
        n = int((s[qi] > 0).sum())
        require(len(hits) == n, f"{label} {qi}: {len(hits)} hits, {n} rows")
        require([h["_id"] for h in hits] == [f"d{d}" for d in o[qi, :n]],
                f"{label} {qi}: ids differ from the main phase's rows")
        require(np.array_equal(np.array([h["_score"] for h in hits],
                                        np.float32), s[qi, :n]),
                f"{label} {qi}: scores differ from the main phase's rows")


DENSE_HOLD_THREADS = 8     # dense-executor answers computed at once


def hold_dense(svc, pairs, label: str, dense=None) -> dict:
    """Every (body, fast-path response) against svc._search_dense(body)
    (computed here unless `dense` has it, DENSE_HOLD_THREADS at once: the
    dense executor serves concurrent requests, and its device waits
    release the GIL). Returns the dense answers."""
    dense = {} if dense is None else dense
    pairs = list(pairs)
    todo = {}
    for body, _ in pairs:
        key = json.dumps(body, sort_keys=True)
        if key not in dense:
            todo.setdefault(key, body)
    with ThreadPoolExecutor(max_workers=DENSE_HOLD_THREADS) as ex:
        for key, ans in zip(todo, ex.map(svc._search_dense,
                                         todo.values())):
            dense[key] = ans
    for i, (body, r) in enumerate(pairs):
        same_results(r, dense[json.dumps(body, sort_keys=True)],
                     f"{label} {i}")
    return dense


def _sparse_key(args, kw):
    qoff = kw.get("qoff")
    return 1 if qoff is None else int(qoff.shape[0]) - 1


def _shape_key(args, kw):
    return tuple(tuple(a.shape) if hasattr(a, "shape") else a
                 for a in args)


def _k11_key(args, kw):
    """K11's launch shape: its input shapes and its number of runs."""
    runs = kw.get("runs")
    return _shape_key(args, kw) + (1 if runs is None else len(runs) - 1,)


def _lane_key(args, kw):
    """K10's launch shape: its mode, k and input shapes."""
    mode = ("bool" if kw.get("qf") is not None else
            "hybrid" if kw.get("addend") is not None else "lane")
    return (mode, kw["k"]) + _shape_key(args, kw)


def _fused_key(args, kw):
    """F1-F3's launch shape: (partitions, QC), from the stacked qscale."""
    return tuple(int(x) for x in args[0].shape[:2])


# the serving path's kernel wrappers besides K1, K8, the pack and the block
# scatter (their path shapes are the main phase's, held there, or K8's,
# timed by k8_case): (name, module, attribute, launch-shape key,
# arguments to copy when recorded)
PATH_KERNELS = (
    ("sweep_rowmax", "kernels", "sweep_rowmax",
     lambda a, kw: int(a[3].shape[1]), ()),
    ("sweep_rowmax_bitset", "kernels", "sweep_rowmax_bitset",
     lambda a, kw: int(a[3].shape[1]), ()),
    # K5's clause slots come from host buffers, K3's slice pool is
    # overwritten by later batches: copied
    ("intersect_bitset", "kernels", "intersect_bitset_counts",
     _shape_key, (0, 1)),
    ("sparse_gather", "kernels", "sparse_gather", _sparse_key, (4,)),
    ("knn_int8_window_topc", "knn", "knn_int8_window_topc",
     lambda a, kw: _shape_key(a, kw) + (a[5] is not None,), ()),
    ("merge_topk", "kernels", "merge_topk", _shape_key, ()),
    # BlockMax and spmd: K10's inputs are fresh per call; K11 adds into its
    # accumulator in place, which is copied before the call
    ("lane_topk", "kernels", "lane_topk", _lane_key, ()),
    ("weighted_block_scatter", "kernels", "weighted_block_scatter",
     _k11_key, (0,)),
    # F1-F3 on an index of several segments: (partitions, QC); F3's two
    # launches (the stacked K5, then K6) are counted apart, both held as F3
    ("fused_sweep_rowmax", "kernels", "fused_sweep_rowmax", _fused_key, ()),
    ("fused_sweep_rowmax_conj", "kernels", "fused_sweep_rowmax_conj",
     _fused_key, ()),
    ("fused_sweep_rowmax_bitset", "kernels", "fused_sweep_rowmax_bitset",
     _fused_key, ()),
    ("fused_intersect_bitset", "kernels", "fused_sweep_rowmax_bitset",
     _fused_key, ()),
)


@contextlib.contextmanager
def record_shapes():
    """Yields {kernel: {launch shape: [launches, args, kw]}}: the
    launches that PATH_KERNELS's wrappers make while the block runs (a
    call that launches nothing is not counted), by launch shape (the
    sweeps' query width QC, K3's query count, the others' input shapes),
    with the first launching call's arguments at each shape, the ones
    that later calls overwrite copied."""
    import threading

    from elasticsearch_tpu_torch.parallel import kernels
    from elasticsearch_tpu_torch.parallel import knn as knn_mod

    mods = {"kernels": kernels, "knn": knn_mod}
    seen = {name: {} for name, *_ in PATH_KERNELS}
    mine = threading.local()       # launches made by this thread, by name
    launch = kernels._launch

    def counted(name, *args):
        launch(name, *args)
        if not hasattr(mine, "n"):
            mine.n = {}
        mine.n[name] = mine.n.get(name, 0) + 1

    def spy(name, fn, key, copy_at):
        def call(*args, **kw):
            n0 = getattr(mine, "n", {}).get(name, 0)
            k = key(args, kw)
            kept = None
            if k not in seen[name]:        # copied before the call
                kept = tuple(a.clone() if i in copy_at else a
                             for i, a in enumerate(args))
            out = fn(*args, **kw)
            n = getattr(mine, "n", {}).get(name, 0) - n0
            if n:
                rec = seen[name].get(k)
                if rec is None:
                    rec = seen[name][k] = [0, kept, dict(kw)]
                rec[0] += n
            return out
        return call

    saved = [(kernels, "_launch", launch)]
    kernels._launch = counted
    for name, mod, attr, key, copy_at in PATH_KERNELS:
        fn = getattr(mods[mod], attr)
        saved.append((mods[mod], attr, fn))
        setattr(mods[mod], attr, spy(name, fn, key, copy_at))
    try:
        yield seen
    finally:
        for mod, attr, fn in reversed(saved):    # F3's two spies nest
            setattr(mod, attr, fn)


@contextlib.contextmanager
def record_k8():
    """Yields a dict: the query count Q of every K8 launch while the block
    runs ("qs"), and the inputs of the first launch at the largest Q
    ("args": mask, blob, pair counts, n_segments)."""
    from elasticsearch_tpu_torch.parallel import kernels

    rec = {"qs": [], "args": None}
    seg_counts, two_level = (kernels.agg_segment_counts,
                             kernels.agg_two_level_counts)

    def note(mask, blob, ps, n_seg):
        q = int(mask.shape[0])
        rec["qs"].append(q)
        if rec["args"] is None or q > int(rec["args"][0].shape[0]):
            rec["args"] = (mask, blob, ps, n_seg)

    def spy1(mask, blob, *, p, n_segments):
        note(mask, blob, [p], n_segments)
        return seg_counts(mask, blob, p=p, n_segments=n_segments)

    def spy2(mask, blob, *, pd, pm, n_segments):
        note(mask, blob, [pd, pm], n_segments)
        return two_level(mask, blob, pd=pd, pm=pm, n_segments=n_segments)

    kernels.agg_segment_counts, kernels.agg_two_level_counts = spy1, spy2
    try:
        yield rec
    finally:
        kernels.agg_segment_counts, kernels.agg_two_level_counts = (
            seg_counts, two_level)


def timed_concurrent(fn, items, threads: int):
    """fn(item) for every item from `threads` threads released together;
    returns (results, per-item seconds, wall seconds)."""
    import threading

    barrier = threading.Barrier(threads)
    out, lat = [None] * len(items), [0.0] * len(items)

    def run(i):
        s = time.perf_counter()
        out[i] = fn(items[i])
        lat[i] = time.perf_counter() - s

    def worker(w):
        barrier.wait(timeout=60)
        for i in range(w, len(items), threads):
            run(i)

    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as ex:
        list(ex.map(worker, range(threads)))
    return out, lat, time.perf_counter() - t


def latency_summary(lat, wall: float) -> dict:
    a = np.asarray(lat) * 1e3
    return {"p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "max_ms": float(a.max()), "wall_s": wall,
            "qps": len(a) / wall}


def hold_kernel(label, wrapper, plain, args, kw) -> dict:
    """wrapper(*args, **kw) on the card against plain(*args, **kw),
    bitwise, once more on outputs filled with NaN / -1 first
    (kernels.poisoned); both timed by CUDA events. The plain version gets
    the keywords it takes (not the wrapper's host_checked)."""
    import inspect

    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    out = {}
    takes = inspect.signature(plain).parameters
    pkw = {key: v for key, v in kw.items() if key in takes}

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    ms = cuda_ms(lambda: out.__setitem__("k", tup(wrapper(*args, **kw))),
                 10)
    plain_ms = cuda_ms(lambda: out.__setitem__("p", tup(plain(*args,
                                                               **pkw))), 1)
    err = max(max_abs_err(a, b) for a, b in zip(out["k"], out["p"]))
    require(err == 0.0 and all(torch.equal(a, b)
                               for a, b in zip(out["k"], out["p"])),
            f"{label} kernel vs plain: max_abs_err {err}")
    with k.poisoned():
        again = tup(wrapper(*args, **kw))
    require(all(torch.equal(a, b) for a, b in zip(again, out["p"])),
            f"{label} on poisoned outputs differs from the plain version")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "poisoned_run": "bitwise",
            "out_bytes": sum(t.numel() * t.element_size() for t in out["p"])}


def path_bound(name, args, kw, out_bytes: int):
    """(bound ms, by) of K5, K9 or K4 at a serving-path launch, counted as
    check_k5, check_k9 and check_k4 count them on the main path: each
    input byte read once (K5: each distinct clause block), each output
    byte written once."""
    from elasticsearch_tpu_torch.parallel import kernels as k

    if name == "intersect_bitset":
        qs, qn = (np.asarray(a.cpu()) for a in args[:2])
        nsw, qc = kw["nsw"], int(qs.shape[0])
        hp = int(args[2].shape[0]) - 2
        distinct = (set(qs.ravel().tolist()) | set(qn.ravel().tolist())) \
            - {hp, hp + 1}
        block = k.SW_WORD_ROWS * 128 * 4
        nbytes = (len(distinct) * nsw * block + qs.nbytes + qn.nbytes
                  + out_bytes)
        return bound(nbytes, qc * nsw * block // 4 * 12, PEAK_F32)
    if name == "knn_int8_window_topc":
        qi8, qm, q8, meta, act, fmask = args
        nbytes = (q8.numel() + meta.numel() * 4 + qi8.numel()
                  + qm.numel() * 4 + act.numel() * 4 + out_bytes
                  + (0 if fmask is None else fmask.numel()))
        rows = q8.numel() // int(q8.shape[-1])
        return bound(nbytes, 2 * int(qi8.shape[0]) * int(q8.shape[-1])
                     * rows, PEAK_INT8)
    if name == "lane_topk":
        w = lane_work(args, kw)
        return bound(w["bytes"] + out_bytes, w["ops"], PEAK_F32)
    scores = args[0]                               # merge_topk
    q, lanes = (int(x) for x in scores.shape)
    return bound(scores.numel() * 8 + out_bytes, q * kw["k"] * lanes * 3,
                 PEAK_F32)


def lane_work(args, kw) -> dict:
    """What one K10 call must move and compute on these inputs: each
    distinct selected block row's docs and scores once, the row
    descriptors, and per distinct (row, doc) candidate its live byte (and
    addend, hp floats); two float operations a real lane. Also the real
    lanes' (row, doc) keys, which the library yardstick sorts."""
    import torch

    bd, bs, live, qb, qw, ts = args
    S, T, _ = (int(x) for x in bd.shape)
    Q, _, B = (int(x) for x in qb.shape)
    R = int(ts.shape[2]) - 1
    D = int(live.shape[1])
    nb = ts[:, :, R].long()
    used = torch.arange(B, device=bd.device)[None, None, :] < nb[:, :, None]
    q_i, s_i, p_i = torch.nonzero(used, as_tuple=True)
    blk = qb[q_i, s_i, p_i].long()
    rows_read = int(torch.unique(s_i * T + blk).numel())
    real = bs[s_i, blk] > 0
    keys = ((q_i * S + s_i)[:, None] * D
            + bd[s_i, blk].long())[real]
    n_real = int(keys.numel())
    n_docs = int(torch.unique(keys).numel())
    per_doc = 1 + 4 * sum(kw.get(x) is not None for x in ("addend", "hp"))
    desc = sum(t.numel() * t.element_size() for t in (qb, qw, ts)) + (
        0 if kw.get("qf") is None else kw["qf"].numel() * 4)
    return {"bytes": rows_read * 128 * 8 + desc + n_docs * per_doc,
            "ops": 2 * n_real, "rows_read": rows_read, "lanes": n_real,
            "docs": n_docs, "keys": keys}


def hold_k11(label, args, kw, parent=None) -> dict:
    """K11 at a recorded launch (its accumulator as it was before the
    call, its runs as recorded): the kernel twice and the plain version,
    each on a copy, bitwise (no atomics: run to run too), also under
    kernels.poisoned; timed by events, by CUDA graph and alone (the
    profiler's kernel events) on a scratch copy beside the plain version
    and index_add_ of the same lanes; where `parent` (weighted_parent) is
    given, also the parent's launch a run, bitwise, and both by CUDA
    graph in turns (this tree, parent, parent, this tree); its bound:
    the selected rows read once, the descriptors, each distinct target's
    accumulator read and write."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    acc0, rest = args[0], args[1:]

    def run(fn):
        a = acc0.clone()
        fn(a, *rest, **kw)
        return a

    got, again, want = (run(k.weighted_block_scatter),
                        run(k.weighted_block_scatter),
                        run(k.weighted_block_scatter_plain))
    with k.poisoned():
        pois = run(k.weighted_block_scatter)
    err = max_abs_err(got, want)
    require(err == 0.0 and all(torch.equal(x.view(torch.int32),
                                           want.view(torch.int32))
                               for x in (got, again, pois)),
            f"{label} kernel vs plain: max_abs_err {err}")
    ids, w, bd, bs = rest[:4]
    rows = kw.get("rows", rest[4] if len(rest) > 4 else None)
    runs = kw.get("runs")
    S, R, D = (int(x) for x in acc0.shape)
    T = int(bd.shape[1])
    idc = ids.long().clamp(0, T - 1)
    part = torch.arange(S, device=acc0.device)[:, None]
    docs = bd[part, idc].long()
    sc = bs[part, idc]
    r = torch.zeros_like(idc) if rows is None else rows.long()
    keep = (((ids >= 0) & (ids < T) & (r >= 0) & (r < R))[:, :, None]
            & (sc > 0) & (docs >= 0) & (docs < D))
    flat = ((part[:, :, None] * R + r[:, :, None]) * D + docs)[keep]
    vals = (w[:, :, None] * sc)[keep]
    scratch = acc0.clone()
    turns = None
    if parent is not None:
        offs = k.weighted_run_offsets(runs, int(ids.shape[1])).tolist()
        cut = [(ids[:, a:b].contiguous(), w[:, a:b].contiguous(),
                None if rows is None else rows[:, a:b].contiguous())
               for a, b in zip(offs[:-1], offs[1:]) if b > a]

        def old():
            for ci, cw, cr in cut:
                weighted_parent_call(parent, scratch, ci, cw, bd, bs,
                                     rows=cr)

        def new():
            k.weighted_block_scatter(scratch, *rest, **kw)

        scratch.copy_(acc0)
        old()
        require(torch.equal(scratch.view(torch.int32),
                            want.view(torch.int32)),
                f"{label}: the parent's launches differ from the plain "
                f"version")
        turns = [graph_ms(new, 200), graph_ms(old, 200), graph_ms(old, 200),
                 graph_ms(new, 200)]
    ms = cuda_ms(lambda: k.weighted_block_scatter(scratch, *rest, **kw), 10)
    plain_ms = cuda_ms(
        lambda: k.weighted_block_scatter_plain(scratch, *rest, **kw), 1)
    gms = (graph_ms(lambda: k.weighted_block_scatter(scratch, *rest, **kw),
                    200) if turns is None else (turns[0] + turns[3]) / 2)
    n_launch = int((np.diff(k.weighted_run_offsets(
        runs, int(ids.shape[1]))) > 0).sum())       # a launch a run
    alone, _ = kernel_alone(
        lambda: k.weighted_block_scatter(scratch, *rest, **kw),
        ["weighted_rows_kernel"], 5, {"weighted_rows_kernel": n_launch})
    lib = cuda_ms(lambda: scratch.view(-1).index_add_(0, flat, vals), 10)
    valid = (ids >= 0) & (ids < T)
    rows_read = int(torch.unique((part * T + idc)[valid]).numel())
    desc = sum(t.numel() * t.element_size() for t in (ids, w)) + (
        0 if rows is None else rows.numel() * 4) + (
        0 if runs is None else len(runs) * 4)
    lanes = int(flat.numel())
    targets = int(torch.unique(flat).numel())
    b_ms, b_by = bound(rows_read * 128 * 8 + desc + targets * 8, 2 * lanes,
                       PEAK_F32)
    return {"ms": ms, "plain_ms": plain_ms, "graph_ms": gms,
            "alone_ms": alone, "library_ms": lib, "max_abs_err": err,
            "bound_ms": b_ms,
            "bound_by": b_by, "bound_share": b_ms / gms, "lanes": lanes,
            "targets": targets, "rows_read": rows_read,
            "runs": 1 if runs is None else len(runs) - 1,
            "parent_graph_ms": None if turns is None
            else (turns[1] + turns[2]) / 2, "graph_turns": turns,
            "poisoned_run": "bitwise", "run_to_run": "bitwise"}


def weighted_parent(path):
    """The parent commit's K11 C entry (a launch per run: a thread a lane,
    no run table), built with nvcc from `path`, or None when `path` is not
    a file."""
    import ctypes

    from elasticsearch_tpu_torch.tools.k9_ab import parent_entry

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return parent_entry(path, "weighted_parent", "es_weighted_block_scatter",
                        [P] * 6 + [I, I, L, I, I, P])


def weighted_parent_call(fn, acc, ids, w, bd, bs, checked=False,
                         rows=None) -> None:
    """One launch of the parent's K11 (weighted_parent) on one run;
    `checked` first makes the parent wrapper's argument checks (its host
    cost on the path)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    if checked:
        dev = acc.device
        for t, nm, dt, nd in ((acc, "acc", torch.float32, 3),
                              (ids, "block_ids", torch.int32, 2),
                              (w, "weights", torch.float32, 2),
                              (bd, "block_docs", torch.int32, 3),
                              (bs, "block_scores", torch.float32, 3)):
            k._check(t, nm, dt, nd, dev)
        require(w.shape == ids.shape and bs.shape == bd.shape,
                "the parent's K11: shapes do not agree")
    S, R, D = (int(x) for x in acc.shape)
    rc = fn(ids.data_ptr(), w.data_ptr(),
            0 if rows is None else rows.data_ptr(), bd.data_ptr(),
            bs.data_ptr(), acc.data_ptr(), S, int(ids.shape[1]),
            int(bd.shape[1]), R, D,
            k._raw_stream(torch.cuda.current_device()))
    if rc != 0:
        raise RuntimeError(f"the parent's K11 failed: cudaError {rc}")


def weighted_ab(calls, parent=None) -> dict:
    """K11 per overflow query, on the calls `_exhaustive_topk` made (ids,
    weights, block arrays, runs): this tree's one call (a launch a run,
    from the C entry) against the parent's calls for the same query (its
    caller's: one a run and 8,192-block chunk, each a launch), each held
    bitwise against the plain version on a zero
    accumulator; timed in turns (this tree, parent, parent, this tree) by
    CUDA graph (the launches alone, summed in one graph) and by events
    around the whole step with the host copies of ids and weights (the
    parent's caller copied both per run, and checked its arguments per
    launch as the wrapper does), each one's host enqueue (its checks
    and launches, inputs on the card) and its kernels alone (the
    profiler's events, summed over the launches). `parent` is
    weighted_parent's entry or None (its fields then null). Each call is
    (ids, weights, block_docs, block_scores, runs as the caller gave them
    (None: one run), the accumulator's docs D)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    out = []
    for ids, w, bd, bs, runs, D in calls:
        dev = ids.device
        S, C = (int(x) for x in ids.shape)
        offs = k.weighted_run_offsets(runs, C)
        spans = list(zip(offs[:-1].tolist(), offs[1:].tolist()))
        n_launch = sum(b > a for a, b in spans)      # a launch a run
        acc0 = torch.zeros((S, 1, D), dtype=torch.float32, device=dev)
        want = acc0.clone()
        k.weighted_block_scatter_plain(want, ids, w, bd, bs, runs=runs)
        qb, qw = ids.cpu().numpy(), w.cpu().numpy()
        old_spans = [(c, min(c + PARENT_OVERFLOW_CHUNK, b)) for a, b in spans
                     for c in range(a, b, PARENT_OVERFLOW_CHUNK)]
        cut = [(ids[:, a:b].contiguous(), w[:, a:b].contiguous())
               for a, b in old_spans]

        def new_dev(acc):
            k.weighted_block_scatter(acc, ids, w, bd, bs, runs=runs)

        def new_host(acc):
            k.weighted_block_scatter(
                acc, torch.from_numpy(qb).to(dev),
                torch.from_numpy(qw).to(dev), bd, bs, runs=runs)

        def old_dev(acc, checked=False):
            for pi, pw in cut:
                weighted_parent_call(parent, acc, pi, pw, bd, bs, checked)

        def old_host(acc):
            for a, b in old_spans:
                weighted_parent_call(
                    parent, acc,
                    torch.from_numpy(np.ascontiguousarray(qb[:, a:b])).to(dev),
                    torch.from_numpy(np.ascontiguousarray(qw[:, a:b])).to(dev),
                    bd, bs, checked=True)

        fns = [new_dev, new_host] + ([old_dev, old_host] if parent else [])
        for fn in fns:
            a = acc0.clone()
            fn(a)
            require(torch.equal(a.view(torch.int32), want.view(torch.int32)),
                    f"K11 A/B: {fn.__name__} differs from the plain version "
                    f"({len(spans)} runs)")
        scratch = acc0.clone()
        row = {"runs": len(spans), "blocks": C, "partitions": S,
               "calls": 1, "kernel_launches": n_launch,
               "parent_launches": len(old_spans)}
        if parent:
            g = [graph_ms(lambda: new_dev(scratch), SCATTER_GRAPH_REPS),
                 graph_ms(lambda: old_dev(scratch), SCATTER_GRAPH_REPS),
                 graph_ms(lambda: old_dev(scratch), SCATTER_GRAPH_REPS),
                 graph_ms(lambda: new_dev(scratch), SCATTER_GRAPH_REPS)]
            e = [cuda_ms(lambda: new_host(scratch), 10),
                 cuda_ms(lambda: old_host(scratch), 10),
                 cuda_ms(lambda: old_host(scratch), 10),
                 cuda_ms(lambda: new_host(scratch), 10)]
            row["enqueue_ms"] = host_enqueue_ms(lambda: new_dev(scratch), 50)
            row["parent_enqueue_ms"] = host_enqueue_ms(
                lambda: old_dev(scratch, True), 50)
            row["alone_ms"] = kernel_alone(
                lambda: new_dev(scratch), ["weighted_rows_kernel"], 5,
                {"weighted_rows_kernel": n_launch})[0]
            row["parent_alone_ms"] = kernel_alone(
                lambda: old_dev(scratch), ["weighted_scatter_kernel"], 5,
                {"weighted_scatter_kernel": len(old_spans)})[0]
            row.update(graph_ms=(g[0] + g[3]) / 2,
                       parent_graph_ms=(g[1] + g[2]) / 2, graph_turns=g,
                       events_ms=(e[0] + e[3]) / 2,
                       parent_events_ms=(e[1] + e[2]) / 2, events_turns=e,
                       parent_bitwise=True)
        else:
            row.update(graph_ms=graph_ms(lambda: new_dev(scratch),
                                         SCATTER_GRAPH_REPS),
                       events_ms=cuda_ms(lambda: new_host(scratch), 10),
                       parent_graph_ms=None, parent_events_ms=None)
        out.append(row)
        del scratch, want, cut
    sums = {f: (sum(r[f] for r in out) if all(r[f] is not None
                                              for r in out) else None)
            for f in ("graph_ms", "parent_graph_ms", "events_ms",
                      "parent_events_ms", "calls", "kernel_launches",
                      "parent_launches")}
    return {"queries": out, "sums": sums}


def check_path_shapes(seen, dp, lane_parent=None,
                      weighted_parent=None, fused_parent=None) -> dict:
    """Every kernel of record_shapes at every launch shape the serving
    path gave it, on the recorded inputs, held bitwise against its plain
    version, also on poisoned outputs: K2 and K6 through sweep_ab, then
    timed by CUDA-graph replay beside their bounds (K2's column bytes over
    `dp` docs, or over its live rows' docs when dp is None); K3 beside its
    bound; K5, K9, K4 and K10 by hold_kernel, K10 also beside the parent
    commit's kernel where `lane_parent` (lane_parent) is given (lane_ab);
    K11 by hold_k11, beside the parent's launches where `weighted_parent`
    (weighted_parent) is given. Returns {kernel: {shape: numbers}}."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k
    from elasticsearch_tpu_torch.tools.k2_ab import bitset_work, sweep_work

    plains = {"sweep_rowmax": k.sweep_rowmax_plain,
              "sweep_rowmax_bitset": k.sweep_rowmax_bitset_plain,
              "intersect_bitset": k.intersect_bitset_counts_plain,
              "sparse_gather": k.sparse_gather_plain,
              "knn_int8_window_topc": k.knn_int8_window_topc_plain,
              "merge_topk": k.merge_topk_plain,
              "lane_topk": k.lane_topk_plain}
    wrappers = {"sweep_rowmax": k.sweep_rowmax,
                "sweep_rowmax_bitset": k.sweep_rowmax_bitset,
                "intersect_bitset": k.intersect_bitset_counts,
                "sparse_gather": k.sparse_gather,
                "knn_int8_window_topc": k.knn_int8_window_topc,
                "merge_topk": k.merge_topk,
                "lane_topk": k.lane_topk}
    out = {}
    for name, shapes in seen.items():
        out[name] = {}
        for key in sorted(shapes, key=str):
            n, args, kw = shapes[key]
            label = f"{name} at serving shape {key}"
            if name in ("sweep_rowmax", "sweep_rowmax_bitset"):
                row = sweep_ab(label, wrappers[name], plains[name], args,
                               kw["nsw"])
                wq_np = args[3].cpu().numpy()
                if name == "sweep_rowmax":
                    nbytes, ops, n_union, nnz = sweep_work(
                        wq_np, int(args[4].numel()) if dp is None else dp,
                        kw["nsw"])
                    row.update(union_slots=n_union, nonzero_weights=nnz)
                else:
                    nbytes, ops, work = bitset_work(wq_np, args[4],
                                                    kw["nsw"])
                    row.update(work)
                row["bound_ms"], row["bound_by"] = bound(nbytes, ops,
                                                         PEAK_INT8)
                row["graph_ms"] = graph_ms(
                    lambda: wrappers[name](*args, **kw), 200)
                row["bound_share"] = row["bound_ms"] / row["graph_ms"]
                row["poisoned_run"] = "bitwise"
            elif name == "weighted_block_scatter":
                row = hold_k11(label, args, kw, weighted_parent)
            elif name == "fused_intersect_bitset":
                row = {"held_by": "fused_sweep_rowmax_bitset (its counts "
                                  "and rows)"}
            elif name.startswith("fused_"):
                row = hold_fused(label, name, args, kw, fused_parent)
            else:
                row = hold_kernel(label, wrappers[name], plains[name], args,
                                  kw)
                if name == "sparse_gather":
                    b_ms, b_by, lanes = k3_bound(args[0], args[4], key)
                    row.update(bound_ms=b_ms, bound_by=b_by, lanes=lanes,
                               chunks=int(args[0].shape[0]))
                else:
                    row["bound_ms"], row["bound_by"] = path_bound(
                        name, args, kw, row["out_bytes"])
                    row["graph_ms"] = graph_ms(
                        lambda: wrappers[name](*args, **kw), 200)
                    row["bound_share"] = row["bound_ms"] / row["graph_ms"]
                if name == "lane_topk":
                    # the yardstick: torch.sort of the same lanes by
                    # (row, doc), the TPU program's first step
                    keys = lane_work(args, kw)["keys"]
                    row["library_ms"] = cuda_ms(lambda: torch.sort(keys), 10)
                    row["lanes"] = int(keys.numel())
                    del keys
                    row["tiles"] = k.lane_topk_plan(
                        int(args[0].shape[0]), int(args[3].shape[0]),
                        int(args[3].shape[2]), kw["k"])[1]
                    if lane_parent is not None:
                        want = plains[name](*args, **kw)
                        row.update(lane_ab(label, lane_parent, args, kw,
                                           want))
                        row["bound_share"] = row["bound_ms"] / row["graph_ms"]
                        del want
            row["launches"] = n
            out[name][str(key)] = row
            log(f"{label}: {n} launches, "
                + ", ".join(f"{f} {row[f]:.4f}" for f in
                            ("ms", "plain_ms", "graph_ms", "parent_graph_ms",
                             "library_ms", "bound_ms")
                            if row.get(f) is not None))
    return out


class KnnSources:
    """`_source` of the kNN service's rows, built on access (the tag only:
    the 768 floats of a row are not returned)."""

    def __init__(self, tags):
        self.tags = tags

    def __len__(self):
        return len(self.tags)

    def __getitem__(self, i):
        return {"tag": "red" if self.tags[int(i)] == 1 else "green"}


def knn_service(device):
    """The kNN service: two segments of SERVING_KNN_ROWS rows each, 768-d
    cosine vectors and the keyword `tag` from knn_data's generator (config
    4 cut from 2M rows to fit the clock; knn_phase keeps the full 2M)."""
    from elasticsearch_tpu_torch.index.segment import (
        KeywordColumn, Segment, VectorColumn, build_field_postings,
    )

    n = 2 * SERVING_KNN_ROWS
    vec, norms, qs, tags = knn_data(n)
    segs = []
    for off in (0, SERVING_KNN_ROWS):
        m = SERVING_KNN_ROWS
        tg = tags[off:off + m].astype(np.int32)
        fp = build_field_postings("tag", np.ones(m, np.int64),
                                  np.arange(m, dtype=np.int64), tg,
                                  ["green", "red"])
        kc = KeywordColumn(terms=["green", "red"],
                           term_to_ord={"green": 0, "red": 1}, ords=tg,
                           max_ords=tg, exists=np.ones(m, bool),
                           ord_start=np.arange(m + 1, dtype=np.int64),
                           all_ords=tg)
        col = VectorColumn(vec[off:off + m], norms[off:off + m],
                           np.ones(m, bool), KNN_DIMS, "cosine")
        segs.append((Segment(
            seg_id=0, doc_ids=[f"k{off + i}" for i in range(m)],
            sources=KnnSources(tg), postings={"tag": fp}, numeric={},
            keyword={"tag": kc}, vectors={"vec": col},
            seq_nos=np.arange(off, off + m, dtype=np.int64),
            device=device), np.ones(m, bool)))
    mapping = {"properties": {"tag": {"type": "keyword"},
                              "vec": {"type": "dense_vector",
                                      "dims": KNN_DIMS,
                                      "similarity": "cosine"}}}
    return serving_service(segs, mapping, "serving_knn", device), qs


# --------------------------------------------------------------------------
# the REST node: python -m elasticsearch_tpu_torch's Node over HTTP
# --------------------------------------------------------------------------

REST_TIMEOUT_S = 300       # one HTTP request's socket timeout
# the sections of the port's GET /_nodes/stats (the reference's, all of
# them: tests/test_torch_rest.py holds the key sets equal)
REST_STATS_SECTIONS = (
    "name", "breakers", "indexing_pressure", "indices", "jvm", "thread_pool",
    "tpu_agg", "tpu_ccr", "tpu_ccs", "tpu_coalescer", "tpu_compile",
    "tpu_coordinator", "tpu_durability", "tpu_hbm", "tpu_health",
    "tpu_integrity", "tpu_knn", "tpu_overload", "tpu_relocation",
    "tpu_scheduler", "tpu_search_latency", "tpu_settings", "tpu_tasks",
    "tpu_turbo")
# kernels the REST traffic must launch: the Turbo sweeps and cold-term
# gather (match, bool), the dense executor's block scatter, K8 and kNN.
# K1 and the bitset pack launch only when the traffic builds a column
# (a phrase body's adjacency column evicted since the serving phase):
# their launches are reported, not required. K7 (ES_TPU_BITSET=0) is off
# this path.
REST_KERNELS = ("sweep_rowmax", "sparse_gather", "intersect_bitset",
                "sweep_rowmax_bitset", "bm25_block_scatter",
                "block_presence", "agg_counts", "knn_int8_window_topc",
                "merge_topk")


def install_service(node, svc) -> None:
    """Put a built IndexService into a port Node: its indices and its
    cluster state, with every shard a started primary on this node, as
    Node.create_index leaves a new index."""
    import uuid

    from elasticsearch_tpu_torch.cluster.state import ShardRouting

    meta = svc.meta
    with node.indices._lock:
        node.indices._indices[meta.index] = svc
    routing = [ShardRouting(index=meta.index, shard_id=i,
                            node_id=node.node_id, primary=True,
                            state="STARTED",
                            allocation_id=uuid.uuid4().hex[:20])
               for i in range(meta.number_of_shards)]
    node.update_state(lambda st: st.with_index(meta, routing))


class RestClient:
    """urllib over 127.0.0.1 to one HttpServer. A 429 is retried after its
    Retry-After header, as a client would, and counted in `shed`; `call`
    fails the run on any other status but 2xx, `status` returns it."""

    def __init__(self, port: int):
        import threading

        self.base = f"http://127.0.0.1:{port}"
        self.shed = []
        self._lock = threading.Lock()

    def status(self, method, path, body=None, ndjson=None, headers=None,
               params=None):
        """(status, decoded body) of one request: JSON, or text for a
        text/plain answer."""
        import urllib.error
        import urllib.parse
        import urllib.request

        if ndjson is not None:
            data = ("\n".join(json.dumps(x) for x in ndjson) + "\n").encode()
            ctype = "application/x-ndjson"
        else:
            data = None if body is None else json.dumps(body).encode()
            ctype = "application/json"
        url = self.base + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        while True:
            req = urllib.request.Request(
                url, data=data, method=method,
                headers={"Content-Type": ctype, **(headers or {})})
            try:
                with urllib.request.urlopen(req,
                                            timeout=REST_TIMEOUT_S) as resp:
                    raw = resp.read()
                    text = resp.headers.get_content_type() == "text/plain"
                    return resp.status, (raw.decode() if text
                                         else json.loads(raw))
            except urllib.error.HTTPError as e:
                if e.code != 429:
                    payload = e.read()
                    try:
                        return e.code, json.loads(payload)
                    except ValueError:
                        return e.code, payload[:2000]
                wait = float(e.headers.get("Retry-After") or 1)
                with self._lock:
                    self.shed.append({"path": path, "retry_after_s": wait})
                time.sleep(wait)

    def call(self, method, path, body=None, ndjson=None, headers=None,
             params=None):
        code, out = self.status(method, path, body, ndjson, headers, params)
        if not 200 <= code < 300:
            raise AssertionError(f"REST {method} {path}: status {code}: "
                                 f"{str(out)[:2000]}")
        return out


def _no_took(r):
    """A response without its clock readings: `took`, an msearch item's
    `status`, and `profile`'s timings."""
    return {k: v for k, v in r.items() if k not in ("took", "status",
                                                     "profile")}


def hold_same(got, want, label: str) -> None:
    """A REST response against the in-process one for the same body: equal
    but for `took` (and an msearch item's `status`), scores bit for bit
    (JSON carries a float's repr, which reads back to the same double)."""
    require(isinstance(got, dict) and got.get("status", 200) == 200,
            f"{label}: {str(got)[:300]}")
    g, w = _no_took(got), _no_took(want)
    if g != w:
        gh = [(h["_id"], h.get("_score")) for h in g["hits"]["hits"]]
        wh = [(h["_id"], h.get("_score")) for h in w["hits"]["hits"]]
        raise AssertionError(f"{label}: differs from the serving phase: "
                             f"hits {gh[:5]} against {wh[:5]}, totals "
                             f"{g['hits'].get('total')} against "
                             f"{w['hits'].get('total')}")


def rest_phase(svc, kn_svc, served: dict, held: dict, dp: int,
               device="cuda") -> dict:
    """The REST node on the card: a port Node(device=...) with the serving
    phase's two services installed (install_service), register_handlers,
    an HttpServer on a free port with the node's thread pool, driven by
    urllib over 127.0.0.1 with the launch counts set to 0 just before and
    read just after, no plain version allowed:
      1. POST /_msearch of config-1 batch 0 (256 bodies), then of the 8
         DSL bodies; the in-process IndexService.msearch of batch 0 timed
         beside it;
      2. batch 0 as 256 POST /serving/_search from SERVING_THREADS threads
         at once, then one at a time;
      3. config 2's 256 bool bodies as one _msearch, and the 64 phrase
         bodies as another;
      4. the 25 DENSE_BODIES as _search;
      5. the AGG_THREADS agg bodies from as many threads, the request
         cache emptied first (the serving phase cached these bodies);
      6. the 8 kNN bodies as one _msearch on the kNN index;
      7. GET /, /_cluster/health, /_nodes, /_nodes/stats, /_cat/indices.
    Each search response must equal the serving phase's for the same body
    but for `took`, scores bitwise. A 429 is retried after its Retry-After
    and counted beside tpu_overload's shed counters; any other status
    fails. Every launch shape the path gives K2-K6, K9 or K4 that the
    serving phase did not hold is held here (check_path_shapes). Returns
    the report, its launches and new shapes included."""
    import copy

    import torch

    from elasticsearch_tpu_torch.common import hbm_ledger
    from elasticsearch_tpu_torch.device import device_name
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.parallel import kernels
    from elasticsearch_tpu_torch.rest import (
        HttpServer, RestController, register_handlers,
    )

    t_phase = time.time()
    node = Node(device=device)
    server = None
    rep = {}
    try:
        for s in (svc, kn_svc):
            install_service(node, s)
        rc = RestController()
        register_handlers(node, rc)
        server = HttpServer(rc, port=0, thread_pool=node.thread_pool)
        server.start()
        cl = RestClient(server.port)
        shed0 = dict(node.overload.stats()["shed"])
        groups, kbodies = served["groups"], served["knn_bodies"]
        with contextlib.ExitStack() as st:
            # the serving phase's knobs
            st.enter_context(env_set("ES_TPU_TURBO_HBM", str(TURBO_HBM)))
            st.enter_context(env_set("ES_TPU_TURBO_COLD_DF", str(COLD_DF)))
            st.enter_context(env_set("ES_TPU_SPARSE_WIDTHS", WIDE_LADDER))
            plain = st.enter_context(plain_calls())
            spies = st.enter_context(contextlib.ExitStack())
            shapes = spies.enter_context(record_shapes())
            kernels.reset_launches()
            t_main = time.time()

            # 1. msearch of config 1 and the DSL bodies
            head = {"index": svc.name}
            t = time.perf_counter()
            m0 = cl.call("POST", "/_msearch", ndjson=[
                x for b in groups[0] for x in (head, b)])["responses"]
            http_s = time.perf_counter() - t
            m_dsl = cl.call("POST", "/_msearch", ndjson=[
                x for b in groups[2] for x in (head, b)])["responses"]

            # 2. singles, concurrent then one at a time
            path = f"/{svc.name}/_search"
            singles, s_lat, s_wall = timed_concurrent(
                lambda b: cl.call("POST", path, b), groups[0],
                SERVING_THREADS)
            solo, o_lat, o_wall = timed_concurrent(
                lambda b: cl.call("POST", path, b), groups[0], 1)
            rep["singles"] = {
                "http_concurrent": latency_summary(s_lat, s_wall),
                "http_solo": latency_summary(o_lat, o_wall),
                "in_process_concurrent": served["singles"]["concurrent"],
                "in_process_solo": served["singles"]["solo"]}

            # 3. bool and phrase bodies, one _msearch each
            m_bool = cl.call("POST", "/_msearch", ndjson=[
                x for b in served["bools"] for x in (head, b)])["responses"]
            m_phrase = cl.call("POST", "/_msearch", ndjson=[
                x for b in served["phrases"]
                for x in (head, b)])["responses"]

            # 4. the dense bodies
            t = time.perf_counter()
            dense = {name: cl.call("POST", path, copy.deepcopy(b))
                     for name, b in DENSE_BODIES.items()}
            rep["dense_bodies_s"] = time.perf_counter() - t

            # 5. aggregations from AGG_THREADS threads, uncached
            with svc._req_cache_lock:
                svc._req_cache.clear()
            rc0 = dict(svc.request_cache_stats)
            aggs, a_lat, a_wall = timed_concurrent(
                lambda b: cl.call("POST", path, b), served["agg_bodies"],
                AGG_THREADS)
            rep["aggs"] = latency_summary(a_lat, a_wall)

            # 6. kNN bodies on the kNN index
            t = time.perf_counter()
            m_knn = cl.call("POST", "/_msearch", ndjson=[
                x for b in kbodies for x in ({"index": kn_svc.name}, b)]
            )["responses"]
            rep["knn_msearch_s"] = time.perf_counter() - t

            # 7. the node's own endpoints
            root = cl.call("GET", "/")
            health = cl.call("GET", "/_cluster/health")
            info = cl.call("GET", "/_nodes")
            stats = cl.call("GET", "/_nodes/stats")
            ledger = hbm_ledger.hbm_stats()
            cat = cl.call("GET", "/_cat/indices")
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            spies.close()
            rep["main_path_s"] = time.time() - t_main

            # the same batch in process, outside the counted window: the
            # launches above are the HTTP traffic's alone
            t = time.perf_counter()
            svc.msearch(groups[0])
            inproc_s = time.perf_counter() - t
            rep["msearch"] = {"http_batch_s": http_s,
                              "in_process_batch_s": inproc_s,
                              "rest_cost_s": http_s - inproc_s}
            log(f"rest msearch of 256: {http_s:.3f}s over HTTP, "
                f"{inproc_s:.3f}s in process")

            # ---- holds (launches already read) ----
            t = time.time()
            require(not any(plain.values()),
                    f"rest: plain versions ran on the card: "
                    f"{ {k: v for k, v in plain.items() if v} }")
            for i, (g, w) in enumerate(zip(m0, served["served"][0])):
                hold_same(g, w, f"rest msearch batch 0 {i}")
            for i, (g, w) in enumerate(zip(m_dsl, served["served"][2])):
                hold_same(g, w, f"rest msearch dsl {i}")
            for i, (g, w) in enumerate(zip(singles, served["served"][0])):
                hold_same(g, w, f"rest concurrent single {i}")
            for i, (g, w) in enumerate(zip(solo, served["served"][0])):
                hold_same(g, w, f"rest solo single {i}")
            for i, (g, w) in enumerate(zip(m_bool, served["bool_resps"])):
                hold_same(g, w, f"rest bool {i}")
            for i, (g, w) in enumerate(zip(m_phrase,
                                           served["phrase_resps"])):
                hold_same(g, w, f"rest phrase {i}")
            for name, r in dense.items():
                hold_same(r, served["dense"][name], f"rest dense {name}")
            require(svc.request_cache_stats["hits"] == rc0["hits"],
                    "rest: an agg body was answered from the request cache")
            for i, (g, w) in enumerate(zip(aggs, served["agg_resps"])):
                hold_same(g, w, f"rest agg {i}")
            for i, (g, w) in enumerate(zip(m_knn, served["knn_resps"])):
                hold_same(g, w, f"rest knn {i}")
            require(len(m0) == len(groups[0]) and len(m_knn) == len(kbodies)
                    and len(m_bool) == len(served["bools"]),
                    "rest: an _msearch lost responses")
            require(root.get("tagline") == "You Know, for Search",
                    f"rest: GET / answered {root}")
            require(health.get("status") in ("green", "yellow"),
                    f"rest: cluster health {health}")
            (ninfo,) = info["nodes"].values()
            card = device_name(node.device)
            require(ninfo["accelerators"] == [card],
                    f"rest: /_nodes lists {ninfo['accelerators']}, the card "
                    f"is {card}")
            (nstats,) = stats["nodes"].values()
            missing = [k for k in REST_STATS_SECTIONS if k not in nstats]
            require(not missing, f"rest: /_nodes/stats lacks {missing}")
            require(nstats["tpu_hbm"]["occupancy_bytes"]
                    == ledger["occupancy_bytes"],
                    f"rest: tpu_hbm occupancy "
                    f"{nstats['tpu_hbm']['occupancy_bytes']} against the "
                    f"ledger's {ledger['occupancy_bytes']}")
            require(svc.name in cat and kn_svc.name in cat,
                    f"rest: /_cat/indices lists {cat!r}")
            rep["hold_s"] = time.time() - t
        shed1 = node.overload.stats()["shed"]
        rep["shed"] = {"retried_429": len(cl.shed), "requests": cl.shed,
                       "tpu_overload": {k: shed1[k] - shed0[k]
                                        for k in shed1},
                       "level": node.overload.stats()["level"]}
        rep["launches"] = {k: v for k, v in launches.items() if v}
        rep["launches_by_shape"] = {
            name: {str(key): v[0] for key, v in sh.items()}
            for name, sh in shapes.items()}
        log(f"rest main path: {rep['main_path_s']:.1f}s; launches "
            f"{rep['launches']}; 429s retried {len(cl.shed)}; overload "
            f"shed {rep['shed']['tpu_overload']}; holds "
            f"{rep['hold_s']:.1f}s")
        log(f"rest singles: {rep['singles']}")
        for name in REST_KERNELS:
            require(launches.get(name, 0) > 0,
                    f"rest: {name} never launched: {launches}")
        for name, sh in shapes.items():
            require(sum(v[0] for v in sh.values()) == launches[name],
                    f"rest: {name}'s launches by shape do not add up to "
                    f"its count {launches[name]}")
        new = {name: {key: v for key, v in sh.items()
                      if str(key) not in held.get(name, {})}
               for name, sh in shapes.items()}
        rep["new_shapes"] = check_path_shapes(new, dp)
    finally:
        if server is not None:
            server.stop()
        node.close()
    rep["phase_s"] = time.time() - t_phase
    log(f"rest phase took {rep['phase_s']:.1f}s")
    return rep


# --------------------------------------------------------------------------
# the REST node, part 2: security, templates, async search, snapshots,
# lifecycle and the other admin routes
# --------------------------------------------------------------------------

ADMIN_PASSWORD = "chip-smoke-bootstrap"  # bootstrap.password of `elastic`
ADMIN_TEMPLATES = 32         # batch-0 queries through _search/template
ADMIN_ASYNC_BOOLS = 8        # config-2 bool bodies through _async_search
RANK_EVAL_QUERIES = 16       # batch-0 queries through _rank_eval
LIFECYCLE_DOCS = 10_000      # docs of the lifecycle index, through _bulk
# The BM25 index the phase snapshots. segment_payloads + put_segment_blob
# of a 600,000-doc dense segment took 18.2 s on a CPU host
# (snapshot_rehearsal; a 995 MB blob), a linear projection of 243 s for
# the serving index's 8,000,000 docs, over the phase's 90 s allowance: the
# phase snapshots a 1,000,000-doc segment drawn the same way instead.
SNAP_DOCS = 1_000_000
SNAP_ALLOWANCE_S = 90.0
# top-level keys of the reference's answers (rest/handlers.py)
ADMIN_KEYS = {
    "field_caps": {"indices", "fields"},
    "explain": {"_index", "_id", "matched", "explanation"},
    "termvectors": {"_index", "_id", "found", "term_vectors"},
    "rank_eval": {"metric_score", "details", "failures"},
    "slowlog": {"slowlog"},
    "trace": {"traces"},
}
ADMIN_CATS = ("count", "nodes", "segments", "aliases", "allocation",
              "templates", "thread_pool", "tasks")
# kernels the phase's HTTP traffic must launch: the sweeps and the
# cold-term gather (authenticated _msearch, templates, the restored
# index), K1 (the restored index builds its columns), K5 and K6 (bool
# bodies through _async_search), K8 (agg bodies through _async_search),
# K9 and K4 (kNN on the restored two-segment index)
ADMIN_KERNELS = ("build_columns", "sweep_rowmax", "sparse_gather",
                 "merge_topk", "intersect_bitset", "sweep_rowmax_bitset",
                 "agg_counts", "knn_int8_window_topc")


def basic_auth(user: str, password: str) -> dict:
    import base64

    return {"Authorization": "Basic " + base64.b64encode(
        f"{user}:{password}".encode()).decode()}


def snapshot_rehearsal(n: int) -> dict:
    """Times segment_payloads + put_segment_blob of an n-doc dense segment
    (the serving phase's, on the CPU) into a temporary fs repository, and
    projects the time to FULL_DOCS linearly:
    `python3 -c "import chip_smoke as cs; print(cs.snapshot_rehearsal(600000))"`
    (about a minute at 600,000 docs). The admin phase snapshots SNAP_DOCS
    when the projection exceeds SNAP_ALLOWANCE_S."""
    import shutil
    import tempfile

    from elasticsearch_tpu_torch.snapshots.repository import FsRepository

    fp, tokens, bounds = build_index(n, VOCAB)
    seg, _, _ = dense_segment(fp, tokens, bounds, n, "cpu")
    svc = serving_service([(seg, np.ones(n, bool))], DENSE_MAPPING,
                          "serving", "cpu")
    root = tempfile.mkdtemp()
    try:
        repo = FsRepository("rehearsal", root)
        t = time.perf_counter()
        payloads, _ = svc.shards[0].segment_payloads()
        payload_s = time.perf_counter() - t
        t = time.perf_counter()
        for blob, _ in payloads:
            repo.put_segment_blob(blob)
        put_s = time.perf_counter() - t
        nbytes = sum(len(b) for b, _ in payloads)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        svc.close()
    total = payload_s + put_s
    return {"docs": n, "segment_payloads_s": payload_s,
            "put_segment_blob_s": put_s, "blob_bytes": nbytes,
            "projected_full_s": total * FULL_DOCS / n,
            "fits": total * FULL_DOCS / n <= SNAP_ALLOWANCE_S}


def admin_phase(svc, kn_svc, served: dict, held: dict, rest: dict,
                device="cuda", snap_docs: int = SNAP_DOCS) -> dict:
    """The rest of the REST node on the card: a second port Node with
    xpack.security.enabled and a bootstrap password, the serving phase's
    two services installed, behind an HttpServer on 127.0.0.1, the launch
    counts set to 0 just before and read just after, no plain version
    allowed:
      1. as `elastic`: a role with `read` on the serving, kNN and restored
         indices, a user with it, an API key;
      2. batch 0's 256 bodies as one authenticated _msearch, as the user
         and with the API key; no credentials answer 401, a user whose
         role lacks the index 403; batch 0 as authenticated singles from
         SERVING_THREADS threads, then one at a time;
      3. _search/template and _render/template of the first
         ADMIN_TEMPLATES queries of batch 0 (a mustache {{q}} in a `match`
         body), each against the _search of the rendered body;
      4. _async_search of ADMIN_ASYNC_BOOLS config-2 bool bodies and the
         serving phase's agg bodies (request cache emptied) with
         wait_for_completion_timeout=0, _tasks while they run, polled to
         the end, then deleted;
      5. an fs repository in a temporary directory, _verify; a snapshot of
         the kNN index (two 131,072 x 768 segments) and of a SNAP_DOCS
         BM25 index drawn as the dense segment is (seeds 42 and 46; its
         answers to batch 0 taken first); a restore with a rename; batch 0
         and the 8 kNN bodies on the restored indices;
      6. a LIFECYCLE_DOCS index written through _bulk behind a write
         alias, _rollover on max_docs, _close / _open, _split to 2
         shards;
      7. _field_caps, _explain and _termvectors of batch 0's top hit on
         the restored BM25 index, _rank_eval of RANK_EVAL_QUERIES batch-0
         queries rated by their own top 10, _tpu/metrics, _tpu/slowlog,
         _tpu/trace, _nodes/hot_threads and the _cat tables of ADMIN_CATS.
    Holds: every search answer equal to the serving phase's for the same
    body (the restored BM25 index's to the original's) but for `took`,
    scores bitwise; the restored kNN ids and order equal, scores within
    knn_score_bound; templates equal to the rendered bodies' answers;
    _explain's value within DENSE_SCORE_ULPS of the hit's score and equal
    to the CPU's answer on the same segment; rank_eval precision 1.0;
    each admin route 200 with the reference's top-level keys; every
    kernel of ADMIN_KERNELS launched; every launch shape the serving and
    REST phases did not hold, and every shape of the restored and
    lifecycle indices (their engines are new), held by check_path_shapes.
    A 429 is retried and counted; any other unexpected status fails.
    Returns the report."""
    import copy
    import shutil
    import tempfile

    import torch

    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.engine import (
        EngineSearcher, SegmentView,
    )
    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.parallel import kernels
    from elasticsearch_tpu_torch.rest import (
        HttpServer, RestController, register_handlers,
    )
    from elasticsearch_tpu_torch.search import execute_search

    t_phase = time.time()
    rep = {"snapshot_docs": snap_docs}
    su = basic_auth("elastic", ADMIN_PASSWORD)
    node = Node(Settings({"xpack.security.enabled": "true",
                          "bootstrap.password": ADMIN_PASSWORD}),
                device=device)
    server = None
    repo_dir = tempfile.mkdtemp(prefix="es_tpu_snap_")
    groups = served["groups"]
    batch0 = groups[0]
    try:
        for s in (svc, kn_svc):
            install_service(node, s)
        # the snapshot's BM25 index, and its answers to batch 0 before the
        # snapshot (the restored index is held to them)
        t = time.time()
        sfp, stok, sbounds = build_index(snap_docs, VOCAB)
        sseg, _, _ = dense_segment(sfp, stok, sbounds, snap_docs, device)
        del sfp, stok, sbounds
        snap_svc = serving_service([(sseg, np.ones(snap_docs, bool))],
                                   DENSE_MAPPING, "snap_bm25", device)
        install_service(node, snap_svc)
        rep["snap_index_build_s"] = time.time() - t
        rc = RestController()
        register_handlers(node, rc)
        server = HttpServer(rc, port=0, thread_pool=node.thread_pool)
        server.start()
        cl = RestClient(server.port)
        shed0 = dict(node.overload.stats()["shed"])
        with contextlib.ExitStack() as st:
            st.enter_context(env_set("ES_TPU_TURBO_HBM", str(TURBO_HBM)))
            st.enter_context(env_set("ES_TPU_TURBO_COLD_DF", str(COLD_DF)))
            st.enter_context(env_set("ES_TPU_SPARSE_WIDTHS", WIDE_LADDER))
            plain = st.enter_context(plain_calls())
            windows = {}
            kernels.reset_launches()
            t_main = time.time()

            # ---- window "serving": the serving phase's indices ----
            with record_shapes() as windows["serving"]:
                # 1. security
                names = [svc.name, kn_svc.name, "restored_*"]
                cl.call("PUT", "/_security/role/searcher", {"indices": [
                    {"names": names, "privileges": ["read"]}]}, headers=su)
                cl.call("PUT", "/_security/role/outsider", {"indices": [
                    {"names": ["elsewhere-*"], "privileges": ["read"]}]},
                    headers=su)
                cl.call("PUT", "/_security/user/searcher", {
                    "password": "searcher-pw", "roles": ["searcher"]},
                    headers=su)
                cl.call("PUT", "/_security/user/outsider", {
                    "password": "outsider-pw", "roles": ["outsider"]},
                    headers=su)
                key = cl.call("POST", "/_security/api_key",
                              {"name": "chip-smoke"}, headers=su)
                user = basic_auth("searcher", "searcher-pw")
                api = {"Authorization": f"ApiKey {key['encoded']}"}
                who = cl.call("GET", "/_security/_authenticate",
                              headers=user)

                # 2. authenticated _msearch, refusals, singles
                head = {"index": svc.name}
                nd = [x for b in batch0 for x in (head, b)]
                t = time.perf_counter()
                m_user = cl.call("POST", "/_msearch", ndjson=nd,
                                 headers=user)["responses"]
                user_s = time.perf_counter() - t
                t = time.perf_counter()
                m_key = cl.call("POST", "/_msearch", ndjson=nd,
                                headers=api)["responses"]
                key_s = time.perf_counter() - t
                anon = cl.status("POST", "/_msearch", ndjson=nd)
                outsider = cl.status("POST", "/_msearch", ndjson=nd,
                                     headers=basic_auth("outsider",
                                                        "outsider-pw"))
                path = f"/{svc.name}/_search"
                singles, s_lat, s_wall = timed_concurrent(
                    lambda b: cl.call("POST", path, b, headers=user),
                    batch0, SERVING_THREADS)
                solo, o_lat, o_wall = timed_concurrent(
                    lambda b: cl.call("POST", path, b, headers=user),
                    batch0, 1)
                rep["auth"] = {
                    "msearch_user_s": user_s, "msearch_api_key_s": key_s,
                    "msearch_open_s": rest.get("msearch", {}).get(
                        "http_batch_s"),
                    "singles_concurrent": latency_summary(s_lat, s_wall),
                    "singles_solo": latency_summary(o_lat, o_wall),
                    "open_singles_concurrent": rest.get("singles", {}).get(
                        "http_concurrent"),
                    "open_singles_solo": rest.get("singles", {}).get(
                        "http_solo")}
                log(f"admin: authenticated _msearch of 256 {user_s:.3f}s "
                    f"(API key {key_s:.3f}s, open "
                    f"{rep['auth']['msearch_open_s']}s); singles "
                    f"{rep['auth']['singles_concurrent']}, solo "
                    f"{rep['auth']['singles_solo']}")

                # 3. templates
                tpl = {"query": {"match": {"body": "{{q}}"}}}
                tmpl, rendered, plain_search, words = [], [], [], []
                for q in batch0[:ADMIN_TEMPLATES]:
                    words.append(" ".join(
                        t["term"]["body"] if isinstance(t["term"]["body"], str)
                        else t["term"]["body"]["value"]
                        for t in q["query"]["bool"]["should"]))
                    params = {"source": tpl, "params": {"q": words[-1]}}
                    # (_render/template is a cluster action: `elastic`)
                    rendered.append(cl.call("POST", "/_render/template",
                                            params, headers=su))
                    tmpl.append(cl.call("POST",
                                        f"/{svc.name}/_search/template",
                                        params, headers=user))
                    plain_search.append(cl.call(
                        "POST", path, {"query": {"match": {
                            "body": words[-1]}}}, headers=user))

                # 4. async search of bool and agg bodies
                with svc._req_cache_lock:
                    svc._req_cache.clear()
                a_bodies = (served["bools"][:ADMIN_ASYNC_BOOLS]
                            + served["agg_bodies"])
                a_want = (served["bool_resps"][:ADMIN_ASYNC_BOOLS]
                          + served["agg_resps"])
                t = time.perf_counter()
                subs = [cl.call("POST", f"/{svc.name}/_async_search", b,
                                headers=su, params={
                                    "wait_for_completion_timeout": "0"})
                        for b in a_bodies]
                listing = cl.call("GET", "/_tasks", headers=su, params={
                    "actions": "indices:data/read/async_search",
                    "detailed": "true"})
                listed = [t for n in listing["nodes"].values()
                          for t in n["tasks"].values()]
                running_after = [
                    s["id"] for s in subs
                    if cl.call("GET", f"/_async_search/{s['id']}",
                               headers=su)["is_running"]]
                finals = []
                for s in subs:
                    while True:
                        r = cl.call("GET", f"/_async_search/{s['id']}",
                                    headers=su)
                        if not r["is_running"]:
                            break
                        time.sleep(0.01)
                    finals.append(r)
                async_s = time.perf_counter() - t
                deleted = [cl.call("DELETE", f"/_async_search/{s['id']}",
                                   headers=su) for s in subs]
                gone = [cl.status("GET", f"/_async_search/{s['id']}",
                                  headers=su)[0] for s in subs]
                rep["async"] = {"searches": len(subs), "s": async_s,
                                "running_at_submit": sum(
                                    s["is_running"] for s in subs),
                                "listed": len(listed),
                                "running_after_listing":
                                    len(running_after)}

                # 7 (on the serving indices). rank_eval, field caps
                rated = []
                for i, (b, r) in enumerate(zip(batch0[:RANK_EVAL_QUERIES],
                                               served["served"][0])):
                    rated.append({"id": f"q{i}", "request": b, "ratings": [
                        {"_index": h["_index"], "_id": h["_id"], "rating": 1}
                        for h in r["hits"]["hits"][:K]]})
                rank = cl.call("POST", f"/{svc.name}/_rank_eval", {
                    "requests": rated, "metric": {"precision": {"k": K}}},
                    headers=user)
                caps = cl.call("GET", f"/{svc.name}/_field_caps",
                               params={"fields": "*"}, headers=su)

            # ---- 5. snapshot and restore (the new engines: snap_bm25 and
            # the restored indices) ----
            with record_shapes() as windows["snapshot"]:
                t = time.perf_counter()
                snap_answers = cl.call("POST", "/_msearch", ndjson=[
                    x for b in batch0 for x in ({"index": "snap_bm25"}, b)],
                    headers=su)["responses"]
                rep["snap_original_batch_s"] = time.perf_counter() - t
                cl.call("PUT", "/_snapshot/chip", {"type": "fs", "settings": {
                    "location": repo_dir}}, headers=su)
                verify = cl.call("POST", "/_snapshot/chip/_verify", headers=su)
                t = time.perf_counter()
                snap = cl.call("PUT", "/_snapshot/chip/s1", {
                    "indices": f"snap_bm25,{kn_svc.name}"}, headers=su)
                rep["snapshot_s"] = time.perf_counter() - t
                rep["repository_bytes"] = sum(
                    os.path.getsize(os.path.join(d, f))
                    for d, _, fs in os.walk(repo_dir) for f in fs)
                t = time.perf_counter()
                restored = cl.call("POST", "/_snapshot/chip/s1/_restore", {
                    "rename_pattern": "^", "rename_replacement": "restored_"},
                    headers=su)
                rep["restore_s"] = time.perf_counter() - t
                log(f"admin: snapshot {rep['snapshot_s']:.1f}s, restore "
                    f"{rep['restore_s']:.1f}s, repository "
                    f"{rep['repository_bytes'] / 1e9:.2f} GB")
                k1 = kernels.LAUNCHES["build_columns"]
                t = time.perf_counter()
                r_bm25 = cl.call("POST", "/_msearch", ndjson=[
                    x for b in batch0
                    for x in ({"index": "restored_snap_bm25"}, b)],
                    headers=user)["responses"]
                rep["restored_first_batch_s"] = time.perf_counter() - t
                rep["restored_k1_launches"] = \
                    kernels.LAUNCHES["build_columns"] - k1
                t = time.perf_counter()
                r_knn = cl.call("POST", "/_msearch", ndjson=[
                    x for b in served["knn_bodies"]
                    for x in ({"index": f"restored_{kn_svc.name}"}, b)],
                    headers=user)["responses"]
                rep["restored_knn_s"] = time.perf_counter() - t
                # 7 (on the restored index). explain, termvectors
                top = r_bm25[0]["hits"]["hits"][0]
                explain = cl.call(
                    "POST", f"/restored_snap_bm25/_explain/{top['_id']}",
                    batch0[0], headers=user)
                tv = cl.call(
                    "POST", f"/restored_snap_bm25/_termvectors/{top['_id']}",
                    {"fields": ["body"], "term_statistics": True},
                    headers=su)

            # ---- 6. lifecycle ----
            with record_shapes() as windows["lifecycle"]:
                t = time.perf_counter()
                life = lifecycle_steps(cl, su)
                rep["lifecycle_s"] = time.perf_counter() - t

            # ---- 7. the node's observability and _cat routes ----
            metrics_text = cl.call("GET", "/_tpu/metrics", headers=su)
            slowlog = cl.call("GET", "/_tpu/slowlog", headers=su)
            trace = cl.call("GET", "/_tpu/trace", headers=su)
            hot = cl.call("GET", "/_nodes/hot_threads", headers=su)
            cats = {c: cl.call("GET", f"/_cat/{c}", headers=su)
                    for c in ADMIN_CATS}
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            rep["main_path_s"] = time.time() - t_main

            # ---- holds (launches already read) ----
            t = time.time()
            require(not any(plain.values()),
                    f"admin: plain versions ran on the card: "
                    f"{ {k: v for k, v in plain.items() if v} }")
            require(who.get("username") == "searcher",
                    f"admin: _authenticate answered {who}")
            require(anon[0] == 401 and outsider[0] == 403,
                    f"admin: no credentials {anon[0]}, an outsider "
                    f"{outsider[0]}, not 401 / 403")
            for label, ms in (("user", m_user), ("api key", m_key)):
                require(len(ms) == len(batch0),
                        f"admin: the {label}'s _msearch lost responses")
                for i, (g, w) in enumerate(zip(ms, served["served"][0])):
                    hold_same(g, w, f"admin {label} msearch {i}")
            for i, (g, w) in enumerate(zip(singles, served["served"][0])):
                hold_same(g, w, f"admin concurrent single {i}")
            for i, (g, w) in enumerate(zip(solo, served["served"][0])):
                hold_same(g, w, f"admin solo single {i}")
            for i, (r, g, w) in enumerate(zip(rendered, tmpl,
                                              plain_search)):
                require(r["template_output"] == {"query": {"match": {
                    "body": words[i]}}}, f"admin template {i}: rendered {r}")
                hold_same(g, w, f"admin search template {i}")
            for i, (s, r, w) in enumerate(zip(subs, finals, a_want)):
                require(r["is_partial"] is False and r["response"],
                        f"admin async {i}: {str(r)[:300]}")
                hold_same(r["response"], w, f"admin async {i}")
            require(all(s.get("id") for s in subs),
                    "admin: an _async_search answered without an id")
            # a search still running after the listing ran during it
            require(len(listed) >= len(running_after)
                    and all(x["description"] == f"async[{svc.name}]"
                            for x in listed),
                    f"admin: {len(running_after)} async searches ran past "
                    f"_tasks, which listed {len(listed)}: {listed[:2]}")
            require(all(d.get("acknowledged") for d in deleted)
                    and all(code == 404 for code in gone),
                    f"admin: async deletes {deleted[:2]}, then {gone[:4]}")
            require(verify.get("verified") is True,
                    f"admin: _verify answered {verify}")
            require(snap["snapshot"]["state"] == "SUCCESS",
                    f"admin: snapshot {snap}")
            require(sorted(restored["snapshot"]["indices"])
                    == sorted(["restored_snap_bm25",
                               f"restored_{kn_svc.name}"]),
                    f"admin: restore {restored}")
            require(rep["restored_k1_launches"] > 0,
                    "admin: the restored index built no column (K1)")
            for i, (g, w) in enumerate(zip(r_bm25, snap_answers)):
                g = dict(g, hits=dict(g["hits"], hits=[
                    dict(h, _index="snap_bm25") for h in g["hits"]["hits"]]))
                hold_same(g, w, f"admin restored bm25 {i}")
            kbound = knn_score_bound(np.stack([np.asarray(
                b["knn"][0]["query_vector"] if isinstance(b["knn"], list)
                else b["knn"]["query_vector"], np.float32)
                for b in served["knn_bodies"]]))
            for i, (g, w) in enumerate(zip(r_knn, served["knn_resps"])):
                gh, wh = g["hits"]["hits"], w["hits"]["hits"]
                require([h["_id"] for h in gh] == [h["_id"] for h in wh],
                        f"admin restored knn {i}: ids differ")
                d = max((abs(a["_score"] - b["_score"])
                         for a, b in zip(gh, wh)), default=0.0)
                require(d <= kbound[i], f"admin restored knn {i}: scores "
                                        f"differ by {d} > {kbound[i]}")
            # explain: the restored segment on the CPU, the same query
            # filtered to the doc
            rseg = node.indices.get("restored_snap_bm25").shards[0]\
                ._segments[0]
            cseg = copy.copy(rseg)
            cseg.torch_device = torch.device("cpu")
            cpu = EngineSearcher([SegmentView(
                segment=cseg, live=np.ones(snap_docs, bool), live_epoch=0)],
                cseg.torch_device)
            want = execute_search(cpu, MapperService(copy.deepcopy(
                DENSE_MAPPING)), {"query": {"bool": {
                    "must": [batch0[0]["query"]],
                    "filter": [{"ids": {"values": [top["_id"]]}}]}},
                    "size": 1}, "restored_snap_bm25")
            ev = explain["explanation"]["value"]
            require(explain["matched"] is True
                    and ev == want["hits"]["hits"][0]["_score"],
                    f"admin explain: {ev} against the CPU's "
                    f"{want['hits']['hits'][:1]}")
            ulps = abs(int(np.float32(ev).view(np.int32))
                       - int(np.float32(top["_score"]).view(np.int32)))
            require(ulps <= DENSE_SCORE_ULPS,
                    f"admin explain: {ev} is {ulps} ulps from the hit's "
                    f"{top['_score']}")
            rep["explain_ulps"] = int(ulps)
            require(tv.get("found") and "body" in tv["term_vectors"],
                    f"admin termvectors: {str(tv)[:300]}")
            require(rank["metric_score"] == 1.0,
                    f"admin rank_eval: precision {rank['metric_score']}")
            for label, got in (("field_caps", caps), ("explain", explain),
                               ("termvectors", tv), ("rank_eval", rank),
                               ("slowlog", slowlog), ("trace", trace)):
                require(ADMIN_KEYS[label] <= set(got),
                        f"admin {label}: keys {sorted(got)}")
            require("body" in caps["fields"],
                    f"admin field_caps: {sorted(caps['fields'])}")
            require(isinstance(metrics_text, str) and "es_tpu_" in
                    metrics_text, "admin: _tpu/metrics is not an exposition")
            require(isinstance(hot, str) and "thread [" in hot,
                    f"admin: hot_threads {str(hot)[:200]}")
            for c, text in cats.items():
                require(isinstance(text, str), f"admin _cat/{c}: {text}")
            require(cats["count"].strip() and svc.name in cats["segments"]
                    and "life" in cats["aliases"],
                    f"admin _cat: count {cats['count']!r}, aliases "
                    f"{cats['aliases']!r}")
            life_hold(life)
            rep["hold_s"] = time.time() - t
        shed1 = node.overload.stats()["shed"]
        rep["shed"] = {"retried_429": len(cl.shed),
                       "tpu_overload": {k: shed1[k] - shed0[k]
                                        for k in shed1}}
        rep["launches"] = {k: v for k, v in launches.items() if v}
        for name in ADMIN_KERNELS:
            require(launches.get(name, 0) > 0,
                    f"admin: {name} never launched: {launches}")
        for name in windows["serving"]:
            n = sum(v[0] for w in windows.values()
                    for v in w[name].values())
            require(n == launches[name],
                    f"admin: {name}'s launches by shape ({n}) do not add "
                    f"up to its count {launches[name]}")
        rep["launches_by_shape"] = {
            win: {name: {str(key): v[0] for key, v in sh.items()}
                  for name, sh in seen.items() if sh}
            for win, seen in windows.items()}
        # the serving indices' shapes the serving and REST phases did not
        # hold; every shape of the new indices' engines (snapshot,
        # restored, lifecycle)
        new = {name: {key: v for key, v in sh.items()
                      if str(key) not in held.get(name, {})}
               for name, sh in windows["serving"].items()}
        rep["new_shapes"] = {
            "serving": check_path_shapes(new, None),
            "snapshot": check_path_shapes(windows["snapshot"], None),
            "lifecycle": check_path_shapes(windows["lifecycle"], None)}
        log(f"admin main path: {rep['main_path_s']:.1f}s; launches "
            f"{rep['launches']}; 429s retried {len(cl.shed)}; holds "
            f"{rep['hold_s']:.1f}s")
    finally:
        if server is not None:
            server.stop()
        node.close()
        shutil.rmtree(repo_dir, ignore_errors=True)
    rep["phase_s"] = time.time() - t_phase
    log(f"admin phase took {rep['phase_s']:.1f}s")
    return rep


def lifecycle_docs(n: int):
    """n docs of 8-40 Zipf terms, drawn as build_index draws the corpus
    (seed 42, the same vocabulary)."""
    _, tokens, bounds = build_index(n, VOCAB)
    return [" ".join(f"t{t}" for t in tokens[bounds[i]:bounds[i + 1]])
            for i in range(n)]


def lifecycle_steps(cl, su) -> dict:
    """A LIFECYCLE_DOCS index behind the write alias `life`, written
    through _bulk: _rollover on max_docs, _close (a search answers 400),
    _open, _split to 2 shards, and one `match` search (dfs: the two
    shards score with the index's statistics) before and after the
    split."""
    out = {}
    cl.call("PUT", "/life-000001", {"aliases": {"life": {
        "is_write_index": True}}, "mappings": {"properties": {
            "body": {"type": "text"}}}}, headers=su)
    docs = lifecycle_docs(LIFECYCLE_DOCS)
    lines = []
    for i, text in enumerate(docs):
        lines += [{"index": {"_index": "life", "_id": f"l{i}"}},
                  {"body": text}]
    t = time.perf_counter()
    out["bulk"] = cl.call("POST", "/_bulk", ndjson=lines, headers=su,
                          params={"refresh": "true"})
    out["bulk_s"] = time.perf_counter() - t
    out["count"] = cl.call("GET", "/life-000001/_count", headers=su)
    out["rollover_unmet"] = cl.call("POST", "/life/_rollover", {
        "conditions": {"max_docs": LIFECYCLE_DOCS + 1}}, headers=su)
    out["rollover"] = cl.call("POST", "/life/_rollover", {
        "conditions": {"max_docs": LIFECYCLE_DOCS}}, headers=su)
    out["alias"] = cl.call("GET", "/_alias/life", headers=su)
    # two mid-vocabulary terms: every hit returned, none cut at a tie
    body = {"query": {"match": {"body": "t5000 t7000"}}, "size": 50}
    out["before"] = cl.call("POST", "/life-000001/_search", body,
                            headers=su,
                            params={"search_type": "dfs_query_then_fetch"})
    out["close"] = cl.call("POST", "/life-000001/_close", headers=su)
    out["closed_search"] = cl.status("POST", "/life-000001/_search", body,
                                     headers=su)[0]
    out["open"] = cl.call("POST", "/life-000001/_open", headers=su)
    out["split"] = cl.call("PUT", "/life-000001/_split/life-split", {
        "settings": {"index.number_of_shards": 2}}, headers=su)
    out["split_count"] = cl.call("GET", "/life-split/_count", headers=su)
    out["after"] = cl.call("POST", "/life-split/_search", body, headers=su,
                           params={"search_type": "dfs_query_then_fetch"})
    return out


def life_hold(life: dict) -> None:
    require(not life["bulk"]["errors"]
            and len(life["bulk"]["items"]) == LIFECYCLE_DOCS,
            "admin lifecycle: _bulk reported errors")
    require(life["count"]["count"] == LIFECYCLE_DOCS,
            f"admin lifecycle: count {life['count']}")
    require(life["rollover_unmet"]["rolled_over"] is False
            and life["rollover"]["rolled_over"] is True
            and life["rollover"]["new_index"] == "life-000002",
            f"admin lifecycle: rollover {life['rollover']}")
    require(life["alias"]["life-000002"]["aliases"]["life"]
            .get("is_write_index") is True,
            f"admin lifecycle: alias {life['alias']}")
    require(life["closed_search"] == 400,
            f"admin lifecycle: a closed index answered "
            f"{life['closed_search']}")
    require(life["split"].get("acknowledged") is True
            and life["split_count"]["count"] == LIFECYCLE_DOCS,
            f"admin lifecycle: split {life['split']}, "
            f"{life['split_count']}")
    # equal scores tie-break by shard: the hits are compared as sets
    before, after = ({h["_id"]: h["_score"] for h in life[k]["hits"]["hits"]}
                     for k in ("before", "after"))
    total = life["before"]["hits"]["total"]
    require(0 < total["value"] == len(before) < 50
            and life["after"]["hits"]["total"] == total,
            f"admin lifecycle: totals {total} and "
            f"{life['after']['hits']['total']}")
    require(sorted(before) == sorted(after)
            and all(abs(after[d] - v) <= SERVE_RTOL * abs(v) + SERVE_ATOL
                    for d, v in before.items()),
            f"admin lifecycle: the split answers {after}, the source "
            f"{before}")
    require(life["after"]["_shards"]["total"] == 2,
            f"admin lifecycle: {life['after']['_shards']}")


def serving_agg_bodies() -> list:
    """AGG_THREADS size-0 variants of the dense phase's agg body, distinct
    match terms: distinct request-cache keys."""
    import copy

    return [{"size": 0, "query": {"match": {"body": f"t6 t{60 + i}"}},
             "aggs": copy.deepcopy(AGG_BODY)} for i in range(AGG_THREADS)]


def serving_phase(seg, fp, tokens, bounds, n: int, batches, dsl, main_rows,
                  device="cuda") -> tuple:
    """The product's entry point on the card: a one-shard port IndexService
    over the dense phase's segment (all live: its rows are then the main
    phase's), with the main phase's knobs, and six kinds of traffic, every
    launch count set to 0 just before and read just after, no plain
    version allowed:
      1. IndexService.msearch of each config-1 batch of 256 as DSL bodies,
         and of the 8 DSL_BODIES: one _disjunctive_batch each;
      2. the first batch's 256 bodies as single IndexService.search calls
         from SERVING_THREADS threads at once (the scheduler's lanes), then
         one at a time with ES_TPU_COALESCE_US=0;
      3. config 2's 256 bool bodies and config 3's first 64 slop-0 phrase
         bodies through IndexService.search (_conjunctive -> search_bool);
      4. the 25 DENSE_BODIES through IndexService.search (the dense
         executor serves those the fast path declines);
      5. the agg body of DENSE_BODIES in AGG_THREADS variants (distinct
         match terms, size 0: distinct request-cache keys) from as many
         threads at once: K8 through the bulk tier;
      6. on a second service (knn_service), the 8 knn_bodies through
         try_msearch -> _knn_batch (K9, K4).
    Holds: the rows of 1 and 2 bitwise equal to the main phase's; every
    fast-path response equal to svc._search_dense within SERVE_RTOL; 5's
    responses equal to the same bodies served one at a time with the host
    aggregators (ES_TPU_AGG=0); 6's ids and order equal to the KnnEngine's
    dense route (ES_TPU_KNN_INT8=0), scores within KNN_GAMMA; no fault, no
    timeout; certificate fallbacks as in the main
    phase, the bool and phrase ones explained (hold_fallbacks); each
    kernel of the path launched, K8 at Q > 1. Then each kernel of
    record_shapes at every launch shape the path gave it, held against its
    plain version (check_path_shapes), and K8 at its largest Q, timed
    beside its bound. Returns (launches, {kernel: {shape: numbers}}, K8
    case, report, the bodies and answers cluster_phase serves again)."""
    import copy

    import torch

    from elasticsearch_tpu_torch.parallel import kernels
    from elasticsearch_tpu_torch.search import agg_device, serving
    from elasticsearch_tpu_torch.search.serving import extract_plan
    from elasticsearch_tpu_torch.threadpool.scheduler import scheduler_stats

    t_phase = time.time()
    sseg = copy.copy(seg)            # arrays shared, device cache its own
    svc = serving_service([(sseg, np.ones(n, bool))], DENSE_MAPPING,
                          "serving", device)
    kn_svc, kqs = knn_service(device)
    f0 = serving.serving_fault_stats()
    rep = {"docs": n, "threads": SERVING_THREADS,
           "agg_threads": AGG_THREADS,
           "knn_rows": 2 * SERVING_KNN_ROWS}
    with contextlib.ExitStack() as st:
        # the main phase's knobs: the snapshot builds the engine it measured
        st.enter_context(env_set("ES_TPU_TURBO_HBM", str(TURBO_HBM)))
        st.enter_context(env_set("ES_TPU_TURBO_COLD_DF", str(COLD_DF)))
        st.enter_context(env_set("ES_TPU_SPARSE_WIDTHS", WIDE_LADDER))
        snap = svc.serving.snapshot()
        eng = snap.engine("body")       # the first search would build it
        require(eng is not None and eng.kind == "turbo",
                "the serving snapshot did not build a Turbo engine")
        turbo = eng.turbos[0]
        log(f"serving: services and the snapshot's engine built in "
            f"{time.time() - t_phase:.1f}s")
        plain = st.enter_context(plain_calls())
        # the spies stop where the launch counts are read: the holds
        # below launch kernels too
        spies = st.enter_context(contextlib.ExitStack())
        shapes = spies.enter_context(record_shapes())
        k8 = spies.enter_context(record_k8())
        kernels.reset_launches()
        t_main = time.time()

        # 1. msearch: one _disjunctive_batch a batch
        groups = [[match_body(q) for q in b] for b in batches]
        groups.append(copy.deepcopy(DSL_BODIES))
        served, lat, fb_per = [], [], []
        for bodies in groups:
            fb0 = eng.stats["fallbacks"]
            t = time.perf_counter()
            served.append(svc.msearch(bodies))
            lat.append(time.perf_counter() - t)
            fb_per.append(eng.stats["fallbacks"] - fb0)
        require(svc.serving.snapshot() is snap, "the snapshot changed")
        t = time.perf_counter()
        again = svc.msearch(groups[0])
        warm_s = time.perf_counter() - t
        t = time.perf_counter()
        eng_rows = eng.search_many([[p.disj for p in
                                     (extract_plan(b, svc.mapper)
                                      for b in groups[0])]], k=K)[0]
        engine_s = time.perf_counter() - t
        rep["msearch"] = {"batch_latency_s": lat, "warm_batch_s": warm_s,
                          "engine_batch_s": engine_s,
                          "serving_overhead_s": warm_s - engine_s}
        log(f"serving msearch: batches {[round(x, 3) for x in lat]}s; "
            f"batch 0 again {warm_s:.3f}s against the engine's own "
            f"search_many {engine_s:.3f}s on the same batch")

        # 2. concurrent singles, then the same one at a time
        fb0 = eng.stats["fallbacks"]
        s0 = scheduler_stats()
        singles, s_lat, s_wall = timed_concurrent(svc.search, groups[0],
                                                  SERVING_THREADS)
        s1 = scheduler_stats()
        with env_set("ES_TPU_COALESCE_US", "0"):
            solo, o_lat, o_wall = timed_concurrent(svc.search, groups[0], 1)
        fb_singles = eng.stats["fallbacks"] - fb0
        rep["singles"] = {
            "concurrent": latency_summary(s_lat, s_wall),
            "solo": latency_summary(o_lat, o_wall),
            "scheduler": {
                "flushes": s1["sched_dispatches"] - s0["sched_dispatches"],
                "queries": s1["sched_queries"] - s0["sched_queries"],
                "direct": s1["direct_dispatches"] - s0["direct_dispatches"],
                "largest_batch": s1["largest_batch"],
                "bucket_counts": {
                    b: c - s0["bucket_counts"].get(b, 0)
                    for b, c in s1["bucket_counts"].items()},
                "tiers": s1["tiers"], "buckets": s1["buckets"]}}
        log(f"serving singles: {rep['singles']}")

        # 3. bool and phrase bodies, one at a time
        bools = [bool_body(sp) for sp in draw_bool(BOOL_BATCH, VOCAB)]
        phrases = [{"query": {"match_phrase": {"body": " ".join(p)}}}
                   for p in draw_phrases(PHRASES, fp, tokens,
                                         bounds)[:PHRASE_BATCH]]
        st0 = dict(eng.stats)
        with record_fallbacks(turbo, True) as fell:
            t = time.perf_counter()
            bool_resps = [svc.search(b) for b in bools]
            bool_s = time.perf_counter() - t
            t = time.perf_counter()
            phrase_resps = [svc.search(b) for b in phrases]
            phrase_s = time.perf_counter() - t
        d_bool = _delta(eng.stats, st0, BOOL_STATS)
        rep["bool"] = {"queries": len(bools), "s": bool_s,
                       "phrases": len(phrases), "phrase_s": phrase_s,
                       **d_bool}

        # 4. the dense phase's bodies through the public entry
        declined = [name for name, b in DENSE_BODIES.items()
                    if extract_plan(b, svc.mapper) is None]
        t = time.perf_counter()
        dense_resps = {name: svc.search(copy.deepcopy(b))
                       for name, b in DENSE_BODIES.items()}
        rep["dense_bodies"] = {"bodies": len(DENSE_BODIES),
                               "declined": len(declined),
                               "s": time.perf_counter() - t}

        # 5. concurrent aggregations through the bulk tier
        agg_bodies = serving_agg_bodies()
        rc0 = dict(svc.request_cache_stats)
        a0 = agg_device.agg_stats()
        agg_resps, a_lat, a_wall = timed_concurrent(svc.search, agg_bodies,
                                                    AGG_THREADS)
        a1 = agg_device.agg_stats()
        rep["aggs"] = {**latency_summary(a_lat, a_wall),
                       "k8_q": list(k8["qs"]),
                       "device_dispatches": a1["agg_device_dispatches"]
                       - a0["agg_device_dispatches"],
                       "host_fallbacks": a1["agg_host_fallbacks"]
                       - a0["agg_host_fallbacks"]}

        # 6. kNN bodies on the second service
        kbodies = [b for b, _ in knn_bodies(kqs)[0]]
        t = time.perf_counter()
        knn_resps = kn_svc.serving.try_msearch(kbodies, "query_then_fetch")
        rep["knn"] = {"bodies": len(kbodies),
                      "s": time.perf_counter() - t}
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        spies.close()
        main_s = time.time() - t_main
        sched1 = scheduler_stats()
        fault = serving.serving_fault_stats()

        # ---- holds (launches already read) ----
        t = time.time()
        require(not any(plain.values()),
                f"serving: plain versions ran on the card: "
                f"{ {k: v for k, v in plain.items() if v} }")
        for key in ("fastpath_device_fault", "fastpath_timed_out",
                    "fastpath_reject_error"):
            require(fault[key] == f0[key],
                    f"serving: {key} moved by {fault[key] - f0[key]}")
        for key in ("degraded", "sparse_fallbacks", "cold_queries",
                    "health_device_faults", "health_fallback_queries"):
            require(eng.stats[key] == 0, f"serving: {key} = {eng.stats[key]}")
        for bodies, rows, resps, label in zip(
                groups, main_rows, served, ["batch 0", "batch 1", "dsl"]):
            hold_rows(resps, (rows[0], rows[2]), f"msearch {label}")
        hold_rows(again, (main_rows[0][0], main_rows[0][2]),
                  "msearch batch 0 again")
        require(np.array_equal(eng_rows[0], main_rows[0][0])
                and np.array_equal(eng_rows[2], main_rows[0][2]),
                "the snapshot engine's rows differ from the main phase's")
        hold_rows(singles, (main_rows[0][0], main_rows[0][2]),
                  "concurrent singles")
        hold_rows(solo, (main_rows[0][0], main_rows[0][2]), "solo singles")
        n_match = sum(len(g) for g in groups)
        require(sum(fb_per) <= MAX_CERT_FALLBACK_SHARE * n_match,
                f"serving: {sum(fb_per)} certificate fallbacks in {n_match} "
                f"match queries")
        # the same 256 queries twice: the same certificates fail each time
        require(fb_singles == 2 * fb_per[0],
                f"serving: {fb_singles} fallbacks in the two single runs, "
                f"{fb_per[0]} in the batch of the same queries")
        rep["certificate_fallbacks"] = {"match_per_batch": fb_per,
                                        "singles": fb_singles,
                                        "bool_and_phrase":
                                        d_bool["fallbacks"]}
        rep["bool"]["fallbacks_explained"] = hold_fallbacks(
            fp, n, turbo.nsw, fell, d_bool["fallbacks"],
            len(bools) + len(phrases), "serving bool and phrase")
        dense = hold_dense(svc, zip(groups[0], served[0]), "msearch 0")
        hold_dense(svc, zip(groups[1], served[1]), "msearch 1")
        hold_dense(svc, zip(groups[2], served[2]), "msearch dsl")
        hold_dense(svc, zip(groups[0], singles), "singles", dense)
        hold_dense(svc, zip(bools, bool_resps), "bool")
        hold_dense(svc, zip(phrases, phrase_resps), "phrase")
        for name, r in dense_resps.items():
            want = svc._search_dense(copy.deepcopy(DENSE_BODIES[name]))
            if name in declined:
                # the same route: equal but for the profile's clock readings
                dense_same({**r, "profile": None}, {**want, "profile": None},
                           0, f"declined {name}")
            else:
                same_results(r, want, f"served {name}")
        require(svc.request_cache_stats["hits"] == rc0["hits"],
                "serving: an agg body was answered from the request cache")
        with env_set("ES_TPU_AGG", "0"):
            for i, (b, r) in enumerate(zip(agg_bodies, agg_resps)):
                want = svc._search_dense(copy.deepcopy(b))
                require(r["aggregations"] == want["aggregations"]
                        and r["hits"]["total"] == want["hits"]["total"],
                        f"serving agg {i}: differs from the host path")
        require(rep["aggs"]["host_fallbacks"] == 0,
                "serving: an agg collect fell back to the host")
        require(max(k8["qs"], default=0) > 1,
                f"serving: K8 never launched at Q > 1: {k8['qs']}")
        kbound = knn_score_bound(np.stack([np.asarray(
            b["knn"][0]["query_vector"] if isinstance(b["knn"], list)
            else b["knn"]["query_vector"], np.float32) for b in kbodies]))
        with env_set("ES_TPU_KNN_INT8", "0"):
            kdense = kn_svc.serving.try_msearch(kbodies, "query_then_fetch")
        for i, (b, r, w) in enumerate(zip(kbodies, knn_resps, kdense)):
            require(r is not None and w is not None,
                    f"serving knn {i}: the fast path declined")
            require([h["_id"] for h in r["hits"]["hits"]]
                    == [h["_id"] for h in w["hits"]["hits"]],
                    f"serving knn {i}: ids differ from the dense route")
            d = max((abs(a["_score"] - c["_score"]) for a, c in
                     zip(r["hits"]["hits"], w["hits"]["hits"])), default=0)
            require(d <= kbound[i], f"serving knn {i}: scores differ by {d} "
                                    f"> {kbound[i]}")
            same_results(r, kn_svc._search_dense(copy.deepcopy(b)),
                         f"serving knn {i}")
        hold_s = time.time() - t

    need = ("build_columns", "sweep_rowmax", "sparse_gather",
            "intersect_bitset", "sweep_rowmax_bitset", "pack_presence_bits",
            "bm25_block_scatter", "block_presence", "agg_counts",
            "knn_int8_window_topc", "merge_topk")
    for name in need:
        require(launches[name] > 0,
                f"serving: {name} never launched: {launches}")
    for name, sh in shapes.items():
        require(sum(v[0] for v in sh.values()) == launches[name],
                f"serving: {name}'s launches by shape "
                f"{ {str(key): v[0] for key, v in sh.items()} } do not "
                f"add up to its count {launches[name]}")
    by_shape = {name: {str(key): v[0] for key, v in sh.items()}
                for name, sh in shapes.items()}
    log(f"serving main path: {main_s:.1f}s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; by shape "
        f"{by_shape}; K8 Q {k8['qs']}; holds {hold_s:.1f}s")

    # ---- the new path shapes against their bounds ----
    held = check_path_shapes(shapes, turbo.Dp)
    mask, blob, ps, n_seg = k8["args"]
    k8_row = k8_case(mask, blob, ps, n_seg)
    log(f"K8 at the serving path's largest Q {int(mask.shape[0])}: events "
        f"{k8_row['ms']:.4f} ms, graph {k8_row['device_ms']:.4f} ms, bound "
        f"{k8_row['bound_ms']:.4f} ms ({k8_row['bound_by']})")
    rep.update({"main_path_s": main_s, "hold_s": hold_s,
                "launches": {k: v for k, v in launches.items() if v},
                "scheduler_after": sched1,
                "fault_stats": {k: fault[k] - f0[k] for k in fault}})
    # ---- the same traffic through the REST node ----
    answers = {
        "groups": groups, "served": served, "singles": rep["singles"],
        "bools": bools, "bool_resps": bool_resps, "phrases": phrases,
        "phrase_resps": phrase_resps, "dense": dense_resps,
        "agg_bodies": agg_bodies, "agg_resps": agg_resps,
        "knn_bodies": kbodies, "knn_resps": knn_resps}
    rep["rest"] = rest_phase(svc, kn_svc, answers, held, turbo.Dp,
                             device=device)
    # ---- the rest of the REST node: security, snapshots, lifecycle ----
    rep["admin"] = admin_phase(svc, kn_svc, answers, {
        name: {**held.get(name, {}), **rep["rest"]["new_shapes"].get(
            name, {})} for name in set(held) | set(rep["rest"]["new_shapes"])},
        rep["rest"], device=device)
    rep["phase_s"] = time.time() - t_phase
    # what the cluster phase serves again and holds its answers to
    again = {k: answers[k] for k in ("groups", "served", "bools",
                                     "bool_resps", "phrases",
                                     "phrase_resps")}
    del shapes, k8, mask, blob, snap, eng, turbo, svc, kn_svc, sseg, answers
    torch.cuda.empty_cache()
    return launches, held, k8_row, rep, again


# ---------------------------------------------------------------------------
# BlockMax over the Turbo budget, and the spmd programs (slice 18)
# ---------------------------------------------------------------------------

BM_TURBO_HBM = 1 << 20     # ES_TPU_TURBO_HBM for the BlockMax service: far
#                            below the 8M-doc shard's Turbo columns
BM_RTOL = BM_ATOL = 2e-5   # tests/test_blockmax.py's assert_topk_equal
BM_OVERFLOW_QUERIES = 8    # batch-0 queries through _exhaustive_topk
BM_FORCED_BOOL = 16        # heavy config-2 specs through one device group
BM_LONG_QUERIES = 4        # pasted-text `match` bodies, one msearch
BM_LONG_TERMS = 100        # their distinct terms: K10 rows of 100 runs, more
                           # than a pass stages (lane_topk.cu's RUN_CHUNK)
BM_LONG_BLOCKS = 8192      # their postings blocks at most (one K10 bucket)
BM_BIG_QUERIES = 2         # `match` bodies of mid terms whose blocks pass
#                            the largest bucket: the overflow path's traffic
BM_BOOL_THREADS = 8        # search_bool calls in flight (the host conjunction
#                            sorts release the GIL)
SPMD_PARTS = 4             # the spmd programs' cut: 4 stacked partitions
SPMD_DOCS = 250_000        # of 250,000 docs each (no Qc cap, spmd.py:559)
SPMD_QUERIES = 64
SPMD_CACHE = 256           # Bm25ColumnCache capacity


@contextlib.contextmanager
def turbo_budget(nbytes: int):
    """The snapshot's Turbo budget at `nbytes` while the block runs:
    ES_TPU_TURBO_HBM is read once, when search/serving.py is imported (as
    in the reference), into select_bm25_engine's default budget, so this
    sets the knob and that default, which a process started with
    ES_TPU_TURBO_HBM=nbytes would hold."""
    from elasticsearch_tpu_torch.search import serving

    kw = serving.select_bm25_engine.__kwdefaults__
    saved = kw["hbm_budget_bytes"]
    kw["hbm_budget_bytes"] = nbytes
    try:
        with env_set("ES_TPU_TURBO_HBM", str(nbytes)):
            yield
    finally:
        kw["hbm_budget_bytes"] = saved


def resp_rows(resps, k=K):
    """(scores [Q, k] f32, parts [Q, k] i32, ords [Q, k] i32) of one-shard
    search responses whose ids are `d<ord>`; empty slots (0, 0, 0)."""
    s = np.zeros((len(resps), k), np.float32)
    o = np.zeros((len(resps), k), np.int32)
    for qi, r in enumerate(resps):
        for j, h in enumerate(r["hits"]["hits"][:k]):
            s[qi, j] = np.float32(h["_score"])
            o[qi, j] = int(h["_id"][1:])
    return s, np.zeros_like(o), o


def hold_close(got, want, label) -> int:
    """tests/test_blockmax.py's assert_topk_equal over every row: the same
    filled slots, scores within BM_RTOL relative plus BM_ATOL, the same
    (partition, ord) in the same order wherever adjacent scores are
    separated beyond that, the same set across near-ties. Returns how many
    rows were held as sets."""
    (gs, gp, go), (ws, wp, wo) = got, want
    require(gs.shape == ws.shape and np.isfinite(gs).all(),
            f"{label}: result shapes or finiteness")
    sets = 0
    for qi in range(len(ws)):
        w = ws[qi].astype(np.float64)
        v = w > 0
        require(np.array_equal(gs[qi] > 0, v),
                f"{label} {qi}: filled slots differ")
        d = np.abs(gs[qi].astype(np.float64) - w)
        require((d <= BM_RTOL * np.abs(w) + BM_ATOL).all(),
                f"{label} {qi}: scores {gs[qi]} against {ws[qi]}")
        g_ids = list(zip(gp[qi][v], go[qi][v]))
        w_ids = list(zip(wp[qi][v], wo[qi][v]))
        x = w[v]
        if (np.abs(np.diff(x)) > BM_RTOL * np.abs(x[:-1]) + BM_ATOL).all():
            require(g_ids == w_ids, f"{label} {qi}: ids or order differ")
        else:
            sets += 1
            require(set(g_ids) == set(w_ids),
                    f"{label} {qi}: ids differ across a near-tie")
    return sets


def _unpack(packed):
    return (packed[..., 0, :].copy(), packed[..., 1, :].astype(np.int32),
            packed[..., 2, :].astype(np.int32))


def long_queries(fp, n: int):
    """BM_LONG_QUERIES pasted-text queries (seed 47): each BM_LONG_TERMS
    distinct terms drawn Zipf(1.07) from the vocabulary's ranks 1000 on,
    skipping terms the index lacks, hot terms (df > n / 8) and terms past
    BM_LONG_BLOCKS postings blocks in all, so that BlockMax scores each
    term in a K10 run of its own and no query overflows the largest
    bucket."""
    rng = np.random.default_rng(47)
    p = zipf_probs(VOCAB)[1000:]
    p /= p.sum()
    out = []
    for _ in range(16 * BM_LONG_QUERIES):
        terms, blocks = [], 0
        for x in rng.choice(np.arange(1000, VOCAB), 4 * BM_LONG_TERMS,
                            replace=False, p=p):
            o = fp.term_to_ord.get(f"t{x}", -1)
            if o < 0 or int(fp.doc_freq[o]) * 8 > n:
                continue
            if blocks + int(fp.block_count[o]) <= BM_LONG_BLOCKS:
                terms.append(f"t{x}")
                blocks += int(fp.block_count[o])
            if len(terms) == BM_LONG_TERMS:
                out.append(terms)
                break
        if len(out) == BM_LONG_QUERIES:
            break
    require(len(out) == BM_LONG_QUERIES,
            f"long queries: found {len(out)} of {BM_LONG_QUERIES} on {n} docs")
    return out


def big_queries(fp, n: int, max_bucket: int):
    """BM_BIG_QUERIES queries (seed 53) of non-hot terms (df at most
    n / HOT_DF_FRACTION) drawn from the 64 with the most postings blocks,
    each drawn until its blocks pass `max_bucket`, the largest dispatch
    bucket: BlockMax sends such a query to its overflow path
    (_exhaustive_topk) when culling keeps more than that many."""
    from elasticsearch_tpu_torch.parallel.blockmax import HOT_DF_FRACTION

    mid = sorted(((int(fp.block_count[o]), t)
                  for t, o in fp.term_to_ord.items()
                  if int(fp.doc_freq[o]) * HOT_DF_FRACTION <= n),
                 reverse=True)[:64]
    rng = np.random.default_rng(53)
    out = []
    for _ in range(BM_BIG_QUERIES):
        terms, blocks = [], 0
        for i in rng.permutation(len(mid)):
            terms.append(mid[i][1])
            blocks += mid[i][0]
            if blocks > max_bucket:
                break
        require(blocks > max_bucket,
                f"big queries: {blocks} blocks, not past {max_bucket}")
        out.append(terms)
    return out


def blockmax_phase(seg, fp, n: int, batches, main_rows, bool_answers,
                   device="cuda", lane_parent_src=None,
                   weighted_parent_src=None) -> tuple:
    """BlockMax on the main path's shard, where the reference selects it:
    a one-shard port IndexService over the dense phase's segment (all
    live) with ES_TPU_TURBO_HBM at BM_TURBO_HBM, far below the shard's
    Turbo columns, so that select_bm25_engine routes the field to
    BlockMaxBM25 (`exceeds_hbm_budget`). With every launch count set to 0
    just before and read just after, no plain version allowed:
      1. IndexService.msearch of both config-1 batches of 256 as DSL
         bodies (one _disjunctive_batch each; K10 in its lane and hybrid
         modes, K4), then of long_queries' pasted-text `match` bodies
         (K10 rows of BM_LONG_TERMS runs), then of big_queries' bodies
         (K11 launches counted: the overflow path where culling keeps
         their blocks past the largest bucket);
      2. config 2's 256 bool specs through BlockMaxBM25.search_bool, in
         BM_BOOL_THREADS concurrent calls (routes counted: _bool_host, the
         device program, _bool_exhaustive), and BM_FORCED_BOOL heavy specs
         as one device group (`_bool_group`; K10's bool mode: the host
         conjunction takes most specs at this size);
      3. the overflow path, `_exhaustive_topk`, on BM_OVERFLOW_QUERIES
         queries of batch 0, the long bodies and the big ones, every block
         kept (K11, one call a query: a run a non-hot term; each query's
         calls counted).
    Holds (hold_close, tests/test_blockmax.py's rule): every msearch top-10
    against the main path's host-exact rows, the long queries' against
    brute_topk; the bool answers against the
    bool phase's host-exact answers; the overflow rows against the msearch
    answers of the same queries and the main path's, the long and big
    bodies' against brute_topk and their msearch answers. Then the spmd
    programs (spmd_step) in a window of their own, and every K10, K11 and
    K4 launch shape of both windows held bitwise against its plain version
    (check_path_shapes), K10 also beside the parent commit's kernel
    where `lane_parent_src` names its source (lane_ab), K11 beside the
    parent's launches where `weighted_parent_src` names its source; the
    rows sum launches x graph ms over each window's shapes. K11's
    overflow calls are also timed query by query (weighted_ab). Returns
    (kernel rows, report)."""
    import copy

    import torch

    from elasticsearch_tpu_torch.common import hbm_ledger
    from elasticsearch_tpu_torch.parallel import blockmax as bm
    from elasticsearch_tpu_torch.parallel import kernels
    from elasticsearch_tpu_torch.search import serving

    t_phase = time.time()
    bool_specs, bool_hs, bool_ho = bool_answers
    rep = {"docs": n, "turbo_hbm": BM_TURBO_HBM}
    sseg = copy.copy(seg)            # arrays shared, device cache its own
    svc = serving_service([(sseg, np.ones(n, bool))], DENSE_MAPPING,
                          "blockmax", device)
    f0 = serving.serving_fault_stats()
    with contextlib.ExitStack() as st:
        st.enter_context(turbo_budget(BM_TURBO_HBM))
        st.enter_context(env_set("ES_TPU_TURBO_COLD_DF", str(COLD_DF)))
        t = time.time()
        eng = svc.serving.snapshot().engine("body")
        rep["engine_build_s"] = time.time() - t
        routing = hbm_ledger.last_routing()
        require(eng.kind == "blockmax"
                and routing["reason"] == "exceeds_hbm_budget",
                f"blockmax: the snapshot built {eng.kind} ({routing})")
        rep["routing"] = routing
        rep["hot_terms"] = len(eng._hot_slots)
        rep["device_bytes"] = eng.hbm_bytes()
        rep["block_rows"] = int(eng.stacked.block_docs.shape[1])
        rep["qc_dense_cap"] = eng._qc_dense_cap
        log(f"blockmax: engine built in {rep['engine_build_s']:.1f}s "
            f"({routing['reason']}; {rep['block_rows']} block rows, "
            f"{rep['hot_terms']} hot columns, {rep['device_bytes']} device "
            f"bytes)")
        routes = {"host": 0, "device": 0, "exhaustive": 0}
        lock = __import__("threading").Lock()

        def count(name, route, rows):
            real = getattr(eng, name)

            def call(*a):
                with lock:
                    routes[route] += rows(a)
                return real(*a)
            st.callback(setattr, eng, name, real)
            setattr(eng, name, call)

        count("_bool_host", "host", lambda a: 1)
        count("_bool_exhaustive", "exhaustive", lambda a: 1)
        count("_bool_group", "device", lambda a: len(a[0]))
        plain = st.enter_context(plain_calls())
        spies = st.enter_context(contextlib.ExitStack())
        shapes = spies.enter_context(record_shapes())
        kernels.reset_launches()
        t_main = time.time()
        # 1. msearch of both config-1 batches
        groups = [[match_body(q) for q in b] for b in batches]
        served, lat, timing = [], [], []
        for g in groups:
            t = time.perf_counter()
            served.append(svc.msearch(g))
            lat.append(time.perf_counter() - t)
            timing.append(dict(eng.last_timing))
        long_q = long_queries(fp, n)
        t = time.perf_counter()
        long_got = svc.msearch([{"query": {"match": {"body": " ".join(q)}}}
                                for q in long_q])
        long_s = time.perf_counter() - t
        long_timing = dict(eng.last_timing)
        big_q = big_queries(fp, n, bm._MAX_BUCKET)
        n0 = kernels.LAUNCHES["weighted_block_scatter"]
        t = time.perf_counter()
        big_got = svc.msearch([{"query": {"match": {"body": " ".join(q)}}}
                               for q in big_q])
        big_s = time.perf_counter() - t
        big_routed = kernels.LAUNCHES["weighted_block_scatter"] - n0
        # 2. config 2 through search_bool, then a forced device group
        t = time.perf_counter()
        step = -(-len(bool_specs) // BM_BOOL_THREADS)
        with ThreadPoolExecutor(max_workers=BM_BOOL_THREADS) as ex:
            parts = list(ex.map(
                lambda i: eng.search_bool(bool_specs[i:i + step], k=K),
                range(0, len(bool_specs), step)))
        bool_got = tuple(np.concatenate([p[i] for p in parts])
                         for i in range(3))
        bool_s = time.perf_counter() - t
        heavy_idx, heavy = [], []
        for i, spec in enumerate(bool_specs):
            rows, nm, _, tot = eng._bool_spec_rows(spec)
            if (i % 2 and tot <= bm._MAX_BUCKET
                    and nm == sum(1 for r in rows if r[2])):
                heavy_idx.append(i)
                heavy.append((rows, nm, tot))
            if len(heavy) == BM_FORCED_BOOL:
                break
        bucket = bm._group_shape(max(h[2] for h in heavy))[0]
        t = time.perf_counter()
        forced = _unpack(eng._bool_group([h[:2] for h in heavy], bucket, K))
        forced_s = time.perf_counter() - t
        # 3. the overflow path on batch-0 queries and the long bodies,
        # every block kept; K11's calls kept for weighted_ab
        ov_q = batches[0][:BM_OVERFLOW_QUERIES] + long_q + big_q
        ov_calls, ov_launches = [], []
        scatter = kernels.weighted_block_scatter

        def keep_call(acc, ids, w, bd, bs, rows=None, runs=None):
            ov_calls.append((ids, w, bd, bs, runs, int(acc.shape[2])))
            return scatter(acc, ids, w, bd, bs, rows=rows, runs=runs)

        kernels.weighted_block_scatter = keep_call
        ov_rows, ov_s = [], []
        try:
            for q in ov_q:
                n0 = kernels.LAUNCHES["weighted_block_scatter"]
                c0 = len(ov_calls)
                t = time.perf_counter()
                ov_rows.append(eng._exhaustive_topk(
                    [(x, 1.0) for x in dict.fromkeys(q)], {}, K))
                ov_s.append(time.perf_counter() - t)
                ov_launches.append(
                    (kernels.LAUNCHES["weighted_block_scatter"] - n0,
                     len(ov_calls) - c0))
        finally:
            kernels.weighted_block_scatter = scatter
        ov = _unpack(np.stack(ov_rows[:BM_OVERFLOW_QUERIES]))
        long_ov = _unpack(np.stack(ov_rows[BM_OVERFLOW_QUERIES:
                                           BM_OVERFLOW_QUERIES
                                           + BM_LONG_QUERIES]))
        big_ov = _unpack(np.stack(ov_rows[BM_OVERFLOW_QUERIES
                                          + BM_LONG_QUERIES:]))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        spies.close()
        main_s = time.time() - t_main
        fault = serving.serving_fault_stats()
        require(not any(plain.values()),
                f"blockmax: plain versions ran on the card: "
                f"{ {k: v for k, v in plain.items() if v} }")
    for key in ("fastpath_device_fault", "fastpath_timed_out",
                "fastpath_reject_error", "shard_fault_recoveries"):
        require(fault[key] == f0[key],
                f"blockmax: {key} moved by {fault[key] - f0[key]}")
    hs = eng.health.flat_stats()
    require(hs["health_device_faults"] == 0
            and hs["health_fallback_queries"] == 0,
            f"blockmax: health {hs}")
    for name in ("lane_topk", "weighted_block_scatter", "merge_topk"):
        require(launches[name] > 0, f"blockmax: {name} never launched")
    # one K11 launch a query that has a non-hot term (a run each)
    cold = [int(any((m := eng._terms.get(x)) is not None and m.hot_slot < 0
                    for x in q)) for q in ov_q]
    require(ov_launches == [(c, c) for c in cold],
            f"blockmax overflow: K11 launches per query {ov_launches}, "
            f"expected one a query with a non-hot term {cold}")
    long_runs = max(key[7][2] - 1 for key in shapes["lane_topk"])
    require(long_timing["n_queries"] == BM_LONG_QUERIES
            and long_runs >= BM_LONG_TERMS,
            f"blockmax: the long queries did not reach K10 "
            f"({long_timing}, {long_runs} runs at most)")
    log(f"blockmax main path: {main_s:.1f}s; msearch {lat} s; search_bool "
        f"{bool_s:.2f}s (routes {routes}); forced device group of "
        f"{len(heavy)} {forced_s:.3f}s; overflow {sum(ov_s):.3f}s; long queries "
        f"{long_s:.3f}s ({long_runs} runs); big queries {big_s:.3f}s "
        f"({big_routed} K11 calls); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    # ---- holds ----
    t = time.time()
    near = {}
    got = [resp_rows(r) for r in served]
    for bi, (g, rows) in enumerate(zip(got, main_rows)):
        near[f"batch {bi}"] = hold_close(g, rows, f"blockmax batch {bi}")
    want_bool = (bool_hs, np.zeros_like(bool_ho), bool_ho)
    near["bool"] = hold_close(bool_got, want_bool, "blockmax search_bool")
    near["forced"] = hold_close(
        forced, tuple(a[heavy_idx] for a in want_bool),
        "blockmax forced device group")
    ov_want = tuple(a[:BM_OVERFLOW_QUERIES] for a in got[0])
    near["overflow"] = hold_close(ov, ov_want, "blockmax overflow")
    long_want = [np.zeros((BM_LONG_QUERIES, K), np.float32),
                 np.zeros((BM_LONG_QUERIES, K), np.int32),
                 np.zeros((BM_LONG_QUERIES, K), np.int32)]
    for qi, q in enumerate(long_q):
        bs_, bo_ = brute_topk(fp, n, [(x, 1.0) for x in q])
        long_want[0][qi, :len(bs_)] = bs_
        long_want[2][qi, :len(bo_)] = bo_
    near["long"] = hold_close(resp_rows(long_got), tuple(long_want),
                              "blockmax long queries")
    hold_close(ov, tuple(a[:BM_OVERFLOW_QUERIES] for a in main_rows[0]),
               "blockmax overflow vs main")
    near["long_overflow"] = hold_close(long_ov, tuple(long_want),
                                       "blockmax long overflow")
    hold_close(long_ov, resp_rows(long_got), "blockmax long overflow vs "
               "msearch")
    big_want = [np.zeros((len(big_q), K), np.float32),
                np.zeros((len(big_q), K), np.int32),
                np.zeros((len(big_q), K), np.int32)]
    for qi, q in enumerate(big_q):
        bs_, bo_ = brute_topk(fp, n, [(x, 1.0) for x in q])
        big_want[0][qi, :len(bs_)] = bs_
        big_want[2][qi, :len(bo_)] = bo_
    near["big"] = hold_close(resp_rows(big_got), tuple(big_want),
                             "blockmax big queries")
    near["big_overflow"] = hold_close(big_ov, tuple(big_want),
                                      "blockmax big overflow")
    require(routes["host"] + routes["device"] + routes["exhaustive"]
            <= len(bool_specs) + len(heavy),
            f"blockmax: bool routes {routes}")
    rep.update({
        "msearch_s": lat, "msearch_queries": [len(g) for g in groups],
        "last_timing": timing,
        "long_queries": {"queries": len(long_q), "terms": BM_LONG_TERMS,
                         "k10_runs": long_runs, "s": long_s,
                         "last_timing": long_timing}, "bool_s": bool_s,
        "bool_routes": {**routes, "device": routes["device"] - len(heavy)},
        "forced_device_group": {"specs": len(heavy), "bucket": bucket,
                                "s": forced_s},
        "overflow": {"queries": len(ov_q), "s": ov_s,
                     "k11_calls": [x[0] for x in ov_launches],
                     "runs": [1 if c[4] is None else len(c[4]) - 1
                              for c in ov_calls],
                     "blocks": [int(c[0].shape[1]) for c in ov_calls]},
        "big_queries": {"queries": len(big_q),
                        "terms": [len(q) for q in big_q],
                        "blocks": [sum(int(fp.block_count[
                            fp.term_to_ord[x]]) for x in q) for q in big_q],
                        "msearch_s": big_s,
                        "k11_calls_in_msearch": big_routed},
        "held_as_sets": near, "hold_s": time.time() - t,
        "main_path_s": main_s,
        "launches": {k: v for k, v in launches.items() if v}})
    log(f"blockmax holds: every answer within {BM_RTOL} of the host-exact "
        f"rows ({near} rows held as sets) in {rep['hold_s']:.1f}s")
    # ---- K11 query by query, beside the parent's launches ----
    t = time.time()
    w_par = weighted_parent(weighted_parent_src) if device == "cuda" else None
    log(f"parent K11 for the A/B: "
        f"{weighted_parent_src if w_par else 'not given'}")
    k11_ab = weighted_ab(ov_calls, w_par)
    del ov_calls
    k11_ab["s"] = time.time() - t
    log(f"K11 per overflow query, summed over {len(k11_ab['queries'])}: "
        f"{k11_ab['sums']}")
    del svc, eng, sseg, served, got
    torch.cuda.empty_cache()
    # ---- the spmd programs, in a window of their own ----
    spmd_launches, spmd_shapes, rep["spmd"] = spmd_step(device)
    # ---- every launch shape of both windows against its plain version ----
    for name in ("lane_topk", "weighted_block_scatter", "merge_topk"):
        require(sum(v[0] for v in shapes[name].values()) == launches[name],
                f"blockmax: {name}'s launches by shape do not add up")
    t = time.time()
    lane_par = lane_parent(lane_parent_src) if device == "cuda" else None
    log(f"parent K10 for the A/B: "
        f"{lane_parent_src if lane_par else 'not given'}")
    held = check_path_shapes(
        {name: shapes[name] for name in
         ("lane_topk", "weighted_block_scatter", "merge_topk")}, None,
        lane_par, w_par)
    spmd_held = check_path_shapes(
        {name: spmd_shapes[name] for name in
         ("lane_topk", "weighted_block_scatter", "merge_topk")}, None,
        lane_par, w_par)
    del shapes, spmd_shapes
    torch.cuda.empty_cache()
    rep["shape_holds_s"] = time.time() - t
    rows = []
    for name, src, replaces, lib in (
            ("lane_topk", "lane_topk.cu",
             "elasticsearch_tpu/parallel/blockmax.py:911 (XLA program; "
             "also :931, :1014, spmd.py:335)",
             "torch.sort of the same lanes by (row, doc)"),
            ("weighted_block_scatter", "block_scatter.cu",
             "elasticsearch_tpu/parallel/blockmax.py:963 (XLA program; "
             "also spmd.py:650)",
             "index_add_ of the same lanes")):
        per = held[name]
        head = max(per.values(),                     # the most lanes
                   key=lambda r: r["launches"] * r.get("lanes", 1))
        rows.append({
            "name": name, "route": "cuda",
            "source": f"elasticsearch_tpu_torch/parallel/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in per.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library_note": lib,
            "graph_ms": head["graph_ms"], "head_shape": next(
                k for k, r in per.items() if r is head),
            "poisoned_run": "bitwise", "shapes": per,
            "spmd_launches": spmd_launches[name],
            "spmd_shapes": spmd_held[name]})
        if name == "weighted_block_scatter":
            rows[-1]["overflow_queries"] = k11_ab
            # and the multi-run launch of the most lanes beside it
            multi = max((r for r in per.values() if r["runs"] > 1),
                        key=lambda r: r["launches"] * r["lanes"])
            rows[-1]["multi_run_head"] = {
                "shape": next(k for k, r in per.items() if r is multi),
                **{f: multi.get(f) for f in (
                    "runs", "lanes", "ms", "graph_ms", "alone_ms",
                    "parent_graph_ms", "bound_ms", "bound_share",
                    "plain_ms", "library_ms")}}
        rows[-1].update(shape_sums(per, spmd_held[name]))
        rows[-1]["parent_graph_ms"] = head.get("parent_graph_ms")
        log(f"{name} launches x graph ms: {rows[-1]['sum_graph_ms']}"
            f" (parent {rows[-1]['parent_sum_graph_ms']}), spmd "
            f"{rows[-1]['spmd_sum_graph_ms']} (parent "
            f"{rows[-1]['spmd_parent_sum_graph_ms']})")
    rep["merge_topk_shapes"] = held["merge_topk"]
    rep["phase_s"] = time.time() - t_phase
    log(f"blockmax phase took {rep['phase_s']:.1f}s")
    return rows, rep


def shape_sums(per, spmd) -> dict:
    """A kernel's launches x graph ms summed over the BlockMax window's
    shapes (`per`) and the spmd window's, this tree's and, where timed,
    the parent's (None when not)."""
    def total(shapes, field):
        vals = [r["launches"] * r[field] for r in shapes.values()
                if r.get(field) is not None]
        return sum(vals) if len(vals) == len(shapes) else None

    return {"sum_graph_ms": total(per, "graph_ms"),
            "parent_sum_graph_ms": total(per, "parent_graph_ms"),
            "spmd_sum_graph_ms": total(spmd, "graph_ms"),
            "spmd_parent_sum_graph_ms": total(spmd, "parent_graph_ms")}


def brute_stacked(fps, doc_counts, terms, k=K):
    """An independent numpy ranking over stacked partitions with the
    index-global statistics (df summed over partitions, avgdl over every
    partition's docs): brute_topk's f32 term-at-a-time scoring per
    partition, then (score desc, partition asc, doc asc). Returns
    (scores [k], parts [k], ords [k])."""
    import math

    total = sum(doc_counts)
    n_field = sum(int(np.count_nonzero(fp.doc_len)) for fp in fps)
    avgdl = sum(fp.sum_doc_len for fp in fps) / n_field
    agg = {}
    for t in terms:
        t, w = (t, 1.0) if isinstance(t, str) else t
        agg[t] = agg.get(t, 0.0) + w
    cand = []
    for s, fp in enumerate(fps):
        dense = np.zeros(len(fp.doc_len), np.float32)
        for t, boost in agg.items():
            df = sum(int(f.doc_freq[f.term_to_ord[t]]) for f in fps
                     if t in f.term_to_ord)
            o = fp.term_to_ord.get(t, -1)
            if o < 0 or df == 0:
                continue
            idf = math.log(1.0 + (total - df + 0.5) / (df + 0.5))
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
        d = np.nonzero(dense > 0)[0]
        sel = np.lexsort((d, -dense[d]))[:k]
        cand += [(float(dense[x]), s, int(x)) for x in d[sel]]
    cand.sort(key=lambda c: (-c[0], c[1], c[2]))
    out = np.zeros((3, k), np.float64)
    for j, c in enumerate(cand[:k]):
        out[:, j] = c
    return out[0].astype(np.float32), out[1].astype(np.int32), \
        out[2].astype(np.int32)


def spmd_step(device="cuda") -> tuple:
    """The spmd programs, which no serving route reaches, at a stated cut
    (their query bucketing has no Qc cap, spmd.py:559-578): SPMD_PARTS
    stacked partitions of SPMD_DOCS docs drawn as build_index draws the
    shard (seeds 60 + partition), SPMD_QUERIES two-term queries of
    draw_batches, and as many 768-d rows drawn as knn_data draws config 4
    with its first SPMD_QUERIES (planted) queries. With the launch counts
    set to 0 just before and read just after: sharded_bm25_topk (K10 per
    (partition, query), K4), Bm25ColumnCache (capacity SPMD_CACHE; its
    columns built by K11, the batch twice: built, then cached) and
    sharded_knn_topk (bf16 products in f32, K4). Holds: the BM25 answers
    against brute_stacked under hold_close; the kNN answers against a
    numpy ranking of the same bf16-rounded rows and queries (f32 BLAS)
    within knn_score_bound, near-tie swaps counted (knn_agree). Returns
    (launches, recorded shapes, report)."""
    import torch

    from elasticsearch_tpu_torch.ops.knn import sqrt_rn
    from elasticsearch_tpu_torch.parallel import kernels
    from elasticsearch_tpu_torch.parallel.spmd import (
        Bm25ColumnCache, build_stacked_bm25, build_stacked_knn,
        prepare_query_blocks, sharded_bm25_topk, sharded_knn_topk,
    )

    t0 = time.time()
    n_rows = SPMD_PARTS * SPMD_DOCS
    # the kNN rows and each partition's postings, build_index(SPMD_DOCS,
    # VOCAB, 60 + s), drawn in threads at once (numpy releases the GIL;
    # each draw is seeded, so the same as one after another)
    rows = prefetch(knn_data, n_rows)
    with ThreadPoolExecutor(max_workers=SPMD_PARTS) as ex:
        parts = [_Seg(SPMD_DOCS, fp) for fp in ex.map(
            lambda s: build_index(SPMD_DOCS, VOCAB, 60 + s)[0],
            range(SPMD_PARTS))]
    vec, norms, qs, tags = rows.result()
    stacked = build_stacked_bm25(parts, "body", device=device,
                                 device_arrays=True)
    queries = draw_batches(1, SPMD_QUERIES, VOCAB)[0]
    qs = qs[:SPMD_QUERIES]
    ksegs = knn_segments(vec, norms, tags, SPMD_PARTS)
    kst = build_stacked_knn(ksegs, "vec", device=device)
    build_s = time.time() - t0
    rep = {"partitions": SPMD_PARTS, "docs": SPMD_DOCS,
           "queries": SPMD_QUERIES, "cache_capacity": SPMD_CACHE,
           "knn_rows": n_rows, "build_s": build_s}
    with contextlib.ExitStack() as st:
        plain = st.enter_context(plain_calls())
        spies = st.enter_context(contextlib.ExitStack())
        shapes = spies.enter_context(record_shapes())
        kernels.reset_launches()
        t = time.perf_counter()
        bm25 = sharded_bm25_topk(stacked, *prepare_query_blocks(stacked,
                                                                queries),
                                 k=K)
        rep["sharded_bm25_s"] = time.perf_counter() - t
        cache = Bm25ColumnCache(stacked, capacity=SPMD_CACHE)
        t = time.perf_counter()
        col = cache.search(queries, k=K)
        rep["column_cache_build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        col2 = cache.search(queries, k=K)
        rep["column_cache_s"] = time.perf_counter() - t
        t = time.perf_counter()
        knn = sharded_knn_topk(kst, qs, k=K)
        rep["sharded_knn_s"] = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        spies.close()
        require(not any(plain.values()),
                f"spmd: plain versions ran on the card: "
                f"{ {k: v for k, v in plain.items() if v} }")
    for name in ("lane_topk", "weighted_block_scatter", "merge_topk"):
        require(launches[name] > 0, f"spmd: {name} never launched")
    t = time.time()
    fps = [p.postings["body"] for p in parts]
    want = tuple(np.stack(x) for x in zip(*[
        brute_stacked(fps, [SPMD_DOCS] * SPMD_PARTS, q) for q in queries]))
    rep["held_as_sets"] = {
        "sharded_bm25": hold_close(bm25, want, "spmd sharded_bm25_topk"),
        "column_cache": hold_close(col, want, "spmd Bm25ColumnCache")}
    require(all(np.array_equal(a, b) for a, b in zip(col, col2)),
            "spmd: the cached batch differs from the building one")
    # the kNN ranking of the same bf16 values, f32 BLAS sums
    vn = vec / np.maximum(norms, np.float32(1e-20))[:, None]
    vb = torch.from_numpy(vn).to(torch.bfloat16).float().numpy()
    qb = torch.from_numpy(qs).to(torch.bfloat16).float().numpy()
    qn = np.maximum(sqrt_rn(torch.from_numpy(
        (qs * qs).sum(axis=1, dtype=np.float32))).numpy(), np.float32(1e-20))
    sc = ((1.0 + (qb @ vb.T) / qn[:, None]) / 2.0).astype(np.float32)
    del vn, vb
    step = -(-n_rows // SPMD_PARTS)
    ks, kp, ko = [], [], []
    for row in sc:
        sel = np.argpartition(-row, K)[:K]
        sel = sel[np.lexsort((sel, -row[sel]))]
        ks.append(row[sel])
        kp.append((sel // step).astype(np.int32))
        ko.append((sel % step).astype(np.int32))
    rep["knn"] = knn_agree(knn, (np.stack(ks), np.stack(kp), np.stack(ko)),
                           knn_score_bound(qs), "spmd sharded_knn_topk")
    rep["hold_s"] = time.time() - t
    rep["launches"] = {k: v for k, v in launches.items() if v}
    log(f"spmd: built in {build_s:.1f}s; sharded_bm25 "
        f"{rep['sharded_bm25_s']:.3f}s, column cache "
        f"{rep['column_cache_build_s']:.3f}s / {rep['column_cache_s']:.3f}s,"
        f" sharded_knn {rep['sharded_knn_s']:.3f}s; launches "
        f"{rep['launches']}; holds {rep['held_as_sets']}, kNN {rep['knn']}")
    del stacked, cache, kst, vec
    return launches, shapes, rep


# ---------------------------------------------------------------------------
# the cluster path: ClusterNode, the transport fan-out, replication
# ---------------------------------------------------------------------------

CLUSTER_NODES = ["n0", "n1", "n2"]   # n0 the master
CLUSTER_THREADS = 16         # coordinator searches in flight
CLUSTER_BOOLS = 128          # config-2 bool bodies of the serving phase
CLUSTER_PHRASES = 64         # its slop-0 phrase bodies (all it served)
CLUSTER_KERNELS = ("build_columns", "sweep_rowmax", "sparse_gather",
                   "intersect_bitset", "sweep_rowmax_bitset")
# the replicated index: two primaries, a replica each, written through the
# cluster's _bulk; CUT from the shard's 8M docs for Python ingest speed:
# every doc is analysed, indexed and refreshed into a segment once a copy,
# about 1.7 ms a doc on a CPU host (5,000 docs: 3.8 s of _bulk, 4.9 s of
# refresh), so 100,000 would take the phase past its clock alone
REPL_DOCS = 20_000
REPL_BULK = 5_000            # docs a _bulk call
REPL_COLD_DF = 512           # so 10,000-doc shards hold hot columns too
REPL_MATCH = 64              # batch-0 match bodies on the replicated index
REPL_BOOLS = 32              # and config-2 bool bodies
REPL_MAPPING = {"properties": {"body": {"type": "text"},
                               "n": {"type": "integer"}}}


def same_hits(got, want, label: str) -> None:
    """Two search responses: the same ids, f32 `_score`s bitwise and the
    same total."""
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    require([h["_id"] for h in gh] == [h["_id"] for h in wh],
            f"{label}: ids {[h['_id'] for h in gh]} against "
            f"{[h['_id'] for h in wh]}")
    require(np.array_equal(np.array([h["_score"] for h in gh], np.float32),
                           np.array([h["_score"] for h in wh], np.float32)),
            f"{label}: scores differ bitwise")
    require(got["hits"]["total"] == want["hits"]["total"],
            f"{label}: total {got['hits']['total']} against "
            f"{want['hits']['total']}")


def repl_docs(n: int):
    """The replicated index's docs: drawn as build_index draws the shard
    (seed 47), as _bulk index ops."""
    lens = np.random.default_rng(47).integers(8, 40, size=n)
    tokens = zipf_tokens(np.random.default_rng(48), int(lens.sum()), VOCAB)
    bnd = np.concatenate([[0], np.cumsum(lens)]).tolist()
    toks = tokens.tolist()
    return [{"op": "index", "id": f"r{i}",
             "source": {"n": i, "body": " ".join(
                 f"t{t}" for t in toks[bnd[i]:bnd[i + 1]])}}
            for i in range(n)]


def cluster_phase(seg, n: int, answers: dict, held: dict,
                  device="cuda") -> tuple:
    """The cluster path on the card (form_local_cluster(CLUSTER_NODES,
    device=...)): three in-process ClusterNodes over the local transport,
    sharing the one card.
      1. Serving index: one primary shard, no replica, whose engine holds
         the shard's segment, all live (installed as serving_service
         installs it, not through _bulk); batch 0's 256 `match` bodies,
         CLUSTER_BOOLS config-2 bool bodies and the serving phase's
         CLUSTER_PHRASES slop-0 phrase bodies from CLUSTER_THREADS threads
         through ClusterNode.search on a node that does not hold the
         shard: the coordinator's fan-out over the transport, the data
         node's shard query phase on its ServingContext (Turbo: K1 builds
         the new engine's columns, K2, K3, and K5 + K6 for the bools and
         phrases), the fetch phase, the reduce; launch counts set to 0
         just before and read just after, no plain version allowed. Each
         top-10 is held bitwise to the serving phase's answer for the same
         body (the same shard statistics; Turbo's scores come from the
         host), and every new launch shape against its plain version
         (check_path_shapes). The index is then deleted.
      2. Replicated index (REPL_DOCS, cut): two primaries with a replica
         each, written through ClusterNode.bulk; REPL_MATCH `match` and
         REPL_BOOLS bool bodies held to the dense route
         (ES_TPU_DISABLE_SHARD_SERVING=1): ids and totals equal, scores
         within SERVE_RTOL. Then a primary relocates with the warm handoff
         on (sparse_prewarms > 0, warm_failures 0, answers bitwise equal
         to before), a node holding a primary dies (a replica is
         promoted, answers equal again), and the master reallocates the
         lost copies (peer recovery of a replica from the new primary,
         answers equal again).
    Returns (launches, {kernel: {shape: numbers}}, report)."""
    import copy
    import gc

    import torch

    from elasticsearch_tpu_torch.cluster_node import form_local_cluster
    from elasticsearch_tpu_torch.common import integrity, relocation
    from elasticsearch_tpu_torch.parallel import kernels
    from elasticsearch_tpu_torch.search import serving

    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the earlier phases' engines are garbage in reference cycles until a
    # collection: without one about 15 GiB of them stayed on the card
    base = torch.cuda.memory_allocated()
    log(f"cluster: {base / 2**30:.2f} GiB on the card before the phase")
    relocation.reset_for_tests()
    nodes, store, channels = form_local_cluster(CLUSTER_NODES, device=device)
    by_name = {nd.node_name: nd for nd in nodes}
    master = nodes[0]
    rep = {"nodes": len(nodes), "threads": CLUSTER_THREADS,
           "device_bytes_before": base}
    try:
        with contextlib.ExitStack() as st:
            st.enter_context(env_set("ES_TPU_TURBO_HBM", str(TURBO_HBM)))
            st.enter_context(env_set("ES_TPU_TURBO_COLD_DF", str(COLD_DF)))
            st.enter_context(env_set("ES_TPU_SPARSE_WIDTHS", WIDE_LADDER))
            master.create_index("serving", {
                "settings": {"number_of_shards": 1,
                             "number_of_replicas": 0},
                "mappings": copy.deepcopy(DENSE_MAPPING)})
            holder = store.current().primary_of("serving", 0).node_id
            inst = by_name[holder].shard_service.get_shard("serving", 0)
            install_segments(inst.engine, [(copy.copy(seg),
                                            np.ones(n, bool))])
            coord = next(nd for nd in nodes if nd.node_name != holder)
            matches = answers["groups"][0]
            bodies = (matches + answers["bools"][:CLUSTER_BOOLS]
                      + answers["phrases"][:CLUSTER_PHRASES])
            want = (answers["served"][0]
                    + answers["bool_resps"][:CLUSTER_BOOLS]
                    + answers["phrase_resps"][:CLUSTER_PHRASES])
            f0 = serving.serving_fault_stats()
            plain = st.enter_context(plain_calls())
            spies = st.enter_context(contextlib.ExitStack())
            shapes = spies.enter_context(record_shapes())
            kernels.reset_launches()
            resps, lat, wall = timed_concurrent(
                lambda b: coord.search("serving", copy.deepcopy(b)),
                bodies, CLUSTER_THREADS)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            spies.close()
            fault = serving.serving_fault_stats()
            require(not any(plain.values()),
                    f"cluster: plain versions ran on the card: "
                    f"{ {k: v for k, v in plain.items() if v} }")
            for key in ("fastpath_device_fault", "fastpath_timed_out",
                        "fastpath_reject_error"):
                require(fault[key] == f0[key],
                        f"cluster: {key} moved by {fault[key] - f0[key]}")
            t = time.time()
            for i, (r, w) in enumerate(zip(resps, want)):
                require(r["_shards"] == {"total": 1, "successful": 1,
                                         "skipped": 0, "failed": 0},
                        f"cluster {i}: _shards {r['_shards']}")
                same_hits(r, w, f"cluster serving {i}")
            eng = inst._serving_ctx.snapshot().engine("body")
            require(eng.kind == "turbo"
                    and eng.device.type == torch.device(device).type,
                    f"cluster: the shard's engine is {eng.kind} on "
                    f"{eng.device}, not Turbo on {device}")
            for name in CLUSTER_KERNELS:
                require(launches.get(name, 0) > 0,
                        f"cluster: {name} never launched: {launches}")
            for name, sh in shapes.items():
                require(sum(v[0] for v in sh.values())
                        == launches.get(name, 0),
                        f"cluster: {name}'s launches by shape do not add "
                        f"up to its count {launches.get(name, 0)}")
            rep["serving_index"] = {
                "node_of_shard": holder, "coordinator": coord.node_name,
                "match": len(matches),
                "bools": len(answers["bools"][:CLUSTER_BOOLS]),
                "phrases": len(answers["phrases"][:CLUSTER_PHRASES]),
                **latency_summary(lat, wall),
                "hold_s": time.time() - t,
                "launches": {k: v for k, v in launches.items() if v},
                "launches_by_shape": {
                    name: {str(key): v[0] for key, v in sh.items()}
                    for name, sh in shapes.items()}}
            log(f"cluster serving index: {len(bodies)} searches in "
                f"{wall:.1f}s (p50 {rep['serving_index']['p50_ms']:.1f} "
                f"ms), every top-10 bitwise the serving phase's; launches "
                + ", ".join(f"{k} {launches.get(k, 0)}"
                            for k in CLUSTER_KERNELS))
        # the plain versions are allowed again: the holds call them
        new = {name: {key: v for key, v in sh.items()
                      if str(key) not in held.get(name, {})}
               for name, sh in shapes.items()}
        rep["new_shapes"] = check_path_shapes(new, eng.turbos[0].Dp)
        rep["peak_device_bytes_serving"] = torch.cuda.max_memory_allocated()
        del eng, inst, shapes, new, resps, want
        master.delete_index("serving")
        torch.cuda.empty_cache()

        # ---- 2. the replicated index, with the startup checksum scan on
        # (these nodes hold no data path: each scan finds no blob) ----
        c0 = integrity.integrity_stats()
        with env_set("ES_TPU_TURBO_COLD_DF", str(REPL_COLD_DF)), \
                env_set("ES_TPU_CHECK_ON_STARTUP", "1"):
            rep["replicated"] = replicated_steps(nodes, store, channels,
                                                 answers)
        c1 = integrity.integrity_stats()
        scans = {k: c1[k] - c0[k] for k in ("startup_checks",
                                             "startup_failures")}
        require(scans["startup_checks"] >= 2
                and scans["startup_failures"] == 0,
                f"repl: startup scans {scans}")
        rep["replicated"]["startup_scans"] = scans
        rep["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        for nd in nodes:
            nd.close()
    rep["startup_scan"] = startup_scan_step(device)
    rep["phase_s"] = time.time() - t_phase
    log(f"cluster phase took {rep['phase_s']:.1f}s; peak device memory "
        f"{rep['peak_device_bytes'] / 2**30:.2f} GiB (serving index "
        f"{rep['peak_device_bytes_serving'] / 2**30:.2f} GiB, "
        f"{base / 2**30:.2f} GiB held before the phase)")
    del nodes, by_name, master, store, channels
    torch.cuda.empty_cache()
    return launches, rep["new_shapes"], rep


SCAN_DOCS = 2_000   # docs of the startup-scan index (a data path each)


def startup_scan_step(device="cuda") -> dict:
    """Step 3 of cluster_phase: ES_TPU_CHECK_ON_STARTUP with blobs to read.
    Four CrashRestartCluster nodes on `device` (m0 the master), each with a
    data path under a temporary directory; an index of one shard and a
    replica, SCAN_DOCS of the replicated index's docs through _bulk. The
    replica's node dies; the spare node recovers a copy from the primary,
    and with the knob on the first blob its scan reads comes back flipped
    (an injected segment_read clause): the scan fails the copy before it
    reports started, the master recovers it again, and the second scan
    is clean. Every doc reads back; the copy is in sync."""
    import shutil
    import tempfile

    from elasticsearch_tpu_torch.common import faults, integrity
    from elasticsearch_tpu_torch.testing.chaos import CrashRestartCluster

    t = time.time()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scan_")
    try:
        cluster = CrashRestartCluster(["m0", "d0", "d1", "d2"], tmp,
                                      roles={"m0": ("master",)},
                                      device=device)
        cluster.master().create_index("scan", {
            "settings": {"number_of_shards": 1, "number_of_replicas": 1},
            "mappings": REPL_MAPPING})
        docs = repl_docs(SCAN_DOCS)
        r = cluster.master().bulk("scan", docs)
        require(not r["errors"], "scan: _bulk had errors")
        replica = next(c.node_id for c in cluster.store.current()
                       .shard_copies("scan", 0)
                       if not c.primary and c.state == "STARTED")
        c0 = integrity.integrity_stats()
        with env_set("ES_TPU_CHECK_ON_STARTUP", "1"), \
                faults.inject("segment_read:raise@1x1"):
            cluster.crash(replica)
        c1 = integrity.integrity_stats()
        d = {k: c1[k] - c0[k] for k in (
            "startup_checks", "startup_failures", "shards_failed_corrupt",
            "segments_verified", "bytes_verified")}
        require(d["startup_checks"] >= 2 and d["startup_failures"] == 1
                and d["shards_failed_corrupt"] >= 1
                and d["segments_verified"] >= 1,
                f"scan: startup scan counters {d}")
        inst = cluster.primary_instance("scan", docs[0]["id"])
        require(len(inst.tracker.in_sync_ids) == 2,
                f"scan: in-sync copies {inst.tracker.in_sync_ids}")
        for op in docs[::97]:
            require(cluster.read_doc("scan", op["id"]) == op["source"],
                    f"scan: doc {op['id']} reads back wrong")
        for nd in cluster.nodes:
            nd.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    d["s"] = time.time() - t
    log(f"cluster startup scan: a flipped blob failed the recovered copy "
        f"before it started, the second recovery scanned clean: {d}")
    return d


def replicated_steps(nodes, store, channels, answers) -> dict:
    """Step 2 of cluster_phase on the three nodes."""
    import copy

    from elasticsearch_tpu_torch.common import durability, relocation

    by_name = {nd.node_name: nd for nd in nodes}
    master = nodes[0]
    rep = {"docs": REPL_DOCS, "cut_from": FULL_DOCS}
    t = time.time()
    docs = repl_docs(REPL_DOCS)
    rep["draw_s"] = time.time() - t
    t = time.time()
    master.create_index("repl", {
        "settings": {"number_of_shards": 2, "number_of_replicas": 1},
        "mappings": copy.deepcopy(REPL_MAPPING)})
    for o in range(0, len(docs), REPL_BULK):
        r = nodes[1].bulk("repl", docs[o:o + REPL_BULK])
        require(not r["errors"], f"repl: _bulk at {o} had errors")
    nodes[1].refresh("repl")
    rep["bulk_s"] = time.time() - t
    require(master.health()["status"] == "green", "repl: not green")
    for sid in range(2):
        counts = {by_name[c.node_id].shard_service.get_shard(
            "repl", sid).engine.doc_count()
            for c in store.current().shard_copies("repl", sid)}
        require(len(counts) == 1, f"repl: copies of shard {sid} hold "
                                  f"{counts} docs")
    bodies = (answers["groups"][0][:REPL_MATCH]
              + answers["bools"][:REPL_BOOLS])
    for b in bodies:
        b["track_total_hits"] = True

    def serve(coord):
        return [coord.search("repl", copy.deepcopy(b)) for b in bodies]

    t = time.time()
    before = serve(nodes[2])
    rep["serve_s"] = time.time() - t
    with env_set("ES_TPU_DISABLE_SHARD_SERVING", "1"):
        dense = serve(nodes[2])
    for i, (r, w) in enumerate(zip(before, dense)):
        same_results(r, w, f"repl dense route {i}")
    log(f"cluster replicated index: {REPL_DOCS} docs through _bulk in "
        f"{rep['bulk_s']:.1f}s; {len(bodies)} bodies held to the dense "
        f"route")

    # relocate a primary with the warm handoff on: to a node that holds
    # no copy of its shard, a data node other than the master if it can
    t = time.time()
    moves = []
    for sid in range(2):
        here = {c.node_id for c in store.current().shard_copies("repl",
                                                                 sid)}
        src = store.current().primary_of("repl", sid).node_id
        moves += [(sid, src, to) for to in sorted(set(by_name) - here)]
    moves.sort(key=lambda m: m[2] == "n0")
    sid, src, to = moves[0]
    # the source copy serves first (a coordinator queries its own copy),
    # so its engine holds cold-term slices for the handoff to ship
    for i, (r, w) in enumerate(zip(serve(by_name[src]), before)):
        same_hits(r, w, f"repl from {src} {i}")
    master.cluster_reroute([{"move": {"index": "repl", "shard": sid,
                                      "from_node": src, "to_node": to}}])
    st = relocation.relocation_stats()
    require(store.current().primary_of("repl", sid).node_id == to,
            f"repl: shard {sid}'s primary did not move to {to}")
    require(st["moves"] == 1 and st["warm_handoffs"] == 1,
            f"repl: relocation counters {st}")
    require(st["sparse_prewarms"] > 0 and st["warm_failures"] == 0,
            f"repl: warm handoff {st}")
    moved = serve(nodes[2])
    for i, (r, w) in enumerate(zip(moved, before)):
        same_hits(r, w, f"repl after the move {i}")
    rep["relocation"] = {"shard": sid, "from": src, "to": to,
                         "s": time.time() - t, **st}
    log(f"cluster relocation of shard {sid} {src} -> {to}: {st}")

    # a data node holding a primary dies: its replica is promoted, then
    # the master reallocates the lost copies (peer recovery)
    t = time.time()
    d0 = durability.durability_stats()
    prim = {store.current().primary_of("repl", s).node_id for s in range(2)}
    victim = sorted(prim - {"n0"})[0]
    terms0 = store.current().indices["repl"].primary_terms
    channels.kill(victim)
    store.remove_applier(victim)
    master.report_node_left(victim)
    cur = store.current()
    require(victim not in cur.nodes, f"repl: {victim} still in the state")
    require(master.health()["status"] == "green",
            f"repl: not green after {victim} died: {master.health()}")
    promoted = [s for s in range(2)
                if cur.indices["repl"].primary_terms[s] > terms0[s]]
    require(promoted, "repl: no replica was promoted")
    d1 = durability.durability_stats()
    recoveries = d1["recoveries_started"] - d0["recoveries_started"]
    require(recoveries > 0, "repl: no peer recovery after the failover")
    coord = by_name["n0"]
    after = serve(coord)
    for i, (r, w) in enumerate(zip(after, before)):
        same_hits(r, w, f"repl after the failover {i}")
    rep["failover"] = {"victim": victim, "promoted_shards": promoted,
                       "peer_recoveries": recoveries,
                       "s": time.time() - t}
    log(f"cluster failover: {victim} down, shards {promoted} promoted, "
        f"{recoveries} peer recoveries, answers bitwise equal")
    return rep


# ---------------------------------------------------------------------------
# the fused S > 1 Turbo route (F1-F3, K4 on every merge)
# ---------------------------------------------------------------------------

FUSED_PARTS = 4        # the 8M-doc shard as four 2M-doc segments
FUSED_PHRASES = 64     # config 3's first slop-0 phrases


def split_postings(fp, lo: int, hi: int, keep=None, pos_keep=None,
                   term_of=None):
    """The FieldPostings of docs [lo, hi) of fp, renumbered from 0: what a
    segment holding those docs indexes (the same postings, tfs, positions
    and doc lengths, laid out as build_field_postings lays them; nothing
    is drawn again). keep, pos_keep, term_of: which of fp's postings and
    positions lie in the range, and the term of each posting, when the
    caller has them."""
    from elasticsearch_tpu_torch.index.segment import BLOCK, FieldPostings

    n_terms = len(fp.terms)
    n_pos = np.diff(fp.pos_start)
    if term_of is None:
        term_of = np.repeat(np.arange(n_terms, dtype=np.int32),
                            np.diff(fp.post_start))
    if keep is None:
        keep = (fp.post_doc >= lo) & (fp.post_doc < hi)
    if pos_keep is None:
        pos_keep = np.repeat(keep, n_pos)
    idx = np.flatnonzero(keep)
    term_ord = term_of[idx].astype(np.int64)
    within = idx - fp.post_start[term_ord]
    tf = fp.block_tfs[fp.block_start[term_ord] + within // BLOCK,
                      within % BLOCK]
    doc_ord = (fp.post_doc[idx] - lo).astype(np.int64)
    pos_data = fp.pos_data[pos_keep]
    doc_freq = np.bincount(term_ord, minlength=n_terms).astype(np.int32)
    n_blocks = (doc_freq + BLOCK - 1) // BLOCK
    block_start = np.zeros(n_terms, np.int32)
    if n_terms:
        block_start[0] = 1
        np.cumsum(n_blocks[:-1], out=block_start[1:])
        block_start[1:] += 1
    offsets = np.zeros(n_terms + 1, np.int64)
    np.cumsum(doc_freq, out=offsets[1:])
    w = np.arange(len(term_ord), dtype=np.int64) - offsets[term_ord]
    row = block_start[term_ord] + (w // BLOCK).astype(np.int32)
    lane = (w % BLOCK).astype(np.int32)
    total = 1 + int(n_blocks.sum())
    block_docs = np.zeros((total, BLOCK), np.int32)
    block_tfs = np.zeros((total, BLOCK), np.float32)
    block_docs[row, lane] = doc_ord
    block_tfs[row, lane] = tf
    block_max_tf = np.zeros(total, np.float32)
    if len(term_ord):
        starts = np.nonzero(lane == 0)[0]
        block_max_tf[row[starts]] = np.maximum.reduceat(tf, starts)
    total_tf = np.zeros(n_terms, np.int64)
    nz = doc_freq > 0
    if nz.any():
        total_tf[nz] = np.add.reduceat(tf.astype(np.int64),
                                       offsets[:-1][nz])
    pos_start = np.zeros(len(term_ord) + 1, np.int64)
    np.cumsum(n_pos[idx], out=pos_start[1:])
    doc_len = fp.doc_len[lo:hi].copy()
    return FieldPostings(
        field=fp.field, term_to_ord=fp.term_to_ord, terms=fp.terms,
        doc_freq=doc_freq, total_term_freq=total_tf,
        block_start=block_start, block_count=n_blocks.astype(np.int32),
        block_docs=block_docs, block_tfs=block_tfs,
        block_max_tf=block_max_tf, post_start=offsets,
        post_doc=doc_ord.astype(np.int32), pos_start=pos_start,
        pos_data=pos_data, doc_len=doc_len,
        sum_doc_len=float(doc_len.sum()))


def fused_segments(fp, n: int):
    """The shard cut by doc range into FUSED_PARTS segments: [(_Seg, first
    doc)]; the postings of each split in threads (numpy's fancy indexing
    releases the GIL)."""
    step = -(-n // FUSED_PARTS)
    term_of = np.repeat(np.arange(len(fp.terms), dtype=np.int32),
                        np.diff(fp.post_start))
    part = (fp.post_doc // step).astype(np.int8)     # each posting's cut
    pos_part = np.repeat(part, np.diff(fp.pos_start))
    cuts = [(lo, min(n, lo + step)) for lo in range(0, n, step)]
    with ThreadPoolExecutor(max_workers=len(cuts)) as ex:
        fps = list(ex.map(
            lambda i: split_postings(fp, cuts[i][0], cuts[i][1], part == i,
                                     pos_part == i, term_of),
            range(len(cuts))))
    return [(_Seg(hi - lo, f), lo) for (lo, hi), f in zip(cuts, fps)]


def _fused_parts(args, name):
    """(per-partition solo arguments, nsw) of a fused call's arguments,
    the weights cut to each partition's own slots."""
    from elasticsearch_tpu_torch.parallel import kernels as k

    if name == "fused_sweep_rowmax":
        qs, hi, lo, wq, live = args
        per = [(qs[i], hi[i], lo[i],
                k._part_wq(wq, i, int(hi[i].shape[1])), live[i])
               for i in range(len(hi))]
    elif name == "fused_sweep_rowmax_conj":
        qs, nreq, hi, lo, wq, wp, live = args
        per = [(qs[i], nreq[i], hi[i], lo[i],
                k._part_wq(wq, i, int(hi[i].shape[1])),
                wp[i, :, :int(hi[i].shape[1])].contiguous(), live[i])
               for i in range(len(hi))]
    else:
        qs, q_slots, q_neg, bits, hi, lo, wq, live = args
        per = [(qs[i], q_slots[i], q_neg[i], bits[i], hi[i], lo[i],
                k._part_wq(wq, i, int(hi[i].shape[1])), live[i])
               for i in range(len(hi))]
    return per


def fused_sequential(name, per, nsw, n_rows):
    """The S separate launches the fused one replaces, on the same inputs:
    each partition's K2 (F1), K7 (F2) or K5 with its counts and K6 (F3),
    and its row pick."""
    from elasticsearch_tpu_torch.parallel import kernels as k

    out = []
    for i, a in enumerate(per):
        if name == "fused_sweep_rowmax":
            rm, rr = k.sweep_rowmax(*a, nsw=nsw[i])
        elif name == "fused_sweep_rowmax_conj":
            rm, rr = k.sweep_rowmax_conj(*a, nsw=nsw[i])
        else:
            qs, sl, ng, bits, hi, lo, wq, live = a
            mask, _ = k.intersect_bitset_counts(sl, ng, bits, nsw=nsw[i])
            rm, rr = k.sweep_rowmax_bitset(qs, hi, lo, wq, mask, live,
                                           nsw=nsw[i])
        out.append(k.pick_rows(rm, rr, n_rows=n_rows))
    return out


def fused_work(name, per, nsw):
    """(bytes, int8 operations, {k5_bytes}) F1-F3 move and compute on these
    inputs, summed over the partitions as check_k2 / check_k7 / check_k5 +
    check_k6 count one sweep: each union slot's columns (F3: in chunks a
    query keeps), live, the weights, the outputs, and F3's distinct clause
    blocks, mask and counts."""
    from elasticsearch_tpu_torch.parallel import kernels as k
    from elasticsearch_tpu_torch.tools.k2_ab import bitset_work, sweep_work

    nbytes = ops = k5_bytes = 0
    for i, a in enumerate(per):
        if name == "fused_sweep_rowmax":
            b, o, _, _ = sweep_work(a[3].cpu().numpy(), int(a[4].numel()),
                                    nsw[i])
        elif name == "fused_sweep_rowmax_conj":
            b, o, _, _ = sweep_work(a[4].cpu().numpy(), int(a[6].numel()),
                                    nsw[i], a[5].cpu().numpy(),
                                    a[1].cpu().numpy())
        else:
            qs, sl, ng, bits, hi, lo, wq, live = a
            mask = k.intersect_bitset_plain(sl.to(bits.device),
                                            ng.to(bits.device), bits,
                                            nsw=nsw[i])
            b, o, _ = bitset_work(wq.cpu().numpy(), mask, nsw[i])
            hp = int(bits.shape[0]) - 2
            distinct = (set(sl.cpu().numpy().ravel().tolist())
                        | set(ng.cpu().numpy().ravel().tolist())) - {hp,
                                                                     hp + 1}
            block = k.SW_WORD_ROWS * 128 * 4
            qc = int(sl.shape[0])
            kb = (len(distinct) * nsw[i] * block + qc * nsw[i] * block
                  + sl.numel() * 4 + ng.numel() * 4 + qc * 4)
            k5_bytes += kb
            b += kb
            del mask
        nbytes += b
        ops += o
    return nbytes, ops, {"k5_bytes": k5_bytes}


FUSED_MODE_OF = {"fused_sweep_rowmax": "disj",
                 "fused_sweep_rowmax_conj": "conj",
                 "fused_sweep_rowmax_bitset": "bitset"}
FUSED_ROWS = {
    "fused_sweep_rowmax": ("elasticsearch_tpu/parallel/turbo.py:2099 "
                           "(_fused_sweep_disj; sweep_rowmax pallas_call "
                           "kernels.py:190)"),
    "fused_sweep_rowmax_conj": ("elasticsearch_tpu/parallel/turbo.py:2128 "
                                "(_fused_sweep_bool; sweep_rowmax_conj "
                                "pallas_call kernels.py:318)"),
    "fused_sweep_rowmax_bitset": ("elasticsearch_tpu/parallel/turbo.py:2148 "
                                  "(_fused_sweep_bitset; "
                                  "sweep_rowmax_bitset pallas_call "
                                  "kernels.py:581)"),
    "fused_intersect_bitset": ("elasticsearch_tpu/parallel/turbo.py:2148 "
                               "(_fused_sweep_bitset; intersect_bitset "
                               "pallas_call kernels.py:432)"),
}


def hold_fused(label, name, args, kw, parent=None) -> dict:
    """F1, F2 or F3 at one launch shape: bitwise against its plain version,
    also on poisoned outputs (hold_kernel), timed by events, by CUDA graph
    and alone (torch.profiler's kernel events), beside the sum of the S
    separate K2 / K7 / K5 + K6 launches (and row picks) on the same inputs
    (by events and by graph), torch._int_mm's four products per partition
    (the yardstick of K2's row) and the byte bound. F3's row carries its
    stacked K5 stage's time alone (`k5_alone_ms`) and bytes. F1-F3's
    sweep launch (fused_sweep_kernel from kernels.FUSED_MIN_QC /
    FUSED_MIN_QC_BITSET / FUSED_MIN_QC_CONJ queries, sweep_group_kernel
    below; the profiler's kernel name follows) is also timed alone by graph
    beside the parent commit's C entry of the same name on the same inputs,
    in turns, the parent's output held bitwise to this tree's (`parent`:
    {name: C entry}, fused_parents)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    row = hold_kernel(label, getattr(k, name), getattr(k, name + "_plain"),
                      args, kw)
    fn = getattr(k, name)
    if name == "fused_sweep_rowmax_bitset":
        # by graph: the launches and the pick, the slots on the card first
        # (the wrapper's upload of host slots is not capturable)
        gargs = (args[0], args[1].to(args[0].device),
                 args[2].to(args[0].device)) + tuple(args[3:])
        hpts = [int(h.shape[1]) for h in args[4]]
        row["graph_ms"] = graph_ms(lambda: k._fused_bitset_launches(
            *gargs, kw["nsw"], kw["n_rows"], hpts), 50)
        row["graph_note"] = "the two launches and the pick, slots on the card"
    else:
        row["graph_ms"] = graph_ms(lambda: fn(*args, **kw), 50)
    # below their kernels.FUSED_MIN_QC* F1-F3 run sweep_group_kernel
    cluster = k.fused_sweep_cluster(int(args[0].shape[1]),
                                    FUSED_MODE_OF[name])
    names = (("fused_sweep_kernel",) if cluster
             else ("sweep_group_kernel",)) + (
        ("fused_intersect_counts_kernel",)
        if name == "fused_sweep_rowmax_bitset" else ())
    row["kernel_ms"], row["kernel_events"] = kernel_alone(
        lambda: fn(*args, **kw), names, 5)
    if name == "fused_sweep_rowmax_bitset":
        row["k5_alone_ms"] = row["kernel_events"]["ms"][
            "fused_intersect_counts_kernel"]
    nsw, n_rows = list(kw["nsw"]), kw["n_rows"]
    per = _fused_parts(args, name)
    want = getattr(k, name + "_plain")(*args, **kw)
    seq = fused_sequential(name, per, nsw, n_rows)
    picked = want[0] if isinstance(want, tuple) else want
    require(all(torch.equal(a, b) for a, b in zip(seq, picked)),
            f"{label}: the S separate launches differ from the plain version")
    del want, seq
    row["sequential_ms"] = cuda_ms(
        lambda: fused_sequential(name, per, nsw, n_rows), 10)
    row["sequential_graph_ms"] = graph_ms(
        lambda: fused_sequential(name, per, nsw, n_rows), 50)
    nbytes, ops, extra = fused_work(name, per, nsw)
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, PEAK_INT8)
    row["bound_share"] = row["bound_ms"] / row["graph_ms"]
    row.update(extra)
    lib = 0.0
    for a in per:
        i_wq = 6 if name == "fused_sweep_rowmax_bitset" else (
            4 if name == "fused_sweep_rowmax_conj" else 3)
        i_hi = 4 if name == "fused_sweep_rowmax_bitset" else (
            2 if name == "fused_sweep_rowmax_conj" else 1)
        lib += int_mm_cols_ms(a[i_hi], a[i_hi + 1],
                              int(a[-1].numel()), a[i_wq])
    row["library_ms"] = lib
    row["library_note"] = ("torch._int_mm of the four score products over "
                           "all slots, summed over the partitions")
    row.update(fused_sweep_ab(name, args, kw, (parent or {}).get(name)))
    row["shape"] = {"partitions": len(per), "QC": int(args[0].shape[1]),
                    "nsw": nsw, "Hpt": [int(a[1 if name ==
                                              "fused_sweep_rowmax" else
                                              (2 if name ==
                                               "fused_sweep_rowmax_conj"
                                               else 4)].shape[1])
                                        for a in per]}
    return row


def fused_parents(src):
    """{F1-F3 wrapper name: C entry} of an earlier sweep_rowmax.cu with
    the same fused entries (the A/B parent), or None when src is not a
    file."""
    if not src or not os.path.isfile(src):
        return None
    from pathlib import Path

    from elasticsearch_tpu_torch.tools.k2_ab import fused_entry
    from elasticsearch_tpu_torch.tools.k9_ab import build

    lib = build("k2_parent", Path(src))
    return {"fused_sweep_rowmax": fused_entry(lib, "fused_disj"),
            "fused_sweep_rowmax_conj": fused_entry(lib, "fused_conj"),
            "fused_sweep_rowmax_bitset": fused_entry(lib, "fused_bitset")}


def fused_sweep_ab(name, args, kw, parent) -> dict:
    """F1's, F2's or F3's sweep launch alone on a fused call's inputs (F3:
    on the mask its K5 stage makes of them): this tree's C entry by CUDA
    graph, in turns with the parent's (`parent`, a C entry) where given,
    both writing preallocated outputs, the parent's held bitwise to this
    tree's; and the cluster kernel's work on these inputs (k2_ab's
    fused_stage_work: staged and direct queries, batches, union slots,
    stages copied and skipped; F2's dead stages), run or not at this
    QC."""
    import torch

    from elasticsearch_tpu_torch.parallel import cuda_build
    from elasticsearch_tpu_torch.parallel import kernels as k
    from elasticsearch_tpu_torch.tools.k2_ab import (fused_runner,
                                                     fused_stage_work,
                                                     launch_graph_ms)

    nreq = wp = mask = None
    if name == "fused_sweep_rowmax":
        qs, hi, lo, wq, live = args
        kind = "fused_disj"
    elif name == "fused_sweep_rowmax_conj":
        qs, nreq, hi, lo, wq, wp, live = args
        kind = "fused_conj"
    else:
        qs, sl, ng, bits, hi, lo, wq, live = args
        dev = qs.device
        mask, _ = k._fused_intersect(sl.to(dev), ng.to(dev), bits,
                                     list(kw["nsw"]))
        kind = "fused_bitset"
    f = {"qscale": qs, "wq": wq, "hi": list(hi), "lo": list(lo),
         "live": list(live), "nsw": list(kw["nsw"]), "mask": mask,
         "nreq": nreq, "wp": wp}
    run = fused_runner(f, kind)
    own = cuda_build.kernel(name)
    fns = {"current": own} if parent is None else {"parent": parent,
                                                   "current": own}
    outs = {x: run(fn) for x, fn in fns.items()}
    order = list(fns) + list(fns)[::-1]
    times = {x: [] for x in fns}
    for x in order:
        times[x].append(launch_graph_ms(
            lambda: run(fns[x], outs=outs[x]), 50))
    torch.cuda.synchronize()
    row = {"sweep_graph_ms": times["current"],
           "stage_work": fused_stage_work(
               qs, wq, [int(h.shape[1]) for h in hi], list(kw["nsw"]), mask,
               force=True,
               conj=(None if nreq is None
                     else (nreq, wp, list(hi), list(lo), list(live))))}
    if parent is not None:
        m, r = run(parent, poison=True)
        cm, cr = run(own, poison=True)
        require(torch.equal(m, cm) and torch.equal(r, cr),
                f"{name}: the parent's sweep differs from this tree's")
        row.update(parent_sweep_graph_ms=times["parent"],
                   parent_graph_ms=min(times["parent"]),
                   parent_note="the parent commit's C entry, the sweep "
                               "launch alone, by graph, in turns")
    del outs, mask
    return row


def hold_fused_k5(rec) -> dict:
    """F3's first launch alone (kernels._fused_intersect, the stacked K5
    with its counts) on the inputs of a recorded F3 call, slots on the
    card: its counts and each partition's mask on its own superwindows
    bitwise against the plain K5 per partition (also poisoned), timed by
    events and by CUDA graph beside the plain version and the bytes it
    must move (each distinct clause block, the masks and counts)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels as k

    _, args, kw = rec
    nsw = list(kw["nsw"])
    dev = args[0].device
    sl, ng, bits = args[1].to(dev), args[2].to(dev), args[3]
    out = {}

    def kern():
        out["k"] = k._fused_intersect(sl, ng, bits, nsw)

    def plain():
        out["p"] = [k.intersect_bitset_counts_plain(sl[i], ng[i], bits[i],
                                                    nsw=nsw[i])
                    for i in range(len(bits))]

    ms = cuda_ms(kern, 10)
    plain_ms = cuda_ms(plain, 1)

    def held(got):
        mask, counts = got
        return all(torch.equal(mask[i, :, :nsw[i] * k.SW_WORD_ROWS], pm)
                   and torch.equal(counts[i], pc)
                   for i, (pm, pc) in enumerate(out["p"]))

    require(held(out["k"]), "fused K5 stage differs from the plain K5")
    with k.poisoned():
        again = k._fused_intersect(sl, ng, bits, nsw)
    require(held(again), "fused K5 stage on poisoned outputs differs")
    block = k.SW_WORD_ROWS * 128 * 4
    qc = int(sl.shape[1])
    nbytes = 0
    for i in range(len(bits)):
        hp = int(bits[i].shape[0]) - 2
        distinct = (set(sl[i].cpu().numpy().ravel().tolist())
                    | set(ng[i].cpu().numpy().ravel().tolist())) - {hp,
                                                                    hp + 1}
        nbytes += (len(distinct) + qc) * nsw[i] * block + qc * 48 + qc * 4
    b_ms, b_by = bound(nbytes, 0, PEAK_F32)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "graph_ms": graph_ms(kern, 50), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "library_note": "no single PyTorch call gathers and ANDs the "
                            "clause blocks", "poisoned_run": "bitwise"}


def _global_rows(rows, base):
    """(scores, 0, global doc ids) of a partitioned engine's rows."""
    s, p, o = rows
    g = np.where(s > 0, np.asarray(base)[p] + o, 0).astype(np.int64)
    return s, np.zeros_like(p), g


def serve_fused(eng, traffic, fault_log):
    """Every (route, queries) of the fused phase's traffic through eng:
    match batches by search_many, bools by search_bool with ES_TPU_BITSET
    at 1 (bitset) or 0 (coverage), phrases by search_phrase. Returns
    {label: rows} and {label: seconds}, launch and merge counters by label."""
    from elasticsearch_tpu_torch.parallel import kernels

    rows, lat, per = {}, {}, {}
    for label, route, qs in traffic:
        l0, m0 = dict(kernels.LAUNCHES), dict(eng.merge_stats)
        t = time.time()
        if route == "match":
            rows[label] = eng.search_many([qs], k=K, fault_log=fault_log)[0]
        elif route == "phrase":
            rows[label] = eng.search_phrase(qs, k=K, slop=0,
                                            fault_log=fault_log)
        else:
            with env_set("ES_TPU_BITSET", "1" if route == "bitset" else "0"):
                rows[label] = eng.search_bool(qs, k=K, fault_log=fault_log)
        lat[label] = time.time() - t
        per[label] = (
            {n: kernels.LAUNCHES[n] - l0[n] for n in kernels.LAUNCHES
             if kernels.LAUNCHES[n] != l0[n]},
            {n: eng.merge_stats[n] - m0[n] for n in eng.merge_stats})
    return rows, lat, per


SOLO_SWEEPS = ("sweep_rowmax", "sweep_rowmax_conj", "sweep_rowmax_bitset",
               "intersect_bitset")
FUSED_OF = {"match": ("fused_sweep_rowmax",),
            "coverage": ("fused_sweep_rowmax_conj",),
            "bitset": ("fused_intersect_bitset", "fused_sweep_rowmax_bitset"),
            "phrase": ("fused_intersect_bitset", "fused_sweep_rowmax_bitset")}


def fused_phase(fp, n: int, batches, dsl, main_rows, held, bool_ans,
                phrase_ans, device="cuda", k2_parent_src=None):
    """The fused S > 1 route (ROADMAP item 5) on the shard cut into
    FUSED_PARTS segments by doc range: select_bm25_engine builds the fused
    TurboEngine (one F1-F3 launch per query chunk for every partition, K4
    on every merge); both config-1 batches and the DSL plans, config 2's
    bool specs on both sweeps (ES_TPU_BITSET=1: F3, =0: F2) and the first
    FUSED_PHRASES slop-0 phrases with the head-term ones, every launch
    count set to 0 before and read after. Every top-10 is held bitwise
    against the sequential route over the same partitions (a second
    TurboEngine, fusion off; the config-1 traffic then once more on the
    fused route, warm) and against the single-segment rows of the main
    path, doc ids mapped, and so against the host-exact tier's answers:
    the main path's hold of the first HOLD_PER_BATCH of each batch and of
    the DSL plans (`held`), the bool and phrase answers (`bool_ans`,
    `phrase_ans`). The segments' and the shard's f32 doc-length sums, from
    which the index-global avgdl comes, are printed beside. Then every
    launch shape of the phase (F1-F3, K3, K4) is held against its plain
    version and timed (hold_fused, check_path_shapes), F1-F3's sweep
    beside the parent commit's where `k2_parent_src` (a whole earlier
    sweep_rowmax.cu) is given.
    Returns (kernel rows, report)."""
    import torch

    from elasticsearch_tpu_torch.parallel import kernels
    from elasticsearch_tpu_torch.search.serving import (
        TurboEngine, engine_desc, select_bm25_engine,
    )

    t_phase = time.time()
    bool_qs, b_hs, b_ho = bool_ans
    # the first FUSED_PHRASES drawn phrases, which mostly gallop to the
    # host, and the head-term ones, which take the device sweep
    pick = list(range(FUSED_PHRASES)) + list(
        range(len(phrase_ans[0]) - len(HEAD_PHRASES), len(phrase_ans[0])))
    phrases = [phrase_ans[0][i] for i in pick]
    p_hs, p_ho = phrase_ans[1][pick], phrase_ans[2][pick]
    t = time.time()
    cut = fused_segments(fp, n)
    base = np.asarray([lo for _, lo in cut], np.int64)
    split_s = time.time() - t
    os.environ.pop("ES_TPU_TURBO_MESH", None)
    t = time.time()
    eng = select_bm25_engine([sg for sg, _ in cut], "body", device=device,
                             hbm_budget_bytes=TURBO_HBM, cold_df=COLD_DF)
    require(eng.kind == "turbo" and eng.fused
            and len(eng.turbos) == FUSED_PARTS
            and engine_desc(eng) == ("fused_turbo", FUSED_PARTS),
            f"fused: the engine is {engine_desc(eng)}, not fused_turbo over "
            f"{FUSED_PARTS} partitions")
    n_cols = eng.prebuild_columns()
    if device == "cuda":
        torch.cuda.synchronize()
    build_s = time.time() - t
    log(f"fused: {FUSED_PARTS} segments split in {split_s:.1f}s, engine "
        f"and {n_cols} columns in {build_s:.1f}s; nsw "
        f"{[x.nsw for x in eng.turbos]}, Hp {[x.Hp for x in eng.turbos]}")
    traffic = ([(f"match{i}", "match", b) for i, b in enumerate(batches)]
               + [("dsl", "match", dsl), ("bitset", "bitset", bool_qs),
                  ("coverage", "coverage", bool_qs),
                  ("phrase", "phrase", phrases)])
    fault_log = []
    with record_shapes() as seen, plain_calls() as pc:
        kernels.reset_launches()
        rows, lat, per = serve_fused(eng, traffic, fault_log)
        launches = dict(kernels.LAUNCHES)
    require(not fault_log, f"fused: fault records {fault_log}")
    require(not any(pc.values()), f"fused: a plain version ran: {pc}")
    for label, route, qs in traffic:
        lc, mc = per[label]
        chunks = mc["fused_dispatches"]
        require(chunks >= 1 and all(lc.get(x, 0) == chunks
                                    for x in FUSED_OF[route]),
                f"fused {label}: {chunks} fused dispatches, launches {lc}")
        require(mc["partition_dispatches"] == chunks * FUSED_PARTS,
                f"fused {label}: partition dispatches {mc}")
        require(not any(lc.get(x, 0) for x in SOLO_SWEEPS),
                f"fused {label}: a solo sweep launched: {lc}")
        require(lc.get("merge_topk", 0) == mc["merge_device"] == 1
                and mc["merge_host"] == 0,
                f"fused {label}: merges {mc}, K4 launches "
                f"{lc.get('merge_topk', 0)}")
    for name, sh in seen.items():
        require(sum(v[0] for v in sh.values()) == launches[name],
                f"fused: {name}'s launches by shape do not add up")
    st = eng.stats
    for key in ("degraded", "sparse_fallbacks", "cold_queries",
                "health_device_faults", "health_fallback_queries"):
        require(st[key] == 0, f"fused: {key} = {st[key]}")
    log(f"fused route: latencies {lat}; launches "
        f"{ {x: v for x, v in launches.items() if v} }")

    # the sequential route over the same partitions, bitwise
    seq = TurboEngine(eng.turbos)
    require(not seq.fused and engine_desc(seq) == ("turbo", FUSED_PARTS),
            "fused: the second engine is not the sequential route")
    kernels.reset_launches()
    s_rows, s_lat, s_per = serve_fused(seq, traffic, fault_log)
    s_launch = dict(kernels.LAUNCHES)
    require(not fault_log, f"sequential: fault records {fault_log}")
    require(not any(s_launch[x] for x in FUSED_ROWS)
            and s_launch["merge_topk"] == 0,
            f"sequential: a fused kernel or K4 launched: {s_launch}")
    for label, _, _ in traffic:
        for g, w, what in zip(rows[label], s_rows[label],
                              ("scores", "parts", "ords")):
            require(np.array_equal(g, w),
                    f"fused {label}: {what} differ from the sequential "
                    f"route")
    log(f"sequential route: latencies {s_lat}; every top-10 bitwise the "
        f"fused route's")
    # the config-1 traffic once more on the fused route, its caches warm
    # as the sequential route found them (the first pass built the slices
    # and columns both read)
    w_rows, w_lat, _ = serve_fused(
        eng, [x for x in traffic if x[1] == "match"], fault_log)
    require(not fault_log, f"fused warm: fault records {fault_log}")
    for label in w_rows:
        require(all(np.array_equal(g, w) for g, w in
                    zip(w_rows[label], rows[label])),
                f"fused {label}: the warm pass differs from the first")
    log(f"fused route, warm: latencies {w_lat}")

    # the single-segment rows, doc ids mapped to the shard's; and the
    # host-exact answers: the main path's host-exact tier's on the first
    # HOLD_PER_BATCH of each batch and the DSL plans (`held`), the bool
    # and phrase answers (which are the host-exact tier's)
    one = {f"match{i}": r for i, r in enumerate(main_rows[:len(batches)])}
    one["dsl"] = main_rows[len(batches)]
    zero = np.zeros_like(b_ho)
    one["bitset"] = one["coverage"] = (b_hs, zero, b_ho)
    one["phrase"] = (p_hs, np.zeros_like(p_ho), p_ho)
    exact = {f"match{i}": h for i, h in enumerate(held[:len(batches)])}
    exact["dsl"] = held[len(batches)]
    exact["bitset"] = exact["coverage"] = (b_hs, b_ho)
    exact["phrase"] = (p_hs, p_ho)
    n_held = 0
    vs_one = {}
    for label, _, _ in traffic:
        g = _global_rows(rows[label], base)
        hs, ho = exact[label]
        m = len(hs)
        require(np.array_equal(g[0][:m], hs)
                and np.array_equal(g[2][:m], np.where(hs > 0, ho, 0)),
                f"fused {label}: differs from the host-exact tier")
        n_held += m
        w = one[label]
        w = (w[0], np.zeros_like(w[2]), np.where(w[0] > 0, w[2], 0))
        same = int(sum(np.array_equal(g[0][q], w[0][q])
                       and np.array_equal(g[2][q], w[2][q])
                       for q in range(len(w[0]))))
        d = np.abs(g[0].astype(np.float64) - w[0].astype(np.float64))
        vs_one[label] = {"queries": len(w[0]), "bitwise": same,
                         "max_abs_score_diff": float(d.max())}
    sums = {"segments_f32_sum_doc_len": [float(sg.postings["body"]
                                               .sum_doc_len)
                                         for sg, _ in cut],
            "shard_f32_sum_doc_len": float(fp.sum_doc_len),
            "exact_sum_doc_len": int(fp.doc_len.astype(np.int64).sum())}
    log(f"fused: {n_held} answers bitwise the host-exact tier's; against "
        f"the single-segment rows (ids mapped): {vs_one}; doc-length sums "
        f"{sums}")
    require(all(v["bitwise"] == v["queries"] for v in vs_one.values()),
            f"fused: rows differ from the single-segment rows: {vs_one}, "
            f"doc-length sums {sums}")

    # every launch shape of the phase against its plain version, timed
    t = time.time()
    shapes = check_path_shapes(seen, None,
                               fused_parent=fused_parents(k2_parent_src))
    kernel_rows = []
    for name, replaces in FUSED_ROWS.items():
        sh = shapes.get(name, {})
        require(sh, f"fused: {name} has no launch shape")
        # the shape launched most, the widest among equals
        head = max(sh, key=lambda x: (sh[x]["launches"],
                                      int(x.strip("()").split(",")[1])))
        r = sh[head]
        row = {"name": name, "route": "cuda",
               "source": ("elasticsearch_tpu_torch/parallel/csrc/"
                          + ("intersect_bitset.cu"
                             if name == "fused_intersect_bitset"
                             else "sweep_rowmax.cu")),
               "replaces": replaces, "launches": launches[name],
               "shape_timed": head, "shapes": sh}
        if name == "fused_intersect_bitset":
            recs = {str(x): v for x, v in
                    seen["fused_sweep_rowmax_bitset"].items()}
            row.update(hold_fused_k5(recs[head]))
        else:
            row.update({x: r[x] for x in
                        ("max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")})
        kernel_rows.append(row)
    checks_s = time.time() - t
    report = {"partitions": FUSED_PARTS, "docs": n, "split_s": split_s,
              "build_s": build_s, "columns": n_cols,
              "latency_s": lat, "warm_latency_s": w_lat,
              "sequential_latency_s": s_lat,
              "launches": {x: v for x, v in launches.items() if v},
              "per_call": {label: per[label] for label in per},
              "sequential_launches": {x: v for x, v in s_launch.items()
                                      if v},
              "host_exact_held": n_held,
              "vs_one_segment": vs_one, "doc_length_sums": sums,
              "merge_stats": dict(eng.merge_stats),
              "fallbacks": st["fallbacks"], "checks_s": checks_s,
              "shapes": {x: {str(key): v for key, v in sh.items()}
                         for x, sh in shapes.items()}}
    del eng, seq, cut, rows, s_rows, w_rows, seen
    if device == "cuda":
        torch.cuda.empty_cache()
    report["phase_s"] = time.time() - t_phase
    log(f"fused phase took {report['phase_s']:.1f}s")
    return kernel_rows, report


# ---------------------------------------------------------------------------
# the integrity plane on the card: the HBM scrub of engines already built
# ---------------------------------------------------------------------------

SCRUB_RESULTS_OK = ("clean", "baselined")


def flip_in_place(t) -> None:
    """One bit of the tensor's middle byte flipped where it lies, through
    .copy_() of that one byte (rot in device memory, no injection)."""
    import torch

    b = t.view(-1).view(torch.uint8)
    mid = b.numel() // 2
    bad = torch.tensor([int(b[mid].item()) ^ 1], dtype=torch.uint8,
                       device=t.device)
    b[mid:mid + 1].copy_(bad)


def integrity_phase(label: str, owners, inject, inplace, rerun, need,
                    health=None, probe=None, trip=None) -> dict:
    """The HBM scrub on an engine an earlier phase built and still holds:
      1. one full scrub cycle over every region of `owners` (each region
         downloaded once and hashed, host-backed ones against their host
         copy, device-built ones baselined), every result clean or
         baselined; each region's bytes and seconds (D2H + sha256) logged;
      2. `inject` = (owner, region): an injected hbm_region flip, found
         and repaired;
      3. `inplace` = (owner, region, attr): one bit of the device tensor
         `owner.attr` flipped through .copy_(), found and repaired;
      4. `rerun()` serves the engine's held answers again and requires them
         bitwise; every launch count set to 0 just before and read just
         after, and each kernel of `need` launched;
      5. with an EngineHealth (`health`): ES_TPU_HEALTH_TRIP_N injected
         mismatches in a row of `trip` = (owner, region) (default:
         `inject`'s) open its circuit, and after the backoff `probe()` (a
         search, which requires its answers) is the half-open probe that
         closes it.
    Returns the phase's report."""
    from elasticsearch_tpu_torch.common import faults, integrity
    from elasticsearch_tpu_torch.common.settings import knob
    from elasticsearch_tpu_torch.parallel import kernels

    t0 = time.time()
    c0 = integrity.integrity_stats()
    regions = {}
    for o in owners:
        for r in integrity.scrub_owner(o):
            require(r["result"] in SCRUB_RESULTS_OK,
                    f"{label} scrub: {r['region']} is {r['result']} on a "
                    f"clean engine")
            regions[r["region"]] = {"bytes": r["bytes"],
                                    "scrub_s": r["seconds"],
                                    "result": r["result"]}
            log(f"{label} scrub region {r['region']}: {r['bytes']} bytes, "
                f"{r['seconds']:.3f}s (D2H + sha256), {r['result']}")
    cycle_s = time.time() - t0
    require(regions, f"{label}: no scrub region registered")

    def flipped(owner, name, what):
        (r,) = integrity.scrub_owner(owner, [name])
        require(r["result"] == "mismatch" and r.get("repaired"),
                f"{label} scrub: {what} on {name} gave {r}")
        # the repaired region scrubs clean (or re-baselines), which also
        # ends the run of mismatches on the engine's circuit
        (r,) = integrity.scrub_owner(owner, [name])
        require(r["result"] in SCRUB_RESULTS_OK,
                f"{label} scrub: {name} after its repair gave {r}")

    t = time.time()
    o, name = inject
    with faults.inject(f"hbm_region#{name}:raise@1x1"):
        flipped(o, name, "an injected flip")
    inject_s = time.time() - t
    t = time.time()
    o, name, attr = inplace
    flip_in_place(getattr(o, attr))
    flipped(o, name, "an in-place flip")
    inplace_s = time.time() - t

    t = time.time()
    kernels.reset_launches()
    rerun()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    for k in need:
        require(launches.get(k, 0) > 0,
                f"{label}: {k} did not launch after the repairs: "
                f"{launches}")
    rerun_s = time.time() - t
    rep = {"regions": regions, "full_cycle_s": cycle_s,
           "injected_flip_s": inject_s, "in_place_flip_s": inplace_s,
           "rerun_s": rerun_s, "launches": launches}
    trips = 0
    if health is not None:
        trip_n = int(knob("ES_TPU_HEALTH_TRIP_N"))
        require(health.trip_n == trip_n and health.state == "closed",
                f"{label}: health {health.stats()}")
        opens = health.counters["circuit_opens"]
        o, name = trip or inject
        for i in range(trip_n):
            require(health.state == "closed",
                    f"{label}: circuit open after {i} mismatches")
            with faults.inject(f"hbm_region#{name}:raise@1x1"):
                (r,) = integrity.scrub_owner(o, [name])
            require(r["result"] == "mismatch",
                    f"{label} scrub: mismatch {i + 1} of {trip_n} gave {r}")
        trips = trip_n
        require(health.state == "open"
                and health.counters["circuit_opens"] == opens + 1,
                f"{label}: circuit not open after {trip_n} scrub "
                f"mismatches: {health.stats()}")
        time.sleep(health.backoff_ms / 1000.0 + 0.05)
        probes = health.counters["probe_successes"]
        probe()
        require(health.state == "closed"
                and health.counters["probe_successes"] == probes + 1,
                f"{label}: the probe did not close the circuit: "
                f"{health.stats()}")
        rep["health"] = {"trip_n": trip_n,
                         "backoff_ms": health.base_backoff_ms,
                         "transitions": list(health._transitions)[-3:]}
    c1 = integrity.integrity_stats()
    d = {k: c1[k] - c0[k] for k in ("scrub_ticks", "scrub_clean",
                                    "scrub_baselined", "scrub_mismatches",
                                    "scrub_repairs", "scrub_repaired_bytes")}
    require(d["scrub_mismatches"] == d["scrub_repairs"] == 2 + trips,
            f"{label} scrub counters {d}")
    rep["counters"] = d
    rep["phase_s"] = time.time() - t0
    log(f"{label} integrity: full cycle {cycle_s:.2f}s over "
        f"{sum(r['bytes'] for r in regions.values())} bytes in "
        f"{len(regions)} regions; injected and in-place flips repaired, "
        f"answers bitwise again (launches {launches}); counters {d}; "
        f"{rep['phase_s']:.1f}s")
    return rep


def turbo_integrity(eng, batches, dsl, results) -> dict:
    """integrity_phase on the main path's engine (S = 1): its regions
    scrubbed, an injected flip of `live` and an in-place flip of the column
    cache (a baseline region: its repair drops the cache, so K1 rebuilds
    on the rerun) repaired, the first HOLD_PER_BATCH queries of batch 0
    and the DSL bodies bitwise the main path's answers again, the circuit
    tripped and closed by a search of 8 queries."""
    (turbo,) = eng.turbos

    def answers(b, want, label):
        gs, _, go = eng.search_many([b], k=K)[0]
        m = len(b)
        require(np.array_equal(gs, want[0][:m])
                and np.array_equal(go, want[2][:m]),
                f"turbo {label}: answers differ from the main path's")

    def rerun():
        answers(batches[0][:HOLD_PER_BATCH], results[0], "rerun")
        answers(dsl, results[-1], "rerun (DSL bodies)")

    return integrity_phase(
        "turbo", [turbo], (turbo, "live"), (turbo, "cols_hi", "cols_hi"),
        rerun, ("build_columns", "sweep_rowmax", "sparse_gather"),
        eng.health, lambda: answers(batches[0][:8], results[0], "probe"))


def knn_integrity(eng, qs, ans) -> dict:
    """integrity_phase on knn_phase's S = 1 engine: an injected flip of
    knn_shards and an in-place flip of the row meta repaired, the 256
    queries bitwise the int8 route's warm answers again and within the
    score bound of the dense route's, the circuit tripped (on the row
    meta: 32 MB a scrub, not knn_shards' 1.5 GB) and closed by the same
    search."""
    from elasticsearch_tpu_torch.parallel import knn as knn_mod

    works = [knn_mod.KnnWork(q) for q in qs]
    bound = knn_score_bound(qs)

    def rerun():
        got = eng.search_many([works], k=K)[0]
        require(all(np.array_equal(a, b)
                    for a, b in zip(got, ans["int8_warm"])),
                "knn S=1: answers after the repairs differ")
        knn_agree(got, ans["dense"], bound, "knn S=1 after the repairs")

    return integrity_phase(
        "knn S=1", [eng], (eng, "knn_shards"), (eng, "knn_meta", "d_meta"),
        rerun, ("knn_int8_window_topc",), eng.health, rerun,
        trip=(eng, "knn_meta"))


def agg_integrity(ctx, lay, cmasks, dev_out) -> dict:
    """integrity_phase on agg_phase's layouts: every layout's region
    scrubbed, an injected flip of the terms_metric layout `lay` and an
    in-place flip of another layout repaired, the config-6 requests
    bitwise `dev_out` again (K8). The agg tier has no health circuit, as
    in the reference."""
    from elasticsearch_tpu_torch.search import agg_device

    layouts = [x for x in ctx.leaf.segment._device.values()
               if isinstance(x, agg_device._AggLayout)]
    other = next(x for x in layouts if x is not lay)

    def rerun():
        out, _ = run_aggs(ctx, AGG_SPEC, cmasks)
        require(out == dev_out, "config 6 after the repairs differs")

    return integrity_phase("agg", layouts, (lay, lay.region_name),
                           (other, other.region_name, "dev"), rerun,
                           ("agg_counts",))


def run(n_docs: int, n_batches: int, batch: int, knn_docs: int,
        agg_docs: int, k3_parent_src=None, k2_parent_src=None,
        k8_parent_src=None, k4_parent_src=None, k5_parent_src=None,
        scatter_parent_src=None, lane_parent_src=None,
        weighted_parent_src=None) -> dict:
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
    parent = k3_parent(k3_parent_src)
    log(f"parent K3 for the A/B: {k3_parent_src if parent else 'not given'}")
    from elasticsearch_tpu_torch.tools.k2_ab import parent_runner

    # the parent's whole sweep_rowmax.cu: its K2, K6 and K7 entries
    k2_parent = parent_runner(k2_parent_src)
    k6_parent = parent_runner(k2_parent_src, "bitset")
    k7_parent = parent_runner(k2_parent_src, "conj")
    log(f"parent sweeps (K2, K6, K7) for the A/B: "
        f"{k2_parent_src if k2_parent else 'not given'}")
    k5_parent_fn = k5_parent(k5_parent_src)
    scatter = scatter_parent(scatter_parent_src)
    for name, src in (("K8", k8_parent_src), ("K4", k4_parent_src),
                      ("K5", k5_parent_src),
                      ("block scatter", scatter_parent_src),
                      ("K10", lane_parent_src),
                      ("K11", weighted_parent_src)):
        log(f"parent {name} for the A/B: "
            f"{src if src and os.path.isfile(src) else 'not given'}")

    if n_docs < FULL_DOCS:
        log(f"CUT: index cut from {FULL_DOCS} to {n_docs} docs")
    t = time.time()
    fp, tokens, bounds = build_index(n_docs, VOCAB)
    index_s = time.time() - t
    log(f"index with positions: {n_docs} docs, {len(tokens)} tokens, "
        f"{len(fp.post_doc)} postings in {index_s:.1f}s")

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
    results, lat, cert_fb, k3_per, k3_batch = [], [], [], [], []
    with record_k3_groups(turbo) as k3_groups:
        for b in batches + [dsl]:
            fb0 = eng.stats["fallbacks"]
            k30 = kernels.LAUNCHES["sparse_gather"]
            g0 = len(k3_groups)
            t = time.time()
            results.append(eng.search_many([b], k=K, fault_log=fault_log)[0])
            lat.append(time.time() - t)
            cert_fb.append(eng.stats["fallbacks"] - fb0)
            k3_per.append(kernels.LAUNCHES["sparse_gather"] - k30)
            k3_batch.append(list(range(g0, len(k3_groups))))
    launches = dict(kernels.LAUNCHES)
    require([len(x) for x in k3_batch] == k3_per,
            f"K3 groups recorded {k3_batch} against launches {k3_per}")
    log(f"main path: {n_cols} columns prebuilt in {prebuild_s:.2f}s; "
        f"batch latencies {[round(x, 4) for x in lat]}s; launches {launches}")
    require(all(launches[n] > 0 for n in
                ("build_columns", "sweep_rowmax", "sparse_gather")),
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

    # ---- hold: top-10s against the host-exact tier (the DSL bodies in
    # full, each batch on its first HOLD_PER_BATCH queries) ----
    t = time.time()
    n_q = 0
    parts, owner = [], []
    for bi, (b, (s, p, o)) in enumerate(zip(batches + [dsl], results)):
        require(s.shape == (len(b), K) and np.isfinite(s).all(),
                "result shape or finiteness")
        require(not p.any(), "partition ids on a one-partition engine")
        m = len(b) if bi == len(batches) else min(len(b), HOLD_PER_BATCH)
        parts += [b[i:i + 8] for i in range(0, m, 8)]
        owner += [bi] * len(range(0, m, 8))
    host = host_exact_runs(turbo, parts)
    held = []
    for bi, (s, _, o) in enumerate(results):
        mine = [h for h, ob in zip(host, owner) if ob == bi]
        hs = np.concatenate([h[0] for h in mine])
        ho = np.concatenate([h[1] for h in mine])
        ho[hs <= 0] = 0
        m = len(hs)
        require(np.array_equal(s[:m], hs) and np.array_equal(o[:m], ho),
                "device route differs from the host-exact tier")
        held.append((hs, ho))
        n_q += m
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
    rows.append(check_k2(turbo, batches[0], launches["sweep_rowmax"],
                         k2_parent))
    rows.append(check_k3(k3_groups, k3_batch, turbo.Dp // kernels.TILE,
                         launches["sparse_gather"], parent))
    del k3_groups
    for r in rows:
        log(f"{r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
            f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{r['library_ms']}, launches {r['launches']}")
    torch.cuda.empty_cache()

    # ---- bool and phrase paths on the same engine and shard ----
    t = time.time()
    bool_rows, bool_report, k3_bool = bool_phases(eng, turbo, fp, n_docs,
                                                  tokens, bounds, mapper,
                                                  parent, k6_parent,
                                                  k7_parent, k5_parent_fn)
    rows[2]["bool_path"] = k3_bool
    rows[0]["phrase_launches"] = bool_report["k1_phrase_launches"]
    bool_answers = bool_report.pop("answers")
    phrase_answers = bool_report.pop("phrase_answers")
    rows += bool_rows
    bool_report["phases_s"] = time.time() - t

    # check_pack reset the peak to measure the repack's own
    peak = max(torch.cuda.max_memory_allocated(),
               bool_report.pop("peak_device_bytes_before"))
    ledger = hbm_ledger.hbm_stats()

    integ = {"turbo": turbo_integrity(eng, batches, dsl, results)}
    del eng, turbo
    torch.cuda.empty_cache()

    # ---- the fused S > 1 route on the shard cut into four segments ----
    fused_rows, fused_report = fused_phase(
        fp, n_docs, batches, dsl, results, held, bool_answers,
        phrase_answers, k2_parent_src=k2_parent_src)
    rows += fused_rows
    del phrase_answers
    # the kNN rows and the agg leaf, drawn in threads from here on, after
    # the forked holds and while the card works
    knn_draw = prefetch(knn_data, knn_docs)
    agg_draw = prefetch(agg_leaf, agg_docs)

    # ---- the dense search path (execute_search) on the same shard ----
    t = time.time()
    dense_rows, dense_report, dense_seg = dense_phase(
        fp, tokens, bounds, n_docs, scatter=scatter)
    dense_report["phase_s"] = time.time() - t
    rows += dense_rows
    log(f"dense phase took {dense_report['phase_s']:.1f}s")

    # ---- the serving entry point (IndexService) on the same segment ----
    s_launches, s_shapes, s_k8, serving_report, answers = serving_phase(
        dense_seg, fp, tokens, bounds, n_docs, batches, dsl, results)
    log(f"serving phase took {serving_report['phase_s']:.1f}s")

    # ---- BlockMax over the Turbo budget on the same shard, then spmd ----
    bm_rows, bm_report = blockmax_phase(dense_seg, fp, n_docs, batches,
                                        results[:len(batches)],
                                        bool_answers,
                                        lane_parent_src=lane_parent_src,
                                        weighted_parent_src=(
                                            weighted_parent_src))
    rows += bm_rows

    # ---- the cluster path: three ClusterNodes on the card ----
    seen = {name: {**s_shapes.get(name, {}),
                   **serving_report["rest"]["new_shapes"].get(name, {})}
            for name in set(s_shapes)
            | set(serving_report["rest"]["new_shapes"])}
    for win in serving_report["admin"]["new_shapes"].values():
        for name, sh in win.items():
            seen.setdefault(name, {}).update(sh)
    c_launches, c_shapes, cluster_report = cluster_phase(
        dense_seg, n_docs, answers, seen)
    del dense_seg, tokens, bounds, bool_answers, answers
    default = default_ladder(fp, n_docs, batches[0], held[0])
    del fp
    torch.cuda.empty_cache()

    # ---- quantized kNN (config 4) on S = 1 and stacked S = 4 ----
    t = time.time()
    knn_rows, knn_report = knn_phase(knn_docs, k4_parent_src=k4_parent_src,
                                     data=knn_draw)
    del knn_draw
    knn_report["phase_s"] = time.time() - t
    rows += knn_rows

    # ---- analytics (config 6): device aggregations through K8 ----
    t = time.time()
    agg_row, agg_report = agg_phase(agg_docs, k8_parent_src=k8_parent_src,
                                    leaf=agg_draw)
    del agg_draw
    agg_report["phase_s"] = time.time() - t
    rows.append(agg_row)
    log(f"agg phase took {agg_report['phase_s']:.1f}s")
    rest = serving_report["rest"]
    admin = serving_report["admin"]
    integ["knn"] = knn_report["S=1"]["integrity"]
    integ["agg"] = agg_report["integrity"]
    integ_launches = {}
    for rep_ in integ.values():
        for name, v in rep_["launches"].items():
            integ_launches[name] = integ_launches.get(name, 0) + v
    for r in rows:
        r["integrity_launches"] = integ_launches.get(r["name"], 0)
        r["serving_launches"] = s_launches.get(r["name"], 0)
        r["rest_launches"] = rest["launches"].get(r["name"], 0)
        r["admin_launches"] = admin["launches"].get(r["name"], 0)
        r["cluster_launches"] = c_launches.get(r["name"], 0)
        if c_shapes.get(r["name"]):
            r["cluster_shapes"] = c_shapes[r["name"]]
        r["admin_shapes"] = {win: sh[r["name"]] for win, sh in
                             admin["new_shapes"].items() if sh.get(r["name"])}
        if r["name"] in rest["new_shapes"]:
            r["rest_shapes"] = rest["new_shapes"][r["name"]]
        if r["name"] in s_shapes:
            r["serving_shapes"] = s_shapes[r["name"]]
        if r["name"] == "agg_counts":
            r["serving_path"] = s_k8

    phase_s = {"kernel_build": build_s, "index_build": index_s,
               "bool_and_phrase": bool_report["phases_s"],
               "fused": fused_report["phase_s"],
               "dense": dense_report["phase_s"],
               "serving": serving_report["phase_s"],
               "blockmax": bm_report["phase_s"],
               "cluster": cluster_report["phase_s"],
               "knn": knn_report["phase_s"], "agg": agg_report["phase_s"],
               "integrity": sum(x["phase_s"] for x in integ.values()),
               "script": time.time() - T0}
    log("phase times: " + ", ".join(f"{k} {v:.1f}s"
                                    for k, v in phase_s.items()))
    serving = {"docs": n_docs, "cut": n_docs < FULL_DOCS,
               "phase_s": phase_s,
               "index_build_s": index_s,
               "sparse_widths": WIDE_LADDER,
               "queries": n_main, "held_queries": n_q,
               "batch_latency_s": lat,
               "qps_per_batch": [len(b) / x for b, x in
                                 zip(batches + [dsl], lat)],
               "prebuild_s": prebuild_s, "columns": n_cols,
               "certificate_fallbacks_per_batch": cert_fb,
               "certificate_fallback_limit": MAX_CERT_FALLBACK_SHARE,
               "k3_launches_per_batch": k3_per,
               "default_ladder": default,
               "bool_and_phrase": bool_report,
               "fused": fused_report,
               "knn": knn_report,
               "agg": agg_report,
               "dense": dense_report,
               "index_service": serving_report,
               "blockmax": bm_report,
               "cluster": cluster_report,
               "integrity": integ,
               "hbm_ledger": ledger,
               "kernel_build_s": build_s,
               "peak_device_bytes": peak}
    return {"kernels": rows, "serving": serving}


def serving_only(n_docs: int, n_batches: int, batch: int) -> dict:
    """The serving phase alone (--serving-only): the kernels built, the
    index drawn, the main path's engine rows of each batch (its knobs,
    its columns prebuilt; nothing else of the main phase held or timed),
    the dense phase's segment, then serving_phase. Returns its launches,
    path shapes, K8 case and report."""
    import torch

    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.parallel import cuda_build
    from elasticsearch_tpu_torch.search.serving import (
        extract_plan, select_bm25_engine,
    )

    t = time.time()
    cuda_build.build_all()
    log(f"kernels built in {time.time() - t:.1f}s")
    fp, tokens, bounds = build_index(n_docs, VOCAB)
    eng = select_bm25_engine([_Seg(n_docs, fp)], "body", device="cuda",
                             hbm_budget_bytes=TURBO_HBM, cold_df=COLD_DF)
    eng.prebuild_columns()
    batches = draw_batches(n_batches, batch, VOCAB)
    mapper = MapperService({"properties": {"body": {"type": "text"}}})
    dsl = [extract_plan(b, mapper).disj for b in DSL_BODIES]
    rows = [eng.search_many([b], k=K)[0] for b in batches + [dsl]]
    del eng
    torch.cuda.empty_cache()
    log("main path rows")
    seg, _, _ = dense_segment(fp, tokens, bounds, n_docs, "cuda")
    launches, shapes, k8_row, rep, _ = serving_phase(
        seg, fp, tokens, bounds, n_docs, batches, dsl, rows)
    return {"launches": launches, "shapes": shapes, "k8": k8_row,
            "report": rep}


def blockmax_only(n_docs: int, n_batches: int, batch: int,
                  lane_parent_src=None, weighted_parent_src=None) -> dict:
    """The BlockMax phase alone (--blockmax-only): the kernels built, the
    index drawn, the main path's engine rows of each batch and the
    host-exact answers of config 2 (its columns prebuilt, nothing else of
    the main phase held or timed), the dense phase's segment, then
    blockmax_phase. Returns its kernel rows and report."""
    import torch

    from elasticsearch_tpu_torch.parallel import cuda_build
    from elasticsearch_tpu_torch.search.serving import select_bm25_engine

    t = time.time()
    cuda_build.build_all()
    log(f"kernels built in {time.time() - t:.1f}s")
    fp, tokens, bounds = build_index(n_docs, VOCAB)
    eng = select_bm25_engine([_Seg(n_docs, fp)], "body", device="cuda",
                             hbm_budget_bytes=TURBO_HBM, cold_df=COLD_DF)
    eng.prebuild_columns()
    batches = draw_batches(n_batches, batch, VOCAB)
    rows = [eng.search_many([b], k=K)[0] for b in batches]
    turbo = eng.turbos[0]
    bool_qs = draw_bool(BOOL_BATCH, VOCAB)
    chunks = [bool_qs[i:i + 8] for i in range(0, len(bool_qs), 8)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        host = list(ex.map(lambda q: turbo.search_bool_host(q, k=K), chunks))
    hs = np.concatenate([h[0] for h in host])
    ho = np.concatenate([h[1] for h in host])
    ho[hs <= 0] = 0
    del eng, turbo
    torch.cuda.empty_cache()
    log("main path rows and config-2 answers")
    seg, _, _ = dense_segment(fp, tokens, bounds, n_docs, "cuda")
    kernel_rows, rep = blockmax_phase(seg, fp, n_docs, batches, rows,
                                      (bool_qs, hs, ho),
                                      lane_parent_src=lane_parent_src,
                                      weighted_parent_src=weighted_parent_src)
    return {"kernels": kernel_rows, "report": rep}


def fused_only(n_docs: int, n_batches: int, batch: int,
               k2_parent=K2_PARENT) -> dict:
    """The fused phase alone (--fused-only): the kernels built, the index
    drawn, the single-segment rows it is held against (the main path's
    engine at its knobs, its columns prebuilt: both config-1 batches and
    the DSL plans; config 2's specs and the phrases of the bool phases on
    the host-exact tier), then fused_phase, the sweeps beside `k2_parent`'s
    (--k2-parent). Returns its kernel rows and report."""
    import torch

    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.parallel import cuda_build
    from elasticsearch_tpu_torch.search.serving import (
        extract_plan, select_bm25_engine,
    )

    t = time.time()
    cuda_build.build_all()
    log(f"kernels built in {time.time() - t:.1f}s")
    fp, tokens, bounds = build_index(n_docs, VOCAB)
    eng = select_bm25_engine([_Seg(n_docs, fp)], "body", device="cuda",
                             hbm_budget_bytes=TURBO_HBM, cold_df=COLD_DF)
    eng.prebuild_columns()
    batches = draw_batches(n_batches, batch, VOCAB)
    mapper = MapperService({"properties": {"body": {"type": "text"}}})
    dsl = [extract_plan(b, mapper).disj for b in DSL_BODIES]
    rows = [eng.search_many([b], k=K)[0] for b in batches + [dsl]]
    turbo = eng.turbos[0]
    parts, owner = [], []
    for bi, b in enumerate(batches + [dsl]):
        m = len(b) if bi == len(batches) else min(len(b), HOLD_PER_BATCH)
        parts += [b[i:i + 8] for i in range(0, m, 8)]
        owner += [bi] * len(range(0, m, 8))
    host = host_exact_runs(turbo, parts)
    held = []
    for bi in range(len(batches) + 1):
        mine = [h for h, ob in zip(host, owner) if ob == bi]
        held.append((np.concatenate([h[0] for h in mine]),
                     np.concatenate([h[1] for h in mine])))
    bool_qs = draw_bool(BOOL_BATCH, VOCAB)
    phrases = draw_phrases(PHRASES, fp, tokens, bounds) + HEAD_PHRASES
    specs = bool_qs + [{"phrases": [(p, 0, 1.0)]} for p in phrases]
    chunks = [specs[i:i + 8] for i in range(0, len(specs), 8)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        host = list(ex.map(lambda q: turbo.search_bool_host(q, k=K), chunks))
    hs = np.concatenate([h[0] for h in host])
    ho = np.concatenate([h[1] for h in host])
    ho[hs <= 0] = 0
    nb = len(bool_qs)
    del eng, turbo, tokens, bounds
    torch.cuda.empty_cache()
    log("single-segment rows and host answers")
    kernel_rows, rep = fused_phase(fp, n_docs, batches, dsl, rows, held,
                                   (bool_qs, hs[:nb], ho[:nb]),
                                   (phrases, hs[nb:], ho[nb:]),
                                   k2_parent_src=k2_parent)
    return {"kernels": kernel_rows, "report": rep}


def admin_only(n_docs: int, n_batches: int, batch: int,
               device="cuda") -> dict:
    """The admin phase alone (--admin-only): the kernels built, the index
    drawn at n_docs, the dense segment (all live) and the kNN service as
    the serving phase builds them, the answers admin_phase holds served
    in process under the serving phase's knobs (batch 0's msearch, the
    first ADMIN_ASYNC_BOOLS bool bodies, the agg bodies, the kNN bodies),
    then admin_phase with no shape held before it, its BM25 snapshot at
    min(SNAP_DOCS, n_docs). Returns its report."""
    import torch

    from elasticsearch_tpu_torch.parallel import cuda_build

    t = time.time()
    if device == "cuda":
        cuda_build.build_all()
    log(f"kernels built in {time.time() - t:.1f}s")
    fp, tokens, bounds = build_index(n_docs, VOCAB)
    seg, _, _ = dense_segment(fp, tokens, bounds, n_docs, device)
    del fp, tokens, bounds
    svc = serving_service([(seg, np.ones(n_docs, bool))], DENSE_MAPPING,
                          "serving", device)
    kn_svc, kqs = knn_service(device)
    groups = [[match_body(q) for q in b]
              for b in draw_batches(n_batches, batch, VOCAB)]
    bools = [bool_body(sp) for sp in
             draw_bool(BOOL_BATCH, VOCAB)][:ADMIN_ASYNC_BOOLS]
    aggs = serving_agg_bodies()
    kbodies = [b for b, _ in knn_bodies(kqs)[0]]
    with contextlib.ExitStack() as st:
        st.enter_context(env_set("ES_TPU_TURBO_HBM", str(TURBO_HBM)))
        st.enter_context(env_set("ES_TPU_TURBO_COLD_DF", str(COLD_DF)))
        st.enter_context(env_set("ES_TPU_SPARSE_WIDTHS", WIDE_LADDER))
        answers = {
            "groups": groups, "served": [svc.msearch(groups[0])],
            "bools": bools, "bool_resps": [svc.search(b) for b in bools],
            "agg_bodies": aggs, "agg_resps": [svc.search(b) for b in aggs],
            "knn_bodies": kbodies,
            "knn_resps": kn_svc.serving.try_msearch(kbodies,
                                                    "query_then_fetch")}
    log("admin: the in-process answers served")
    rep = admin_phase(svc, kn_svc, answers, {}, {}, device=device,
                      snap_docs=min(SNAP_DOCS, n_docs))
    del svc, kn_svc, seg
    if device == "cuda":
        torch.cuda.empty_cache()
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=FULL_DOCS,
                    help="index size (default: one 8M-doc shard)")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--knn-docs", type=int, default=KNN_DOCS,
                    help="kNN column size (default: 2M 768-d vectors)")
    ap.add_argument("--agg-docs", type=int, default=AGG_DOCS,
                    help="agg leaf size (default: config 6's 10M docs)")
    ap.add_argument("--k3-parent", default=K3_PARENT,
                    help="an earlier sparse_gather.cu (one query a launch) "
                         "to time beside this tree's K3 on the same "
                         "dispatches; skipped when the file is missing")
    ap.add_argument("--k2-parent", default=K2_PARENT,
                    help="an earlier sweep_rowmax.cu (same C entries) to "
                         "time beside this tree's K2, K6 and K7 on the "
                         "same inputs; skipped when the file is missing")
    ap.add_argument("--k8-parent", default=K8_PARENT,
                    help="an earlier agg_counts.cu (its C entry without "
                         "word scratch) to time beside this tree's K8 on "
                         "the same inputs; skipped when the file is missing")
    ap.add_argument("--k4-parent", default=K4_PARENT,
                    help="an earlier merge_topk.cu (same C entry) to time "
                         "beside this tree's K4 on the same merge; skipped "
                         "when the file is missing")
    ap.add_argument("--k5-parent", default=K5_PARENT,
                    help="an earlier intersect_bitset.cu (its mask-only C "
                         "entry) to time with the torch mask_chunk_counts "
                         "beside this tree's K5 stage; skipped when the "
                         "file is missing")
    ap.add_argument("--scatter-parent", default=SCATTER_PARENT,
                    help="an earlier block_scatter.cu (the same C "
                         "entries) to time beside this tree's block scatter "
                         "on the same calls; skipped when the file is "
                         "missing")
    ap.add_argument("--lane-topk-parent", default=LANE_TOPK_PARENT,
                    help="an earlier lane_topk.cu (its C entry without the "
                         "tile scratch) to time beside this tree's K10 at "
                         "every BlockMax and spmd launch shape; skipped "
                         "when the file is missing")
    ap.add_argument("--weighted-scatter-parent", default=WEIGHTED_PARENT,
                    help="an earlier block_scatter.cu (its K11 C entry "
                         "without the run table, a launch per run) to time "
                         "beside this tree's K11 on every overflow query; "
                         "skipped when the file is missing")
    ap.add_argument("--serving-only", action="store_true",
                    help="run the serving phase alone on the index "
                         "(its main-path rows first), print its report and "
                         "the card's name; no ok line")
    ap.add_argument("--blockmax-only", action="store_true",
                    help="run the BlockMax phase alone on an index of "
                         "--docs docs (the main path's rows first), print "
                         "its kernel rows and report and the card's name; "
                         "no ok line")
    ap.add_argument("--fused-only", action="store_true",
                    help="run the fused S > 1 phase alone on an index of "
                         "--docs docs (the single-segment rows first), "
                         "print its kernel rows and report and the card's "
                         "name; no ok line")
    ap.add_argument("--admin-only", action="store_true",
                    help="run the admin phase alone on a serving index of "
                         "--docs docs, print its report and the card's "
                         "name; no ok line")
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
    zipf_tokens_match()
    try:
        import elasticsearch_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 2
    if (args.serving_only or args.admin_only or args.blockmax_only
            or args.fused_only):
        if args.fused_only:
            out = {"fused_only": fused_only(args.docs, args.batches,
                                            args.batch, args.k2_parent)}
        elif args.serving_only:
            out = {"serving_only": serving_only(args.docs, args.batches,
                                                args.batch)}
        elif args.blockmax_only:
            out = {"blockmax_only": blockmax_only(
                args.docs, args.batches, args.batch, args.lane_topk_parent,
                args.weighted_scatter_parent)}
        else:
            out = {"admin_only": admin_only(args.docs, args.batches,
                                            args.batch)}
        print(json.dumps(out, default=str), flush=True)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
        return 0
    out = run(args.docs, args.batches, args.batch, args.knn_docs,
              args.agg_docs, args.k3_parent, args.k2_parent,
              args.k8_parent, args.k4_parent, args.k5_parent,
              args.scatter_parent, args.lane_topk_parent,
              args.weighted_scatter_parent)
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
