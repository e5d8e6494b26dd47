"""The sweeps side by side: an earlier `sweep_rowmax.cu` against this
tree's, on one card in one process, on seeded synthetic inputs made on the
card in seconds (no index build), 123 superwindows of 65536 docs and Hpt
225 as the engine's 8M-doc shard has them:

- `--kernel disj` (K2, `es_sweep_rowmax`): config 1's shape, two-term
  Zipf queries of which about half the terms have a device column, about
  90 union slots with column densities from 90% down to under 1%, QC 256
  and the DSL batch's QC 8;
- `--kernel conj` (K7, `es_sweep_rowmax_conj`): config 2's device chunk,
  weighted as `TurboBM25._bool_weights` weights it: QC 256 of which the
  first 128 are heavy conjunctions (two head-term musts, +1 coverage
  each, some with a head-term filter or must_not) and the rest padding,
  and QC 8 for the DSL batch;
- `--kernel bitset` (K6, `es_sweep_rowmax_bitset`): the same queries and
  columns, each gated by its mask as K5 makes it from the columns'
  presence bits (about 45% of the (query, chunk) pairs live at QC 256);
- `--kernel fused_disj` (F1, `es_fused_sweep_rowmax`), `--kernel
  fused_conj` (F2, `es_fused_sweep_rowmax_conj`, conj_inputs' queries
  weighted as for K7) and `--kernel fused_bitset` (F3's sweep,
  `es_fused_sweep_rowmax_bitset`, on masks made as for K6): the fused
  phase's shape, the shard as four partitions of 31 superwindows and Hpt
  97, each with its own slots (its 96 most frequent terms) and columns, at
  QC 256, 16 and 8 (`--qc` other QCs). Their `--ablate` adds
  `FUSED_ABLATIONS` (`--variants` some of them): variants of the parent's
  source (its sweep_group_kernel without the column loads, or without the
  coverage gate) and of this tree's, each running fused_sweep_kernel at
  every QC (`cluster`: as built; its cluster size, tile, ring depth, and
  timed-only variants without the copies, the scoring or the gates;
  `trace` its phase stamps). Each case also prints the cluster kernel's
  work on its inputs (`fused_stage_work`: staged and direct queries,
  batches, union slots, stages copied and skipped, bytes copied; F2: the
  stages in which no query of the batch keeps a doc).

    python -m elasticsearch_tpu_torch.tools.k2_ab --parent OLD.cu \\
        [--kernel disj|conj|bitset|fused_disj|fused_conj|fused_bitset] \\
        [--ablate] \\
        [--variants cluster,trace] [--qc 256,128,16] [--reps 20] \\
        [--out FILE]

`--parent` is a source with the same C entry (for example
`git show HEAD~1:elasticsearch_tpu_torch/parallel/csrc/sweep_rowmax.cu`);
`--ablate` adds the `ABLATIONS` variants of this tree's source, those named
`x-...` timed only (their outputs are not the kernel's). All are built with
nvcc and the flags of `cuda_build` into the gitignored build directory.
Every other output must equal the plain torch version bitwise; any
difference fails the run (each checked output is first filled with NaN
and -1). Times are CUDA-event medians, taken in turns (parent, variants,
this tree, this tree, variants, parent), and the kernel alone from
torch.profiler's kernel events (`kernel_ms`). Prints one JSON object
last.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from elasticsearch_tpu_torch.parallel import cuda_build
from elasticsearch_tpu_torch.parallel import kernels as k
from elasticsearch_tpu_torch.tools.k9_ab import (build, cuda_ms, kernel_alone,
                                                 parent_entry)

NSW = 123                # 8,060,928 docs: config 1's 8M-doc shard
HPT = 225
VOCAB = 500_000

_P, _I = ctypes.c_void_p, ctypes.c_int

# Variants of this tree's source, each a list of (text, replacement):
# G8 / G32 set the group size, intpath scores every query on the integer
# path (int32 sums, a conversion instruction per sum), all with the same
# outputs (checked). Timed only: x-noselect drops the selection rounds,
# x-noload the column loads, x-nomath the float path's byte conversions
# and fmas, x-nocov K7's coverage gate and x-nomask K6's mask gate (every
# live doc passes).
ABLATIONS = {
    "G8": [("constexpr int G = 16;", "constexpr int G = 8;")],
    "G32": [("constexpr int G = 16;", "constexpr int G = 32;")],
    "intpath": [("return 16512LL * sum_a + 128LL * sum_b < (1LL << 24) "
                 "&& qs > 0.f;", "return false;")],
    "x-noselect": [("for (int p = 0; p < NCAND; ++p) {",
                    "for (int p = 0; p < 0; ++p) {")],
    "x-noload": [("  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));",
                  "  const unsigned x = (unsigned)(uintptr_t)p;\n"
                  "  const uint4 v = make_uint4(x, x >> 3, x >> 5, x >> 7);")],
    "x-nomath": [("""        const float hf = byte_f(hb, j), lf = byte_f(lb, j);
        y[d] = __fmaf_rn(hf, wa, y[d]);
        y[d] = __fmaf_rn(lf, wb, y[d]);
        z[d] = __fmaf_rn(lf, wl, z[d]);""",
                  "        y[d] += __uint_as_float(hb ^ lb) * wa;")],
    "x-nocov": [("            gate &= cover_bits(ent + c0, s_wp + s_off[j]"
                 " + c0, n - c0, hi,\n                               lo, "
                 "s_need[j]);", "            gate += 0 * c0;")],
    "x-nomask": [("            gate &= mask_bits(mask",
                  "            gate |= 0u * mask_bits(mask")],
}
# The trace variant's stamps: the first cluster's rank 0 writes
# %globaltimer at its phase boundaries into f_trace (stamp 0 at the start,
# 1 after the own lists, 2 after the set-up; a superwindow n from 8 + 6 n:
# its alive bits, +2 the producer's last stage, +1 the staged queries, +3
# the row maxima gathered, +4 its selection), read by es_fused_trace
_TRACE_DEFS = """constexpr int F_TRACE_N = 64;
__device__ unsigned long long f_trace[F_TRACE_N];

__device__ __forceinline__ void trace_at(int i) {
  if (i >= F_TRACE_N || (blockIdx.x | blockIdx.y | blockIdx.z)) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  f_trace[i] = t;
}

"""
_TRACE_ENTRY = """extern "C" int es_fused_trace(void* out) {
  return cudaMemcpyFromSymbol(out, f_trace, sizeof(f_trace)) == cudaSuccess
             ? F_TRACE_N : -1;
}

"""


def _after(anchor, text):
    return (anchor, anchor + text)


def _before(anchor, text):
    return (anchor, text + anchor)


TRACE = [
    _before("__device__ __forceinline__ void put_row(", _TRACE_DEFS),
    _after("  uint32_t fpar = 0, epar = 0, pend = 0;\n",
           "  int n_sw = 0;\n  if (tid == 0) trace_at(0);\n"),
    _after("        cluster.sync();                          // every rank's "
           "own region\n", "        if (tid == 0) trace_at(1);\n"),
    _before("      // ---- the cluster's superwindows of the partition",
            "      if (tid == 0) trace_at(2);\n"),
    _before("        // ---- 4. a stage a (row group, batch)",
            "        if (tid == 0) trace_at(8 + 6 * n_sw);\n"),
    _after("            pend = 0;\n",
           "            if (lane == 0) trace_at(8 + 6 * n_sw + 2);\n"),
    _before("        // ---- 5. the direct queries",
            "        if (tid == 0) trace_at(8 + 6 * n_sw + 1);\n"),
    _after("        cluster.sync();                        // every rank's "
           "row maxima\n", "        if (tid == 0) trace_at(8 + 6 * n_sw + 3);\n"),
    _after("        cluster.sync();     // no rank reads another's maxima "
           "after\n", "        if (tid == 0) trace_at(8 + 6 * n_sw + 4);\n"
           "        ++n_sw;\n"),
    _before('extern "C" int es_fused_max_parts()', _TRACE_ENTRY),
]
# this tree's F1 and F3 from QC 1 on: the cluster kernel at every QC (below
# kernels.FUSED_MIN_QC the build runs sweep_group_kernel)
ALL_QC = [(f"constexpr int F_MIN_QC = {k.FUSED_MIN_QC};",
           "constexpr int F_MIN_QC = 1;"),
          (f"constexpr int F_MIN_QC_BITSET = {k.FUSED_MIN_QC_BITSET};",
           "constexpr int F_MIN_QC_BITSET = 1;"),
          (f"constexpr int F_MIN_QC_CONJ = {k.FUSED_MIN_QC_CONJ};",
           "constexpr int F_MIN_QC_CONJ = 1;")]
# F2's consumers in two passes over a staged query's list: the gate from
# its coverage entries (cover_staged), then its score entries under the
# gate's byte mask, none where the warp's four rows keep no doc
_COVER_STAGED = """// The coverage gate (CONJ) over the thread's DPT docs of a row from a
// stage: bit d set where cov = sum wp * present equals need, present =
// (hi | lo) != 0 from the staged bytes (cover_bits' test: bit 7 of
// ((x & 0x7F) + 0x7F) | x). A word's four docs sum as two 16-bit fields
// of two int32s (docs 0 and 2, docs 1 and 3), two imads a word and entry;
// exact: a staged list holds at most 255 entries of |wp| <= 128, so each
// field's |cov| <= 32640 < 2^15 and no int32 partial sum overflows.
__device__ __forceinline__ unsigned cover_staged(const uint32_t* ent,
                                                 const int8_t* wps, int n,
                                                 const unsigned char* st,
                                                 int need) {
  int ev[NW], od[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    ev[w] = 0;
    od[w] = 0;
  }
  for (int k = 0; k < n; ++k) {
    const unsigned char* p = st + (ent[k] & 0xFFFF) * F_SLOT_BYTES;
    const uint4 h = *reinterpret_cast<const uint4*>(p);
    const uint4 l = *reinterpret_cast<const uint4*>(p + F_R * 128);
    const int c = wps[k];
    const unsigned x[NW] = {h.x | l.x, h.y | l.y, h.z | l.z, h.w | l.w};
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const unsigned b7 = ((x[w] & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x[w];
      ev[w] += c * (int)((b7 >> 7) & 0x00010001u);
      od[w] += c * (int)((b7 >> 15) & 0x00010001u);
    }
  }
  unsigned g = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int c0 = (short)ev[w], c2 = (ev[w] - c0) >> 16;
    const int c1 = (short)od[w], c3 = (od[w] - c1) >> 16;
    g |= ((unsigned)(c0 == need) | ((unsigned)(c1 == need) << 1)
          | ((unsigned)(c2 == need) << 2) | ((unsigned)(c3 == need) << 3))
         << (4 * w);
  }
  return g;
}

"""
TWO_PASS = [
    _before("// a float-path row max of pre (bits) as a val's bits",
            _COVER_STAGED),
    ("""                    m = docs_conj_staged(list + info.z, lwp + info.z, cx.x,
                                         cx.y, info.y, st, a16, cx.z);""",
     """                    const unsigned gate =
                        a16 & cover_staged(list + info.z + cx.y,
                                           lwp + info.z + cx.y,
                                           info.y - cx.y, st, cx.z);
                    m = __any_sync(FULL, gate != 0u)
                            ? docs_staged(list + info.z, cx.x, st,
                                          gate_words(gate))
                            : 0;"""),
]
# F2's one-pass consumers as one loop over a staged query's list, whose
# body tests which parts the entry is in
_LOOP_TREE = """  int k = 0;
  for (; k < c0; ++k) {"""
ONE_LOOP = [
    (_LOOP_TREE, """  for (int k = 0; k < n; ++k) {
    const uint32_t e = ent[k];
    uint4 h, l;
    stage(e, h, l);
    if (k < ns) score_entry(t, h, l, (int)e >> 16);
    if (k >= c0) cover_entry(ev, od, h, l, wps[k]);
  }
  for (int k = 0; k < 0; ++k) {"""),
    ("  for (; k < ns; ++k) {", "  for (int k = 0; k < 0; ++k) {"),
    ("  for (; k < n; ++k) {", "  for (int k = 0; k < 0; ++k) {"),
]
# F1-F3's variants: (source: "parent" or "tree", edits); every tree
# variant runs the cluster kernel at every QC. p-x-noload is the parent's
# sweep_group_kernel without its column loads, p-x-nocover without F2's
# coverage gate (every live doc passes; both timed only); cluster this
# tree's kernel as it is; CL4 a cluster of 4 blocks (128 rows each), GQ the
# other tile size (F1 128 queries, F3 and F2 256), ST2 a ring of at most 2
# stages, CW31 31 consumer warps (a budget of 64 registers a thread against
# 128) (outputs checked); x-nocopy stages nothing (the consumers score
# whatever the ring holds), x-noscore scores nothing, x-nomask gates F3's
# docs by live alone, x-nocover F2's (timed only); TWO scores F2's staged
# queries in two passes (TWO_PASS), ONELOOP in one loop (ONE_LOOP); trace
# stamps the phases of the first cluster's rank 0 (TRACE, es_fused_trace,
# printed)
FUSED_ABLATIONS = {
    "p-x-noload": ("parent", ABLATIONS["x-noload"]),
    "p-x-nocover": ("parent", ABLATIONS["x-nocov"]),
    "cluster": ("tree", ALL_QC),
    "CL4": ("tree", ALL_QC + [("constexpr int F_CL = 8;",
                               "constexpr int F_CL = 4;")]),
    "GQ": ("tree", ALL_QC + [("constexpr int F_GQ = 256;",
                              "constexpr int F_GQ = 128;"),
                             ("constexpr int F_GQ_BITSET = 128;",
                              "constexpr int F_GQ_BITSET = 256;"),
                             ("constexpr int F_GQ_CONJ = 128;",
                              "constexpr int F_GQ_CONJ = 256;")]),
    "ST2": ("tree", ALL_QC + [("constexpr int F_MAX_ST = 8;",
                               "constexpr int F_MAX_ST = 2;")]),
    "x-nocopy": ("tree", ALL_QC + [("for (int u = 0; u < nu; ++u) {",
                                    "for (int u = 0; u < 0; ++u) {")]),
    "x-noscore": ("tree", ALL_QC + [
        ("  return max(t[0], 0);", "  return n + 0 * t[0];")]),
    "x-nomask": ("tree", ALL_QC + [
        ("const unsigned gate = a16 & mask_gate(mw, row & 31);",
         "const unsigned gate = a16;")]),
    "x-nocover": ("tree", ALL_QC + [
        ("    ev[w] += c * (int)((b7 >> 7) & 0x00010001u);\n"
         "    od[w] += c * (int)((b7 >> 15) & 0x00010001u);",
         "    ev[w] += 0 * c * (int)b7;")]),
    "TWO": ("tree", ALL_QC + TWO_PASS),
    "ONELOOP": ("tree", ALL_QC + ONE_LOOP),
    "CW31": ("tree", ALL_QC + [("constexpr int F_CW = 15;",
                                "constexpr int F_CW = 31;")]),
    "trace": ("tree", ALL_QC + TRACE),
}
FUSED_PARTS = 4
FUSED_NSW = 31           # a 2M-doc partition of the 8M-doc shard
FUSED_HPT = 97

# each kernel's C entry, its count of input pointers and its name in
# cuda_build; the pointers come in the order of the wrapper's positional
# arguments, then (out_m, out_r, qc, hpt, nsw, stream)
ENTRIES = {"disj": ("es_sweep_rowmax", 5, "sweep_rowmax"),
           "conj": ("es_sweep_rowmax_conj", 7, "sweep_rowmax_conj"),
           "bitset": ("es_sweep_rowmax_bitset", 6, "sweep_rowmax_bitset")}
WRAPPERS = {"disj": (k.sweep_rowmax, k.sweep_rowmax_plain),
            "conj": (k.sweep_rowmax_conj, k.sweep_rowmax_conj_plain),
            "bitset": (k.sweep_rowmax_bitset, k.sweep_rowmax_bitset_plain)}


def ablated_sources(out_dir: Path, variants=None, parent=None):
    """Write each variant (default ABLATIONS, all of this tree's
    sweep_rowmax.cu; FUSED_ABLATIONS name their source, `parent` the
    parent's file) into out_dir; returns {name: path}."""
    tree = (cuda_build.CSRC / "sweep_rowmax.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, spec in (variants or ABLATIONS).items():
        base, edits = spec if isinstance(spec, tuple) else ("tree", spec)
        text = Path(parent).read_text() if base == "parent" else tree
        for old, new in edits:
            if old not in text:
                raise ValueError(f"ablation {name}: text not in the source")
            text = text.replace(old, new)
        paths[name] = out_dir / f"k2_{name}.cu"
        paths[name].write_text(text)
    return paths


def _argtypes(kernel: str):
    return [_P] * (ENTRIES[kernel][1] + 2) + [_I] * 3 + [_P]


def entry(lib: ctypes.CDLL, kernel: str = "disj"):
    fn = getattr(lib, ENTRIES[kernel][0])
    fn.argtypes = _argtypes(kernel)
    fn.restype = ctypes.c_int
    return fn


def run_raw(fn, args, nsw: int, poison: bool = False):
    """One call of a built sweep entry (`entry`) on the wrapper's
    positional tensors `args` with the wrapper's allocations; `poison`
    fills the outputs with NaN and -1 first (kernels.poisoned), so a check
    never reads an earlier call's results from reused memory."""
    qc = int(args[0].shape[0])
    hi = next(a for a in args if a.dim() == 4)
    with k.poisoned() if poison else contextlib.nullcontext():
        rm, rr = k._sweep_out(nsw, qc, hi.device)
    rc = fn(*(a.data_ptr() for a in args), rm.data_ptr(), rr.data_ptr(), qc,
            int(hi.shape[1]), nsw, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sweep launch failed: cudaError {rc}")
    return rm, rr


def parent_runner(path, kernel: str = "disj"):
    """run(args, nsw, poison=False) -> (rowmax, rows) of an earlier
    sweep_rowmax.cu's entry for `kernel` (run_raw), built from `path`, or
    None when `path` is not a file."""
    fn = parent_entry(path, "k2_parent", ENTRIES[kernel][0],
                      _argtypes(kernel))
    if fn is None:
        return None
    return lambda args, nsw, poison=False: run_raw(fn, args, nsw, poison)


def sweep_work(wq_np: np.ndarray, dp: int, nsw: int, wp_np=None,
               nreq_np=None):
    """The work a sweep's bound counts for these inputs: each union slot's
    two column layers (K7: every slot with a score or coverage weight),
    live, the weights and the outputs moved once, and four int8
    multiply-adds (8 operations) per (nonzero weight, doc), K7 a fifth
    product for coverage (10). Returns (bytes, int8 operations, union
    slots, nonzero weights); chip_smoke.py turns the first two into its
    bound with the card's peak rates."""
    nz = (wq_np != 0).any(axis=0)                     # [QC, Hpt]
    per_doc, extra = 8, 0
    if wp_np is not None:
        nz = nz | (wp_np != 0)
        per_doc, extra = 10, wp_np.nbytes + nreq_np.nbytes
    n_union, nnz = int(nz.any(axis=0).sum()), int(nz.sum())
    qc = wq_np.shape[1]
    nbytes = (n_union * 2 * dp + dp * 4 + wq_np.nbytes + qc * 4 + extra
              + 2 * nsw * qc * k.CAND_PAD * 4)
    return nbytes, nnz * per_doc * dp, n_union, nnz


def bitset_work(wq_np: np.ndarray, mask, nsw: int):
    """The work K6's bound counts: the union slots' columns only in chunks
    where a query weighting the slot has a surviving bit, live in chunks
    any query keeps, the masks of queries with a score weight (the others
    read none), the weights and the outputs moved once, and 8 operations
    per (nonzero weight, doc of a live chunk). `mask` is K5's [QC, nsw *
    16, 128] i32 output. Returns (bytes, int8 operations, {live_chunks,
    chunks, scored_queries, nonzero_weights})."""
    qc = wq_np.shape[1]
    lo = ((mask & 0xFFFF) != 0).any(dim=-1)
    hi = (((mask >> 16) & 0xFFFF) != 0).any(dim=-1)
    live_c = torch.stack([lo, hi], dim=-1).reshape(qc, -1).cpu().numpy()
    nz = (wq_np != 0).any(axis=0)                           # [QC, Hpt]
    col_bytes = 0
    for slot in np.nonzero(nz.any(axis=0))[0]:
        col_bytes += int(live_c[nz[:, slot]].any(axis=0).sum()) * k.CHUNK * 2
    any_live = int(live_c.any(axis=0).sum())
    scored = int(nz.any(axis=1).sum())
    nbytes = (col_bytes + any_live * k.CHUNK * 4
              + scored * mask[0].numel() * 4 + wq_np.nbytes + qc * 4
              + 2 * nsw * qc * k.CAND_PAD * 4)
    ops = int((nz.sum(axis=1) * live_c.sum(axis=1)).sum()) * k.CHUNK * 8
    return nbytes, ops, {"live_chunks": int(live_c.sum()),
                         "chunks": int(live_c.size),
                         "scored_queries": scored,
                         "nonzero_weights": int(nz.sum())}


def _columns(ranks, p, slot_of, g, nsw=NSW, hpt=HPT):
    """hi / lo columns on the card for the terms of rank `ranks`: a column
    of rank r holds a doc with the chance a 24-term doc holds the term
    (90% at rank 1, under 1% at rank 224), hi 1..127 and lo -64..64 where
    it does."""
    dev = torch.device("cuda")
    dpc = nsw * k.N_CHUNKS
    hi = torch.zeros((dpc, hpt, 16, 128), dtype=torch.int8, device=dev)
    lo = torch.zeros_like(hi)
    for r in np.unique(ranks):
        d = 1.0 - (1.0 - p[r]) ** 24
        present = torch.rand((dpc, 16, 128), device=dev, generator=g) < d
        h = torch.randint(1, 128, (dpc, 16, 128), device=dev, generator=g,
                          dtype=torch.int8)
        lw = torch.randint(-64, 65, (dpc, 16, 128), device=dev, generator=g,
                           dtype=torch.int8)
        hi[:, slot_of[r]] = torch.where(present, h, 0)
        lo[:, slot_of[r]] = torch.where(present, lw, 0)
        del present, h, lw
    return hi, lo


def _live(g, nsw=NSW):
    """2% of docs dead."""
    return (torch.rand((nsw * k.SW_ROWS, 128), device=torch.device("cuda"),
                       generator=g) > 0.02).float()


def inputs(qc: int, seed: int = 0):
    """Config 1's K2 inputs on the card. Queries of two terms drawn as
    chip_smoke.py draws them (Zipf(1.07) over a 500k-term vocabulary); a
    term among the Hpt - 1 most frequent has a device column, the rest are
    cold (K3's) and carry no weight here. Columns as `_columns` makes
    them, live as `_live`. Weights as the engine quantizes them. Returns
    ((qscale, hi, lo, wq, live), (wq,) as numpy)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    p /= p.sum()
    slot_of = rng.permutation(HPT - 1)                # rank -> slot
    terms = rng.choice(VOCAB, size=(256, 2), p=p)
    wq = np.zeros((2, 256, HPT), np.int8)
    for q, r in zip(*np.nonzero(terms < HPT - 1)):
        s = slot_of[terms[q, r]]
        wq[0, q, s] = rng.integers(1, 128)
        wq[1, q, s] = rng.integers(-127, 128)
    hi, lo = _columns(terms[terms < HPT - 1], p, slot_of, g)
    live = _live(g)
    wq = np.ascontiguousarray(wq[:, :qc])
    qscale = rng.uniform(1e-5, 1e-3, size=(qc, 1)).astype(np.float32)
    args = (torch.from_numpy(qscale).to(dev), hi, lo,
            torch.from_numpy(wq).to(dev), live)
    return args, (wq,)


def conj_inputs(qc: int, seed: int = 0):
    """Config 2's K7 inputs on the card: chip_smoke.py's device chunk of
    draw_bool, the heavy conjunctions (two musts among the 100 most
    frequent terms, each +1 coverage and a score weight; the mid-rank
    should has no device column), in the first half of QC, the rest
    padding (all zero, qscale 1, nreq 0). One query in four also has a
    head-term filter (+1 coverage, no score weight), one in eight a
    head-term must_not (-(nreq + 1)), as the DSL bodies do. Columns and
    live as for K2. Returns ((qscale, nreq, hi, lo, wq, wp, live), (wq,
    wp, nreq) as numpy)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    p /= p.sum()
    slot_of = rng.permutation(HPT - 1)
    n_act = max(1, qc // 2)
    heads = rng.integers(0, 100, size=(n_act, 4))
    wq = np.zeros((2, qc, HPT), np.int8)
    wp = np.zeros((qc, HPT), np.int8)
    nreq = np.zeros((qc, 1), np.int32)
    qscale = np.ones((qc, 1), np.float32)
    for q in range(n_act):
        req = {int(slot_of[r]) for r in heads[q, :2]}
        for s in req:
            wq[0, q, s] = rng.integers(1, 128)
            wq[1, q, s] = rng.integers(-127, 128)
        if q % 4 == 1:
            req.add(int(slot_of[heads[q, 2]]))       # a filter
        for s in req:
            wp[q, s] = 1
        nreq[q, 0] = len(req)
        mn = int(slot_of[heads[q, 3]])
        if q % 8 == 3 and mn not in req:
            wp[q, mn] = -(len(req) + 1)              # a must_not
        qscale[q, 0] = rng.uniform(1e-5, 1e-3)
    hi, lo = _columns(heads.ravel(), p, slot_of, g)
    live = _live(g)
    args = tuple(torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                 else a for a in (qscale, nreq, hi, lo, wq, wp, live))
    return args, (wq, wp, nreq)


def bitset_inputs(qc: int, seed: int = 0):
    """Config 2's K6 inputs on the card: conj_inputs' queries, columns and
    live, each query gated by its mask as K5 makes it, the AND of its
    required slots' presence bits (pack_presence_bits) AND-NOT its
    must_not's; padding queries' masks all zero. Returns ((qscale, hi, lo,
    wq, mask, live), (wq, mask))."""
    (qscale, _, hi, lo, wq_t, _, live), (wq, wp, _) = conj_inputs(qc, seed)
    bits = k.pack_presence_bits(hi, lo)[:, : NSW * k.SW_WORD_ROWS]
    mask = torch.zeros((qc, NSW * k.SW_WORD_ROWS, 128), dtype=torch.int32,
                       device=hi.device)
    for q in np.nonzero((wp != 0).any(axis=1))[0]:
        m = torch.full_like(mask[0], -1)
        for s in np.nonzero(wp[q] > 0)[0]:
            m &= bits[s]
        for s in np.nonzero(wp[q] < 0)[0]:
            m &= ~bits[s]
        mask[q] = m
    del bits
    return (qscale, hi, lo, wq_t, mask, live), (wq, mask)


def fused_inputs(qc: int, kernel: str = "fused_disj", seed: int = 0):
    """F1's (fused_disj), F2's (fused_conj) or F3's sweep's (fused_bitset)
    inputs on the card at the fused phase's shape: FUSED_PARTS partitions
    of FUSED_NSW superwindows and Hpt FUSED_HPT, each holding its
    FUSED_HPT - 1 most frequent terms in slots of its own order, with
    columns and live as `_columns` / `_live` make them. fused_disj:
    inputs()'s two-term queries; fused_conj and fused_bitset:
    conj_inputs()'s (the heavy conjunctions, then padding), weighted for
    coverage as conj_inputs() weights them (fused_conj) or gated by a mask
    as bitset_inputs() makes it (fused_bitset). Made at QC 256 and cut to
    the first `qc` queries. Returns a dict: qscale [S, QC, 1], wq [S, 2,
    QC, Hpt], lists hi, lo, live, nsw, nreq [S, QC, 1] and wp [S, QC, Hpt]
    (fused_conj), mask [S, QC, nsw * 16, 128] (fused_bitset), and the
    weights as numpy per partition (wq_np, wp_np, nreq_np)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    p /= p.sum()
    hp, n = FUSED_HPT - 1, 256
    if kernel == "fused_disj":
        terms = rng.choice(VOCAB, size=(n, 2), p=p)
    else:
        heads = rng.integers(0, min(100, hp), size=(n // 2, 4))
    out = {"qscale": [], "wq": [], "hi": [], "lo": [], "live": [],
           "nsw": [FUSED_NSW] * FUSED_PARTS, "mask": [], "wp": [],
           "nreq": []}
    for _ in range(FUSED_PARTS):
        slot_of = rng.permutation(hp)
        wq = np.zeros((2, n, FUSED_HPT), np.int8)
        qs = rng.uniform(1e-5, 1e-3, size=(n, 1)).astype(np.float32)
        if kernel == "fused_disj":
            for q, r in zip(*np.nonzero(terms < hp)):
                s = slot_of[terms[q, r]]
                wq[0, q, s] = rng.integers(1, 128)
                wq[1, q, s] = rng.integers(-127, 128)
            ranks = terms[terms < hp]
        else:
            req_of, neg_of = [], []
            for q in range(n // 2):
                req = {int(slot_of[r]) for r in heads[q, :2]}
                for s in req:
                    wq[0, q, s] = rng.integers(1, 128)
                    wq[1, q, s] = rng.integers(-127, 128)
                if q % 4 == 1:
                    req.add(int(slot_of[heads[q, 2]]))    # a filter
                mn = int(slot_of[heads[q, 3]])
                req_of.append(sorted(req))
                neg_of.append([mn] if q % 8 == 3 and mn not in req else [])
            qs[n // 2:] = 1.0
            ranks = heads.ravel()
        hi, lo = _columns(ranks, p, slot_of, g, FUSED_NSW, FUSED_HPT)
        live = _live(g, FUSED_NSW)
        wq = np.ascontiguousarray(wq[:, :qc])
        if kernel == "fused_conj":
            wp = np.zeros((qc, FUSED_HPT), np.int8)
            nreq = np.zeros((qc, 1), np.int32)
            for q in range(min(qc, n // 2)):
                wp[q, req_of[q]] = 1
                wp[q, neg_of[q]] = -(len(req_of[q]) + 1)
                nreq[q, 0] = len(req_of[q])
            out["wp"].append(wp)
            out["nreq"].append(nreq)
        out["qscale"].append(qs[:qc])
        out["wq"].append(wq)
        out["hi"].append(hi)
        out["lo"].append(lo)
        out["live"].append(live)
        if kernel == "fused_bitset":
            bits = k.pack_presence_bits(hi, lo)[:, : FUSED_NSW
                                                * k.SW_WORD_ROWS]
            mask = torch.zeros((qc, FUSED_NSW * k.SW_WORD_ROWS, 128),
                               dtype=torch.int32, device=dev)
            for q in range(min(qc, n // 2)):
                m = torch.full_like(mask[0], -1)
                for s in req_of[q]:
                    m &= bits[s]
                for s in neg_of[q]:
                    m &= ~bits[s]
                mask[q] = m
            del bits
            out["mask"].append(mask)
    out["qscale"] = torch.from_numpy(np.stack(out["qscale"])).to(dev)
    out["wq_np"] = out["wq"]
    out["wq"] = torch.from_numpy(np.stack(out["wq"])).to(dev)
    out["wp_np"], out["nreq_np"] = out["wp"], out["nreq"]
    if out["wp"]:
        out["wp"] = torch.from_numpy(np.stack(out["wp"])).to(dev)
        out["nreq"] = torch.from_numpy(np.stack(out["nreq"])).to(dev)
    if out["mask"]:
        out["mask"] = torch.stack(out["mask"])
    return out


_FUSED_ENTRIES = {"fused_disj": ("es_fused_sweep_rowmax", "fused_sweep_rowmax",
                                 [_P, _I] + [_P] * 4 + [_I, _I, _I, _P]),
                  "fused_conj": ("es_fused_sweep_rowmax_conj",
                                 "fused_sweep_rowmax_conj",
                                 [_P, _I] + [_P] * 6 + [_I, _I, _I, _P]),
                  "fused_bitset": ("es_fused_sweep_rowmax_bitset",
                                   "fused_sweep_rowmax_bitset",
                                   [_P, _I] + [_P] * 5 + [_I, _I, _I, _P])}


def fused_entry(lib: ctypes.CDLL, kernel: str):
    fn = getattr(lib, _FUSED_ENTRIES[kernel][0])
    fn.argtypes = _FUSED_ENTRIES[kernel][2]
    fn.restype = ctypes.c_int
    return fn


def fused_runner(f, kernel: str):
    """run(fn, poison=False, outs=None) -> (rowmax, rows) [S, nsw, QC,
    CAND_PAD]: one launch of a fused C entry (`fused_entry`, this tree's or
    an earlier one's, the same arguments) on `f` (fused_inputs), into
    `outs` or new outputs (poison: filled with NaN and -1 first)."""
    n, qc = len(f["hi"]), int(f["wq"].shape[2])
    nsw_max = max(f["nsw"])
    ws = int(f["wq"].shape[3])
    table = k._sweep_table(f["hi"], f["lo"], f["live"], f["nsw"],
                           [int(h.shape[1]) for h in f["hi"]])
    ins = [f["qscale"].data_ptr(), f["wq"].data_ptr()]
    if kernel == "fused_conj":
        ins = [f["qscale"].data_ptr(), f["nreq"].data_ptr(),
               f["wq"].data_ptr(), f["wp"].data_ptr()]
    if kernel == "fused_bitset":
        ins.append(f["mask"].data_ptr())

    def run(fn, poison=False, outs=None):
        if outs is None:
            with k.poisoned() if poison else contextlib.nullcontext():
                rm, rr, _ = k._fused_sweep_out(n, nsw_max, qc,
                                               f["wq"].device)
        else:
            rm, rr = outs
        rc = fn(table.ctypes.data, n, *ins, rm.data_ptr(), rr.data_ptr(),
                qc, ws, nsw_max, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused launch failed: cudaError {rc}")
        return rm, rr
    return run


def fused_plain(f, kernel: str):
    """Each partition's plain K2 / K7 / K6 rows, stacked as the fused
    output."""
    ms, rs = [], []
    for i in range(len(f["hi"])):
        a = (f["qscale"][i], f["hi"][i], f["lo"][i], f["wq"][i])
        if kernel == "fused_disj":
            m, r = k.sweep_rowmax_plain(*a, f["live"][i], nsw=f["nsw"][i])
        elif kernel == "fused_conj":
            m, r = k.sweep_rowmax_conj_plain(
                f["qscale"][i], f["nreq"][i], f["hi"][i], f["lo"][i],
                f["wq"][i], f["wp"][i], f["live"][i], nsw=f["nsw"][i])
        else:
            m, r = k.sweep_rowmax_bitset_plain(*a, f["mask"][i], f["live"][i],
                                               nsw=f["nsw"][i])
        ms.append(m)
        rs.append(r)
    return torch.stack(ms), torch.stack(rs)


def _kept_groups(mask, nsw: int):
    """[QC, nsw, 512 / FUSED_STAGE_ROWS] bool on the card: a query's K5
    mask (its [QC, nsw_max * 16, 128] words) keeps some row of the row
    group in the superwindow (bit r % 32 of some word of word row r / 32),
    as fused_sweep_kernel's keep words and chunk skip read it."""
    m = mask[:, :nsw * k.SW_WORD_ROWS]
    while m.shape[-1] > 1:                     # OR of the row's 128 words
        h = m.shape[-1] // 2
        m = m[..., :h] | m[..., h:]
    bits = torch.arange(32, device=m.device, dtype=torch.int32)
    rows = ((m >> bits) & 1).bool()             # [QC, nsw * 16, 32]
    rows = rows.reshape(m.shape[0], nsw, k.SW_ROWS)
    return rows.reshape(m.shape[0], nsw, -1, k.FUSED_STAGE_ROWS).any(-1)


def _gate_groups(hi, lo, live, wp, nreq, nsw: int):
    """[QC, nsw, 512 / FUSED_STAGE_ROWS] bool on the inputs' device: some
    live doc of the row group passes the query's coverage gate in the
    superwindow (cov = sum wp * ((hi | lo) != 0) == nreq, K7's), a
    superwindow at a time. wp [QC, ws], nreq [QC, 1]."""
    hpt = int(hi.shape[1])
    w = wp[:, :hpt].float()
    out = []
    for sw in range(nsw):
        c = slice(sw * k.N_CHUNKS, (sw + 1) * k.N_CHUNKS)
        pres = ((hi[c] != 0) | (lo[c] != 0)).permute(1, 0, 2, 3)
        cov = w @ pres.reshape(hpt, -1).float()           # exact integers
        ok = (cov == nreq.float()) & (live[sw * k.SW_ROWS:(sw + 1)
                                           * k.SW_ROWS].reshape(1, -1) > 0)
        out.append(ok.reshape(ok.shape[0], -1, k.FUSED_STAGE_ROWS * 128)
                   .any(-1))
    return torch.stack(out, 1)


def fused_stage_work(qscale, wq, hpts, nsw, mask=None,
                     force: bool = False, conj=None) -> dict:
    """What fused_sweep_kernel does with a launch's inputs (F3 with `mask`,
    its K5 stage's output; F2 with `conj` = (nreq [S, QC, 1], wp [S, QC,
    ws], hi, lo, live)), from its plan (kernels.fused_sweep_plan,
    fused_batches) and the same selection: per tile the staged queries (a
    fast_query list within slot_cap, the rank's and the tile's lists
    within lc; F2's lists hold its score and coverage slots, none for a
    query with no score weight) and the direct ones, the batches and their
    union slots; per (partition, superwindow) the stages copied (row group,
    batch; F3 only where a query of the batch keeps a row of the group) and
    skipped, and the bytes they copy (union slots x 1 KB a stage). F2 also
    counts `dead_stages`, the stages in which no query of the batch keeps a
    doc through its coverage gate, and `dead_score_bytes`, what a design
    that staged those stages' coverage slots alone would not copy. `qscale`
    [S, QC, 1], `wq` [S, 2, QC, ws] (card or host), `hpts` and `nsw` per
    partition. Returns totals over the launch, {"cluster": False} where the
    launch runs sweep_group_kernel (`force`: what the cluster kernel would
    do)."""
    S, qc = int(wq.shape[0]), int(wq.shape[2])
    mode = "bitset" if mask is not None else "conj" if conj else "disj"
    plan = k.fused_sweep_plan(qc, max(hpts), mode)
    if not plan["cluster"] and not force:
        return {"cluster": False}

    def host(a):
        return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

    wq_np = host(wq)
    qs_np = host(qscale).reshape(S, qc)
    wp_np = None if not conj else host(conj[1])
    cl, n_g = k.FUSED_CLUSTER, k.SW_ROWS // k.FUSED_STAGE_ROWS
    tot = {"cluster": plan["cluster"], "tiles": 0, "staged": 0, "direct": 0,
           "batches": 0, "union_slots": [], "items": 0, "stages": 0,
           "skipped_stages": 0, "copy_bytes": 0}
    if conj:
        tot.update(dead_stages=0, dead_score_bytes=0)
    for z in range(S):
        hpt = hpts[z]
        wh = wq_np[z, 0, :, :hpt].astype(np.int64)
        wl = wq_np[z, 1, :, :hpt].astype(np.int64)
        kept = None if mask is None else _kept_groups(mask[z], nsw[z])
        alive = None if not conj else _gate_groups(
            conj[2][z], conj[3][z], conj[4][z], conj[1][z], conj[0][z],
            nsw[z])
        tot["items"] += nsw[z]
        for w0 in range(0, qc, plan["gq"]):
            ng = min(plan["gq"], qc - w0)
            lists, fast = [], []
            for q in range(w0, w0 + ng):
                sc = (wh[q] != 0) | (wl[q] != 0)
                if conj and sc.any():
                    sc = sc | (wp_np[z, q, :hpt] != 0)
                lists.append(np.nonzero(sc)[0])
                fast.append(16512 * np.abs(wh[q]).sum()
                            + 128 * np.abs(wl[q]).sum() < 2 ** 24
                            and qs_np[z, q] > 0)
            own_ok = {}
            for rank in range(cl):
                e = 0
                for j in range(rank, ng, cl):
                    n = len(lists[j])
                    ln = n if fast[j] and 0 < n <= plan["slot_cap"] else 0
                    e += ln
                    own_ok[j] = ln > 0 and e <= plan["lc"]
            staged, e = [], 0
            for j in range(ng):
                ln = len(lists[j]) if own_ok[j] else 0
                e += ln
                if ln and e <= plan["lc"]:
                    staged.append(j)
            tot["tiles"] += 1
            tot["staged"] += len(staged)
            tot["direct"] += sum(1 for j in range(ng)
                                 if len(lists[j]) and j not in staged)
            batches = k.fused_batches([lists[j] for j in staged],
                                      plan["slot_cap"])
            tot["batches"] += len(batches)
            for b in batches:
                union = set().union(*(set(lists[staged[t]].tolist())
                                      for t in b))
                nu = len(union)
                tot["union_slots"].append(nu)
                rows = torch.tensor([w0 + staged[t] for t in b])
                if kept is None:
                    n_st = nsw[z] * n_g
                else:
                    n_st = int(kept[rows.to(kept.device)].any(0).sum())
                tot["stages"] += n_st
                tot["skipped_stages"] += nsw[z] * n_g - n_st
                tot["copy_bytes"] += n_st * nu * 2 * k.FUSED_STAGE_ROWS * 128
                if conj:
                    dead = n_st - int(alive[rows.to(alive.device)].any(0)
                                      .sum())
                    cover = set().union(*(
                        set(np.nonzero(wp_np[z, w0 + staged[t], :hpt])[0]
                            .tolist()) for t in b))
                    tot["dead_stages"] += dead
                    tot["dead_score_bytes"] += (
                        dead * len(union - cover) * 2
                        * k.FUSED_STAGE_ROWS * 128)
    u = tot.pop("union_slots")
    tot["union_slots_mean"] = float(np.mean(u)) if u else 0.0
    tot["union_slots_max"] = int(max(u)) if u else 0
    tot["stages_per_item"] = tot["stages"] / max(tot["items"], 1)
    tot["skipped_per_item"] = tot["skipped_stages"] / max(tot["items"], 1)
    return tot


def launch_graph_ms(fn, reps: int = 50) -> float:
    """Device time of one call of fn from a CUDA graph of it replayed `reps`
    times between two events (no host between launches)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    gr = torch.cuda.CUDAGraph()
    with torch.cuda.graph(gr):
        fn()
    gr.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        gr.replay()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


FUSED_MODE = {"fused_disj": "disj", "fused_conj": "conj",
              "fused_bitset": "bitset"}


def fused_main(args) -> int:
    """The A/B of F1, F2 or F3's sweep (see the module's note)."""
    kern = args.kernel
    mode = FUSED_MODE[kern]
    cuda_build.build_all()
    for line in cuda_build.BUILD_LOG.get("sweep_rowmax", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas sweep_rowmax: {line.strip()}", flush=True)
    others = {"parent": fused_entry(build("k2_parent", args.parent), kern)}
    if args.ablate or args.variants:
        chosen = (args.variants.split(",") if args.variants
                  else list(FUSED_ABLATIONS))
        for name, path in ablated_sources(
                cuda_build.BUILD_DIR / "ablate",
                {n: FUSED_ABLATIONS[n] for n in chosen},
                args.parent).items():
            others[name] = fused_entry(build(f"k2_{name}", path), kern)
    own = cuda_build.kernel(_FUSED_ENTRIES[kern][1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report = {"card": smi, "kernel": kern, "reps": args.reps, "cases": []}
    old_kernel = {n for n in others
                  if n == "parent" or FUSED_ABLATIONS.get(n, ("",))[0]
                  == "parent"}
    for qc in args.qc:
        f = fused_inputs(qc, kern)
        run = fused_runner(f, kern)
        fns = {"current": own, **others}
        outs = {n: run(fns[n]) for n in fns}

        def call(n):
            return lambda: run(fns[n], outs=outs[n])

        order = list(others) + ["current", "current"] + list(others)[::-1]
        times = {n: [] for n in order}
        graph = {n: [] for n in order}
        for n in order:
            times[n].append(cuda_ms(call(n), args.reps))
            graph[n].append(launch_graph_ms(call(n)))
        # the checks: every output written over NaN / -1
        pm, pr = fused_plain(f, kern)
        for n in fns:
            if n.startswith("x-") or n.startswith("p-x-"):
                continue
            m, r = run(fns[n], poison=True)
            if not (torch.equal(m, pm) and torch.equal(r, pr)):
                raise AssertionError(f"{n} differs from the plain {kern} "
                                     f"sweep at QC {qc}")
        nbytes = ops = 0
        work = {}
        for i in range(len(f["hi"])):
            if kern != "fused_bitset":
                b, o, nu, nnz = sweep_work(
                    f["wq_np"][i], int(f["live"][i].numel()), f["nsw"][i],
                    *((f["wp_np"][i], f["nreq_np"][i])
                      if kern == "fused_conj" else ()))
                work.setdefault("union_slots", []).append(nu)
                work.setdefault("nonzero_weights", []).append(nnz)
            else:
                b, o, w = bitset_work(f["wq_np"][i], f["mask"][i],
                                      f["nsw"][i])
                for key, v in w.items():
                    work.setdefault(key, []).append(v)
            nbytes += b
            ops += o
        if "trace" in others:           # the stamps of one launch, in us
            lib = build("k2_trace", cuda_build.BUILD_DIR / "ablate"
                        / "k2_trace.cu")
            run(fns["trace"], outs=outs["trace"])
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 64)()
            if lib.es_fused_trace(ctypes.byref(buf)) > 0:
                t0 = buf[0]
                print("trace", qc, [round((x - t0) / 1e3, 1) if x else None
                                    for x in buf], flush=True)
        plan = k.fused_sweep_plan(qc, FUSED_HPT, mode)
        kernel_ms = {}
        for n in fns:
            # the parent's launch runs either kernel (its own thresholds)
            names = [("sweep_group_kernel",), ("fused_sweep_kernel",)]
            if not (n in old_kernel
                    or (n == "current" and not plan["cluster"])):
                names.reverse()
            kernel_ms[n] = kernel_alone(call(n), names=names[0])[0]
            if kernel_ms[n] is None and n in old_kernel:
                kernel_ms[n] = kernel_alone(call(n), names=names[1])[0]
        # the cluster kernel's work on these inputs (this tree's launch
        # below FUSED_MIN_QC runs sweep_group_kernel; its variants do not)
        stage_work = fused_stage_work(
            f["qscale"], f["wq"], [FUSED_HPT] * len(f["hi"]), f["nsw"],
            f["mask"] if kern == "fused_bitset" else None, force=True,
            conj=((f["nreq"], f["wp"], f["hi"], f["lo"], f["live"])
                  if kern == "fused_conj" else None))
        case = {"QC": qc, "partitions": len(f["hi"]), "nsw": f["nsw"],
                "Hpt": FUSED_HPT, **work, "stage_work": stage_work,
                "plan": plan,
                "clusters_at_once": cuda_build.kernel("fused_sweep_clusters")(
                    qc, FUSED_HPT, k.FUSED_MODES.index(mode)),
                "sms": torch.cuda.get_device_properties(0)
                .multi_processor_count,
                "bytes": nbytes, "int8_ops": ops, "ms": times,
                "graph_ms": graph, "kernel_ms": kernel_ms}
        print(json.dumps(case), flush=True)
        report["cases"].append(case)
        del f, run, outs, pm, pr
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--kernel", choices=sorted(ENTRIES) + sorted(
        _FUSED_ENTRIES), default="disj")
    ap.add_argument("--ablate", action="store_true",
                    help="add the ABLATIONS variants of this tree's source")
    ap.add_argument("--variants",
                    help="F1 / F3: only these FUSED_ABLATIONS (comma list)")
    ap.add_argument("--qc", type=lambda x: [int(v) for v in x.split(",")],
                    default=[256, 16, 8],
                    help="F1 / F3: the QCs timed (comma list)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_ab: CUDA is not available", file=sys.stderr)
        return 2
    kern = args.kernel
    if kern in _FUSED_ENTRIES:
        return fused_main(args)
    cuda_build.build_all()
    for line in cuda_build.BUILD_LOG.get("sweep_rowmax", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas sweep_rowmax: {line.strip()}", flush=True)
    others = {"parent": entry(build("k2_parent", args.parent), kern)}
    if args.ablate:
        for name, path in ablated_sources(
                cuda_build.BUILD_DIR / "ablate").items():
            others[name] = entry(build(f"k2_{name}", path), kern)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report = {"card": smi, "kernel": kern, "reps": args.reps, "cases": []}
    wrapper, plain = WRAPPERS[kern]
    own = cuda_build.kernel(ENTRIES[kern][2])
    make = {"disj": inputs, "conj": conj_inputs, "bitset": bitset_inputs}
    for qc in (256, 8):
        a, np_in = make[kern](qc)

        def cur():
            wrapper(*a, nsw=NSW)

        def other(name):
            def f():
                run_raw(others[name], a, NSW)
            return f

        order = list(others) + ["current", "current"] + list(others)[::-1]
        times = {n: [] for n in order}
        for n in order:
            times[n].append(cuda_ms(cur if n == "current" else other(n),
                                    args.reps))
        # the checks: every output written over NaN / -1
        res = {"current": run_raw(own, a, NSW, poison=True)}
        for n in others:
            if not n.startswith("x-"):
                res[n] = run_raw(others[n], a, NSW, poison=True)
        pm, pr = plain(*a, nsw=NSW)
        for n, (m, r) in res.items():
            if not (torch.equal(m, pm) and torch.equal(r, pr)):
                raise AssertionError(f"{n} differs from the plain {kern} "
                                     f"sweep at QC {qc}")
        if kern == "bitset":
            nbytes, ops, work = bitset_work(np_in[0], np_in[1], NSW)
        else:
            nbytes, ops, n_union, nnz = sweep_work(
                np_in[0], NSW * k.SW, NSW, *np_in[1:])
            work = {"union_slots": n_union, "nonzero_weights": nnz}
        kernel_ms = {"current": kernel_alone(cur, names=("sweep",))[0]}
        for n in others:
            kernel_ms[n] = kernel_alone(other(n), names=("sweep",))[0]
        case = {"QC": qc, "nsw": NSW, "Hpt": HPT, **work,
                "active_queries": int((np_in[0] != 0).any(axis=(0, 2))
                                      .sum()),
                "bytes": nbytes, "int8_ops": ops, "ms": times,
                "kernel_ms": kernel_ms,
                "group": cuda_build.kernel("sweep_group")()}
        print(json.dumps(case), flush=True)
        report["cases"].append(case)
        del a, res, pm, pr
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
