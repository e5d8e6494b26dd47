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
  presence bits (about 45% of the (query, chunk) pairs live at QC 256).

    python -m elasticsearch_tpu_torch.tools.k2_ab --parent OLD.cu \\
        [--kernel disj|conj|bitset] [--ablate] [--reps 20] [--out FILE]

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
# each kernel's C entry, its count of input pointers and its name in
# cuda_build; the pointers come in the order of the wrapper's positional
# arguments, then (out_m, out_r, qc, hpt, nsw, stream)
ENTRIES = {"disj": ("es_sweep_rowmax", 5, "sweep_rowmax"),
           "conj": ("es_sweep_rowmax_conj", 7, "sweep_rowmax_conj"),
           "bitset": ("es_sweep_rowmax_bitset", 6, "sweep_rowmax_bitset")}
WRAPPERS = {"disj": (k.sweep_rowmax, k.sweep_rowmax_plain),
            "conj": (k.sweep_rowmax_conj, k.sweep_rowmax_conj_plain),
            "bitset": (k.sweep_rowmax_bitset, k.sweep_rowmax_bitset_plain)}


def ablated_sources(out_dir: Path):
    """Write each ABLATIONS variant of this tree's sweep_rowmax.cu into
    out_dir; returns {name: path}."""
    src = (cuda_build.CSRC / "sweep_rowmax.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in ABLATIONS.items():
        text = src
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


def _columns(ranks, p, slot_of, g):
    """hi / lo columns on the card for the terms of rank `ranks`: a column
    of rank r holds a doc with the chance a 24-term doc holds the term
    (90% at rank 1, under 1% at rank 224), hi 1..127 and lo -64..64 where
    it does."""
    dev = torch.device("cuda")
    dpc = NSW * k.N_CHUNKS
    hi = torch.zeros((dpc, HPT, 16, 128), dtype=torch.int8, device=dev)
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


def _live(g):
    """2% of docs dead."""
    return (torch.rand((NSW * k.SW_ROWS, 128), device=torch.device("cuda"),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--kernel", choices=sorted(ENTRIES), default="disj")
    ap.add_argument("--ablate", action="store_true",
                    help="add the ABLATIONS variants of this tree's source")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_ab: CUDA is not available", file=sys.stderr)
        return 2
    kern = args.kernel
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
