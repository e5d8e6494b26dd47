"""K2 side by side: an earlier `sweep_rowmax.cu` against this tree's, on one
card in one process, on seeded synthetic inputs of config 1's shape (123
superwindows of 65536 docs, Hpt 225, two-term Zipf queries of which about
half the terms have a device column, about 90 union slots with column
densities from 90% down to under 1%, QC 256 and the DSL batch's QC 8),
made on the card in seconds: no index build.

    python -m elasticsearch_tpu_torch.tools.k2_ab --parent OLD.cu \\
        [--ablate] [--reps 20] [--out k2_ab.json]

`--parent` is a source with the same C entry `es_sweep_rowmax` (for
example `git show HEAD~1:elasticsearch_tpu_torch/parallel/csrc/sweep_rowmax.cu`);
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
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from elasticsearch_tpu_torch.parallel import cuda_build
from elasticsearch_tpu_torch.parallel import kernels as k
from elasticsearch_tpu_torch.tools.k9_ab import build, cuda_ms, kernel_times

NSW = 123                # 8,060,928 docs: config 1's 8M-doc shard
HPT = 225
VOCAB = 500_000

_P, _I = ctypes.c_void_p, ctypes.c_int

# Variants of this tree's source, each a list of (text, replacement):
# G8 / G32 set the group size, intpath scores every query on the integer
# path (int32 sums, a conversion instruction per sum), all with the same
# outputs (checked). Timed only: x-noselect drops the selection rounds,
# x-noload the float path's column loads, x-nomath its byte conversions
# and fmas.
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
}


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


def entry(lib: ctypes.CDLL):
    fn = lib.es_sweep_rowmax
    fn.argtypes = [_P] * 7 + [_I] * 3 + [_P]
    fn.restype = ctypes.c_int
    return fn


def run_raw(fn, args, nsw: int, poison: bool = False):
    """One call of a built es_sweep_rowmax with the wrapper's allocations;
    `poison` fills the outputs with NaN and -1 first, so a check never
    reads an earlier call's results from reused memory."""
    qs, hi, lo, wq, live = args
    qc = int(wq.shape[1])
    shape = (nsw, qc, k.CAND_PAD)
    if poison:
        rm = torch.full(shape, float("nan"), device=hi.device)
        rr = torch.full(shape, -1, dtype=torch.int32, device=hi.device)
    else:
        rm = torch.empty(shape, dtype=torch.float32, device=hi.device)
        rr = torch.empty(shape, dtype=torch.int32, device=hi.device)
    rc = fn(qs.data_ptr(), hi.data_ptr(), lo.data_ptr(), wq.data_ptr(),
            live.data_ptr(), rm.data_ptr(), rr.data_ptr(), qc,
            int(hi.shape[1]), nsw, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    return rm, rr


def parent_runner(path):
    """run(args, nsw) -> (rowmax, rows) of an earlier sweep_rowmax.cu with
    the same C entry, built from `path`, or None when `path` is not a
    file."""
    if path is None or not Path(path).is_file():
        return None
    fn = entry(build("k2_parent", Path(path)))
    return lambda args, nsw: run_raw(fn, args, nsw)


def sweep_work(wq_np: np.ndarray, dp: int, nsw: int):
    """The work K2's bound counts for these inputs: each union slot's two
    column layers, live, the weights and the outputs moved once, and four
    int8 multiply-adds (8 operations) per (nonzero weight, doc). Returns
    (bytes, int8 operations, union slots, nonzero weights); chip_smoke.py
    turns the first two into its bound with the card's peak rates."""
    nz = (wq_np != 0).any(axis=0)                     # [QC, Hpt]
    n_union, nnz = int(nz.any(axis=0).sum()), int(nz.sum())
    qc = wq_np.shape[1]
    nbytes = (n_union * 2 * dp + dp * 4 + wq_np.nbytes + qc * 4
              + 2 * nsw * qc * k.CAND_PAD * 4)
    return nbytes, nnz * 4 * 2 * dp, n_union, nnz


def inputs(qc: int, seed: int = 0):
    """Config 1's K2 inputs on the card. Queries of two terms drawn as
    chip_smoke.py draws them (Zipf(1.07) over a 500k-term vocabulary); a
    term among the Hpt - 1 most frequent has a device column, the rest are
    cold (K3's) and carry no weight here. A column of rank r holds a doc
    with the chance a 24-term doc holds the term (90% at rank 1, under 1%
    at rank 224), hi 1..127 and lo -64..64 where it does; 2% of docs are
    dead. Weights as the engine quantizes them. Returns ((qscale, hi, lo,
    wq, live), wq as numpy)."""
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
    dpc = NSW * k.N_CHUNKS
    hi = torch.zeros((dpc, HPT, 16, 128), dtype=torch.int8, device=dev)
    lo = torch.zeros_like(hi)
    for r in np.unique(terms[terms < HPT - 1]):
        d = 1.0 - (1.0 - p[r]) ** 24
        present = torch.rand((dpc, 16, 128), device=dev, generator=g) < d
        h = torch.randint(1, 128, (dpc, 16, 128), device=dev, generator=g,
                          dtype=torch.int8)
        lw = torch.randint(-64, 65, (dpc, 16, 128), device=dev, generator=g,
                           dtype=torch.int8)
        hi[:, slot_of[r]] = torch.where(present, h, 0)
        lo[:, slot_of[r]] = torch.where(present, lw, 0)
        del present, h, lw
    live = (torch.rand((NSW * k.SW_ROWS, 128), device=dev, generator=g)
            > 0.02).float()
    wq = np.ascontiguousarray(wq[:, :qc])
    qscale = rng.uniform(1e-5, 1e-3, size=(qc, 1)).astype(np.float32)
    args = (torch.from_numpy(qscale).to(dev), hi, lo,
            torch.from_numpy(wq).to(dev), live)
    return args, wq


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--ablate", action="store_true",
                    help="add the ABLATIONS variants of this tree's source")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_ab: CUDA is not available", file=sys.stderr)
        return 2
    cuda_build.build_all()
    for line in cuda_build.BUILD_LOG.get("sweep_rowmax", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas sweep_rowmax: {line.strip()}", flush=True)
    others = {"parent": entry(build("k2_parent", args.parent))}
    if args.ablate:
        for name, path in ablated_sources(
                cuda_build.BUILD_DIR / "ablate").items():
            others[name] = entry(build(f"k2_{name}", path))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report = {"card": smi, "reps": args.reps, "cases": []}
    for qc in (256, 8):
        a, wq_np = inputs(qc)

        def cur():
            k.sweep_rowmax(*a, nsw=NSW)

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
        res = {"current": run_raw(cuda_build.kernel("sweep_rowmax"), a, NSW,
                                  poison=True)}
        for n in others:
            if not n.startswith("x-"):
                res[n] = run_raw(others[n], a, NSW, poison=True)
        pm, pr = k.sweep_rowmax_plain(*a, nsw=NSW)
        for n, (m, r) in res.items():
            if not (torch.equal(m, pm) and torch.equal(r, pr)):
                raise AssertionError(f"{n} differs from the plain K2 at "
                                     f"QC {qc}")
        nbytes, ops, n_union, nnz = sweep_work(wq_np, NSW * k.SW, NSW)
        kernel_ms = {"current": kernel_times(cur, names=("sweep",))["sweep"]}
        for n in others:
            kernel_ms[n] = kernel_times(other(n), names=("sweep",))["sweep"]
        case = {"QC": qc, "nsw": NSW, "Hpt": HPT, "union_slots": n_union,
                "nonzero_weights": nnz,
                "active_queries": int((wq_np != 0).any(axis=(0, 2)).sum()),
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
