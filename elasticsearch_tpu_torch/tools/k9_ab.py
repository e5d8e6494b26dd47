"""K9 side by side: an earlier `knn_window_topc.cu` against this tree's, on
one card in one process, at config 4's full size (977 windows of 2048
768-d rows, 2,000,896 rows; stacked: 4 x 245 windows), on seeded random
int8 rows made on the card.

    python -m elasticsearch_tpu_torch.tools.k9_ab --parent OLD.cu \\
        [--ablate] [--out chiprun_out/k9_ab.json]

`--parent` is a source with the earlier single-kernel C entry (no scratch,
no chunk argument); `--ablate` adds the `ABLATIONS` variants of this tree's
source, those named `x-...` timed only (their outputs are not the
kernel's). All are built with nvcc and the flags of `cuda_build` into the
gitignored build directory. Every other output must equal this tree's
kernel bitwise, and this tree's kernel must equal the plain torch version;
any difference fails the run. Times are CUDA-event medians, taken in turns
(parent, variants, this tree, this tree, variants, parent). Also timed:
the scratch budgets of `kernels.KNN_SCRATCH_BYTES`, the two passes apart
(`kernel_alone`, from torch.profiler's kernel events; for every variant
too), and `torch._int_mm` of the int8 product alone. Prints one JSON
object last.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from elasticsearch_tpu_torch.parallel import cuda_build
from elasticsearch_tpu_torch.parallel import kernels as k

DIMS_P = 768
NW = 977                 # 2,000,896 rows at S = 1
NW_STACKED = 245         # per partition, 4 partitions
PASS_NAMES = ("knn_score_pass", "knn_select_pass")

_P, _I = ctypes.c_void_p, ctypes.c_int
_OLD_ARGS = [_P] * 8 + [_I] * 5 + [_P]
_NEW_ARGS = [_P] * 9 + [_I] * 6 + [_P]


# Variants of this tree's source, each a list of (text, replacement):
# sync-staging copies the stages with plain 16-byte loads and stores, two
# deep, and warp-64x32 gives each warp 64 x 32 (8 warps a block), both with
# the same outputs (checked); the x- ablations drop one part of the score
# pass (timed only).
_MMA = """        mma_s8(acc[mi][ni], a0.x, a1.x, a0.y, a1.y, b[ni].x, b[ni].y);
        mma_s8(acc[mi][ni], a0.z, a1.z, a0.w, a1.w, b[ni].z, b[ni].w);"""
_CP_ASYNC = """  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");"""
ABLATIONS = {
    "sync-staging": [
        (_CP_ASYNC, """  (void)s;
  int4 v = make_int4(0, 0, 0, 0);
  if (src_bytes) v = *reinterpret_cast<const int4*>(src);
  *reinterpret_cast<int4*>(dst) = v;"""),
        ('asm volatile("cp.async.commit_group;\\n" ::: "memory");', ""),
        ('asm volatile("cp.async.wait_group %0;\\n" ::"n"(N) : "memory");',
         ""),
        ("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "warp-64x32": [("constexpr int WN = 64;", "constexpr int WN = 32;")],
    "x-nomma": [(_MMA, "        acc[mi][ni][0] ^= a0.x ^ a1.y ^ b[ni].x ^ "
                       "a0.z ^ a1.w ^ b[ni].w;")],
    "x-nolds-nomma": [("  for (int kk = 0; kk < KSTAGE / KSTEP; ++kk) {",
                       "  for (int kk = 0; kk < 0; ++kk) {")],
    "x-noepi": [("""          const float x = epilogue<SIM>(acc[mi][ni][h * 2 + j],
                                        s_meta[0][d + j], s_meta[1][d + j],
                                        s_meta[2][d + j], qm);""",
                 "          const float x = (float)acc[mi][ni][h * 2 + j];")],
    "x-noqueryload": [("    for (int i = tid; i < BM * CPR; i += A_THREADS) {",
                       "    for (int i = tid; i < 0; i += A_THREADS) {")],
    "x-noscorestore": [("""      *reinterpret_cast<float4*>(out + (int64_t)r * W + c * 4) =
          *reinterpret_cast<const float4*>(s_out + r * OROW + c * 4);""",
                        "      if (s_out[r * OROW + c * 4] == 12345.f) "
                        "out[0] = 1.f;")],
}


def ablated_sources(out_dir: Path):
    """Write each ABLATIONS variant of this tree's knn_window_topc.cu into
    out_dir; returns {name: path}."""
    src = (cuda_build.CSRC / "knn_window_topc.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise ValueError(f"ablation {name}: text not in the source")
            text = text.replace(old, new)
        paths[name] = out_dir / f"{name}.cu"
        paths[name].write_text(text)
    return paths


def build(name: str, src: Path) -> ctypes.CDLL:
    """nvcc `src` into the build directory (cuda_build's flags)."""
    code = src.read_bytes()
    h = hashlib.sha256(code + " ".join(cuda_build.NVCC_FLAGS).encode())
    out = cuda_build.BUILD_DIR / "ab" / f"lib{name}-{h.hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    if not out.exists():
        r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                            "-o", str(out), str(src)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc {src}: {r.stderr}")
    return ctypes.CDLL(str(out))


def parent_entry(path, name: str, symbol: str, argtypes):
    """The C entry `symbol` of an earlier kernel source `path` (the parent
    commit's, for an A/B in one process), built as `name` (build) and
    bound with `argtypes`; None when `path` is not a file."""
    if path is None or not Path(path).is_file():
        return None
    fn = getattr(build(name, Path(path)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def entry(lib: ctypes.CDLL, new_abi: bool):
    fn = lib.es_knn_int8_window_topc
    fn.argtypes = _NEW_ARGS if new_abi else _OLD_ARGS
    fn.restype = ctypes.c_int
    return fn


def cuda_ms(fn, reps: int) -> float:
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


def kernel_alone(fn, names=PASS_NAMES, reps: int = 3, per_call=None):
    """Device time alone per call of fn's kernels whose names contain one of
    `names`, from torch.profiler's CUDA kernel events over `reps` calls
    after a warm-up: for each name its mean event time times its launches
    a call (`per_call`, 1 where not given), summed over `names`. Returns
    (ms or None where a name had no event, info): info["ms"] per name,
    info["events"] {name: [seen, expected]} and info["short"], true where
    the profiler saw fewer events than the calls launched (it drops some
    in long runs); a short count is printed to stderr as SHORT."""
    from torch.profiler import ProfilerActivity, profile

    per_call = per_call or {}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot = {n: 0.0 for n in names}
    seen = {n: 0 for n in names}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in ev.name:
                tot[n] += ev.time_range.elapsed_us() / 1e3
                seen[n] += 1
    each = {n: (tot[n] / seen[n] * per_call.get(n, 1) if seen[n] else None)
            for n in names}
    events = {n: [seen[n], reps * per_call.get(n, 1)] for n in names}
    short = any(s < want for s, want in events.values())
    if short:
        print(f"SHORT: the profiler saw fewer kernel events than launches "
              f"{events}; the time alone is per event x launches",
              file=sys.stderr, flush=True)
    ms = (None if any(x is None for x in each.values())
          else float(sum(each.values())))
    return ms, {"ms": each, "events": events, "short": short}


def inputs(n_parts: int, nw: int, qc: int, masked: bool, seed: int):
    """K9's inputs on the card, as KnnEngine lays them: doc-major int8
    rows with per-row (scale, row_l1, nrm, okf) meta (5% dead rows),
    quantized queries with their qmeta, every window active."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q8 = torch.randint(-127, 128, (n_parts, nw, k.KNN_W, DIMS_P),
                       dtype=torch.int8, device=dev, generator=g)
    scale = torch.rand((n_parts, nw, k.KNN_W), device=dev, generator=g)
    scale = scale * 0.02 + 1e-3
    meta = torch.empty((n_parts, 4, nw, k.KNN_W), device=dev)
    meta[:, 0] = scale
    for p in range(n_parts):
        l1 = q8[p].abs().sum(dim=2, dtype=torch.int32).float()
        meta[p, 1] = scale[p] * l1
    meta[:, 2] = torch.rand((n_parts, nw, k.KNN_W), device=dev,
                            generator=g) + 0.5
    meta[:, 3] = (torch.rand((n_parts, nw, k.KNN_W), device=dev,
                             generator=g) > 0.05).float()
    qi8 = torch.randint(-127, 128, (qc, DIMS_P), dtype=torch.int8,
                        device=dev, generator=g)
    sq = torch.rand(qc, device=dev, generator=g) * 0.01 + 1e-3
    ql1 = sq * qi8.abs().sum(dim=1, dtype=torch.int32).float()
    qn = torch.rand(qc, device=dev, generator=g) + 0.5
    qmeta = torch.zeros((qc, 8), device=dev)
    qmeta[:, 0] = sq
    qmeta[:, 1] = 0.5 * ql1 + DIMS_P * sq / 4.0
    qmeta[:, 2] = qn
    qmeta[:, 3] = qn * qn
    qmeta[:, 4] = 1.0 / qn
    qmeta[:, 5] = 0.5 * sq
    act = torch.ones((n_parts, qc, nw), device=dev)
    fmask = None
    if masked:
        fmask = (torch.rand((n_parts, qc, nw, k.KNN_W), device=dev,
                            generator=g) > 0.5).to(torch.int8)
    if n_parts == 1:
        q8, meta, act = q8[0], meta[0], act[0]
        fmask = None if fmask is None else fmask[0]
    return qi8, qmeta, q8, meta, act, fmask


def run_raw(fn, new_abi: bool, args, n_parts: int, sim: int = 0):
    """One call of a built entry point with the wrapper's allocations."""
    qi8, qmeta, q8, meta, act, fmask = args
    stacked = q8.dim() == 4
    lead = 1 if stacked else 0
    nw = int(q8.shape[lead])
    qc = int(qi8.shape[0])
    pre = (n_parts,) if stacked else ()
    out_s = torch.empty(pre + (nw, qc, k.KNN_CANDW), dtype=torch.float32,
                        device=q8.device)
    out_r = torch.empty(pre + (nw, qc, k.KNN_CANDW), dtype=torch.int32,
                        device=q8.device)
    ptrs = [qi8.data_ptr(), qmeta.data_ptr(), q8.data_ptr(), meta.data_ptr(),
            act.data_ptr(), 0 if fmask is None else fmask.data_ptr(),
            out_s.data_ptr(), out_r.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    if new_abi:
        cw = k.knn_chunk_windows(nw, qc, n_parts)
        scratch = torch.empty((n_parts, cw, qc, k.KNN_W),
                              dtype=torch.float32, device=q8.device)
        rc = fn(*ptrs, scratch.data_ptr(), qc, DIMS_P, nw, n_parts, sim, cw,
                stream)
    else:
        rc = fn(*ptrs, qc, DIMS_P, nw, n_parts, sim, stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out_s, out_r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--ablate", action="store_true",
                    help="add the ABLATIONS variants of this tree's source")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k9_ab: CUDA is not available", file=sys.stderr)
        return 2
    cuda_build.build_all()
    others = {"parent": entry(build("k9_parent", args.parent), False)}
    if args.ablate:
        for name, path in ablated_sources(
                cuda_build.BUILD_DIR / "ablate").items():
            others[name] = entry(build(f"k9_{name}", path), True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report = {"card": smi, "reps": args.reps, "cases": []}
    cases = [(1, NW, 16, False), (1, NW, 16, True), (1, NW, 256, False),
             (1, NW, 256, True), (4, NW_STACKED, 256, False),
             (4, NW_STACKED, 256, True)]
    for n_parts, nw, qc, masked in cases:
        a = inputs(n_parts, nw, qc, masked, seed=qc + nw + masked)
        res = {}

        def cur():
            res["current"] = k.knn_int8_window_topc(*a, similarity="cosine")

        def other(name):
            def f():
                res[name] = run_raw(others[name], name != "parent", a,
                                    n_parts)
            return f

        order = list(others) + ["current", "current"] + list(others)[::-1]
        times = {n: [] for n in order}
        for n in order:
            times[n].append(cuda_ms(cur if n == "current" else other(n),
                                    args.reps))
        plain = k.knn_int8_window_topc_plain(*a, similarity="cosine")
        for n, (s, r) in res.items():
            if n.startswith("x-"):
                continue
            if not (torch.equal(s, plain[0]) and torch.equal(r, plain[1])):
                raise AssertionError(f"{n} differs from the plain K9 on "
                                     f"{(n_parts, nw, qc, masked)}")
        del plain
        case = {"partitions": n_parts, "nw": nw, "QC": qc, "masked": masked,
                "chunk_windows": k.knn_chunk_windows(nw, qc, n_parts),
                "chunks": len(k.knn_chunks(
                    nw, k.knn_chunk_windows(nw, qc, n_parts))),
                "ms": times}
        case["passes_ms"] = kernel_alone(cur)[1]["ms"]
        case["variant_passes_ms"] = {
            n: kernel_alone(other(n))[1]["ms"]
            for n in others if n != "parent"}
        if n_parts == 1 and qc == 256 and not masked:
            budgets = {}
            keep = k.KNN_SCRATCH_BYTES
            try:
                for b in (16 << 20, 32 << 20, 128 << 20, 256 << 20, 512 << 20,
                          1 << 40):
                    k.KNN_SCRATCH_BYTES = b
                    budgets[str(b)] = {
                        "chunk_windows": k.knn_chunk_windows(nw, qc),
                        "ms": cuda_ms(cur, args.reps)}
            finally:
                k.KNN_SCRATCH_BYTES = keep
            case["budgets"] = budgets
            b = a[2].reshape(-1, DIMS_P).t()
            case["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(a[0], b),
                                        args.reps)
        print(json.dumps(case), flush=True)
        report["cases"].append(case)
        del a, res
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
