"""Build and load the hand-written CUDA kernels of `parallel/csrc`.

Each ``csrc/*.cu`` file has a plain C interface (pointers and the stream as
``void*``) and compiles with ``nvcc`` into its own shared library, loaded
with ctypes — no PyTorch headers, so a build takes seconds. All sources are
compiled in parallel, one ``nvcc`` each, on first use, into
``csrc/build/`` (listed in ``.gitignore``). A library's file name carries a
hash of its source and flags, so an edited source is never served by a
stale build. Any failure raises `KernelBuildError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from elasticsearch_tpu_torch.common.errors import KernelBuildError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("build_columns", "sweep_rowmax", "sparse_gather",
           "intersect_bitset", "merge_topk", "knn_window_topc",
           "agg_counts", "pack_bits", "block_scatter", "lane_topk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# kernel -> (source, C entry point, argtypes); one source may hold several;
# sweep_group / sweep_list_cap launch nothing: they report K2's built G and
# list capacity; agg_word_bytes and agg_plan report K8's word scratch
# size and histogram plan; intersect_table_q K5's queries a launch;
# lane_topk_cap K10's big-k buffer for a k; fused_max_parts the
# partitions one fused sweep launch takes; fused_sweep_plan F1 and F3's
# shared-memory plan for (QC, Hpt, F3), fused_sweep_clusters the clusters of
# it the card holds at once
_SIGNATURES = {
    "build_columns": ("build_columns", "es_build_columns",
                      [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I,
                       _F, _F, _F, _P]),
    "sweep_rowmax": ("sweep_rowmax", "es_sweep_rowmax",
                     [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "sweep_group": ("sweep_rowmax", "es_sweep_group", []),
    "sweep_list_cap": ("sweep_rowmax", "es_sweep_list_cap", [_I]),
    "sweep_rowmax_conj": ("sweep_rowmax", "es_sweep_rowmax_conj",
                          [_P] * 9 + [_I, _I, _I, _P]),
    "sweep_rowmax_bitset": ("sweep_rowmax", "es_sweep_rowmax_bitset",
                            [_P] * 8 + [_I, _I, _I, _P]),
    "fused_sweep_rowmax": ("sweep_rowmax", "es_fused_sweep_rowmax",
                           [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P]),
    "fused_sweep_rowmax_conj": ("sweep_rowmax", "es_fused_sweep_rowmax_conj",
                                [_P, _I] + [_P] * 6 + [_I, _I, _I, _P]),
    "fused_sweep_rowmax_bitset": ("sweep_rowmax",
                                  "es_fused_sweep_rowmax_bitset",
                                  [_P, _I] + [_P] * 5 + [_I, _I, _I, _P]),
    "fused_max_parts": ("sweep_rowmax", "es_fused_max_parts", []),
    "fused_sweep_plan": ("sweep_rowmax", "es_fused_sweep_plan",
                         [_I, _I, _I, _P]),
    "fused_sweep_clusters": ("sweep_rowmax", "es_fused_sweep_clusters",
                             [_I, _I, _I]),
    "sparse_gather": ("sparse_gather", "es_sparse_gather",
                      [_P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P]),
    "intersect_bitset": ("intersect_bitset", "es_intersect_bitset",
                         [_P] * 5 + [_I] * 4 + [_P]),
    "intersect_table_q": ("intersect_bitset", "es_intersect_table_q", []),
    "fused_intersect_bitset": ("intersect_bitset",
                               "es_fused_intersect_bitset",
                               [_P, _I] + [_P] * 4 + [_I, _I, _P]),
    "pack_presence_bits": ("pack_bits", "es_pack_presence_bits",
                           [_P, _P, _P, _I, _I, _P]),
    "merge_topk": ("merge_topk", "es_merge_topk",
                   [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "knn_int8_window_topc": ("knn_window_topc", "es_knn_int8_window_topc",
                             [_P] * 9 + [_I] * 6 + [_P]),
    "agg_counts": ("agg_counts", "es_agg_counts",
                   [_P, _L, _I, _P, _L, _P, _L, _I, _L, _I, _I, _I, _P,
                    _P]),
    "agg_word_bytes": ("agg_counts", "es_agg_word_bytes", [_I, _L]),
    "agg_plan": ("agg_counts", "es_agg_plan", [_I, _I, _P]),
    "bm25_block_scatter": ("block_scatter", "es_bm25_block_scatter",
                           [_P] * 5 + [_I, _L, _I] + [_F] * 5 + [_P, _P]),
    "block_presence": ("block_scatter", "es_block_presence",
                       [_P, _P, _P, _I, _L, _I, _P, _P]),
    "weighted_block_scatter": ("block_scatter", "es_weighted_block_scatter",
                               [_P] * 7 + [_I, _I, _I, _L, _I, _I, _P]),
    "lane_topk": ("lane_topk", "es_lane_topk",
                  [_P] * 14 + [_I, _I, _L, _I, _I, _I, _I, _I, _I, _I,
                               _P]),
    "lane_topk_cap": ("lane_topk", "es_lane_topk_cap", [_I]),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}   # guarded by: _LOCK
_FUNCS: Dict[str, object] = {}   # guarded by: _LOCK
BUILD_LOG: Dict[str, str] = {}             # guarded by: _LOCK (ptxas -v)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _build_missing() -> None:  # caller holds _LOCK
    todo = [n for n in SOURCES
            if n not in _LIBS and not _lib_path(n).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for n in todo:
            tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for n, tmp, p in procs:
            out, err = p.communicate()
            BUILD_LOG[n] = (out + err).strip()
            if p.returncode != 0:
                failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{err}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _lib_path(n))
        if failed:
            raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    for n in SOURCES:
        if n in _LIBS:
            continue
        try:
            _LIBS[n] = ctypes.CDLL(str(_lib_path(n)))
        except OSError as e:
            raise KernelBuildError(f"cannot load {_lib_path(n)}: {e}") from e
    for name, (src, sym, argtypes) in _SIGNATURES.items():
        if name in _FUNCS:
            continue
        fn = getattr(_LIBS[src], sym)
        fn.argtypes = argtypes
        fn.restype = _L if sym == "es_agg_word_bytes" else ctypes.c_int
        _FUNCS[name] = fn


def kernel(name: str):
    """The C entry point of kernel `name`, building every kernel first if
    needed."""
    with _LOCK:
        if name not in _FUNCS:
            _build_missing()
        return _FUNCS[name]


def build_all() -> None:
    """Build and load every kernel now (the serving engine calls this at
    construction, so a build failure never surfaces mid-query)."""
    with _LOCK:
        _build_missing()
