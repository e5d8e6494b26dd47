"""ES_TPU_* environment knob registry (the port's copy of the registry half
of elasticsearch_tpu/common/settings.py).

Only the knobs this slice reads are declared, under the reference's names
and defaults, so an A/B run sets the same environment for both packages.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError


@dataclass(frozen=True)
class EnvKnob:
    """One declared ES_TPU_* environment knob."""

    name: str
    type: str          # 'int' | 'float' | 'str' | 'flag' ('1' == on)
    default: Any       # None means "computed by the consumer"
    doc: str


ENV_KNOBS: dict[str, EnvKnob] = {}

_KNOB_PARSERS: dict[str, Callable[[str], Any]] = {
    "int": int,
    "float": float,
    "str": str,
    "flag": lambda raw: raw == "1",
}

_UNSET = object()


class UndeclaredKnobError(KeyError):
    """An ES_TPU_* knob was read without being declared in the registry."""


def declare_knob(name: str, type: str, default: Any, doc: str) -> EnvKnob:
    if type not in _KNOB_PARSERS:
        raise IllegalArgumentError(f"unknown knob type [{type}] for [{name}]")
    k = EnvKnob(name, type, default, doc)
    ENV_KNOBS[name] = k
    return k


def knob(name: str, default: Any = _UNSET) -> Any:
    """Current value of a declared knob: the parsed environment value when
    set, else `default` (usually the declared one). Reads the environment
    per call, and falls back to the default on an unparseable value, as the
    reference does."""
    decl = ENV_KNOBS.get(name)
    if decl is None:
        raise UndeclaredKnobError(
            f"ES_TPU knob [{name}] is not declared in "
            f"common/settings.py — declare_knob() it")
    fallback = decl.default if default is _UNSET else default
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return fallback
    try:
        return _KNOB_PARSERS[decl.type](raw)
    except (TypeError, ValueError):
        return fallback


declare_knob("ES_TPU_FAULTS", "str", "",
             "Fault-injection spec `site[#part]:mode[@nth][xcount][=arg]"
             "[~prob];…` installed at import (common/faults.py)")
declare_knob("ES_TPU_FAULTS_SEED", "int", 0,
             "Seed for probabilistic (~prob) fault clauses")
declare_knob("ES_TPU_TURBO_HBM", "int", 6 << 30,
             "Device-memory budget in bytes for TurboBM25's int8 column cache")
declare_knob("ES_TPU_TURBO_COLD_DF", "int", None,
             "Doc-frequency threshold below which terms stay cold; "
             "default: parallel/turbo.py COLD_DF")
declare_knob("ES_TPU_FORCE_TURBO", "flag", False,
             "'1' makes Turbo eligible on the CPU (differential tests run "
             "the kernels' plain torch versions)")
declare_knob("ES_TPU_BITSET", "flag", True,
             "Packed-uint32 bitset intersection for bool queries: clause "
             "match sets AND/AND-NOT blockwise on device and the sweep "
             "skips all-zero blocks (0 = dense coverage-matmul sweep)")
declare_knob("ES_TPU_BITSET_HOST_DF", "int", 512,
             "Bool queries whose rarest required clause has df below this "
             "route to the galloping host intersection instead of the "
             "device bitset sweep (0 disables the fallback)")
declare_knob("ES_TPU_SPARSE", "flag", True,
             "Eager sparse impact slices: cold (df < COLD_DF) terms score "
             "on device via the sparse_gather kernel (0 = host cold path)")
declare_knob("ES_TPU_SPARSE_WIDTHS", "str", "1024,4096,16384",
             "Comma-separated slice-width ladder for eager sparse cold-"
             "term slices (each rung rounds up to a 1024-posting granule; "
             "a term uses the smallest rung >= its df)")
declare_knob("ES_TPU_AGG", "flag", True,
             "Route terms/histogram/date_histogram collects (and their "
             "metric sub-aggs) through the device aggregation engine on "
             "leaves above the size floor; off = the exact host "
             "aggregators serve everything (A/B reference path)")
declare_knob("ES_TPU_AGG_HBM_FRAC", "float", 0.25,
             "Cap on precomputed agg-column HBM as a fraction of "
             "ES_TPU_TURBO_HBM: layouts that would exceed it are refused "
             "and their collects stay on host")
declare_knob("ES_TPU_KNN_INT8", "flag", True,
             "Serve KnnEngine first passes from the int8-quantized shards "
             "(exact f32 rescore restores bit-identity); off = the f32 "
             "brute-force path verbatim (A/B reference)")
declare_knob("ES_TPU_KNN_NPROBE", "int", 0,
             "IVF coarse-pruning probe count for KnnEngine first passes: "
             "score only docs assigned to the nprobe nearest k-means "
             "centroids (0 = exact, no pruning)")
declare_knob("ES_TPU_KNN_RESCORE_MULT", "int", 4,
             "Candidate over-fetch factor for the kNN exact rescore: the "
             "first pass keeps k*mult candidates per (query, partition) "
             "before the f32 rescore picks the final k")
declare_knob("ES_TPU_FORCE_KNN", "flag", False,
             "'1' forces KnnEngine serving eligibility off-TPU "
             "(interpret-mode differential tests)")
declare_knob("ES_TPU_TRANSLOG_SYNC_OPS", "int", 128,
             "Async-durability exposure bound: fsync the translog every N "
             "appended ops (request durability syncs every op)")
declare_knob("ES_TPU_TASK_BAN_TTL_S", "float", 300.0,
             "Lifetime of a cancellation ban entry: racing child "
             "registrations for a banned parent are cancelled on arrival "
             "until the ban expires")
declare_knob("ES_TPU_METRICS_SAMPLE_S", "float", 0.0,
             "Period of the background metrics sampler in seconds: every "
             "tick snapshots counters/gauges into the history ring served "
             "at GET /_tpu/metrics/history (0 = sampler off)")
declare_knob("ES_TPU_METRICS_HISTORY", "int", 120,
             "Capacity of the in-memory metrics-sample ring (oldest "
             "samples drop first)")
declare_knob("ES_TPU_INTEGRITY_SCRUB_S", "float", 0.0,
             "HBM scrub period in seconds (0 = off): re-download one "
             "device-resident region per tick on the management pool, "
             "re-hash against the host-side fingerprint, re-upload on "
             "mismatch; skipped while the overload level is not GREEN")
