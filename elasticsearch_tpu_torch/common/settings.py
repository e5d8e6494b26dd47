"""Typed, validated, dynamically-updatable settings and the ES_TPU_*
environment knob registry (the port's copy of
elasticsearch_tpu/common/settings.py).

A `Setting` is a typed key with a default, parser, validator, scope and a
`dynamic` flag; `Settings` is an immutable key->raw-value map with typed
reads; `ClusterSettings` is the registry that validates updates and
notifies subscribers on dynamic changes.

Every knob of the reference is declared, under the reference's names,
types and defaults, so an A/B run sets the same environment for both
packages.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any, Callable, Generic, Iterable, Mapping, TypeVar

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError

T = TypeVar("T")

_TIME_RE = re.compile(r"^(-?\d+(?:\.\d+)?)(nanos|micros|ms|s|m|h|d)$")
_BYTES_RE = re.compile(r"^(-?\d+(?:\.\d+)?)(b|kb|mb|gb|tb|pb)?$", re.IGNORECASE)

_TIME_FACTORS = {"nanos": 1e-9, "micros": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
_BYTE_FACTORS = {None: 1, "b": 1, "kb": 1 << 10, "mb": 1 << 20, "gb": 1 << 30, "tb": 1 << 40, "pb": 1 << 50}


def parse_time_value(value: Any) -> float:
    """'30s' / '500ms' / number -> seconds."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _TIME_RE.match(str(value).strip())
    if not m:
        raise IllegalArgumentError(f"failed to parse time value [{value}]")
    return float(m.group(1)) * _TIME_FACTORS[m.group(2)]


def parse_bytes_value(value: Any) -> int:
    """'512mb' / '1gb' / number -> bytes."""
    if isinstance(value, (int, float)):
        return int(value)
    m = _BYTES_RE.match(str(value).strip())
    if not m:
        raise IllegalArgumentError(f"failed to parse byte size value [{value}]")
    unit = m.group(2).lower() if m.group(2) else None
    return int(float(m.group(1)) * _BYTE_FACTORS[unit])


def _parse_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    s = str(value).strip().lower()
    if s == "true":
        return True
    if s == "false":
        return False
    raise IllegalArgumentError(f"failed to parse boolean value [{value}], expected [true] or [false]")


class Setting(Generic[T]):
    """A typed setting key. Scope is 'node', 'cluster' or 'index'."""

    def __init__(
        self,
        key: str,
        default: T | Callable[["Settings"], T],
        parser: Callable[[Any], T],
        *,
        scope: str = "cluster",
        dynamic: bool = False,
        validator: Callable[[T], None] | None = None,
    ):
        self.key = key
        self._default = default
        self.parser = parser
        self.scope = scope
        self.dynamic = dynamic
        self.validator = validator

    def default(self, settings: "Settings") -> T:
        if callable(self._default):
            return self._default(settings)
        return self._default

    def get(self, settings: "Settings") -> T:
        raw = settings.raw(self.key)
        if raw is None:
            return self.default(settings)
        value = self.parser(raw)
        if self.validator is not None:
            self.validator(value)
        return value

    # -- constructors mirroring the reference's factory methods --

    @staticmethod
    def bool_setting(key: str, default: bool, **kw) -> "Setting[bool]":
        return Setting(key, default, _parse_bool, **kw)

    @staticmethod
    def int_setting(key: str, default: int, min_value: int | None = None, **kw) -> "Setting[int]":
        def parse(v):
            i = int(v)
            if min_value is not None and i < min_value:
                raise IllegalArgumentError(f"failed to parse value [{v}] for setting [{key}] must be >= {min_value}")
            return i

        return Setting(key, default, parse, **kw)

    @staticmethod
    def float_setting(key: str, default: float, **kw) -> "Setting[float]":
        return Setting(key, default, float, **kw)

    @staticmethod
    def str_setting(key: str, default: str, **kw) -> "Setting[str]":
        return Setting(key, default, str, **kw)

    @staticmethod
    def time_setting(key: str, default: float | str, **kw) -> "Setting[float]":
        dflt = parse_time_value(default) if isinstance(default, str) else default
        return Setting(key, dflt, parse_time_value, **kw)

    @staticmethod
    def bytes_setting(key: str, default: int | str, **kw) -> "Setting[int]":
        dflt = parse_bytes_value(default) if isinstance(default, str) else default
        return Setting(key, dflt, parse_bytes_value, **kw)


class Settings(Mapping[str, Any]):
    """Immutable flat key->value map. Nested dicts are flattened with dots."""

    def __init__(self, values: Mapping[str, Any] | None = None):
        self._values: dict[str, Any] = {}
        if values:
            self._flatten("", values)

    def _flatten(self, prefix: str, values: Mapping[str, Any]) -> None:
        for k, v in values.items():
            key = f"{prefix}{k}"
            if isinstance(v, Mapping):
                self._flatten(f"{key}.", v)
            else:
                self._values[key] = v

    EMPTY: "Settings"

    def raw(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def get(self, setting: "Setting[T] | str", default: Any = None) -> Any:
        if isinstance(setting, Setting):
            return setting.get(self)
        return self._values.get(setting, default)

    def with_updates(self, updates: Mapping[str, Any]) -> "Settings":
        merged = dict(self._values)
        flat = Settings(updates)
        for k, v in flat._values.items():
            if v is None:
                merged.pop(k, None)  # null value resets to default, as in the reference API
            else:
                merged[k] = v
        out = Settings()
        out._values = merged
        return out

    def filtered_by_prefix(self, prefix: str) -> "Settings":
        out = Settings()
        out._values = {k: v for k, v in self._values.items() if k.startswith(prefix)}
        return out

    def as_dict(self) -> dict[str, Any]:
        return dict(self._values)

    def as_nested_dict(self) -> dict[str, Any]:
        nested: dict[str, Any] = {}
        for key, value in sorted(self._values.items()):
            parts = key.split(".")
            node = nested
            for p in parts[:-1]:
                node = node.setdefault(p, {})
                if not isinstance(node, dict):
                    break
            else:
                node[parts[-1]] = value
        return nested

    def __getitem__(self, key: str) -> Any:
        return self._values[key]

    def __iter__(self):
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __repr__(self) -> str:
        return f"Settings({self._values!r})"


Settings.EMPTY = Settings()


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


def effective_knobs() -> dict[str, dict]:
    """{name: {value, default, source}} for the `tpu_settings` section of
    GET /_nodes/stats — `source` says whether the environment or the
    declared default is in effect right now."""
    out: dict[str, dict] = {}
    for name in sorted(ENV_KNOBS):
        decl = ENV_KNOBS[name]
        raw = os.environ.get(name)
        out[name] = {
            "value": knob(name),
            "default": decl.default,
            "type": decl.type,
            "source": "env" if raw not in (None, "") else "default",
        }
    return out


declare_knob("ES_TPU_PLUGINS", "str", "",
             "Comma-separated plugin modules exposing install(node), "
             "loaded at node startup")
declare_knob("ES_TPU_FAULTS", "str", "",
             "Fault-injection spec `site[#part]:mode[@nth][xcount][=arg]"
             "[~prob];…` installed at import (common/faults.py)")
declare_knob("ES_TPU_FAULTS_SEED", "int", 0,
             "Seed for probabilistic (~prob) fault clauses")
declare_knob("ES_TPU_HEALTH_TRIP_N", "int", 3,
             "Consecutive device faults that open an engine's circuit")
declare_knob("ES_TPU_HEALTH_BACKOFF_MS", "int", 1000,
             "Base backoff before a half-open probe (doubles per reopen, "
             "capped at 32x)")
declare_knob("ES_TPU_TURBO_HBM", "int", 6 << 30,
             "Device-memory budget in bytes for TurboBM25's int8 column cache")
declare_knob("ES_TPU_TURBO_COLD_DF", "int", None,
             "Doc-frequency threshold below which terms stay cold; "
             "default: parallel/turbo.py COLD_DF")
declare_knob("ES_TPU_TURBO_MESH", "int", None,
             "Fused multi-partition Turbo: the reference's device cap of its "
             "mesh; on one card 0 (or less) disables fusion and any other "
             "value keeps it (default: fused for S >= 2)")
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
declare_knob("ES_TPU_CHECK_ON_STARTUP", "flag", False,
             "Re-verify every committed segment checksum before a shard "
             "copy reports started (ref: index.shard.check_on_startup) — "
             "corruption found here fails the copy instead of serving it")
declare_knob("ES_TPU_INTEGRITY_SCRUB_S", "float", 0.0,
             "HBM scrub period in seconds (0 = off): re-download one "
             "device-resident region per tick on the management pool, "
             "re-hash against the host-side fingerprint, re-upload on "
             "mismatch; skipped while the overload level is not GREEN")
# the serving context, the dispatch scheduler, pools, tracing, overload
declare_knob("ES_TPU_COALESCE_US", "float", 2000.0,
             "Dispatch-coalescer flush window in microseconds "
             "(0 disables coalescing)")
declare_knob("ES_TPU_DISABLE_SHARD_SERVING", "flag", False,
             "'1' disables the shard-level serving fast path on data nodes")
declare_knob("ES_TPU_POOL_SEARCH_SIZE", "int", None,
             "Worker count for the search pool (default 3*cpus/2+1)")
declare_knob("ES_TPU_POOL_SEARCH_QUEUE", "int", None,
             "Queue capacity for the search pool (default 1000)")
declare_knob("ES_TPU_POOL_WRITE_SIZE", "int", None,
             "Worker count for the write pool (default cpus)")
declare_knob("ES_TPU_POOL_WRITE_QUEUE", "int", None,
             "Queue capacity for the write pool (default 10000)")
declare_knob("ES_TPU_POOL_GET_SIZE", "int", None,
             "Worker count for the get pool (default cpus)")
declare_knob("ES_TPU_POOL_GET_QUEUE", "int", None,
             "Queue capacity for the get pool (default 1000)")
declare_knob("ES_TPU_POOL_MANAGEMENT_SIZE", "int", None,
             "Worker count for the management pool (default 2)")
declare_knob("ES_TPU_POOL_MANAGEMENT_QUEUE", "int", None,
             "Queue capacity for the management pool (default 512)")
declare_knob("ES_TPU_POOL_SNAPSHOT_SIZE", "int", None,
             "Worker count for the snapshot pool (default 1)")
declare_knob("ES_TPU_POOL_SNAPSHOT_QUEUE", "int", None,
             "Queue capacity for the snapshot pool (default 256)")
declare_knob("ES_TPU_TRACE_SAMPLE", "int", 0,
             "Trace every Nth search even without profile=true or slowlog "
             "thresholds (0 = off; sampled traces land in the trace ring)")
declare_knob("ES_TPU_TRACE_RING", "int", 64,
             "Capacity of the in-memory flight-recorder ring of completed "
             "traces")
declare_knob("ES_TPU_SLOWLOG_RING", "int", 128,
             "Capacity of the in-memory search slowlog ring")
declare_knob("ES_TPU_SCHED_MODE", "str", "adaptive",
             "Serving dispatch path: 'adaptive' (continuous-batching "
             "scheduler) or 'legacy' (fixed-window coalescer)")
declare_knob("ES_TPU_SCHED_BUCKETS", "str", "1,4,16,64,256",
             "Padded batch-size ladder for the adaptive scheduler "
             "(comma-separated, each bucket one dispatch width); when "
             "the env var is unset the ladder autotunes from the observed "
             "sched_queue_depth / coalesce_pad_ratio histograms")
declare_knob("ES_TPU_SCHED_INTERACTIVE_US", "float", 1000.0,
             "Max scheduler queue wait for interactive-tier queries, "
             "microseconds")
declare_knob("ES_TPU_SCHED_BULK_US", "float", 8000.0,
             "Max scheduler queue wait for bulk-tier queries, "
             "microseconds")
declare_knob("ES_TPU_SCHED_INFLIGHT", "int", 2,
             "In-flight device batches per scheduler lane (2 = "
             "double-buffered: demux of batch N overlaps the sweep of "
             "N+1)")
declare_knob("ES_TPU_HOT_THREADS_INTERVAL_MS", "int", 15,
             "Sleep between the two stack samples of a hot_threads "
             "capture (threads idle across both samples are filtered)")
declare_knob("ES_TPU_OVERLOAD_YELLOW", "float", 0.7,
             "Folded pressure score at which the node enters YELLOW "
             "(bulk-tier requests shed with 429 + Retry-After)")
declare_knob("ES_TPU_OVERLOAD_RED", "float", 0.9,
             "Folded pressure score at which the node enters RED "
             "(interactive requests shed too)")
declare_knob("ES_TPU_OVERLOAD_HYSTERESIS_MS", "int", 2000,
             "Pressure-level downgrade dwell: the raw level must stay "
             "below the current one this long before the node steps down "
             "(upgrades apply immediately)")
declare_knob("ES_TPU_RETRY_BUDGET_RATIO", "float", 0.2,
             "Retry tokens refilled per successful request into the "
             "node-wide retry budget (0 disables the budget: retries are "
             "unbounded as before)")
declare_knob("ES_TPU_RETRY_BUDGET_CAP", "int", 32,
             "Retry-budget bucket capacity (and initial fill): each "
             "failover / replication / bulk / recovery / poison-solo "
             "retry spends one token")
# the transport and cross-cluster search planes of the REST node
declare_knob("ES_TPU_RPC_TIMEOUT_MS", "int", 0,
             "Floor for the per-RPC deadline in ms (0 = request budget "
             "only)")
declare_knob("ES_TPU_TCP_TIMEOUT_S", "float", 30.0,
             "Socket timeout for TcpNodeChannels remote RPCs, seconds")
declare_knob("ES_TPU_REMOTE_RETRIES", "int", 1,
             "Extra attempts per remote-cluster RPC after the first "
             "(rotating across the remote's seed nodes), each spending a "
             "token from the node's retry budget")
declare_knob("ES_TPU_REMOTE_BACKOFF_MS", "int", 25,
             "Delay between remote-cluster RPC attempts, ms")
# the task plane, shard allocation and cross-cluster replication
declare_knob("ES_TPU_TASK_FANOUT_TIMEOUT_MS", "int", 2000,
             "Per-peer budget for _tasks / hot_threads / ban fan-out RPCs "
             "(a dead peer degrades to node_failures instead of hanging "
             "the coordinator)")
declare_knob("ES_TPU_DELAYED_ALLOC_MS", "int", 0,
             "Delayed allocation window after node-left, ms: replica "
             "replacements stay UNASSIGNED this long so a bounced node "
             "can rejoin and recover its own copies (0 = reallocate "
             "immediately; index.unassigned.node_left.delayed_timeout "
             "analog)")
declare_knob("ES_TPU_CCR_POLL_MS", "int", 100,
             "Follower-index pull-loop poll interval, ms (0 = no "
             "background thread; tests and bench pump poll_once() "
             "deterministically)")
declare_knob("ES_TPU_CCR_BATCH_OPS", "int", 512,
             "Max translog ops per CCR fetch batch (one sha256-verified "
             "wire payload)")
# the cluster path: coordinator bulk, peer recovery, relocation and
# search failover (cluster_node.py, indices/, action/search_action.py)
declare_knob("ES_TPU_SEARCH_SHARD_RETRIES", "int", 3,
             "Max replica-failover retries per shard before it counts "
             "failed")
declare_knob("ES_TPU_BULK_RETRIES", "int", 20,
             "Coordinator bulk retry attempts per shard before the items "
             "fail with unavailable_shards_exception")
declare_knob("ES_TPU_BULK_RETRY_MS", "int", 100,
             "Delay between coordinator bulk retries, ms")
declare_knob("ES_TPU_BULK_TIMEOUT_MS", "int", 0,
             "Overall coordinator bulk deadline in ms (0 = retries bound "
             "the wait on their own)")
declare_knob("ES_TPU_RECOVERY_RETRIES", "int", 3,
             "Peer-recovery attempts per replica before it is reported "
             "shard-failed to the master")
declare_knob("ES_TPU_RECOVERY_BACKOFF_MS", "int", 50,
             "Base backoff between peer-recovery retries, ms (doubles per "
             "attempt)")
declare_knob("ES_TPU_RELOC_WARM", "flag", True,
             "Warm device handoff on shard relocation: the target builds "
             "its per-field engines, uploads columns, widens its dispatch "
             "ladder to the source's hot shapes and pre-slices the "
             "source's resident cold terms BEFORE reporting shard-started "
             "(0 = relocate cold)")


class ClusterSettings:
    """Registry of known settings + dynamic-update subscription.

    Ref: common/settings/AbstractScopedSettings.java — validates that updates
    only touch registered dynamic settings and notifies consumers.
    """

    def __init__(self, initial: Settings, registered: Iterable[Setting] | None = None):
        self._settings = initial
        self._registered: dict[str, Setting] = {}
        self._consumers: list[tuple[Setting, Callable[[Any], None]]] = []
        for s in registered or ():
            self.register(s)

    def register(self, setting: Setting) -> None:
        self._registered[setting.key] = setting

    @property
    def settings(self) -> Settings:
        return self._settings

    def get(self, setting: Setting[T]) -> T:
        return setting.get(self._settings)

    def add_settings_update_consumer(self, setting: Setting[T], consumer: Callable[[T], None]) -> None:
        self._consumers.append((setting, consumer))

    def apply(self, updates: Mapping[str, Any]) -> Settings:
        """Validate + apply updates; notify consumers whose value changed."""
        flat = Settings(updates)
        for key in flat:
            reg = self._registered.get(key)
            if reg is None:
                raise IllegalArgumentError(f"transient setting [{key}], not recognized")
            if not reg.dynamic:
                raise IllegalArgumentError(f"final {reg.scope} setting [{key}], not updateable")
            if flat.raw(key) is not None:
                reg.parser(flat.raw(key))  # validate before committing
        old = self._settings
        self._settings = old.with_updates(updates)
        for setting, consumer in self._consumers:
            new_val = setting.get(self._settings)
            if setting.get(old) != new_val:
                consumer(new_val)
        return self._settings
