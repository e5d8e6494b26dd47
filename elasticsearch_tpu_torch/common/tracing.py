"""Per-request trace contexts for the search flight recorder.

A ``TraceContext`` is born at the REST layer (or at a coordinator entry for
the in-process cluster harness), rides the current thread via a thread-local,
hops threads through ``threadpool.pool`` (tasks capture the submitter's trace
and re-activate it in the worker), and crosses node boundaries as a small
``_trace`` dict inside the shard RPC payload — NEVER inside the search body
itself, which would trip ``extract_plan``'s allowed-key check and silently
kill the Turbo fast path.

Tracing is OFF by default: ``current()`` returns None, every recording site
degrades to one thread-local read, and responses are bit-identical to the
untraced build (differential-tested). It turns on per request when:

- the search body asks for ``profile``,
- ``ES_TPU_TRACE_SAMPLE`` = N samples every Nth search, or
- the target index has any ``index.search.slowlog.threshold.*`` configured
  (slow queries must carry phase attribution when they hit the slowlog).

Completed traces land in a bounded in-memory ring (``ES_TPU_TRACE_RING``);
over-threshold queries additionally append structured records to the slowlog
ring (``ES_TPU_SLOWLOG_RING``) served at ``GET /_tpu/slowlog``.

The port's copy of elasticsearch_tpu/common/tracing.py; its code differs only
in the imports.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.common.settings import knob, parse_time_value

_tls = threading.local()


class TraceContext:
    """Spans for one search request on one node. Thread-safe: spans arrive
    from pool workers, coalescer leaders and RPC threads concurrently."""

    __slots__ = ("trace_id", "opaque_id", "node", "kind", "t0", "spans",
                 "_lock")

    def __init__(self, trace_id: Optional[str] = None,
                 opaque_id: Optional[str] = None,
                 node: str = "", kind: str = "coordinator"):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.opaque_id = opaque_id
        self.node = node
        self.kind = kind
        self.t0 = time.monotonic()
        self._lock = threading.Lock()
        self.spans: List[dict] = []  # guarded by: _lock

    def add_span(self, name: str, duration_ms: float, **meta: Any) -> None:
        end_ms = (time.monotonic() - self.t0) * 1e3
        span = {"name": name,
                "start_ms": round(max(0.0, end_ms - duration_ms), 3),
                "duration_ms": round(duration_ms, 3)}
        if meta:
            span["meta"] = meta
        with self._lock:
            self.spans.append(span)

    @contextmanager
    def span(self, name: str, **meta: Any):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add_span(name, (time.monotonic() - t0) * 1e3, **meta)

    def span_dicts(self) -> List[dict]:
        with self._lock:
            return [dict(s) for s in self.spans]

    def phase_totals(self) -> Dict[str, float]:
        """Aggregate span durations by name (ms). rest_total is excluded —
        it envelopes every other phase and would double the sum."""
        out: Dict[str, float] = {}
        for s in self.span_dicts():
            if s["name"] == "rest_total":
                continue
            out[s["name"]] = round(out.get(s["name"], 0.0) + s["duration_ms"], 3)
        return out

    def wire(self) -> dict:
        """What crosses the RPC boundary (payload `_trace` key)."""
        return {"trace_id": self.trace_id, "opaque_id": self.opaque_id}

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "opaque_id": self.opaque_id,
                "node": self.node, "kind": self.kind,
                "spans": self.span_dicts()}


def current() -> Optional[TraceContext]:
    return getattr(_tls, "trace", None)


@contextmanager
def activate(tc: Optional[TraceContext]):
    """Install ``tc`` as the thread's current trace. activate(None) is a
    no-op pass-through so call sites need no branching."""
    if tc is None:
        yield None
        return
    prev = getattr(_tls, "trace", None)
    _tls.trace = tc
    try:
        yield tc
    finally:
        _tls.trace = prev


def child_from_wire(wire: Optional[dict], node: str = "",
                    kind: str = "shard") -> Optional[TraceContext]:
    """Data-node side of RPC propagation: rebuild a local context sharing
    the coordinator's trace id (or None when the request is untraced)."""
    if not wire:
        return None
    return TraceContext(trace_id=wire.get("trace_id"),
                        opaque_id=wire.get("opaque_id"),
                        node=node, kind=kind)


# --- sampling ---------------------------------------------------------------

_SAMPLE_LOCK = threading.Lock()
_SAMPLE = {"n": 0}  # guarded by: _SAMPLE_LOCK


def should_sample() -> bool:
    """Every-Nth sampling per ES_TPU_TRACE_SAMPLE (0 = off)."""
    every = knob("ES_TPU_TRACE_SAMPLE")
    if every <= 0:
        return False
    with _SAMPLE_LOCK:
        _SAMPLE["n"] += 1
        return _SAMPLE["n"] % every == 0


# --- flight-recorder ring ---------------------------------------------------

_RING_LOCK = threading.Lock()
_TRACES: deque = deque()  # guarded by: _RING_LOCK


def record_trace(tc: TraceContext) -> None:
    cap = max(1, knob("ES_TPU_TRACE_RING"))
    with _RING_LOCK:
        _TRACES.append(tc.to_dict())
        while len(_TRACES) > cap:
            _TRACES.popleft()


def recent_traces() -> List[dict]:
    with _RING_LOCK:
        return list(_TRACES)


# --- slowlog ----------------------------------------------------------------

_SLOWLOG_LOCK = threading.Lock()
_SLOWLOG: deque = deque()  # guarded by: _SLOWLOG_LOCK
_SLOWLOG_COUNTS = {"query_warn": 0, "query_info": 0,
                   "fetch_warn": 0, "fetch_info": 0}  # guarded by: _SLOWLOG_LOCK

_SLOWLOG_SETTING = "index.search.slowlog.threshold.{phase}.{level}"
_LEVELS = ("warn", "info")  # warn checked first: highest threshold wins


def slowlog_thresholds(settings) -> Dict[str, Dict[str, Optional[float]]]:
    """Effective per-phase thresholds (ms) from an index Settings object —
    {'query': {'warn': ms|None, 'info': ms|None}, 'fetch': {...}}.
    Unset or '-1' means disabled, matching the reference semantics."""
    out: Dict[str, Dict[str, Optional[float]]] = {}
    for phase in ("query", "fetch"):
        per: Dict[str, Optional[float]] = {}
        for level in _LEVELS:
            raw = settings.raw(_SLOWLOG_SETTING.format(phase=phase, level=level))
            ms: Optional[float] = None
            if raw not in (None, "", "-1", -1):
                try:
                    ms = float(raw)  # bare numbers are ms (reference convention)
                except (TypeError, ValueError):
                    try:
                        ms = parse_time_value(str(raw)) * 1000.0
                    except Exception:  # unparseable -> disabled, not fatal
                        ms = None
                if ms is not None and ms < 0:
                    ms = None
            per[level] = ms
        out[phase] = per
    return out


def slowlog_configured(settings) -> bool:
    th = slowlog_thresholds(settings)
    return any(v is not None for per in th.values() for v in per.values())


def slowlog_check(phase: str, took_ms: float,
                  thresholds: Dict[str, Optional[float]]) -> Optional[str]:
    """Highest matching level for one phase timing, or None."""
    for level in _LEVELS:
        ms = thresholds.get(level)
        if ms is not None and took_ms >= ms:
            return level
    return None


def slowlog_record(phase: str, level: str, index: str, took_ms: float,
                   source: Any = None, node: str = "", shard: Any = None,
                   tc: Optional[TraceContext] = None) -> None:
    entry = {
        "phase": phase,
        "level": level,
        "index": index,
        "shard": shard,
        "node": node,
        "took_ms": round(took_ms, 3),
        "source": source,
        "trace_id": tc.trace_id if tc is not None else None,
        "opaque_id": tc.opaque_id if tc is not None else None,
        "phases": tc.phase_totals() if tc is not None else {},
    }
    cap = max(1, knob("ES_TPU_SLOWLOG_RING"))
    key = f"{phase}_{level}"
    with _SLOWLOG_LOCK:
        if key in _SLOWLOG_COUNTS:
            _SLOWLOG_COUNTS[key] += 1
        _SLOWLOG.append(entry)
        while len(_SLOWLOG) > cap:
            _SLOWLOG.popleft()


def slowlog_entries() -> List[dict]:
    with _SLOWLOG_LOCK:
        return list(_SLOWLOG)


def slowlog_stats() -> dict:
    with _SLOWLOG_LOCK:
        return {**_SLOWLOG_COUNTS, "ring_entries": len(_SLOWLOG)}


def reset_for_tests() -> None:
    with _RING_LOCK:
        _TRACES.clear()
    with _SLOWLOG_LOCK:
        _SLOWLOG.clear()
        for k in _SLOWLOG_COUNTS:
            _SLOWLOG_COUNTS[k] = 0
    with _SAMPLE_LOCK:
        _SAMPLE["n"] = 0
    if getattr(_tls, "trace", None) is not None:
        _tls.trace = None
