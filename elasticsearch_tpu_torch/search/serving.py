"""The serving fast path (the port of elasticsearch_tpu/search/serving.py):
`IndexService.search` / `msearch` try `ServingContext.try_search` /
`try_msearch` first, and the dense executor serves whatever it declines.

A request is servable here when it reduces to a flat BM25 plan over one
text field. `extract_plan` flattens the body exactly as the reference
does: a disjunctive plan (match (or), term, bool.should of those) batches
per field into one `_disjunctive_batch`, which goes through the adaptive
scheduler (`threadpool.scheduler.serving_dispatch`) to
`TurboEngine.search_many`; a conjunctive one (must, filter, must_not,
match_phrase) becomes a search_bool spec through `_turbo_bool_spec` and
goes to `TurboEngine.search_bool` (`_conjunctive`), or, where Turbo cannot
represent it, to the host columnar executor (`_conjunctive_partition`).
`ServingSnapshot.engine` builds the engine through `select_bm25_engine`,
once per (snapshot, field).

Scoring stats are index-global (every partition scores with the same
idf/avgdl), so the fast path engages for single-shard indices and for
`search_type=dfs_query_then_fetch` on multi-shard ones. Results are exact:
the same f32 scores as the reference and the deterministic (score desc,
partition asc, doc asc) order.

A kNN-only body (top-level `knn`, no `query`) becomes a `KnnPlan` through
`extract_knn_plan`; its optional filter flattens in filter context and
`_knn_filter_mask` turns it into per-partition doc masks. `_knn_batch`
serves the bodies of one vector field through the snapshot's KnnEngine
(`select_knn_engine`, stacked when there are several partitions).

Where the port differs from the reference:

* **No mesh.** The snapshot carries the index's device instead
  (`ServingSnapshot(searchers, device)`); `select_bm25_engine` runs with
  `device=snap.device`. S > 1 partitions take the fused route, as the
  reference's one-card mesh gives them (`_turbo_fused`): one launch per
  query chunk for every partition (`parallel.turbo.ShardedTurbo`) and
  the merge on the device (K4). `ES_TPU_TURBO_MESH` <= 0 gives the
  sequential route and `_merge3`; on one card its other values mean
  nothing more.
* **The backend gate.** `knn_engine` builds on a `cuda` snapshot, and on
  the CPU only with `ES_TPU_FORCE_KNN` (the reference: on a TPU backend,
  or with the knob).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from elasticsearch_tpu_torch import device as _device
from elasticsearch_tpu_torch.common import (
    faults, hbm_ledger, integrity, metrics, tracing,
)
from elasticsearch_tpu_torch.common.errors import (
    DeviceFaultError, KernelBuildError, KernelLaunchError,
    SearchPhaseExecutionError,
)
from elasticsearch_tpu_torch.common.faults import FaultRecord
from elasticsearch_tpu_torch.common.health import EngineHealth
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.index.positions import phrase_freqs
from elasticsearch_tpu_torch.ops import bm25_idf
from elasticsearch_tpu_torch.search import queries as q
from elasticsearch_tpu_torch.search.queries import parse_query
from elasticsearch_tpu_torch.tasks.task_manager import (
    Deadline, DispatchDeadlineError, TaskCancelledError, parse_timeout_ms,
)
from elasticsearch_tpu_torch.threadpool.coalescer import record_device

K1 = 1.2
B = 0.75

_ALLOWED_KEYS = {"query", "size", "from", "_source", "stored_fields",
                 "track_total_hits", "version", "seq_no_primary_term",
                 "timeout", "allow_partial_search_results", "profile"}
_MAX_K = 1000
_KNN_ALLOWED_KEYS = (_ALLOWED_KEYS | {"knn"}) - {"query"}

# serving-path fault/containment counters
_SERVING_STATS = {"fastpath_reject_error": 0, "fastpath_device_fault": 0,
                  "fastpath_timed_out": 0,
                  "shard_fault_recoveries": 0}  # guarded by: _SERVING_LOCK
_SERVING_LOCK = threading.Lock()
_LOGGED_REJECT_TYPES: set = set()  # guarded by: _SERVING_LOCK


def serving_fault_stats() -> dict:
    with _SERVING_LOCK:
        return dict(_SERVING_STATS)


def _count_serving(key: str, n: int = 1) -> None:
    with _SERVING_LOCK:
        _SERVING_STATS[key] += n


def _note_reject_error(e: BaseException, where: str) -> None:
    """An unexpected error declines the fast path (the dense executor
    serves), as in the reference, but not silently: each one is counted
    (fastpath_reject_error) and the first of each (site, type) is logged
    with a traceback."""
    _count_serving("fastpath_reject_error")
    tname = type(e).__name__
    with _SERVING_LOCK:
        if (where, tname) in _LOGGED_REJECT_TYPES:
            return
        _LOGGED_REJECT_TYPES.add((where, tname))
    logging.getLogger("search.serving").warning(
        "fast path hit an unexpected %s at %s (%s); falling back to the "
        "dense executor; further %s errors here are counted, not logged",
        tname, where, e, tname, exc_info=True)


# --------------------------------------------------------------------------
# Plan extraction
# --------------------------------------------------------------------------


@dataclass
class FlatPlan:
    """A query tree flattened to postings-level operations."""

    field: Optional[str] = None                 # the single scoring field
    disj: List[Tuple[str, float]] = dc_field(default_factory=list)
    conj: List[Tuple[str, float]] = dc_field(default_factory=list)
    should: List[Tuple[str, float]] = dc_field(default_factory=list)
    filters: List[Tuple[str, List[str]]] = dc_field(default_factory=list)
    must_not: List[Tuple[str, List[str]]] = dc_field(default_factory=list)
    phrases: List[Tuple[List[str], int, float]] = dc_field(default_factory=list)

    @property
    def is_disjunctive(self) -> bool:
        return (bool(self.disj) and not self.conj and not self.filters
                and not self.must_not and not self.phrases and not self.should)

    @property
    def is_conjunctive(self) -> bool:
        return bool(self.conj or self.filters or self.phrases) and not self.disj

    def scoring_terms(self) -> List[str]:
        return [t for t, _ in self.disj + self.conj + self.should]


class _Reject(Exception):
    pass


def extract_plan(request: dict, mapper) -> Optional[FlatPlan]:
    """Flatten an eligible request body into a FlatPlan, or None."""
    if any(k not in _ALLOWED_KEYS for k in request):
        return None
    body_q = request.get("query")
    if body_q is None:
        return None
    size = int(request.get("size", 10))
    from_ = int(request.get("from", 0))
    if size <= 0 or from_ + size > _MAX_K:
        return None
    try:
        query = parse_query(body_q)
        plan = FlatPlan()
        _flatten(query, plan, mapper, ctx="top", weight=1.0)
    except _Reject:
        return None
    except Exception as e:
        _note_reject_error(e, "extract_plan")
        return None
    if not (plan.is_disjunctive or plan.is_conjunctive):
        return None
    return plan


@dataclass
class KnnPlan:
    """An eligible top-level `knn` body flattened for KnnEngine serving:
    the query vector plus an optional filter already reduced to postings
    operations (the FlatPlan machinery the BM25 sweep uses)."""

    field: str
    vector: list
    k: int
    filter_plan: Optional[FlatPlan] = None


def extract_knn_plan(request: dict, mapper) -> Optional[KnnPlan]:
    """Flatten an eligible kNN-only request body (top-level `knn`, no
    `query`) into a KnnPlan, or None for the dense executor. The filter
    clause must reduce to postings operations (term/terms/match in filter
    context); scored clauses, boosts != 1 and multi-kNN stay dense."""
    if any(k not in _KNN_ALLOWED_KEYS for k in request):
        return None
    spec = request.get("knn")
    if spec is None or request.get("query") is not None:
        return None
    if isinstance(spec, list):
        if len(spec) != 1:
            return None
        spec = spec[0]
    if not isinstance(spec, dict):
        return None
    size = int(request.get("size", 10))
    from_ = int(request.get("from", 0))
    if size <= 0 or from_ + size > _MAX_K:
        return None
    if float(spec.get("boost", 1.0)) != 1.0:
        return None
    field = spec.get("field")
    vec = spec.get("query_vector")
    if not field or vec is None:
        return None
    ft = mapper.field_type(field)
    if ft is None or ft.family != "vector":
        return None
    # the knn section's k caps the hit count (size only windows into it),
    # matching the dense executor's top-level-knn semantics
    k = int(spec.get("k", 10))
    if k <= 0 or k > _MAX_K:
        return None
    fplan = None
    if spec.get("filter") is not None:
        try:
            node = parse_query(spec["filter"])
            fplan = FlatPlan()
            _flatten(node, fplan, mapper, ctx="filter", weight=1.0)
        except _Reject:
            return None
        except Exception as e:
            _note_reject_error(e, "extract_knn_plan")
            return None
        if fplan.disj or fplan.conj or fplan.should or fplan.phrases:
            return None          # scored clauses inside filter: dense
        if not fplan.filters and not fplan.must_not:
            return None
    return KnnPlan(field=field, vector=vec, k=k, filter_plan=fplan)


def _post_docs(fp, term: str) -> np.ndarray:
    o = fp.term_to_ord.get(term)
    if o is None:
        return np.empty(0, np.int32)
    return fp.post_doc[int(fp.post_start[o]): int(fp.post_start[o + 1])]


def _knn_filter_mask(fplan: FlatPlan, seg) -> np.ndarray:
    """One partition's filter candidate mask (seg: an object with `n_docs`
    and a `postings` dict): AND of per-clause postings unions, minus
    must_not postings — the BM25 sweep's candidate set for the same
    clauses, reused as the kNN doc filter."""
    n = seg.n_docs
    mask = np.ones(n, bool)
    for f, terms in fplan.filters:
        fpf = seg.postings.get(f)
        if fpf is None:
            return np.zeros(n, bool)
        m = np.zeros(n, bool)
        for t in terms:
            m[_post_docs(fpf, t)] = True
        mask &= m
    for f, terms in fplan.must_not:
        fpf = seg.postings.get(f)
        if fpf is None:
            continue
        for t in terms:
            mask[_post_docs(fpf, t)] = False
    return mask


def _text_field(plan: FlatPlan, mapper, field: str) -> None:
    ft = mapper.field_type(field)
    if ft is None or ft.family != "inverted":
        raise _Reject
    if plan.field is None:
        plan.field = field
    elif plan.field != field:
        raise _Reject


def _posting_field(mapper, field: str) -> None:
    """Filter-context fields must be postings-backed (text or keyword)."""
    ft = mapper.field_type(field)
    if ft is None or ft.family not in ("inverted", "keyword"):
        raise _Reject


def _analyze(mapper, field: str, text: str) -> List[str]:
    ft = mapper.field_type(field)
    return mapper.analyzer_for(ft).terms(text)


def _flatten(node, plan: FlatPlan, mapper, ctx: str, weight: float) -> None:
    """ctx: 'top' | 'must' | 'should' | 'filter'."""
    w = weight * getattr(node, "boost", 1.0)
    if isinstance(node, q.TermQuery):
        if ctx == "filter":
            _posting_field(mapper, node.field)
            plan.filters.append((node.field, [str(node.value)]))
            return
        _text_field(plan, mapper, node.field)
        dest = plan.conj if ctx == "must" else (
            plan.should if ctx == "should" else plan.disj)
        dest.append((str(node.value), w))
        return
    if isinstance(node, q.TermsQuery):
        if ctx != "filter":
            raise _Reject       # scoring terms-query is constant-score; dense
        _posting_field(mapper, node.field)
        plan.filters.append((node.field, [str(v) for v in node.values]))
        return
    if isinstance(node, q.MatchQuery):
        if getattr(node, "fuzziness", None):
            raise _Reject
        ft = mapper.field_type(node.field)
        if ft is None or ft.family != "inverted":
            raise _Reject       # keyword/numeric match has no-analysis paths
        terms = _analyze(mapper, node.field, node.text)
        if not terms:
            raise _Reject
        msm = node.minimum_should_match
        if ctx == "filter":
            if node.operator == "and":
                for t in terms:
                    plan.filters.append((node.field, [t]))
            elif msm is None or msm <= 1:
                plan.filters.append((node.field, terms))
            else:
                raise _Reject
            return
        _text_field(plan, mapper, node.field)
        if node.operator == "and" or (ctx == "must" and len(terms) == 1):
            plan.conj.extend((t, w) for t in terms)
        elif ctx == "must":
            raise _Reject       # scored OR-group under must: not flat
        elif msm is None or msm <= 1:
            dest = plan.should if ctx == "should" else plan.disj
            dest.extend((t, w) for t in terms)
        else:
            raise _Reject
        return
    if isinstance(node, q.MatchPhraseQuery):
        if ctx == "should":
            raise _Reject
        _text_field(plan, mapper, node.field)
        terms = _analyze(mapper, node.field, node.text)
        if len(terms) < 1:
            raise _Reject
        plan.phrases.append((terms, int(node.slop),
                             0.0 if ctx == "filter" else w))
        return
    if isinstance(node, q.MatchAllQuery):
        if ctx == "filter":
            return              # no-op constraint
        raise _Reject
    if isinstance(node, q.BoolQuery):
        if ctx not in ("top", "must", "filter"):
            raise _Reject
        msm = node.minimum_should_match
        in_filter = ctx == "filter"
        has_required = bool(node.must or node.filter)
        for c in node.must:
            _flatten(c, plan, mapper, "filter" if in_filter else "must", w)
        for c in node.filter:
            _flatten(c, plan, mapper, "filter", w)
        for c in node.must_not:
            if isinstance(c, q.TermQuery):
                _posting_field(mapper, c.field)
                plan.must_not.append((c.field, [str(c.value)]))
            elif isinstance(c, q.TermsQuery):
                _posting_field(mapper, c.field)
                plan.must_not.append((c.field, [str(v) for v in c.values]))
            else:
                raise _Reject
        if node.should:
            if msm is not None and msm > 1:
                raise _Reject
            if has_required:
                if msm is not None and msm >= 1:
                    raise _Reject   # should becomes required: not flat
                if not in_filter:   # optional scorers; in filter ctx a
                    for c in node.should:   # non-required should is a no-op
                        _flatten(c, plan, mapper, "should", w)
            elif in_filter:
                # pure-should bool in filter context = required OR-group
                # (default minimum_should_match 1); representable only as a
                # single-field any-of term group
                if msm is not None and msm < 1:
                    raise _Reject
                fields = set()
                group: List[str] = []
                for c in node.should:
                    if isinstance(c, q.TermQuery):
                        _posting_field(mapper, c.field)
                        fields.add(c.field)
                        group.append(str(c.value))
                    elif isinstance(c, q.TermsQuery):
                        _posting_field(mapper, c.field)
                        fields.add(c.field)
                        group.extend(str(v) for v in c.values)
                    else:
                        raise _Reject
                if len(fields) != 1:
                    raise _Reject
                plan.filters.append((fields.pop(), group))
            elif ctx == "top":
                if msm is not None and msm < 1:
                    raise _Reject   # msm=0 pure-should matches everything
                if len(node.should) == 1:
                    _flatten(node.should[0], plan, mapper, "top", w)
                else:
                    # multiple alternatives: each must be a pure disjunctive
                    # leaf, else flattening would promote it to required
                    for c in node.should:
                        if isinstance(c, q.TermQuery):
                            pass
                        elif (isinstance(c, q.MatchQuery)
                              and c.operator != "and"
                              and (c.minimum_should_match is None
                                   or c.minimum_should_match <= 1)):
                            pass
                        else:
                            raise _Reject
                        _flatten(c, plan, mapper, "top", w)
            else:
                # pure-should bool under must: a required SCORED or-group —
                # not representable flat; dense path handles it
                raise _Reject
        return
    raise _Reject


def _turbo_bool_spec(plan: FlatPlan) -> Optional[dict]:
    """Convert a conjunctive FlatPlan into a TurboBM25.search_bool spec, or
    None when Turbo's contract cannot represent it: every clause must be a
    single term on the scoring field, and every match must be guaranteed a
    positive score (the engine drops score <= 0 matches)."""
    if plan.field is None or plan.disj:
        return None
    for f, terms in plan.filters:
        if f != plan.field or len(terms) != 1:
            return None          # cross-field / any-of filter groups
    for f, _ in plan.must_not:
        if f != plan.field:
            return None
    if (any(w < 0 for _, w in plan.conj)
            or any(w < 0 for _, w in plan.should)
            or any(b < 0 for _, _, b in plan.phrases)):
        return None
    if not (any(w > 0 for _, w in plan.conj)
            or any(b > 0 for _, _, b in plan.phrases)):
        return None              # no positively-scored required clause
    return {
        "must": list(plan.conj),
        "should": list(plan.should),
        "filter": [terms[0] for _, terms in plan.filters],
        "must_not": [t for _, terms in plan.must_not for t in terms],
        "phrases": [(list(terms), int(slop), float(boost))
                    for terms, slop, boost in plan.phrases],
    }


# --------------------------------------------------------------------------
# BM25 engine selection
# --------------------------------------------------------------------------

# device memory reserved for TurboBM25's int8 column cache when selected
TURBO_HBM_BUDGET = knob("ES_TPU_TURBO_HBM")

def _env_cold_df() -> Optional[int]:
    return knob("ES_TPU_TURBO_COLD_DF")


# node-wide Turbo partition-merge counters (every TurboEngine adds to these
# beside its own merge_stats)
_TURBO_NODE_STATS = {"merge_device": 0, "merge_host": 0,
                     "partition_dispatches": 0,
                     "fused_dispatches": 0}  # guarded by: _TURBO_NODE_LOCK
_TURBO_NODE_LOCK = threading.Lock()


def turbo_node_stats() -> dict:
    """Merge counters and the bitset tier's node counters (the port keeps
    the sparse tier's counters on each engine's `stats` only)."""
    from elasticsearch_tpu_torch.parallel.turbo import node_bitset_stats

    with _TURBO_NODE_LOCK:
        out = dict(_TURBO_NODE_STATS)
    out.update(node_bitset_stats())
    return out


def engine_desc(eng) -> Tuple[str, int]:
    """(description, partition count) of the tier that would run a
    dispatch right now: `fused_turbo` / `turbo` / `host_tier` (circuit
    open) / the engine's kind / `host` (no engine). Profile output and
    trace spans use it."""
    kind = getattr(eng, "kind", None)
    parts = len(getattr(eng, "turbos", ()) or ()) or 1
    if kind == "turbo":
        health = getattr(eng, "health", None)
        if health is not None and not health.allow_device():
            return "host_tier", parts
        if getattr(eng, "fused", False) and parts >= 2:
            return "fused_turbo", parts
        return "turbo", parts
    return (kind or "host"), parts


def device_profile_node(eng, dur_ms: float, parts: Optional[int] = None) -> dict:
    """A QueryProfiler-shaped node for the device dispatch, merged into the
    profile `searches.query` list next to the host query tree."""
    desc, n_parts = engine_desc(eng)
    return {"type": "DeviceDispatch",
            "description": f"engine={desc} partitions={parts or n_parts}",
            "time_in_nanos": int(dur_ms * 1e6)}


def _synth_query_node(query_obj, time_ns: int) -> dict:
    """QueryProfiler-shaped node for a parsed query object (the dense
    executor's (type, description) convention)."""
    node = {"type": type(query_obj).__name__,
            "description": repr(query_obj)[:200],
            "time_in_nanos": int(time_ns)}
    kids = []
    if isinstance(query_obj, q.BoolQuery):
        kids = (list(query_obj.must) + list(query_obj.should)
                + list(query_obj.filter) + list(query_obj.must_not))
    elif isinstance(query_obj, q.ConstantScoreQuery) \
            and query_obj.filter is not None:
        kids = [query_obj.filter]
    if kids:
        node["children"] = [_synth_query_node(c, 0) for c in kids]
    return node


def fastpath_profile_nodes(request, eng, dur_ms: float,
                           parts: Optional[int] = None) -> list:
    """Profile `query` list for a fast-path-served request: the parsed
    query tree with the dispatch time on the root, plus a DeviceDispatch
    node naming the tier that ran."""
    nodes = []
    try:
        nodes.append(_synth_query_node(parse_query(request.get("query")),
                                       int(dur_ms * 1e6)))
    except Exception:   # profile must never fail the search
        pass
    nodes.append(device_profile_node(eng, dur_ms, parts=parts))
    return nodes


def _turbo_fused(n_partitions: int) -> bool:
    """Whether S partitions take the fused route: the mesh-less counterpart
    of the reference's `_turbo_mesh` (serving.py:520), which on a one-card
    host gives every S >= 2 a mesh unless ES_TPU_TURBO_MESH caps it at 0.
    S < 2 has nothing to fuse."""
    if n_partitions < 2:
        return False
    cap = knob("ES_TPU_TURBO_MESH")
    return cap is None or cap > 0


class TurboEngine:
    """Per-partition TurboBM25 engines behind the (scores, partition, ord)
    search_many contract.

    With S > 1 partitions and `fused`, every partition's sweep and row
    pick run as one launch per query chunk (parallel.turbo.ShardedTurbo)
    and the partition top-ks merge on the device
    (parallel.spmd.merge_partition_topk, K4) with the (score desc,
    partition asc, ord asc) order of the host `_merge3`, bitwise: the merge
    permutes the exact f32 scores. Without it (S == 1, or
    ES_TPU_TURBO_MESH=0) the partitions run one after another and merge
    through `_merge3`, a partition whose device path faults served by its
    host tier. A faulted engine or an open circuit serves the whole batch
    from the host tier. `check` is the cooperative-cancellation callable
    of the reference, passed down to every partition's device and host
    tiers."""

    kind = "turbo"

    def __init__(self, turbos: Sequence, fused: bool = False):
        self.turbos = list(turbos)
        for i, t in enumerate(self.turbos):
            t.part_id = i          # fault-site attribution per partition
        self.fused = bool(fused) and len(self.turbos) >= 2
        self._sharded = None
        if self.fused:
            from elasticsearch_tpu_torch.parallel.turbo import ShardedTurbo

            self._sharded = ShardedTurbo(self.turbos,
                                         on_dispatch=self._count_fused)
        self.health = EngineHealth("turbo")
        for t in self.turbos:
            # repeated scrub mismatches in a partition's regions trip the
            # circuit device faults trip
            integrity.attach_scrub_health(t, self.health)
        self._stats_lock = threading.Lock()
        self.merge_stats = {"merge_device": 0, "merge_host": 0,
                            "partition_dispatches": 0,
                            "fused_dispatches": 0}  # guarded by: _stats_lock

    @property
    def device(self):
        """The partitions' device (the scheduler launches in its scope)."""
        return self.turbos[0].device if self.turbos else None

    def _count(self, key: str, n: int = 1) -> None:
        if n <= 0:
            return
        with self._stats_lock:
            self.merge_stats[key] += n
        with _TURBO_NODE_LOCK:
            _TURBO_NODE_STATS[key] += n

    @property
    def qc_sizes(self):
        """Dispatch widths (pad-waste accounting and the adaptive
        scheduler's bucket ladder read them through the engine facade).
        Partitions share one width set by construction."""
        return self.turbos[0].qc_sizes if self.turbos else ()

    def extend_qc_sizes(self, sizes) -> None:
        """Scheduler bucket-ladder hook: widen every partition's width set,
        and the ladder of the device aggregation engine of the same
        device, so agg dispatches are primed before the first analytics
        request reaches its lane."""
        for t in self.turbos:
            t.extend_qc_sizes(sizes)
        if self._sharded is not None:
            self._sharded.extend_qc_sizes(sizes)
        if self.device is not None:
            from elasticsearch_tpu_torch.search import agg_device

            agg_device.default_engine(self.device).extend_qc_sizes(sizes)

    def sparse_hot_terms(self) -> list:
        """Union of the partitions' resident cold-term slices: the warm
        relocation handoff's payload (the target rebuilds them through
        prewarm_sparse before taking traffic)."""
        out = set()
        for t in self.turbos:
            out.update(t.sparse_hot_terms())
        return sorted(out)

    def prewarm_sparse(self, terms) -> int:
        """Build cold-term slices for `terms` on every partition ahead of
        traffic; returns the slices resident afterwards."""
        return sum(t.prewarm_sparse(terms) for t in self.turbos)

    def _host_tier_many(self, batches, k, check):
        """Whole-engine host-exact tier: zero device dispatches, merged
        via _merge3 — bit-identical to the device route."""
        per = [t.search_many_host(batches, k=k, check=check)
               for t in self.turbos]
        return [self._merge3([p[bi] for p in per], len(batch), k)
                for bi, batch in enumerate(batches)]

    def _health_account(self, log, n0: int) -> None:
        new = log[n0:]
        if new:
            self.health.record_fault(new[-1].error)
        else:
            self.health.record_success()

    def search_many(self, batches: Sequence[List], k: int = 10, check=None,
                    fault_log=None):
        log = fault_log if fault_log is not None else []
        n0 = len(log)
        nq = sum(len(b) for b in batches)
        if not self.health.allow_device():
            self.health.record_fallback(nq)
            return self._host_tier_many(batches, k, check)
        fused = self._sharded
        try:
            if fused is not None:
                per = fused.search_many(batches, k=k, check=check,
                                        fault_log=log)
            else:
                per = []
                for t in self.turbos:
                    try:
                        per.append(t.search_many(batches, k=k, check=check))
                    except DeviceFaultError as e:
                        log.append(FaultRecord.from_error(
                            e, partition=t.part_id))
                        per.append(t.search_many_host(batches, k=k,
                                                      check=check))
        except DeviceFaultError as e:
            log.append(FaultRecord.from_error(e))
            self.health.record_fault(e)
            self.health.record_fallback(nq)
            return self._host_tier_many(batches, k, check)
        out = [self._merge_parts([p[bi] for p in per], len(batch), k,
                                 fault_log=log)
               for bi, batch in enumerate(batches)]
        self._health_account(log, n0)
        return out

    def _count_fused(self) -> None:
        """One fused launch: a dispatch of every partition."""
        self._count("fused_dispatches")
        self._count("partition_dispatches", len(self.turbos))

    def search_bool(self, queries: Sequence[dict], k: int = 10,
                    check=None, fault_log=None):
        """Batched bool top-k through the per-partition conjunctive sweeps:
        (scores [Q, k], partition [Q, k], ord [Q, k]). Fault containment
        as in search_many: an open circuit or a fault outside a partition
        serves the batch from the host tier, a faulted partition is served
        by its own."""
        log = fault_log if fault_log is not None else []
        n0 = len(log)
        if not self.health.allow_device():
            self.health.record_fallback(len(queries))
            return self._merge3([t.search_bool_host(queries, k=k,
                                                    check=check)
                                 for t in self.turbos], len(queries), k)
        fused = self._sharded
        try:
            if fused is not None:
                per = fused.search_bool(queries, k=k, check=check,
                                        fault_log=log)
            else:
                per = []
                for t in self.turbos:
                    try:
                        per.append(t.search_bool(queries, k=k, check=check))
                    except DeviceFaultError as e:
                        log.append(FaultRecord.from_error(
                            e, partition=t.part_id))
                        per.append(t.search_bool_host(queries, k=k,
                                                      check=check))
        except DeviceFaultError as e:
            log.append(FaultRecord.from_error(e))
            self.health.record_fault(e)
            self.health.record_fallback(len(queries))
            return self._merge3([t.search_bool_host(queries, k=k,
                                                    check=check)
                                 for t in self.turbos], len(queries), k)
        out = self._merge_parts(per, len(queries), k, fault_log=log)
        self._health_account(log, n0)
        return out

    def search_phrase(self, phrases: Sequence[List[str]], k: int = 10,
                      slop: int = 0, check=None, fault_log=None):
        """Batched match_phrase top-k: sugar over search_bool; slop-0
        phrases ride the adjacency columns, other slops the exact host
        positional path."""
        specs = [{"phrases": [(list(p), int(slop), 1.0)]} for p in phrases]
        return self.search_bool(specs, k=k, check=check, fault_log=fault_log)

    def _merge_parts(self, per, Q: int, k: int, fault_log=None):
        """Per-partition (scores, docs) into the engine-wide (scores,
        partition, ord) contract: on the device (K4) on the fused route,
        through the host `_merge3` otherwise. A faulted device merge falls
        back to `_merge3`, bitwise the same (the merge only permutes exact
        f32 scores); a kernel error propagates."""
        if len(per) > 1 and self.fused and Q > 0:
            try:
                with faults.device_dispatch("merge_kernel"):
                    from elasticsearch_tpu_torch.parallel.spmd import (
                        merge_partition_topk,
                    )

                    out = merge_partition_topk(
                        np.stack([s for s, _ in per]),
                        np.stack([d for _, d in per]), k,
                        device=self.device)
                self._count("merge_device")
                return out
            except DeviceFaultError as e:
                if fault_log is not None:
                    fault_log.append(FaultRecord.from_error(e))
        if len(per) > 1 and Q > 0:
            self._count("merge_host")
        return self._merge3(per, Q, k)

    def _merge3(self, per, Q: int, k: int):
        """Merge per-partition (scores, docs) into the engine-wide
        (scores, partition, ord) contract: (score desc, partition asc, doc
        asc)."""
        out_s = np.zeros((Q, k), np.float32)
        out_p = np.zeros((Q, k), np.int32)
        out_o = np.zeros((Q, k), np.int32)
        if len(per) == 1:
            s, d = per[0]
            out_s, out_o = s.copy(), d.copy()
            out_o[out_s <= 0] = 0
            return out_s, out_p, out_o
        for qi in range(Q):
            cand = [(float(s), pi, int(d))
                    for pi, (ss, dd) in enumerate(per)
                    for s, d in zip(ss[qi], dd[qi]) if s > 0]
            cand.sort(key=lambda x: (-x[0], x[1], x[2]))
            for j, (s, pi, d) in enumerate(cand[:k]):
                out_s[qi, j] = s
                out_p[qi, j] = pi
                out_o[qi, j] = d
        return out_s, out_p, out_o

    def hbm_bytes(self) -> int:
        # the fused engine holds nothing of its own on the device
        return sum(t.hbm_bytes() for t in self.turbos)

    def prebuild_columns(self) -> int:
        return sum(t.prebuild_columns() for t in self.turbos)

    @property
    def stats(self) -> dict:
        agg: Dict[str, float] = {}
        for t in self.turbos:
            for key, v in t.stats.items():
                agg[key] = agg.get(key, 0) + v
        with self._stats_lock:
            agg.update(self.merge_stats)
        agg.update(self.health.flat_stats())
        return agg


def turbo_eligible(segments, field: str, *, device=None,
                   hbm_budget_bytes: int = TURBO_HBM_BUDGET,
                   cold_df: Optional[int] = None) -> bool:
    """True when TurboBM25 should serve this index's disjunctions: the
    device is the card (on the CPU only when ES_TPU_FORCE_TURBO=1, as the
    reference gates its interpret mode off the TPU), and the full colizable
    column set fits the device budget."""
    from elasticsearch_tpu_torch.parallel.kernels import SW
    from elasticsearch_tpu_torch.parallel.turbo import COLD_DF

    dev = _device.resolve(device)
    force = knob("ES_TPU_FORCE_TURBO")
    if dev.type != "cuda" and not force:
        hbm_ledger.note_routing(field, False, "backend_not_cuda",
                                0, hbm_budget_bytes)
        return False
    if cold_df is None:
        cold_df = _env_cold_df()
    cdf = COLD_DF if cold_df is None else cold_df
    cache = 0
    for seg in segments:
        fp = seg.postings.get(field)
        if fp is None:
            continue
        n_docs = max(seg.n_docs, 1)
        dp = -(-n_docs // SW) * SW
        n_col = int((fp.doc_freq >= cdf).sum())
        cache += 2 * dp * (((n_col + 8 + 31) // 32) * 32 + 1)
    eligible = cache <= hbm_budget_bytes
    if not eligible:
        reason = "exceeds_hbm_budget"
    elif dev.type != "cuda":
        reason = "forced_turbo"
    else:
        reason = "fits_hbm_budget"
    hbm_ledger.note_routing(field, eligible, reason, cache, hbm_budget_bytes)
    return eligible


def select_bm25_engine(segments, field: str, live_masks=None, *,
                       device=None,
                       hbm_budget_bytes: int = TURBO_HBM_BUDGET,
                       cold_df: Optional[int] = None):
    """Build the disjunctive BM25 serving engine for these partitions
    (objects with `n_docs` and a `postings` dict of FieldPostings): a
    TurboEngine where Turbo is eligible, else BlockMaxBM25 over the
    partitions stacked on `device` (the reference's one selection point,
    serving.py:866). Several partitions take the fused route unless
    ES_TPU_TURBO_MESH <= 0 (`_turbo_fused`)."""
    from elasticsearch_tpu_torch.parallel.blockmax import BlockMaxBM25
    from elasticsearch_tpu_torch.parallel.kernels import SW
    from elasticsearch_tpu_torch.parallel.spmd import build_stacked_bm25
    from elasticsearch_tpu_torch.parallel.turbo import COLD_DF, TurboBM25

    dev = _device.resolve(device)
    if cold_df is None:
        cold_df = _env_cold_df()
    if not turbo_eligible(segments, field, device=dev,
                          hbm_budget_bytes=hbm_budget_bytes, cold_df=cold_df):
        return BlockMaxBM25(
            build_stacked_bm25(segments, field, live_masks, device=dev,
                               serve_only=True, device_arrays=True), dev)
    # index-global scoring stats: every partition scores with the same
    # total_docs/avgdl/df
    total_docs = sum(max(seg.n_docs, 1) for seg in segments)
    n_field = 0
    sum_dl = 0.0
    df_map: Dict[str, int] = {}
    for seg in segments:
        fp = seg.postings.get(field)
        if fp is None:
            continue
        n_field += int(np.count_nonzero(fp.doc_len))
        sum_dl += float(fp.sum_doc_len)
        for t, o in fp.term_to_ord.items():
            df_map[t] = df_map.get(t, 0) + int(fp.doc_freq[o])
    avgdl = (sum_dl / n_field) if n_field else 1.0

    cdf = COLD_DF if cold_df is None else cold_df
    turbos = []
    for i, seg in enumerate(segments):
        stacked = build_stacked_bm25(
            [seg], field,
            live_masks=None if live_masks is None else [live_masks[i]])
        kwargs = {} if cold_df is None else {"cold_df": cold_df}
        # budget proportional to this partition's need
        fp = seg.postings.get(field)
        n_col = 0 if fp is None else int((fp.doc_freq >= cdf).sum())
        dp = -(-max(seg.n_docs, 1) // SW) * SW
        need_bytes = 2 * dp * (n_col + 8)
        turbos.append(TurboBM25(
            stacked, hbm_budget_bytes=need_bytes,
            total_docs=total_docs, avgdl=avgdl,
            df_of=lambda t: df_map.get(t, 0), device=dev, **kwargs))
    return TurboEngine(turbos, fused=_turbo_fused(len(turbos)))


# --------------------------------------------------------------------------
# kNN engine selection
# --------------------------------------------------------------------------


def select_knn_engine(segments, field: str, live_masks=None, *,
                      device=None):
    """The KnnEngine for these partitions' vector field (objects with
    `n_docs` and a `vectors` dict of VectorColumn), as the reference's
    ServingSnapshot._build_knn_engine builds it: None when ineligible (the
    device is not the card and ES_TPU_FORCE_KNN is unset, no partition holds
    the field, or the partitions' dims or similarity differ). Partitions
    without the field get an all-missing stub column, so engine partition
    indices stay aligned with `segments`. Several partitions stack on the
    card, where the reference passes its mesh."""
    from elasticsearch_tpu_torch.index.segment import VectorColumn
    from elasticsearch_tpu_torch.parallel.knn import KnnEngine

    dev = _device.resolve(device)
    if dev.type != "cuda" and not knob("ES_TPU_FORCE_KNN"):
        return None
    cols = [seg.vectors.get(field) for seg in segments]
    present = [c for c in cols if c is not None]
    if not present:
        return None
    dims = present[0].dims
    sim = present[0].similarity
    if any(c.dims != dims or c.similarity != sim for c in present):
        return None
    for i, c in enumerate(cols):
        if c is None:
            n = segments[i].n_docs
            cols[i] = VectorColumn(
                np.zeros((n, dims), np.float32), np.zeros(n, np.float32),
                np.zeros(n, bool), dims, sim)
    return KnnEngine(cols, lives=live_masks, stacked=len(cols) > 1,
                     device=dev)


# --------------------------------------------------------------------------
# Serving snapshot
# --------------------------------------------------------------------------


@dataclass
class _Partition:
    shard_id: int
    leaf_idx: int
    base: int                   # global ord offset within the shard
    segment: object
    live: np.ndarray
    live_epoch: int
    all_live: bool


class ServingSnapshot:
    """Point-in-time columnar view of every (shard, segment) partition, on
    the index's device (the reference passes its mesh here)."""

    def __init__(self, searchers, device):
        self.searchers = searchers
        self.device = device
        self.partitions: List[_Partition] = []
        for shard_id, se in enumerate(searchers):
            base = 0
            for leaf_idx, v in enumerate(se.views):
                self.partitions.append(_Partition(
                    shard_id=shard_id, leaf_idx=leaf_idx, base=base,
                    segment=v.segment, live=v.live, live_epoch=v.live_epoch,
                    all_live=bool(v.live.all())))
                base += v.segment.n_docs
        self.total_docs = sum(int(p.live.sum()) for p in self.partitions)
        self._bm: Dict[str, object] = {}
        self._knn: Dict[str, object] = {}
        self._stats: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def key(self):
        # mirrors engine.searcher_version(): (shard_id, seg_id, epoch)
        return tuple((p.shard_id, p.segment.seg_id, p.live_epoch)
                     for p in self.partitions)

    # ---- per-field state ----

    def field_fps(self, field: str):
        return [p.segment.postings.get(field) for p in self.partitions]

    def stats(self, field: str):
        """(total_docs, avgdl, df: term -> int) with index-global scope."""
        if field not in self._stats:
            fps = self.field_fps(field)
            n = 0
            s = 0.0
            for fp in fps:
                if fp is not None:
                    n += int(np.count_nonzero(fp.doc_len))
                    s += float(fp.sum_doc_len)
            avgdl = (s / n) if n else 1.0
            self._stats[field] = (sum(p.segment.n_docs for p in self.partitions),
                                  avgdl, {})
        return self._stats[field]

    def idf(self, field: str, term: str) -> float:
        total, _, cache = self.stats(field)
        if term not in cache:
            df = 0
            for fp in self.field_fps(field):
                if fp is not None and term in fp.term_to_ord:
                    df += int(fp.doc_freq[fp.term_to_ord[term]])
            cache[term] = bm25_idf(total, df) if df else 0.0
        return cache[term]

    def engine(self, field: str):
        """The disjunctive BM25 engine for this snapshot, built once per
        (snapshot, field): a TurboEngine when Turbo is eligible, BlockMax
        otherwise."""
        with self._lock:
            if field not in self._bm:
                self._bm[field] = select_bm25_engine(
                    [p.segment for p in self.partitions], field,
                    [p.live for p in self.partitions],
                    device=self.device)
            return self._bm[field]

    def knn_engine(self, field: str):
        """The quantized KnnEngine for this snapshot's vector field, built
        once per (snapshot, field) by `select_knn_engine`: None when
        ineligible (a CPU snapshot without ES_TPU_FORCE_KNN, no partition
        holds the field, or dims or similarity differ). Partitions without
        the field get an all-missing stub column, so engine partition
        indices stay aligned with `partitions`."""
        with self._lock:
            if field not in self._knn:
                self._knn[field] = select_knn_engine(
                    [p.segment for p in self.partitions], field,
                    [p.live for p in self.partitions], device=self.device)
            return self._knn[field]


# --------------------------------------------------------------------------
# Executors over a snapshot
# --------------------------------------------------------------------------


def _tf_at(fp, term: str, docs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(tf f32[n], present bool[n]) of `term` for sorted candidate docs
    (index/segment.py tf_at, shared with TurboBM25's bool rescore)."""
    from elasticsearch_tpu_torch.index.segment import tf_at

    return tf_at(fp, term, docs)


def _conjunctive_candidates(plan: FlatPlan, snap: ServingSnapshot,
                            part: _Partition):
    """(cand docs, aligned phrase (pf, boost, idf_sum) list) for one
    partition after all required-clause narrowing (intersection, phrase
    verify, must_not, live) — shared by the host scoring path and the
    count-only totals pass used when TurboBM25 serves the hits."""
    seg = part.segment
    fp = seg.postings.get(plan.field) if plan.field else None
    req: List[np.ndarray] = []
    for t, _ in plan.conj:
        if fp is None:
            return None
        docs = _post_docs(fp, t)
        if not len(docs):
            return None
        req.append(docs)
    for f, terms in plan.filters:
        fpf = seg.postings.get(f)
        if fpf is None:
            return None
        arrs = [_post_docs(fpf, t) for t in terms]
        arrs = [a for a in arrs if len(a)]
        if not arrs:
            return None
        group = arrs[0] if len(arrs) == 1 else np.unique(np.concatenate(arrs))
        req.append(group)
    cand: Optional[np.ndarray] = None
    if req:
        req.sort(key=len)
        cand = req[0]
        for s in req[1:]:
            cand = cand[np.isin(cand, s, assume_unique=True)]
            if not len(cand):
                return None

    # phrase conjunction + per-phrase frequencies, kept aligned with `cand`
    phrase_pf: List[Tuple[np.ndarray, float, float]] = []  # (pf, boost, idf_sum)
    for terms, slop, boost in plan.phrases:
        if fp is None:
            return None
        docs, pf = phrase_freqs(fp, terms, slop=slop, docs_filter=cand)
        if not len(docs):
            return None
        if cand is not None and len(docs) < len(cand):
            sel = np.searchsorted(cand, docs)
            phrase_pf = [(x[sel], b, i) for x, b, i in phrase_pf]
        cand = docs
        idf_sum = sum(snap.idf(plan.field, t) for t in terms)
        phrase_pf.append((pf, boost, idf_sum))
    if cand is None or not len(cand):
        return None

    def narrow(keep: np.ndarray):
        nonlocal cand, phrase_pf
        cand = cand[keep]
        phrase_pf = [(x[keep], b, i) for x, b, i in phrase_pf]

    for f, terms in plan.must_not:
        fpf = seg.postings.get(f)
        if fpf is None:
            continue
        for t in terms:
            bad = _post_docs(fpf, t)
            if len(bad) and len(cand):
                narrow(~np.isin(cand, bad, assume_unique=True))
    if len(cand) and not part.all_live:
        narrow(part.live[cand])
    if not len(cand):
        return None
    return cand, phrase_pf


def _conjunctive_partition(plan: FlatPlan, snap: ServingSnapshot,
                           part: _Partition):
    """(docs, scores) for one partition — all host columnar ops."""
    r = _conjunctive_candidates(plan, snap, part)
    if r is None:
        return None
    cand, phrase_pf = r
    seg = part.segment
    fp = seg.postings.get(plan.field) if plan.field else None

    _, avgdl, _ = snap.stats(plan.field) if plan.field else (0, 1.0, None)
    dl = fp.doc_len[cand] if fp is not None else np.zeros(len(cand), np.float32)
    norm = K1 * (1.0 - B + B * dl / max(avgdl, 1e-9))
    scores = np.zeros(len(cand), np.float64)
    for t, w in plan.conj:
        tf, _ = _tf_at(fp, t, cand)
        scores += w * snap.idf(plan.field, t) * tf * (K1 + 1.0) / (tf + norm)
    for t, w in plan.should:
        tf, present = _tf_at(fp, t, cand)
        contrib = (w * snap.idf(plan.field, t) * tf * (K1 + 1.0)
                   / np.maximum(tf + norm, 1e-9))
        scores += np.where(present, contrib, 0.0)
    for pf, boost, idf_sum in phrase_pf:
        if boost == 0.0:
            continue
        scores += boost * idf_sum * pf * (K1 + 1.0) / (pf + norm)
    return cand, scores.astype(np.float32)


class ServingContext:
    """Owns the snapshot cache for one index; entry point for the fast path.

    Kernel errors (`KernelBuildError`, `KernelLaunchError`) propagate to the
    caller, where the reference declines on any error: a kernel that does
    not build or launch is a fault of the port, never served around by the
    dense executor."""

    def __init__(self, index_service):
        self.svc = index_service
        self._snapshot: Optional[ServingSnapshot] = None
        self._lock = threading.Lock()

    def snapshot(self) -> ServingSnapshot:
        # cheap identity probe first: no searcher acquisition (and no live-
        # mask copies) on the hot path when the cached snapshot is current
        key = tuple((sid,) + sv for sid, s in enumerate(self.svc.shards)
                    for sv in s.searcher_version())
        with self._lock:
            snap = self._snapshot
            if snap is not None and snap.key() == key:
                return snap
            searchers = [s.acquire_searcher() for s in self.svc.shards]
            snap = ServingSnapshot(searchers, self.svc.device)
            self._snapshot = snap
            return snap

    # ---- entry points ----

    def try_search(self, request: dict, search_type: str,
                   task=None) -> Optional[dict]:
        out = self.try_msearch([request], search_type, task=task)
        return out[0] if out else None

    def try_msearch(self, requests: Sequence[dict], search_type: str,
                    task=None) -> List[Optional[dict]]:
        """Serve each eligible body; None where the dense path must run.
        Disjunctive bodies on the same field batch into ONE dispatch."""
        if len(self.svc.shards) > 1 and search_type != "dfs_query_then_fetch":
            return [None] * len(requests)
        plans = [extract_plan(r, self.svc.mapper) for r in requests]
        kplans = [extract_knn_plan(r, self.svc.mapper) if p is None else None
                  for p, r in zip(plans, requests)]
        if not any(plans) and not any(kplans):
            return [None] * len(plans)
        snap = self.snapshot()
        if snap.total_docs == 0:
            return [None] * len(plans)
        out: List[Optional[dict]] = [None] * len(plans)

        # kNN-only bodies on the same vector field batch into one dispatch
        knn_by_field: Dict[str, List[int]] = {}
        for i, kp in enumerate(kplans):
            if kp is not None:
                knn_by_field.setdefault(kp.field, []).append(i)
        for field, idxs in knn_by_field.items():
            try:
                results = self._knn_batch(
                    field, [kplans[i] for i in idxs],
                    [requests[i] for i in idxs], snap, task=task)
                for i, r in zip(idxs, results):
                    out[i] = r
            except (TaskCancelledError, KernelBuildError, KernelLaunchError):
                raise
            except Exception as e:
                _note_reject_error(e, "knn_batch")

        # group disjunctive plans by field for batched device dispatch
        by_field: Dict[str, List[int]] = {}
        for i, plan in enumerate(plans):
            if plan is None:
                continue
            start = time.monotonic()
            if plan.is_disjunctive:
                if self._disj_servable(plan, snap, requests[i]):
                    by_field.setdefault(plan.field, []).append(i)
                continue
            try:
                if task is not None:
                    task.check()
                out[i] = self._conjunctive(plan, snap, requests[i], start,
                                           task=task)
            except (TaskCancelledError, KernelBuildError, KernelLaunchError):
                raise
            except SearchPhaseExecutionError as e:
                # allow_partial_search_results=false with a faulted shard:
                # a request-level error, not a dense retry
                out[i] = e
            except Exception as e:
                _note_reject_error(e, "conjunctive")
                out[i] = None
        for field, idxs in by_field.items():
            try:
                results = self._disjunctive_batch(
                    field, [plans[i] for i in idxs],
                    [requests[i] for i in idxs], snap, task=task)
                for i, r in zip(idxs, results):
                    out[i] = r
            except (TaskCancelledError, KernelBuildError, KernelLaunchError):
                raise
            except Exception as e:
                _note_reject_error(e, "disjunctive_batch")
        return out

    def try_query_phase(self, request: dict, task=None):
        """Query-phase-only fast path for a per-shard executor: eligible
        plans run on this shard's Turbo engine and come back as a
        QuerySearchResult (leaf/ord hits, no fetch). Stats are shard-local
        (the dense executor's query_then_fetch scope). None when the dense
        executor must run."""
        from elasticsearch_tpu_torch.search.query_phase import (
            QuerySearchResult, ShardHit,
        )

        if len(self.svc.shards) != 1:
            return None             # per-shard adapter always has one
        plan = extract_plan(request, self.svc.mapper)
        if plan is None:
            return None
        snap = self.snapshot()
        if snap.total_docs == 0:
            return None
        k = int(request.get("from", 0)) + int(request.get("size", 10))
        deadline = self._deadline_for(request)
        check = self._combined_check(task, [deadline])
        flog: List[FaultRecord] = []
        timed_out = QuerySearchResult(total=0, relation="gte", hits=[],
                                      max_score=None, timed_out=True)
        if plan.is_disjunctive:
            if not self._disj_servable(plan, snap, request):
                return None
            eng = snap.engine(plan.field)
            # engines that do not degrade themselves (BlockMax) get the
            # circuit enforced here, the dense executor as their fallback
            health = (getattr(eng, "health", None)
                      if getattr(eng, "kind", "") != "turbo" else None)
            if health is not None and not health.allow_device():
                health.record_fallback(1)
                return None             # circuit open: dense executor tier
            from elasticsearch_tpu_torch.threadpool.scheduler import (
                serving_dispatch,
            )

            try:
                t_dev = time.monotonic()
                scores, parts, ords = serving_dispatch(
                    eng, [plan.disj], k, check=check, fault_log=flog)
                dev_ms = (time.monotonic() - t_dev) * 1e3
            except DispatchDeadlineError:
                _count_serving("fastpath_timed_out")
                return timed_out
            except DeviceFaultError as e:
                if health is not None:
                    health.record_fault(e)
                _count_serving("fastpath_device_fault")
                return None             # dense executor serves this one
            if health is not None:
                health.record_success()
            total_rel = self._disj_total
        elif plan.is_conjunctive and plan.field is not None:
            # conjunctive / phrase plans serve through the same engine when
            # it is Turbo; otherwise the dense executor is the query phase
            eng = snap.engine(plan.field)
            if getattr(eng, "kind", "") != "turbo":
                return None
            spec = _turbo_bool_spec(plan)
            if spec is None:
                return None
            try:
                t_dev = time.monotonic()
                scores, parts, ords = eng.search_bool(
                    [spec], k=k, check=check, fault_log=flog)
                dev_ms = (time.monotonic() - t_dev) * 1e3
                # search_bool bypasses the scheduler: the conjunctive
                # path's device-histogram site
                record_device(eng, 1, dev_ms,
                              engine_name=engine_desc(eng)[0])
            except DispatchDeadlineError:
                _count_serving("fastpath_timed_out")
                return timed_out

            def total_rel(p, sn, req, n):
                return self._conj_total(p, sn, req)
        else:
            return None
        if flog:
            _count_serving("shard_fault_recoveries", len(flog))
        t_demux = time.monotonic()
        hits = []
        max_score = None
        for j in range(k):
            s = float(scores[0, j])
            if s <= 0 or not np.isfinite(s):
                break
            part = snap.partitions[int(parts[0, j])]
            o = int(ords[0, j])
            hits.append(ShardHit(leaf_idx=part.leaf_idx, ord=o, score=s,
                                 global_ord=part.base + o))
            max_score = s if max_score is None else max(max_score, s)
        total, relation = total_rel(plan, snap, request, len(hits))
        demux_ms = (time.monotonic() - t_demux) * 1e3
        metrics.observe("demux", demux_ms)
        tc = tracing.current()
        if tc is not None:
            tc.add_span("demux", demux_ms)
        return QuerySearchResult(
            total=total, relation=relation, hits=hits, max_score=max_score,
            timed_out=bool(deadline is not None and deadline.expired),
            profile=fastpath_profile_nodes(request, eng, dev_ms)
            if request.get("profile") else None)

    # ---- disjunctive (device) ----

    def _disj_servable(self, plan, snap, request) -> bool:
        k = int(request.get("from", 0)) + int(request.get("size", 10))
        max_docs = max(p.segment.n_docs for p in snap.partitions)
        return k <= max_docs

    @staticmethod
    def _deadline_for(request) -> Optional[Deadline]:
        """Request timeout -> Deadline (None when no timeout is set)."""
        t = request.get("timeout")
        if t is None:
            return None
        ms = parse_timeout_ms(t)
        return Deadline(ms) if ms is not None else None

    @staticmethod
    def _combined_check(task, deadlines):
        """Cooperative check threaded into engine dispatches: task
        cancellation raises; an expired request deadline raises
        DispatchDeadlineError so the request yields timed_out partial
        results."""
        tcheck = task.check if task is not None else None
        dls = [d for d in deadlines if d is not None]
        if tcheck is None and not dls:
            return None

        def check():
            if tcheck is not None:
                tcheck()
            for d in dls:
                if d.expired:
                    raise DispatchDeadlineError()
        return check

    def _disjunctive_batch(self, field: str, plans, requests, snap, task=None):
        start = time.monotonic()
        bm = snap.engine(field)
        k = max(int(r.get("from", 0)) + int(r.get("size", 10))
                for r in requests)
        queries = [p.disj for p in plans]
        deadlines = [self._deadline_for(r) for r in requests]
        check = self._combined_check(task, deadlines)
        # TurboEngine degrades itself (internal circuit + host tier);
        # engines that can't (BlockMax) get the circuit enforced here,
        # with the dense executor as their fallback tier
        health = (getattr(bm, "health", None)
                  if getattr(bm, "kind", "") != "turbo" else None)
        if health is not None and not health.allow_device():
            health.record_fallback(len(queries))
            return [None] * len(requests)
        flog: List[FaultRecord] = []
        # small batches continuous-batch with concurrent dispatches on the
        # same engine (threadpool/scheduler); large msearch batches go
        # direct
        from elasticsearch_tpu_torch.threadpool.scheduler import (
            serving_dispatch,
        )

        try:
            t_dev = time.monotonic()
            scores, parts, ords = serving_dispatch(
                bm, queries, k, check=check, fault_log=flog)
            dev_ms = (time.monotonic() - t_dev) * 1e3
        except DispatchDeadlineError:
            _count_serving("fastpath_timed_out")
            # expired requests report timed_out partials; the rest re-run
            # on the dense executor
            return [self._timed_out_response(r, snap, start)
                    if d is not None and d.timed_out else None
                    for r, d in zip(requests, deadlines)]
        except DeviceFaultError as e:
            if health is not None:
                health.record_fault(e)
            _count_serving("fastpath_device_fault")
            return [None] * len(requests)
        if health is not None:
            health.record_success()
        if flog:
            _count_serving("shard_fault_recoveries", len(flog))
        t_demux = time.monotonic()
        extracted = []
        for qi, (plan, request) in enumerate(zip(plans, requests)):
            hits = []
            for j in range(k):
                if scores[qi, j] <= 0 or not np.isfinite(scores[qi, j]):
                    break
                hits.append((int(parts[qi, j]), int(ords[qi, j]),
                             float(scores[qi, j])))
            total, relation = self._disj_total(plan, snap, request, len(hits))
            extracted.append((hits, total, relation))
        demux_ms = (time.monotonic() - t_demux) * 1e3
        metrics.observe("demux", demux_ms)
        tc = tracing.current()
        if tc is not None:
            tc.add_span("demux", demux_ms, batch=len(requests))
        results = []
        for qi, request in enumerate(requests):
            hits, total, relation = extracted[qi]
            d = deadlines[qi]
            try:
                results.append(self._respond(
                    request, snap, hits, total, relation, start,
                    timed_out=bool(d is not None and d.expired),
                    faults=flog,
                    profile_nodes=fastpath_profile_nodes(request, bm, dev_ms)
                    if request.get("profile") else None))
            except SearchPhaseExecutionError as e:
                results.append(e)
        return results

    def _knn_batch(self, field: str, kplans, requests, snap, task=None):
        """kNN-only bodies on one vector field: resolve each filter to
        per-partition candidate masks and serve filter + kNN in one
        quantized dispatch per chunk. None per body where the dense
        executor must run."""
        from elasticsearch_tpu_torch.parallel.knn import KnnWork

        start = time.monotonic()
        eng = snap.knn_engine(field)
        if eng is None:
            return [None] * len(requests)
        k = max(kp.k for kp in kplans)
        works = []
        for kp in kplans:
            filters = None
            if kp.filter_plan is not None:
                filters = [_knn_filter_mask(kp.filter_plan, p.segment)
                           for p in snap.partitions]
            works.append(KnnWork(np.asarray(kp.vector, np.float32),
                                 filters=filters))
        deadlines = [self._deadline_for(r) for r in requests]
        check = self._combined_check(task, deadlines)
        flog: List[FaultRecord] = []
        from elasticsearch_tpu_torch.threadpool.scheduler import (
            serving_dispatch,
        )

        try:
            t_dev = time.monotonic()
            scores, parts, ords = serving_dispatch(
                eng, works, k, check=check, fault_log=flog)
            dev_ms = (time.monotonic() - t_dev) * 1e3
        except DispatchDeadlineError:
            _count_serving("fastpath_timed_out")
            return [self._timed_out_response(r, snap, start)
                    if d is not None and d.timed_out else None
                    for r, d in zip(requests, deadlines)]
        except DeviceFaultError as e:
            eng.health.record_fault(e)
            _count_serving("fastpath_device_fault")
            return [None] * len(requests)
        if flog:
            _count_serving("shard_fault_recoveries", len(flog))
        t_demux = time.monotonic()
        extracted = []
        for qi, kp in enumerate(kplans):
            hits = []
            for j in range(min(k, kp.k)):
                if scores[qi, j] <= 0 or not np.isfinite(scores[qi, j]):
                    break
                hits.append((int(parts[qi, j]), int(ords[qi, j]),
                             float(scores[qi, j])))
            # kNN totals are the k nearest by definition, always exact
            extracted.append((hits, len(hits), "eq"))
        demux_ms = (time.monotonic() - t_demux) * 1e3
        metrics.observe("demux", demux_ms)
        tc = tracing.current()
        if tc is not None:
            tc.add_span("demux", demux_ms, batch=len(requests))
        results = []
        for qi, request in enumerate(requests):
            hits, total, relation = extracted[qi]
            d = deadlines[qi]
            try:
                results.append(self._respond(
                    request, snap, hits, total, relation, start,
                    timed_out=bool(d is not None and d.expired),
                    faults=flog,
                    profile_nodes=fastpath_profile_nodes(request, eng, dev_ms)
                    if request.get("profile") else None))
            except SearchPhaseExecutionError as e:
                results.append(e)
        return results

    def _disj_total(self, plan, snap, request, n_found) -> Tuple[int, str]:
        track = request.get("track_total_hits", 10000)
        if track is False:
            return n_found, "gte"
        track_n = 1 << 62 if track is True else int(track)
        all_live = all(p.all_live for p in snap.partitions)
        dfs = []
        for t, _ in plan.disj:
            df = 0
            for fp in snap.field_fps(plan.field):
                if fp is not None and t in fp.term_to_ord:
                    df += int(fp.doc_freq[fp.term_to_ord[t]])
            dfs.append(df)
        # df is an exact lower bound on the union only when nothing is deleted
        if all_live and max(dfs, default=0) >= track_n:
            return track_n, "gte"
        count = 0
        terms = {t for t, _ in plan.disj}
        for p in snap.partitions:
            fp = p.segment.postings.get(plan.field)
            if fp is None:
                continue
            arrs = [_post_docs(fp, t) for t in terms]
            arrs = [a for a in arrs if len(a)]
            if not arrs:
                continue
            u = arrs[0] if len(arrs) == 1 else np.unique(np.concatenate(arrs))
            count += int(p.live[u].sum()) if not p.all_live else len(u)
        if count > track_n:
            return track_n, "gte"
        return count, "eq"

    # ---- conjunctive (Turbo device path or host columnar) ----

    def _conj_total(self, plan, snap, request) -> Tuple[int, str]:
        """Exact conjunctive hit count (the host scoring path's narrowing,
        no scoring) with the track_total_hits cap — the totals side when
        TurboBM25 serves the hits."""
        total = 0
        for part in snap.partitions:
            r = _conjunctive_candidates(plan, snap, part)
            if r is not None:
                total += len(r[0])
        track = request.get("track_total_hits", 10000)
        if track is False:
            return total, "gte"
        track_n = 1 << 62 if track is True else int(track)
        if total > track_n:
            return track_n, "gte"
        return total, "eq"

    def _conjunctive(self, plan, snap, request, start, task=None):
        k = int(request.get("from", 0)) + int(request.get("size", 10))
        deadline = self._deadline_for(request)
        eng = snap.engine(plan.field) if plan.field else None
        spec = _turbo_bool_spec(plan) \
            if getattr(eng, "kind", "") == "turbo" else None
        if spec is not None:
            # Turbo serves the hits (conjunctive sweep over the int8
            # columns, bitwise rescore); totals come from the same count
            # the host path would have produced
            check = self._combined_check(task, [deadline])
            flog: List[FaultRecord] = []
            try:
                t_dev = time.monotonic()
                scores, parts, ords = eng.search_bool(
                    [spec], k=k, check=check, fault_log=flog)
                dev_ms = (time.monotonic() - t_dev) * 1e3
                # search_bool bypasses the scheduler: the conjunctive
                # path's device-histogram site
                record_device(eng, 1, dev_ms,
                              engine_name=engine_desc(eng)[0])
            except DispatchDeadlineError:
                _count_serving("fastpath_timed_out")
                return self._timed_out_response(request, snap, start)
            if flog:
                _count_serving("shard_fault_recoveries", len(flog))
            hits = []
            for j in range(k):
                s = float(scores[0, j])
                if s <= 0 or not np.isfinite(s):
                    break
                hits.append((int(parts[0, j]), int(ords[0, j]), s))
            total, relation = self._conj_total(plan, snap, request)
            return self._respond(
                request, snap, hits, total, relation, start,
                timed_out=bool(deadline is not None and deadline.expired),
                faults=flog,
                profile_nodes=fastpath_profile_nodes(request, eng, dev_ms)
                if request.get("profile") else None)
        all_s, all_p, all_o = [], [], []
        total = 0
        timed_out = False
        t_host = time.monotonic()
        for pi, part in enumerate(snap.partitions):
            if deadline is not None and deadline.expired:
                # partial results over the partitions scored so far
                timed_out = True
                break
            r = _conjunctive_partition(plan, snap, part)
            if r is None:
                continue
            docs, scores = r
            total += len(docs)
            if len(docs) > k:
                sel = np.lexsort((docs, -scores))[:k]
                docs, scores = docs[sel], scores[sel]
            all_s.append(scores)
            all_p.append(np.full(len(docs), pi, np.int32))
            all_o.append(docs.astype(np.int32))
        if all_s:
            sc = np.concatenate(all_s)
            pp = np.concatenate(all_p)
            oo = np.concatenate(all_o)
            order = np.lexsort((oo, pp, -sc))[:k]
            hits = [(int(pp[i]), int(oo[i]), float(sc[i])) for i in order]
        else:
            hits = []
        track = request.get("track_total_hits", 10000)
        if track is False:
            relation = "gte"
        else:
            track_n = 1 << 62 if track is True else int(track)
            relation = "eq" if total <= track_n else "gte"
            total = min(total, track_n)
        return self._respond(
            request, snap, hits, total, relation, start,
            timed_out=timed_out,
            profile_nodes=fastpath_profile_nodes(
                request, None, (time.monotonic() - t_host) * 1e3,
                parts=len(snap.partitions))
            if request.get("profile") else None)

    # ---- response assembly ----

    def _timed_out_response(self, request, snap, start):
        """Empty partial response for a request whose deadline expired
        before any dispatch completed."""
        return self._respond(request, snap, [], 0, "gte", start,
                             timed_out=True)

    def _shards_section(self, snap, faults_log) -> dict:
        """`_shards` accounting: shards whose device dispatch faulted are
        reported (with a reason entry); recovered ones still count as
        successful (the host tier re-scored them bitwise)."""
        n_shards = len(self.svc.shards)
        out = {"total": n_shards, "successful": n_shards, "skipped": 0,
               "failed": 0}
        if not faults_log:
            return out
        failures = []
        seen = set()
        for fr in faults_log:
            pi = fr.partition
            if pi is not None and 0 <= pi < len(snap.partitions):
                sid = snap.partitions[pi].shard_id
            else:
                sid = 0
            key = (sid, fr.site)
            if key in seen:
                continue
            seen.add(key)
            err = fr.error
            failures.append({
                "shard": sid,
                "index": self.svc.name,
                "status": "recovered" if fr.recovered else "failed",
                "reason": {
                    "type": getattr(err, "error_type",
                                    type(err).__name__),
                    "reason": str(err),
                    **({"site": fr.site} if fr.site else {}),
                },
            })
        hard = sum(1 for f in failures if f["status"] == "failed")
        out["failed"] = hard
        out["successful"] = n_shards - min(hard, n_shards)
        out["failures"] = failures
        return out

    def _respond(self, request, snap, hits, total, relation, start,
                 timed_out=False, faults=None, profile_nodes=None):
        from elasticsearch_tpu_torch.search.fetch_phase import (
            execute_fetch_phase,
        )
        from elasticsearch_tpu_torch.search.query_phase import ShardHit

        if faults and request.get("allow_partial_search_results", True) \
                is False:
            first = faults[0]
            raise SearchPhaseExecutionError(
                f"shard failure during [{first.site}]: {first.error} "
                "(allow_partial_search_results=false)",
                failures=[{"site": fr.site, "partition": fr.partition,
                           "reason": str(fr.error)} for fr in faults])

        from_ = int(request.get("from", 0))
        size = int(request.get("size", 10))
        window = hits[from_: from_ + size]
        max_score = hits[0][2] if hits else None
        out_hits = []
        t_fetch = time.monotonic()
        for pi, ord_, score in window:
            part = snap.partitions[pi]
            sh = ShardHit(leaf_idx=part.leaf_idx, ord=ord_, score=score,
                          global_ord=part.base + ord_)
            fetched = execute_fetch_phase(
                snap.searchers[part.shard_id], [sh], request, self.svc.name)
            hit = fetched[0]
            if hit.get("_score") is None:
                hit["_score"] = score
            out_hits.append(hit)
        fetch_ms = (time.monotonic() - t_fetch) * 1e3
        metrics.observe("fetch", fetch_ms)
        tc = tracing.current()
        if tc is not None:
            tc.add_span("fetch", fetch_ms, hits=len(out_hits))
        took = int((time.monotonic() - start) * 1000)
        resp = {
            "took": took,
            "timed_out": bool(timed_out),
            "_shards": self._shards_section(snap, faults),
            "hits": {
                "total": {"value": total, "relation": relation},
                "max_score": max_score,
                "hits": out_hits,
            },
        }
        if profile_nodes is not None:
            resp["profile"] = {"shards": [{
                "id": f"[{self.svc.name}][0]",
                "searches": [{"query": profile_nodes,
                              "rewrite_time": 0,
                              "collector": []}],
            }]}
        from elasticsearch_tpu_torch.search.response import (
            finalize_hits_envelope,
        )

        return finalize_hits_envelope(resp, request)
