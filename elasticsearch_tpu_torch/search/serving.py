"""The serving path's BM25 and kNN routes (the port of the `match`,
`bool`, `match_phrase` and top-level `knn` routes of
elasticsearch_tpu/search/serving.py).

A request is servable here when it reduces to a flat BM25 plan over one
text field. `extract_plan` flattens the body exactly as the reference
does: a disjunctive plan (match (or), term, bool.should of those) goes to
`TurboEngine.search_many`; a conjunctive one (must, filter, must_not,
match_phrase) becomes a search_bool spec through `_turbo_bool_spec` and
goes to `TurboEngine.search_bool`. `select_bm25_engine` builds the engine.

Scoring stats are index-global (every partition scores with the same
idf/avgdl). Results are exact: the same f32 scores as the reference and
the deterministic (score desc, partition asc, doc asc) order.

A kNN-only body (top-level `knn`, no `query`) becomes a `KnnPlan` through
`extract_knn_plan`; its optional filter flattens in filter context and
`_knn_filter_mask` turns it into per-partition doc masks. `select_knn_engine`
builds the KnnEngine over the partitions, stacked when there are several.

Not ported yet (ROADMAP.md): BlockMax (indices whose columns exceed the
device budget), the fused S > 1 BM25 path, the host columnar bool executor
behind the REST node, ServingSnapshot/ServingContext and the REST node
above them.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from elasticsearch_tpu_torch import device as _device
from elasticsearch_tpu_torch.common import hbm_ledger
from elasticsearch_tpu_torch.common.errors import DeviceFaultError
from elasticsearch_tpu_torch.common.faults import FaultRecord
from elasticsearch_tpu_torch.common.health import EngineHealth
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.search import queries as q
from elasticsearch_tpu_torch.search.queries import parse_query

_ALLOWED_KEYS = {"query", "size", "from", "_source", "stored_fields",
                 "track_total_hits", "version", "seq_no_primary_term",
                 "timeout", "allow_partial_search_results", "profile"}
_MAX_K = 1000
_KNN_ALLOWED_KEYS = (_ALLOWED_KEYS | {"knn"}) - {"query"}

_REJECT_LOCK = threading.Lock()
_LOGGED_REJECT_TYPES: set = set()  # guarded by: _REJECT_LOCK


def _note_reject_error(e: BaseException, where: str) -> None:
    """An unexpected error while flattening declines the fast path, as in
    the reference, but the first one of each (site, type) is logged."""
    tname = type(e).__name__
    with _REJECT_LOCK:
        if (where, tname) in _LOGGED_REJECT_TYPES:
            return
        _LOGGED_REJECT_TYPES.add((where, tname))
    logging.getLogger("search.serving").warning(
        "plan extraction hit an unexpected %s at %s (%s); the request is "
        "declined", tname, where, e, exc_info=True)


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

_BLOCKMAX_TODO = ("the BlockMax engine is not ported yet (ROADMAP.md, queue "
                  "1, item 8: parallel/blockmax.py BlockMaxBM25)")


def _env_cold_df() -> Optional[int]:
    return knob("ES_TPU_TURBO_COLD_DF")


class TurboEngine:
    """Per-partition TurboBM25 engines behind the (scores, partition, ord)
    search_many contract. Mesh-less: partitions run one after another and
    merge through the host `_merge3` (the reference's S == 1 route); a
    partition whose device path faults is served by its host tier, and a
    faulted engine or an open circuit serves the whole batch there."""

    kind = "turbo"

    def __init__(self, turbos: Sequence):
        self.turbos = list(turbos)
        for i, t in enumerate(self.turbos):
            t.part_id = i          # fault-site attribution per partition
        self.health = EngineHealth("turbo")

    def _host_tier_many(self, batches, k):
        """Whole-engine host-exact tier: zero device dispatches, merged
        via _merge3 — bit-identical to the device route."""
        per = [t.search_many_host(batches, k=k) for t in self.turbos]
        return [self._merge3([p[bi] for p in per], len(batch), k)
                for bi, batch in enumerate(batches)]

    def search_many(self, batches: Sequence[List], k: int = 10,
                    fault_log=None):
        log = fault_log if fault_log is not None else []
        n0 = len(log)
        nq = sum(len(b) for b in batches)
        if not self.health.allow_device():
            self.health.record_fallback(nq)
            return self._host_tier_many(batches, k)
        try:
            per = []
            for t in self.turbos:
                try:
                    per.append(t.search_many(batches, k=k))
                except DeviceFaultError as e:
                    log.append(FaultRecord.from_error(e, partition=t.part_id))
                    per.append(t.search_many_host(batches, k=k))
        except DeviceFaultError as e:
            log.append(FaultRecord.from_error(e))
            self.health.record_fault(e)
            self.health.record_fallback(nq)
            return self._host_tier_many(batches, k)
        out = [self._merge3([p[bi] for p in per], len(batch), k)
               for bi, batch in enumerate(batches)]
        if log[n0:]:
            self.health.record_fault(log[-1].error)
        else:
            self.health.record_success()
        return out

    def search_bool(self, queries: Sequence[dict], k: int = 10,
                    fault_log=None):
        """Batched bool top-k through the per-partition conjunctive sweeps:
        (scores [Q, k], partition [Q, k], ord [Q, k]). Fault containment
        as in search_many: an open circuit or a fault outside a partition
        serves the batch from the host tier, a faulted partition is served
        by its own."""
        log = fault_log if fault_log is not None else []
        n0 = len(log)
        if not self.health.allow_device():
            self.health.record_fallback(len(queries))
            return self._merge3([t.search_bool_host(queries, k=k)
                                 for t in self.turbos], len(queries), k)
        try:
            per = []
            for t in self.turbos:
                try:
                    per.append(t.search_bool(queries, k=k))
                except DeviceFaultError as e:
                    log.append(FaultRecord.from_error(e, partition=t.part_id))
                    per.append(t.search_bool_host(queries, k=k))
        except DeviceFaultError as e:
            log.append(FaultRecord.from_error(e))
            self.health.record_fault(e)
            self.health.record_fallback(len(queries))
            return self._merge3([t.search_bool_host(queries, k=k)
                                 for t in self.turbos], len(queries), k)
        out = self._merge3(per, len(queries), k)
        if log[n0:]:
            self.health.record_fault(log[-1].error)
        else:
            self.health.record_success()
        return out

    def search_phrase(self, phrases: Sequence[List[str]], k: int = 10,
                      slop: int = 0, fault_log=None):
        """Batched match_phrase top-k: sugar over search_bool; slop-0
        phrases ride the adjacency columns, other slops the exact host
        positional path."""
        specs = [{"phrases": [(list(p), int(slop), 1.0)]} for p in phrases]
        return self.search_bool(specs, k=k, fault_log=fault_log)

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
        return sum(t.hbm_bytes() for t in self.turbos)

    def prebuild_columns(self) -> int:
        return sum(t.prebuild_columns() for t in self.turbos)

    @property
    def stats(self) -> dict:
        agg: Dict[str, float] = {}
        for t in self.turbos:
            for key, v in t.stats.items():
                agg[key] = agg.get(key, 0) + v
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
    (objects with `n_docs` and a `postings` dict of FieldPostings). Raises
    NotImplementedError where the reference would select BlockMax."""
    from elasticsearch_tpu_torch.parallel.kernels import SW
    from elasticsearch_tpu_torch.parallel.spmd import build_stacked_bm25
    from elasticsearch_tpu_torch.parallel.turbo import COLD_DF, TurboBM25

    dev = _device.resolve(device)
    if cold_df is None:
        cold_df = _env_cold_df()
    if not turbo_eligible(segments, field, device=dev,
                          hbm_budget_bytes=hbm_budget_bytes, cold_df=cold_df):
        raise NotImplementedError(
            f"field [{field}] is not Turbo-eligible "
            f"({hbm_ledger.last_routing()['reason']}); {_BLOCKMAX_TODO}")
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
    return TurboEngine(turbos)


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
