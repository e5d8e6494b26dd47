"""Query phase: run the query tree over all segments, collect top hits.

Re-designs the reference QueryPhase (ref: search/query/QueryPhase.java:158
executeInternal — collector chain assembly, total-hits tracking, sort) for
dense device execution: per leaf we get (scores, mask), AND in the live mask,
count totals, and collect top-k with lax.top_k; score-sorted collection stays
on device, field-sorted collection gathers exact f64 columns host-side.

The port's copy of elasticsearch_tpu/search/query_phase.py: the hybrid
knn + query sum, the slice mask and the total run in torch on the leaf's
device, score-sorted collection goes through `ops.masked_top_k` (ties to
the lower ordinal; its padding slots are read only through `valid`), and
host reads of device tensors are `.cpu().numpy()` (`executor.to_host`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
from elasticsearch_tpu_torch.index.engine import EngineSearcher
from elasticsearch_tpu_torch.mapper.mapper_service import MapperService
from elasticsearch_tpu_torch.ops import masked_top_k, total_hits
from elasticsearch_tpu_torch.search import queries as q
from elasticsearch_tpu_torch.search.executor import (
    LeafContext, QueryExecutor, ShardStats, leaves, to_host,
)
from elasticsearch_tpu_torch.search.queries import parse_query


@dataclass
class ShardHit:
    leaf_idx: int
    ord: int
    score: float
    global_ord: int
    sort_values: Optional[List[Any]] = None


@dataclass
class QuerySearchResult:
    total: int
    relation: str                      # "eq" | "gte"
    hits: List[ShardHit]
    max_score: Optional[float]
    # reduced aggregation PARTIALS for this shard (coordinator finalizes)
    aggregations: Optional[dict] = None
    timed_out: bool = False
    terminated_early: bool = False
    profile: Optional[list] = None


def parse_sort(sort_spec) -> List[Tuple[str, str]]:
    """Normalize the sort element to [(field, order)]."""
    if sort_spec is None:
        return []
    if isinstance(sort_spec, (str, dict)):
        sort_spec = [sort_spec]
    out = []
    for s in sort_spec:
        if isinstance(s, str):
            out.append((s, "desc" if s == "_score" else "asc"))
        elif isinstance(s, dict):
            for fname, spec in s.items():
                order = spec.get("order", "asc") if isinstance(spec, dict) else str(spec)
                out.append((fname, order))
    return out


def execute_query_phase(
    searcher: EngineSearcher,
    mapper: MapperService,
    request: dict,
    *,
    executor: QueryExecutor | None = None,
    task=None,
    breaker=None,
) -> QuerySearchResult:
    from elasticsearch_tpu_torch.tasks.task_manager import Deadline, parse_timeout_ms

    lvs = leaves(searcher)
    stats = ShardStats(searcher.views)
    ex = executor or QueryExecutor(mapper, stats)
    if task is not None:
        ex.check = task.check
    profiler = None
    if request.get("profile"):
        from elasticsearch_tpu_torch.search.executor import QueryProfiler

        profiler = QueryProfiler()
        ex.profiler = profiler
    deadline = Deadline(parse_timeout_ms(request.get("timeout")))
    terminate_after = request.get("terminate_after") or None  # 0 = not set
    terminated_early = False

    query = parse_query(request.get("query")) if request.get("query") else None
    knn_spec = request.get("knn")
    size = int(request.get("size", 10))
    from_ = int(request.get("from", 0))
    min_score = request.get("min_score")
    sort = parse_sort(request.get("sort"))
    collapse_field = (request.get("collapse") or {}).get("field")
    if collapse_field and not sort:
        # collapse needs the full candidate stream per leaf, not a device
        # top-k: route through sorted collection on score
        sort = [("_score", "desc")]
    track = request.get("track_total_hits", 10000)
    k = from_ + size

    # pagination cursors (ref: SearchAfterBuilder / scroll continuation)
    after = None
    if request.get("search_after") is not None:
        if not sort:
            raise IllegalArgumentError("search_after requires a sort")
        after = (_after_prefix(sort, request["search_after"]), None, 0)
    full = request.get("_after_full")
    if full is not None:
        if not sort:
            raise IllegalArgumentError("cursor continuation requires a sort")
        after = (_after_prefix(sort, full["values"]),
                 (int(full["shard_id"]), int(full["ord"])),
                 int(request.get("_shard_id", 0)))

    if query is None and knn_spec is None:
        query = q.MatchAllQuery()

    knn_query = None
    if knn_spec is not None:
        if isinstance(knn_spec, list):
            knn_spec = knn_spec[0]
        knn_query = q.KnnQuery(
            field=knn_spec["field"],
            query_vector=knn_spec["query_vector"],
            k=int(knn_spec.get("k", 10)),
            num_candidates=int(knn_spec.get("num_candidates", 100)),
            filter=parse_query(knn_spec["filter"]) if knn_spec.get("filter") else None,
            boost=float(knn_spec.get("boost", 1.0)),
        )
        if k == from_ + size:
            k = max(k, knn_query.k)

    aggs_spec = request.get("aggs") or request.get("aggregations")

    total = 0
    collected: List[ShardHit] = []
    leaf_masks: List[np.ndarray] = []

    # knn contributes only the k nearest live docs shard-wide (ref: ES 8 knn
    # section semantics — per-shard top-k then coordinator merge)
    knn_leaf_results: List[Tuple[np.ndarray, np.ndarray]] = []
    if knn_query is not None:
        per_leaf = []
        for leaf in lvs:
            ks, km = ex.execute(knn_query, leaf)
            km = km & leaf.live_dev()
            per_leaf.append((to_host(ks), to_host(km)))
        flat = np.concatenate([np.where(m, s, -np.inf) for s, m in per_leaf]) \
            if per_leaf else np.empty(0, np.float32)
        kk = min(knn_query.k, len(flat))
        keep = np.zeros(len(flat), bool)
        if kk > 0:
            top = np.argpartition(-flat, kk - 1)[:kk]
            keep[top[np.isfinite(flat[top])]] = True
        off = 0
        for s, m in per_leaf:
            knn_leaf_results.append((s, keep[off: off + len(s)]))
            off += len(s)

    for leaf_idx, leaf in enumerate(lvs):
        if leaf.n_docs == 0:
            continue
        if task is not None:
            task.check()
        if deadline.expired or (terminate_after is not None
                                and total >= int(terminate_after)):
            terminated_early = terminate_after is not None and \
                total >= int(terminate_after)
            break
        if query is not None:
            scores, mask = ex.execute(query, leaf)
        else:
            scores = leaf.zeros(torch.float32)
            mask = leaf.zeros(torch.bool)
        if knn_query is not None:
            ks, km = knn_leaf_results[leaf_idx]
            ks_dev = leaf.up(np.where(km, ks, 0.0))
            km_dev = leaf.up(km)
            # hybrid: scores sum where both match (ES 8 combined knn+query)
            scores = scores + ks_dev
            mask = mask | km_dev if query is not None else km_dev
        mask = mask & leaf.live_dev()
        slice_spec = request.get("slice")
        if slice_spec is not None:
            mask = mask & leaf.up(_slice_mask(leaf, slice_spec))
        if min_score is not None:
            mask = mask & (scores >= float(min_score))
        total += int(total_hits(mask))
        if aggs_spec:
            leaf_masks.append((leaf, to_host(mask), to_host(scores)))

        if sort:
            leaf_hits = _collect_sorted(leaf, leaf_idx, scores, mask, sort,
                                        None if collapse_field else k,
                                        after=after)
            if collapse_field:
                # keep the best hit of each of the top-k groups (ref:
                # CollapsingTopDocsCollector — shards return k GROUPS)
                leaf_hits = _leaf_collapse(leaf, leaf_hits, collapse_field, k)
            collected.extend(leaf_hits)
        else:
            kk = min(k, leaf.n_docs)
            if kk == 0:
                continue
            top_s, top_o, valid = masked_top_k(scores, mask, k=kk)
            top_s = to_host(top_s)
            top_o = to_host(top_o)
            valid = to_host(valid)
            for s, o, v in zip(top_s, top_o, valid):
                if v:
                    collected.append(ShardHit(leaf_idx, int(o), float(s), leaf.base + int(o)))

    if sort:
        keyed = [((_sort_key(h, sort), h.global_ord), h) for h in collected]
        keyed.sort(key=lambda kv: kv[0])
        merged = [h for _, h in keyed]
        if collapse_field:
            merged = _collapse_ranked(
                [(h, collapse_value(lvs[h.leaf_idx].segment, h.ord,
                                    collapse_field)) for h in merged], k)
        else:
            merged = merged[:k]
    else:
        collected.sort(key=lambda h: (-h.score, h.global_ord))
        merged = collected[:k]

    # second-pass window rescoring (ref: search/rescore/RescorePhase.java:1
    # — the shard rescores its top window_size hits with a second query
    # before the coordinator merge)
    rescore_spec = request.get("rescore")
    if rescore_spec:
        if sort and not (len(sort) == 1 and sort[0][0] == "_score"):
            raise IllegalArgumentError(
                "Cannot use [sort] option in conjunction with [rescore].")
        merged = _apply_rescores(lvs, ex, merged, rescore_spec)

    # the shard returns the full top-(from+size) window; the COORDINATOR
    # applies `from` after the cross-shard merge (ref: SearchPhaseController
    # sortDocs — shards cannot know which of their hits the offset skips)
    window = merged
    max_score = None
    if not sort and merged:
        max_score = max(h.score for h in merged)

    relation = "eq"
    if track is not True and isinstance(track, bool) is False:
        threshold = int(track)
        if total > threshold:
            relation = "gte"
            total = min(total, threshold)
    elif track is False:
        relation = "gte"

    agg_partials = None
    if aggs_spec:
        from elasticsearch_tpu_torch.search.aggregations import (
            AggContext, collect_leaf, parse_aggs, reduce_partials,
        )

        aggs, _ = parse_aggs(aggs_spec)
        partials = []
        for leaf, m, sc in leaf_masks:
            if task is not None:
                task.check()
            partials.append(collect_leaf(
                aggs, AggContext(leaf=leaf, mapper=mapper, executor=ex,
                                 live=to_host(leaf.live_dev()),
                                 scores=sc, breaker=breaker), m))
        # reduce leaves within the shard; the coordinator reduces shards and
        # finalizes (ref P6: partials stay commutative until the final reduce)
        agg_partials = reduce_partials(aggs, partials)

    return QuerySearchResult(total=total, relation=relation, hits=window,
                             max_score=max_score, aggregations=agg_partials,
                             timed_out=deadline.timed_out,
                             terminated_early=terminated_early,
                             profile=profiler.tree() if profiler else None)


def _apply_rescores(lvs, ex, merged: List[ShardHit],
                    rescore_spec) -> List[ShardHit]:
    """Re-rank the top window_size hits with each rescore query in turn
    (ref: QueryRescorer.combine — a window hit that fails to match the
    rescore query keeps query_weight * original; matches combine by
    score_mode). Hits beyond the window keep their order below it."""
    specs = rescore_spec if isinstance(rescore_spec, list) else [rescore_spec]
    for spec in specs:
        if not isinstance(spec, dict) or "query" not in spec:
            raise IllegalArgumentError("rescore requires a [query] element")
        window_size = int(spec.get("window_size", 10))
        qspec = spec["query"]
        rq = parse_query(qspec["rescore_query"])
        qw = float(qspec.get("query_weight", 1.0))
        rqw = float(qspec.get("rescore_query_weight", 1.0))
        mode = qspec.get("score_mode", "total")
        if mode not in ("total", "multiply", "avg", "max", "min"):
            raise IllegalArgumentError(
                f"[rescore] illegal score_mode [{mode}]")
        window = merged[:window_size]
        tail = merged[window_size:]
        by_leaf: dict = {}
        for h in window:
            by_leaf.setdefault(h.leaf_idx, []).append(h)
        out = []
        for leaf_idx, hits in by_leaf.items():
            scores, mask = ex.execute(rq, lvs[leaf_idx])
            s = to_host(scores)
            m = to_host(mask)
            for h in hits:
                orig = qw * h.score
                if bool(m[h.ord]):
                    sec = rqw * float(s[h.ord])
                    combined = {"total": orig + sec,
                                "multiply": orig * sec,
                                "avg": (orig + sec) / 2.0,
                                "max": max(orig, sec),
                                "min": min(orig, sec)}[mode]
                else:
                    combined = orig
                out.append(ShardHit(h.leaf_idx, h.ord, float(combined),
                                    h.global_ord, h.sort_values))
        out.sort(key=lambda h: (-h.score, h.global_ord))
        merged = out + tail
    return merged


def _slice_mask(leaf, slice_spec) -> np.ndarray:
    """Sliced scroll (ref P11: SliceBuilder — hash(_id) % max == id splits
    a scan into independent workers). CRC32 of the doc id: stable across
    processes, cached per (segment, max)."""
    import zlib

    sid = int(slice_spec.get("id", 0))
    smax = int(slice_spec.get("max", 1))
    if smax < 1 or not (0 <= sid < smax):
        raise IllegalArgumentError(
            f"slice id [{sid}] must be in [0, max [{smax}])")
    seg = leaf.segment
    key = f"slicemod:{smax}"
    mods = seg._device.get(key)
    if mods is None:
        mods = np.asarray([zlib.crc32(d.encode()) % smax
                           for d in seg.doc_ids], np.int32)
        seg._device[key] = mods
    return mods == sid


def collapse_value(seg, ord_: int, field: str):
    """Single doc-values entry used for field collapsing (ref:
    search/collapse/CollapseBuilder — keyword or numeric, single-valued)."""
    kc = seg.keyword.get(field)
    if kc is not None and kc.exists[ord_]:
        return kc.terms[kc.ords[ord_]]
    nc = seg.numeric.get(field)
    if nc is not None and nc.exists[ord_]:
        return float(nc.values[ord_])
    return None


def _collapse_ranked(ranked, k):
    """First (best-ranked) hit per collapse value; None groups pass through
    uncollapsed (ES: missing values are not grouped together)."""
    seen = set()
    out = []
    for h, v in ranked:
        if v is not None:
            if v in seen:
                continue
            seen.add(v)
        out.append(h)
        if len(out) >= k:
            break
    return out


def _leaf_collapse(leaf: LeafContext, hits, field: str, k: int):
    return _collapse_ranked(
        [(h, collapse_value(leaf.segment, h.ord, field)) for h in hits], k)


def _collect_sorted(leaf: LeafContext, leaf_idx: int, scores, mask, sort, k,
                    after=None) -> List[ShardHit]:
    """after: optional (prefix_key, shard_key, shard_id) — keep only hits
    STRICTLY after the cursor in the canonical (sort, shard, ord) order.
    shard_key is None for user search_after (prefix-only, ties skipped —
    ES semantics: add a tiebreaker field for gapless pagination)."""
    mask_np = to_host(mask)
    cand = np.nonzero(mask_np)[0]
    if len(cand) == 0:
        return []
    scores_np = to_host(scores)
    out = []
    sort_cols = []
    for fname, order in sort:
        if fname in ("_score",):
            sort_cols.append(scores_np[cand])
        elif fname == "_doc":
            sort_cols.append(cand.astype(np.float64))
        else:
            col = leaf.segment.numeric.get(fname)
            if col is not None:
                raw = col.values if order == "asc" else col.max_values
                vals = np.where(col.exists[cand], raw[cand],
                                np.inf if order == "asc" else -np.inf)
                sort_cols.append(vals)
            else:
                kc = leaf.segment.keyword.get(fname)
                if kc is not None:
                    terms = kc.terms
                    # multi-valued sort mode: min for asc, max for desc (ref:
                    # search/sort/FieldSortBuilder default sort modes)
                    col_ords = kc.ords if order == "asc" else kc.max_ords
                    missing = "￿" if order == "asc" else ""
                    vals = [terms[o] if o >= 0 else missing for o in col_ords[cand]]
                    sort_cols.append(np.asarray(vals, object))
                else:
                    sort_cols.append(np.full(len(cand), np.inf))
    for i, ord_ in enumerate(cand):
        sv = [c[i] for c in sort_cols]
        out.append(ShardHit(leaf_idx, int(ord_), float(scores_np[ord_]),
                            leaf.base + int(ord_), sort_values=sv))
    if after is not None:
        prefix, shard_key, shard_id = after
        kept = []
        for h in out:
            hk = _sort_key(h, sort)
            if hk > prefix:
                kept.append(h)
            elif hk == prefix and shard_key is not None and \
                    (shard_id, h.global_ord) > shard_key:
                kept.append(h)
        out = kept
    # local truncation: sort + cut to k to bound merge cost (k=None: caller
    # needs the full stream, e.g. for collapse grouping)
    out.sort(key=lambda h: (_sort_key(h, sort), h.global_ord))
    return out if k is None else out[:k]


def _sort_key(hit: ShardHit, sort) -> tuple:
    """Comparable prefix from the hit's sort values — NO tiebreaker; callers
    append (shard_id, global_ord) as needed so local sort, coordinator merge
    and cursor comparison all share one canonical total order."""
    return _key_from_values(hit.sort_values, sort)


def _key_from_values(values, sort) -> tuple:
    key = []
    for (fname, order), v in zip(sort, values):
        if fname == "_score":
            key.append(-float(v) if order == "desc" else float(v))
        elif isinstance(v, str):
            key.append(_InvStr(v) if order == "desc" else v)
        else:
            key.append(-float(v) if order == "desc" else float(v))
    return tuple(key)


def _after_prefix(sort, values) -> tuple:
    """Build the cursor key for search_after values (client-supplied)."""
    if len(values) != len(sort):
        raise IllegalArgumentError(
            f"search_after must have {len(sort)} value(s) to match the sort")
    return _key_from_values(list(values), sort)


class _InvStr:
    """Reverse-ordering wrapper for string sort keys."""

    __slots__ = ("s",)

    def __init__(self, s: str):
        self.s = s

    def __lt__(self, other):
        return self.s > other.s

    def __eq__(self, other):
        return self.s == other.s
