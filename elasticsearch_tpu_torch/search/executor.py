"""Per-segment query execution: query tree -> dense (scores, mask) on device.

This is the TPU replacement for Lucene's Weight/Scorer/BulkScorer stack driven
by ContextIndexSearcher (ref: search/internal/ContextIndexSearcher.java:213 —
the per-leaf hot loop). Instead of doc-at-a-time iterators, every query node
evaluates to a dense pair over the segment:

    scores: f32[n_docs]  — 0 where the node does not match
    mask:   bool[n_docs] — exact match set of the node

Composition is pure vector algebra (bool = sum/AND/OR/count), which XLA fuses
aggressively. Postings-backed nodes use the block-scatter ops in ops/scoring;
numeric/keyword-range and phrase-position work happens host-side on exact
dtypes, producing device masks.

Statistics (idf, avgdl) are computed shard-wide across segments so scores are
identical to a single-segment index (Lucene IndexSearcher semantics).

The port's copy of elasticsearch_tpu/search/executor.py: the reference's
eager `jnp` is torch on the leaf's device (`LeafContext.device`, the
segment's), host numpy masks upload with `torch.as_tensor` (`leaf.up`) and
device results read back with `.cpu().numpy()` (`to_host`). The term
scatter and the constant-score masks run the block-scatter kernel through
ops/scoring. The profiler synchronizes the leaf's CUDA device where the
reference blocks until its arrays are ready. `function_score`'s sqrt is the
correctly rounded one (`ops.knn.sqrt_rn`); its log1p is torch's, which may
differ from XLA's by an ulp.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, List, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError, ParsingError
from elasticsearch_tpu_torch.index.engine import EngineSearcher, SegmentView
from elasticsearch_tpu_torch.index.positions import phrase_freqs
from elasticsearch_tpu_torch.index.segment import Segment
from elasticsearch_tpu_torch.mapper.field_types import parse_date_millis
from elasticsearch_tpu_torch.mapper.mapper_service import MapperService
from elasticsearch_tpu_torch.ops import (
    bm25_idf,
    bm25_scatter_scores,
    constant_scatter_mask,
    knn_scores,
    next_bucket,
    pad_block_ids,
)
from elasticsearch_tpu_torch.ops.knn import sqrt_rn
from elasticsearch_tpu_torch.search import queries as q

K1 = 1.2
B = 0.75
MAX_TERM_EXPANSIONS = 1024  # ref: index.max_terms_count / MultiTermQuery rewrites


def edit_distance_capped(a: str, b: str, max_d: int) -> int | None:
    """Optimal-string-alignment distance if <= max_d, else None (the
    reference's fuzzy semantics: Damerau-Levenshtein with adjacent
    transpositions; ref: Lucene LevenshteinAutomata). Banded DP with
    early exit; returns the DISTANCE so callers never re-run the DP."""
    la, lb = len(a), len(b)
    if abs(la - lb) > max_d:
        return None
    if max_d == 0:
        return 0 if a == b else None
    prev2 = None
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        row_min = i
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            v = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if (prev2 is not None and i > 1 and j > 1
                    and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]):
                v = min(v, prev2[j - 2] + 1)
            cur[j] = v
            row_min = min(row_min, v)
        if row_min > max_d:
            return None
        prev2, prev = prev, cur
    return prev[lb] if prev[lb] <= max_d else None


def within_edits(a: str, b: str, max_d: int) -> bool:
    return edit_distance_capped(a, b, max_d) is not None


def expand_fuzzy(dictionary, value: str, max_edits: int, prefix_length: int,
                 max_expansions: int, check=None):
    """Dictionary terms within max_edits of value (sharing the required
    prefix), nearest-first, capped at max_expansions. The dictionary is
    sorted, so a required prefix narrows the scan to its bisect range."""
    import bisect

    prefix = value[:prefix_length]
    lo, hi = 0, len(dictionary)
    if prefix:
        lo = bisect.bisect_left(dictionary, prefix)
        hi = bisect.bisect_left(dictionary, prefix + "\uffff")
    out = []
    for i in range(lo, hi):
        if check is not None and (i - lo) % 65536 == 0:
            check()
        t = dictionary[i]
        d = edit_distance_capped(t, value, max_edits)
        if d is not None:
            out.append((d, t))
    out.sort()
    return [t for _, t in out[:max_expansions]]


def _haversine_m(lat, lon, qlat, qlon) -> np.ndarray:
    """Great-circle distance in meters, vectorized (ref: GeoUtils haversin)."""
    r = 6371008.8
    lat1, lon1 = np.radians(lat), np.radians(lon)
    lat2, lon2 = np.radians(qlat), np.radians(qlon)
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    h = np.sin(dlat / 2.0) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2.0) ** 2
    return 2.0 * r * np.arcsin(np.minimum(np.sqrt(h), 1.0))


def _any_per_doc(col, hit: np.ndarray) -> np.ndarray:
    """CSR 'any value matches' reduction over a NumericColumn's multivalues."""
    cum = np.concatenate([[0], np.cumsum(hit.astype(np.int64))])
    counts = cum[col.value_start[1:]] - cum[col.value_start[:-1]]
    return (counts > 0) & col.exists


class ShardStats:
    """Shard-wide collection statistics for consistent BM25 across segments."""

    def __init__(self, views: List[SegmentView]):
        self.views = views
        self._field_cache: Dict[str, Tuple[int, float]] = {}
        self._term_cache: Dict[Tuple[str, str], int] = {}
        self.doc_count = sum(v.segment.n_docs for v in views)

    def avgdl(self, field: str) -> float:
        n, total = self._field_stats(field)
        return (total / n) if n else 1.0

    def _field_stats(self, field: str) -> Tuple[int, float]:
        if field not in self._field_cache:
            n = 0
            total = 0.0
            for v in self.views:
                fn, ft = v.segment.field_stats(field)
                n += fn
                total += ft
            self._field_cache[field] = (n, total)
        return self._field_cache[field]

    def df(self, field: str, term: str) -> int:
        key = (field, term)
        if key not in self._term_cache:
            self._term_cache[key] = sum(v.segment.term_stats(field, term)[0] for v in self.views)
        return self._term_cache[key]

    def idf(self, field: str, term: str) -> float:
        df = self.df(field, term)
        if df == 0:
            return 0.0
        return bm25_idf(self.doc_count, df)


class LeafContext:
    """One segment + its live mask, with device-mask caching. Tensors of
    the leaf live on its segment's device (`device`)."""

    def __init__(self, view: SegmentView, base: int):
        self.view = view
        self.segment: Segment = view.segment
        self.base = base  # global ordinal offset of this leaf within the shard
        self.n_docs = view.segment.n_docs
        self.device = view.segment.torch_device

    def up(self, host) -> torch.Tensor:
        """A host array (numpy) as a tensor on the leaf's device."""
        return torch.as_tensor(np.asarray(host), device=self.device)

    def zeros(self, dtype) -> torch.Tensor:
        return torch.zeros(self.n_docs, dtype=dtype, device=self.device)

    def ones(self, dtype) -> torch.Tensor:
        return torch.ones(self.n_docs, dtype=dtype, device=self.device)

    def full(self, value, dtype) -> torch.Tensor:
        return torch.full((self.n_docs,), value, dtype=dtype,
                          device=self.device)

    def live_dev(self):
        key = f"live:{self.view.live_epoch}"
        cache = self.segment._device
        with self.segment._device_lock:
            if key not in cache:
                # drop stale epochs for this segment
                for k in [k for k in cache if k.startswith("live:")]:
                    del cache[k]
                cache[key] = self.up(self.view.live)
            return cache[key]


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor read back as a numpy array."""
    return t.cpu().numpy()


def leaves(searcher: EngineSearcher) -> List[LeafContext]:
    out = []
    base = 0
    for v in searcher.views:
        out.append(LeafContext(v, base))
        base += v.segment.n_docs
    return out


# --------------------------------------------------------------------------
# Node execution
# --------------------------------------------------------------------------


class QueryProfiler:
    """Per-query-node timing tree (ref: QueryProfiler/ProfileResult):
    nested executes stack; children attach under their parent. Timings
    include device dispatch + sync for that node's work (the TPU analog of
    the reference's per-Weight/Scorer breakdown)."""

    def __init__(self):
        self.roots: List[dict] = []
        self._stack: List[dict] = []

    def push(self, query) -> dict:
        # MERGE by (type, description): one tree per query, timings
        # aggregated across leaves/segments (the reference reports one
        # ProfileResult tree per query per shard)
        key = (type(query).__name__, repr(query)[:200])
        siblings = (self._stack[-1]["children"] if self._stack
                    else self.roots)
        for n in siblings:
            if (n["type"], n["description"]) == key:
                self._stack.append(n)
                return n
        node = {"type": key[0], "description": key[1],
                "time_in_nanos": 0, "children": []}
        siblings.append(node)
        self._stack.append(node)
        return node

    def pop(self) -> None:
        self._stack.pop()

    def tree(self) -> List[dict]:
        def clean(n):
            out = {k: v for k, v in n.items() if k != "children" or v}
            if n["children"]:
                out["children"] = [clean(c) for c in n["children"]]
            # parents accumulate children's time too (reference semantics:
            # self time shown via breakdowns; we report inclusive)
            return out
        return [clean(r) for r in self.roots]


class QueryExecutor:
    def __init__(self, mapper: MapperService, stats: ShardStats):
        self.mapper = mapper
        self.stats = stats
        # cooperative cancellation hook (ref: ContextIndexSearcher.java:66
        # addQueryCancellation) — set by the query phase when a Task exists
        self.check = None
        # query profiler (ref: search/profile/query/QueryProfiler.java) —
        # set by the query phase when the request asks for profile: true
        self.profiler = None

    def execute(self, query: q.Query, leaf: LeafContext):
        """Returns (scores f32[n], mask bool[n]) device arrays."""
        if self.check is not None:
            self.check()
        n = leaf.n_docs
        if n == 0:
            return leaf.zeros(torch.float32), leaf.zeros(torch.bool)
        method = getattr(self, f"_exec_{type(query).__name__}", None)
        if method is None:
            raise ParsingError(f"unsupported query [{type(query).__name__}]")
        if self.profiler is not None:
            import time as _time

            node = self.profiler.push(query)
            t0 = _time.monotonic_ns()
            try:
                scores, mask = method(query, leaf)
                # profiling must attribute DEVICE time to the node that
                # dispatched it, not to whoever later forces the sync
                if scores.device.type == "cuda":
                    torch.cuda.synchronize(scores.device)
            finally:
                node["time_in_nanos"] += _time.monotonic_ns() - t0
                self.profiler.pop()
        else:
            scores, mask = method(query, leaf)
        boost = getattr(query, "boost", 1.0)
        if boost != 1.0:
            scores = scores * boost
        return scores, mask

    # ---- leaves of the query tree ----

    def _exec_MatchAllQuery(self, query, leaf):
        n = leaf.n_docs
        return leaf.ones(torch.float32), leaf.ones(torch.bool)

    def _exec_MatchNoneQuery(self, query, leaf):
        n = leaf.n_docs
        return leaf.zeros(torch.float32), leaf.zeros(torch.bool)

    def _exec_TermQuery(self, query, leaf):
        return self._term_scores(leaf, query.field, str(query.value))

    # ---- parent-join (ref: modules/parent-join) ----
    # Joins are shard-scoped (parent and child share a shard via routing,
    # the reference's constraint), so the inner query runs once over ALL
    # of the shard's leaves and the per-parent aggregate is cached on the
    # query instance — each shard parses its own query tree, so the cache
    # is naturally shard-local.

    def _shard_leaves(self):
        out = []
        base = 0
        for v in self.stats.views:
            out.append(LeafContext(v, base))
            base += v.segment.n_docs
        return out

    def _join_children_agg(self, query, child_type: str):
        """parent_id -> (count, sum, max, min) over live matching childs."""
        state = getattr(query, "_join_state", None)
        if state is not None:
            return state
        jf = self.mapper.join_field()
        agg: dict = {}
        if jf is not None:
            for lf in self._shard_leaves():
                seg = lf.segment
                names = seg.keyword.get(jf.name)
                parents = seg.keyword.get(f"{jf.name}.__parent")
                if names is None or parents is None:
                    continue
                child_ord = names.term_to_ord.get(child_type)
                if child_ord is None:
                    continue
                s, m = self.execute(query.query, lf)
                m = to_host(m) & lf.view.live & (names.ords == child_ord)
                s = to_host(s)
                for o in np.nonzero(m)[0]:
                    pts = parents.doc_terms(int(o))
                    if not pts:
                        continue
                    pid = pts[0]
                    sc = float(s[o])
                    cur = agg.get(pid)
                    agg[pid] = (1, sc, sc, sc) if cur is None else (
                        cur[0] + 1, cur[1] + sc, max(cur[2], sc),
                        min(cur[3], sc))
        query._join_state = agg
        return agg

    def _exec_HasChildQuery(self, query, leaf):
        jf = self.mapper.join_field()
        n = leaf.n_docs
        if jf is None:
            return leaf.zeros(torch.float32), leaf.zeros(torch.bool)
        parent_type = jf.parent_of.get(query.type)
        agg = self._join_children_agg(query, query.type)
        names = leaf.segment.keyword.get(jf.name)
        mask = np.zeros(n, bool)
        scores = np.zeros(n, np.float32)
        if names is not None and parent_type is not None:
            p_ord = names.term_to_ord.get(parent_type)
            if p_ord is not None:
                is_parent = names.ords == p_ord
                for o in np.nonzero(is_parent)[0]:
                    st = agg.get(leaf.segment.doc_ids[int(o)])
                    if st is None or not (query.min_children <= st[0]
                                          <= query.max_children):
                        continue
                    mask[o] = True
                    mode = query.score_mode
                    val = {"none": 1.0, "sum": st[1], "max": st[2],
                           "min": st[3], "avg": st[1] / st[0]}.get(mode, 1.0)
                    scores[o] = query.boost * val
        return leaf.up(scores), leaf.up(mask)

    def _exec_HasParentQuery(self, query, leaf):
        jf = self.mapper.join_field()
        n = leaf.n_docs
        if jf is None:
            return leaf.zeros(torch.float32), leaf.zeros(torch.bool)
        state = getattr(query, "_join_state", None)
        if state is None:
            # matching LIVE parents: id -> score
            state = {}
            for lf in self._shard_leaves():
                seg = lf.segment
                names = seg.keyword.get(jf.name)
                if names is None:
                    continue
                p_ord = names.term_to_ord.get(query.parent_type)
                if p_ord is None:
                    continue
                s, m = self.execute(query.query, lf)
                m = to_host(m) & lf.view.live & (names.ords == p_ord)
                s = to_host(s)
                for o in np.nonzero(m)[0]:
                    state[seg.doc_ids[int(o)]] = float(s[o])
            query._join_state = state
        names = leaf.segment.keyword.get(jf.name)
        parents = leaf.segment.keyword.get(f"{jf.name}.__parent")
        mask = np.zeros(n, bool)
        scores = np.zeros(n, np.float32)
        if names is not None and parents is not None:
            child_types = {c for c, p in jf.parent_of.items()
                           if p == query.parent_type}
            child_ords = {names.term_to_ord[c] for c in child_types
                          if c in names.term_to_ord}
            if child_ords:
                is_child = np.isin(names.ords, list(child_ords))
                for o in np.nonzero(is_child)[0]:
                    pts = parents.doc_terms(int(o))
                    if pts and pts[0] in state:
                        mask[o] = True
                        scores[o] = query.boost * (
                            state[pts[0]] if query.score else 1.0)
        return leaf.up(scores), leaf.up(mask)

    def _exec_ParentIdQuery(self, query, leaf):
        jf = self.mapper.join_field()
        n = leaf.n_docs
        if jf is None:
            return leaf.zeros(torch.float32), leaf.zeros(torch.bool)
        names = leaf.segment.keyword.get(jf.name)
        parents = leaf.segment.keyword.get(f"{jf.name}.__parent")
        mask = np.zeros(n, bool)
        if names is not None and parents is not None:
            c_ord = names.term_to_ord.get(query.type)
            if c_ord is not None:
                for o in np.nonzero(names.ords == c_ord)[0]:
                    pts = parents.doc_terms(int(o))
                    if pts and pts[0] == query.id:
                        mask[o] = True
        scores = np.where(mask, np.float32(query.boost), 0.0)
        return leaf.up(scores.astype(np.float32)), leaf.up(mask)

    def _exec_PercolateQuery(self, query, leaf):
        """Reverse search (ref: modules/percolator/PercolateQuery.java):
        candidates via the hidden `<field>.__terms` sidecar postings, then
        exact replay of each candidate's stored query against an in-memory
        segment of the percolated document(s). Constant score (the
        reference's non-scoring percolation mode)."""
        from elasticsearch_tpu_torch.search.percolate import (
            build_memory_views, document_tokens, matching_ords,
        )

        state = getattr(query, "_mem_state", None)
        if state is None:
            views = build_memory_views(self.mapper, query.documents,
                                       leaf.segment.torch_device)
            state = (views, document_tokens(views))
            query._mem_state = state    # reuse across this request's leaves
        mem_views, doc_toks = state
        ords = matching_ords(leaf.segment, query.field, doc_toks,
                             self.mapper, mem_views, check=self.check)
        n = leaf.n_docs
        mask = np.zeros(n, bool)
        if len(ords):
            mask[ords] = True
        scores = np.where(mask, np.float32(query.boost), 0.0)
        return leaf.up(scores.astype(np.float32)), leaf.up(mask)

    def _impl_TermsQuery(self, query, leaf):
        """Constant-score disjunction (ref: Lucene TermInSetQuery)."""
        field = query.field
        ft = self.mapper.field_type(field)
        if ft is not None and ft.family == "numeric":
            col = leaf.segment.numeric.get(field)
            if col is None:
                return self._none(leaf)
            want = np.asarray([ft.doc_value(v) for v in query.values], np.float64)
            mask_np = np.zeros(leaf.n_docs, bool)
            for w in want:
                mask_np |= col.range_mask(w, w, True, True)
            mask = leaf.up(mask_np)
            return mask.to(torch.float32), mask
        fp = leaf.segment.postings.get(field)
        if fp is None:
            return self._none(leaf)
        ids = [fp.term_block_ids(str(v)) for v in query.values]
        ids = [i for i in ids if len(i)]
        if not ids:
            return self._none(leaf)
        all_ids = np.concatenate(ids)
        block_docs, block_tfs, _ = leaf.segment.device(f"post:{field}")
        mask = constant_scatter_mask(block_docs, block_tfs,
                                     leaf.up(pad_block_ids(all_ids)), n_docs=leaf.n_docs)
        return mask.to(torch.float32), mask

    def _exec_MatchQuery(self, query, leaf):
        ft = self.mapper.field_type(query.field)
        if ft is None:
            return self._none(leaf)
        if ft.family != "inverted":
            return self._term_scores(leaf, query.field, str(query.text))
        analyzer = self.mapper.analyzer_for(ft)
        terms = analyzer.terms(query.text)
        if not terms:
            return self._none(leaf)
        pairs = [self._term_scores(leaf, query.field, t) for t in terms]
        scores = sum((p[0] for p in pairs), leaf.zeros(torch.float32))
        counts = sum((p[1].to(torch.int32) for p in pairs), leaf.zeros(torch.int32))
        if query.operator == "and":
            needed = len(terms)
        else:
            needed = query.minimum_should_match or 1
        mask = counts >= needed
        return scores, mask

    def _exec_MultiMatchQuery(self, query, leaf):
        subs = [self.execute(q.MatchQuery(f, query.text, operator=query.operator), leaf)
                for f in query.fields]
        if not subs:
            return self._none(leaf)
        if query.type == "most_fields":
            scores = sum((s for s, _ in subs), leaf.zeros(torch.float32))
        else:  # best_fields
            scores = subs[0][0]
            for s, _ in subs[1:]:
                scores = torch.maximum(scores, s)
        mask = subs[0][1]
        for _, m in subs[1:]:
            mask = mask | m
        return scores, mask

    def _exec_MatchPhraseQuery(self, query, leaf):
        """Conjunction on device, exact position verification on host
        (ref: Lucene PhraseQuery/SloppyPhraseScorer semantics)."""
        ft = self.mapper.field_type(query.field)
        if ft is None or ft.family != "inverted":
            return self._exec_MatchQuery(
                q.MatchQuery(query.field, query.text, operator="and"), leaf)
        analyzer = self.mapper.analyzer_for(ft)
        terms = analyzer.terms(query.text)
        if not terms:
            return self._none(leaf)
        if len(terms) == 1:
            return self._term_scores(leaf, query.field, terms[0])
        fp = leaf.segment.postings.get(query.field)
        if fp is None:
            return self._none(leaf)
        # columnar positional verify: all candidates in a few array passes
        # (index/positions.py), no per-doc loop
        docs, freqs = phrase_freqs(fp, terms, slop=query.slop)
        phrase_freq = np.zeros(leaf.n_docs, np.float32)
        phrase_freq[docs] = freqs
        idf_sum = sum(self.stats.idf(query.field, t) for t in terms)
        avgdl = self.stats.avgdl(query.field)
        dl = fp.doc_len
        denom = phrase_freq + K1 * (1.0 - B + B * dl / max(avgdl, 1e-9))
        scores_np = np.where(phrase_freq > 0,
                             idf_sum * phrase_freq * (K1 + 1.0) / denom, 0.0).astype(np.float32)
        scores = leaf.up(scores_np)
        return scores, scores > 0

    def _impl_RangeQuery(self, query, leaf):
        field = query.field
        ft = self.mapper.field_type(field)
        if ft is not None and ft.family == "numeric":
            col = leaf.segment.numeric.get(field)
            if col is None:
                return self._none(leaf)
            conv = ft.doc_value
            lo, inc_lo = (-np.inf, True)
            hi, inc_hi = (np.inf, True)
            if query.gte is not None:
                lo, inc_lo = conv(query.gte), True
            if query.gt is not None:
                lo, inc_lo = conv(query.gt), False
            if query.lte is not None:
                hi, inc_hi = conv(query.lte), True
            if query.lt is not None:
                hi, inc_hi = conv(query.lt), False
            mask = leaf.up(col.range_mask(lo, hi, inc_lo, inc_hi))
            return mask.to(torch.float32), mask
        # keyword/text: lexicographic term range over the term dictionary
        fp = leaf.segment.postings.get(field)
        if fp is None:
            return self._none(leaf)
        terms = fp.terms
        lo_i, hi_i = 0, len(terms)
        import bisect
        if query.gte is not None:
            lo_i = bisect.bisect_left(terms, str(query.gte))
        if query.gt is not None:
            lo_i = bisect.bisect_right(terms, str(query.gt))
        if query.lte is not None:
            hi_i = bisect.bisect_right(terms, str(query.lte))
        if query.lt is not None:
            hi_i = bisect.bisect_left(terms, str(query.lt))
        return self._terms_mask_by_ords(leaf, field, range(lo_i, max(lo_i, hi_i)))

    def _impl_ExistsQuery(self, query, leaf):
        field = query.field
        seg = leaf.segment
        mask_np = np.zeros(leaf.n_docs, bool)
        found = False
        if field in seg.numeric:
            mask_np |= seg.numeric[field].exists
            found = True
        if field in seg.keyword:
            mask_np |= seg.keyword[field].exists
            found = True
        if field in seg.vectors:
            mask_np |= seg.vectors[field].exists
            found = True
        fp = seg.postings.get(field)
        if fp is not None and field not in seg.keyword:
            mask_np |= fp.doc_len > 0
            found = True
        if not found:
            return self._none(leaf)
        mask = leaf.up(mask_np)
        return mask.to(torch.float32), mask

    def _exec_IdsQuery(self, query, leaf):
        mask_np = np.zeros(leaf.n_docs, bool)
        for doc_id in query.values:
            ord_ = leaf.segment.id_to_ord.get(doc_id)
            if ord_ is not None:
                mask_np[ord_] = True
        mask = leaf.up(mask_np)
        return mask.to(torch.float32), mask

    def _impl_PrefixQuery(self, query, leaf):
        return self._multi_term(leaf, query.field, lambda t: t.startswith(query.value))

    def _exec_FuzzyQuery(self, query, leaf):
        """Edit-distance expansion over the term dictionary; each doc scores
        as its best-matching expansion (ref: Lucene FuzzyQuery via
        top-terms blended rewrite — best-of approximates the blend)."""
        fp = leaf.segment.postings.get(query.field)
        if fp is None:
            return self._none(leaf)
        terms = expand_fuzzy(fp.terms, query.value, query.max_edits(),
                             query.prefix_length, query.max_expansions,
                             check=self.check)
        if not terms:
            return self._none(leaf)
        scores = leaf.zeros(torch.float32)
        mask = leaf.zeros(torch.bool)
        for t in terms:
            s, m = self._term_scores(leaf, query.field, t)
            scores = torch.maximum(scores, s)
            mask = mask | m
        return scores, mask

    def _impl_RegexpQuery(self, query, leaf):
        """Anchored regular expression over the term dictionary (ref:
        RegexpQueryBuilder — Lucene RegExp is implicitly anchored)."""
        import re

        try:
            pat = re.compile(query.value)
        except re.error as e:
            raise IllegalArgumentError(f"invalid regexp [{query.value}]: {e}")
        return self._multi_term(leaf, query.field,
                                lambda t: pat.fullmatch(t) is not None)

    def _exec_MatchPhrasePrefixQuery(self, query, leaf):
        """Phrase with the LAST term prefix-expanded (ref:
        MatchPhrasePrefixQueryBuilder -> Lucene MultiPhraseQuery): phrase
        frequency sums over the expansions, scored BM25 with the fixed
        terms' idf plus an idf from the expansions' combined df."""
        ft = self.mapper.field_type(query.field)
        if ft is None or ft.family != "inverted":
            return self._none(leaf)
        analyzer = self.mapper.analyzer_for(ft)
        terms = analyzer.terms(query.text)
        if not terms:
            return self._none(leaf)
        fp = leaf.segment.postings.get(query.field)
        if fp is None:
            return self._none(leaf)
        prefix = terms[-1]
        fixed = terms[:-1]
        expansions = [t for t in fp.terms if t.startswith(prefix)]
        expansions = expansions[: query.max_expansions]
        if not expansions:
            return self._none(leaf)
        pf_total = np.zeros(leaf.n_docs, np.float32)
        for exp in expansions:
            if self.check is not None:
                self.check()
            docs, pf = phrase_freqs(fp, fixed + [exp], slop=query.slop)
            if len(docs):
                pf_total[docs] += pf
        if not pf_total.any():
            return self._none(leaf)
        df_union = sum(self.stats.df(query.field, t) for t in expansions)
        idf_sum = sum(self.stats.idf(query.field, t) for t in fixed)
        idf_sum += bm25_idf(self.stats.doc_count, min(df_union, self.stats.doc_count))
        avgdl = self.stats.avgdl(query.field)
        denom = pf_total + K1 * (1.0 - B + B * fp.doc_len / max(avgdl, 1e-9))
        scores_np = np.where(pf_total > 0,
                             idf_sum * pf_total * (K1 + 1.0) / denom,
                             0.0).astype(np.float32)
        scores = leaf.up(scores_np)
        return scores, scores > 0

    def _impl_GeoDistanceQuery(self, query, leaf):
        gc = leaf.segment.geo.get(query.field)
        if gc is None:
            return self._none(leaf)
        d = _haversine_m(gc.lat, gc.lon, query.lat, query.lon)
        mask = leaf.up(_any_per_doc(gc, d <= query.distance_m))
        return mask.to(torch.float32), mask

    def _impl_GeoBoundingBoxQuery(self, query, leaf):
        gc = leaf.segment.geo.get(query.field)
        if gc is None:
            return self._none(leaf)
        lat, lon = gc.lat, gc.lon
        ok_lat = (lat <= query.top) & (lat >= query.bottom)
        if query.left <= query.right:
            ok_lon = (lon >= query.left) & (lon <= query.right)
        else:   # box crosses the antimeridian
            ok_lon = (lon >= query.left) | (lon <= query.right)
        mask = leaf.up(_any_per_doc(gc, ok_lat & ok_lon))
        return mask.to(torch.float32), mask

    def _impl_WildcardQuery(self, query, leaf):
        return self._multi_term(leaf, query.field,
                                lambda t, pat=query.value: fnmatch.fnmatchcase(t, pat))

    def _exec_ConstantScoreQuery(self, query, leaf):
        _, mask = self.execute(query.filter, leaf)
        return mask.to(torch.float32), mask

    def _exec_BoolQuery(self, query, leaf):
        n = leaf.n_docs
        scores = leaf.zeros(torch.float32)
        mask = leaf.ones(torch.bool)
        for c in query.must:
            s, m = self.execute(c, leaf)
            scores = scores + s
            mask = mask & m
        for c in query.filter:
            _, m = self.execute(c, leaf)
            mask = mask & m
        for c in query.must_not:
            _, m = self.execute(c, leaf)
            mask = mask & ~m
        if query.should:
            should_count = leaf.zeros(torch.int32)
            for c in query.should:
                s, m = self.execute(c, leaf)
                scores = scores + torch.where(m, s, 0.0)
                should_count = should_count + m.to(torch.int32)
            msm = query.minimum_should_match
            if msm is None:
                msm = 0 if (query.must or query.filter) else 1
            if msm > 0:
                mask = mask & (should_count >= msm)
        return scores, mask

    def _exec_FunctionScoreQuery(self, query, leaf):
        scores, mask = self.execute(query.query, leaf)
        factor = leaf.full(query.weight, torch.float32)
        if query.field_value_factor:
            spec = query.field_value_factor
            col = leaf.segment.numeric.get(spec["field"])
            if col is not None:
                vals = leaf.up(col.values.astype(np.float32))
                vals = vals * spec.get("factor", 1.0)
                modifier = spec.get("modifier", "none")
                if modifier == "log1p":
                    vals = torch.log1p(torch.clamp(vals, min=0.0))
                elif modifier == "sqrt":
                    vals = sqrt_rn(torch.clamp(vals, min=0.0))
                elif modifier == "square":
                    vals = vals * vals
                missing = spec.get("missing", 1.0)
                vals = torch.where(leaf.up(col.exists), vals, missing)
                factor = factor * vals
        if query.boost_mode == "replace":
            scores = factor
        elif query.boost_mode == "sum":
            scores = scores + factor
        else:  # multiply
            scores = scores * factor
        return scores, mask

    def _exec_KnnQuery(self, query, leaf):
        seg = leaf.segment
        if query.field not in seg.vectors:
            return self._none(leaf)
        vc = seg.vectors[query.field]
        vectors, norms, exists = seg.device(f"vec:{query.field}")
        qv = leaf.up(np.asarray([query.query_vector], np.float32))
        scores = knn_scores(qv, vectors, norms, exists, similarity=vc.similarity)[0]
        mask = leaf.up(vc.exists)
        if query.filter is not None:
            _, fm = self.execute(query.filter, leaf)
            mask = mask & fm
        scores = torch.where(mask, scores, 0.0)
        return scores, mask

    # constant-score filters: masks cached per segment (see _cached_mask)

    def _exec_TermsQuery(self, query, leaf):
        mask = self._cached_mask(
            leaf, query, lambda: self._impl_TermsQuery(query, leaf)[1])
        return mask.to(torch.float32), mask

    def _exec_RangeQuery(self, query, leaf):
        mask = self._cached_mask(
            leaf, query, lambda: self._impl_RangeQuery(query, leaf)[1])
        return mask.to(torch.float32), mask

    def _exec_ExistsQuery(self, query, leaf):
        mask = self._cached_mask(
            leaf, query, lambda: self._impl_ExistsQuery(query, leaf)[1])
        return mask.to(torch.float32), mask

    def _exec_PrefixQuery(self, query, leaf):
        mask = self._cached_mask(
            leaf, query, lambda: self._impl_PrefixQuery(query, leaf)[1])
        return mask.to(torch.float32), mask

    def _exec_WildcardQuery(self, query, leaf):
        mask = self._cached_mask(
            leaf, query, lambda: self._impl_WildcardQuery(query, leaf)[1])
        return mask.to(torch.float32), mask

    def _exec_RegexpQuery(self, query, leaf):
        mask = self._cached_mask(
            leaf, query, lambda: self._impl_RegexpQuery(query, leaf)[1])
        return mask.to(torch.float32), mask

    def _exec_GeoDistanceQuery(self, query, leaf):
        mask = self._cached_mask(
            leaf, query, lambda: self._impl_GeoDistanceQuery(query, leaf)[1])
        return mask.to(torch.float32), mask

    def _exec_GeoBoundingBoxQuery(self, query, leaf):
        mask = self._cached_mask(
            leaf, query, lambda: self._impl_GeoBoundingBoxQuery(query, leaf)[1])
        return mask.to(torch.float32), mask

    def _exec_NestedQuery(self, query, leaf):
        """Block-join as a child-table pass (ref: NestedQueryBuilder ->
        Lucene ToParentBlockJoinQuery): run the inner query over the nested
        field's child table, then CSR-reduce matching child scores to the
        parent per score_mode. Parent live masking happens in the normal
        query phase; children live/die with their parent."""
        nt = leaf.segment.nested.get(query.path)
        if nt is None or nt.child.n_docs == 0:
            return self._none(leaf)
        child_scores, child_mask = self._nested_child_exec(
            leaf, query.path, query.query)
        cs = to_host(child_scores)
        cm = to_host(child_mask)
        n_parents = leaf.n_docs
        starts = nt.child_start
        hit = cm.astype(np.int64)
        cum = np.concatenate([[0], np.cumsum(hit)])
        counts = (cum[starts[1:]] - cum[starts[:-1]]).astype(np.float64)
        mask_np = counts > 0
        sc = np.where(cm, cs.astype(np.float64), 0.0)
        cum_s = np.concatenate([[0.0], np.cumsum(sc)])
        sums = cum_s[starts[1:]] - cum_s[starts[:-1]]
        mode = query.score_mode
        if mode == "none":
            # ref: NestedQueryBuilder score_mode none -> constant 0 score
            scores_np = np.zeros(n_parents, np.float64)
        elif mode == "sum":
            scores_np = sums
        elif mode in ("max", "min"):
            sentinel = -np.inf if mode == "max" else np.inf
            vals = np.where(cm, cs.astype(np.float64), sentinel)
            # sentinel APPENDED so trailing childless parents' starts index
            # it instead of clamping into (and truncating) the previous
            # parent's reduceat run; empty middle runs yield a neighboring
            # element but are zeroed by the parent mask below
            vals = np.append(vals, sentinel)
            red = (np.maximum if mode == "max" else np.minimum
                   ).reduceat(vals, starts[:-1].astype(np.int64))
            scores_np = np.where(mask_np, red, 0.0)
        else:  # avg (default)
            scores_np = np.divide(sums, counts, out=np.zeros_like(sums),
                                  where=counts > 0)
        scores_np = np.where(mask_np, scores_np, 0.0)
        mask = leaf.up(mask_np)
        return leaf.up(scores_np.astype(np.float32)), mask

    def _nested_child_exec(self, leaf, path, inner_query):
        """(scores, mask) over the child table of `path` on this leaf.

        The leaf/stats pair is cached per segment (immutable); the executor
        is PER CALL — it carries this request's cancellation hook, and a
        shared one would race across concurrent requests."""
        from elasticsearch_tpu_torch.index.engine import SegmentView

        nt = leaf.segment.nested[path]
        cache_key = f"nestedleaf:{path}"
        with leaf.segment._device_lock:
            ctx = leaf.segment._device.get(cache_key)
            if ctx is None:
                view = SegmentView(segment=nt.child,
                                   live=np.ones(nt.child.n_docs, bool),
                                   live_epoch=0)
                ctx = (LeafContext(view, base=0), ShardStats([view]))
                leaf.segment._device[cache_key] = ctx
        child_leaf, child_stats = ctx
        child_ex = QueryExecutor(self.mapper, child_stats)
        child_ex.check = self.check
        return child_ex.execute(inner_query, child_leaf)

    # ---- helpers ----

    _QUERY_CACHE_MAX = 32   # cached filter masks per segment (FIFO)

    def _cached_mask(self, leaf, query, builder):
        """Per-SEGMENT filter-mask cache (ref: indices/IndicesQueryCache.java
        :42 — Lucene caches filter DocIdSets per reader). Masks depend only
        on the immutable segment (live/stats are applied later), so the key
        is the query's canonical repr; storage rides the segment's device-
        array cache and dies with the segment."""
        cache = leaf.segment._device
        # key: auto-generated dataclass repr — field-complete for every
        # cacheable (flat, scalar-field) query type routed here
        key = f"qcache:{query!r}"
        with leaf.segment._device_lock:
            hit = cache.get(key)
        if hit is not None:
            return hit
        mask = builder()
        with leaf.segment._device_lock:
            keys = [k for k in cache if k.startswith("qcache:")]
            if len(keys) >= self._QUERY_CACHE_MAX:
                cache.pop(keys[0], None)
            cache[key] = mask
        return mask

    def _none(self, leaf):
        n = leaf.n_docs
        return leaf.zeros(torch.float32), leaf.zeros(torch.bool)

    def _term_scores(self, leaf: LeafContext, field: str, term: str):
        """A single term: BM25 with norms on text fields; norm-free BM25
        (== idf at tf=1) on keyword fields; equality mask on numeric."""
        ft = self.mapper.field_type(field)
        if ft is not None and ft.family == "numeric":
            col = leaf.segment.numeric.get(field)
            if col is None:
                return self._none(leaf)
            want = ft.doc_value(term)
            mask = leaf.up(col.range_mask(want, want, True, True))
            return mask.to(torch.float32), mask
        fp = leaf.segment.postings.get(field)
        if fp is None:
            return self._none(leaf)
        ids = fp.term_block_ids(term)
        if len(ids) == 0:
            return self._none(leaf)
        block_docs, block_tfs, doc_len_dev = leaf.segment.device(f"post:{field}")
        idf = self.stats.idf(field, term)
        is_text = ft is None or ft.family == "inverted"
        padded = pad_block_ids(ids)
        idf_arr = np.zeros(len(padded), np.float32)
        idf_arr[: len(ids)] = idf
        if is_text:
            avgdl = self.stats.avgdl(field)
            scores = bm25_scatter_scores(
                block_docs, block_tfs, doc_len_dev, leaf.up(padded),
                leaf.up(idf_arr), float(np.float32(max(avgdl, 1e-9))),
                n_docs=leaf.n_docs, k1=K1, b=B)
            return scores, scores > 0
        # keyword: no norms; tf=1 -> score == idf
        mask = constant_scatter_mask(block_docs, block_tfs, leaf.up(padded),
                                     n_docs=leaf.n_docs)
        return mask.to(torch.float32) * idf, mask

    def _multi_term(self, leaf, field, predicate):
        """Constant-score rewrite of a multi-term query (prefix/wildcard)."""
        fp = leaf.segment.postings.get(field)
        if fp is None:
            return self._none(leaf)
        ords = []
        for i, t in enumerate(fp.terms):
            if self.check is not None and i % 65536 == 0:
                self.check()   # huge dictionaries: stay cancellable mid-scan
            if predicate(t):
                ords.append(i)
        return self._terms_mask_by_ords(leaf, field, ords)

    def _terms_mask_by_ords(self, leaf, field, ords):
        fp = leaf.segment.postings[field]
        ords = list(ords)[:MAX_TERM_EXPANSIONS]
        if not ords:
            return self._none(leaf)
        parts = []
        for o in ords:
            s, c = int(fp.block_start[o]), int(fp.block_count[o])
            parts.append(np.arange(s, s + c, dtype=np.int32))
        all_ids = np.concatenate(parts)
        block_docs, block_tfs, _ = leaf.segment.device(f"post:{field}")
        mask = constant_scatter_mask(block_docs, block_tfs,
                                     leaf.up(pad_block_ids(all_ids)), n_docs=leaf.n_docs)
        return mask.to(torch.float32), mask


