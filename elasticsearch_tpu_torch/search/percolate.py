"""Percolator: reverse search — store queries, match documents against them
(ref: modules/percolator/ — PercolatorFieldMapper extracts
terms from the stored query into hidden fields; PercolateQueryBuilder's
candidate phase pre-filters by those terms; a MemoryIndex replay verifies).

The same two-phase shape, mapped onto this engine's columnar segments:

* INDEX time (mapper_service `percolator` family branch): the stored query
  JSON parses through the regular DSL and `extract_terms` walks the tree
  collecting `field\\0term` tokens into a hidden keyword sidecar
  `<field>.__terms` — real postings, so candidate generation is ordinary
  postings intersection, not a scan. Queries with no extractable terms
  (match_all, ranges, ...) index the ALWAYS sentinel and are verified
  against every percolated document (ref: QueryAnalyzer's
  matchAllDocs/verified handling).
* QUERY time (`percolate` query, executor._exec_PercolateQuery): the
  percolated document(s) build a tiny in-memory Segment through the SAME
  mapper + SegmentBuilder as real indexing (the MemoryIndex analog), the
  sidecar postings nominate candidate stored queries, and each candidate's
  parsed query runs against the memory segment for exact verification.

Percolation is a vocabulary-sized problem (queries x doc terms), four
orders below doc-count scale, so it runs on host; the TPU keeps serving
the O(docs) search path.

The port's copy of elasticsearch_tpu/search/percolate.py: the memory
segment lives on the device of the leaf being percolated.
"""

from __future__ import annotations

from typing import List, Set, Tuple

import numpy as np

from elasticsearch_tpu_torch.search import queries as q

ALWAYS = "\0__always__"
_SEP = "\0"


def _token(field: str, term) -> str:
    return f"{field}{_SEP}{term}"


def extract_terms(node) -> Tuple[Set[str], bool]:
    """(tokens, exact) for a parsed query node.

    tokens — a candidate document must contain at least ONE of them for
    the query to possibly match (ANY-overlap prefilter; the reference
    additionally tracks minimum-should-match counts, which only tightens
    the same safe bound). {ALWAYS} means "cannot prefilter".
    exact is unused today (the verify phase always runs) but mirrors the
    reference's `verified` flag for future skip-verify optimization."""
    if isinstance(node, q.TermQuery):
        return {_token(node.field, node.value)}, True
    if isinstance(node, q.TermsQuery):
        return {_token(node.field, v) for v in node.values}, True
    if isinstance(node, (q.MatchQuery, q.MatchPhraseQuery,
                         q.MatchPhrasePrefixQuery)):
        # analysis happens at index time in the mapper branch; here the raw
        # whitespace/lowercase split is the safe superset fallback
        terms = str(node.text).lower().split()
        if not terms:
            return {ALWAYS}, False
        return {_token(node.field, t) for t in terms}, True
    if isinstance(node, q.BoolQuery):
        required = list(node.must) + list(node.filter)
        if required:
            # a conjunction must match EVERY required child: any child's
            # token set is a valid prefilter — pick the smallest
            # extractable one (ref: QueryAnalyzer selectBestExtraction)
            best: Set[str] | None = None
            for c in required:
                toks, _ = extract_terms(c)
                if ALWAYS in toks:
                    continue
                if best is None or len(toks) < len(best):
                    best = toks
            return (best, False) if best else ({ALWAYS}, False)
        if node.should:
            out: Set[str] = set()
            for c in node.should:
                toks, _ = extract_terms(c)
                if ALWAYS in toks:
                    return {ALWAYS}, False
                out |= toks
            return (out, False) if out else ({ALWAYS}, False)
        return {ALWAYS}, False
    if isinstance(node, q.ConstantScoreQuery):
        return extract_terms(node.filter)
    if isinstance(node, q.NestedQuery):
        toks, _ = extract_terms(node.query)
        # nested child terms index under the child field names, which the
        # document side also emits — usable as-is
        return toks, False
    if isinstance(node, q.MatchNoneQuery):
        return set(), True          # never a candidate
    # match_all, range, exists, prefix, wildcard, fuzzy, knn, geo, ...
    return {ALWAYS}, False


def query_index_tokens(mapper, query_json: dict) -> List[str]:
    """Sidecar tokens for one stored query (index-time path). Analyzed
    text queries extract their ANALYZED terms so they line up with what
    documents index."""
    parsed = q.parse_query(query_json)
    toks, _ = _extract_analyzed(parsed, mapper)
    return sorted(toks) if toks else []


def _extract_analyzed(node, mapper) -> Tuple[Set[str], bool]:
    if isinstance(node, (q.MatchQuery, q.MatchPhraseQuery,
                         q.MatchPhrasePrefixQuery)):
        ft = mapper.field_type(node.field)
        if ft is not None and ft.family == "inverted":
            terms = mapper.analyzer_for(ft).terms(str(node.text))
            if not terms:
                return {ALWAYS}, False
            return {_token(node.field, t) for t in terms}, True
        return extract_terms(node)
    if isinstance(node, q.BoolQuery):
        required = list(node.must) + list(node.filter)
        if required:
            best: Set[str] | None = None
            for c in required:
                toks, _ = _extract_analyzed(c, mapper)
                if ALWAYS in toks:
                    continue
                if best is None or len(toks) < len(best):
                    best = toks
            return (best, False) if best else ({ALWAYS}, False)
        if node.should:
            out: Set[str] = set()
            for c in node.should:
                toks, _ = _extract_analyzed(c, mapper)
                if ALWAYS in toks:
                    return {ALWAYS}, False
                out |= toks
            return (out, False) if out else ({ALWAYS}, False)
        return {ALWAYS}, False
    if isinstance(node, q.ConstantScoreQuery):
        return _extract_analyzed(node.filter, mapper)
    return extract_terms(node)


# --------------------------------------------------------------------------
# query-time: memory index + candidate verification
# --------------------------------------------------------------------------


class _MemView:
    """SegmentView shim over the percolated documents' memory segment."""

    def __init__(self, segment):
        self.segment = segment
        self.live = np.ones(segment.n_docs, bool)
        self.live_epoch = 0


def build_memory_views(mapper, documents: List[dict], device):
    """One in-memory Segment on `device` holding the percolated docs —
    built by the SAME parse + SegmentBuilder path as real indexing, so
    analysis, multi-fields and dynamic mappings behave identically (the
    reference's MemoryIndex guarantee)."""
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder

    b = SegmentBuilder(seg_id=-1, device=device)
    for i, src in enumerate(documents):
        b.add(mapper.parse(f"_percolate#{i}", src), seq_no=i, version=1)
    return [_MemView(b.build())]


def document_tokens(views) -> Set[str]:
    """Every `field\\0term` a percolated document contains (inverted +
    keyword postings of the memory segment) plus ALWAYS."""
    out = {ALWAYS}
    for v in views:
        for fname, fp in v.segment.postings.items():
            for t in fp.term_to_ord:
                out.add(_token(fname, t))
    return out


def matching_ords(leaf_segment, field: str, doc_toks: Set[str],
                  mapper, mem_views, check=None) -> np.ndarray:
    """Stored-query ords in `leaf_segment` whose query matches any memory
    doc: sidecar-postings candidate generation, then exact replay."""
    from elasticsearch_tpu_torch.search.executor import (
        LeafContext, QueryExecutor, ShardStats,
    )

    fp = leaf_segment.postings.get(f"{field}.__terms")
    if fp is None:
        return np.zeros(0, np.int64)
    cand: Set[int] = set()
    for tok in doc_toks:
        o = fp.term_to_ord.get(tok)
        if o is None:
            continue
        lo, hi = int(fp.post_start[o]), int(fp.post_start[o + 1])
        cand.update(int(d) for d in fp.post_doc[lo:hi])
    if not cand:
        return np.zeros(0, np.int64)

    stats = ShardStats(mem_views)
    ex = QueryExecutor(mapper, stats)
    mem_leaves = [LeafContext(v, 0) for v in mem_views]
    matched = []
    for ord_ in sorted(cand):
        if check is not None:
            check()
        src = leaf_segment.sources[ord_]
        stored = None if src is None else src.get(field)
        if not isinstance(stored, dict):
            continue
        try:
            parsed = q.parse_query(stored)
            hit = False
            for leaf in mem_leaves:
                _, mask = ex.execute(parsed, leaf)
                if bool(mask.any()):
                    hit = True
                    break
            if hit:
                matched.append(ord_)
        except Exception:
            continue     # an unparseable stored query matches nothing
    return np.asarray(matched, np.int64)
