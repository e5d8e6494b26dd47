"""Highlighting: wrap query matches in stored text with tags.

Re-designs the reference's unified highlighter (ref:
search/fetch/subphase/highlight/HighlightPhase.java:40,
DefaultHighlighter + Lucene UnifiedHighlighter): query terms are extracted
from the parsed query tree, the stored source text is re-analyzed (tokens
carry offsets — analysis/analyzers.py), matched tokens (including full
phrase occurrences, position-checked) are wrapped, and the best fragments
are selected. Pure host work in the fetch phase, off the scoring path.

The port's copy of elasticsearch_tpu/search/highlight.py.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, Optional

from elasticsearch_tpu_torch.search import queries as q

DEFAULT_FRAGMENT_SIZE = 100
DEFAULT_NUM_FRAGMENTS = 5


@dataclass
class FieldMatchers:
    terms: set = dc_field(default_factory=set)
    predicates: List[Callable[[str], bool]] = dc_field(default_factory=list)
    phrases: List[tuple] = dc_field(default_factory=list)  # (terms tuple, slop)

    def empty(self) -> bool:
        return not self.terms and not self.predicates and not self.phrases


def extract_matchers(query, mapper) -> Dict[str, FieldMatchers]:
    """Walk the query tree collecting per-field highlightable matchers
    (ref: the reference extracts terms via Query visitor / extractTerms)."""
    out: Dict[str, FieldMatchers] = {}

    def fm(field: str) -> FieldMatchers:
        return out.setdefault(field, FieldMatchers())

    def analyze(field: str, text: str) -> List[str]:
        ft = mapper.field_type(field)
        if ft is None or ft.family != "inverted":
            return [str(text)]
        return mapper.analyzer_for(ft).terms(text)

    def walk(node):
        if node is None:
            return
        if isinstance(node, q.TermQuery):
            fm(node.field).terms.add(str(node.value))
        elif isinstance(node, q.TermsQuery):
            fm(node.field).terms.update(str(v) for v in node.values)
        elif isinstance(node, q.MatchQuery):
            fm(node.field).terms.update(analyze(node.field, node.text))
        elif isinstance(node, q.MultiMatchQuery):
            for f in node.fields:
                fm(f).terms.update(analyze(f, node.text))
        elif isinstance(node, q.MatchPhraseQuery):
            terms = analyze(node.field, node.text)
            if len(terms) == 1:
                fm(node.field).terms.add(terms[0])
            elif terms:
                fm(node.field).phrases.append((tuple(terms), int(node.slop)))
        elif isinstance(node, q.PrefixQuery):
            fm(node.field).predicates.append(
                lambda t, p=str(node.value): t.startswith(p))
        elif isinstance(node, q.FuzzyQuery):
            from elasticsearch_tpu_torch.search.executor import within_edits

            fm(node.field).predicates.append(
                lambda t, v=str(node.value), d=node.max_edits():
                within_edits(t, v, d))
        elif isinstance(node, q.RegexpQuery):
            import re

            try:
                pat = re.compile(node.value)
                fm(node.field).predicates.append(
                    lambda t, p=pat: p.fullmatch(t) is not None)
            except re.error:
                pass
        elif isinstance(node, q.MatchPhrasePrefixQuery):
            terms = analyze(node.field, node.text)
            if terms:
                fm(node.field).terms.update(terms[:-1])
                fm(node.field).predicates.append(
                    lambda t, p=terms[-1]: t.startswith(p))
        elif isinstance(node, q.WildcardQuery):
            fm(node.field).predicates.append(
                lambda t, p=str(node.value): fnmatch.fnmatchcase(t, p))
        elif isinstance(node, q.BoolQuery):
            for c in list(node.must) + list(node.filter) + list(node.should):
                walk(c)   # must_not matches must NOT highlight
        elif isinstance(node, q.ConstantScoreQuery):
            walk(node.filter)
        elif isinstance(node, q.FunctionScoreQuery):
            walk(node.query)
        elif isinstance(node, q.KnnQuery):
            walk(node.filter)

    walk(query)
    return out


def _phrase_token_spans(tokens, phrase_terms, slop: int) -> List[int]:
    """Token indices participating in a phrase occurrence. slop 0 = exact
    consecutive positions; slop > 0 = all terms within a position window of
    len(phrase) + slop (the sloppy window shape index/positions.py uses)."""
    by_term: Dict[str, List[int]] = {}
    for i, t in enumerate(tokens):
        by_term.setdefault(t.term, []).append(i)
    if any(pt not in by_term for pt in phrase_terms):
        return []
    hits: List[int] = []
    pos_of = {i: tokens[i].position for i in range(len(tokens))}
    first = phrase_terms[0]
    for i0 in by_term[first]:
        p0 = pos_of[i0]
        group = [i0]
        ok = True
        for j, pt in enumerate(phrase_terms[1:], start=1):
            want_lo = p0 + j - slop
            want_hi = p0 + j + slop
            found = None
            for i in by_term[pt]:
                if want_lo <= pos_of[i] <= want_hi:
                    found = i
                    break
            if found is None:
                ok = False
                break
            group.append(found)
        if ok:
            hits.extend(group)
    return hits


def _matched_token_indices(tokens, matchers: FieldMatchers) -> List[int]:
    idx = set()
    for i, t in enumerate(tokens):
        if t.term in matchers.terms:
            idx.add(i)
        elif any(p(t.term) for p in matchers.predicates):
            idx.add(i)
    for phrase_terms, slop in matchers.phrases:
        idx.update(_phrase_token_spans(tokens, list(phrase_terms), slop))
    return sorted(idx)


def _fragment_text(text: str, spans: List[tuple], fragment_size: int,
                   num_fragments: int, pre: str, post: str,
                   order: str) -> List[str]:
    """Chunk text at whitespace near fragment_size, keep the chunks that
    contain matches (top by match count), wrap each matched span."""
    if num_fragments == 0:       # whole field as one fragment (ES semantics)
        bounds = [(0, len(text))]
    else:
        bounds = []
        start = 0
        n = len(text)
        while start < n:
            end = min(start + fragment_size, n)
            if end < n:
                ws = text.rfind(" ", start + 1, end + 1)
                if ws > start:
                    end = ws
            bounds.append((start, end))
            start = end + 1 if end < n and text[end] == " " else end
    scored = []
    for bi, (bs, be) in enumerate(bounds):
        # a span belongs to the chunk containing its START; the fragment
        # end extends to cover a boundary-straddling match
        inside = [s for s in spans if bs <= s[0] < be]
        if inside:
            be = max(be, max(e for _, e in inside))
            scored.append((len(inside), bi, bs, be, inside))
    if not scored:
        return []
    if num_fragments == 0:
        chosen = scored
    else:
        scored.sort(key=lambda x: (-x[0], x[1]))
        chosen = scored[:num_fragments]
        if order != "score":
            chosen.sort(key=lambda x: x[1])
    frags = []
    for _, _, bs, be, inside in chosen:
        parts = []
        cur = bs
        for s, e in inside:
            parts.append(text[cur:s])
            parts.append(pre)
            parts.append(text[s:e])
            parts.append(post)
            cur = e
        parts.append(text[cur:be])
        frags.append("".join(parts))
    return frags


def highlight_hit(seg, ord_: int, highlight_spec: dict, query,
                  mapper) -> Optional[dict]:
    """Compute the `highlight` section for one hit, or None."""
    if not highlight_spec or query is None:
        return None
    matchers = extract_matchers(query, mapper)
    fields_spec = highlight_spec.get("fields", {})
    if isinstance(fields_spec, list):   # ES accepts a list of single-key dicts
        merged = {}
        for f in fields_spec:
            merged.update(f)
        fields_spec = merged
    global_pre = (highlight_spec.get("pre_tags") or ["<em>"])[0]
    global_post = (highlight_spec.get("post_tags") or ["</em>"])[0]
    require_match = highlight_spec.get("require_field_match", True)
    out = {}
    for pattern, spec in fields_spec.items():
        spec = spec or {}
        for fname in _matching_fields(seg, mapper, pattern):
            m = matchers.get(fname)
            if m is None or m.empty():
                if require_match:
                    continue
                # highlight terms from ANY field on this one
                m = FieldMatchers()
                for other in matchers.values():
                    m.terms |= other.terms
                    m.predicates += other.predicates
                    m.phrases += other.phrases
                if m.empty():
                    continue
            ft = mapper.field_type(fname)
            if ft is None or ft.family not in ("inverted", "keyword"):
                continue
            value = _field_value(seg.sources[ord_], fname)
            if value is None:
                continue
            texts = value if isinstance(value, list) else [value]
            analyzer = mapper.analyzer_for(ft)
            pre = (spec.get("pre_tags") or [global_pre])[0]
            post = (spec.get("post_tags") or [global_post])[0]
            frags_out: List[str] = []
            for text in texts:
                text = str(text)
                tokens = analyzer.tokenize(text)
                idx = _matched_token_indices(tokens, m)
                if not idx:
                    continue
                spans = [(tokens[i].start_offset, tokens[i].end_offset)
                         for i in idx]
                frags_out.extend(_fragment_text(
                    text, spans,
                    int(spec.get("fragment_size", DEFAULT_FRAGMENT_SIZE)),
                    int(spec.get("number_of_fragments", DEFAULT_NUM_FRAGMENTS)),
                    pre, post, spec.get("order", highlight_spec.get("order", "none"))))
            if frags_out:
                nf = int(spec.get("number_of_fragments", DEFAULT_NUM_FRAGMENTS))
                out[fname] = frags_out[:nf] if nf > 0 else frags_out
    return out or None


def _matching_fields(seg, mapper, pattern: str) -> List[str]:
    if "*" not in pattern:
        return [pattern]
    names = set()
    if hasattr(mapper, "field_names"):
        names.update(mapper.field_names())
    names.update(seg.postings.keys())
    return sorted(n for n in names if fnmatch.fnmatchcase(n, pattern))


def _field_value(source: dict, dotted: str):
    node = source
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node
