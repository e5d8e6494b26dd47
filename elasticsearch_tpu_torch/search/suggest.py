"""Suggesters: term, phrase, completion (ref: the reference's suggest
module, server/src/main/java/org/elasticsearch/search/suggest/).

Placement: suggestion is a term-DICTIONARY problem, not a
postings-scoring problem — vocabulary sizes (10^5-10^6) are four orders of
magnitude below doc counts, so these run on host over the segment term
dictionaries (the analog of Lucene's FST walks), leaving the device for
the O(docs) work:

* term — candidate generation by banded edit distance over a
  (prefix, length)-bucketed dictionary index (the hash-prefilter analog of
  DirectSpellChecker's Levenshtein automaton walk,
  ref: search/suggest/term/TermSuggester.java).
* phrase — unigram language-model rescoring of candidate corrections with
  beam search, real-word error likelihood and confidence cutoffs (the
  gram_size=1 configuration of PhraseSuggester's NoisyChannelSpellChecker,
  ref: search/suggest/phrase/PhraseSuggester.java; higher-order grams need
  a shingle subfield, same as the reference).
* completion — prefix search over per-segment sorted (input, weight, doc)
  arrays built from stored completion-field values, weight-ranked (the
  sorted-array analog of the FST in
  search/suggest/completion/CompletionSuggester.java).

All suggesters work over EVERY (segment, live) view at once with
index-global frequencies, which matches the reference's coordinator-merged
semantics in one pass.

The port's copy of elasticsearch_tpu/search/suggest.py; its code differs only
in the imports.
"""

from __future__ import annotations

import heapq
import math
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError


# --------------------------------------------------------------------------
# dictionary index (cached per segment+field)
# --------------------------------------------------------------------------


class _DictIndex:
    """(first prefix char, length)-bucketed term dictionary for banded
    edit-distance candidate generation."""

    def __init__(self, terms_df: Dict[str, int], total_tf: float):
        self.df = terms_df
        self.total_tf = max(total_tf, 1.0)
        self.buckets: Dict[Tuple[str, int], List[str]] = {}
        for t in terms_df:
            if not t:
                continue
            self.buckets.setdefault((t[0], len(t)), []).append(t)

    def candidates(self, word: str, max_edits: int, prefix_length: int,
                   max_inspections: int = 1 << 14) -> List[str]:
        """Terms within max_edits of `word` sharing its prefix_length-char
        prefix. An edit can change length by one, so only length buckets
        within +-max_edits need inspection."""
        out = []
        first = word[:1]
        inspected = 0
        for dl in range(-max_edits, max_edits + 1):
            ln = len(word) + dl
            if ln <= 0:
                continue
            # prefix_length >= 1 pins the first character (the reference's
            # default — typos rarely hit the first letter)
            firsts = [first] if prefix_length >= 1 else \
                list({k[0] for k in self.buckets})
            for f in firsts:
                for cand in self.buckets.get((f, ln), ()):
                    inspected += 1
                    if inspected > max_inspections:
                        return out
                    if cand == word:
                        continue
                    if word[:prefix_length] != cand[:prefix_length]:
                        continue
                    if _edit_distance_banded(word, cand, max_edits) \
                            <= max_edits:
                        out.append(cand)
        return out


def _edit_distance_banded(a: str, b: str, band: int) -> int:
    """Levenshtein distance, early-exit when it must exceed `band`."""
    if abs(len(a) - len(b)) > band:
        return band + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        lo = band + 1
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != cb))
            lo = min(lo, cur[j])
        if lo > band:
            return band + 1
        prev = cur
    return prev[-1]


def _field_dict(views, field: str) -> _DictIndex:
    """Index-global df per term over live views, cached on the view set."""
    df: Dict[str, int] = {}
    ttf = 0.0
    for v in views:
        fp = v.segment.postings.get(field)
        if fp is None:
            continue
        cached = getattr(v.segment, "_suggest_dict_cache", None)
        if cached is None:
            cached = {}
            v.segment._suggest_dict_cache = cached
        if field not in cached:
            cached[field] = (
                {t: int(fp.doc_freq[o]) for t, o in fp.term_to_ord.items()},
                float(fp.total_term_freq.sum()))
        seg_df, seg_ttf = cached[field]
        for t, n in seg_df.items():
            df[t] = df.get(t, 0) + n
        ttf += seg_ttf
    return _DictIndex(df, ttf)


# --------------------------------------------------------------------------
# term suggester
# --------------------------------------------------------------------------


def _similarity(word: str, cand: str, ed: int) -> float:
    return 1.0 - ed / max(len(word), len(cand), 1)


def _analyze(mapper, field: str, text: str) -> List[Tuple[str, int, int]]:
    """(term, offset, length) tokens; offsets are best-effort recovered by
    scanning the original text left to right."""
    ft = mapper.field_type(field)
    if ft is None:
        raise IllegalArgumentError(f"no mapping found for field [{field}]")
    terms = mapper.analyzer_for(ft).terms(text)
    out = []
    cursor = 0
    low = text.lower()
    for t in terms:
        at = low.find(t, cursor)
        if at < 0:
            at = cursor
        out.append((t, at, len(t)))
        cursor = at + len(t)
    return out


def _term_suggest(views, mapper, text: str, spec: dict) -> List[dict]:
    field = spec.get("field")
    if not field:
        raise IllegalArgumentError("suggester [term] requires [field]")
    size = int(spec.get("size", 5))
    max_edits = int(spec.get("max_edits", 2))
    if not 1 <= max_edits <= 2:
        raise IllegalArgumentError("max_edits must be 1 or 2")
    prefix_length = int(spec.get("prefix_length", 1))
    min_word_length = int(spec.get("min_word_length", 4))
    mode = spec.get("suggest_mode", "missing")
    sort = spec.get("sort", "score")
    d = _field_dict(views, field)

    entries = []
    for word, off, ln in _analyze(mapper, field, text):
        options: List[dict] = []
        freq_self = d.df.get(word, 0)
        want = (mode == "always"
                or (mode == "missing" and freq_self == 0)
                or mode == "popular")
        if want and len(word) >= min_word_length:
            for cand in d.candidates(word, max_edits, prefix_length):
                freq = d.df[cand]
                if mode == "popular" and freq <= freq_self:
                    continue
                ed = _edit_distance_banded(word, cand, max_edits)
                options.append({"text": cand,
                                "score": round(_similarity(word, cand, ed), 6),
                                "freq": freq})
            if sort == "frequency":
                options.sort(key=lambda o: (-o["freq"], -o["score"],
                                            o["text"]))
            else:
                options.sort(key=lambda o: (-o["score"], -o["freq"],
                                            o["text"]))
            options = options[:size]
        entries.append({"text": word, "offset": off, "length": ln,
                        "options": options})
    return entries


# --------------------------------------------------------------------------
# phrase suggester
# --------------------------------------------------------------------------


def _phrase_suggest(views, mapper, text: str, spec: dict) -> List[dict]:
    field = spec.get("field")
    if not field:
        raise IllegalArgumentError("suggester [phrase] requires [field]")
    size = int(spec.get("size", 5))
    max_errors = float(spec.get("max_errors", 1.0))
    confidence = float(spec.get("confidence", 1.0))
    rwel = float(spec.get("real_word_error_likelihood", 0.95))
    gen = (spec.get("direct_generator") or [{}])[0]
    max_edits = int(gen.get("max_edits", 2))
    prefix_length = int(gen.get("prefix_length", 1))
    cand_size = int(gen.get("size", 5))
    highlight = spec.get("highlight")
    d = _field_dict(views, field)

    tokens = _analyze(mapper, field, text)
    words = [w for w, _, _ in tokens]
    if not words:
        return [{"text": text, "offset": 0, "length": len(text),
                 "options": []}]
    n_allowed = max(1, int(math.ceil(max_errors * len(words)))
                    if max_errors <= 1.0 else int(max_errors))

    def uni_logp(w: str, original: bool) -> float:
        # unigram LM with +0.5 smoothing; existing original words carry the
        # real-word error likelihood (ref: LaplaceScorer + confidence gate)
        p = (d.df.get(w, 0) + 0.5) / (d.total_tf + 0.5)
        if original and d.df.get(w, 0) > 0:
            p *= rwel
        return math.log(p)

    # per-token candidate lists (original first)
    per_token: List[List[str]] = []
    for w in words:
        cands = [w]
        if len(w) >= 2:
            scored = []
            for c in d.candidates(w, max_edits, prefix_length):
                ed = _edit_distance_banded(w, c, max_edits)
                scored.append((-_similarity(w, c, ed), -d.df[c], c))
            scored.sort()
            cands += [c for _, _, c in scored[:cand_size]]
        per_token.append(cands)

    base_score = sum(uni_logp(w, True) for w in words)

    # beam over correction combinations bounded by n_allowed edits
    beam: List[Tuple[float, int, Tuple[str, ...]]] = [(0.0, 0, ())]
    for ti, cands in enumerate(per_token):
        nxt = []
        for lp, nerr, seq in beam:
            for ci, c in enumerate(cands):
                err = nerr + (1 if ci > 0 else 0)
                if err > n_allowed:
                    continue
                nxt.append((lp + uni_logp(c, ci == 0), err, seq + (c,)))
        nxt.sort(key=lambda x: -x[0])
        beam = nxt[:32]

    options = []
    seen = set()
    for lp, nerr, seq in beam:
        if nerr == 0:
            continue
        phrase = " ".join(seq)
        if phrase in seen:
            continue
        seen.add(phrase)
        if lp <= base_score + math.log(max(confidence, 1e-9)):
            continue
        opt = {"text": phrase, "score": round(math.exp(lp / len(seq)), 8)}
        if highlight:
            pre = highlight.get("pre_tag", "<em>")
            post = highlight.get("post_tag", "</em>")
            opt["highlighted"] = " ".join(
                f"{pre}{c}{post}" if c != words[i] else c
                for i, c in enumerate(seq))
        options.append(opt)
    options.sort(key=lambda o: -o["score"])
    end = tokens[-1][1] + tokens[-1][2]
    return [{"text": text, "offset": 0, "length": end,
             "options": options[:size]}]


# --------------------------------------------------------------------------
# completion suggester
# --------------------------------------------------------------------------


def _completion_entries(segment, field: str):
    """Sorted (input_lower, weight, doc_ord, input) built from stored
    sources — the array analog of the reference's per-segment FST."""
    cache = getattr(segment, "_completion_cache", None)
    if cache is None:
        cache = {}
        segment._completion_cache = cache
    if field in cache:
        return cache[field]
    rows: List[Tuple[str, int, int, str]] = []
    for ord_, src in enumerate(segment.sources):
        if src is None:
            continue
        val = src.get(field)
        if val is None:
            continue
        vals = val if isinstance(val, list) else [val]
        if vals and all(isinstance(x, str) for x in vals):
            # a plain string array is ONE entry with multiple inputs
            vals = [{"input": vals}]
        for v in vals:
            if isinstance(v, str):
                inputs, weight = [v], 1
            elif isinstance(v, dict):
                inp = v.get("input", [])
                inputs = [inp] if isinstance(inp, str) else list(inp)
                weight = int(v.get("weight", 1))
            else:
                continue
            for text_in in inputs:
                rows.append((str(text_in).lower(), weight, ord_,
                             str(text_in)))
    rows.sort()
    cache[field] = rows
    return rows


def _completion_suggest(views, mapper, text: str, spec: dict) -> List[dict]:
    field = spec.get("field")
    if not field:
        raise IllegalArgumentError("suggester [completion] requires [field]")
    size = int(spec.get("size", 5))
    skip_dup = bool(spec.get("skip_duplicates", False))
    prefix = text.lower()
    heap: List[Tuple[int, str, str]] = []   # (weight, input, _id)
    for v in views:
        rows = _completion_entries(v.segment, field)
        keys = [r[0] for r in rows]
        i = bisect_left(keys, prefix)
        while i < len(rows) and rows[i][0].startswith(prefix):
            low, weight, ord_, original = rows[i]
            i += 1
            if not bool(v.live[ord_]):
                continue
            heapq.heappush(heap, (weight, original, v.segment.doc_ids[ord_]))
            if len(heap) > max(size * 4, 32):
                heapq.heappop(heap)
    ranked = sorted(heap, key=lambda r: (-r[0], r[1]))
    options = []
    seen_text = set()
    for weight, original, doc_id in ranked:
        if skip_dup:
            if original in seen_text:
                continue
            seen_text.add(original)
        options.append({"text": original, "_id": doc_id,
                        "score": float(weight)})
        if len(options) >= size:
            break
    return [{"text": text, "offset": 0, "length": len(text),
             "options": options}]


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------


_KINDS = {"term": _term_suggest, "phrase": _phrase_suggest,
          "completion": _completion_suggest}


def execute_suggest(views: Sequence, mapper, suggest_spec: dict) -> dict:
    """The `suggest` block of `_search` (or the standalone suggest body).

    views: every (segment, live) view across shards — frequencies are
    index-global in one pass, matching the reference's coordinator-merged
    output."""
    if not isinstance(suggest_spec, dict):
        raise IllegalArgumentError("[suggest] must be an object")
    global_text = suggest_spec.get("text")
    out = {}
    for name, body in suggest_spec.items():
        if name == "text":
            continue
        if not isinstance(body, dict):
            raise IllegalArgumentError(f"suggester [{name}] must be an object")
        kinds = [k for k in body if k in _KINDS]
        if len(kinds) != 1:
            raise IllegalArgumentError(
                f"suggester [{name}] requires exactly one of "
                f"{sorted(_KINDS)}")
        kind = kinds[0]
        text = body.get("text") or body.get("prefix") or global_text
        if text is None:
            raise IllegalArgumentError(
                f"suggester [{name}] requires [text] or [prefix]")
        out[name] = _KINDS[kind](views, mapper, str(text), body[kind])
    return out
