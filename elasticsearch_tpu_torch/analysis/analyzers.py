"""Text analysis: tokenizers + token-filter chains.

Host-side (indexing is CPU work in this design; ref SURVEY.md §3.3 — JSON
parse + analysis is the host hot loop). Mirrors the reference's analyzer
registry model (ref: index/analysis/AnalysisRegistry.java and the
analysis-common module's standard/whitespace/keyword/stop analyzers) without
its class explosion: an Analyzer is a tokenizer function plus a list of
token-filter functions; custom analyzers are assembled from named parts.

Tokens carry positions (for phrase queries) and offsets (for highlighting).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Iterable, List

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError

# Reference standard tokenizer is UAX#29 word-break; this regex covers the
# alnum word segmentation that matters for scoring parity on English corpora.
_WORD_RE = re.compile(r"[0-9A-Za-z_À-ɏЀ-ӿ؀-ۿ一-鿿]+")
_WS_RE = re.compile(r"\S+")
_LETTER_RE = re.compile(r"[A-Za-zÀ-ɏЀ-ӿ]+")

ENGLISH_STOPWORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)


@dataclass
class Token:
    term: str
    position: int
    start_offset: int
    end_offset: int


TokenFilter = Callable[[Iterable[Token]], Iterable[Token]]


def lowercase_filter(tokens: Iterable[Token]) -> Iterable[Token]:
    for t in tokens:
        t.term = t.term.lower()
        yield t


def make_stop_filter(stopwords: frozenset[str]) -> TokenFilter:
    def stop(tokens: Iterable[Token]) -> Iterable[Token]:
        # Positions are preserved across removed stopwords (position gaps),
        # matching the reference's StopFilter posInc behaviour.
        for t in tokens:
            if t.term not in stopwords:
                yield t

    return stop


def make_length_filter(min_len: int, max_len: int) -> TokenFilter:
    def length(tokens: Iterable[Token]) -> Iterable[Token]:
        for t in tokens:
            if min_len <= len(t.term) <= max_len:
                yield t

    return length


_ASCII_FOLD = str.maketrans(
    "àáâãäåçèéêëìíîïñòóôõöùúûüýÿÀÁÂÃÄÅÇÈÉÊËÌÍÎÏÑÒÓÔÕÖÙÚÛÜÝ",
    "aaaaaaceeeeiiiinooooouuuuyyAAAAAACEEEEIIIINOOOOOUUUUY",
)


def asciifolding_filter(tokens: Iterable[Token]) -> Iterable[Token]:
    for t in tokens:
        t.term = t.term.translate(_ASCII_FOLD)
        yield t


class Analyzer:
    def __init__(self, name: str, token_re: re.Pattern | None, filters: List[TokenFilter]):
        self.name = name
        self._token_re = token_re  # None => emit whole input as one token
        self._filters = filters

    def tokenize(self, text: str) -> List[Token]:
        if self._token_re is None:
            tokens: Iterable[Token] = [Token(text, 0, 0, len(text))] if text else []
        else:
            tokens = (
                Token(m.group(0), pos, m.start(), m.end())
                for pos, m in enumerate(self._token_re.finditer(text))
            )
        for f in self._filters:
            tokens = f(tokens)
        return list(tokens)

    def terms(self, text: str) -> List[str]:
        return [t.term for t in self.tokenize(text)]


def StandardAnalyzer() -> Analyzer:
    return Analyzer("standard", _WORD_RE, [lowercase_filter])


def WhitespaceAnalyzer() -> Analyzer:
    return Analyzer("whitespace", _WS_RE, [])


def KeywordAnalyzer() -> Analyzer:
    return Analyzer("keyword", None, [])


def SimpleAnalyzer() -> Analyzer:
    return Analyzer("simple", _LETTER_RE, [lowercase_filter])


def StopAnalyzer(stopwords: frozenset[str] = ENGLISH_STOPWORDS) -> Analyzer:
    return Analyzer("stop", _LETTER_RE, [lowercase_filter, make_stop_filter(stopwords)])


class AnalysisRegistry:
    """Named analyzers per index, with custom-analyzer assembly from settings.

    Ref: index/analysis/AnalysisRegistry.java:46. Custom analyzers are defined
    in index settings as {"tokenizer": ..., "filter": [...]}.
    """

    _BUILTIN = {
        "standard": StandardAnalyzer,
        "whitespace": WhitespaceAnalyzer,
        "keyword": KeywordAnalyzer,
        "simple": SimpleAnalyzer,
        "stop": StopAnalyzer,
    }

    _TOKENIZERS = {
        "standard": _WORD_RE,
        "whitespace": _WS_RE,
        "letter": _LETTER_RE,
        "keyword": None,
    }

    def __init__(self, analyzer_settings: dict | None = None):
        self._analyzers: dict[str, Analyzer] = {}
        for name, config in (analyzer_settings or {}).items():
            self._analyzers[name] = self._build_custom(name, config)

    def _build_custom(self, name: str, config: dict) -> Analyzer:
        if config.get("type") in self._BUILTIN:
            return self._BUILTIN[config["type"]]()
        tokenizer = config.get("tokenizer", "standard")
        if tokenizer not in self._TOKENIZERS:
            raise IllegalArgumentError(f"failed to find tokenizer [{tokenizer}] for analyzer [{name}]")
        filters: List[TokenFilter] = []
        for fname in config.get("filter", []):
            if fname == "lowercase":
                filters.append(lowercase_filter)
            elif fname == "stop":
                filters.append(make_stop_filter(ENGLISH_STOPWORDS))
            elif fname == "asciifolding":
                filters.append(asciifolding_filter)
            else:
                raise IllegalArgumentError(f"failed to find filter [{fname}] for analyzer [{name}]")
        return Analyzer(name, self._TOKENIZERS[tokenizer], filters)

    def get(self, name: str) -> Analyzer:
        if name in self._analyzers:
            return self._analyzers[name]
        builder = self._BUILTIN.get(name)
        if builder is None:
            raise IllegalArgumentError(f"failed to find analyzer [{name}]")
        analyzer = builder()
        self._analyzers[name] = analyzer
        return analyzer
