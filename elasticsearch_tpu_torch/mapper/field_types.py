"""Field types: how JSON values become indexable/columnar data.

Re-designs the reference's MappedFieldType + *FieldMapper pairs
(ref: index/mapper/TextFieldMapper.java, NumberFieldMapper.java,
DateFieldMapper.java, KeywordFieldMapper.java, BooleanFieldMapper.java and
x-pack vectors DenseVectorFieldMapper.java:44) into one class per family.

Each field type knows how to:
  * parse a JSON value into index terms (inverted) and/or a doc value (columnar)
  * normalize query-time values the same way (term/range queries must agree
    with index-time encoding)

Columnar encoding choices are TPU-first: every doc value becomes either an
f64/i64 cell in a dense column, an ordinal into a per-segment sorted term
dictionary (keyword), or a row of a dense [n_docs, dims] matrix (dense_vector).

The port's copy of elasticsearch_tpu/mapper/field_types.py, whole.
"""

from __future__ import annotations

import datetime as _dt
import ipaddress
import math
from typing import Any, List, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError, MapperParsingError


class FieldType:
    """Base field type. `family` drives segment storage layout."""

    family = "none"  # inverted | numeric | keyword | vector
    searchable = True
    has_doc_values = True

    def __init__(self, name: str, params: dict):
        self.name = name
        self.params = params
        # sub-fields indexed from the same JSON value (mapping "fields": {...})
        self.multi_fields: list["FieldType"] = []

    # inverted-index terms for one JSON value: list of (term, [positions])
    def index_terms(self, value: Any, analyzer=None) -> List[Tuple[str, List[int]]]:
        return []

    # columnar value (float for numeric family, str for keyword family)
    def doc_value(self, value: Any) -> Any:
        return None

    def mapping(self) -> dict:
        out = {"type": self.params.get("type", "object")}
        for k, v in self.params.items():
            if k not in ("type", "fields"):
                out[k] = v
        if self.multi_fields:
            out["fields"] = {
                mf.name.rsplit(".", 1)[1]: mf.mapping() for mf in self.multi_fields
            }
        return out


class TextFieldType(FieldType):
    """Full-text: analyzed into positioned terms; no doc values (ref:
    TextFieldMapper — fielddata off by default)."""

    family = "inverted"
    has_doc_values = False

    def index_terms(self, value, analyzer=None):
        tokens = analyzer.tokenize(str(value))
        by_term: dict[str, list[int]] = {}
        for t in tokens:
            by_term.setdefault(t.term, []).append(t.position)
        return list(by_term.items())


class KeywordFieldType(FieldType):
    """Exact-match string; indexed untokenized + ordinal doc values."""

    family = "keyword"

    def __init__(self, name: str, params: dict):
        super().__init__(name, params)
        self.ignore_above = params.get("ignore_above", 2147483647)

    def _normalize(self, value: Any) -> str | None:
        s = value if isinstance(value, str) else _json_str(value)
        if len(s) > self.ignore_above:
            return None
        return s

    def index_terms(self, value, analyzer=None):
        s = self._normalize(value)
        return [] if s is None else [(s, [0])]

    def doc_value(self, value):
        return self._normalize(value)


_INT_TYPES = {"long": (-(2**63), 2**63 - 1), "integer": (-(2**31), 2**31 - 1),
              "short": (-(2**15), 2**15 - 1), "byte": (-(2**7), 2**7 - 1)}
_FLOAT_TYPES = {"double", "float", "half_float"}


class NumberFieldType(FieldType):
    """Numeric family; stored as an f64 column (exact for all int53 and the
    reference's float types at query precision)."""

    family = "numeric"

    def __init__(self, name: str, params: dict):
        super().__init__(name, params)
        self.number_type = params["type"]

    def parse(self, value: Any) -> float:
        if isinstance(value, bool):
            raise MapperParsingError(f"failed to parse field [{self.name}] of type [{self.number_type}]")
        try:
            f = float(value)
        except (TypeError, ValueError):
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type [{self.number_type}]: value [{value}]"
            )
        if self.number_type in _INT_TYPES:
            if not float(f).is_integer():
                # the reference rejects fractional values for integer types unless coerce
                if self.params.get("coerce", True):
                    f = float(int(f))
                else:
                    raise MapperParsingError(f"failed to parse field [{self.name}]: [{value}] has a decimal part")
            lo, hi = _INT_TYPES[self.number_type]
            if not (lo <= f <= hi):
                raise MapperParsingError(f"Value [{value}] out of range for field [{self.name}]")
        return f

    def index_terms(self, value, analyzer=None):
        return []  # numeric search runs against the column, not the inverted index

    def doc_value(self, value):
        return self.parse(value)


class DateFieldType(FieldType):
    """Dates stored as epoch-millis i64 column (ref: DateFieldMapper)."""

    family = "numeric"

    def parse(self, value: Any) -> float:
        return float(parse_date_millis(value))

    def doc_value(self, value):
        return self.parse(value)


class BooleanFieldType(FieldType):
    family = "numeric"

    def parse(self, value: Any) -> float:
        if isinstance(value, bool):
            return 1.0 if value else 0.0
        if value in ("true", "True"):
            return 1.0
        if value in ("false", "False", ""):
            return 0.0
        raise MapperParsingError(f"failed to parse boolean field [{self.name}], value [{value}]")

    def doc_value(self, value):
        return self.parse(value)


class IpFieldType(FieldType):
    """IPs normalized to integer form in an f64 column (v4; v6 stored as
    ordinal keyword fallback)."""

    family = "keyword"

    def _normalize(self, value: Any) -> str:
        try:
            return str(ipaddress.ip_address(str(value)))
        except ValueError:
            raise MapperParsingError(f"failed to parse IP [{value}] for field [{self.name}]")

    def index_terms(self, value, analyzer=None):
        return [(self._normalize(value), [0])]

    def doc_value(self, value):
        return self._normalize(value)


class DenseVectorFieldType(FieldType):
    """Dense float vectors as rows of a per-segment [n_docs, dims] matrix.

    Ref: x-pack vectors DenseVectorFieldMapper.java:56-64 (max 2048 dims,
    binary doc values). TPU-first re-design: the whole segment's vectors are
    one HBM-resident matrix so kNN is a single batched matmul on the MXU.
    """

    family = "vector"
    searchable = False

    def __init__(self, name: str, params: dict):
        super().__init__(name, params)
        self.dims = int(params.get("dims", 0))
        if not (0 < self.dims <= 4096):
            raise MapperParsingError(f"[dims] must be in [1, 4096] for field [{self.name}]")
        self.similarity = params.get("similarity", "cosine")

    def doc_value(self, value):
        arr = np.asarray(value, dtype=np.float32)
        if arr.shape != (self.dims,):
            raise MapperParsingError(
                f"The [dims] of field [{self.name}] is [{self.dims}], "
                f"but the provided vector has [{arr.shape}]"
            )
        if not np.all(np.isfinite(arr)):
            raise MapperParsingError(f"Vector for field [{self.name}] contains non-finite values")
        return arr


class NestedFieldType(FieldType):
    """Nested object arrays (ref: index/mapper/NestedObjectMapper and
    Lucene's block join). TPU-first re-design: instead of interleaving
    hidden child documents into the parent doc-id space (Lucene's layout),
    each nested field owns a columnar CHILD TABLE sidecar in the segment —
    its own postings/columns over child rows plus a child->parent map — so
    the nested query is a child-table scoring pass + one CSR reduce back to
    parents, with parent doc ids, seqnos and live masks untouched."""

    family = "nested"


class GeoPointFieldType(FieldType):
    """lat/lon pairs as TWO dense numeric columns ({field}.lat/{field}.lon —
    ref: GeoPointFieldMapper; the reference packs into a BKD tree, here
    distance/box predicates are vectorized column math over the pair, which
    is the columnar play for spatial filtering on dense hardware)."""

    family = "geo"

    def parse(self, value: Any) -> tuple:
        from elasticsearch_tpu_torch.search.queries import parse_geo_point

        try:
            return parse_geo_point(value)
        except Exception:
            raise MapperParsingError(
                f"failed to parse geo_point [{value}] for [{self.name}]")

    def doc_value(self, value):
        return self.parse(value)


_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def parse_date_millis(value: Any) -> int:
    """epoch_millis int | ISO8601 | yyyy-MM-dd — the reference's
    strict_date_optional_time||epoch_millis default format."""
    if isinstance(value, bool):
        raise MapperParsingError(f"failed to parse date value [{value}]")
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip()
    if s.isdigit() or (s.startswith("-") and s[1:].isdigit()):
        return int(s)
    try:
        if s.endswith("Z"):
            s = s[:-1] + "+00:00"
        dt = _dt.datetime.fromisoformat(s)
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=_dt.timezone.utc)
        return int(dt.timestamp() * 1000)
    except ValueError:
        raise MapperParsingError(f"failed to parse date value [{value}]")


def _json_str(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float) and value.is_integer() and abs(value) < 2**53:
        return str(int(value))
    return str(value)


class JoinFieldType(FieldType):
    """Parent-join relations (ref: modules/parent-join/
    ParentJoinFieldMapper.java). The field's own keyword value is the
    relation NAME (term-searchable, like the reference); a child doc's
    parent id lands in the hidden `<name>.__parent` keyword sidecar.
    Parent and child must share a shard (routing by parent id), exactly
    the reference's constraint."""

    family = "join"

    def __init__(self, name: str, params: dict):
        super().__init__(name, params)
        rels = params.get("relations", {}) or {}
        self.relations = rels
        self.parent_of: dict[str, str] = {}
        for p, cs in rels.items():
            for c in ([cs] if isinstance(cs, str) else cs):
                self.parent_of[c] = p

    def parse_join_value(self, value):
        """(relation_name, parent_id|None), validated."""
        if isinstance(value, str):
            name, parent = value, None
        elif isinstance(value, dict):
            name = value.get("name")
            parent = value.get("parent")
        else:
            raise MapperParsingError(
                f"join field [{self.name}] expects a name or object")
        known = set(self.relations) | set(self.parent_of)
        if name not in known:
            raise MapperParsingError(
                f"unknown join name [{name}] for field [{self.name}]")
        if name in self.parent_of and parent is None:
            raise MapperParsingError(
                f"[parent] is missing for join field [{self.name}]")
        return name, (None if parent is None else str(parent))

    def index_terms(self, value, analyzer=None):
        return []


class PercolatorFieldType(FieldType):
    """Stored-query field (ref: modules/percolator/
    PercolatorFieldMapper.java). The query JSON stays in _source; index
    time extracts its terms into a hidden `<name>.__terms` keyword sidecar
    for candidate prefiltering (search/percolate.py)."""

    family = "percolator"

    def index_terms(self, value, analyzer=None):
        return []


class CompletionFieldType(FieldType):
    """Completion-suggester input field (ref: CompletionFieldMapper.java).
    The suggester builds its per-segment sorted prefix arrays from stored
    _source values (search/suggest.py); no postings are indexed."""

    family = "completion"

    def index_terms(self, value, analyzer=None):
        return []


_TYPES = {
    "text": TextFieldType,
    "keyword": KeywordFieldType,
    "completion": CompletionFieldType,
    "percolator": PercolatorFieldType,
    "join": JoinFieldType,
    "date": DateFieldType,
    "date_nanos": DateFieldType,
    "boolean": BooleanFieldType,
    "ip": IpFieldType,
    "dense_vector": DenseVectorFieldType,
    "geo_point": GeoPointFieldType,
    "nested": NestedFieldType,
}


def build_field_type(name: str, params: dict) -> FieldType:
    t = params.get("type")
    if t in _TYPES:
        return _TYPES[t](name, params)
    if t in _INT_TYPES or t in _FLOAT_TYPES:
        return NumberFieldType(name, params)
    raise MapperParsingError(f"No handler for type [{t}] declared on field [{name}]")
