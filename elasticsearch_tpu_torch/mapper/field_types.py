"""Field types the serving paths read (the port's copy of the text, keyword
and dense_vector types of elasticsearch_tpu/mapper/field_types.py, and of
its `parse_date_millis`, which the `date_range` aggregation reads). Other
field families are not ported yet: `build_field_type` rejects them."""

from __future__ import annotations

import datetime as _dt
from typing import Any

import numpy as np

from elasticsearch_tpu_torch.common.errors import MapperParsingError


class FieldType:
    """Base field type. `family` drives segment storage layout."""

    family = "none"  # inverted | keyword | vector

    def __init__(self, name: str, params: dict):
        self.name = name
        self.params = params
        self.multi_fields: list["FieldType"] = []


class TextFieldType(FieldType):
    """Full-text: analyzed into positioned terms."""

    family = "inverted"


class KeywordFieldType(FieldType):
    """Exact-match string; indexed untokenized."""

    family = "keyword"


class DenseVectorFieldType(FieldType):
    """Dense float vectors as rows of a per-segment [n_docs, dims] matrix
    (max 4096 dims)."""

    family = "vector"
    searchable = False

    def __init__(self, name: str, params: dict):
        super().__init__(name, params)
        self.dims = int(params.get("dims", 0))
        if not (0 < self.dims <= 4096):
            raise MapperParsingError(
                f"[dims] must be in [1, 4096] for field [{self.name}]")
        self.similarity = params.get("similarity", "cosine")

    def doc_value(self, value):
        arr = np.asarray(value, dtype=np.float32)
        if arr.shape != (self.dims,):
            raise MapperParsingError(
                f"The [dims] of field [{self.name}] is [{self.dims}], "
                f"but the provided vector has [{arr.shape}]")
        if not np.all(np.isfinite(arr)):
            raise MapperParsingError(
                f"Vector for field [{self.name}] contains non-finite values")
        return arr


_TYPES = {"text": TextFieldType, "keyword": KeywordFieldType,
          "dense_vector": DenseVectorFieldType}


def build_field_type(name: str, params: dict) -> FieldType:
    t = params.get("type")
    if t in _TYPES:
        return _TYPES[t](name, params)
    raise MapperParsingError(
        f"No handler for type [{t}] declared on field [{name}] "
        f"(the port serves text, keyword and dense_vector fields so far)")


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
