"""MapperService: index schema registry + JSON document parsing.

Re-designs the reference's MapperService/DocumentParser pair
(ref: index/mapper/MapperService.java:54, DocumentParser.java:35): holds the
per-index mapping, parses JSON docs into the flat representation the segment
builder consumes, performs dynamic mapping for unseen fields, and merges
mapping updates (new fields only; type changes are conflicts, as in the
reference's strict merge).

Dot-notation flattening handles object fields; arrays index every element
into the same field (reference array semantics).

The port's copy of elasticsearch_tpu/mapper/mapper_service.py, whole.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np

from elasticsearch_tpu_torch.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.common.errors import IllegalArgumentError, MapperParsingError
from elasticsearch_tpu_torch.mapper.field_types import (
    DateFieldType,
    FieldType,
    build_field_type,
    parse_date_millis,
)


@dataclass
class LuceneDoc:
    """The indexable form of one document (analog of the reference's
    ParseContext.Document): what the segment builder consumes."""

    doc_id: str
    source: dict
    # field -> [(term, positions)], for inverted ("text") fields
    inverted: Dict[str, List[Tuple[str, List[int]]]] = field(default_factory=dict)
    # field -> list of float values (numeric family columns; multivalued)
    numeric: Dict[str, List[float]] = field(default_factory=dict)
    # field -> list of str values (keyword family; ordinal columns)
    keyword: Dict[str, List[str]] = field(default_factory=dict)
    # field -> np.ndarray (dense vectors)
    vectors: Dict[str, np.ndarray] = field(default_factory=dict)
    # total token count per text field (field length norm for BM25)
    field_lengths: Dict[str, int] = field(default_factory=dict)
    # field -> [(lat, lon)] pairs (geo_point columns keep pairing intact)
    geo: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    # nested field -> list of CHILD docs (each a LuceneDoc over the child
    # object, fields under their full dotted names)
    nested: Dict[str, List["LuceneDoc"]] = field(default_factory=dict)
    # next free position per text field (internal; positions-gap bookkeeping)
    _pos_ceiling: Dict[str, int] = field(default_factory=dict)


# type used for ParsedDocument in external signatures; kept as alias
ParsedDocument = LuceneDoc


_DEFAULT_DATE_PATTERNS = ("date_optional_time",)


class MapperService:
    SINGLE_MAPPING_NAME = "_doc"

    def __init__(self, mappings: dict | None = None, analysis_registry: AnalysisRegistry | None = None,
                 dynamic: bool = True):
        self._lock = threading.Lock()
        self._field_types: Dict[str, FieldType] = {}
        self._analyzers = analysis_registry or AnalysisRegistry()
        self.dynamic = dynamic
        if mappings:
            self.merge(mappings)

    # ---- schema ----

    def merge(self, mappings: dict) -> None:
        """Merge a mapping definition {"properties": {...}}; conflicting type
        changes raise, new fields are added (ref: MapperService.merge)."""
        props = mappings.get("properties")
        if props is None:
            # a bare field map; meta sections (_source, dynamic, ...) are
            # index options, not fields — but anything shaped like a field
            # definition (a dict with type/properties) IS a field, whatever
            # its name
            props = {k: v for k, v in mappings.items()
                     if isinstance(v, dict)
                     and ("type" in v or "properties" in v)
                     and not k.startswith("_")}
        props = props or {}
        with self._lock:
            self._merge_props("", props)

    def _merge_props(self, prefix: str, props: dict) -> None:
        for name, definition in props.items():
            full = f"{prefix}{name}"
            if not isinstance(definition, dict):
                raise MapperParsingError(f"Expected map for property [{full}]")
            if "properties" in definition and "type" not in definition:
                self._merge_props(f"{full}.", definition["properties"])
                continue
            if definition.get("type") == "object":
                self._merge_props(f"{full}.", definition.get("properties", {}))
                continue
            if definition.get("type") == "nested":
                self._field_types[full] = build_field_type(full, definition)
                # child sub-fields register under their dotted names; the
                # nested root intercepts parsing so they only index into
                # the child table, never the parent
                self._merge_props(f"{full}.", definition.get("properties", {}))
                continue
            new_type = build_field_type(full, definition)
            existing = self._field_types.get(full)
            if existing is not None:
                if existing.params.get("type") != definition.get("type"):
                    raise IllegalArgumentError(
                        f"mapper [{full}] cannot be changed from type "
                        f"[{existing.params.get('type')}] to [{definition.get('type')}]"
                    )
                continue
            for sub_name, sub_def in (definition.get("fields") or {}).items():
                sub = build_field_type(f"{full}.{sub_name}", sub_def)
                new_type.multi_fields.append(sub)
                self._field_types[f"{full}.{sub_name}"] = sub
            self._field_types[full] = new_type

    def field_type(self, name: str) -> FieldType | None:
        return self._field_types.get(name)

    def join_field(self) -> FieldType | None:
        """The index's single join field, if mapped (the reference allows
        at most one, ParentJoinFieldMapper.java)."""
        for ft in self._field_types.values():
            if ft.family == "join":
                return ft
        return None

    def field_names(self) -> List[str]:
        return sorted(self._field_types)

    def mapping(self) -> dict:
        """Render back as nested {"properties": ...} JSON."""
        root: dict = {}
        for name in sorted(self._field_types):
            parts = name.split(".")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {}).setdefault("properties", {})
            node[parts[-1]] = self._field_types[name].mapping()
        return {"properties": root}

    def analyzer_for(self, ft: FieldType):
        name = ft.params.get("analyzer", "standard")
        return self._analyzers.get(name)

    # ---- document parsing ----

    def parse(self, doc_id: str, source: dict) -> LuceneDoc:
        doc = LuceneDoc(doc_id=doc_id, source=source)
        dynamic_updates: Dict[str, FieldType] = {}
        self._parse_obj("", source, doc, dynamic_updates)
        if dynamic_updates:
            with self._lock:
                for name, ft in dynamic_updates.items():
                    self._field_types.setdefault(name, ft)
        return doc

    def _parse_obj(self, prefix: str, obj: dict, doc: LuceneDoc, dyn: Dict[str, FieldType]) -> None:
        for key, value in obj.items():
            full = f"{prefix}{key}"
            known = self._field_types.get(full)
            if known is not None and known.family == "nested":
                objs = value if isinstance(value, list) else [value]
                children = doc.nested.setdefault(full, [])
                for child_obj in objs:
                    if not isinstance(child_obj, dict):
                        raise MapperParsingError(
                            f"object mapping for [{full}] tried to parse "
                            "a non-object value as nested")
                    child = LuceneDoc(doc_id=f"{doc.doc_id}#{full}#{len(children)}",
                                      source=child_obj)
                    self._parse_obj(f"{full}.", child_obj, child, dyn)
                    children.append(child)
                continue
            if known is not None and known.family == "completion":
                # {"input": [...], "weight": n} shapes are suggester data
                # read from _source (search/suggest.py), not sub-objects
                continue
            if known is not None and known.family == "join":
                name, parent = known.parse_join_value(value)
                doc.keyword.setdefault(full, []).append(name)
                if parent is not None:
                    doc.keyword.setdefault(f"{full}.__parent",
                                           []).append(parent)
                continue
            if known is not None and known.family == "percolator":
                # stored query: extract candidate-prefilter terms into the
                # hidden keyword sidecar (ref: PercolatorFieldMapper
                # processQuery -> extraction fields)
                from elasticsearch_tpu_torch.search.percolate import (
                    query_index_tokens,
                )

                if not isinstance(value, dict):
                    raise MapperParsingError(
                        f"percolator field [{full}] must hold a query object")
                # an empty token list (match_none) means never-candidate
                toks = query_index_tokens(self, value)
                if toks:
                    doc.keyword.setdefault(f"{full}.__terms", []).extend(toks)
                continue
            if isinstance(value, dict) and not (
                    known is not None and known.family == "geo"):
                self._parse_obj(f"{full}.", value, doc, dyn)
                continue
            if known is not None and known.family == "vector":
                self._index_values(known, [value], doc)  # whole array is one value
                continue
            if known is not None and known.family == "geo":
                # [lon, lat] is ONE point; a list of dicts/strings/pairs is
                # multi-valued
                if isinstance(value, list) and value and \
                        isinstance(value[0], (dict, str, list, tuple)):
                    self._index_values(known, list(value), doc)
                else:
                    self._index_values(known, [value], doc)
                continue
            values = value if isinstance(value, list) else [value]
            # nested objects inside arrays are flattened (reference object-array semantics)
            if values and isinstance(values[0], dict):
                for v in values:
                    if isinstance(v, dict):
                        self._parse_obj(f"{full}.", v, doc, dyn)
                continue
            ft = self._field_types.get(full)
            if ft is None:
                ft = self._dynamic_field_type(full, values, dyn)
                if ft is None:
                    continue
            self._index_values(ft, values, doc)

    def _index_values(self, ft: FieldType, values: list, doc: LuceneDoc) -> None:
        for mf in ft.multi_fields:
            self._index_values(mf, values, doc)
        for v in values:
            if v is None:
                continue
            if ft.family == "inverted":
                analyzer = self.analyzer_for(ft)
                terms = ft.index_terms(v, analyzer)
                # position offset so multi-valued text keeps phrase semantics
                # separate across values (reference position_increment_gap=100)
                base = doc._pos_ceiling.get(ft.name, 0)
                if base:
                    base += 100
                shifted = [(t, [p + base for p in ps]) for t, ps in terms]
                bucket = doc.inverted.setdefault(ft.name, [])
                bucket.extend(shifted)
                n_tokens = sum(len(ps) for _, ps in terms)
                max_pos = max((p for _, ps in shifted for p in ps), default=base - 1)
                doc._pos_ceiling[ft.name] = max_pos + 1
                doc.field_lengths[ft.name] = doc.field_lengths.get(ft.name, 0) + n_tokens
            elif ft.family == "numeric":
                doc.numeric.setdefault(ft.name, []).append(ft.doc_value(v))
            elif ft.family == "keyword":
                dv = ft.doc_value(v)
                if dv is not None:
                    doc.keyword.setdefault(ft.name, []).append(dv)
            elif ft.family == "vector":
                doc.vectors[ft.name] = ft.doc_value(v)
            elif ft.family == "geo":
                doc.geo.setdefault(ft.name, []).append(ft.doc_value(v))

    def _dynamic_field_type(self, name: str, values: list, dyn: Dict[str, FieldType]) -> FieldType | None:
        """Dynamic mapping rules (ref: DocumentParser dynamic templates default):
        bool->boolean, int->long, float->double (reference maps to float),
        date-parseable string->date, other string->text with .keyword subfield."""
        if not self.dynamic:
            return None
        sample = next((v for v in values if v is not None), None)
        if sample is None:
            return None
        if isinstance(sample, bool):
            params = {"type": "boolean"}
        elif isinstance(sample, int):
            params = {"type": "long"}
        elif isinstance(sample, float):
            params = {"type": "float"}
        elif isinstance(sample, str):
            if _looks_like_date(sample):
                params = {"type": "date"}
            else:
                params = {"type": "text"}
        else:
            return None
        ft = build_field_type(name, params)
        if params["type"] == "text":
            kw = build_field_type(f"{name}.keyword", {"type": "keyword", "ignore_above": 256})
            ft.multi_fields.append(kw)
            dyn[f"{name}.keyword"] = kw
            self._field_types.setdefault(f"{name}.keyword", kw)
        dyn[name] = ft
        self._field_types.setdefault(name, ft)
        return ft


def _looks_like_date(s: str) -> bool:
    if len(s) < 8 or not s[:4].isdigit():
        return False
    try:
        parse_date_millis(s)
        return True
    except MapperParsingError:
        return False
