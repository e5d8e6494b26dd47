"""The `field_type` / `analyzer_for` surface of the reference's
MapperService (elasticsearch_tpu/mapper/mapper_service.py), which the
serving path's plan extraction reads. Document parsing is not ported."""

from __future__ import annotations

import threading
from typing import Dict

from elasticsearch_tpu_torch.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, MapperParsingError,
)
from elasticsearch_tpu_torch.mapper.field_types import (
    FieldType, build_field_type,
)


class MapperService:
    def __init__(self, mappings: dict | None = None,
                 analysis_registry: AnalysisRegistry | None = None):
        self._lock = threading.Lock()
        self._field_types: Dict[str, FieldType] = {}  # guarded by: _lock
        self._analyzers = analysis_registry or AnalysisRegistry()
        if mappings:
            self.merge(mappings)

    def merge(self, mappings: dict) -> None:
        """Merge a mapping definition {"properties": {...}}; conflicting
        type changes raise, new fields are added."""
        props = mappings.get("properties")
        if props is None:
            props = {k: v for k, v in mappings.items()
                     if isinstance(v, dict)
                     and ("type" in v or "properties" in v)
                     and not k.startswith("_")}
        with self._lock:
            self._merge_props("", props or {})

    def _merge_props(self, prefix: str, props: dict) -> None:
        for name, definition in props.items():
            full = f"{prefix}{name}"
            if not isinstance(definition, dict):
                raise MapperParsingError(f"Expected map for property [{full}]")
            if ("properties" in definition and "type" not in definition) \
                    or definition.get("type") == "object":
                self._merge_props(f"{full}.",
                                  definition.get("properties", {}))
                continue
            new_type = build_field_type(full, definition)
            existing = self._field_types.get(full)
            if existing is not None:
                if existing.params.get("type") != definition.get("type"):
                    raise IllegalArgumentError(
                        f"mapper [{full}] cannot be changed from type "
                        f"[{existing.params.get('type')}] to "
                        f"[{definition.get('type')}]")
                continue
            for sub_name, sub_def in (definition.get("fields") or {}).items():
                sub = build_field_type(f"{full}.{sub_name}", sub_def)
                new_type.multi_fields.append(sub)
                self._field_types[f"{full}.{sub_name}"] = sub
            self._field_types[full] = new_type

    def field_type(self, name: str) -> FieldType | None:
        return self._field_types.get(name)

    def analyzer_for(self, ft: FieldType):
        return self._analyzers.get(ft.params.get("analyzer", "standard"))
