"""Field mappings (the port's copy of the text/keyword part of
elasticsearch_tpu/mapper)."""

from elasticsearch_tpu_torch.mapper.field_types import (
    FieldType, KeywordFieldType, TextFieldType, build_field_type,
)
from elasticsearch_tpu_torch.mapper.mapper_service import MapperService

__all__ = ["FieldType", "KeywordFieldType", "TextFieldType",
           "build_field_type", "MapperService"]
