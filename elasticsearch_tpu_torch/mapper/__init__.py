"""Field mappings (the port's copy of the text, keyword and dense_vector
part of elasticsearch_tpu/mapper)."""

from elasticsearch_tpu_torch.mapper.field_types import (
    DenseVectorFieldType, FieldType, KeywordFieldType, TextFieldType,
    build_field_type,
)
from elasticsearch_tpu_torch.mapper.mapper_service import MapperService

__all__ = ["DenseVectorFieldType", "FieldType", "KeywordFieldType",
           "TextFieldType", "build_field_type", "MapperService"]
