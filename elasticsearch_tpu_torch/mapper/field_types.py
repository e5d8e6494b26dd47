"""Field types the BM25 serving path reads (the port's copy of the text and
keyword types of elasticsearch_tpu/mapper/field_types.py, without document
parsing). Other field families are not ported yet: `build_field_type`
rejects them."""

from __future__ import annotations

from elasticsearch_tpu_torch.common.errors import MapperParsingError


class FieldType:
    """Base field type. `family` drives segment storage layout."""

    family = "none"  # inverted | keyword

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


_TYPES = {"text": TextFieldType, "keyword": KeywordFieldType}


def build_field_type(name: str, params: dict) -> FieldType:
    t = params.get("type")
    if t in _TYPES:
        return _TYPES[t](name, params)
    raise MapperParsingError(
        f"No handler for type [{t}] declared on field [{name}] "
        f"(the port serves text and keyword fields so far)")
