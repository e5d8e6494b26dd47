"""Ingest processors: per-document transforms applied before indexing.

Re-designs the reference's processor set (ref: ingest/CompoundProcessor.java
chain-with-on_failure semantics and the ~30 processors under
modules/ingest-common/src/main/java/org/elasticsearch/ingest/common/) as
small functions over the ingest document. The ingest document wraps the
source plus metadata (`_index`, `_id`) and exposes dotted-path access,
matching the reference's IngestDocument field paths.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Any, Callable, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuError


class IngestProcessorError(ElasticsearchTpuError):
    status = 400
    error_type = "illegal_argument_exception"


class DropDocument(Exception):
    """Raised by the drop processor: the document is silently discarded."""


class IngestDocument:
    """Source + metadata with dotted-path access (ref: IngestDocument)."""

    def __init__(self, source: dict, index: str = "", doc_id: str = ""):
        self.source = source
        self.meta = {"_index": index, "_id": doc_id}

    def _resolve(self, path: str):
        if path.startswith("_"):
            return self.meta, path
        parts = path.split(".")
        node = self.source
        for p in parts[:-1]:
            if not isinstance(node, dict) or p not in node:
                return None, parts[-1]
            node = node[p]
        return (node, parts[-1]) if isinstance(node, dict) else (None, parts[-1])

    def has(self, path: str) -> bool:
        node, leaf = self._resolve(path)
        return node is not None and leaf in node

    def get(self, path: str, default=None):
        node, leaf = self._resolve(path)
        if node is None or leaf not in node:
            return default
        return node[leaf]

    def set(self, path: str, value) -> None:
        if path.startswith("_"):
            self.meta[path] = value
            return
        parts = path.split(".")
        node = self.source
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            node = nxt
        node[parts[-1]] = value

    def remove(self, path: str) -> bool:
        node, leaf = self._resolve(path)
        if node is not None and leaf in node:
            del node[leaf]
            return True
        return False


Processor = Callable[[IngestDocument], None]


def _tmpl(value: str, doc: IngestDocument) -> str:
    """Tiny mustache subset: {{field}} substitution (ref: ingest uses
    mustache templates for set/rename values)."""
    if not isinstance(value, str) or "{{" not in value:
        return value
    return re.sub(r"\{\{\s*([\w._]+)\s*\}\}",
                  lambda m: str(doc.get(m.group(1), "")), value)


def _req(cfg: dict, key: str, type_: str):
    if key not in cfg:
        raise IngestProcessorError(f"[{key}] required property is missing")
    return cfg[key]


def _missing(cfg, doc, field) -> bool:
    """Shared ignore_missing handling; raises unless configured to skip."""
    if doc.has(field):
        return False
    if cfg.get("ignore_missing", False):
        return True
    raise IngestProcessorError(
        f"field [{field}] not present as part of path [{field}]")


# ---- the processors ----


def p_set(cfg):
    field = _req(cfg, "field", "set")
    value = cfg.get("value")
    copy_from = cfg.get("copy_from")
    override = cfg.get("override", True)

    def run(doc):
        if not override and doc.get(field) is not None:
            return
        doc.set(field, doc.get(copy_from) if copy_from else _tmpl(value, doc))
    return run


def p_remove(cfg):
    fields = _req(cfg, "field", "remove")
    fields = fields if isinstance(fields, list) else [fields]

    def run(doc):
        for f in fields:
            if not doc.remove(f) and not cfg.get("ignore_missing", False):
                raise IngestProcessorError(f"field [{f}] not present")
    return run


def p_rename(cfg):
    field = _req(cfg, "field", "rename")
    target = _req(cfg, "target_field", "rename")

    def run(doc):
        if _missing(cfg, doc, field):
            return
        if doc.has(target):
            raise IngestProcessorError(
                f"field [{target}] already exists")
        doc.set(target, doc.get(field))
        doc.remove(field)
    return run


_CONVERTERS = {
    "integer": lambda v: int(float(v)),
    "long": lambda v: int(float(v)),
    "float": float,
    "double": float,
    "string": str,
    "boolean": lambda v: (v if isinstance(v, bool)
                          else str(v).lower() == "true"),
    "auto": lambda v: _auto_convert(v),
}


def _auto_convert(v):
    if not isinstance(v, str):
        return v
    for fn in (int, float):
        try:
            return fn(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def p_convert(cfg):
    field = _req(cfg, "field", "convert")
    type_ = _req(cfg, "type", "convert")
    if type_ not in _CONVERTERS:
        raise IngestProcessorError(f"type [{type_}] not supported")
    target = cfg.get("target_field", field)

    def run(doc):
        if _missing(cfg, doc, field):
            return
        v = doc.get(field)
        conv = _CONVERTERS[type_]
        try:
            doc.set(target, [conv(x) for x in v] if isinstance(v, list)
                    else conv(v))
        except (TypeError, ValueError):
            raise IngestProcessorError(
                f"unable to convert [{v}] to {type_}")
    return run


def _string_proc(name, fn):
    def build(cfg):
        field = _req(cfg, "field", name)
        target = cfg.get("target_field", field)

        def run(doc):
            if _missing(cfg, doc, field):
                return
            v = doc.get(field)
            if isinstance(v, list):
                doc.set(target, [fn(str(x)) for x in v])
            else:
                doc.set(target, fn(str(v)))
        return run
    return build


def p_split(cfg):
    field = _req(cfg, "field", "split")
    sep = _req(cfg, "separator", "split")
    target = cfg.get("target_field", field)

    def run(doc):
        if _missing(cfg, doc, field):
            return
        doc.set(target, re.split(sep, str(doc.get(field))))
    return run


def p_join(cfg):
    field = _req(cfg, "field", "join")
    sep = _req(cfg, "separator", "join")
    target = cfg.get("target_field", field)

    def run(doc):
        v = doc.get(field)
        if not isinstance(v, list):
            raise IngestProcessorError(f"field [{field}] is not a list")
        doc.set(target, sep.join(str(x) for x in v))
    return run


def p_gsub(cfg):
    field = _req(cfg, "field", "gsub")
    pattern = re.compile(_req(cfg, "pattern", "gsub"))
    replacement = _req(cfg, "replacement", "gsub")
    target = cfg.get("target_field", field)

    def run(doc):
        if _missing(cfg, doc, field):
            return
        doc.set(target, pattern.sub(replacement, str(doc.get(field))))
    return run


def p_append(cfg):
    field = _req(cfg, "field", "append")
    value = _req(cfg, "value", "append")

    def run(doc):
        values = value if isinstance(value, list) else [value]
        values = [_tmpl(v, doc) for v in values]
        cur = doc.get(field)
        if cur is None:
            doc.set(field, list(values))
        elif isinstance(cur, list):
            cur.extend(values)
        else:
            doc.set(field, [cur] + list(values))
    return run


def p_date(cfg):
    from elasticsearch_tpu_torch.mapper.field_types import parse_date_millis

    field = _req(cfg, "field", "date")
    target = cfg.get("target_field", "@timestamp")
    formats = cfg.get("formats", ["ISO8601"])

    def run(doc):
        v = doc.get(field)
        last = None
        for fmt in formats:
            try:
                if fmt in ("ISO8601", "strict_date_optional_time"):
                    ms = parse_date_millis(v)
                elif fmt == "UNIX":
                    ms = int(float(v) * 1000)
                elif fmt == "UNIX_MS":
                    ms = int(float(v))
                else:
                    ms = int(_dt.datetime.strptime(
                        str(v), fmt).replace(
                        tzinfo=_dt.timezone.utc).timestamp() * 1000)
                doc.set(target, _dt.datetime.fromtimestamp(
                    ms / 1000.0, _dt.timezone.utc).isoformat()
                    .replace("+00:00", "Z"))
                return
            except Exception as e:  # noqa: BLE001 — try next format
                last = e
        raise IngestProcessorError(
            f"unable to parse date [{v}]: {last}")
    return run


def p_fail(cfg):
    message = _req(cfg, "message", "fail")

    def run(doc):
        raise IngestProcessorError(_tmpl(message, doc))
    return run


def p_drop(cfg):
    def run(doc):
        raise DropDocument()
    return run


def p_dissect(cfg):
    """Minimal dissect: '%{field} %{other}' literal-delimiter parsing."""
    field = _req(cfg, "field", "dissect")
    pattern = _req(cfg, "pattern", "dissect")
    parts = re.split(r"%\{([\w.@]*)\}", pattern)
    # parts alternates literal, key, literal, key, ... literal

    def run(doc):
        if _missing(cfg, doc, field):
            return
        s = str(doc.get(field))
        pos = 0
        keys: List[tuple] = []
        if not s.startswith(parts[0]):
            raise IngestProcessorError(
                f"dissect pattern [{pattern}] does not match [{s}]")
        pos = len(parts[0])
        for i in range(1, len(parts), 2):
            key = parts[i]
            lit = parts[i + 1] if i + 1 < len(parts) else ""
            if lit:
                end = s.find(lit, pos)
                if end < 0:
                    raise IngestProcessorError(
                        f"dissect pattern [{pattern}] does not match [{s}]")
            else:
                end = len(s)
            if key:
                keys.append((key, s[pos:end]))
            pos = end + len(lit)
        for key, val in keys:
            doc.set(key, val)
    return run


PROCESSORS: Dict[str, Callable[[dict], Processor]] = {
    "set": p_set,
    "remove": p_remove,
    "rename": p_rename,
    "convert": p_convert,
    "lowercase": _string_proc("lowercase", str.lower),
    "uppercase": _string_proc("uppercase", str.upper),
    "trim": _string_proc("trim", str.strip),
    "split": p_split,
    "join": p_join,
    "gsub": p_gsub,
    "append": p_append,
    "date": p_date,
    "fail": p_fail,
    "drop": p_drop,
    "dissect": p_dissect,
}
