"""Fetch phase: hydrate winning doc ids into full hits.

Re-designs the reference FetchPhase (ref: search/fetch/FetchPhase.java:71 and
the subphase chain under search/fetch/subphase/) — _source loading and
filtering, plus the doc-values `fields` option. Stored fields live host-side
(sources list per segment), so fetch is pure host work, exactly as the
reference keeps fetch off the scoring hot path.

The port's copy of elasticsearch_tpu/search/fetch_phase.py; inner hits
read the child table's scores back from the leaf's device.
"""

from __future__ import annotations

import fnmatch
from typing import Any, List

from elasticsearch_tpu_torch.index.engine import EngineSearcher
from elasticsearch_tpu_torch.search.query_phase import ShardHit


def filter_source(source: dict, source_spec) -> dict | None:
    """Apply the request `_source` option: bool | list | {includes, excludes}."""
    if source_spec is None or source_spec is True:
        return source
    if source_spec is False:
        return None
    if isinstance(source_spec, str):
        source_spec = [source_spec]
    if isinstance(source_spec, list):
        includes, excludes = source_spec, []
    else:
        includes = source_spec.get("includes", source_spec.get("include", []))
        excludes = source_spec.get("excludes", source_spec.get("exclude", []))
        if isinstance(includes, str):
            includes = [includes]
        if isinstance(excludes, str):
            excludes = [excludes]
    flat = _flatten(source)
    out_flat = {}
    for key, value in flat.items():
        if includes and not any(_match(key, p) for p in includes):
            continue
        if any(_match(key, p) for p in excludes):
            continue
        out_flat[key] = value
    return _unflatten(out_flat)


def _match(key: str, pattern: str) -> bool:
    return fnmatch.fnmatchcase(key, pattern) or key.startswith(pattern + ".") or \
        fnmatch.fnmatchcase(key.split(".")[0], pattern)


def _flatten(obj: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in obj.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, f"{key}."))
        else:
            out[key] = v
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def execute_fetch_phase(
    searcher: EngineSearcher,
    hits: List[ShardHit],
    request: dict,
    index_name: str,
    mapper=None,
) -> List[dict]:
    source_spec = request.get("_source")
    fields_spec = request.get("fields")
    highlight_spec = request.get("highlight")
    hl_query = None
    parsed_query = None
    if mapper is not None and request.get("query"):
        from elasticsearch_tpu_torch.search.queries import parse_query

        try:
            parsed_query = parse_query(request["query"])
        except Exception:  # noqa: BLE001 — fetch must not fail on parse
            parsed_query = None
    if highlight_spec and parsed_query is not None:
        hl_query = parsed_query
    inner_specs = _collect_inner_hits(parsed_query) if parsed_query else []
    _ih_cache: dict = {}   # (leaf_idx, spec idx) -> child (scores, mask)
    out = []
    for h in hits:
        seg = searcher.views[h.leaf_idx].segment
        hit: dict[str, Any] = {
            "_index": index_name,
            "_id": seg.doc_ids[h.ord],
            "_score": None if h.sort_values is not None else h.score,
        }
        src = filter_source(seg.sources[h.ord], source_spec)
        if src is not None:
            hit["_source"] = src
        if fields_spec:
            hit["fields"] = _fetch_fields(seg, h.ord, fields_spec)
        if request.get("script_fields"):
            sf = _script_fields(seg, h.ord, request["script_fields"])
            hit.setdefault("fields", {}).update(sf)
        if h.sort_values is not None:
            hit["sort"] = [s.s if hasattr(s, "s") else s for s in h.sort_values]
        if hl_query is not None:
            from elasticsearch_tpu_torch.search.highlight import highlight_hit

            hl = highlight_hit(seg, h.ord, highlight_spec, hl_query, mapper)
            if hl:
                hit["highlight"] = hl
        if inner_specs:
            ih = _render_inner_hits(searcher, h, inner_specs, mapper,
                                    index_name, _ih_cache)
            if ih:
                hit["inner_hits"] = ih
        out.append(hit)
    return out


def _collect_inner_hits(query) -> list:
    """(name, NestedQuery) pairs for every nested query with inner_hits."""
    from elasticsearch_tpu_torch.search import queries as q

    out = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, q.NestedQuery):
            if node.inner_hits is not None:
                out.append((node.inner_hits.get("name", node.path), node))
            walk(node.query)
        elif isinstance(node, q.BoolQuery):
            for c in list(node.must) + list(node.filter) + list(node.should):
                walk(c)
        elif isinstance(node, q.ConstantScoreQuery):
            walk(node.filter)
        elif isinstance(node, q.FunctionScoreQuery):
            walk(node.query)

    walk(query)
    return out


def _render_inner_hits(searcher, h: ShardHit, inner_specs, mapper,
                       index_name: str, cache: dict) -> dict:
    """Matching children of one parent hit (ref: fetch/subphase/InnerHits-
    Phase.java): the child table is scored ONCE per (leaf, spec) for the
    whole fetch — each hit then slices its parent's CSR run."""
    import numpy as np

    from elasticsearch_tpu_torch.search.executor import (
        QueryExecutor, ShardStats, leaves, to_host,
    )

    leaf = leaves(searcher)[h.leaf_idx]
    out = {}
    for si, (name, nq) in enumerate(inner_specs):
        nt = leaf.segment.nested.get(nq.path)
        if nt is None:
            continue
        ckey = (h.leaf_idx, si)
        if ckey not in cache:
            ex = QueryExecutor(mapper, ShardStats(searcher.views))
            ccs, ccm = ex._nested_child_exec(leaf, nq.path, nq.query)
            cache[ckey] = (to_host(ccs), to_host(ccm))
        cs, cm = cache[ckey]
        lo, hi = int(nt.child_start[h.ord]), int(nt.child_start[h.ord + 1])
        idx = [i for i in range(lo, hi) if cm[i]]
        idx.sort(key=lambda i: (-cs[i], i))
        size = int((nq.inner_hits or {}).get("size", 3))
        shown = idx[:size]
        out[name] = {"hits": {
            "total": {"value": len(idx), "relation": "eq"},
            "max_score": float(cs[idx[0]]) if idx else None,
            "hits": [{
                "_index": index_name,
                "_id": leaf.segment.doc_ids[h.ord],
                "_nested": {"field": nq.path, "offset": i - lo},
                "_score": float(cs[i]),
                "_source": nt.child.sources[i],
            } for i in shown],
        }}
    return out


def _script_fields(seg, ord_: int, spec: dict) -> dict:
    """ref: fetch/subphase/ScriptFieldsPhase — sandboxed expressions over
    doc values (numeric/keyword columns) and params."""
    from elasticsearch_tpu_torch.script.expressions import _DocField, compile_script

    class _LazyDoc(dict):
        """doc['field'] materializes only the columns a script touches."""

        def __missing__(self, fname):
            col = seg.numeric.get(fname)
            if col is not None:
                if col.exists[ord_]:
                    lo = int(col.value_start[ord_])
                    hi = int(col.value_start[ord_ + 1])
                    vals = [float(v) for v in col.all_values[lo:hi]]
                else:
                    vals = []
            else:
                kc = seg.keyword.get(fname)
                vals = kc.doc_terms(ord_) \
                    if kc is not None and kc.exists[ord_] else []
            f = _DocField(vals)
            self[fname] = f
            return f

    out = {}
    doc = _LazyDoc()
    for name, body in spec.items():
        script_spec = body.get("script", body) if isinstance(body, dict) else body
        script = compile_script(script_spec)
        params = script_spec.get("params", {}) \
            if isinstance(script_spec, dict) else {}
        value = script.execute({"doc": doc, "params": params})
        out[name] = value if isinstance(value, list) else [value]
    return out


def _fetch_fields(seg, ord_: int, fields_spec) -> dict:
    """The `fields` API: values from doc-value columns."""
    out = {}
    for f in fields_spec:
        fname = f["field"] if isinstance(f, dict) else f
        for target, col in seg.numeric.items():
            if fnmatch.fnmatchcase(target, fname) and col.exists[ord_]:
                lo, hi = int(col.value_start[ord_]), int(col.value_start[ord_ + 1])
                out[target] = [float(v) for v in col.all_values[lo:hi]]
        for target, kc in seg.keyword.items():
            if fnmatch.fnmatchcase(target, fname) and kc.exists[ord_]:
                out[target] = kc.doc_terms(ord_)
    return out
