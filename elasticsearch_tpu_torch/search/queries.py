"""Query DSL: JSON -> query tree.

Re-designs the reference's 47 QueryBuilder classes (ref: index/query/ —
MatchQueryBuilder, TermQueryBuilder, BoolQueryBuilder, RangeQueryBuilder,
ExistsQueryBuilder, IdsQueryBuilder, PrefixQueryBuilder, WildcardQueryBuilder,
ConstantScoreQueryBuilder, MatchPhraseQueryBuilder; parsed via
SearchExecutionContext.toQuery index/query/SearchExecutionContext.java:451)
as plain dataclasses. Parsing is one table-driven function; execution lives
in search/executor.py (the device side).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

from elasticsearch_tpu_torch.common.errors import ParsingError


class Query:
    pass


@dataclass
class MatchAllQuery(Query):
    boost: float = 1.0


@dataclass
class MatchNoneQuery(Query):
    pass


@dataclass
class TermQuery(Query):
    field: str
    value: Any
    boost: float = 1.0


@dataclass
class TermsQuery(Query):
    field: str
    values: List[Any]
    boost: float = 1.0


@dataclass
class MatchQuery(Query):
    field: str
    text: str
    operator: str = "or"           # or | and
    minimum_should_match: Optional[int] = None
    boost: float = 1.0
    fuzziness: Optional[str] = None  # accepted, not yet scored differently


@dataclass
class MatchPhraseQuery(Query):
    field: str
    text: str
    slop: int = 0
    boost: float = 1.0


@dataclass
class RangeQuery(Query):
    field: str
    gte: Any = None
    gt: Any = None
    lte: Any = None
    lt: Any = None
    boost: float = 1.0


@dataclass
class ExistsQuery(Query):
    field: str
    boost: float = 1.0


@dataclass
class IdsQuery(Query):
    values: List[str]
    boost: float = 1.0


@dataclass
class PrefixQuery(Query):
    field: str
    value: str
    boost: float = 1.0


@dataclass
class WildcardQuery(Query):
    field: str
    value: str
    boost: float = 1.0


@dataclass
class ConstantScoreQuery(Query):
    filter: Query = None
    boost: float = 1.0


@dataclass
class BoolQuery(Query):
    must: List[Query] = field(default_factory=list)
    should: List[Query] = field(default_factory=list)
    filter: List[Query] = field(default_factory=list)
    must_not: List[Query] = field(default_factory=list)
    minimum_should_match: Optional[int] = None
    boost: float = 1.0


@dataclass
class FuzzyQuery(Query):
    field: str
    value: str
    fuzziness: object = "AUTO"      # "AUTO" | 0 | 1 | 2
    prefix_length: int = 0
    max_expansions: int = 50
    boost: float = 1.0

    def max_edits(self) -> int:
        """ref: Fuzziness.AUTO — 0 edits below 3 chars, 1 below 6, else 2."""
        if isinstance(self.fuzziness, str) and self.fuzziness.upper() == "AUTO":
            n = len(self.value)
            return 0 if n < 3 else (1 if n < 6 else 2)
        return int(self.fuzziness)


@dataclass
class RegexpQuery(Query):
    field: str
    value: str
    boost: float = 1.0


@dataclass
class MatchPhrasePrefixQuery(Query):
    field: str
    text: str
    slop: int = 0
    max_expansions: int = 50
    boost: float = 1.0


@dataclass
class GeoDistanceQuery(Query):
    field: str
    lat: float
    lon: float
    distance_m: float
    boost: float = 1.0


@dataclass
class GeoBoundingBoxQuery(Query):
    field: str
    top: float
    left: float
    bottom: float
    right: float
    boost: float = 1.0


def parse_geo_point(value) -> tuple:
    """{lat, lon} | 'lat,lon' | [lon, lat] (GeoJSON order) -> (lat, lon).
    One parser for query AND index time (GeoPointFieldType delegates here)
    so accepted formats cannot drift."""
    try:
        if isinstance(value, dict):
            return float(value["lat"]), float(value["lon"])
        if isinstance(value, str):
            parts = value.split(",")
            if len(parts) == 2:
                return float(parts[0]), float(parts[1])
        elif isinstance(value, (list, tuple)) and len(value) == 2:
            return float(value[1]), float(value[0])
    except (KeyError, TypeError, ValueError):
        pass
    raise ParsingError(f"failed to parse geo point [{value}]")


_DIST_UNITS_M = {"mm": 0.001, "cm": 0.01, "m": 1.0, "km": 1000.0,
                 "mi": 1609.344, "miles": 1609.344, "yd": 0.9144,
                 "ft": 0.3048, "in": 0.0254, "nmi": 1852.0, "nm": 1852.0}


def parse_distance_m(value) -> float:
    """'10km' / '500m' / '1.5mi' / number (meters) -> meters."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip().lower()
    for unit in sorted(_DIST_UNITS_M, key=len, reverse=True):
        if s.endswith(unit):
            return float(s[: -len(unit)]) * _DIST_UNITS_M[unit]
    return float(s)


@dataclass
class NestedQuery(Query):
    """ref: index/query/NestedQueryBuilder.java — score_mode avg (default),
    sum, max, min, none."""

    path: str
    query: Query = None
    score_mode: str = "avg"
    inner_hits: Optional[dict] = None
    boost: float = 1.0


@dataclass
class HasChildQuery(Query):
    """ref: modules/parent-join/HasChildQueryBuilder.java — parents with at
    least min_children matching children; score_mode none (default), sum,
    max, min, avg."""

    type: str
    query: Query = None
    score_mode: str = "none"
    min_children: int = 1
    max_children: int = 2**31 - 1
    boost: float = 1.0


@dataclass
class HasParentQuery(Query):
    """ref: modules/parent-join/HasParentQueryBuilder.java."""

    parent_type: str
    query: Query = None
    score: bool = False
    boost: float = 1.0


@dataclass
class ParentIdQuery(Query):
    """ref: modules/parent-join/ParentIdQueryBuilder.java."""

    type: str
    id: str = ""
    boost: float = 1.0


@dataclass
class PercolateQuery(Query):
    """ref: modules/percolator/PercolateQueryBuilder.java — match stored
    queries in `field` against the given document(s)."""

    field: str
    documents: List[dict] = field(default_factory=list)
    boost: float = 1.0


@dataclass
class KnnQuery(Query):
    """Top-level knn search section (ES 8 _search "knn" or query vector)."""

    field: str
    query_vector: List[float]
    k: int = 10
    num_candidates: int = 100
    filter: Optional[Query] = None
    boost: float = 1.0


@dataclass
class MultiMatchQuery(Query):
    fields: List[str]
    text: str
    type: str = "best_fields"      # best_fields | most_fields
    operator: str = "or"
    boost: float = 1.0


@dataclass
class FunctionScoreQuery(Query):
    """Minimal function_score: supports weight + field_value_factor."""

    query: Query
    field_value_factor: Optional[dict] = None
    weight: float = 1.0
    boost_mode: str = "multiply"
    boost: float = 1.0


def _one_entry(body: dict, name: str) -> tuple:
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingError(f"[{name}] query malformed, expected a single field object")
    return next(iter(body.items()))


def parse_query(body: dict) -> Query:
    """Parse the JSON query DSL (the `query` element of a search request)."""
    if body is None:
        return MatchAllQuery()
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingError("query malformed, expected a single top-level key")
    kind, spec = next(iter(body.items()))

    if kind == "match_all":
        return MatchAllQuery(boost=spec.get("boost", 1.0) if isinstance(spec, dict) else 1.0)
    if kind == "match_none":
        return MatchNoneQuery()

    if kind == "match":
        fname, v = _one_entry(spec, "match")
        if isinstance(v, dict):
            return MatchQuery(fname, str(v["query"]), operator=v.get("operator", "or").lower(),
                              minimum_should_match=_parse_msm(v.get("minimum_should_match")),
                              boost=v.get("boost", 1.0), fuzziness=v.get("fuzziness"))
        return MatchQuery(fname, str(v))

    if kind == "match_phrase":
        fname, v = _one_entry(spec, kind)
        if isinstance(v, dict):
            return MatchPhraseQuery(fname, str(v["query"]), slop=int(v.get("slop", 0)),
                                    boost=v.get("boost", 1.0))
        return MatchPhraseQuery(fname, str(v))

    if kind == "term":
        fname, v = _one_entry(spec, "term")
        if isinstance(v, dict):
            return TermQuery(fname, v["value"], boost=v.get("boost", 1.0))
        return TermQuery(fname, v)

    if kind == "terms":
        boost = spec.get("boost", 1.0) if isinstance(spec, dict) else 1.0
        entries = [(k, v) for k, v in spec.items() if k != "boost"]
        if len(entries) != 1:
            raise ParsingError("[terms] query requires exactly one field")
        fname, values = entries[0]
        if not isinstance(values, list):
            raise ParsingError("[terms] query requires an array of terms")
        return TermsQuery(fname, values, boost=boost)

    if kind == "range":
        fname, v = _one_entry(spec, "range")
        q = RangeQuery(fname, gte=v.get("gte", v.get("from")), gt=v.get("gt"),
                       lte=v.get("lte", v.get("to")), lt=v.get("lt"),
                       boost=v.get("boost", 1.0))
        return q

    if kind == "exists":
        return ExistsQuery(spec["field"], boost=spec.get("boost", 1.0))

    if kind == "ids":
        return IdsQuery([str(x) for x in spec.get("values", [])])

    if kind == "prefix":
        fname, v = _one_entry(spec, "prefix")
        if isinstance(v, dict):
            return PrefixQuery(fname, str(v["value"]), boost=v.get("boost", 1.0))
        return PrefixQuery(fname, str(v))

    if kind == "wildcard":
        fname, v = _one_entry(spec, "wildcard")
        if isinstance(v, dict):
            return WildcardQuery(fname, str(v.get("value", v.get("wildcard"))), boost=v.get("boost", 1.0))
        return WildcardQuery(fname, str(v))

    if kind == "constant_score":
        return ConstantScoreQuery(filter=parse_query(spec["filter"]), boost=spec.get("boost", 1.0))

    if kind == "bool":
        def _clauses(key):
            raw = spec.get(key, [])
            if isinstance(raw, dict):
                raw = [raw]
            return [parse_query(c) for c in raw]

        return BoolQuery(
            must=_clauses("must"),
            should=_clauses("should"),
            filter=_clauses("filter"),
            must_not=_clauses("must_not"),
            minimum_should_match=_parse_msm(spec.get("minimum_should_match")),
            boost=spec.get("boost", 1.0),
        )

    if kind == "multi_match":
        return MultiMatchQuery(fields=list(spec.get("fields", [])), text=str(spec["query"]),
                               type=spec.get("type", "best_fields"),
                               operator=spec.get("operator", "or").lower(),
                               boost=spec.get("boost", 1.0))

    if kind == "function_score":
        inner = parse_query(spec.get("query", {"match_all": {}}))
        fvf = spec.get("field_value_factor")
        weight = float(spec.get("weight", 1.0))
        for fn in spec.get("functions", []):
            if "weight" in fn:
                weight *= float(fn["weight"])
            if "field_value_factor" in fn:
                fvf = fn["field_value_factor"]
        return FunctionScoreQuery(query=inner, field_value_factor=fvf, weight=weight,
                                  boost_mode=spec.get("boost_mode", "multiply"),
                                  boost=spec.get("boost", 1.0))

    if kind == "knn":
        return KnnQuery(field=spec["field"], query_vector=spec["query_vector"],
                        k=int(spec.get("k", spec.get("num_candidates", 10))),
                        num_candidates=int(spec.get("num_candidates", 100)),
                        filter=parse_query(spec["filter"]) if spec.get("filter") else None,
                        boost=spec.get("boost", 1.0))

    if kind == "nested":
        return NestedQuery(path=spec["path"], query=parse_query(spec["query"]),
                           score_mode=spec.get("score_mode", "avg"),
                           inner_hits=spec.get("inner_hits"),
                           boost=spec.get("boost", 1.0))

    if kind == "has_child":
        return HasChildQuery(type=spec["type"],
                             query=parse_query(spec["query"]),
                             score_mode=spec.get("score_mode", "none"),
                             min_children=int(spec.get("min_children", 1)),
                             max_children=int(spec.get("max_children",
                                                       2**31 - 1)),
                             boost=spec.get("boost", 1.0))

    if kind == "has_parent":
        return HasParentQuery(parent_type=spec["parent_type"],
                              query=parse_query(spec["query"]),
                              score=bool(spec.get("score", False)),
                              boost=spec.get("boost", 1.0))

    if kind == "parent_id":
        return ParentIdQuery(type=spec["type"], id=str(spec["id"]),
                             boost=spec.get("boost", 1.0))

    if kind == "percolate":
        docs = spec.get("documents")
        if docs is None:
            doc = spec.get("document")
            if doc is None:
                raise ParsingError(
                    "[percolate] requires [document] or [documents]")
            docs = [doc]
        return PercolateQuery(field=spec["field"], documents=list(docs),
                              boost=spec.get("boost", 1.0))

    if kind == "fuzzy":
        fname, v = _one_entry(spec, "fuzzy")
        if not isinstance(v, dict):
            v = {"value": v}
        return FuzzyQuery(fname, str(v["value"]),
                          fuzziness=v.get("fuzziness", "AUTO"),
                          prefix_length=int(v.get("prefix_length", 0)),
                          max_expansions=int(v.get("max_expansions", 50)),
                          boost=v.get("boost", 1.0))

    if kind == "regexp":
        fname, v = _one_entry(spec, "regexp")
        if not isinstance(v, dict):
            v = {"value": v}
        return RegexpQuery(fname, str(v["value"]), boost=v.get("boost", 1.0))

    if kind == "match_phrase_prefix":
        fname, v = _one_entry(spec, "match_phrase_prefix")
        if isinstance(v, dict):
            return MatchPhrasePrefixQuery(
                fname, str(v["query"]), slop=int(v.get("slop", 0)),
                max_expansions=int(v.get("max_expansions", 50)),
                boost=v.get("boost", 1.0))
        return MatchPhrasePrefixQuery(fname, str(v))

    if kind == "geo_distance":
        fields = {k: v for k, v in spec.items()
                  if k not in ("distance", "boost", "validation_method",
                               "distance_type")}
        if len(fields) != 1:
            raise ParsingError("[geo_distance] requires exactly one field")
        fname, point = next(iter(fields.items()))
        lat, lon = parse_geo_point(point)
        return GeoDistanceQuery(fname, lat=lat, lon=lon,
                                distance_m=parse_distance_m(spec["distance"]),
                                boost=spec.get("boost", 1.0))

    if kind == "geo_bounding_box":
        fields = {k: v for k, v in spec.items()
                  if k not in ("boost", "validation_method", "type")}
        if len(fields) != 1:
            raise ParsingError("[geo_bounding_box] requires exactly one field")
        fname, box = next(iter(fields.items()))
        tl = parse_geo_point(box["top_left"])
        br = parse_geo_point(box["bottom_right"])
        return GeoBoundingBoxQuery(fname, top=tl[0], left=tl[1],
                                   bottom=br[0], right=br[1],
                                   boost=box.get("boost", spec.get("boost", 1.0)))

    raise ParsingError(f"unknown query [{kind}]")


def _parse_msm(raw) -> Optional[int]:
    """minimum_should_match: integer forms only (percent forms resolved later)."""
    if raw is None:
        return None
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise ParsingError(f"unsupported minimum_should_match [{raw}]")
