"""Aggregations: collect → partial → commutative reduce → finalize.

Re-designs the reference aggregation framework (ref: search/aggregations/
AggregatorBase.java, InternalAggregations.java — per-shard Aggregator trees
whose InternalAggregation results support commutative partial reduce at the
coordinator, SURVEY.md P6) around columnar masks:

  * per leaf, each aggregation consumes the query's boolean doc mask plus
    the segment's columnar doc values and emits a *partial* (a plain dict,
    wire-serializable);
  * partials merge with a commutative, associative `reduce` — the same
    function merges leaves within a shard, shards within a node, and nodes
    at the coordinator (tree-reduce over the mesh later);
  * `finalize` renders the response JSON, applying size/ordering that must
    only happen after the final reduce (terms size cut, percentile
    interpolation, pipeline aggs).

Bucket aggregations refine the doc mask per bucket and recurse into
sub-aggregations, mirroring the reference's collect-mode tree.

The port's copy of elasticsearch_tpu/search/aggregations.py (numpy only),
changed in its imports and in `_agg_device()`, which returns the port's
search/agg_device.py. It is the exact reference every device route is held
to. `ctx.leaf` needs `n_docs` and a `segment` with `numeric` and `keyword`
column dicts (index/segment.py), a `_device` dict (the agg layouts' cache),
and, for the aggs that read them, `postings`, `doc_ids` and `sources`.
`filter` and `filters` run their query through `ctx.executor.execute`,
the dense executor the query phase supplies.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError, ParsingError
from elasticsearch_tpu_torch.parallel.routing import murmur3_hash
from elasticsearch_tpu_torch.script.expressions import compile_script

# --------------------------------------------------------------------------
# context plumbing
# --------------------------------------------------------------------------


@dataclass
class AggContext:
    """Per-leaf collection context."""

    leaf: Any                       # LeafContext
    mapper: Any                     # MapperService
    executor: Any                   # QueryExecutor (for filter/filters aggs)
    live: np.ndarray                # [n_docs] bool — live docs irrespective of query
    scores: Optional[np.ndarray] = None   # [n_docs] f32 query scores (top_hits)
    breaker: Any = None             # CircuitBreaker — bucket-array accounting


PIPELINE_TYPES = {
    "derivative", "cumulative_sum", "avg_bucket", "sum_bucket", "min_bucket",
    "max_bucket", "stats_bucket", "bucket_script", "bucket_selector",
    "bucket_sort", "serial_diff", "moving_fn",
}


def parse_aggs(spec: dict) -> Tuple[List["Agg"], List["PipelineAgg"]]:
    aggs: List[Agg] = []
    pipelines: List[PipelineAgg] = []
    for name, body in (spec or {}).items():
        if not isinstance(body, dict):
            raise ParsingError(f"aggregation [{name}] must be an object")
        sub_spec = body.get("aggs") or body.get("aggregations") or {}
        types = [k for k in body if k not in ("aggs", "aggregations", "meta")]
        if len(types) != 1:
            raise ParsingError(f"expected exactly one aggregation type for [{name}]")
        atype = types[0]
        params = body[atype]
        if atype in PIPELINE_TYPES:
            pipelines.append(PipelineAgg(name, atype, params))
            continue
        cls = AGG_TYPES.get(atype)
        if cls is None:
            raise ParsingError(f"unknown aggregation type [{atype}] for [{name}]")
        sub, sub_pipes = parse_aggs(sub_spec)
        aggs.append(cls(name, params, sub, sub_pipes))
    return aggs, pipelines


def collect_leaf(aggs: List["Agg"], ctx: AggContext, mask: np.ndarray) -> Dict[str, Any]:
    return {a.name: a.collect(ctx, mask) for a in aggs}


def reduce_partials(aggs: List["Agg"], partials: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {a.name: a.reduce([p[a.name] for p in partials]) for a in aggs}


def finalize_aggs(aggs: List["Agg"], pipelines: List["PipelineAgg"],
                  reduced: Dict[str, Any]) -> Dict[str, Any]:
    out = {a.name: a.finalize(reduced[a.name]) for a in aggs}
    run_pipelines(out, pipelines)
    return out


def finalize_shard_aggs(request: dict, shard_partials: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Coordinator entry: reduce per-shard partials, finalize once."""
    spec = request.get("aggs") or request.get("aggregations") or {}
    aggs, pipelines = parse_aggs(spec)
    reduced = reduce_partials(aggs, shard_partials)
    return finalize_aggs(aggs, pipelines, reduced)


# --------------------------------------------------------------------------
# value sources
# --------------------------------------------------------------------------


def _value_docs(col) -> np.ndarray:
    """The doc of each value of a numeric column (its value_start CSR
    expanded), made once per column: a terms agg's per-bucket metrics
    gather each bucket's mask through it instead of expanding the CSR
    again for every bucket and metric (np.repeat of a bool mask is the
    slow step)."""
    vd = getattr(col, "_value_docs", None)
    if vd is None:
        counts = col.value_start[1:] - col.value_start[:-1]
        vd = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
        col._value_docs = vd
    return vd


def _numeric_all(ctx: AggContext, fname: str, mask: np.ndarray,
                 missing=None) -> np.ndarray:
    """All values (multi-valued flattened) of masked docs."""
    col = ctx.leaf.segment.numeric.get(fname)
    if col is None:
        if missing is not None:
            return np.full(int(mask.sum()), float(missing))
        return np.empty(0, np.float64)
    sel = mask & col.exists
    take = sel[_value_docs(col)]
    vals = col.all_values[take[: len(col.all_values)]] if len(col.all_values) else np.empty(0)
    if missing is not None:
        n_missing = int((mask & ~col.exists).sum())
        if n_missing:
            vals = np.concatenate([vals, np.full(n_missing, float(missing))])
    return vals


def _numeric_first(ctx: AggContext, fname: str, mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(values, exists) single-valued view (min value per doc) of masked docs."""
    col = ctx.leaf.segment.numeric.get(fname)
    if col is None:
        n = ctx.leaf.n_docs
        return np.zeros(n, np.float64), np.zeros(n, bool)
    return col.values, col.exists & mask


def _keyword_col(ctx: AggContext, fname: str):
    seg = ctx.leaf.segment
    col = seg.keyword.get(fname)
    if col is None and not fname.endswith(".keyword"):
        col = seg.keyword.get(fname + ".keyword")
    return col


def _fmt_date(ms: float) -> str:
    dt = datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


# --------------------------------------------------------------------------
# base classes
# --------------------------------------------------------------------------


class Agg:
    type_name = ""

    def __init__(self, name: str, params: dict, sub: List["Agg"],
                 sub_pipelines: List["PipelineAgg"]):
        self.name = name
        self.params = params if isinstance(params, dict) else {}
        self.sub = sub
        self.sub_pipelines = sub_pipelines

    # --- per-bucket sub-agg helpers ---

    def _collect_sub(self, ctx: AggContext, mask: np.ndarray) -> Dict[str, Any]:
        return collect_leaf(self.sub, ctx, mask)

    def _reduce_sub(self, parts: List[Dict[str, Any]]) -> Dict[str, Any]:
        return reduce_partials(self.sub, parts)

    def _finalize_sub(self, reduced: Dict[str, Any]) -> Dict[str, Any]:
        # relative parent pipelines apply to this agg's own buckets, not
        # inside each bucket — those run in _apply_bucket_pipelines
        pipes = [p for p in self.sub_pipelines if not _is_relative_pipeline(p)]
        return finalize_aggs(self.sub, pipes, reduced)

    def collect(self, ctx: AggContext, mask: np.ndarray) -> Any:
        raise NotImplementedError

    def reduce(self, partials: List[Any]) -> Any:
        raise NotImplementedError

    def finalize(self, partial: Any) -> Dict[str, Any]:
        raise NotImplementedError


PARENT_PIPELINE_TYPES = {"derivative", "cumulative_sum", "serial_diff",
                         "moving_fn", "bucket_script", "bucket_selector",
                         "bucket_sort"}


def _is_relative_pipeline(p: "PipelineAgg") -> bool:
    """True when a parent pipeline declared inside a bucket agg uses paths
    relative to each bucket (the ES-idiomatic placement)."""
    if p.type_name not in PARENT_PIPELINE_TYPES:
        return False
    path = p.params.get("buckets_path")
    if path is None:
        return p.type_name == "bucket_sort"
    if isinstance(path, dict):
        return all(">" not in v for v in path.values())
    return ">" not in path


class BucketAgg(Agg):
    """Buckets keyed by a hashable key; sub-aggs recurse per bucket.

    Partial: {key: {"doc_count": int, "sub": {...}, **extra}}
    """

    def _apply_bucket_pipelines(self, buckets: List[dict]) -> None:
        """Run relative-path parent pipelines over this agg's own buckets
        (ref: parent pipeline aggs are declared inside the multi-bucket agg
        and reference sibling metrics by relative path)."""
        for p in self.sub_pipelines:
            if not _is_relative_pipeline(p):
                continue
            path = p.params.get("buckets_path")
            t = p.type_name
            if t == "bucket_script":
                _t_bucket_script(buckets, None, p)
            elif t == "bucket_selector":
                _t_bucket_selector(buckets, None, p)
            elif t == "bucket_sort":
                _t_bucket_sort(buckets, None, p)
            elif t == "derivative":
                _t_derivative(buckets, path, p)
            elif t == "cumulative_sum":
                _t_cumsum(buckets, path, p)
            elif t == "serial_diff":
                _t_serial_diff(buckets, path, p)
            elif t == "moving_fn":
                _t_moving_fn(buckets, path, p)

    def _bucket(self, ctx, mask, **extra) -> dict:
        return {"doc_count": int(mask.sum()), "sub": self._collect_sub(ctx, mask), **extra}

    def _merge_buckets(self, partials: List[dict]) -> dict:
        merged: Dict[Any, dict] = {}
        for p in partials:
            for key, b in p.items():
                m = merged.get(key)
                if m is None:
                    merged[key] = {"doc_count": b["doc_count"], "_subs": [b["sub"]],
                                   **{k: v for k, v in b.items() if k not in ("doc_count", "sub")}}
                else:
                    m["doc_count"] += b["doc_count"]
                    m["_subs"].append(b["sub"])
        for b in merged.values():
            b["sub"] = self._reduce_sub(b.pop("_subs"))
        return merged


# --------------------------------------------------------------------------
# metric aggregations
# --------------------------------------------------------------------------


class MinAgg(Agg):
    type_name = "min"

    def collect(self, ctx, mask):
        vals = _numeric_all(ctx, self.params["field"], mask, self.params.get("missing"))
        return {"min": float(vals.min()) if len(vals) else None}

    def reduce(self, partials):
        vals = [p["min"] for p in partials if p["min"] is not None]
        return {"min": min(vals) if vals else None}

    def finalize(self, partial):
        return {"value": partial["min"]}


class MaxAgg(Agg):
    type_name = "max"

    def collect(self, ctx, mask):
        vals = _numeric_all(ctx, self.params["field"], mask, self.params.get("missing"))
        return {"max": float(vals.max()) if len(vals) else None}

    def reduce(self, partials):
        vals = [p["max"] for p in partials if p["max"] is not None]
        return {"max": max(vals) if vals else None}

    def finalize(self, partial):
        return {"value": partial["max"]}


class SumAgg(Agg):
    type_name = "sum"

    def collect(self, ctx, mask):
        vals = _numeric_all(ctx, self.params["field"], mask, self.params.get("missing"))
        return {"sum": float(vals.sum())}

    def reduce(self, partials):
        return {"sum": float(sum(p["sum"] for p in partials))}

    def finalize(self, partial):
        return {"value": partial["sum"]}


class ValueCountAgg(Agg):
    type_name = "value_count"

    def collect(self, ctx, mask):
        fname = self.params["field"]
        kc = _keyword_col(ctx, fname)
        if kc is not None and ctx.leaf.segment.numeric.get(fname) is None:
            counts = (kc.ord_start[1:] - kc.ord_start[:-1])[mask & kc.exists]
            return {"count": int(counts.sum())}
        vals = _numeric_all(ctx, fname, mask, self.params.get("missing"))
        return {"count": int(len(vals))}

    def reduce(self, partials):
        return {"count": sum(p["count"] for p in partials)}

    def finalize(self, partial):
        return {"value": partial["count"]}


class AvgAgg(Agg):
    type_name = "avg"

    def collect(self, ctx, mask):
        vals = _numeric_all(ctx, self.params["field"], mask, self.params.get("missing"))
        return {"sum": float(vals.sum()), "count": int(len(vals))}

    def reduce(self, partials):
        return {"sum": float(sum(p["sum"] for p in partials)),
                "count": sum(p["count"] for p in partials)}

    def finalize(self, partial):
        c = partial["count"]
        return {"value": (partial["sum"] / c) if c else None}


class StatsAgg(Agg):
    type_name = "stats"

    def collect(self, ctx, mask):
        vals = _numeric_all(ctx, self.params["field"], mask, self.params.get("missing"))
        if not len(vals):
            return {"count": 0, "sum": 0.0, "min": None, "max": None, "sum2": 0.0}
        return {"count": int(len(vals)), "sum": float(vals.sum()),
                "min": float(vals.min()), "max": float(vals.max()),
                "sum2": float((vals.astype(np.float64) ** 2).sum())}

    def reduce(self, partials):
        mins = [p["min"] for p in partials if p["min"] is not None]
        maxs = [p["max"] for p in partials if p["max"] is not None]
        return {"count": sum(p["count"] for p in partials),
                "sum": float(sum(p["sum"] for p in partials)),
                "min": min(mins) if mins else None,
                "max": max(maxs) if maxs else None,
                "sum2": float(sum(p["sum2"] for p in partials))}

    def finalize(self, partial):
        c = partial["count"]
        return {"count": c, "min": partial["min"], "max": partial["max"],
                "avg": (partial["sum"] / c) if c else None, "sum": partial["sum"]}


class ExtendedStatsAgg(StatsAgg):
    type_name = "extended_stats"

    def finalize(self, partial):
        out = StatsAgg.finalize(self, partial)
        c = partial["count"]
        out["sum_of_squares"] = partial["sum2"] if c else None
        if c:
            mean = partial["sum"] / c
            var = max(partial["sum2"] / c - mean * mean, 0.0)
            sigma = float(self.params.get("sigma", 2.0))
            out["variance"] = var
            out["variance_population"] = var
            out["variance_sampling"] = (partial["sum2"] - c * mean * mean) / (c - 1) if c > 1 else None
            out["std_deviation"] = math.sqrt(var)
            out["std_deviation_population"] = math.sqrt(var)
            out["std_deviation_bounds"] = {
                "upper": mean + sigma * math.sqrt(var),
                "lower": mean - sigma * math.sqrt(var),
            }
        else:
            out.update({"sum_of_squares": None, "variance": None, "std_deviation": None,
                        "std_deviation_bounds": {"upper": None, "lower": None}})
        return out


class WeightedAvgAgg(Agg):
    type_name = "weighted_avg"

    def collect(self, ctx, mask):
        vf = self.params["value"]["field"]
        wf = self.params["weight"]["field"]
        vals, vex = _numeric_first(ctx, vf, mask)
        wts, wex = _numeric_first(ctx, wf, mask)
        sel = vex & wex
        return {"vw": float((vals[sel] * wts[sel]).sum()), "w": float(wts[sel].sum())}

    def reduce(self, partials):
        return {"vw": sum(p["vw"] for p in partials), "w": sum(p["w"] for p in partials)}

    def finalize(self, partial):
        return {"value": (partial["vw"] / partial["w"]) if partial["w"] else None}


# ---- cardinality: HyperLogLog++ (dense registers; ref:
#      metrics/AbstractHyperLogLogPlusPlus.java) ----

_HLL_P = 12
_HLL_M = 1 << _HLL_P
_HLL_ALPHA = 0.7213 / (1 + 1.079 / _HLL_M)


def _hll_hash(values) -> np.ndarray:
    out = np.empty(len(values), np.uint64)
    for i, v in enumerate(values):
        if isinstance(v, float) and v.is_integer():
            v = int(v)
        h1 = murmur3_hash(str(v))
        h2 = murmur3_hash("\x00" + str(v))
        out[i] = (np.uint64(h1) << np.uint64(32)) | np.uint64(h2)
    return out


class CardinalityAgg(Agg):
    type_name = "cardinality"

    def collect(self, ctx, mask):
        fname = self.params["field"]
        kc = _keyword_col(ctx, fname)
        if kc is not None and ctx.leaf.segment.numeric.get(fname) is None:
            sel = mask & kc.exists
            counts = kc.ord_start[1:] - kc.ord_start[:-1]
            take = np.repeat(sel, counts)
            ords = np.unique(kc.all_ords[take[: len(kc.all_ords)]])
            values = [kc.terms[o] for o in ords]
        else:
            values = np.unique(_numeric_all(ctx, fname, mask)).tolist()
        regs = np.zeros(_HLL_M, np.uint8)
        if values:
            h = _hll_hash(values)
            idx = (h >> np.uint64(64 - _HLL_P)).astype(np.int64)
            rest = h << np.uint64(_HLL_P)
            # rank = leading zeros of remaining bits + 1
            lz = np.zeros(len(h), np.uint8)
            for b in range(64 - _HLL_P):
                still = rest < (np.uint64(1) << np.uint64(63))
                lz = np.where(still & (lz == b), b + 1, lz)
                rest = rest << np.uint64(1)
            rank = lz + 1
            np.maximum.at(regs, idx, rank.astype(np.uint8))
        return {"regs": regs.tobytes()}

    def reduce(self, partials):
        regs = np.zeros(_HLL_M, np.uint8)
        for p in partials:
            regs = np.maximum(regs, np.frombuffer(p["regs"], np.uint8))
        return {"regs": regs.tobytes()}

    def finalize(self, partial):
        regs = np.frombuffer(partial["regs"], np.uint8).astype(np.float64)
        est = _HLL_ALPHA * _HLL_M * _HLL_M / np.sum(2.0 ** -regs)
        zeros = int((regs == 0).sum())
        if est <= 2.5 * _HLL_M and zeros:
            est = _HLL_M * math.log(_HLL_M / zeros)   # linear counting
        return {"value": int(round(est))}


# ---- percentiles: mergeable t-digest (ref: metrics TDigest) ----


def _tdigest_compress(means: np.ndarray, weights: np.ndarray, max_centroids: int = 100):
    order = np.argsort(means)
    means, weights = means[order], weights[order]
    while len(means) > max_centroids:
        # merge the adjacent pair with the smallest combined weight
        combined = weights[:-1] + weights[1:]
        i = int(np.argmin(combined))
        new_mean = (means[i] * weights[i] + means[i + 1] * weights[i + 1]) / combined[i]
        means = np.concatenate([means[:i], [new_mean], means[i + 2:]])
        weights = np.concatenate([weights[:i], [combined[i]], weights[i + 2:]])
    return means, weights


class PercentilesAgg(Agg):
    type_name = "percentiles"

    DEFAULT_PERCENTS = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)

    def collect(self, ctx, mask):
        vals = _numeric_all(ctx, self.params["field"], mask, self.params.get("missing"))
        if not len(vals):
            return {"means": b"", "weights": b""}
        uniq, counts = np.unique(vals, return_counts=True)
        means, weights = _tdigest_compress(uniq.astype(np.float64), counts.astype(np.float64))
        return {"means": means.tobytes(), "weights": weights.tobytes()}

    def reduce(self, partials):
        means = np.concatenate([np.frombuffer(p["means"]) for p in partials]) \
            if partials else np.empty(0)
        weights = np.concatenate([np.frombuffer(p["weights"]) for p in partials]) \
            if partials else np.empty(0)
        if len(means):
            means, weights = _tdigest_compress(means, weights)
        return {"means": means.tobytes(), "weights": weights.tobytes()}

    def _quantile(self, means, weights, q):
        if not len(means):
            return None
        if len(means) == 1:
            return float(means[0])
        total = weights.sum()
        target = q / 100.0 * total
        cum = np.cumsum(weights) - weights / 2.0
        if target <= cum[0]:
            return float(means[0])
        if target >= cum[-1]:
            return float(means[-1])
        i = int(np.searchsorted(cum, target)) - 1
        frac = (target - cum[i]) / (cum[i + 1] - cum[i])
        return float(means[i] + frac * (means[i + 1] - means[i]))

    def finalize(self, partial):
        means = np.frombuffer(partial["means"])
        weights = np.frombuffer(partial["weights"])
        percents = self.params.get("percents", list(self.DEFAULT_PERCENTS))
        if self.params.get("keyed", True):
            return {"values": {f"{p:.1f}": self._quantile(means, weights, p) for p in percents}}
        return {"values": [{"key": p, "value": self._quantile(means, weights, p)}
                           for p in percents]}


class PercentileRanksAgg(PercentilesAgg):
    type_name = "percentile_ranks"

    def _rank(self, means, weights, v):
        if not len(means):
            return None
        total = weights.sum()
        below = weights[means < v].sum() + weights[means == v].sum() / 2.0
        return float(100.0 * below / total)

    def finalize(self, partial):
        means = np.frombuffer(partial["means"])
        weights = np.frombuffer(partial["weights"])
        values = self.params.get("values", [])
        if self.params.get("keyed", True):
            return {"values": {f"{float(v):.1f}": self._rank(means, weights, float(v))
                               for v in values}}
        return {"values": [{"key": float(v), "value": self._rank(means, weights, float(v))}
                           for v in values]}


class MedianAbsoluteDeviationAgg(Agg):
    type_name = "median_absolute_deviation"

    def collect(self, ctx, mask):
        # exact per-leaf sample (compressed); MAD needs the global median so
        # deviations are computed at finalize from the merged digest
        vals = _numeric_all(ctx, self.params["field"], mask, self.params.get("missing"))
        uniq, counts = np.unique(vals, return_counts=True)
        means, weights = _tdigest_compress(uniq.astype(np.float64),
                                           counts.astype(np.float64), 500)
        return {"means": means.tobytes(), "weights": weights.tobytes()}

    reduce = PercentilesAgg.reduce

    def finalize(self, partial):
        means = np.frombuffer(partial["means"])
        weights = np.frombuffer(partial["weights"])
        if not len(means):
            return {"value": None}
        helper = PercentilesAgg(self.name, {"field": ""}, [], [])
        median = helper._quantile(means, weights, 50.0)
        dev = np.abs(means - median)
        dm, dw = _tdigest_compress(dev, weights.copy())
        return {"value": helper._quantile(dm, dw, 50.0)}


class TopHitsAgg(Agg):
    type_name = "top_hits"

    def _sort_spec(self):
        sort = self.params.get("sort")
        if not sort:
            return None
        if isinstance(sort, (str, dict)):
            sort = [sort]
        out = []
        for s in sort:
            if isinstance(s, str):
                out.append((s, "asc" if s != "_score" else "desc"))
            else:
                (f, spec), = s.items()
                out.append((f, spec.get("order", "asc") if isinstance(spec, dict) else spec))
        return out

    def collect(self, ctx, mask):
        size = int(self.params.get("size", 3))
        seg = ctx.leaf.segment
        sel = np.nonzero(mask)[0]
        scores = ctx.scores if ctx.scores is not None else np.zeros(ctx.leaf.n_docs)
        sort = self._sort_spec()
        if sort:
            fname, order = sort[0]
            if fname == "_score":
                keys = scores[sel]
                desc = order == "desc"
            else:
                col = seg.numeric.get(fname)
                keys = col.values[sel] if col is not None else np.zeros(len(sel))
                desc = order == "desc"
            order_idx = np.argsort(-keys if desc else keys, kind="stable")
        else:
            order_idx = np.argsort(-scores[sel], kind="stable")
        hits = []
        for o in sel[order_idx[:size]]:
            h = {"_id": seg.doc_ids[o], "_score": float(scores[o]),
                 "_source": seg.sources[o]}
            if sort:
                h["sort"] = [float(scores[o]) if sort[0][0] == "_score"
                             else (float(seg.numeric[sort[0][0]].values[o])
                                   if sort[0][0] in seg.numeric else None)]
            hits.append(h)
        return {"hits": hits, "total": int(mask.sum()),
                "sorted_by": sort[0] if sort else ("_score", "desc")}

    def reduce(self, partials):
        hits = [h for p in partials for h in p["hits"]]
        sorted_by = partials[0]["sorted_by"] if partials else ("_score", "desc")
        fname, order = sorted_by
        key = (lambda h: h["sort"][0] if h.get("sort") and h["sort"][0] is not None
               else 0) if fname != "_score" else (lambda h: h["_score"])
        hits.sort(key=key, reverse=(order == "desc"))
        return {"hits": hits, "total": sum(p["total"] for p in partials),
                "sorted_by": sorted_by}

    def finalize(self, partial):
        size = int(self.params.get("size", 3))
        hits = partial["hits"][:size]
        max_score = max((h["_score"] for h in hits), default=None)
        return {"hits": {"total": {"value": partial["total"], "relation": "eq"},
                         "max_score": max_score,
                         "hits": hits}}


# --------------------------------------------------------------------------
# bucket aggregations
# --------------------------------------------------------------------------


AGG_DEVICE_MIN_DOCS = 65536   # below this the dispatch overhead dominates


def _agg_device():
    """The device analytics tier (search/agg_device.py): batched fused
    segment-reduce aggregation on the K8 kernel. Lazy so the device engine
    loads only once a leaf is large enough to route."""
    from elasticsearch_tpu_torch.search import agg_device
    return agg_device


class TermsAgg(BucketAgg):
    type_name = "terms"

    def collect(self, ctx, mask):
        fname = self.params["field"]
        kc = _keyword_col(ctx, fname)
        out: Dict[Any, dict] = {}
        if kc is not None and ctx.leaf.n_docs >= AGG_DEVICE_MIN_DOCS:
            dev = _agg_device().collect_terms(self, ctx, kc, mask)
            if dev is not None:
                return dev
        if kc is not None:
            sel = mask & kc.exists
            counts = kc.ord_start[1:] - kc.ord_start[:-1]
            take = np.repeat(sel, counts)
            # one O(V log V) pass: (term-ord, doc) pairs of selected docs,
            # grouped by sorting on term-ord
            doc_of_value = np.repeat(np.arange(ctx.leaf.n_docs), counts)
            ords = kc.all_ords[take[: len(kc.all_ords)]]
            docs = doc_of_value[take[: len(doc_of_value)]]
            if len(ords):
                order = np.argsort(ords, kind="stable")
                ords_s, docs_s = ords[order], docs[order]
                run_starts = np.concatenate(
                    [[0], np.nonzero(ords_s[1:] != ords_s[:-1])[0] + 1, [len(ords_s)]])
                for i in range(len(run_starts) - 1):
                    lo, hi = run_starts[i], run_starts[i + 1]
                    doc_mask = np.zeros(ctx.leaf.n_docs, bool)
                    doc_mask[docs_s[lo:hi]] = True
                    out[kc.terms[ords_s[lo]]] = self._bucket(ctx, doc_mask)
        else:
            col = ctx.leaf.segment.numeric.get(fname)
            if col is not None:
                sel = mask & col.exists
                vals = col.values[sel]
                for v in np.unique(vals):
                    doc_mask = sel & (col.values == v)
                    key = int(v) if float(v).is_integer() else float(v)
                    out[key] = self._bucket(ctx, doc_mask)
        return out

    def reduce(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, partial):
        size = int(self.params.get("size", 10))
        min_count = int(self.params.get("min_doc_count", 1))
        order = self.params.get("order", {"_count": "desc"})
        if isinstance(order, list):
            order = order[0]
        (okey, odir), = order.items()
        items = [(k, b) for k, b in partial.items() if b["doc_count"] >= min_count]
        fin_cache: Dict[Any, dict] = {}

        def get_fin(k, b):
            if k not in fin_cache:
                fin_cache[k] = self._finalize_sub(b["sub"])
            return fin_cache[k]

        def key_fn(kv):
            k, b = kv
            if okey == "_count":
                return (b["doc_count"], k if isinstance(k, str) else float(k))
            if okey == "_key" or okey == "_term":
                return k
            path = okey.split(".")
            v = get_fin(k, b).get(path[0], {})
            return v.get(path[1] if len(path) > 1 else "value", 0) or 0

        items.sort(key=key_fn, reverse=(odir == "desc"))
        total_count = sum(b["doc_count"] for _, b in partial.items())
        shown = items[:size]
        buckets = []
        for k, b in shown:
            bucket = {"key": k, "doc_count": b["doc_count"]}
            bucket.update(get_fin(k, b))
            buckets.append(bucket)
        self._apply_bucket_pipelines(buckets)
        return {"doc_count_error_upper_bound": 0,
                "sum_other_doc_count": total_count - sum(b["doc_count"] for _, b in shown),
                "buckets": buckets}


MAX_BUCKETS = 65536   # ref: search.max_buckets default


class HistogramAgg(BucketAgg):
    type_name = "histogram"

    def _interval(self):
        interval = float(self.params["interval"])
        if interval <= 0:
            raise IllegalArgumentError("[interval] must be a positive decimal number")
        return interval

    def _key_of(self, vals: np.ndarray) -> np.ndarray:
        interval = self._interval()
        offset = float(self.params.get("offset", 0.0))
        return np.floor((vals - offset) / interval) * interval + offset

    def collect(self, ctx, mask):
        fname = self.params["field"]
        col = ctx.leaf.segment.numeric.get(fname)
        if col is not None and ctx.leaf.n_docs >= AGG_DEVICE_MIN_DOCS:
            dev = _agg_device().collect_histogram(self, ctx, col, mask)
            if dev is not None:
                return dev
        vals, exists = _numeric_first(ctx, fname, mask)
        sel = exists
        # keys round to 10 decimals everywhere (collect, reduce, gap fill) so
        # float interval arithmetic can't split or orphan a bucket
        keys = np.round(self._key_of(vals[sel]), 10)
        out: Dict[float, dict] = {}
        if not self.sub:
            # no sub-aggs: pure counting, one vectorized unique pass — no
            # per-bucket [n_docs] masks (the histogram analog of the terms
            # device kernel; counting stays host because keys depend on the
            # query's interval, so there is nothing segment-static to cache)
            uniq, cnt = np.unique(keys, return_counts=True)
            return {float(k): {"doc_count": int(c), "sub": {}}
                    for k, c in zip(uniq, cnt)}
        sel_idx = np.nonzero(sel)[0]
        for key in np.unique(keys):
            doc_mask = np.zeros(ctx.leaf.n_docs, bool)
            doc_mask[sel_idx[keys == key]] = True
            out[float(key)] = self._bucket(ctx, doc_mask)
        return out

    def reduce(self, partials):
        return self._merge_buckets(partials)

    def _render_key(self, key: float):
        return key

    def finalize(self, partial):
        min_count = int(self.params.get("min_doc_count", 0))
        keys = sorted(partial)
        buckets = []
        if keys and min_count == 0:
            # fill empty buckets between min and max (ref: histogram
            # empty-bucket filling), capped like search.max_buckets
            interval = self._interval()
            if (keys[-1] - keys[0]) / interval > MAX_BUCKETS:
                raise IllegalArgumentError(
                    f"trying to create too many buckets (> {MAX_BUCKETS})")
            full = []
            k = keys[0]
            while k <= keys[-1] + 1e-9:
                full.append(round(k, 10))
                k += interval
            keys = full
        ext = self.params.get("extended_bounds")
        if ext is not None and min_count == 0:
            interval = self._interval()
            lo = self._key_of(np.asarray([float(ext["min"])]))[0]
            hi = self._key_of(np.asarray([float(ext["max"])]))[0]
            if (hi - lo) / interval > MAX_BUCKETS:
                raise IllegalArgumentError(
                    f"trying to create too many buckets (> {MAX_BUCKETS})")
            existing = set(keys)
            k = lo
            while k <= hi + 1e-9:
                if round(k, 10) not in existing:
                    keys.append(round(k, 10))
                k += interval
            keys.sort()
        for k in keys:
            b = partial.get(k)
            count = b["doc_count"] if b else 0
            if count < min_count:
                continue
            bucket = {"key": self._render_key(k), "doc_count": count}
            bucket.update(self._finalize_sub(b["sub"]) if b
                          else self._finalize_sub(self._reduce_sub([])))
            buckets.append(bucket)
        self._apply_bucket_pipelines(buckets)
        return {"buckets": buckets}


_CALENDAR_MS = {
    "second": 1000, "1s": 1000, "minute": 60_000, "1m": 60_000,
    "hour": 3_600_000, "1h": 3_600_000, "day": 86_400_000, "1d": 86_400_000,
    "week": 7 * 86_400_000, "1w": 7 * 86_400_000,
}
_UNIT_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000}


def parse_interval_ms(spec: str) -> float:
    if spec in _CALENDAR_MS:
        return float(_CALENDAR_MS[spec])
    for unit in sorted(_UNIT_MS, key=len, reverse=True):
        if spec.endswith(unit):
            try:
                return float(spec[: -len(unit)]) * _UNIT_MS[unit]
            except ValueError:
                break
    raise IllegalArgumentError(f"unable to parse interval [{spec}]")


class DateHistogramAgg(HistogramAgg):
    type_name = "date_histogram"

    MONTHLY = {"month", "1M", "quarter", "1q", "year", "1y"}

    def _calendar_unit(self) -> Optional[str]:
        spec = self.params.get("calendar_interval") or self.params.get("interval")
        if spec in ("month", "1M"):
            return "month"
        if spec in ("quarter", "1q"):
            return "quarter"
        if spec in ("year", "1y"):
            return "year"
        return None

    def _interval(self):
        spec = (self.params.get("calendar_interval")
                or self.params.get("fixed_interval")
                or self.params.get("interval"))
        return parse_interval_ms(spec)

    def _key_of(self, vals: np.ndarray) -> np.ndarray:
        unit = self._calendar_unit()
        if unit is None:
            return super()._key_of(vals)
        out = np.empty(len(vals), np.float64)
        for i, ms in enumerate(vals):
            dt = datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)
            if unit == "month":
                dt = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
            elif unit == "quarter":
                dt = dt.replace(month=(dt.month - 1) // 3 * 3 + 1, day=1, hour=0,
                                minute=0, second=0, microsecond=0)
            else:
                dt = dt.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
            out[i] = dt.timestamp() * 1000.0
        return out

    def finalize(self, partial):
        if self._calendar_unit() is not None:
            # variable-width buckets: no arithmetic gap filling
            keys = sorted(partial)
            buckets = []
            for k in keys:
                b = partial[k]
                bucket = {"key_as_string": _fmt_date(k), "key": int(k),
                          "doc_count": b["doc_count"]}
                bucket.update(self._finalize_sub(b["sub"]))
                buckets.append(bucket)
            self._apply_bucket_pipelines(buckets)
            return {"buckets": buckets}
        out = super().finalize(partial)
        for b in out["buckets"]:
            b["key_as_string"] = _fmt_date(b["key"])
            b["key"] = int(b["key"])
        return out


class RangeAgg(BucketAgg):
    type_name = "range"

    def _ranges(self):
        return self.params.get("ranges", [])

    def _convert(self, v):
        return float(v)

    def collect(self, ctx, mask):
        fname = self.params["field"]
        col = ctx.leaf.segment.numeric.get(fname)
        out: Dict[str, dict] = {}
        for r in self._ranges():
            lo = self._convert(r["from"]) if "from" in r and r["from"] is not None else -np.inf
            hi = self._convert(r["to"]) if "to" in r and r["to"] is not None else np.inf
            key = r.get("key") or self._default_key(r)
            if col is None:
                doc_mask = np.zeros(ctx.leaf.n_docs, bool)
            else:
                doc_mask = col.range_mask(lo, hi, True, False) & mask
            out[key] = self._bucket(ctx, doc_mask,
                                    **{"from": None if lo == -np.inf else lo,
                                       "to": None if hi == np.inf else hi})
        return out

    def _default_key(self, r) -> str:
        lo = r.get("from")
        hi = r.get("to")
        return f"{'*' if lo is None else float(lo)}-{'*' if hi is None else float(hi)}"

    def reduce(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, partial):
        keyed = self.params.get("keyed", False)
        order = [r.get("key") or self._default_key(r) for r in self._ranges()]
        buckets = []
        for key in order:
            b = partial.get(key)
            if b is None:
                continue
            bucket = {"key": key, "doc_count": b["doc_count"]}
            if b.get("from") is not None:
                bucket["from"] = b["from"]
            if b.get("to") is not None:
                bucket["to"] = b["to"]
            bucket.update(self._finalize_sub(b["sub"]))
            buckets.append(bucket)
        self._apply_bucket_pipelines(buckets)
        if keyed:
            return {"buckets": {b.pop("key"): b for b in buckets}}
        return {"buckets": buckets}


class DateRangeAgg(RangeAgg):
    type_name = "date_range"

    def _convert(self, v):
        from elasticsearch_tpu_torch.mapper.field_types import parse_date_millis
        if isinstance(v, str):
            return float(parse_date_millis(v))
        return float(v)


class FilterAgg(BucketAgg):
    type_name = "filter"

    def collect(self, ctx, mask):
        from elasticsearch_tpu_torch.search.queries import parse_query
        query = parse_query(self.params)
        _, fmask = ctx.executor.execute(query, ctx.leaf)
        doc_mask = np.asarray(fmask) & mask
        return {"_": self._bucket(ctx, doc_mask)}

    def reduce(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, partial):
        b = partial.get("_") or {"doc_count": 0, "sub": self._reduce_sub([])}
        out = {"doc_count": b["doc_count"]}
        out.update(self._finalize_sub(b["sub"]))
        return out


class FiltersAgg(BucketAgg):
    type_name = "filters"

    def collect(self, ctx, mask):
        from elasticsearch_tpu_torch.search.queries import parse_query
        filters = self.params.get("filters", {})
        out = {}
        if isinstance(filters, dict):
            items = filters.items()
        else:
            items = [(str(i), f) for i, f in enumerate(filters)]
        matched_any = np.zeros(ctx.leaf.n_docs, bool)
        for key, fspec in items:
            query = parse_query(fspec)
            _, fmask = ctx.executor.execute(query, ctx.leaf)
            doc_mask = np.asarray(fmask) & mask
            matched_any |= doc_mask
            out[key] = self._bucket(ctx, doc_mask)
        if self.params.get("other_bucket") or self.params.get("other_bucket_key"):
            other_key = self.params.get("other_bucket_key", "_other_")
            out[other_key] = self._bucket(ctx, mask & ~matched_any)
        return out

    def reduce(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, partial):
        filters = self.params.get("filters", {})
        keyed = isinstance(filters, dict)
        buckets = {}
        for key, b in sorted(partial.items()):
            bucket = {"doc_count": b["doc_count"]}
            bucket.update(self._finalize_sub(b["sub"]))
            buckets[key] = bucket
        if keyed or self.params.get("other_bucket_key"):
            return {"buckets": buckets}
        return {"buckets": [dict(b) for _, b in sorted(buckets.items(), key=lambda kv: int(kv[0]) if kv[0].isdigit() else 1 << 30)]}


class MissingAgg(BucketAgg):
    type_name = "missing"

    def collect(self, ctx, mask):
        fname = self.params["field"]
        seg = ctx.leaf.segment
        exists = np.zeros(ctx.leaf.n_docs, bool)
        for coll in (seg.numeric.get(fname), _keyword_col(ctx, fname)):
            if coll is not None:
                exists |= coll.exists
        fp = seg.postings.get(fname)
        if fp is not None:
            exists |= fp.doc_len > 0
        doc_mask = mask & ~exists
        return {"_": self._bucket(ctx, doc_mask)}

    reduce = FilterAgg.reduce
    finalize = FilterAgg.finalize


class GlobalAgg(BucketAgg):
    type_name = "global"

    def collect(self, ctx, mask):
        return {"_": self._bucket(ctx, ctx.live.copy())}

    reduce = FilterAgg.reduce
    finalize = FilterAgg.finalize


class CompositeAgg(BucketAgg):
    """Paginated multi-source buckets (ref: bucket/composite/)."""

    type_name = "composite"

    def _sources(self):
        return [(name, stype, sbody)
                for src in self.params.get("sources", [])
                for name, tdef in src.items()
                for stype, sbody in tdef.items()]

    def collect(self, ctx, mask):
        sources = self._sources()
        seg = ctx.leaf.segment
        sel = np.nonzero(mask)[0]
        buckets: Dict[tuple, int] = {}
        key_parts = []
        for name, stype, sbody in sources:
            fname = sbody["field"]
            kc = _keyword_col(ctx, fname)
            if stype == "terms" and kc is not None:
                vals = [kc.terms[kc.ords[o]] if kc.exists[o] else None for o in sel]
            else:
                col = seg.numeric.get(fname)
                if col is None:
                    vals = [None] * len(sel)
                else:
                    raw = col.values
                    if stype in ("histogram", "date_histogram"):
                        if stype == "histogram":
                            iv = float(sbody["interval"])
                        else:
                            iv = parse_interval_ms(sbody.get("calendar_interval")
                                                   or sbody.get("fixed_interval"))
                        vals = [math.floor(raw[o] / iv) * iv if col.exists[o] else None
                                for o in sel]
                    else:
                        vals = [raw[o] if col.exists[o] else None for o in sel]
            key_parts.append(vals)
        doc_lists: Dict[tuple, List[int]] = {}
        for i in range(len(sel)):
            key = tuple(part[i] for part in key_parts)
            if any(v is None for v in key):
                continue
            doc_lists.setdefault(key, []).append(int(sel[i]))
        out = {}
        for k, doc_list in doc_lists.items():
            doc_mask = np.zeros(ctx.leaf.n_docs, bool)
            doc_mask[doc_list] = True
            out[repr(k)] = {"key": list(k), **self._bucket(ctx, doc_mask)}
        return out

    def reduce(self, partials):
        merged = self._merge_buckets(partials)
        # _merge_buckets keys by repr(key); restore the key payload
        return merged

    def finalize(self, partial):
        size = int(self.params.get("size", 10))
        names = [name for name, _, _ in self._sources()]
        items = sorted(partial.values(), key=lambda b: tuple(
            (v is None, v) for v in b["key"]))
        after = self.params.get("after")
        if after is not None:
            after_key = [after.get(n) for n in names]
            items = [b for b in items if b["key"] > after_key]
        page = items[:size]
        buckets = []
        for b in page:
            bucket = {"key": dict(zip(names, b["key"])), "doc_count": b["doc_count"]}
            bucket.update(self._finalize_sub(b["sub"]))
            buckets.append(bucket)
        out = {"buckets": buckets}
        if page:
            out["after_key"] = dict(zip(names, page[-1]["key"]))
        return out


# --------------------------------------------------------------------------
# pipeline aggregations (coordinator-side, post final reduce;
# ref: search/aggregations/pipeline/)
# --------------------------------------------------------------------------


@dataclass
class PipelineAgg:
    name: str
    type_name: str
    params: dict


def _resolve_path(bucket: dict, path: str):
    if path == "_count":
        return bucket.get("doc_count")
    cur: Any = bucket
    for part in path.replace(">", ".").split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    if isinstance(cur, dict):
        cur = cur.get("value")
    return cur


def run_pipelines(aggs_out: Dict[str, Any], pipelines: List[PipelineAgg]) -> None:
    for p in pipelines:
        fn = _PIPELINE_FNS.get(p.type_name)
        if fn is None:
            raise ParsingError(f"unknown pipeline aggregation [{p.type_name}]")
        fn(aggs_out, p)


def _sibling_values(aggs_out, p: PipelineAgg):
    path = p.params["buckets_path"]
    agg_name, _, metric = path.partition(">")
    target = aggs_out.get(agg_name, {})
    vals = []
    for b in target.get("buckets", []):
        v = _resolve_path(b, metric) if metric else b.get("doc_count")
        if v is not None:
            vals.append(v)
    return vals


def _pl_sibling(stat):
    def fn(aggs_out, p: PipelineAgg):
        vals = _sibling_values(aggs_out, p)
        if not vals:
            aggs_out[p.name] = {"value": None}
            return
        if stat == "avg":
            aggs_out[p.name] = {"value": sum(vals) / len(vals)}
        elif stat == "sum":
            aggs_out[p.name] = {"value": sum(vals)}
        elif stat == "min":
            aggs_out[p.name] = {"value": min(vals)}
        elif stat == "max":
            aggs_out[p.name] = {"value": max(vals)}
        elif stat == "stats":
            aggs_out[p.name] = {"count": len(vals), "min": min(vals), "max": max(vals),
                                "avg": sum(vals) / len(vals), "sum": sum(vals)}
    return fn


def _pl_per_bucket(transform):
    """Parent pipelines: operate on the buckets of the target agg in place."""

    def fn(aggs_out, p: PipelineAgg):
        path = p.params["buckets_path"]
        # buckets_path names a metric inside each bucket of the enclosing agg;
        # here pipelines run attached to the same level as the buckets agg, so
        # the first path element names the buckets agg
        agg_name, _, metric = path.partition(">")
        target = aggs_out.get(agg_name)
        if target is None or "buckets" not in target:
            # relative path: applies to every buckets-agg sibling that has it
            for target in aggs_out.values():
                if isinstance(target, dict) and "buckets" in target:
                    transform(target["buckets"], path, p)
            return
        transform(target["buckets"], metric or "_count", p)
    return fn


def _t_derivative(buckets, metric, p):
    prev = None
    for b in buckets:
        v = _resolve_path(b, metric)
        b[p.name] = {"value": (v - prev) if (v is not None and prev is not None) else None}
        prev = v if v is not None else prev


def _t_cumsum(buckets, metric, p):
    acc = 0.0
    for b in buckets:
        v = _resolve_path(b, metric)
        acc += v or 0.0
        b[p.name] = {"value": acc}


def _t_serial_diff(buckets, metric, p):
    lag = int(p.params.get("lag", 1))
    hist: List[Any] = []
    for b in buckets:
        v = _resolve_path(b, metric)
        if len(hist) >= lag and hist[-lag] is not None and v is not None:
            b[p.name] = {"value": v - hist[-lag]}
        hist.append(v)


def _t_moving_fn(buckets, metric, p):
    window = int(p.params.get("window", 5))
    script = p.params.get("script", "MovingFunctions.unweightedAvg(values)")
    vals: List[Any] = []
    for b in buckets:
        v = _resolve_path(b, metric)
        win = [x for x in vals[-window:] if x is not None]
        if "max" in script:
            out = max(win) if win else None
        elif "min" in script:
            out = min(win) if win else None
        elif "sum" in script:
            out = sum(win) if win else None
        else:
            out = (sum(win) / len(win)) if win else None
        b[p.name] = {"value": out}
        vals.append(v)


def _script_params(p: PipelineAgg) -> dict:
    spec = p.params.get("script")
    return spec.get("params", {}) if isinstance(spec, dict) else {}


def _t_bucket_script(buckets, _metric, p):
    paths = p.params["buckets_path"]
    script = compile_script(p.params["script"])
    params = _script_params(p)
    for b in buckets:
        env = {k: _resolve_path(b, v) for k, v in paths.items()}
        if any(v is None for v in env.values()):
            b[p.name] = {"value": None}
            continue
        env["params"] = params
        b[p.name] = {"value": script.execute(env)}


def _t_bucket_selector(buckets, _metric, p):
    paths = p.params["buckets_path"]
    script = compile_script(p.params["script"])
    params = _script_params(p)
    keep = []
    for b in buckets:
        env = {k: _resolve_path(b, v) for k, v in paths.items()}
        if any(v is None for v in env.values()):
            continue
        env["params"] = params
        if script.execute(env):
            keep.append(b)
    buckets[:] = keep


def _t_bucket_sort(buckets, _metric, p):
    sorts = p.params.get("sort", [])
    frm = int(p.params.get("from", 0))
    size = p.params.get("size")
    for s in reversed(sorts):
        if isinstance(s, str):
            fname, order = s, "asc"
        else:
            (fname, spec), = s.items()
            order = spec.get("order", "asc") if isinstance(spec, dict) else spec
        buckets.sort(key=lambda b: _resolve_path(b, fname) or 0,
                     reverse=(order == "desc"))
    end = None if size is None else frm + int(size)
    buckets[:] = buckets[frm:end]


def _wrap_bucket_pipeline(transform):
    def fn(aggs_out, p: PipelineAgg):
        path = p.params.get("buckets_path")
        if isinstance(path, dict):
            # dict paths like {"r": "cats>rev"}: strip the shared leading agg
            # name and apply to that agg's buckets with relative paths
            prefixes = {v.split(">", 1)[0] for v in path.values() if ">" in v}
            if len(prefixes) == 1:
                agg_name = prefixes.pop()
                target = aggs_out.get(agg_name)
                if target is not None and isinstance(target.get("buckets"), list):
                    stripped = PipelineAgg(p.name, p.type_name, dict(p.params))
                    stripped.params = dict(p.params)
                    stripped.params["buckets_path"] = {
                        k: v.split(">", 1)[1] if ">" in v else v
                        for k, v in path.items()}
                    transform(target["buckets"], None, stripped)
                    return
            for target in aggs_out.values():
                if isinstance(target, dict) and isinstance(target.get("buckets"), list):
                    transform(target["buckets"], None, p)
            return
        if path is None and transform is _t_bucket_sort:
            for target in aggs_out.values():
                if isinstance(target, dict) and isinstance(target.get("buckets"), list):
                    transform(target["buckets"], None, p)
            return
        agg_name, _, metric = (path or "").partition(">")
        target = aggs_out.get(agg_name)
        if target is not None and isinstance(target.get("buckets"), list):
            transform(target["buckets"], metric or "_count", p)
    return fn


_PIPELINE_FNS = {
    "avg_bucket": _pl_sibling("avg"),
    "sum_bucket": _pl_sibling("sum"),
    "min_bucket": _pl_sibling("min"),
    "max_bucket": _pl_sibling("max"),
    "stats_bucket": _pl_sibling("stats"),
    "derivative": _pl_per_bucket(_t_derivative),
    "cumulative_sum": _pl_per_bucket(_t_cumsum),
    "serial_diff": _pl_per_bucket(_t_serial_diff),
    "moving_fn": _pl_per_bucket(_t_moving_fn),
    "bucket_script": _wrap_bucket_pipeline(_t_bucket_script),
    "bucket_selector": _wrap_bucket_pipeline(_t_bucket_selector),
    "bucket_sort": _wrap_bucket_pipeline(_t_bucket_sort),
}


AGG_TYPES = {
    cls.type_name: cls
    for cls in (
        MinAgg, MaxAgg, SumAgg, AvgAgg, ValueCountAgg, StatsAgg, ExtendedStatsAgg,
        WeightedAvgAgg, CardinalityAgg, PercentilesAgg, PercentileRanksAgg,
        MedianAbsoluteDeviationAgg, TopHitsAgg,
        TermsAgg, HistogramAgg, DateHistogramAgg, RangeAgg, DateRangeAgg,
        FilterAgg, FiltersAgg, MissingAgg, GlobalAgg, CompositeAgg,
    )
}
