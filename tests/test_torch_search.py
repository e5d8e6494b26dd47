"""The port's in-process search path against the reference, on the CPU.

Every case of tests/test_search.py runs on twins: each engine the case
builds is a reference `InternalEngine` and a port `InternalEngine`
(`device="cpu"`) fed the same writes and refreshes, and each
`execute_search` call runs on both. The case's own assertions then run on
the port's response, and the two responses must be equal: hits, ids,
order, totals and relation, `max_score`, `_source`, `fields`, sort values,
highlights and aggregations (floats bit for bit). Scores are bitwise,
except where a body scores through `function_score` or `knn` (ROADMAP W2):
the knn product sums its bf16 terms in another order, and torch's log1p
may differ from XLA's by an ulp, so those scores (and a hybrid's sums)
must lie within SCORE_ULPS units in the last place of the reference's f32
score, with ids and order still equal.

Beyond the 24 cases: bodies of the shapes the Turbo route declines
(aggs, highlight, min_score, search_after, rescore, must_not,
minimum_should_match, profile), and a segment blob written by the
reference's `flush` served by the port's engine from the same data path,
and the reference's segments carried across by their arrays
(`segment_io.segment_from_arrays`).
"""

import copy
import inspect
import os

import numpy as np
import pytest
import torch

import test_search
from elasticsearch_tpu.index.engine import InternalEngine as RefEngine
from elasticsearch_tpu.mapper import MapperService as RefMapper
from elasticsearch_tpu.search import execute_search as ref_execute
from elasticsearch_tpu_torch.common.errors import DeviceUnavailableError
from elasticsearch_tpu_torch.index.engine import InternalEngine
from elasticsearch_tpu_torch.mapper import MapperService
from elasticsearch_tpu_torch.search import execute_search

torch.set_num_threads(1)

SCORE_ULPS = 4
MAPPING, DOCS = test_search.MAPPING, test_search.DOCS


def _close(got, want, ulps):
    if want is None or ulps == 0:
        assert (got is None) == (want is None)
        if want is not None:
            assert np.float32(got).view(np.int32) == \
                np.float32(want).view(np.int32), (got, want)
        return
    tol = ulps * np.spacing(np.abs(np.float32(want)))
    assert abs(np.float32(got) - np.float32(want)) <= tol, (got, want)


def _ulps(request) -> int:
    """0 (bitwise) unless the body scores through function_score or knn."""
    text = repr(request)
    return SCORE_ULPS if ("knn" in text or "function_score" in text) else 0


def assert_same(want: dict, got: dict, ulps: int) -> None:
    w, g = copy.deepcopy(want), copy.deepcopy(got)
    w.pop("took")
    g.pop("took")
    wh, gh = w["hits"].pop("hits"), g["hits"].pop("hits")
    _close(g["hits"].pop("max_score"), w["hits"].pop("max_score"), ulps)
    assert g == w                       # totals, relation, aggs, envelope
    assert [h["_id"] for h in gh] == [h["_id"] for h in wh]
    for a, b in zip(gh, wh):
        _close(a.pop("_score"), b.pop("_score"), ulps)
        assert a == b                   # _source, fields, sort, highlight


def _plain(result):
    """An engine result as a comparable value (the two packages' result
    dataclasses are different types)."""
    return vars(result) if hasattr(result, "__dict__") else result


class TwinMapper:
    def __init__(self, mappings):
        self.ref = RefMapper(copy.deepcopy(mappings))
        self.port = MapperService(copy.deepcopy(mappings))


class TwinSearcher:
    def __init__(self, ref, port):
        self.ref, self.port = ref, port

    @property
    def n_docs(self):
        assert self.port.n_docs == self.ref.n_docs
        return self.port.n_docs


class TwinEngine:
    """A reference and a port engine fed the same operations."""

    def __init__(self, mapper: TwinMapper):
        self.mapper = mapper
        self.ref = RefEngine(mapper.ref)
        self.port = InternalEngine(mapper.port, device="cpu")

    def _both(self, name, *a, **kw):
        want = getattr(self.ref, name)(*a, **kw)
        got = getattr(self.port, name)(*a, **kw)
        assert _plain(got) == _plain(want), name
        return got

    def index(self, *a, **kw):
        return self._both("index", *a, **kw)

    def delete(self, *a, **kw):
        return self._both("delete", *a, **kw)

    def refresh(self):
        return self._both("refresh")

    def acquire_searcher(self):
        return TwinSearcher(self.ref.acquire_searcher(),
                            self.port.acquire_searcher())


def twin_execute(searcher, mapper, request, index="index"):
    want = ref_execute(searcher.ref, mapper.ref, copy.deepcopy(request), index)
    got = execute_search(searcher.port, mapper.port, copy.deepcopy(request),
                         index)
    assert_same(want, got, _ulps(request))
    return got


@pytest.fixture(scope="module")
def twin():
    e = TwinEngine(TwinMapper(MAPPING))
    for doc_id, src in DOCS.items():
        e.index(doc_id, src)
        if doc_id == "2":
            e.refresh()          # force multi-segment coverage
    e.refresh()
    assert len(e.port.acquire_searcher().views) == 2
    return e


CASES = sorted(n for n, f in vars(test_search).items()
               if n.startswith("test_") and inspect.isfunction(f))


def test_all_cases_listed():
    assert len(CASES) == 24


@pytest.mark.parametrize("name", CASES)
def test_search_case_matches_reference(name, twin, monkeypatch):
    """The reference case on twins: its assertions hold on the port's
    responses, and every response equals the reference's."""
    monkeypatch.setattr(test_search, "execute_search", twin_execute)
    monkeypatch.setattr(test_search, "InternalEngine", TwinEngine)
    monkeypatch.setattr(test_search, "MapperService", TwinMapper)
    fn = getattr(test_search, name)
    params = inspect.signature(fn).parameters
    fn(*([twin] if "engine" in params else []))


EXTRA = {
    "aggs_under_match": {
        "query": {"match": {"body": "dog lazy"}},
        "aggs": {"t": {"terms": {"field": "tags"}},
                 "p": {"avg": {"field": "price"}},
                 "h": {"histogram": {"field": "views", "interval": 100}}}},
    "aggs_match_all_size0": {
        "size": 0, "aggs": {"d": {"date_histogram": {
            "field": "published", "calendar_interval": "year"}}}},
    "highlight": {"query": {"bool": {"should": [
        {"match": {"body": "lazy dog"}},
        {"match_phrase": {"body": "quick brown"}}]}},
        "highlight": {"fields": {"body": {}, "title": {}}}},
    "min_score": {"query": {"match": {"body": "the dog lazy"}},
                  "min_score": 0.5},
    "search_after": {"query": {"match_all": {}},
                     "sort": [{"views": "desc"}], "search_after": [250]},
    "must_not_msm": {"query": {"bool": {
        "should": [{"match": {"body": "dog"}}, {"match": {"body": "fox"}},
                   {"term": {"tags": "tech"}}],
        "must_not": [{"range": {"price": {"gt": 40}}}],
        "minimum_should_match": 1}}},
    "rescore": {"query": {"match": {"body": "the"}},
                "rescore": {"window_size": 5, "query": {
                    "rescore_query": {"match": {"body": "lazy"}},
                    "query_weight": 0.7, "rescore_query_weight": 1.3}}},
    "profile_fuzzy": {"query": {"fuzzy": {"body": {"value": "dgo"}}},
                      "profile": True},
    "function_score_log1p": {"query": {"function_score": {
        "query": {"match": {"body": "dog search jax"}},
        "functions": [{"field_value_factor": {
            "field": "views", "factor": 1.2, "modifier": "log1p"}}],
        "boost_mode": "sum"}}},
    "source_includes_fields": {"query": {"match_phrase_prefix": {
        "body": "lazy d"}}, "_source": {"includes": ["t*"]},
        "fields": ["tags", "price"]},
    "track_total_false": {"query": {"match_all": {}},
                          "track_total_hits": False, "size": 2},
}


@pytest.mark.parametrize("name", sorted(EXTRA))
def test_declined_shapes_match_reference(name, twin):
    got = twin_execute(twin.acquire_searcher(), twin.mapper, EXTRA[name])
    assert got["hits"]["hits"] or name == "aggs_match_all_size0"


def test_reference_written_segment_blob_serves_same_hits(tmp_path):
    """A data path the reference's engine flushed (commit point, segment
    blobs in segment_io's format, translog tail) recovers into the port's
    engine, which serves the reference's hits."""
    path = str(tmp_path / "shard")
    ref = RefEngine(RefMapper(copy.deepcopy(MAPPING)), data_path=path)
    for i, (doc_id, src) in enumerate(DOCS.items()):
        ref.index(doc_id, src)
        if i == 1:
            ref.refresh()
    ref.delete("3")
    ref.flush()
    ref.index("5", dict(DOCS["1"], title="after the commit"))   # tail op
    ref.close()
    blobs = [f for f in os.listdir(os.path.join(path, "segments"))
             if f.endswith(".seg")]
    assert len(blobs) == 2
    with open(os.path.join(path, "segments", sorted(blobs)[0]), "rb") as f:
        assert f.read(9) == b"ESTPUSEG3"        # segment_io's v3 blob

    ref = RefEngine(RefMapper(copy.deepcopy(MAPPING)), data_path=path)
    port = InternalEngine(MapperService(copy.deepcopy(MAPPING)),
                          data_path=path, device="cpu")
    ref.refresh()
    port.refresh()
    assert port.doc_count() == ref.doc_count() == 4
    for body in ({"query": {"match": {"body": "lazy dog"}}},
                 {"query": {"match_all": {}}, "sort": [{"views": "asc"}]},
                 {"query": {"terms": {"tags": ["animal", "tech"]}},
                  "aggs": {"t": {"terms": {"field": "tags"}}}}):
        want = ref_execute(ref.acquire_searcher(), ref.mapper, body, "i")
        got = execute_search(port.acquire_searcher(), port.mapper, body, "i")
        assert_same(want, got, 0)
    ref.close()
    port.close()


def test_segments_carried_across_by_their_arrays(twin):
    """`segment_io.segment_from_arrays` builds port segments from the
    reference engine's own segments; over the reference's live masks they
    serve the reference's responses."""
    from elasticsearch_tpu_torch.index.engine import (
        EngineSearcher, SegmentView,
    )
    from elasticsearch_tpu_torch.index.segment_io import segment_from_arrays

    ref_s = twin.ref.acquire_searcher()
    cpu = torch.device("cpu")
    port_s = EngineSearcher(
        [SegmentView(segment=segment_from_arrays(v.segment, cpu),
                     live=v.live.copy(), live_epoch=v.live_epoch)
         for v in ref_s.views], cpu)
    for body in ({"query": {"match": {"body": "lazy dog"}}},
                 {"query": {"range": {"published": {"gte": "2021-01-01"}}},
                  "sort": [{"price": "desc"}], "fields": ["tags"]},
                 EXTRA["aggs_under_match"], EXTRA["highlight"]):
        want = ref_execute(ref_s, twin.mapper.ref, copy.deepcopy(body), "i")
        got = execute_search(port_s, twin.mapper.port, copy.deepcopy(body),
                             "i")
        assert_same(want, got, 0)


def test_engine_refuses_to_pick_the_cpu():
    """No device means the card: without one the engine raises, and the
    segments and searcher of a CPU engine carry the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(DeviceUnavailableError):
        InternalEngine(MapperService(copy.deepcopy(MAPPING)))
    e = InternalEngine(MapperService(copy.deepcopy(MAPPING)), device="cpu")
    e.index("1", DOCS["1"])
    e.refresh()
    s = e.acquire_searcher()
    assert s.device.type == "cpu"
    assert s.views[0].segment.torch_device.type == "cpu"
    block_docs, _, _ = s.views[0].segment.device("post:body")
    assert block_docs.device.type == "cpu"
