"""Port serving path vs the reference, on the CPU.

`extract_plan` must flatten every body to the same FlatPlan in both
packages, and `select_bm25_engine(...).search_many` must return the
reference's (scores, partition, ord) bit for bit with ES_TPU_FORCE_TURBO=1
(the reference's own switch for serving Turbo off its device; the port
honours it for device="cpu").
"""

import dataclasses

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.segment import build_field_postings
from elasticsearch_tpu.mapper.mapper_service import MapperService as RefMapper
from elasticsearch_tpu.search import serving as ref_serving
from elasticsearch_tpu_torch.common.errors import DeviceUnavailableError
from elasticsearch_tpu_torch.index.segment import (
    POSTINGS_ARRAYS, postings_from_arrays,
)
from elasticsearch_tpu_torch.mapper import MapperService
from elasticsearch_tpu_torch.search import serving

torch.set_num_threads(1)

MAPPINGS = {"properties": {"body": {"type": "text"},
                           "tag": {"type": "keyword"}}}
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lam", "mu", "nu", "xi", "omicron", "pi"]

BODIES = [
    {"query": {"match": {"body": "alpha beta"}}},
    {"query": {"match": {"body": "Gamma, DELTA!"}}, "size": 25},
    {"query": {"term": {"body": {"value": "delta", "boost": 2.0}}}},
    {"query": {"match": {"body": {"query": "alpha beta gamma",
                                  "operator": "and"}}}},
    {"query": {"bool": {"should": [{"match": {"body": "omicron"}},
                                   {"term": {"body": "pi"}}]}}},
    {"query": {"bool": {"should": [{"match": {"body": "kappa mu"}}]}}},
    {"query": {"bool": {
        "must": [{"term": {"body": "beta"}}],
        "should": [{"term": {"body": "gamma"}}],
        "must_not": [{"term": {"tag": "blue"}}]}}},
    {"query": {"match_phrase": {"body": "alpha beta"}}},
    {"query": {"match": {"body": "theta iota"}}, "from": 5, "size": 10},
    {"query": {"match": {"tag": "red"}}},                    # keyword: none
    {"query": {"match_all": {}}},                            # none
    {"query": {"match": {"body": "xi"}}, "aggs": {}},        # key: none
    {"query": {"match": {"body": {"query": "nu", "fuzziness": 1}}}},
]


def _plan_dict(plan):
    return None if plan is None else dataclasses.asdict(plan)


@pytest.mark.parametrize("body", BODIES, ids=range(len(BODIES)))
def test_extract_plan_same(body):
    want = ref_serving.extract_plan(body, RefMapper(MAPPINGS))
    got = serving.extract_plan(body, MapperService(MAPPINGS))
    assert _plan_dict(got) == _plan_dict(want)


class _Seg:
    def __init__(self, n_docs, fp):
        self.n_docs = n_docs
        self.postings = {"body": fp}


@pytest.fixture(scope="module")
def index():
    """Two partitions of a small text corpus, built by the reference and
    carried across to the port."""
    rng = np.random.default_rng(31)
    ref_segs, port_segs, lives = [], [], []
    for n in (700, 500):
        lens = rng.integers(3, 20, size=n).astype(np.int64)
        toks = rng.integers(0, len(WORDS), size=int(lens.sum()))
        docs = np.repeat(np.arange(n, dtype=np.int64), lens)
        fp = build_field_postings("body", lens, docs, toks, list(WORDS))
        ref_segs.append(_Seg(n, fp))
        port_segs.append(_Seg(n, postings_from_arrays(
            {a: getattr(fp, a) for a in POSTINGS_ARRAYS}, fp.terms,
            fp.sum_doc_len)))
        lives.append(rng.random(n) > 0.1)
    return ref_segs, port_segs, lives


def test_select_bm25_engine_bitwise(index, monkeypatch):
    monkeypatch.setenv("ES_TPU_FORCE_TURBO", "1")
    ref_segs, port_segs, lives = index
    ref = ref_serving.select_bm25_engine(ref_segs, "body", lives, None,
                                         cold_df=300)
    port = serving.select_bm25_engine(port_segs, "body", lives,
                                      device="cpu", cold_df=300)
    assert ref.kind == port.kind == "turbo"
    bodies = [b for b in BODIES if b["query"].get("match", {}).get("body")
              or "term" in b["query"] or "bool" in b["query"]]
    ref_m, port_m = RefMapper(MAPPINGS), MapperService(MAPPINGS)
    batch_ref, batch_port = [], []
    for b in bodies:
        pr = ref_serving.extract_plan(b, ref_m)
        pp = serving.extract_plan(b, port_m)
        if pr is not None and pr.is_disjunctive:
            batch_ref.append(pr.disj)
            batch_port.append(pp.disj)
    assert batch_port == batch_ref and len(batch_port) >= 5
    rng = np.random.default_rng(5)
    pairs = [[WORDS[a], WORDS[b]] for a, b in
             rng.integers(0, len(WORDS), size=(12, 2))]
    want = ref.search_many([batch_ref, pairs], k=10)
    got = port.search_many([batch_port, pairs], k=10)
    for gb, wb in zip(got, want):
        for g, w, name in zip(gb, wb, ("scores", "partitions", "ords")):
            assert np.array_equal(g, w), name
    assert port.stats["fallbacks"] == ref.stats["fallbacks"]


def test_cpu_needs_force_turbo(index, monkeypatch):
    """Without ES_TPU_FORCE_TURBO the reference leaves the CPU to BlockMax;
    the port, which has no BlockMax yet, says so instead of falling back."""
    monkeypatch.delenv("ES_TPU_FORCE_TURBO", raising=False)
    _, port_segs, _ = index
    assert not serving.turbo_eligible(port_segs, "body", device="cpu")
    with pytest.raises(NotImplementedError, match="BlockMax"):
        serving.select_bm25_engine(port_segs, "body", device="cpu")


def test_default_device_is_cuda(index, monkeypatch):
    """An entry point called without device= runs on the card; on a host
    without one it raises rather than picking the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.setenv("ES_TPU_FORCE_TURBO", "1")
    _, port_segs, _ = index
    with pytest.raises(DeviceUnavailableError):
        serving.select_bm25_engine(port_segs, "body")
