"""Driver entry points of the PyTorch + CUDA port (the counterpart of
__graft_entry__.py).

`entry(device=None)` returns a torch function and its example tensors on
the card (or on `device="cpu"`, where the kernels run their plain torch
versions): the batched BM25 block-scoring + top-k step over one segment,
the port's `_local_bm25_topk`. Its scores are the idf-free lane scores of
`spmd._spmd_lane_scores` and its top-k is the K10 `lane_topk` kernel, as
`sharded_bm25_topk` runs them.

`self_test(n_shards=4, device=None)` runs the distributed search step on
`n_shards` stacked partitions of one card: `sharded_bm25_topk` (K10 and
the K4 merge), `sharded_knn_topk`, and the fused S > 1 Turbo route that
`select_bm25_engine` picks, whose device merge must equal the host
`_merge3` of the partitions' own rows bit for bit.

    python __graft_entry_torch__.py               # on the card
    python __graft_entry_torch__.py --device cpu  # the plain versions

Imports torch and the port only, never jax or the reference.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _tiny_corpus(n_docs: int = 96, dims: int = 8, seed: int = 0):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(24)]
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    probs /= probs.sum()
    docs = {}
    for i in range(n_docs):
        body = " ".join(rng.choice(vocab, size=int(rng.integers(3, 12)),
                                   p=probs))
        vec = rng.normal(size=dims).astype(np.float32)
        docs[str(i)] = {"body": body, "vec": vec.tolist()}
    return docs


def _mapping(dims: int = 8):
    return {"properties": {"body": {"type": "text"},
                           "vec": {"type": "dense_vector", "dims": dims}}}


def _segments(docs, n_shards: int, dims: int, device):
    from elasticsearch_tpu_torch.index.engine import InternalEngine
    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.parallel import shard_for_id

    engines = [InternalEngine(MapperService(_mapping(dims)), device=device)
               for _ in range(n_shards)]
    for doc_id, src in docs.items():
        engines[shard_for_id(doc_id, n_shards)].index(doc_id, src)
    for e in engines:
        e.refresh()
    return [e.acquire_searcher().views[0].segment for e in engines]


def entry(device=None):
    """(fn, example_args): batched BM25 top-k over one segment's blocks,
    fn(block_docs, lane_scores, live, qblocks, qidf, tstart) -> (scores
    [1, Q, 10], docs [1, Q, 10])."""
    import torch

    from elasticsearch_tpu_torch import device as _device
    from elasticsearch_tpu_torch.parallel.kernels import lane_topk
    from elasticsearch_tpu_torch.parallel.spmd import (
        _spmd_lane_scores, build_stacked_bm25, prepare_query_blocks,
        term_runs,
    )

    dev = _device.resolve(device)
    (seg,) = _segments(_tiny_corpus(), 1, 8, dev)
    stacked = build_stacked_bm25([seg], "body", device=dev,
                                 device_arrays=True)
    queries = [["w0", "w3"], ["w1"], ["w2", "w5"], ["w4", "w0"]]
    qb, qi = prepare_query_blocks(stacked, queries)
    ts = term_runs(stacked, qb)

    def fn(block_docs, lane_scores, live, qblocks, qidf, tstart):
        return lane_topk(block_docs, lane_scores, live, qblocks, qidf,
                         tstart, k=10)

    example_args = (stacked.block_docs, _spmd_lane_scores(stacked),
                    stacked.live, torch.from_numpy(qb).to(dev),
                    torch.from_numpy(qi).to(dev),
                    torch.from_numpy(ts).to(dev))
    return fn, example_args


def self_test(n_shards: int = 4, device=None) -> dict:
    """The distributed search step on `n_shards` stacked partitions; raises
    AssertionError on a wrong shape or a fused merge that is not the host
    merge. Returns the fused engine's merge counters."""
    from elasticsearch_tpu_torch import device as _device
    from elasticsearch_tpu_torch.parallel.spmd import (
        build_stacked_bm25, build_stacked_knn, prepare_query_blocks,
        sharded_bm25_topk, sharded_knn_topk,
    )
    from elasticsearch_tpu_torch.search.serving import select_bm25_engine

    dev = _device.resolve(device)
    dims = 8
    segments = _segments(_tiny_corpus(n_docs=32 * n_shards, dims=dims,
                                      seed=1), n_shards, dims, dev)
    queries = [["w0", "w3"], ["w1"], ["w2"], ["w4", "w0"]] * 2

    stacked = build_stacked_bm25(segments, "body", device=dev,
                                 device_arrays=True)
    qb, qi = prepare_query_blocks(stacked, queries)
    top_s, shard_of, ord_of = sharded_bm25_topk(stacked, qb, qi, k=5)
    assert top_s.shape == shard_of.shape == (len(queries), 5)
    assert (top_s[:, 0] > 0).all(), "every query matches a document"

    knn = build_stacked_knn(segments, "vec", device=dev)
    qv = np.random.default_rng(2).normal(
        size=(len(queries), dims)).astype(np.float32)
    k_s, k_shard, k_ord = sharded_knn_topk(knn, qv, k=5)
    assert k_s.shape == (len(queries), 5)

    # the fused S > 1 Turbo route, through the serving path's selector;
    # on the CPU Turbo is eligible only when forced, as in the reference
    prev = os.environ.get("ES_TPU_FORCE_TURBO")
    os.environ["ES_TPU_FORCE_TURBO"] = "1"
    try:
        eng = select_bm25_engine(segments, "body", device=dev,
                                 hbm_budget_bytes=64 << 20, cold_df=2)
    finally:
        if prev is None:
            os.environ.pop("ES_TPU_FORCE_TURBO", None)
        else:
            os.environ["ES_TPU_FORCE_TURBO"] = prev
    assert eng.kind == "turbo", eng.kind
    assert eng.fused, "S > 1 partitions take the fused route"
    t_s, t_p, t_o = eng.search_many([queries], k=5)[0]
    assert t_s.shape == (len(queries), 5)
    per = [t.search_many([queries], k=5)[0] for t in eng.turbos]
    r_s, r_p, r_o = eng._merge3(per, len(queries), 5)
    assert np.array_equal(t_s, r_s) and np.array_equal(t_p, r_p) \
        and np.array_equal(t_o, r_o), "fused merge != host _merge3"
    stats = dict(eng.merge_stats)
    assert stats["fused_dispatches"] >= 1
    assert stats["merge_device"] >= 1
    assert stats["partition_dispatches"] >= len(eng.turbos)
    return stats


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions (default: the card)")
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()
    print(f"self_test({args.shards}) ok:",
          self_test(args.shards, device=args.device))
    fn, example = entry(device=args.device)
    out = fn(*example)
    print("entry ok:", [tuple(o.shape) for o in out])
