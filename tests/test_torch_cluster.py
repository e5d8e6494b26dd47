"""The cluster path's own holds on the port, on the CPU.

The reference's cluster suites run on both packages in the
tests/test_torch_<suite>.py twins; these cases hold what the port adds
(ROADMAP W16):

* every node of `form_local_cluster(..., device=...)` serves its shard
  copies on that one device, through the shard query phase's and the
  relocation handoff's `ServingContext`;
* a kernel error in a shard's engine fails the cluster search with its
  type: the dense executor, another copy and `_shards.failed` do not
  serve around it, and it crosses the TCP transport with its type;
* a kernel error fails the warm relocation handoff: the move does not
  complete cold, the source keeps the shard, no warm failure is counted;
* the handoff pre-slices the source's cold tier on the target
  (`sparse_hot_terms` / `prewarm_sparse`), and the answers before and
  after the move are bitwise equal, and equal to the reference's.
"""

import pytest

from elasticsearch_tpu.cluster_node import (
    form_local_cluster as ref_form_local_cluster,
)
from elasticsearch_tpu.common import relocation as ref_reloc
from elasticsearch_tpu_torch.action import search_action
from elasticsearch_tpu_torch.cluster_node import form_local_cluster
from elasticsearch_tpu_torch.common import relocation as reloc
from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuError, KernelBuildError, KernelLaunchError,
)
from elasticsearch_tpu_torch.parallel import kernels
from elasticsearch_tpu_torch.search.serving import TurboEngine
from elasticsearch_tpu_torch.transport.service import TransportService
from test_torch_index_service import TURBO_ENV, assert_bitwise

MAPPINGS = {"properties": {"n": {"type": "integer"},
                           "body": {"type": "text"}}}
MATCH = {"query": {"match": {"body": "common"}}, "size": 10,
         "track_total_hits": True}


def _docs(count):
    # `rare<i % 40>` has df 3 at 120 docs: under TURBO_ENV's cold df of 8,
    # so those terms are served from the sparse slice pool
    return [{"op": "index", "id": str(i),
             "source": {"n": i,
                        "body": f"word{i % 7} common text rare{i % 40}"}}
            for i in range(count)]


def _cluster(make, replicas, count=120, **kw):
    nodes, store, channels = make(["m0", "d0", "d1", "d2"],
                                  roles={"m0": ("master",)}, **kw)
    master, a = nodes[0], nodes[1]
    a.create_index("docs", {"settings": {"number_of_shards": 1,
                                         "number_of_replicas": replicas},
                            "mappings": MAPPINGS})
    assert not a.bulk("docs", _docs(count))["errors"]
    a.refresh("docs")
    return nodes, store, channels


@pytest.fixture()
def turbo(monkeypatch):
    for k, v in TURBO_ENV.items():
        monkeypatch.setenv(k, v)
    reloc.reset_for_tests()
    ref_reloc.reset_for_tests()
    yield
    reloc.reset_for_tests()
    ref_reloc.reset_for_tests()


def _holders(store):
    return {r.node_id for r in store.current().shard_copies("docs", 0)
            if r.node_id is not None}


def _move(node, store):
    src = store.current().primary_of("docs", 0).node_id
    to = next(n for n in ("d0", "d1", "d2") if n != src)
    node.cluster_reroute([{"move": {"index": "docs", "shard": 0,
                                    "from_node": src, "to_node": to}}])
    return src, to


def test_cluster_nodes_serve_on_their_device(turbo):
    nodes, store, _ = _cluster(form_local_cluster, 1, device="cpu")
    r = nodes[2].search("docs", MATCH)
    assert r["hits"]["total"]["value"] == 120
    assert all(n.device.type == "cpu" for n in nodes)
    served = 0
    for n in nodes:
        assert n.shard_service.device == n.device
        for inst in n.shard_service.shards.values():
            assert inst.engine.device.type == "cpu"
            ctx = getattr(inst, "_serving_ctx", None)
            if ctx is not None:
                served += 1
                assert ctx.svc.device == inst.engine.device
                eng = ctx.snapshot().engine("body")
                assert isinstance(eng, TurboEngine)
                assert eng.turbos[0].device.type == "cpu"
    assert served == 1          # the copy that answered the shard query


def test_kernel_error_fails_the_cluster_search(turbo, monkeypatch):
    """One shard, one replica: without the port's rule the failed shard
    query would re-run on the dense executor, then fail over to the
    other copy, then count under `_shards.failed` with a 200 answer."""
    nodes, store, _ = _cluster(form_local_cluster, 1, device="cpu")
    want = nodes[2].search("docs", MATCH)

    def no_launch(*a, **kw):
        raise KernelLaunchError("sweep_rowmax launch failed: cudaError 1")

    dense = []
    query_phase = search_action.execute_query_phase
    monkeypatch.setattr(search_action, "execute_query_phase",
                        lambda *a: dense.append(a) or query_phase(*a))
    monkeypatch.setattr(kernels, "sweep_rowmax", no_launch)
    before = dict(search_action._COORD_COUNTERS)
    for n in nodes:
        with pytest.raises(KernelLaunchError, match="cudaError 1"):
            n.search("docs", MATCH)
    assert dense == []
    assert search_action._COORD_COUNTERS == before
    for n in nodes:
        assert n.search_action.contexts.open_contexts == 0

    # the dense route answers the same body: the fault is the kernel's
    monkeypatch.setenv("ES_TPU_DISABLE_SHARD_SERVING", "1")
    got = nodes[2].search("docs", MATCH)
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in want["hits"]["hits"]]
    assert got["_shards"]["failed"] == 0


def test_kernel_error_crosses_the_tcp_transport():
    t = TransportService("n0")

    def build(req):
        raise KernelBuildError("nvcc failed for sweep_rowmax.cu")

    def app(req):
        raise ElasticsearchTpuError("an application error")

    t.register_request_handler("kernel", build)
    t.register_request_handler("app", app)
    port = t.bind()
    try:
        with pytest.raises(KernelBuildError, match="nvcc failed"):
            TransportService.send_remote("127.0.0.1", port, "kernel", {})
        with pytest.raises(ElasticsearchTpuError) as e:
            TransportService.send_remote("127.0.0.1", port, "app", {})
        assert type(e.value) is ElasticsearchTpuError
        assert "an application error" in str(e.value)
    finally:
        t.close()


def test_kernel_error_fails_the_warm_handoff(turbo, monkeypatch):
    """The handoff's engine calls raise a kernel error (as the handoff's
    kernels would): the reroute raises it, the target copy is failed, the
    source keeps serving, and no warm failure is counted."""
    nodes, store, _ = _cluster(form_local_cluster, 0, device="cpu")
    want = nodes[2].search("docs", MATCH)

    def no_launch(self, sizes):
        raise KernelLaunchError("build_columns launch failed: cudaError 9")

    monkeypatch.setattr(TurboEngine, "extend_qc_sizes", no_launch)
    holders = _holders(store)
    with pytest.raises(KernelLaunchError, match="cudaError 9"):
        _move(nodes[1], store)
    stats = reloc.relocation_stats()
    assert stats["warm_failures"] == 0 and stats["warm_handoffs"] == 0
    assert _holders(store) == holders
    assert all(r.state == "STARTED"
               for r in store.current().shard_copies("docs", 0))
    monkeypatch.undo()
    for k, v in TURBO_ENV.items():
        monkeypatch.setenv(k, v)
    assert_bitwise(nodes[3].search("docs", MATCH), want, MATCH)


def test_warm_handoff_prewarms_the_cold_tier(turbo):
    """The moved copy's engine holds the source's cold-term slices before
    it takes traffic; answers are bitwise equal before and after the
    move, and to the reference's in the same scenario."""
    bodies = [{"query": {"match": {"body": f"rare{i} word{i % 7}"}},
               "size": 10, "track_total_hits": True} for i in range(6)]
    out = {}
    for pkg, make, counters, kw in (
            ("ref", ref_form_local_cluster, ref_reloc, {}),
            ("port", form_local_cluster, reloc, {"device": "cpu"})):
        nodes, store, _ = _cluster(make, 0, **kw)
        before = [nodes[2].search("docs", b) for b in bodies]
        src, to = _move(nodes[1], store)
        assert _holders(store) == {to}
        after = [nodes[3].search("docs", b) for b in bodies]
        for b, x, y in zip(bodies, after, before):
            assert_bitwise(x, y, b)
        by_name = {n.node_name: n for n in nodes}
        eng = by_name[to].shard_service.get_shard(
            "docs", 0)._serving_ctx.snapshot().engine("body")
        out[pkg] = (before, counters.relocation_stats(),
                    eng.sparse_hot_terms())
    (ref_before, ref_stats, ref_hot), (before, stats, hot) = \
        out["ref"], out["port"]
    for b, x, y in zip(bodies, before, ref_before):
        assert_bitwise(x, y, b)
    assert stats["sparse_prewarms"] > 0
    assert stats["warm_failures"] == 0 and stats["warm_handoffs"] == 1
    assert hot and all(t.startswith("rare") for t in hot)
    assert hot == ref_hot
    assert {k: stats[k] for k in ("moves", "warm_handoffs", "fields_warmed",
                                  "sparse_prewarms", "warm_failures")} == \
        {k: ref_stats[k] for k in ("moves", "warm_handoffs", "fields_warmed",
                                   "sparse_prewarms", "warm_failures")}
