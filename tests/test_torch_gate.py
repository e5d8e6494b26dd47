"""The port stands alone: every module of elasticsearch_tpu_torch imports in
a process where `jax` and every `elasticsearch_tpu` module are refused, and
its entry points do not pick the CPU on their own."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_GATE = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "elasticsearch_tpu" or name.startswith("elasticsearch_tpu."):
            raise ImportError("refused: " + name)
        return None

sys.modules["jax"] = None
sys.meta_path.insert(0, Refuse())

import elasticsearch_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "elasticsearch_tpu" or m.startswith("elasticsearch_tpu."))
assert not [m for m in bad if sys.modules[m] is not None], bad
print("\n".join(names))
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    r = subprocess.run([sys.executable, "-c", _GATE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    # package, subpackages and modules: the 33 of slices 1-4 at least, the
    # in-process search path, the serving entry point (index service,
    # serving context, scheduler, coalescer, pools, cluster state), and the
    # REST node with what it builds (`python -m elasticsearch_tpu_torch`):
    # security, snapshots, the task plane, rollover and shard allocation;
    # and the cluster path: ClusterNode, coordination, replication, the
    # shard service and the test harnesses of `testing/`
    names = set(r.stdout.strip().splitlines()[:-1])
    assert {
        "elasticsearch_tpu_torch.__main__",
        "elasticsearch_tpu_torch.node",
        "elasticsearch_tpu_torch.plugins",
        "elasticsearch_tpu_torch.rest.handlers",
        "elasticsearch_tpu_torch.rest.controller",
        "elasticsearch_tpu_torch.rest.http_server",
        "elasticsearch_tpu_torch.transport.channels",
        "elasticsearch_tpu_torch.transport.service",
        "elasticsearch_tpu_torch.cluster.remote",
        "elasticsearch_tpu_torch.cluster.allocation",
        "elasticsearch_tpu_torch.cluster.telemetry_plane",
        "elasticsearch_tpu_torch.index.ccr",
        "elasticsearch_tpu_torch.ingest.service",
        "elasticsearch_tpu_torch.ingest.processors",
        "elasticsearch_tpu_torch.action.search_action",
        "elasticsearch_tpu_torch.common.indexing_pressure",
        "elasticsearch_tpu_torch.common.relocation",
        "elasticsearch_tpu_torch.index.index_service",
        "elasticsearch_tpu_torch.search.serving",
        "elasticsearch_tpu_torch.search.reader_context",
        "elasticsearch_tpu_torch.search.suggest",
        "elasticsearch_tpu_torch.threadpool.scheduler",
        "elasticsearch_tpu_torch.threadpool.coalescer",
        "elasticsearch_tpu_torch.threadpool.pool",
        "elasticsearch_tpu_torch.cluster.state",
        "elasticsearch_tpu_torch.common.tracing",
        "elasticsearch_tpu_torch.common.overload",
        "elasticsearch_tpu_torch.common.breaker",
        "elasticsearch_tpu_torch.security",
        "elasticsearch_tpu_torch.security.service",
        "elasticsearch_tpu_torch.snapshots",
        "elasticsearch_tpu_torch.snapshots.repository",
        "elasticsearch_tpu_torch.snapshots.service",
        "elasticsearch_tpu_torch.tasks.task_plane",
        "elasticsearch_tpu_torch.indices",
        "elasticsearch_tpu_torch.indices.rollover",
        "elasticsearch_tpu_torch.parallel.spmd",
        "elasticsearch_tpu_torch.parallel.blockmax",
        "elasticsearch_tpu_torch.cluster_node",
        "elasticsearch_tpu_torch.cluster.cluster_service",
        "elasticsearch_tpu_torch.cluster.coordination",
        "elasticsearch_tpu_torch.cluster.gateway",
        "elasticsearch_tpu_torch.cluster.store",
        "elasticsearch_tpu_torch.common.wire",
        "elasticsearch_tpu_torch.index.replication",
        "elasticsearch_tpu_torch.indices.cluster_state_service",
        "elasticsearch_tpu_torch.indices.shard_service",
        "elasticsearch_tpu_torch.testing",
        "elasticsearch_tpu_torch.testing.chaos",
        "elasticsearch_tpu_torch.testing.deterministic",
        "elasticsearch_tpu_torch.testing.disruptable_transport",
        "elasticsearch_tpu_torch.testing.linearizability",
    } <= names
    assert int(r.stdout.strip().splitlines()[-1]) >= 108


_GRAFT = r"""
import importlib, importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "elasticsearch_tpu" or name.startswith("elasticsearch_tpu."):
            raise ImportError("refused: " + name)
        return None

sys.modules["jax"] = None
sys.meta_path.insert(0, Refuse())

import __graft_entry_torch__ as g
stats = g.self_test(4, device="cpu")
fn, args = g.entry(device="cpu")
scores, docs = fn(*args)
assert tuple(scores.shape) == tuple(docs.shape) == (1, 4, 10)
assert all(a.device.type == "cpu" for a in args)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "elasticsearch_tpu" or m.startswith("elasticsearch_tpu."))
assert not [m for m in bad if sys.modules[m] is not None], bad
print(stats["fused_dispatches"], stats["merge_device"])
"""


def test_graft_entry_runs_without_jax_or_reference():
    """`__graft_entry_torch__` (the port's counterpart of
    `__graft_entry__.py`) imports and runs its self-test and its entry
    function on the CPU where jax and the reference are refused."""
    r = subprocess.run([sys.executable, "-c", _GRAFT], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    fused, merged = map(int, r.stdout.split())
    assert fused >= 1 and merged >= 1


def test_scripts_import_neither_jax_nor_reference():
    """chip_smoke.py and __graft_entry_torch__.py import nothing of jax or
    of the reference, at module level or inside a function."""
    import ast

    for name in ("chip_smoke.py", "__graft_entry_torch__.py"):
        tree = ast.parse((ROOT / name).read_text(), name)
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module)
        bad = sorted(m for m in mods
                     if m.split(".")[0] in ("jax", "jaxlib",
                                            "elasticsearch_tpu"))
        assert not bad, (name, bad)
        assert "elasticsearch_tpu_torch" in {m.split(".")[0] for m in mods}


def test_graft_entry_step_matches_reference_local_topk():
    """The entry function's K10 top-k over the tiny corpus against the
    reference's `_local_bm25_topk` on the same documents: the same doc
    ids in the same order, scores within the BlockMax bound (W2)."""
    import numpy as np

    import __graft_entry__ as ref_g
    import __graft_entry_torch__ as g

    fn, args = g.entry(device="cpu")
    scores, docs = (t.numpy()[0] for t in fn(*args))
    ref_fn, ref_args = ref_g.entry()
    ref_s, ref_d = (np.asarray(a) for a in ref_fn(*ref_args))
    assert ref_s.shape == scores.shape
    for q in range(scores.shape[0]):
        live = ref_s[q] > 0
        assert np.array_equal(docs[q][live], ref_d[q][live]), q
        assert np.allclose(scores[q][live], ref_s[q][live], rtol=2e-5,
                           atol=2e-5), q
        assert not (scores[q][~live] > 0).any(), q


def test_rollover_imports_alone():
    """`indices.rollover` loads without the package's cluster-path
    modules: the package exports resolve lazily."""
    code = ("import sys\n"
            "import elasticsearch_tpu_torch.indices.rollover as r\n"
            "assert r.next_rollover_name('logs-000001') == 'logs-000002'\n"
            "loaded = sorted(m for m in sys.modules\n"
            "                if m.startswith('elasticsearch_tpu_torch.indices'))\n"
            "assert loaded == ['elasticsearch_tpu_torch.indices',\n"
            "                  'elasticsearch_tpu_torch.indices.rollover'], loaded\n"
            "assert not any('shard_service' in m or 'cluster_state_service' in m\n"
            "               for m in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_default_to_cuda():
    import numpy as np
    import torch

    from elasticsearch_tpu_torch import device
    from elasticsearch_tpu_torch.cluster_node import (
        ClusterNode, LiveClusterNode, form_local_cluster,
    )
    from elasticsearch_tpu_torch.cluster.state import IndexMetadata
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.index_service import (
        IndexService, IndicesService,
    )
    from elasticsearch_tpu_torch.common.errors import DeviceUnavailableError
    from elasticsearch_tpu_torch.index.segment import VectorColumn
    from elasticsearch_tpu_torch.parallel.knn import KnnEngine, build_knn_engine
    from elasticsearch_tpu_torch.parallel.spmd import StackedBM25
    from elasticsearch_tpu_torch.parallel.turbo import TurboBM25
    from elasticsearch_tpu_torch.search import agg_device

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert device.resolve("cpu").type == "cpu"
    with pytest.raises(DeviceUnavailableError):
        device.resolve()
    with pytest.raises(DeviceUnavailableError):
        TurboBM25(StackedBM25(field="body", n_shards=1, max_docs=1,
                              doc_counts=[1], avgdl=1.0, total_docs=1,
                              postings=[]))
    cols = [VectorColumn(np.ones((3, 4), np.float32),
                         np.full(3, 2.0, np.float32), np.ones(3, bool), 4,
                         "cosine")] * 2
    meta = IndexMetadata(index="g", uuid="u", settings=Settings({}),
                         mappings={"properties": {"body": {"type": "text"}}})
    from elasticsearch_tpu_torch.parallel.spmd import (
        build_stacked_bm25, build_stacked_knn,
    )

    class _Seg:
        n_docs = 3
        postings = {}
        vectors = {"v": cols[0]}

    for make in (lambda: IndexService(meta), IndicesService,
                 lambda: build_stacked_bm25([_Seg()], "body",
                                            device_arrays=True),
                 lambda: build_stacked_knn([_Seg()], "v"),
                 lambda: KnnEngine(cols[:1]),
                 lambda: KnnEngine(cols, stacked=True),
                 lambda: build_knn_engine(cols),
                 agg_device.AggDeviceEngine,
                 agg_device.default_engine,
                 lambda: form_local_cluster(["n0", "n1"]),
                 lambda: LiveClusterNode("n0", voting_config=["n0"])):
        with pytest.raises(DeviceUnavailableError):
            make()
    _, store, channels = form_local_cluster(["n0"], device="cpu")
    with pytest.raises(DeviceUnavailableError):
        ClusterNode("n1", channels, store)
