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
