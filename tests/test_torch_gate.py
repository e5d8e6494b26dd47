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
    # in-process search path, and the serving entry point (index service,
    # serving context, scheduler, coalescer, pools, cluster state)
    names = set(r.stdout.strip().splitlines()[:-1])
    assert {
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
    } <= names
    assert int(r.stdout.strip().splitlines()[-1]) >= 65


def test_entry_points_default_to_cuda():
    import numpy as np
    import torch

    from elasticsearch_tpu_torch import device
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
    for make in (lambda: IndexService(meta), IndicesService,
                 lambda: KnnEngine(cols[:1]),
                 lambda: KnnEngine(cols, stacked=True),
                 lambda: build_knn_engine(cols),
                 agg_device.AggDeviceEngine,
                 agg_device.default_engine):
        with pytest.raises(DeviceUnavailableError):
            make()
