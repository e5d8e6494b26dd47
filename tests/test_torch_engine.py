"""The port's write path against the reference, on the CPU.

Every case of tests/test_engine.py runs twice: once as it is, on the
reference, and once on the port, its module globals (`InternalEngine`,
`MapperService`, `Translog`, `LocalCheckpointTracker`,
`ReplicationTracker`, `VersionConflictError`) swapped for the port's, with
the engine on `device="cpu"`. The case's own assertions hold the port's
outcomes (results, versions, seqnos, checkpoints, recovery, translog
replay). Every engine a case builds is recorded, and at the end of the
case each port engine's state must equal its reference twin's: doc count,
checkpoints, segment count, live masks, and every document the case wrote
as `get` returns it.
"""

import inspect

import numpy as np
import pytest
import torch

import test_engine
from elasticsearch_tpu_torch.common.errors import VersionConflictError
from elasticsearch_tpu_torch.index.engine import InternalEngine
from elasticsearch_tpu_torch.index.seqno import (
    LocalCheckpointTracker, ReplicationTracker,
)
from elasticsearch_tpu_torch.index.translog import Translog
from elasticsearch_tpu_torch.mapper import MapperService

torch.set_num_threads(1)

CASES = sorted(n for n, f in vars(test_engine).items()
               if n.startswith("test_") and inspect.isfunction(f))


def test_all_cases_listed():
    assert len(CASES) == 15


def _recording(cls, made, **extra):
    class Recorded(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw, **extra)
            made.append(self)
    return Recorded


def _state(e, ids):
    return {
        "doc_count": e.doc_count(),
        "local_checkpoint": e.local_checkpoint,
        "max_seq_no": e.max_seq_no,
        "segment_count": e.segment_count(),
        "live": [m.tolist() for m in e._live],
        "docs": {i: e.get(i) for i in sorted(ids)},
    }


def _run(name, tmp_path):
    fn = getattr(test_engine, name)
    params = inspect.signature(fn).parameters
    if "tmp_path" in params:
        tmp_path.mkdir()
        fn(tmp_path)
    else:
        fn()


@pytest.mark.parametrize("name", CASES)
def test_engine_case_matches_reference(name, tmp_path, monkeypatch):
    ref_made, port_made = [], []
    monkeypatch.setattr(test_engine, "InternalEngine",
                        _recording(test_engine.InternalEngine, ref_made))
    _run(name, tmp_path / "ref")

    monkeypatch.setattr(test_engine, "InternalEngine",
                        _recording(InternalEngine, port_made, device="cpu"))
    monkeypatch.setattr(test_engine, "MapperService", MapperService)
    monkeypatch.setattr(test_engine, "Translog", Translog)
    monkeypatch.setattr(test_engine, "LocalCheckpointTracker",
                        LocalCheckpointTracker)
    monkeypatch.setattr(test_engine, "ReplicationTracker", ReplicationTracker)
    monkeypatch.setattr(test_engine, "VersionConflictError",
                        VersionConflictError)
    _run(name, tmp_path / "port")

    assert len(port_made) == len(ref_made)
    for p, r in zip(port_made, ref_made):
        ids = set(r._versions) | set(p._versions)
        assert _state(p, ids) == _state(r, ids)
        for view_p, view_r in zip(p.acquire_searcher().views,
                                  r.acquire_searcher().views):
            sp, sr = view_p.segment, view_r.segment
            assert sp.doc_ids == sr.doc_ids
            assert np.array_equal(sp.seq_nos, sr.seq_nos)
            assert np.array_equal(sp.versions, sr.versions)
            assert sp.torch_device.type == "cpu"
