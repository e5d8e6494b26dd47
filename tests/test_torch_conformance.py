"""The YAML REST conformance suites on the port's node.

The port's copy of tests/conformance/test_conformance.py: the same 41
cases, loaded from the same YAML files through `tests.conformance.runner`,
run against a port `Node(device="cpu")` through its `RestController`, the
dispatch surface HTTP clients hit. The snapshot suite names a fixed
repository location; each case here gets it rewritten to a directory of its
own under `tmp_path`, so that it never shares the directory with the
reference's copy of the case running in another process.
"""

import copy
import json
from pathlib import Path

import pytest
import torch

from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest import RestController, register_handlers
from tests.conformance.runner import YamlTestRunner, load_suites

torch.set_num_threads(1)

SUITES = load_suites(Path(__file__).parent / "conformance" / "suites")
# the repository location the snapshot suite hardcodes
SHARED_REPO = "/tmp/es_tpu_conformance_repo"


def _relocate(steps, location):
    """`steps` with every string equal to SHARED_REPO replaced by
    `location`."""
    if isinstance(steps, dict):
        return {k: _relocate(v, location) for k, v in steps.items()}
    if isinstance(steps, list):
        return [_relocate(v, location) for v in steps]
    return location if steps == SHARED_REPO else steps


@pytest.fixture()
def dispatch():
    node = Node(device="cpu")
    rc = RestController()
    register_handlers(node, rc)

    def call(method, path, params, raw):
        resp = rc.dispatch(method, path, params, raw)
        data = resp.encode()
        try:
            body = json.loads(data) if data else {}
        except json.JSONDecodeError:
            body = {"_raw": data.decode(errors="replace")}
        return resp.status, body

    yield call
    node.close()


def test_suites_are_the_reference_set():
    """The 41 cases the reference's conformance test runs."""
    assert len(SUITES) == 41
    assert sum(SHARED_REPO in json.dumps(s) for s in SUITES) == 1


@pytest.mark.parametrize(
    "fname,name,setup,steps", SUITES,
    ids=[f"{f}::{n}" for f, n, _, _ in SUITES])
def test_suite(dispatch, tmp_path, fname, name, setup, steps):
    location = str(tmp_path / "repo")
    runner = YamlTestRunner(dispatch)
    if setup:
        runner.run_steps(_relocate(copy.deepcopy(setup), location))
    runner.run_steps(_relocate(copy.deepcopy(steps), location))
