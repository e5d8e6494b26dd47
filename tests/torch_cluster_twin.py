"""Twin runs of the reference's cluster suites, on the reference and the port.

`twin_suite(suite, ns)` loads ``tests/test_<suite>.py`` twice into fresh
module objects: once as written (the reference), once with every
``elasticsearch_tpu`` import renamed to ``elasticsearch_tpu_torch`` and
``device="cpu"`` added to each call of the port's entry points
(`form_local_cluster`, `ClusterNode`, `LiveClusterNode`,
`CrashRestartCluster`, `Node`, `InternalEngine`, `segment_from_blob`),
which otherwise take the card. It then adds to ``ns`` one test per reference test, under the same
name, with the same arguments and marks (parametrize included). A twin
test runs the reference's function on the reference, then on the port,
each with its own `monkeypatch`, its own `tmp_path` directory and its own
run of the suite module's fixtures, so the reference's assertions hold on
both packages. While each runs, the twin records what the two packages
must agree on, and compares it after both have passed:

* every `LocalStateStore`'s final cluster state: nodes, index metadata
  (primary terms, in-sync sets, settings, mappings, aliases), routing
  tables; allocation ids are named by the copy that holds them, and
  uuids and wall-clock fields are dropped;
* every `InternalEngine`'s operation history (op, id, seq_no, version,
  source) with its local checkpoint, max seq_no and primary term;
* every `ClusterNode.search` answer: ids, order, totals, `_source`,
  `_shards` and aggregations equal; scores bitwise when the run serves
  Turbo (`TURBO_ENV`), else within `assert_blockmax_results`'s bound
  (the two packages sum floats in different orders, ROADMAP W2);
* the suite's own observables (`observe`), e.g. the coordination runs'
  committed histories.

`modes=("turbo",)` runs the named cases a second time with `TURBO_ENV`
set for both packages. Cases whose runs race by design (threads, wall
clocks) compare only what is deterministic; `loose` names them, each with
its reason. `step_clock` names cases whose transport-circuit backoffs
are tens of milliseconds: there `common.health` reads a `StepClock`,
which moves only when the test sleeps, so a loaded host cannot carry a
circuit past its backoff between two calls the test makes back to back.
"""

from __future__ import annotations

import ast
import copy
import functools
import importlib
import inspect
import json
import re
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

from test_torch_index_service import TURBO_ENV, assert_blockmax_results

TESTS = Path(__file__).resolve().parent
ENTRY_POINTS = {"form_local_cluster", "ClusterNode", "LiveClusterNode",
                "CrashRestartCluster", "Node", "InternalEngine",
                "segment_from_blob"}


class _CpuEntryPoints(ast.NodeTransformer):
    """Add device="cpu" to every call of a port entry point."""

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        name = f.id if isinstance(f, ast.Name) else \
            f.attr if isinstance(f, ast.Attribute) else None
        if name in ENTRY_POINTS and not any(
                k.arg == "device" for k in node.keywords):
            node.keywords.append(ast.keyword(
                arg="device", value=ast.Constant("cpu")))
        return node


def load(suite: str, port: bool) -> types.ModuleType:
    path = TESTS / f"test_{suite}.py"
    src = path.read_text()
    if port:
        src = re.sub(r"\belasticsearch_tpu\b", "elasticsearch_tpu_torch", src)
    tree = ast.parse(src, str(path))
    if port:
        tree = ast.fix_missing_locations(_CpuEntryPoints().visit(tree))
    name = f"_twin_{'port' if port else 'ref'}_{suite}"
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


# ---------------------------------------------------------------------------
# what both packages must agree on
# ---------------------------------------------------------------------------


def _aid_names(state: dict) -> dict:
    names = {}
    for index, shards in state["routing"].items():
        for r in shards:
            names[r["allocation_id"]] = (
                f"{index}/{r['shard_id']}/{'p' if r['primary'] else 'r'}"
                f"@{r['node_id']}")
    return names


def state_view(state) -> dict:
    d = copy.deepcopy(state.to_dict())
    aids = _aid_names(d)
    for n in d["nodes"].values():
        n.pop("address", None)
    for m in d["indices"].values():
        m.pop("uuid", None)
        m.pop("creation_date", None)
        m["in_sync_allocations"] = {
            k: sorted(aids.get(a, "<gone>") for a in v)
            for k, v in m["in_sync_allocations"].items()}
    for shards in d["routing"].values():
        for r in shards:
            r["allocation_id"] = aids.get(r["allocation_id"]) \
                if r["allocation_id"] else ""
            r.pop("delayed_until_ms", None)
        shards.sort(key=lambda r: json.dumps(r, sort_keys=True))
    return d


def engine_view(engine) -> tuple:
    ops = [(o["op"], o["id"], o["seq_no"], o.get("version"),
            json.dumps(o.get("source"), sort_keys=True))
           for o in engine.changes_since(-2)]
    return (engine.primary_term, engine.local_checkpoint, engine.max_seq_no,
            tuple(sorted(ops)))


class Recorder:
    """Hooks one package for one run: stores, engines, search answers."""

    def __init__(self, pkg: str, mp: pytest.MonkeyPatch):
        self.stores, self.engines, self.searches = [], [], []
        store_mod = importlib.import_module(f"{pkg}.cluster.store")
        engine_mod = importlib.import_module(f"{pkg}.index.engine")
        node_mod = importlib.import_module(f"{pkg}.cluster_node")
        self._wrap_init(mp, store_mod.LocalStateStore, self.stores)
        self._wrap_init(mp, engine_mod.InternalEngine, self.engines)
        search = node_mod.ClusterNode.search
        rec = self.searches

        @functools.wraps(search)
        def recorded(node, index, body=None):
            resp = search(node, index, body)
            rec.append((index, copy.deepcopy(body), copy.deepcopy(resp)))
            return resp

        mp.setattr(node_mod.ClusterNode, "search", recorded)

    @staticmethod
    def _wrap_init(mp, cls, out):
        init = cls.__init__

        @functools.wraps(init)
        def recorded(self, *a, **kw):
            init(self, *a, **kw)
            out.append(self)

        mp.setattr(cls, "__init__", recorded)

    def view(self, loose: bool) -> dict:
        out = {"states": [state_view(s.state) for s in self.stores]}
        if not loose:
            out["engines"] = sorted(engine_view(e) for e in self.engines)
        return out


def _scores_bitwise(got, want, where):
    assert [np.float32(h["_score"]) if h.get("_score") is not None else None
            for h in got] == \
        [np.float32(h["_score"]) if h.get("_score") is not None else None
         for h in want], where


def _timeless(d):
    """`d` without its wall-clock keys (`took`, at any depth) and its
    `profile` (timings)."""
    if isinstance(d, dict):
        return {k: _timeless(v) for k, v in d.items()
                if k not in ("took", "profile")}
    if isinstance(d, list):
        return [_timeless(v) for v in d]
    return d


def hold_search(got: dict, want: dict, turbo: bool, where) -> None:
    """One ClusterNode.search answer of the port against the reference's."""
    g, w = _timeless(got), _timeless(want)
    gh, wh = g.get("hits", {}).pop("hits", []), w.get("hits", {}).pop(
        "hits", [])
    gm = g.get("hits", {}).pop("max_score", None)
    wm = w.get("hits", {}).pop("max_score", None)
    scored = any(h.get("_score") is not None for h in gh + wh)
    if turbo or not scored:
        assert [h["_id"] for h in gh] == [h["_id"] for h in wh], where
        _scores_bitwise(gh, wh, where)
        assert gm == wm, where
    else:
        assert_blockmax_results(
            {"hits": {"hits": gh, "max_score": None,
                      "total": g["hits"].get("total")}},
            {"hits": {"hits": wh, "max_score": None,
                      "total": w["hits"].get("total")}}, where)
        if gm is None or wm is None:
            assert gm == wm, where
        else:
            assert abs(gm - wm) <= 2e-5 * abs(wm) + 2e-5, where
    # each hit but its score: by id (near-ties may order apart above)
    unscored = lambda hits: sorted(
        (json.dumps({k: v for k, v in h.items() if k != "_score"},
                    sort_keys=True, default=str) for h in hits))
    assert unscored(gh) == unscored(wh), where
    assert g == w, (where, g, w)


def _compare(ref: dict, port: dict, turbo: bool, loose: bool) -> None:
    assert len(port["states"]) == len(ref["states"])
    for i, (p, r) in enumerate(zip(port["states"], ref["states"])):
        assert p == r, f"cluster state of store {i}"
    if not loose:
        assert len(port["engines"]) == len(ref["engines"])
        for i, (p, r) in enumerate(zip(port["engines"], ref["engines"])):
            assert p == r, f"engine {i}: (term, local cp, max seq_no, ops)"
        ps, rs = port["searches"], ref["searches"]
        assert [(i, b) for i, b, _ in ps] == [(i, b) for i, b, _ in rs]
        for (index, body, p), (_, _, r) in zip(ps, rs):
            hold_search(p, r, turbo, (index, body))
    for name in ref.get("observed", {}):
        assert port["observed"][name] == ref["observed"][name], name


# ---------------------------------------------------------------------------
# fixtures of the suite module, run by hand for each package
# ---------------------------------------------------------------------------


def _fixtures(mod) -> dict:
    out = {}
    for name, obj in vars(mod).items():
        marker = getattr(obj, "_fixture_function_marker", None)
        if marker is not None:
            out[marker.name or name] = (obj._get_wrapped_function(),
                                        marker.autouse)
    return out


class _Run:
    """Resolve one variant's arguments; tear its fixtures down after."""

    def __init__(self, mod, builtins: dict):
        self.fixtures = _fixtures(mod)
        self.values = dict(builtins)
        self._teardown = []

    def value(self, name):
        if name in self.values:
            return self.values[name]
        fn, _ = self.fixtures[name]
        args = [self.value(a) for a in inspect.signature(fn).parameters]
        res = fn(*args)
        if inspect.isgenerator(res):
            gen = res
            res = next(gen)
            self._teardown.append(gen)
        self.values[name] = res
        return res

    def autouse(self):
        for name, (_, auto) in self.fixtures.items():
            if auto:
                self.value(name)

    def close(self):
        while self._teardown:
            gen = self._teardown.pop()
            try:
                next(gen)
            except StopIteration:
                pass


class StepClock:
    """`time` for `common.health` and the test module: `monotonic` moves
    only by what `sleep` sleeps (each sleep also sleeps for real)."""

    def __init__(self):
        self.now = time.monotonic()

    def monotonic(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        time.sleep(s)
        self.now += s

    def __getattr__(self, name):
        return getattr(time, name)


def _run_variant(mod, pkg, fn_name, kwargs, tmp, mode, loose, observe,
                 step_clock=False):
    builtins = {"tmp_path": tmp}
    with pytest.MonkeyPatch.context() as mp:
        builtins["monkeypatch"] = mp
        if mode == "turbo":
            for k, v in TURBO_ENV.items():
                mp.setenv(k, v)
        rec = Recorder(pkg, mp)
        if step_clock:
            clock = StepClock()
            mp.setattr(importlib.import_module(f"{pkg}.common.health"),
                       "time", clock)
            mp.setattr(mod, "time", clock)
        observed = {}
        if observe is not None:
            observe(mod, mp, observed)
        run = _Run(mod, builtins)
        try:
            run.autouse()
            fn = getattr(mod, fn_name)
            args = {}
            for a in inspect.signature(fn).parameters:
                args[a] = kwargs[a] if a in kwargs else run.value(a)
            fn(**args)
            view = rec.view(loose)
            view["searches"] = rec.searches
            view["observed"] = {k: v() for k, v in observed.items()}
        finally:
            run.close()
    return view


def twin_suite(suite: str, ns: dict, only=None, skip=(), modes=(),
               loose=None, port_only=None, observe=None,
               step_clock=()) -> None:
    """Add the twin of each test of tests/test_<suite>.py to `ns` (the
    test module's globals). `only` / `skip` select cases by name, `modes`
    maps a case name to extra modes ("turbo"), `loose` maps a case name to
    the reason its runs race (only the final cluster states are compared),
    `port_only` to the reason nothing of its runs can be compared (only
    the port runs it, under the reference's assertions), `step_clock`
    names the cases run on a StepClock, and `observe(mod, mp, observed)`
    hooks a suite's own observables (observed[name] = a callable read
    after the run)."""
    ref = load(suite, port=False)
    port = load(suite, port=True)
    modes = dict(modes)
    loose = dict(loose or {})
    port_only = dict(port_only or {})
    for name, fn in list(vars(ref).items()):
        if not (name.startswith("test_") and inspect.isfunction(fn)):
            continue
        if (only is not None and name not in only) or name in skip:
            continue
        ref_mod = None if name in port_only else ref
        opts = (name in loose, observe, name in step_clock)
        ns[name] = _make_twin(suite, ref_mod, port, name, fn, ("default",),
                              *opts)
        if name in modes:
            ns[f"{name}__turbo"] = _make_twin(suite, ref_mod, port, name, fn,
                                              ("turbo",), *opts)


def _make_twin(suite, ref, port, name, fn, modes, loose, observe,
               step_clock):
    # what pytest must supply: parametrize arguments and tmp_path; the
    # suite's own fixtures and monkeypatch are made per package here
    marks = list(getattr(fn, "pytestmark", []))
    param_names = set()
    for m in marks:
        if m.name == "parametrize":
            names = m.args[0]
            names = [s.strip() for s in names.split(",")] \
                if isinstance(names, str) else list(names)
            param_names.update(names)
    outer = sorted(param_names) + ["tmp_path"]
    (mode,) = modes

    def twin(**kw):
        tmp = kw.pop("tmp_path")
        (tmp / "ref").mkdir()
        (tmp / "port").mkdir()
        want = None if ref is None else _run_variant(
            ref, "elasticsearch_tpu", name, kw, tmp / "ref", mode, loose,
            observe, step_clock)
        got = _run_variant(port, "elasticsearch_tpu_torch", name, kw,
                           tmp / "port", mode, loose, observe, step_clock)
        if want is not None:
            _compare(want, got, mode == "turbo", loose)

    twin.__name__ = name if mode == "default" else f"{name}__{mode}"
    twin.__qualname__ = twin.__name__
    twin.__doc__ = (f"tests/test_{suite}.py::{name} on both packages"
                    + (" (Turbo)" if mode == "turbo" else ""))
    twin.__signature__ = inspect.Signature(
        [inspect.Parameter(a, inspect.Parameter.KEYWORD_ONLY)
         for a in outer])
    twin.pytestmark = marks
    return twin
