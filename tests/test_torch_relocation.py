"""tests/test_relocation.py on both packages (torch_cluster_twin).

The rolling maintenance plane: shard relocation with the warm device
handoff, node drain, delayed allocation, rebalancing, on `form_local_cluster(..., device="cpu")` and on the
reference: the reference's assertions on both runs, then equal cluster
states, engine histories and search answers.

The two warm-handoff cases (`test_warm_handoff_primes_target`,
`test_rpc_relocation_fault_leaves_move_correct_but_cold`) also compare
the device state each package leaves behind (`observe`): the relocation
counters but the wall clock, the hot dispatch shapes of the compile books
(what a source hands its target), and, per node and shard copy, each
field engine the copy's serving snapshot built, with its kind and its
dispatch ladder (what the handoff primed). Each run starts from empty
compile books.
"""

import importlib

from torch_cluster_twin import twin_suite

WARM_CASES = ("test_warm_handoff_primes_target",
              "test_rpc_relocation_fault_leaves_move_correct_but_cold")


def _device_state(nodes) -> dict:
    out = {}
    for node in nodes:
        svc = getattr(node, "shard_service", None)
        for (index, sid), inst in sorted(getattr(svc, "shards", {}).items()):
            ctx = getattr(inst, "_serving_ctx", None)
            snap = getattr(ctx, "_snapshot", None) if ctx else None
            fields = {}
            for field, eng in sorted(getattr(snap, "_bm", {}).items()):
                fields[field] = None if eng is None else (
                    type(eng).__name__,
                    tuple(getattr(eng, "qc_sizes", ())))
            out[f"{node.node_name}/{index}/{sid}"] = fields
    return out


def _observe_device(mod, mp, observed):
    pkg = mod.__name__.startswith("_twin_port") and \
        "elasticsearch_tpu_torch" or "elasticsearch_tpu"
    node_mod = importlib.import_module(f"{pkg}.cluster_node")
    ledger = importlib.import_module(f"{pkg}.common.hbm_ledger")
    reloc = importlib.import_module(f"{pkg}.common.relocation")
    nodes = []
    init = node_mod.ClusterNode.__init__

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        nodes.append(self)

    mp.setattr(node_mod.ClusterNode, "__init__", recorded)
    # the compile books are the process's: start this run's empty, so
    # earlier tests of the worker leave no shapes behind
    ledger.reset_for_tests()
    observed["relocation"] = lambda: {
        k: v for k, v in reloc.relocation_stats().items() if k != "warm_ms"}
    observed["hot_shapes"] = ledger.hot_shapes
    observed["device_state"] = lambda: _device_state(nodes)


twin_suite("relocation", globals(), skip=WARM_CASES)
twin_suite("relocation", globals(), only=WARM_CASES,
           observe=_observe_device)
