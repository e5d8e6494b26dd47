"""Node-level index management (the port's copy of
elasticsearch_tpu/indices/__init__.py).

The package's exports resolve lazily, through the module `__getattr__`
below, so importing one submodule (``indices.rollover``) loads only that
submodule. The reference imports `shard_service` and
`cluster_state_service` here eagerly; the port has neither yet (the
cluster path, ROADMAP item 10a), and naming one of their exports raises
the ModuleNotFoundError of its module.
"""

import importlib

_EXPORTS = {
    "DistributedShardService": "shard_service",
    "ShardInstance": "shard_service",
    "ShardNotFoundError": "shard_service",
    "IndicesClusterStateService": "cluster_state_service",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
