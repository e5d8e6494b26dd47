"""Node-level distributed shard management (the port's copy of
elasticsearch_tpu/indices/__init__.py).

The package exports the reference's names: `DistributedShardService`,
`ShardInstance`, `ShardNotFoundError` and `IndicesClusterStateService`.
They resolve lazily, through the module `__getattr__` below, where the
reference imports them eagerly, so importing one submodule
(``indices.rollover``) loads only that submodule.
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
