"""Distributed search's coordinator counters (the port's copy of the
`tpu_coordinator` books of elasticsearch_tpu/action/search_action.py).

The reference module is the query-then-fetch scatter-gather over the
transport: shard query fan-out, failover to the next-best copy, bounded
coordinator memory and the fetch of winning docs. It imports the shard
service at its top, so its coordinator comes with the cluster path
(ROADMAP item 10a). What the REST node needs now is the counters that
`GET /_nodes/stats` renders as `tpu_coordinator`; a standalone node never
bumps them, so they stay at zero until the coordinator lands.
"""

from __future__ import annotations

import threading
from typing import Dict

# ---- coordinator resilience counters (node-wide; `tpu_coordinator`
#      section of GET /_nodes/stats) ----

_COORD_LOCK = threading.Lock()
_COORD_COUNTERS: Dict[str, int] = {  # guarded by: _COORD_LOCK
    "shard_retries": 0,        # failover attempts on a next-best copy
    "node_circuit_open": 0,    # candidates skipped on an open node circuit
    "rpc_timeouts": 0,         # RPCs abandoned past their deadline
    "fetch_failures": 0,       # shards dropped in the fetch phase
    "can_match_reroutes": 0,   # pre-filter targets demoted as unreachable
    "deadline_expired": 0,     # shards not attempted: request deadline hit
    "overload_reroutes": 0,    # rankings where a pressured copy was demoted
}


def _count_coord(key: str, n: int = 1) -> None:
    with _COORD_LOCK:
        _COORD_COUNTERS[key] += n


def coordinator_stats() -> dict:
    """`tpu_coordinator` stats: resilience counters + transport circuits."""
    from elasticsearch_tpu_torch.common.health import node_transport_health_stats

    with _COORD_LOCK:
        out: dict = dict(_COORD_COUNTERS)
    out["transport"] = node_transport_health_stats()
    return out
