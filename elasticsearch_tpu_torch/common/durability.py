"""Node-wide write-path durability counters.

One module-level counter dict — the same pattern as the coordinator's
resilience counters in action/search_action.py — feeds the
``tpu_durability`` section of GET /_nodes/stats so the write-path fault
ladder is observable: translog fsync failures, replication retries,
recoveries started/failed/retried, translog replays, ghost-tracking
cleanups (ref: the reference exposes the analogous signals across
index/translog stats, RecoveryStats and indices/recovery responses; here
one flat section keeps a chaos run auditable with a single GET).

Open translogs also register here (weakly) so the async-durability
exposure window — ops appended since the last fsync — is visible live,
not only after a crash proves it mattered.

The port's copy of elasticsearch_tpu/common/durability.py.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict

_DURABILITY_LOCK = threading.Lock()
_DURABILITY_COUNTERS: Dict[str, int] = {  # guarded by: _DURABILITY_LOCK
    # translog / commit durability
    "fsync_failures": 0,            # translog fsyncs that raised
    "translog_syncs": 0,            # successful explicit/periodic fsyncs
    "translog_corruptions": 0,      # records appended with a broken CRC
    "segment_commit_failures": 0,   # flush() commits that raised
    "translog_replays": 0,          # crash recoveries that replayed the log
    "translog_replayed_ops": 0,     # ops re-applied by those replays
    # replication
    "replication_retries": 0,       # transient replica-RPC retries
    "replication_failures": 0,      # replica copies failed to the master
    "fsync_shard_failures": 0,      # primary copies failed on broken WAL
    # peer recovery
    "recoveries_started": 0,
    "recoveries_failed": 0,
    "recoveries_retried": 0,
    "ghost_cleanups": 0,            # stale recovery tracking removed
    "store_corruptions_discarded": 0,  # corrupt replica stores quarantined
}

# open translogs, for the live ops-since-sync gauge
_TRANSLOGS: "weakref.WeakSet" = weakref.WeakSet()


def count(key: str, n: int = 1) -> None:
    with _DURABILITY_LOCK:
        _DURABILITY_COUNTERS[key] += n


def register_translog(translog) -> None:
    _TRANSLOGS.add(translog)


def durability_stats() -> dict:
    """The ``tpu_durability`` section of GET /_nodes/stats."""
    with _DURABILITY_LOCK:
        out = dict(_DURABILITY_COUNTERS)
    windows = [t.ops_since_sync for t in _TRANSLOGS]
    out["open_translogs"] = len(windows)
    out["max_ops_since_sync"] = max(windows, default=0)
    return out


def reset_for_tests() -> Dict[str, int]:
    """Zero every counter and return the previous values (test isolation)."""
    with _DURABILITY_LOCK:
        prev = dict(_DURABILITY_COUNTERS)
        for k in _DURABILITY_COUNTERS:
            _DURABILITY_COUNTERS[k] = 0
    return prev
