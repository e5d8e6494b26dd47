"""Node-wide shard-relocation counters.

Same module-level pattern as ``common/durability.py``: one locked dict
feeding the ``tpu_relocation`` section of GET /_nodes/stats, so a rolling
maintenance window is auditable with a single GET — how many moves
committed, how many cancelled, and what the warm HBM handoff actually
primed (ref: the reference spreads the analogous signals across
_cat/recovery and allocation explain; here the TPU twist — compile-cache
priming ahead of shard-started — gets first-class counters).
"""

from __future__ import annotations

import threading
from typing import Dict

_RELOC_LOCK = threading.Lock()
_RELOC_COUNTERS: Dict[str, int] = {  # guarded by: _RELOC_LOCK
    "moves": 0,           # relocations committed (target started, source gone)
    "cancels": 0,         # relocations cancelled (target failed/died; source
                          # reverted to STARTED, still serving)
    "warm_handoffs": 0,    # targets that completed the warm HBM handoff
    "warm_ms": 0,          # wall ms spent warming (engine build + upload +
                           # qc-ladder priming) before shard-started
    "shapes_primed": 0,    # dispatch shapes primed via extend_qc_sizes
    "fields_warmed": 0,    # per-field engines built+uploaded ahead of serving
    "warm_failures": 0,    # warm handoffs that errored (relocation proceeds
                           # cold — warming is best-effort)
    "sparse_prewarms": 0,  # cold-term sparse slices rebuilt on the target
                           # from the source's hot term list
}


def count(key: str, n: int = 1) -> None:
    with _RELOC_LOCK:
        _RELOC_COUNTERS[key] += n


def relocation_stats() -> dict:
    """The ``tpu_relocation`` section of GET /_nodes/stats."""
    with _RELOC_LOCK:
        return dict(_RELOC_COUNTERS)


def reset_for_tests() -> Dict[str, int]:
    """Zero every counter and return the previous values (test isolation)."""
    with _RELOC_LOCK:
        prev = dict(_RELOC_COUNTERS)
        for k in _RELOC_COUNTERS:
            _RELOC_COUNTERS[k] = 0
    return prev
