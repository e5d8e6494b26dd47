"""Durable coordination state: term, vote, accepted cluster state.

The reference persists consensus-critical state in a local Lucene index
(ref: gateway/PersistedClusterStateService.java:111, GatewayMetaState.java:68)
so a restarted node cannot vote twice in one term or forget an accepted-but-
uncommitted publication. Here the same contract is a fsynced JSON document
with atomic replace — the state is small (term, vote, one cluster state) and
write frequency is election/publication cadence, not the data path.

The port's copy of elasticsearch_tpu/cluster/gateway.py, with one repair:
`store` runs under a lock. A live node persists from several transport
reply threads, and in the reference two of them can write the one
``.tmp`` file at once; the second rename then finds it gone, and the
`FileNotFoundError` kills that thread's election or publication round.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional


class PersistedCoordinationState:
    """Load/store one node's (current_term, join_vote_term, accepted state,
    last_committed_version)."""

    FILENAME = "_coordination_state.json"

    def __init__(self, data_path: Optional[str]):
        self.path = os.path.join(data_path, self.FILENAME) if data_path else None
        self._lock = threading.Lock()

    def load(self) -> Optional[dict]:
        if self.path is None or not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            return json.load(f)

    def store(self, doc: dict) -> None:
        if self.path is None:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with self._lock:
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            # fsync the directory so the rename itself is durable — without
            # it a crash can forget a cast vote, the exact contract this
            # module exists to provide (ref: gateway/
            # PersistedClusterStateService.java fsyncs the state directory
            # after commit)
            dir_fd = os.open(os.path.dirname(self.path), os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
