"""Sequence-number machinery: local and global checkpoints.

Ports the reference's replication bookkeeping concepts
(ref: index/seqno/LocalCheckpointTracker.java — max contiguous processed
seqno; index/seqno/ReplicationTracker.java — global checkpoint = min local
checkpoint over the in-sync copy set, plus in-sync membership management).
The algebra is identical; only the implementation is Pythonic (sorted set of
pending seqnos above the checkpoint instead of bitset pages).

The port's copy of elasticsearch_tpu/index/seqno.py.
"""

from __future__ import annotations

import threading

NO_OPS_PERFORMED = -1
UNASSIGNED_SEQ_NO = -2


class LocalCheckpointTracker:
    def __init__(self, max_seq_no: int = NO_OPS_PERFORMED, local_checkpoint: int = NO_OPS_PERFORMED):
        self._lock = threading.Lock()
        self._next_seq_no = max_seq_no + 1
        self._checkpoint = local_checkpoint
        self._pending: set[int] = set()

    def generate_seq_no(self) -> int:
        with self._lock:
            seq = self._next_seq_no
            self._next_seq_no += 1
            return seq

    def mark_processed(self, seq_no: int) -> None:
        with self._lock:
            if seq_no <= self._checkpoint:
                return
            self._pending.add(seq_no)
            while self._checkpoint + 1 in self._pending:
                self._checkpoint += 1
                self._pending.remove(self._checkpoint)
            if seq_no >= self._next_seq_no:
                self._next_seq_no = seq_no + 1

    @property
    def checkpoint(self) -> int:
        return self._checkpoint

    @property
    def max_seq_no(self) -> int:
        return self._next_seq_no - 1

    def contains(self, seq_no: int) -> bool:
        with self._lock:
            return seq_no <= self._checkpoint or seq_no in self._pending

    def fast_forward(self, seq_no: int) -> None:
        """Mark every seqno <= seq_no processed in one step (the no-op gap
        fill the reference performs on primary promotion and at the end of
        ops-based recovery, where replayed history collapses superseded ops;
        ref: index/shard/IndexShard.java primary-promotion no-op fill)."""
        with self._lock:
            if seq_no > self._checkpoint:
                self._checkpoint = seq_no
                self._pending = {s for s in self._pending if s > seq_no}
                while self._checkpoint + 1 in self._pending:
                    self._checkpoint += 1
                    self._pending.remove(self._checkpoint)
            if seq_no >= self._next_seq_no:
                self._next_seq_no = seq_no + 1


class ReplicationTracker:
    """Primary-side global-checkpoint computation over in-sync copies.

    Ref: index/seqno/ReplicationTracker.java: global checkpoint advances to
    the min of local checkpoints of the in-sync set; copies join the set once
    caught up; stale copies are removed (master-driven in the reference).
    """

    def __init__(self, shard_allocation_id: str):
        self._lock = threading.Lock()
        self.allocation_id = shard_allocation_id
        self._local_checkpoints: dict[str, int] = {shard_allocation_id: NO_OPS_PERFORMED}
        self._in_sync: set[str] = {shard_allocation_id}
        self._global_checkpoint = NO_OPS_PERFORMED

    def update_local_checkpoint(self, allocation_id: str, checkpoint: int) -> None:
        with self._lock:
            prev = self._local_checkpoints.get(allocation_id, NO_OPS_PERFORMED)
            self._local_checkpoints[allocation_id] = max(prev, checkpoint)
            self._recompute()

    def add_tracking(self, allocation_id: str) -> None:
        with self._lock:
            self._local_checkpoints.setdefault(allocation_id, NO_OPS_PERFORMED)

    def mark_in_sync(self, allocation_id: str) -> None:
        with self._lock:
            self._local_checkpoints.setdefault(allocation_id, NO_OPS_PERFORMED)
            self._in_sync.add(allocation_id)
            self._recompute()

    def remove_tracking(self, allocation_id: str) -> None:
        with self._lock:
            self._local_checkpoints.pop(allocation_id, None)
            self._in_sync.discard(allocation_id)
            self._recompute()

    def _recompute(self) -> None:
        if self._in_sync:
            cp = min(self._local_checkpoints.get(a, NO_OPS_PERFORMED) for a in self._in_sync)
            # the global checkpoint never goes backwards
            self._global_checkpoint = max(self._global_checkpoint, cp) if cp != NO_OPS_PERFORMED else self._global_checkpoint

    @property
    def global_checkpoint(self) -> int:
        return self._global_checkpoint

    @property
    def in_sync_ids(self) -> set[str]:
        with self._lock:
            return set(self._in_sync)

    @property
    def tracked_ids(self) -> set[str]:
        """Every tracked copy, in-sync or still recovering — the superset a
        ghost-tracking cleanup must consult."""
        with self._lock:
            return set(self._local_checkpoints)
