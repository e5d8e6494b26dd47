"""Shard replication: primary/replica groups with seqno-acked writes.

Re-designs the reference's replication template (ref:
action/support/replication/ReplicationOperation.java:99 — primary executes,
fans to every in-sync replica, collects acks, fails stale copies via the
master, advances the global checkpoint; index/seqno/ReplicationTracker.java
for the checkpoint algebra; indices/recovery/RecoverySourceHandler.java:139
for peer recovery) around the TPU engine:

  * writes execute on the primary engine, then replicate the seqno-stamped
    op to every in-sync copy through a pluggable channel (direct call in
    one process, transport action across nodes);
  * a failed replica is reported to the failure listener (the master's
    shard-failed path) and dropped from the in-sync set;
  * peer recovery = phase1 segment snapshot copy + phase2 ops replay above
    the snapshot's max seqno, then mark in-sync — writes concurrent with
    recovery flow to the new copy as soon as it is tracked, and the engine's
    per-doc seqno comparison makes replayed ops idempotent;
  * failover promotes a replica: bumps the primary term and resyncs copies
    above the global checkpoint (ref: index/shard/PrimaryReplicaSyncer.java).
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuError
from elasticsearch_tpu_torch.index.engine import EngineResult, InternalEngine
from elasticsearch_tpu_torch.index.seqno import NO_OPS_PERFORMED, ReplicationTracker


class ReplicationFailedError(ElasticsearchTpuError):
    status = 503
    error_type = "replication_failed_exception"


@dataclass
class ShardCopy:
    """One physical copy of the shard."""

    allocation_id: str
    node_id: str
    engine: InternalEngine


class ReplicationGroup:
    """Primary-side controller for one shard's copies."""

    def __init__(self, primary: ShardCopy,
                 on_replica_failure: Optional[Callable[[str, Exception], None]] = None):
        self._lock = threading.RLock()
        self.primary = primary
        self.tracker = ReplicationTracker(primary.allocation_id)
        self.tracker.mark_in_sync(primary.allocation_id)
        self.replicas: Dict[str, ShardCopy] = {}
        self.on_replica_failure = on_replica_failure or (lambda aid, e: None)

    # ---- write path (ref: ReplicationOperation.execute) ----

    def index(self, doc_id: str, source: dict, **kw) -> EngineResult:
        with self._lock:
            result = self.primary.engine.index(doc_id, source, **kw)
            self._replicate({"op": "index", "id": doc_id, "source": source,
                             "seq_no": result.seq_no,
                             "primary_term": result.primary_term})
            self._after_write()
            return result

    def delete(self, doc_id: str, **kw) -> EngineResult:
        with self._lock:
            result = self.primary.engine.delete(doc_id, **kw)
            self._replicate({"op": "delete", "id": doc_id,
                             "seq_no": result.seq_no,
                             "primary_term": result.primary_term})
            self._after_write()
            return result

    def _replicate(self, op: dict) -> None:
        in_sync = self.tracker.in_sync_ids
        tracked = {aid: c for aid, c in self.replicas.items()}
        for aid, copy in tracked.items():
            required = aid in in_sync
            try:
                self._apply_to_copy(copy, op)
                self.tracker.update_local_checkpoint(
                    aid, copy.engine.local_checkpoint)
            except Exception as e:  # noqa: BLE001 — any failure fails the copy
                self._fail_replica(aid, e)
                if required:
                    # in the reference the master confirms the failure before
                    # the write acks; here the listener is invoked inline
                    pass

    @staticmethod
    def _apply_to_copy(copy: ShardCopy, op: dict) -> None:
        term = op.get("primary_term")
        if op["op"] == "index":
            copy.engine.index(op["id"], op["source"], seq_no=op["seq_no"],
                              op_primary_term=term)
        else:
            copy.engine.delete(op["id"], seq_no=op["seq_no"],
                               op_primary_term=term)

    def _after_write(self) -> None:
        self.tracker.update_local_checkpoint(
            self.primary.allocation_id, self.primary.engine.local_checkpoint)

    def _fail_replica(self, allocation_id: str, error: Exception) -> None:
        self.replicas.pop(allocation_id, None)
        self.tracker.remove_tracking(allocation_id)
        self.on_replica_failure(allocation_id, error)

    # ---- peer recovery (ref: RecoverySourceHandler.recoverToTarget) ----

    def add_replica(self, copy: ShardCopy) -> None:
        """Recover a new copy and bring it in-sync.

        phase0: track the copy so concurrent writes reach it immediately;
        phase1: snapshot the primary's published segments and install them;
        phase2: replay ops above the snapshot's max seqno (the engine's
        stale-op checks make overlap with live writes idempotent);
        finalize: mark in-sync.
        """
        with self._lock:
            self.replicas[copy.allocation_id] = copy
            self.tracker.add_tracking(copy.allocation_id)

        # phase1: segment-file copy, modeled as a deep snapshot transfer
        term = self.primary.engine.primary_term
        snapshot_ops = self.primary.engine.changes_since(NO_OPS_PERFORMED)
        for op in snapshot_ops:
            self._apply_to_copy(copy, {"op": op["op"], "id": op["id"],
                                       "source": op.get("source"),
                                       "seq_no": op["seq_no"],
                                       "primary_term": term})
        # phase2: replay anything that arrived while phase1 streamed
        with self._lock:
            if copy.allocation_id not in self.replicas:
                # a concurrent write failed this copy during phase1 — do not
                # resurrect it into the in-sync set (its checkpoint would pin
                # the global checkpoint at -1 with no copy behind it)
                return
            gap_ops = self.primary.engine.changes_since(copy.engine.local_checkpoint)
            for op in gap_ops:
                self._apply_to_copy(copy, {"op": op["op"], "id": op["id"],
                                           "source": op.get("source"),
                                           "seq_no": op["seq_no"],
                                           "primary_term": term})
            copy.engine.refresh()
            # latest-op-per-doc replay collapses superseded seqnos; fill the
            # gaps so the copy's checkpoint reaches the replayed history's end
            copy.engine.fill_seqno_gaps(self.primary.engine.max_seq_no)
            self.tracker.update_local_checkpoint(
                copy.allocation_id, copy.engine.local_checkpoint)
            self.tracker.mark_in_sync(copy.allocation_id)

    # ---- failover (ref: IndexShard primary promotion + PrimaryReplicaSyncer) ----

    def promote(self, allocation_id: str) -> "ReplicationGroup":
        """Promote a replica to primary after primary loss. Returns the new
        group; remaining replicas resync from the new primary.

        Resync semantics (ref: index/shard/PrimaryReplicaSyncer.java + the
        replica engine reset to the global checkpoint): each survivor first
        adopts the new primary term — explicitly, so a fully-caught-up copy
        that replays zero ops is still fenced against the deposed primary —
        then rolls back any history above the old global checkpoint to the
        new primary's authoritative per-doc state, then replays the new
        primary's ops above that checkpoint."""
        with self._lock:
            gcp = self.tracker.global_checkpoint
            new_primary = self.replicas.pop(allocation_id)
            new_term = self.primary.engine.primary_term + 1
            new_primary.engine.advance_primary_term(new_term)
            # promotion fills seqno gaps so the new primary's checkpoint
            # reaches its max seqno (reference fills with no-ops)
            new_primary.engine.fill_seqno_gaps(new_primary.engine.max_seq_no)
            group = ReplicationGroup(new_primary, self.on_replica_failure)
            survivors = dict(self.replicas)
        for aid, copy in survivors.items():
            try:
                # fence FIRST: a late write from the deposed primary accepted
                # after docs_above would otherwise escape the rollback set
                copy.engine.advance_primary_term(new_term)
                divergent = copy.engine.docs_above(gcp)
                doc_states = {d: new_primary.engine.doc_resync_state(d)
                              for d in divergent}
                # a copy still catching up (tracked, not yet in-sync) may be
                # behind the global checkpoint — replay from wherever it is
                replay_from = min(gcp, copy.engine.local_checkpoint)
                resync_target_apply(
                    copy.engine, new_term, doc_states, replay_from,
                    new_primary.engine.changes_since(replay_from),
                    new_primary.engine.max_seq_no)
            except Exception as e:  # noqa: BLE001
                group.on_replica_failure(aid, e)
                continue
            group.replicas[aid] = copy
            group.tracker.add_tracking(aid)
            group.tracker.update_local_checkpoint(aid, copy.engine.local_checkpoint)
            group.tracker.mark_in_sync(aid)
        group._after_write()
        return group

    # ---- introspection ----

    @property
    def global_checkpoint(self) -> int:
        return self.tracker.global_checkpoint

    def copies(self) -> List[ShardCopy]:
        with self._lock:
            return [self.primary, *self.replicas.values()]


def resync_target_apply(engine: InternalEngine, new_term: int,
                        doc_states: Dict[str, Optional[dict]],
                        replay_from: int, ops: List[dict],
                        max_seq_no: int) -> None:
    """Target-side primary-replica resync: adopt the new term, roll back
    divergent docs to the new primary's authoritative per-doc state, replay
    its history above the rollback point, and make the result durable.

    Shared by the in-process ReplicationGroup.promote and the transport
    resync action (ref: index/shard/PrimaryReplicaSyncer.java + replica
    engine reset to the global checkpoint).

      * advance term first so even a zero-op resync fences the deposed
        primary;
      * rollback before replay so force_resync_doc's per-doc tombstones
        cannot clobber replayed newer ops;
      * relog + flush so a crash after resync recovers the resynced state,
        not the divergent one (divergent ops already flushed into committed
        segments sit below the committed checkpoint, out of translog-replay
        range — only a re-commit removes them durably).
    """
    engine.advance_primary_term(new_term)
    for doc_id, state in doc_states.items():
        engine.force_resync_doc(doc_id, state)
    engine.reset_local_checkpoint(replay_from)
    for op in ops:
        if op["op"] == "index":
            engine.index(op["id"], op.get("source"), seq_no=op["seq_no"],
                         op_primary_term=new_term)
        else:
            engine.delete(op["id"], seq_no=op["seq_no"],
                          op_primary_term=new_term)
    engine.fill_seqno_gaps(max_seq_no)
    engine.relog_above(replay_from)
    engine.flush()


def new_allocation_id() -> str:
    return uuid.uuid4().hex[:20]
