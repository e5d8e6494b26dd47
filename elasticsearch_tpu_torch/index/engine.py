"""InternalEngine: the per-shard write path and searcher view.

Re-designs the reference engine (ref: index/engine/InternalEngine.java:842
`index()`, :913 translog add, :1057 indexIntoLucene; LiveVersionMap for
versioned upserts; CombinedDeletionPolicy for commits) around immutable TPU
segments:

  * Writes parse into LuceneDocs, get a seqno from the LocalCheckpointTracker,
    go to the translog, and land in an in-memory indexing buffer.
  * refresh() freezes the buffer into a new immutable Segment (the analog of
    Lucene's flush to a new reader) and tombstones superseded copies in older
    segments via per-segment live masks — deletes never mutate a segment.
  * Versioning: internal versioning with optimistic concurrency via
    if_seq_no/if_primary_term (ref: VersionConflictEngineException paths).
  * flush() persists segments + a commit point; recovery replays the translog
    above the committed local checkpoint.
  * merge() compacts segments by rebuilding from live docs' _source (host
    recompaction; ref: ElasticsearchConcurrentMergeScheduler conceptually).

The searcher view is an immutable snapshot: (segments, live-mask copies)
pinned at refresh, like Lucene's point-in-time readers.

The port's copy of elasticsearch_tpu/index/engine.py. One device for the
whole path: `InternalEngine(..., device=None)` resolves it once through
`device.resolve` (the card unless the caller names the CPU; no card
raises `DeviceUnavailableError`), every segment it builds, loads, installs
or merges lives there, and the `EngineSearcher` it hands out carries it
for `search.execute_search`.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch import device as _device
from elasticsearch_tpu_torch.common import integrity
from elasticsearch_tpu_torch.common.durability import count as _count_durability
from elasticsearch_tpu_torch.common.errors import DocumentMissingError, VersionConflictError
from elasticsearch_tpu_torch.common.faults import corruption_fires, durability_fault_point
from elasticsearch_tpu_torch.common.integrity import SegmentCorruptedError
from elasticsearch_tpu_torch.index.segment import Segment, SegmentBuilder
from elasticsearch_tpu_torch.index.segment_io import (
    segment_from_blob, segment_to_blob, verify_blob,
)
from elasticsearch_tpu_torch.index.seqno import LocalCheckpointTracker, NO_OPS_PERFORMED
from elasticsearch_tpu_torch.index.translog import Translog, TranslogFsyncError
from elasticsearch_tpu_torch.mapper.mapper_service import MapperService


@dataclass
class EngineResult:
    doc_id: str
    version: int
    seq_no: int
    primary_term: int
    result: str  # created | updated | deleted | not_found


@dataclass
class SegmentView:
    """One segment plus its live mask frozen at snapshot time."""

    segment: Segment
    live: np.ndarray  # [n_docs] bool
    live_epoch: int   # increments when the mask changes; keys device cache


class EngineSearcher:
    """Point-in-time view over the engine's published segments, on the
    engine's device."""

    def __init__(self, views: List[SegmentView], device):
        self.views = views
        self.device = device

    @property
    def n_docs(self) -> int:
        return sum(int(v.live.sum()) for v in self.views)

    @property
    def max_docs(self) -> int:
        return sum(v.segment.n_docs for v in self.views)


@dataclass
class _VersionEntry:
    seq_no: int
    version: int
    deleted: bool
    # where the latest live copy lives: buffer or (segment_index, ordinal)
    in_buffer: bool = False
    seg_idx: int = -1
    ord: int = -1


class InternalEngine:
    def __init__(
        self,
        mapper_service: MapperService,
        data_path: Optional[str] = None,
        primary_term: int = 1,
        translog_durability: str = "request",
        device=None,
    ):
        self.device = _device.resolve(device)
        self.mapper = mapper_service
        self.primary_term = primary_term
        self.data_path = data_path
        self._lock = threading.RLock()
        self._seqno = LocalCheckpointTracker()
        self._versions: Dict[str, _VersionEntry] = {}  # LiveVersionMap analog
        self._buffer: Dict[str, tuple] = {}            # id -> (LuceneDoc, seq_no, version)
        self._buffer_order: List[str] = []
        self._segments: List[Segment] = []
        self._live: List[np.ndarray] = []
        self._live_epochs: List[int] = []
        self._next_seg_id = 0
        self._last_committed_checkpoint = NO_OPS_PERFORMED
        self._refresh_listeners: List = []
        # tragic-event latch (ref: Engine.failEngine): once the WAL failed
        # under this engine, no further write may be accepted — the copy is
        # failed via the master and replaced by a fresh instance
        self._failed_reason: Optional[str] = None
        if data_path is not None:
            os.makedirs(data_path, exist_ok=True)
            self.translog = Translog(os.path.join(data_path, "translog"), translog_durability)
            self.recover_from_disk()
        else:
            self.translog = None

    # ---------------- write path ----------------

    def index(
        self,
        doc_id: str,
        source: dict,
        *,
        seq_no: Optional[int] = None,
        if_seq_no: Optional[int] = None,
        if_primary_term: Optional[int] = None,
        op_type: str = "index",
        from_translog: bool = False,
        op_primary_term: Optional[int] = None,
    ) -> EngineResult:
        """Index or update one document (ref: InternalEngine.index:842)."""
        with self._lock:
            self._check_not_failed()
            self._check_op_term(op_primary_term)
            entry = self._versions.get(doc_id)
            exists = entry is not None and not entry.deleted
            if seq_no is not None and entry is not None and entry.seq_no >= seq_no:
                # replica/replay path: op is older than what we already hold
                # (ref: InternalEngine OpVsLuceneDocStatus.OP_STALE_OR_EQUAL)
                self._seqno.mark_processed(seq_no)
                return EngineResult(doc_id, entry.version, seq_no,
                                    self.primary_term, "noop")
            if if_seq_no is not None or if_primary_term is not None:
                cur_seq = entry.seq_no if entry else NO_OPS_PERFORMED
                if not exists or cur_seq != if_seq_no or self.primary_term != if_primary_term:
                    raise VersionConflictError(
                        f"[{doc_id}]: version conflict, required seqNo [{if_seq_no}], "
                        f"primary term [{if_primary_term}], current document has seqNo [{cur_seq}]"
                    )
            if op_type == "create" and exists:
                raise VersionConflictError(
                    f"[{doc_id}]: version conflict, document already exists "
                    f"(current version [{entry.version}])"
                )
            doc = self.mapper.parse(doc_id, source)
            seq = seq_no if seq_no is not None else self._seqno.generate_seq_no()
            version = (entry.version + 1) if entry is not None else 1
            # tombstone a previous published copy
            if entry is not None and not entry.in_buffer and entry.seg_idx >= 0:
                self._tombstone(entry.seg_idx, entry.ord)
            self._buffer[doc_id] = (doc, seq, version)
            if not (entry is not None and entry.in_buffer):
                self._buffer_order.append(doc_id)
            self._versions[doc_id] = _VersionEntry(seq_no=seq, version=version, deleted=False, in_buffer=True)
            if self.translog is not None and not from_translog:
                self._translog_add(
                    {"op": "index", "id": doc_id, "seq_no": seq,
                     "primary_term": self.primary_term, "version": version, "source": source}
                )
            self._seqno.mark_processed(seq)
            return EngineResult(doc_id, version, seq, self.primary_term,
                                "updated" if exists else "created")

    def delete(
        self,
        doc_id: str,
        *,
        seq_no: Optional[int] = None,
        if_seq_no: Optional[int] = None,
        if_primary_term: Optional[int] = None,
        from_translog: bool = False,
        op_primary_term: Optional[int] = None,
    ) -> EngineResult:
        with self._lock:
            self._check_not_failed()
            self._check_op_term(op_primary_term)
            entry = self._versions.get(doc_id)
            exists = entry is not None and not entry.deleted
            if seq_no is not None and entry is not None and entry.seq_no >= seq_no:
                self._seqno.mark_processed(seq_no)
                return EngineResult(doc_id, entry.version, seq_no,
                                    self.primary_term, "noop")
            if if_seq_no is not None or if_primary_term is not None:
                cur_seq = entry.seq_no if entry else NO_OPS_PERFORMED
                if not exists or cur_seq != if_seq_no or self.primary_term != if_primary_term:
                    raise VersionConflictError(
                        f"[{doc_id}]: version conflict on delete, required seqNo [{if_seq_no}]"
                    )
            seq = seq_no if seq_no is not None else self._seqno.generate_seq_no()
            if not exists:
                if seq_no is not None:
                    # replica path: record the tombstone so a stale index op
                    # arriving later cannot resurrect the doc
                    self._versions[doc_id] = _VersionEntry(
                        seq_no=seq, version=(entry.version + 1) if entry else 1,
                        deleted=True)
                self._seqno.mark_processed(seq)
                return EngineResult(doc_id, entry.version if entry else 1, seq,
                                    self.primary_term, "not_found")
            version = entry.version + 1
            if entry.in_buffer:
                self._buffer.pop(doc_id, None)
                if doc_id in self._buffer_order:
                    self._buffer_order.remove(doc_id)
            elif entry.seg_idx >= 0:
                self._tombstone(entry.seg_idx, entry.ord)
            self._versions[doc_id] = _VersionEntry(seq_no=seq, version=version, deleted=True)
            if self.translog is not None and not from_translog:
                self._translog_add({"op": "delete", "id": doc_id, "seq_no": seq,
                                    "primary_term": self.primary_term, "version": version})
            self._seqno.mark_processed(seq)
            return EngineResult(doc_id, version, seq, self.primary_term, "deleted")

    def _check_not_failed(self) -> None:  # tpulint: holds=_lock
        if self._failed_reason is not None:
            raise TranslogFsyncError(
                f"engine failed [{self._failed_reason}]; the shard copy "
                f"must be reallocated, not written to")

    def _translog_add(self, op: dict) -> None:  # tpulint: holds=_lock
        """Append one op to the WAL; a failed fsync is a tragic event: the
        engine latches failed so no later write can be acked into a WAL
        that already lost a record (ref: InternalEngine failOnTragicEvent).
        The in-memory effect of THIS op stays — it was never acked, and a
        write surviving unacked is the safe direction."""
        try:
            self.translog.add(op)
        except TranslogFsyncError as e:
            self._failed_reason = str(e)
            raise

    @property
    def failed_reason(self) -> Optional[str]:
        return self._failed_reason

    def _check_op_term(self, op_primary_term: Optional[int]) -> None:
        """Primary-term fencing on the replica path (ref: IndexShard
        acquireReplicaOperationPermit — ops from a deposed primary are
        rejected; a newer term is adopted)."""
        if op_primary_term is None:
            return
        if op_primary_term < self.primary_term:
            raise VersionConflictError(
                f"operation primary term [{op_primary_term}] is too old "
                f"(current [{self.primary_term}])")
        self.primary_term = op_primary_term

    def advance_primary_term(self, term: int) -> None:
        """Adopt a newer primary term (replica-side fencing bump on failover;
        ref: IndexShard.acquireReplicaOperationPermit term adoption). Happens
        explicitly during resync so fully-caught-up survivors — which replay
        zero ops — still reject the deposed primary's writes."""
        with self._lock:
            if term > self.primary_term:
                self.primary_term = term

    def docs_above(self, seq_no: int) -> List[str]:
        """Doc ids whose latest op is above seq_no (divergence candidates)."""
        with self._lock:
            return [d for d, e in self._versions.items() if e.seq_no > seq_no]

    def doc_resync_state(self, doc_id: str) -> Optional[dict]:
        """Authoritative latest state of one doc for primary-replica resync."""
        with self._lock:
            entry = self._versions.get(doc_id)
            if entry is None:
                return None
            if entry.deleted:
                return {"deleted": True, "seq_no": entry.seq_no, "version": entry.version}
            if entry.in_buffer:
                source = self._buffer[doc_id][0].source
            else:
                source = self._segments[entry.seg_idx].sources[entry.ord]
            return {"deleted": False, "seq_no": entry.seq_no,
                    "version": entry.version, "source": source}

    def force_resync_doc(self, doc_id: str, state: Optional[dict]) -> None:
        """Replace this copy's state for one doc with the new primary's
        authoritative state, discarding divergent local history — the per-doc
        form of the reference's engine rollback to the global checkpoint
        during primary-replica resync (ref: index/shard/IndexShard.java
        resetEngineToGlobalCheckpoint)."""
        with self._lock:
            entry = self._versions.get(doc_id)
            if entry is not None and state is not None \
                    and entry.seq_no == state["seq_no"] \
                    and entry.version == state["version"] \
                    and entry.deleted == state["deleted"]:
                return  # already identical — don't churn segments/caches
            if entry is not None and not entry.deleted:
                if entry.in_buffer:
                    self._buffer.pop(doc_id, None)
                    if doc_id in self._buffer_order:
                        self._buffer_order.remove(doc_id)
                elif entry.seg_idx >= 0:
                    self._tombstone(entry.seg_idx, entry.ord)
            if state is None:
                self._versions.pop(doc_id, None)
            elif state["deleted"]:
                self._versions[doc_id] = _VersionEntry(
                    seq_no=state["seq_no"], version=state["version"], deleted=True)
            else:
                doc = self.mapper.parse(doc_id, state["source"])
                self._buffer[doc_id] = (doc, state["seq_no"], state["version"])
                self._buffer_order.append(doc_id)
                self._versions[doc_id] = _VersionEntry(
                    seq_no=state["seq_no"], version=state["version"],
                    deleted=False, in_buffer=True)

    def reset_local_checkpoint(self, seq_no: int) -> None:
        """Rebuild the seqno tracker at a rollback point, discarding marks
        from a divergent history (resync resets to the global checkpoint).
        The translog is trimmed at the same point so crash recovery cannot
        resurrect the divergent tail."""
        with self._lock:
            self._seqno = LocalCheckpointTracker(max_seq_no=seq_no, local_checkpoint=seq_no)
            if self.translog is not None:
                self.translog.trim_above(seq_no)

    def fill_seqno_gaps(self, up_to: int) -> None:
        """Advance the local checkpoint over seqnos collapsed away by
        latest-op-per-doc replay (ops-based recovery / promotion no-op fill)."""
        with self._lock:
            self._seqno.fast_forward(up_to)

    def relog_above(self, seq_no: int) -> None:
        """Re-append the current op of every doc above seq_no to the translog.

        After a resync trim, replayed ops can no-op against already-identical
        in-memory entries (the stale-seqno check fires before translog.add),
        leaving acked writes with no durable record. Re-logging the surviving
        state above the trim point restores crash-recovery coverage."""
        with self._lock:
            if self.translog is None:
                return
            entries = sorted((e.seq_no, d) for d, e in self._versions.items()
                             if e.seq_no > seq_no)
            for _, doc_id in entries:
                entry = self._versions[doc_id]
                if entry.deleted:
                    self.translog.add({"op": "delete", "id": doc_id,
                                       "seq_no": entry.seq_no,
                                       "primary_term": self.primary_term,
                                       "version": entry.version})
                else:
                    if entry.in_buffer:
                        source = self._buffer[doc_id][0].source
                    else:
                        source = self._segments[entry.seg_idx].sources[entry.ord]
                    self.translog.add({"op": "index", "id": doc_id,
                                       "seq_no": entry.seq_no,
                                       "primary_term": self.primary_term,
                                       "version": entry.version, "source": source})

    def _tombstone(self, seg_idx: int, ord_: int) -> None:
        self._live[seg_idx][ord_] = False
        self._live_epochs[seg_idx] += 1

    # ---------------- reads ----------------

    def get(self, doc_id: str) -> Optional[dict]:
        """Realtime get (ref: InternalEngine.get — reads from the version map /
        translog before refresh makes the doc searchable)."""
        with self._lock:
            entry = self._versions.get(doc_id)
            if entry is None or entry.deleted:
                return None
            if entry.in_buffer:
                doc, seq, version = self._buffer[doc_id]
                return {"_id": doc_id, "_version": version, "_seq_no": seq,
                        "_primary_term": self.primary_term, "_source": doc.source}
            seg = self._segments[entry.seg_idx]
            return {"_id": doc_id, "_version": entry.version, "_seq_no": entry.seq_no,
                    "_primary_term": self.primary_term, "_source": seg.sources[entry.ord]}

    def changes_since(self, min_seq_no: int) -> List[dict]:
        """Operation history above a seqno, latest op per doc, seqno-ordered
        (ref: index/engine/LuceneChangesSnapshot.java — ops-based peer
        recovery and CCR read from the index's retained history; here the
        version map + segments retain the latest op for every doc including
        tombstones)."""
        with self._lock:
            ops = []
            for doc_id, entry in self._versions.items():
                if entry.seq_no <= min_seq_no:
                    continue
                if entry.deleted:
                    ops.append({"op": "delete", "id": doc_id, "seq_no": entry.seq_no,
                                "version": entry.version})
                else:
                    if entry.in_buffer:
                        source = self._buffer[doc_id][0].source
                    else:
                        source = self._segments[entry.seg_idx].sources[entry.ord]
                    ops.append({"op": "index", "id": doc_id, "seq_no": entry.seq_no,
                                "version": entry.version, "source": source})
            ops.sort(key=lambda o: o["seq_no"])
            return ops

    def acquire_searcher(self) -> EngineSearcher:
        with self._lock:
            views = [
                SegmentView(segment=s, live=self._live[i].copy(), live_epoch=self._live_epochs[i])
                for i, s in enumerate(self._segments)
            ]
            return EngineSearcher(views, self.device)

    def searcher_version(self) -> tuple:
        """Cheap identity of what acquire_searcher would return — no live-mask
        copies. Serving-snapshot caches key on this (ref: Lucene reader
        version as used by the shard request cache)."""
        with self._lock:
            # seg_id is engine-unique and never recycled (unlike id()):
            # cache keys built from it cannot alias a GC'd segment
            return tuple((s.seg_id, self._live_epochs[i])
                         for i, s in enumerate(self._segments))

    # ---------------- refresh / flush / merge ----------------

    def refresh(self) -> bool:
        """Freeze the indexing buffer into a new searchable segment."""
        with self._lock:
            if not self._buffer_order:
                return False
            builder = SegmentBuilder(seg_id=self._next_seg_id,
                                     device=self.device)
            ords: Dict[str, int] = {}
            for doc_id in self._buffer_order:
                if doc_id not in self._buffer:
                    continue
                doc, seq, version = self._buffer[doc_id]
                ords[doc_id] = builder.add(doc, seq_no=seq, version=version)
            segment = builder.build()
            seg_idx = len(self._segments)
            self._segments.append(segment)
            self._live.append(np.ones(segment.n_docs, bool))
            self._live_epochs.append(0)
            self._next_seg_id += 1
            for doc_id, ord_ in ords.items():
                entry = self._versions[doc_id]
                entry.in_buffer = False
                entry.seg_idx = seg_idx
                entry.ord = ord_
            self._buffer.clear()
            self._buffer_order.clear()
            return True

    def flush(self) -> None:
        """Commit: persist segments + metadata, roll translog generation.

        Ref: InternalEngine.flush — Lucene commit + translog rollover. Segment
        payloads are data-only array blobs (the segment IS the checkpoint;
        segment_io replaces pickle so on-disk state is never
        executable on load — ADVICE r3)."""
        if self.data_path is None:
            return
        with self._lock:
            try:
                durability_fault_point("segment_commit")
            except OSError:
                # a failed commit loses nothing durable: the previous commit
                # point + translog tail still recover every op
                _count_durability("segment_commit_failures")
                raise
            self.refresh()
            seg_dir = os.path.join(self.data_path, "segments")
            os.makedirs(seg_dir, exist_ok=True)
            names = []
            for i, seg in enumerate(self._segments):
                name = f"seg-{seg.seg_id}.seg"
                path = os.path.join(seg_dir, name)
                if not os.path.exists(path):
                    with open(path + ".tmp", "wb") as f:
                        f.write(segment_to_blob(seg))
                    os.replace(path + ".tmp", path)
                names.append({"file": name, "live": self._live[i].tolist()})
            gen = self.translog.rollover()
            commit = {
                "segments": names,
                "local_checkpoint": self._seqno.checkpoint,
                "max_seq_no": self._seqno.max_seq_no,
                "translog_generation": gen,
                "primary_term": self.primary_term,
            }
            tmp = os.path.join(self.data_path, "commit.json.tmp")
            with open(tmp, "w") as f:
                json.dump(commit, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.data_path, "commit.json"))
            self._last_committed_checkpoint = self._seqno.checkpoint
            self.translog.trim_below(gen)

    def recover_from_disk(self) -> None:
        """Crash recovery: load committed segments, replay translog tail
        (ref: index/shard/StoreRecovery.java + translog replay). Called
        from __init__ and by the crash-restart harness's reopened nodes."""
        commit_path = os.path.join(self.data_path, "commit.json")
        committed_cp = NO_OPS_PERFORMED
        if os.path.exists(commit_path):
            with open(commit_path) as f:
                commit = json.load(f)
            committed_cp = commit["local_checkpoint"]
            self.primary_term = max(self.primary_term, commit.get("primary_term", 1))
            self._seqno = LocalCheckpointTracker(
                max_seq_no=commit["max_seq_no"], local_checkpoint=committed_cp
            )
            seg_dir = os.path.join(self.data_path, "segments")
            for meta in commit["segments"]:
                seg: Segment = self._load_committed_segment(seg_dir, meta)
                seg_idx = len(self._segments)
                live = np.asarray(meta["live"], bool)
                self._segments.append(seg)
                self._live.append(live)
                self._live_epochs.append(0)
                self._next_seg_id = max(self._next_seg_id, seg.seg_id + 1)
                for ord_, doc_id in enumerate(seg.doc_ids):
                    if live[ord_]:
                        self._versions[doc_id] = _VersionEntry(
                            seq_no=int(seg.seq_nos[ord_]), version=int(seg.versions[ord_]),
                            deleted=False, in_buffer=False, seg_idx=seg_idx, ord=ord_,
                        )
                        self._seqno.mark_processed(int(seg.seq_nos[ord_]))
        # replay translog tail
        replayed = 0
        for op in self.translog.read_ops(min_seq_no=committed_cp):
            if op["op"] == "index":
                self.index(op["id"], op["source"], seq_no=op["seq_no"], from_translog=True)
            else:
                self.delete(op["id"], seq_no=op["seq_no"], from_translog=True)
            replayed += 1
        if replayed:
            _count_durability("translog_replays")
            _count_durability("translog_replayed_ops", replayed)

    # ---------------- integrity: at-rest verification ----------------

    def _load_committed_segment(self, seg_dir: str, meta: dict) -> Segment:
        """Read + verify one committed blob. The `segment_read` corruption
        site flips a bit in the bytes as read (bit rot between commit and
        reload); the footer verify inside `segment_from_blob` must catch
        it — a failure drops a ``corrupted-*`` marker so the copy cannot
        be reused before a fresh recovery overwrites the store."""
        with open(os.path.join(seg_dir, meta["file"]), "rb") as f:
            blob = f.read()
        if corruption_fires(meta["file"], site="segment_read"):
            blob = integrity.bitflip(blob)
        try:
            return segment_from_blob(blob, self.device)
        except SegmentCorruptedError as e:
            integrity.write_corruption_marker(
                self.data_path, str(e), segment=meta["file"])
            raise

    def verify_store(self) -> int:
        """Full-store checksum scan (the ES_TPU_CHECK_ON_STARTUP leg, ref:
        index.shard.check_on_startup): re-read every committed blob and
        verify its footer WITHOUT rebuilding segments. Returns the number
        of blobs checked; the first failure writes a ``corrupted-*``
        marker and raises `SegmentCorruptedError`."""
        if self.data_path is None:
            return 0
        commit_path = os.path.join(self.data_path, "commit.json")
        if not os.path.exists(commit_path):
            return 0
        with open(commit_path) as f:
            commit = json.load(f)
        seg_dir = os.path.join(self.data_path, "segments")
        checked = 0
        for meta in commit["segments"]:
            with open(os.path.join(seg_dir, meta["file"]), "rb") as f:
                blob = f.read()
            if corruption_fires(meta["file"], site="segment_read"):
                blob = integrity.bitflip(blob)
            try:
                verify_blob(blob)
            except SegmentCorruptedError as e:
                integrity.write_corruption_marker(
                    self.data_path, str(e), segment=meta["file"])
                raise
            checked += 1
        return checked

    # ---------------- peer-recovery snapshot transfer ----------------

    def segment_payloads(self) -> tuple:
        """File-phase recovery source: freeze the buffer, then hand out each
        published segment with its live mask (ref:
        indices/recovery/RecoverySourceHandler.java:267 phase1 — segment
        files are the recovery snapshot; here the segment IS the file).
        Returns ([(segment blob bytes, live mask)], max_seq_no)."""
        with self._lock:
            self.refresh()
            # segments are immutable once published: snapshot the references
            # and mask copies under the lock, serialize OUTSIDE it so a
            # large phase1 transfer does not stall indexing on the source
            snapshot = [(seg, self._live[i].copy())
                        for i, seg in enumerate(self._segments)]
            max_seq_no = self._seqno.max_seq_no
        payloads = [(segment_to_blob(seg), live) for seg, live in snapshot]
        return payloads, max_seq_no

    def install_segment(self, blob: bytes, live_mask) -> None:
        """File-phase recovery target: install one transferred segment
        (ref: indices/recovery/MultiFileWriter.java writes phase1 files).
        Ops-phase replay above the snapshot's seqnos follows separately."""
        with self._lock:
            seg: Segment = segment_from_blob(blob, self.device)
            seg_idx = len(self._segments)
            live = np.asarray(live_mask, bool)
            # remap to a locally-assigned seg id: the source's id can collide
            # with a locally-refreshed segment's id, and flush()'s
            # dedup-by-filename would then commit one payload under both
            seg.seg_id = self._next_seg_id
            self._segments.append(seg)
            self._live.append(live.copy())
            self._live_epochs.append(0)
            self._next_seg_id += 1
            for ord_, doc_id in enumerate(seg.doc_ids):
                if not live[ord_]:
                    continue
                seq = int(seg.seq_nos[ord_])
                prev = self._versions.get(doc_id)
                if prev is not None and prev.seq_no >= seq:
                    # a live write that raced ahead of the transfer wins;
                    # hide the stale installed copy
                    self._live[seg_idx][ord_] = False
                    self._live_epochs[seg_idx] += 1
                    continue
                if prev is not None and not prev.deleted:
                    if prev.in_buffer:
                        self._buffer.pop(doc_id, None)
                        if doc_id in self._buffer_order:
                            self._buffer_order.remove(doc_id)
                    elif prev.seg_idx >= 0:
                        self._tombstone(prev.seg_idx, prev.ord)
                self._versions[doc_id] = _VersionEntry(
                    seq_no=seq, version=int(seg.versions[ord_]),
                    deleted=False, in_buffer=False, seg_idx=seg_idx, ord=ord_)
                self._seqno.mark_processed(seq)

    def force_merge(self, max_num_segments: int = 1) -> None:
        """Compact segments by RECOMBINING columnar data (ref: Lucene
        SegmentMerger — postings/doc values concatenate with ord remaps;
        no _source re-parse, no re-analysis, so merging is O(postings)
        array work instead of O(corpus re-analysis))."""
        from elasticsearch_tpu_torch.index.segment import merge_segments

        with self._lock:
            self.refresh()
            if len(self._segments) <= max_num_segments:
                return
            merged = merge_segments(self._segments, self._live,
                                    seg_id=self._next_seg_id,
                                    device=self.device)
            self._segments = [merged]
            self._live = [np.ones(merged.n_docs, bool)]
            self._live_epochs = [0]
            self._next_seg_id += 1
            for ord_, doc_id in enumerate(merged.doc_ids):
                entry = self._versions.get(doc_id)
                if entry is not None and not entry.in_buffer:
                    entry.seg_idx = 0
                    entry.ord = ord_

    # ---------------- stats ----------------

    @property
    def local_checkpoint(self) -> int:
        return self._seqno.checkpoint

    @property
    def max_seq_no(self) -> int:
        return self._seqno.max_seq_no

    @property
    def seqno_tracker(self) -> LocalCheckpointTracker:
        return self._seqno

    def doc_count(self) -> int:
        with self._lock:
            n = sum(int(l.sum()) for l in self._live)
            n += len([d for d in self._buffer_order if d in self._buffer])
            return n

    def segment_count(self) -> int:
        return len(self._segments)

    def close(self) -> None:
        if self.translog is not None:
            self.translog.close()
