"""Distributed shard instances: replicated writes, peer recovery, resync —
all over the transport.

This is the node-local half of the distributed spine. The reference spreads
it across IndexShard (op application, ref: index/shard/IndexShard.java:798
applyIndexOperationOnPrimary / :807 OnReplica), the replication template
(ref: action/support/replication/ReplicationOperation.java:99 — primary
executes, fans to in-sync replicas, collects acks, fails stale copies via
the master), peer recovery (ref:
indices/recovery/RecoverySourceHandler.java:139 recoverToTarget — file
phase1 + ops phase2 + finalize; PeerRecoveryTargetService.java), and the
primary-replica syncer (ref: index/shard/PrimaryReplicaSyncer.java). Here
one service owns the shard registry and registers every shard-level
transport action; the cluster-state applier (cluster_state_service.py)
drives lifecycle.

Recovery is TARGET-DRIVEN (pull): the new replica asks the primary to
track it, pulls the segment snapshot (the segment IS the recovery file),
replays the op tail, then finalizes. Pull keeps every step idempotent, so
an interrupted recovery simply restarts.

The port's copy of elasticsearch_tpu/indices/shard_service.py. Two
differences:

- ``DistributedShardService(..., device=None)`` resolves its device once
  (``device.resolve``: the card unless the caller names the CPU) and
  every shard copy's `InternalEngine` lives there, so the relocation
  handoff's `ServingContext` serves on the node's device.
- The warm handoff re-raises the port's kernel errors (`KernelBuildError`,
  `KernelLaunchError`): a kernel that does not build or launch is a fault
  of the port, not a cold relocation. Other errors stay best-effort and
  count as ``warm_failures``, as in the reference.
"""

from __future__ import annotations

import base64
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch import device as _device
from elasticsearch_tpu_torch.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.common import integrity
from elasticsearch_tpu_torch.common.durability import count as _count
from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuError, KernelBuildError, KernelLaunchError,
    VersionConflictError,
)
from elasticsearch_tpu_torch.common.faults import corruption_fires
from elasticsearch_tpu_torch.common.integrity import SegmentCorruptedError
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.cluster.state import ClusterState, IndexMetadata, ShardRouting
from elasticsearch_tpu_torch.index.engine import InternalEngine
from elasticsearch_tpu_torch.index.segment_io import blob_hash
from elasticsearch_tpu_torch.index.replication import resync_target_apply
from elasticsearch_tpu_torch.index.seqno import NO_OPS_PERFORMED, ReplicationTracker
from elasticsearch_tpu_torch.index.translog import (
    TranslogCorruptedError, TranslogFsyncError,
)
from elasticsearch_tpu_torch.mapper import MapperService
from elasticsearch_tpu_torch.transport.channels import (
    NodeChannels, NodeUnavailableError, RpcTimeoutError,
)
from elasticsearch_tpu_torch.transport.service import TransportService


def _ops_bytes(ops) -> int:
    """Byte estimate of a bulk ops payload for IndexingPressure accounting
    (source sizes dominate; metadata gets a flat allowance)."""
    import json as _json

    total = 0
    for op in ops:
        src = op.get("source")
        total += 64 + (len(_json.dumps(src)) if src is not None else 0)
    return total


class ShardNotFoundError(ElasticsearchTpuError):
    status = 404
    error_type = "shard_not_found_exception"


class PrimaryTermMismatchError(ElasticsearchTpuError):
    status = 409
    error_type = "illegal_index_shard_state_exception"


@dataclass
class ShardInstance:
    """One local shard copy (ref: index/shard/IndexShard.java state)."""

    index: str
    shard_id: int
    allocation_id: str
    primary: bool
    primary_term: int
    engine: InternalEngine
    mapper: MapperService
    tracker: Optional[ReplicationTracker] = None      # primary only
    # replica-side view of the primary's global checkpoint, refreshed on
    # every replicated write (ref: GlobalCheckpointSyncAction) — the
    # rollback point if this copy is promoted
    known_global_checkpoint: int = NO_OPS_PERFORMED
    state: str = "INITIALIZING"                       # mirrors routing state
    lock: threading.RLock = field(default_factory=threading.RLock)


def build_mapper(meta: IndexMetadata) -> MapperService:
    nested = meta.settings.as_nested_dict()
    try:
        analyzers = nested["index"]["analysis"]["analyzer"]
    except (KeyError, TypeError):
        analyzers = {}
    return MapperService(dict(meta.mappings), AnalysisRegistry(analyzers))


class DistributedShardService:
    """Registry of local shard copies + shard-level transport actions."""

    def __init__(self, node_name: str, transport: TransportService,
                 channels: NodeChannels,
                 master_client: Callable[[str, dict], dict],
                 data_path: Optional[str] = None,
                 indexing_pressure=None, thread_pool=None, tasks=None,
                 overload=None, device=None):
        self.node_name = node_name
        # every local shard copy's engine, and so its serving engines and
        # kernels, lives on this one device
        self.device = _device.resolve(device)
        self.transport = transport
        self.channels = channels
        self.master_client = master_client
        self.data_path = data_path
        # node TaskManager: primary-bulk handlers register child tasks
        # under the coordinator's `_parent_task` payload field when wired
        self.tasks = tasks
        # overload controller (common/overload.py): bulk-tier admission at
        # the primary-bulk handler + the replication retry budget
        self.overload = overload
        self.shards: Dict[Tuple[str, int], ShardInstance] = {}
        self.state: ClusterState = ClusterState()
        self._registry_lock = threading.Lock()
        from elasticsearch_tpu_torch.common.indexing_pressure import IndexingPressure
        from elasticsearch_tpu_torch.threadpool import ThreadPool

        # per-node write backpressure (ref: index/IndexingPressure.java) —
        # injectable so all of a node's stages share ONE budget
        self.indexing_pressure = indexing_pressure or IndexingPressure()
        # injectable for the same reason: the bulk stages execute on the
        # node's WRITE pool so a bulk storm is bounded by write workers
        # and cannot occupy the search stage (ref: ThreadPool.Names.WRITE)
        self.thread_pool = thread_pool or ThreadPool()
        t = transport
        t.register_request_handler(
            "indices:data/write/bulk[s]",
            lambda req: self.thread_pool.execute(
                "write", self._on_primary_bulk, req))
        t.register_request_handler(
            "indices:data/write/bulk[s][r]",
            lambda req: self.thread_pool.execute(
                "write", self._on_replica_bulk, req))
        t.register_request_handler("internal:index/shard/recovery/prepare",
                                   self._on_recovery_prepare)
        t.register_request_handler("internal:index/shard/recovery/segments",
                                   self._on_recovery_segments)
        t.register_request_handler("internal:index/shard/recovery/ops",
                                   self._on_recovery_ops)
        t.register_request_handler("internal:index/shard/recovery/finalize",
                                   self._on_recovery_finalize)
        t.register_request_handler("internal:index/shard/recovery/cancel",
                                   self._on_recovery_cancel)
        t.register_request_handler("internal:index/shard/resync/prepare",
                                   self._on_resync_prepare)
        t.register_request_handler("internal:index/shard/resync/apply",
                                   self._on_resync_apply)
        t.register_request_handler(
            "internal:index/shard/relocation/warm_info",
            self._on_relocation_warm_info)

    # ---------------- registry ----------------

    def get_shard(self, index: str, shard_id: int) -> ShardInstance:
        inst = self.shards.get((index, shard_id))
        if inst is None:
            raise ShardNotFoundError(
                f"no shard [{index}][{shard_id}] on node [{self.node_name}]")
        return inst

    def create_shard(self, meta: IndexMetadata,
                     routing: ShardRouting) -> ShardInstance:
        import os

        mapper = build_mapper(meta)
        path = None
        if self.data_path is not None:
            path = os.path.join(self.data_path, meta.index,
                                str(routing.shard_id))
        durability = meta.settings.raw("index.translog.durability", "request")
        marker = integrity.corruption_marker(path) if path else None
        if marker is not None:
            # a previous incarnation of this copy failed checksum
            # verification and dropped a corrupted-* marker: the store must
            # never serve again as-is. A replica quarantines it and
            # re-bootstraps via peer recovery; a primary assignment is
            # refused outright (the master must pick a healthy copy).
            if routing.primary:
                raise SegmentCorruptedError(
                    f"store [{path}] is marked corrupted: "
                    f"{marker.get('reason')}")
            self._quarantine_store(path)
        try:
            engine = InternalEngine(
                mapper, data_path=path,
                primary_term=meta.primary_term(routing.shard_id),
                translog_durability=durability, device=self.device)
        except (TranslogCorruptedError, SegmentCorruptedError):
            # a replica's store is expendable: quarantine the damaged dir and
            # re-bootstrap empty via peer recovery (ref: the reference drops
            # a corrupt replica store and recovers from the primary). A
            # primary has nothing to recover FROM — surface the corruption.
            if routing.primary or path is None:
                raise
            self._quarantine_store(path)
            engine = InternalEngine(
                mapper, data_path=path,
                primary_term=meta.primary_term(routing.shard_id),
                translog_durability=durability, device=self.device)
        inst = ShardInstance(
            index=meta.index, shard_id=routing.shard_id,
            allocation_id=routing.allocation_id, primary=routing.primary,
            primary_term=meta.primary_term(routing.shard_id),
            engine=engine, mapper=mapper)
        if routing.primary:
            inst.tracker = ReplicationTracker(routing.allocation_id)
            inst.tracker.update_local_checkpoint(
                routing.allocation_id, engine.local_checkpoint)
        with self._registry_lock:
            self.shards[(meta.index, routing.shard_id)] = inst
        return inst

    @staticmethod
    def _quarantine_store(path: str) -> None:
        """Move a damaged store (and its corrupted-* marker) aside so a
        fresh peer recovery can rebuild into a clean directory."""
        import os
        import shutil

        if not os.path.isdir(path):
            return
        shutil.rmtree(path + ".corrupt", ignore_errors=True)
        os.rename(path, path + ".corrupt")
        _count("store_corruptions_discarded")
        integrity.count("copies_quarantined")

    def remove_shard(self, index: str, shard_id: int) -> None:
        with self._registry_lock:
            inst = self.shards.pop((index, shard_id), None)
        if inst is not None:
            inst.engine.close()

    # ---------------- write path (primary side) ----------------

    def _overload_ctl(self):
        if self.overload is None:
            from elasticsearch_tpu_torch.common.overload import default_overload

            self.overload = default_overload()
        return self.overload

    def _on_primary_bulk(self, req) -> dict:
        from elasticsearch_tpu_torch.tasks import task_manager as _taskmgr

        p = req.payload
        # bulk-tier admission BEFORE any op is applied: a YELLOW node
        # sheds the whole shard-bulk with 429 + Retry-After; nothing was
        # written, nothing acked, so the coordinator can fail the items
        # cleanly (replica/recovery paths are never shed — they finish
        # work the primary already admitted)
        ov = self.overload
        if ov is not None:
            retry_after = ov.admit("bulk")
            if retry_after is not None:
                from elasticsearch_tpu_torch.threadpool import (
                    EsRejectedExecutionError,
                )

                raise EsRejectedExecutionError(
                    f"[{self.node_name}] overload shed "
                    f"({ov.stats()['level']}): bulk-tier shard write "
                    f"[{p['index']}][{p['shard_id']}]",
                    node=self.node_name, tier="bulk",
                    retry_after_s=retry_after)
        child = None
        if self.tasks is not None and p.get("_parent_task"):
            # child write task linked by the coordinator's `_parent_task`
            # payload field (next to the op list, never inside an op)
            child = self.tasks.register(
                "indices:data/write/bulk[s]",
                f"shard [{p['index']}][{p['shard_id']}] "
                f"ops[{len(p['ops'])}]",
                parent_task_id=p["_parent_task"])
        try:
            with _taskmgr.activate(child):
                if child is not None:
                    # ban raced this registration: reject before any op
                    # is applied (the coordinator fails these items)
                    child.check()
                    child.note_dispatch(phase="bulk")
                return self._primary_bulk_inner(req)
        finally:
            if child is not None:
                self.tasks.unregister(child)

    def _primary_bulk_inner(self, req) -> dict:
        p = req.payload
        inst = self.get_shard(p["index"], p["shard_id"])
        if not inst.primary:
            raise ShardNotFoundError(
                f"shard [{p['index']}][{p['shard_id']}] on "
                f"[{self.node_name}] is not the primary")
        req_term = p.get("primary_term")
        if req_term is not None and req_term < inst.primary_term:
            # the coordinator routed with a stale cluster state; make it retry
            raise PrimaryTermMismatchError(
                f"request term [{req_term}] below current "
                f"[{inst.primary_term}]")
        ops_bytes = p.get("ops_bytes") or _ops_bytes(p["ops"])
        try:
            with self.indexing_pressure.primary(ops_bytes), inst.lock:
                results: List[dict] = []
                rep_ops: List[dict] = []
                for op in p["ops"]:
                    try:
                        if op["op"] in ("index", "create"):
                            r = inst.engine.index(
                                op["id"], op["source"], op_type=op["op"],
                                if_seq_no=op.get("if_seq_no"),
                                if_primary_term=op.get("if_primary_term"))
                            status = 201 if r.result == "created" else 200
                        else:
                            r = inst.engine.delete(
                                op["id"],
                                if_seq_no=op.get("if_seq_no"),
                                if_primary_term=op.get("if_primary_term"))
                            status = 404 if r.result == "not_found" else 200
                        results.append({"_id": r.doc_id, "_version": r.version,
                                        "_seq_no": r.seq_no,
                                        "_primary_term": r.primary_term,
                                        "result": r.result, "status": status})
                        if r.result != "not_found":
                            rep_ops.append({
                                "op": "delete" if op["op"] == "delete" else "index",
                                "id": op["id"], "source": op.get("source"),
                                "seq_no": r.seq_no})
                    except VersionConflictError as e:
                        results.append({"_id": op["id"], "status": 409,
                                        "error": e.to_dict()})
                self._replicate(inst, rep_ops, ops_bytes)
                inst.tracker.update_local_checkpoint(
                    inst.allocation_id, inst.engine.local_checkpoint)
                return {"results": results,
                        "local_checkpoint": inst.engine.local_checkpoint,
                        "global_checkpoint": inst.tracker.global_checkpoint}
        except TranslogFsyncError as e:
            # the WAL could not persist the op: NEVER ack into a broken
            # translog. Fail this primary copy via the master (promotion /
            # reallocation follow from apply_failed_shard's reroute) and let
            # the coordinator retry against the new primary. Reported
            # outside inst.lock: the state-store applier chain runs
            # synchronously and re-enters shard locks.
            _count("fsync_shard_failures")
            self._report_shard_failed(
                inst.index, inst.shard_id, inst.allocation_id,
                f"translog fsync failed: {e}")
            raise

    def _replicate(self, inst: ShardInstance, rep_ops: List[dict],
                   ops_bytes: Optional[int] = None) -> None:
        """Fan one op batch to every assigned copy (ref:
        ReplicationOperation.java:137 performOnReplicas). A TRANSIENT
        transport blip gets exactly one immediate retry; a persistent
        failure of an in-sync copy -> remove_tracking + shard-failed to the
        master. A still-recovering copy may miss writes (recovery's finalize
        gap replay covers it)."""
        if not rep_ops:
            return
        state = self.state
        gcp = inst.tracker.global_checkpoint
        for r in state.shard_copies(inst.index, inst.shard_id):
            if r.node_id is None or r.state == "UNASSIGNED":
                continue
            # skip SELF by allocation id, not by the primary flag: during a
            # primary relocation the target carries the primary flag in
            # routing but must receive every replicated write until the swap
            if r.allocation_id == inst.allocation_id:
                continue
            in_sync = r.allocation_id in inst.tracker.in_sync_ids
            payload = {"index": inst.index, "shard_id": inst.shard_id,
                       "primary_term": inst.primary_term, "ops": rep_ops,
                       "ops_bytes": ops_bytes, "global_checkpoint": gcp}
            try:
                resp = self._replica_request(r.node_id, payload)
                inst.tracker.update_local_checkpoint(
                    r.allocation_id, resp["local_checkpoint"])
            except Exception as e:  # noqa: BLE001 — any failure fails the copy
                if in_sync:
                    inst.tracker.remove_tracking(r.allocation_id)
                    _count("replication_failures")
                    self._report_shard_failed(inst.index, inst.shard_id,
                                              r.allocation_id, str(e))

    def _replica_request(self, node_id: str, payload: dict) -> dict:
        """One replica-bulk RPC with a single transient retry: a transport
        blip (channel mid-reconnect, injected `rpc_replica_bulk` fault) must
        not cost an in-sync copy; anything that fails twice — or fails
        inside the replica (an application error) — escalates."""
        try:
            resp = self.channels.request(
                node_id, "indices:data/write/bulk[s][r]", payload)
        except (NodeUnavailableError, RpcTimeoutError):
            if not self._overload_ctl().retry_allowed("replication"):
                # retry budget exhausted: escalate the organic transport
                # error instead of doubling the replication storm
                raise
            _count("replication_retries")
            resp = self.channels.request(
                node_id, "indices:data/write/bulk[s][r]", payload)
        self._overload_ctl().note_success()
        return resp

    def _report_shard_failed(self, index: str, shard_id: int,
                             allocation_id: str, reason: str) -> None:
        try:
            self.master_client("internal:cluster/shard/failed",
                               {"index": index, "shard_id": shard_id,
                                "allocation_id": allocation_id,
                                "reason": reason})
        except Exception:  # noqa: BLE001 — master unreachable; next state
            pass           # application reconciles

    # ---------------- write path (replica side) ----------------

    def _on_replica_bulk(self, req) -> dict:
        p = req.payload
        inst = self.get_shard(p["index"], p["shard_id"])
        term = p["primary_term"]
        if term < inst.primary_term:
            raise PrimaryTermMismatchError(
                f"replication from deposed primary (term [{term}] < "
                f"[{inst.primary_term}])")
        ops_bytes = p.get("ops_bytes") or _ops_bytes(p["ops"])
        with self.indexing_pressure.replica(ops_bytes), inst.lock:
            inst.primary_term = max(inst.primary_term, term)
            for op in p["ops"]:
                if op["op"] == "index":
                    inst.engine.index(op["id"], op["source"],
                                      seq_no=op["seq_no"],
                                      op_primary_term=term)
                else:
                    inst.engine.delete(op["id"], seq_no=op["seq_no"],
                                       op_primary_term=term)
            inst.known_global_checkpoint = max(
                inst.known_global_checkpoint,
                p.get("global_checkpoint", NO_OPS_PERFORMED))
            return {"local_checkpoint": inst.engine.local_checkpoint}

    # ---------------- peer recovery: source handlers ----------------

    def _on_recovery_prepare(self, req) -> dict:
        p = req.payload
        inst = self.get_shard(p["index"], p["shard_id"])
        if not inst.primary:
            raise ShardNotFoundError("recovery source must be the primary")
        with inst.lock:
            # phase0: track the target so concurrent writes reach it from
            # now on (ref: RecoverySourceHandler add to replication group)
            inst.tracker.add_tracking(p["target_allocation_id"])
            return {"primary_term": inst.primary_term,
                    "global_checkpoint": inst.tracker.global_checkpoint}

    def _on_recovery_segments(self, req) -> dict:
        p = req.payload
        inst = self.get_shard(p["index"], p["shard_id"])
        with inst.lock:
            # snapshot under the shard lock so the blob + live mask + the
            # max_seq_no it is stamped with form one consistent point in
            # time (a concurrent bulk holds the same lock)
            payloads, max_seq_no = inst.engine.segment_payloads()
        segments = []
        for blob, live in payloads:
            # the advertised hash is computed BEFORE the wire: an injected
            # `segment_transfer` clause damages the payload after it (bit
            # rot in transit), so the hash stays pristine and the TARGET
            # must detect the mismatch and re-fetch
            digest = blob_hash(blob)
            if corruption_fires(self.node_name, site="segment_transfer"):
                blob = integrity.bitflip(blob)
            segments.append({"blob": base64.b64encode(blob).decode("ascii"),
                             "live": live.tolist(), "hash": digest})
        return {"segments": segments, "max_seq_no": max_seq_no}

    def _on_recovery_ops(self, req) -> dict:
        p = req.payload
        inst = self.get_shard(p["index"], p["shard_id"])
        with inst.lock:
            # same consistency argument as segments: the op tail and the
            # max_seq_no / term shipped with it must agree
            out = {"ops": inst.engine.changes_since(p["above_seq_no"]),
                   "max_seq_no": inst.engine.max_seq_no,
                   "primary_term": inst.primary_term}
            if p.get("divergent"):
                # a restarted target is rolling its divergent tail back to
                # the global checkpoint (same machinery as primary-failover
                # resync): ship the authoritative state of each such doc
                out["doc_states"] = {d: inst.engine.doc_resync_state(d)
                                     for d in p["divergent"]}
            return out

    def _on_recovery_cancel(self, req) -> dict:
        """A recovery target died or gave up mid-flight: drop its tracking
        so the global checkpoint is not pinned by a ghost copy forever
        (ref: RecoverySourceHandler cancel + ReplicationTracker's removal of
        failed/relocated copies). Idempotent; in-sync copies are never
        touched — those are the master's to fail."""
        p = req.payload
        inst = self.get_shard(p["index"], p["shard_id"])
        aid = p["target_allocation_id"]
        with inst.lock:
            cleaned = (aid in inst.tracker.tracked_ids
                       and aid not in inst.tracker.in_sync_ids)
            if cleaned:
                inst.tracker.remove_tracking(aid)
                _count("ghost_cleanups")
            return {"cleaned": cleaned}

    def _on_recovery_finalize(self, req) -> dict:
        p = req.payload
        inst = self.get_shard(p["index"], p["shard_id"])
        with inst.lock:
            # the lock is the linearization point: any write that failed to
            # reach the (not-yet-in-sync) target is visible here as a gap
            # above the target's checkpoint; ship it before marking in-sync
            gap_ops = inst.engine.changes_since(p["local_checkpoint"])
            inst.tracker.update_local_checkpoint(
                p["target_allocation_id"], p["local_checkpoint"])
            inst.tracker.mark_in_sync(p["target_allocation_id"])
            return {"gap_ops": gap_ops,
                    "max_seq_no": inst.engine.max_seq_no,
                    "primary_term": inst.primary_term,
                    "global_checkpoint": inst.tracker.global_checkpoint}

    # ---------------- peer recovery: target routine ----------------

    def recover_replica(self, inst: ShardInstance) -> None:
        """Pull-based replica bootstrap from the primary node (ref:
        indices/recovery/PeerRecoveryTargetService.java doRecovery).
        Raises on failure; caller may retry (every step is idempotent).

        Failure after prepare sends a best-effort recovery/cancel to the
        source so the tracking added for this copy does not linger as a
        ghost pinning the primary's global checkpoint."""
        state = self.state
        primary = state.primary_of(inst.index, inst.shard_id)
        # a RELOCATING primary is still the serving copy (and the only
        # legal recovery source while its own move is in flight)
        if primary is None or primary.node_id is None \
                or not primary.serving:
            raise ShardNotFoundError(
                f"no started primary for [{inst.index}][{inst.shard_id}]")
        source = primary.node_id
        shard_ref = {"index": inst.index, "shard_id": inst.shard_id}
        _count("recoveries_started")
        prep = self.channels.request(
            source, "internal:index/shard/recovery/prepare",
            {**shard_ref, "target_allocation_id": inst.allocation_id,
             "target_node": self.node_name})
        try:
            self._recover_replica_tracked(inst, source, shard_ref, prep)
        except Exception:
            _count("recoveries_failed")
            try:
                self.channels.request(
                    source, "internal:index/shard/recovery/cancel",
                    {**shard_ref,
                     "target_allocation_id": inst.allocation_id})
            except Exception:  # noqa: BLE001 — best effort; if the source
                pass           # is gone its tracker died with it
            raise

    def _recover_replica_tracked(self, inst: ShardInstance, source: str,
                                 shard_ref: dict, prep: dict) -> None:
        """The phases that run while the source tracks this copy."""
        # captured BEFORE phase1: a freshly installed snapshot raises
        # max_seq_no above the shipped global checkpoint without any
        # divergence — only pre-existing local history can diverge
        was_empty = inst.engine.max_seq_no == NO_OPS_PERFORMED
        inst.primary_term = max(inst.primary_term, prep["primary_term"])
        inst.engine.advance_primary_term(prep["primary_term"])
        # phase1 (file phase): install the segment snapshot when this copy
        # is empty — segments are the recovery files
        if was_empty:
            seg_resp = self._fetch_verified_segments(source, shard_ref)
            for seg in seg_resp["segments"]:
                inst.engine.install_segment(
                    base64.b64decode(seg["blob"]), seg["live"])
            inst.engine.fill_seqno_gaps(seg_resp["max_seq_no"])
        if not was_empty \
                and inst.engine.max_seq_no > prep["global_checkpoint"]:
            # a restarted copy may hold a divergent tail: ops above the
            # global checkpoint acked by a deposed primary but absent from
            # the current one. Roll back to the checkpoint with the SAME
            # machinery promotion resync uses, then replay forward.
            gcp = prep["global_checkpoint"]
            divergent = inst.engine.docs_above(gcp)
            replay_from = min(gcp, inst.engine.local_checkpoint)
            ops_resp = self.channels.request(
                source, "internal:index/shard/recovery/ops",
                {**shard_ref, "above_seq_no": replay_from,
                 "divergent": divergent})
            with inst.lock:
                resync_target_apply(
                    inst.engine, prep["primary_term"],
                    ops_resp.get("doc_states", {}), replay_from,
                    ops_resp["ops"], ops_resp["max_seq_no"])
        else:
            # phase2 (ops phase): replay history above what we hold
            ops_resp = self.channels.request(
                source, "internal:index/shard/recovery/ops",
                {**shard_ref, "above_seq_no": inst.engine.local_checkpoint})
            self._apply_recovery_ops(inst, ops_resp["ops"],
                                     ops_resp["primary_term"])
            inst.engine.fill_seqno_gaps(ops_resp["max_seq_no"])
        # finalize: source marks us in-sync and ships any writes that missed
        # us while we were not yet required
        fin = self.channels.request(
            source, "internal:index/shard/recovery/finalize",
            {**shard_ref, "target_allocation_id": inst.allocation_id,
             "local_checkpoint": inst.engine.local_checkpoint})
        self._apply_recovery_ops(inst, fin["gap_ops"], fin["primary_term"])
        inst.engine.fill_seqno_gaps(fin["max_seq_no"])
        inst.known_global_checkpoint = max(
            inst.known_global_checkpoint, fin["global_checkpoint"])
        inst.engine.flush()

    def _fetch_verified_segments(self, source: str, shard_ref: dict) -> dict:
        """Phase1 fetch with in-flight verification: every segment payload
        is re-hashed against the hash the source advertised (computed on
        the source BEFORE the wire). A mismatch means transfer corruption —
        re-fetch immediately, bounded by `ES_TPU_RECOVERY_RETRIES`, counted
        under `transfer_retries` (SEPARATE from the node-unavailable retry
        loop in cluster_state_service, which handles dead sources)."""
        retries = max(0, int(knob("ES_TPU_RECOVERY_RETRIES")))
        attempt = 0
        while True:
            resp = self.channels.request(
                source, "internal:index/shard/recovery/segments", shard_ref)
            clean = True
            for seg in resp["segments"]:
                want = seg.get("hash")
                if want is None:
                    continue   # pre-integrity source: nothing to check
                if blob_hash(base64.b64decode(seg["blob"])) != want:
                    clean = False
                    break
                integrity.count("transfer_hashes_verified")
            if clean:
                return resp
            integrity.count("transfer_corruptions")
            if attempt >= retries:
                raise SegmentCorruptedError(
                    f"recovery segment payload from [{source}] failed hash "
                    f"verification {attempt + 1}x (transfer corruption)")
            attempt += 1
            integrity.count("transfer_retries")

    @staticmethod
    def _apply_recovery_ops(inst: ShardInstance, ops: List[dict],
                            term: int) -> None:
        for op in ops:
            if op["op"] == "index":
                inst.engine.index(op["id"], op.get("source"),
                                  seq_no=op["seq_no"], op_primary_term=term)
            else:
                inst.engine.delete(op["id"], seq_no=op["seq_no"],
                                   op_primary_term=term)

    # ---------------- relocation: warm HBM handoff ----------------

    class _WarmView:
        """Minimal index-service view over one shard instance, shaped like
        the search action's _ShardView so the ServingContext built here is
        the SAME object the query path reuses after the swap. Its device
        is the shard engine's, the node's."""

        def __init__(self, inst):
            self.shards = [inst.engine]
            self.mapper = inst.mapper
            self.name = inst.index
            self.device = inst.engine.device

    def _on_relocation_warm_info(self, req) -> dict:
        """Relocation source side: report which fields this copy actually
        served (the per-field engines its serving snapshot built) and the
        process's hot dispatch shapes from the compile-cache introspection,
        so the target can prime before taking traffic."""
        from elasticsearch_tpu_torch.common import hbm_ledger

        p = req.payload
        inst = self.get_shard(p["index"], p["shard_id"])
        fields: List[str] = []
        sparse_terms: Dict[str, List[str]] = {}
        ctx = getattr(inst, "_serving_ctx", None)
        snap = getattr(ctx, "_snapshot", None) if ctx is not None else None
        if snap is not None:
            fields = sorted(getattr(snap, "_bm", {}))
            # the hot cold-tier: terms with resident eager-sparse slices,
            # so the target can pre-slice them instead of rebuilding under
            # first-query latency
            for field in fields:
                eng = snap.engine(field)
                if eng is not None and hasattr(eng, "sparse_hot_terms"):
                    terms = eng.sparse_hot_terms()
                    if terms:
                        sparse_terms[field] = terms
        return {"fields": fields, "shapes": hbm_ledger.hot_shapes(),
                "sparse_terms": sparse_terms}

    def warm_relocation_handoff(self, inst: ShardInstance,
                                source_node: str) -> None:
        """Target side, after recovery and before shard-started: register
        the engine, upload columns, and prime the compile cache with the
        source's hot shapes (extend_qc_sizes), so the relocated shard never
        serves its first query cold. Best-effort — any failure leaves the
        relocation correct-but-cold (ES_TPU_RELOC_WARM=0 skips it
        entirely) — except a kernel error, which is raised."""
        from elasticsearch_tpu_torch.common.relocation import count as _rcount
        from elasticsearch_tpu_torch.common.settings import knob

        if not knob("ES_TPU_RELOC_WARM"):
            return
        t0 = time.monotonic()
        try:
            info = self.channels.request(
                source_node, "internal:index/shard/relocation/warm_info",
                {"index": inst.index, "shard_id": inst.shard_id})
            from elasticsearch_tpu_torch.search.serving import ServingContext

            ctx = getattr(inst, "_serving_ctx", None)
            if ctx is None:
                ctx = ServingContext(self._WarmView(inst))
                inst._serving_ctx = ctx
            snap = ctx.snapshot()
            sizes = sorted({s for sizes in info["shapes"].values()
                            for s in sizes})
            warmed = 0
            primed = 0
            for field in info["fields"]:
                eng = snap.engine(field)
                if eng is None:
                    continue
                warmed += 1
                if sizes and hasattr(eng, "extend_qc_sizes"):
                    eng.extend_qc_sizes(sizes)
                    primed += len(sizes)
                terms = info.get("sparse_terms", {}).get(field)
                if terms and hasattr(eng, "prewarm_sparse"):
                    _rcount("sparse_prewarms", eng.prewarm_sparse(terms))
            _rcount("warm_handoffs")
            _rcount("fields_warmed", warmed)
            _rcount("shapes_primed", primed)
        except (KernelBuildError, KernelLaunchError):
            raise
        except Exception:  # noqa: BLE001 — warming is best-effort; the
            _rcount("warm_failures")   # move itself must not fail on it
        finally:
            _rcount("warm_ms",
                    max(0, int((time.monotonic() - t0) * 1000)))

    # ---------------- primary promotion + resync ----------------

    def promote_to_primary(self, inst: ShardInstance, new_term: int) -> None:
        """This copy was promoted by the master: fence, fill gaps, build the
        primary-side tracker, then resync every surviving copy over the
        transport (ref: IndexShard primary promotion +
        PrimaryReplicaSyncer.java)."""
        with inst.lock:
            gcp = inst.known_global_checkpoint
            inst.engine.advance_primary_term(new_term)
            inst.engine.fill_seqno_gaps(inst.engine.max_seq_no)
            inst.primary = True
            inst.primary_term = new_term
            inst.tracker = ReplicationTracker(inst.allocation_id)
            inst.tracker.update_local_checkpoint(
                inst.allocation_id, inst.engine.local_checkpoint)
        state = self.state
        for r in state.shard_copies(inst.index, inst.shard_id):
            if r.allocation_id == inst.allocation_id or r.node_id is None:
                continue
            # RELOCATING replicas are serving copies and must be resynced
            # like STARTED ones; INITIALIZING/UNASSIGNED are not yet ours
            if not r.serving:
                continue
            try:
                self._resync_copy(inst, r, gcp, new_term)
            except Exception as e:  # noqa: BLE001
                self._report_shard_failed(inst.index, inst.shard_id,
                                          r.allocation_id, str(e))

    def _resync_copy(self, inst: ShardInstance, r: ShardRouting,
                     gcp: int, new_term: int) -> None:
        shard_ref = {"index": inst.index, "shard_id": inst.shard_id}
        prep = self.channels.request(
            r.node_id, "internal:index/shard/resync/prepare",
            {**shard_ref, "primary_term": new_term, "above_seq_no": gcp})
        doc_states = {d: inst.engine.doc_resync_state(d)
                      for d in prep["divergent"]}
        replay_from = min(gcp, prep["local_checkpoint"])
        ops = inst.engine.changes_since(replay_from)
        resp = self.channels.request(
            r.node_id, "internal:index/shard/resync/apply",
            {**shard_ref, "primary_term": new_term,
             "doc_states": doc_states, "replay_from": replay_from,
             "ops": ops, "max_seq_no": inst.engine.max_seq_no})
        inst.tracker.add_tracking(r.allocation_id)
        inst.tracker.update_local_checkpoint(
            r.allocation_id, resp["local_checkpoint"])
        inst.tracker.mark_in_sync(r.allocation_id)

    def _on_resync_prepare(self, req) -> dict:
        p = req.payload
        inst = self.get_shard(p["index"], p["shard_id"])
        term = p["primary_term"]
        if term < inst.primary_term:
            raise PrimaryTermMismatchError(
                f"resync from deposed primary (term [{term}])")
        with inst.lock:
            inst.engine.advance_primary_term(term)
            inst.primary_term = term
            return {"divergent": inst.engine.docs_above(p["above_seq_no"]),
                    "local_checkpoint": inst.engine.local_checkpoint}

    def _on_resync_apply(self, req) -> dict:
        p = req.payload
        inst = self.get_shard(p["index"], p["shard_id"])
        with inst.lock:
            resync_target_apply(inst.engine, p["primary_term"],
                                p["doc_states"], p["replay_from"],
                                p["ops"], p["max_seq_no"])
            inst.primary_term = p["primary_term"]
            return {"local_checkpoint": inst.engine.local_checkpoint}
