"""IndicesClusterStateService analog: cluster state drives local shards.

The reference applies every committed cluster state on every node and
reconciles local shard instances against it (ref:
indices/cluster/IndicesClusterStateService.java:200 applyClusterState —
deletes indices, removes shards, creates/updates shards, starts recoveries,
notifies the master when shards start or fail). Consensus commits
states, and THIS makes them mean something on data nodes.

Reconciliation per applied state:
  * shards whose index/allocation vanished from routing -> close + remove;
  * new assignments to this node -> create engine; fresh primaries report
    started immediately; replicas run pull-based peer recovery from the
    primary node, then report started;
  * a replica whose routing turned primary -> promote (term bump + fence +
    transport resync of survivors);
  * master notifications (shard started/failed) go through the master
    client and come back as new cluster states.

The port's copy of elasticsearch_tpu/indices/cluster_state_service.py,
with the startup checksum scan (`ES_TPU_CHECK_ON_STARTUP`) as in the
reference. One difference: a kernel error of the port
(`KernelBuildError`, `KernelLaunchError`) in a deferred action is not
swallowed. A relocation target whose warm handoff raised one reports its
copy failed (the source keeps the shard), and `apply_cluster_state`
raises the error after the other deferred actions have run.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.cluster.state import ClusterState
from elasticsearch_tpu_torch.common import integrity
from elasticsearch_tpu_torch.common.errors import (
    KernelBuildError, KernelLaunchError,
)
from elasticsearch_tpu_torch.common.integrity import SegmentCorruptedError
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.indices.shard_service import DistributedShardService


class IndicesClusterStateService:
    def __init__(self, node_name: str,
                 shard_service: DistributedShardService,
                 master_client: Callable[[str, dict], dict]):
        self.node_name = node_name
        self.shards = shard_service
        self.master_client = master_client
        self._apply_lock = threading.Lock()
        # actions deferred to after apply returns (a state update must never
        # be submitted from inside the applier — ref: ClusterApplierService
        # appliers run before listeners exactly to avoid this reentrancy)
        self._post_apply: List[Callable[[], None]] = []

    def apply_cluster_state(self, state: ClusterState) -> None:
        with self._apply_lock:
            self.shards.state = state
            self._remove_unassigned_shards(state)
            self._create_or_update_shards(state)
            actions, self._post_apply = self._post_apply, []
        kernel_error: Optional[Exception] = None
        for fn in actions:
            try:
                fn()
            except (KernelBuildError, KernelLaunchError) as e:
                # a fault of the port: never retried around, raised once
                # the other actions have run
                kernel_error = kernel_error or e
            except Exception:  # noqa: BLE001 — reports are retried by
                pass           # the next state application
        if kernel_error is not None:
            raise kernel_error

    # ---- removal (ref: IndicesClusterStateService.removeIndices/Shards) ----

    def _remove_unassigned_shards(self, state: ClusterState) -> None:
        for (index, shard_id), inst in list(self.shards.shards.items()):
            keep = False
            for r in state.routing.get(index, []):
                if (r.shard_id == shard_id and r.node_id == self.node_name
                        and r.allocation_id == inst.allocation_id):
                    keep = True
            if not keep:
                self.shards.remove_shard(index, shard_id)

    # ---- creation / role changes ----

    def _create_or_update_shards(self, state: ClusterState) -> None:
        for r in state.entries_on_node(self.node_name):
            meta = state.indices.get(r.index)
            if meta is None:
                continue
            inst = self.shards.shards.get((r.index, r.shard_id))
            if inst is None:
                try:
                    self._create_local_shard(meta, r)
                except SegmentCorruptedError as e:
                    # corruption fails the COPY, never the applier: the
                    # corrupted-* marker (written where the verify failed)
                    # blocks this store from serving again, and the
                    # deferred shard-failed report routes through the same
                    # seam every other copy failure uses — the master
                    # reallocates from a healthy peer
                    integrity.count("shards_failed_corrupt")
                    self.shards.remove_shard(r.index, r.shard_id)
                    self._defer_report_failed(r, f"corrupted: {e}")
            else:
                new_term = meta.primary_term(r.shard_id)
                still_reloc_target = (r.state == "INITIALIZING"
                                      and r.relocating_node_id is not None)
                if r.primary and not inst.primary and not still_reloc_target:
                    # promotion (ref: IndexShard term bump on new routing);
                    # for a relocation swap the term is unchanged — the
                    # same primary context moves, no bump. A still-
                    # recovering relocation target must NOT promote yet.
                    self.shards.promote_to_primary(inst, new_term)
                inst.state = r.state if r.state != "INITIALIZING" \
                    else inst.state
                if inst.primary and inst.tracker is not None:
                    self._sync_tracker(inst, state, meta)

    def _create_local_shard(self, meta, r) -> None:
        """One new assignment: build the engine and schedule whatever must
        happen before the copy reports started. Raises
        `SegmentCorruptedError` when the store cannot serve (marker, failed
        checksum on commit load, or a failed startup scan)."""
        if r.state == "INITIALIZING" and r.relocating_node_id is not None:
            # relocation target: even when routing carries the
            # primary flag, the source keeps the primary context
            # until the swap — this copy recovers as a replica
            # (peer recovery from the serving primary), warms its
            # HBM/compile caches, then reports started
            from dataclasses import replace as _replace

            inst = self.shards.create_shard(
                meta, _replace(r, primary=False))
            self._defer_recovery(
                inst, relocation_source=r.relocating_node_id)
        elif r.primary:
            inst = self.shards.create_shard(meta, r)
            # fresh (or locally-recovered) primary: started
            inst.state = "STARTED" if r.state == "STARTED" \
                else "INITIALIZING"
            if r.state == "INITIALIZING":
                self._verify_on_startup(inst)
                self._defer_report_started(inst)
                inst.state = "STARTED"
        else:
            inst = self.shards.create_shard(meta, r)
            self._defer_recovery(inst)

    def _verify_on_startup(self, inst) -> None:
        """ES_TPU_CHECK_ON_STARTUP: full-store checksum scan BEFORE the
        copy reports started (ref: index.shard.check_on_startup) — the
        commit load only re-reads blobs it rebuilds, this re-reads all of
        them, so bit rot under an already-loaded store is caught here
        instead of at the next recovery."""
        if not knob("ES_TPU_CHECK_ON_STARTUP"):
            return
        integrity.count("startup_checks")
        try:
            inst.engine.verify_store()
        except SegmentCorruptedError:
            integrity.count("startup_failures")
            raise

    def _sync_tracker(self, inst, state: ClusterState, meta) -> None:
        """Keep the primary's replication tracker consistent with the
        published in-sync set (ref: ReplicationTracker
        updateFromMaster)."""
        present = {r.allocation_id
                   for r in state.shard_copies(inst.index, inst.shard_id)}
        for aid in list(inst.tracker.in_sync_ids):
            if aid != inst.allocation_id and aid not in present:
                inst.tracker.remove_tracking(aid)

    # ---- deferred actions ----

    def _defer_report_started(self, inst) -> None:
        payload = {"index": inst.index, "shard_id": inst.shard_id,
                   "allocation_id": inst.allocation_id}

        def report():
            self.master_client("internal:cluster/shard/started", payload)

        self._post_apply.append(report)

    def _defer_report_failed(self, r, reason: str) -> None:
        payload = {"index": r.index, "shard_id": r.shard_id,
                   "allocation_id": r.allocation_id, "reason": reason}

        def report():
            self.master_client("internal:cluster/shard/failed", payload)

        self._post_apply.append(report)

    def _defer_recovery(self, inst,
                        relocation_source: Optional[str] = None) -> None:
        def recover():
            import time

            from elasticsearch_tpu_torch.common.durability import count

            # a dying source or an injected transport blip must not cost
            # the copy outright: every recovery step is idempotent, so
            # retry with exponential backoff before telling the master
            # (ref: PeerRecoveryTargetService retryRecovery)
            attempts = max(1, knob("ES_TPU_RECOVERY_RETRIES"))
            backoff = knob("ES_TPU_RECOVERY_BACKOFF_MS") / 1000.0
            last_err: Optional[Exception] = None
            for attempt in range(attempts):
                if attempt:
                    ov = getattr(self.shards, "overload", None)
                    if ov is not None and not ov.retry_allowed("recovery"):
                        # node-wide retry budget exhausted: report the
                        # organic error to the master now instead of
                        # piling recovery retries onto a browned-out peer
                        break
                    count("recoveries_retried")
                    time.sleep(backoff * (2 ** (attempt - 1)))
                try:
                    self.shards.recover_replica(inst)
                    last_err = None
                    break
                except Exception as e:  # noqa: BLE001
                    last_err = e
            if last_err is None:
                try:
                    # the freshly recovered (and flushed) store replaces
                    # whatever corruption got this copy here: any marker
                    # left in the data path is stale now
                    if inst.engine.data_path is not None:
                        integrity.clear_corruption_markers(
                            inst.engine.data_path)
                    self._verify_on_startup(inst)
                except SegmentCorruptedError as e:
                    integrity.count("shards_failed_corrupt")
                    last_err = e
            if last_err is not None:
                self.master_client(
                    "internal:cluster/shard/failed",
                    {"index": inst.index, "shard_id": inst.shard_id,
                     "allocation_id": inst.allocation_id,
                     "reason": f"recovery failed: {last_err}"})
                return
            if relocation_source is not None:
                # warm device handoff before shard-started: the moved copy
                # must not serve its first query cold (best-effort inside,
                # but for a kernel error: the move then fails)
                try:
                    self.shards.warm_relocation_handoff(
                        inst, relocation_source)
                except (KernelBuildError, KernelLaunchError) as e:
                    self.master_client(
                        "internal:cluster/shard/failed",
                        {"index": inst.index, "shard_id": inst.shard_id,
                         "allocation_id": inst.allocation_id,
                         "reason": f"warm handoff failed: "
                                   f"{type(e).__name__}: {e}"})
                    raise
            inst.state = "STARTED"
            self.master_client(
                "internal:cluster/shard/started",
                {"index": inst.index, "shard_id": inst.shard_id,
                 "allocation_id": inst.allocation_id})

        self._post_apply.append(recover)
