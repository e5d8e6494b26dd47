"""Cross-cluster replication: follower indices pulling a leader's translog
ops by global-checkpoint range.

The reference's CCR (ref: x-pack ccr — ShardFollowNodeTask's
read/write loop over ShardChangesAction, bootstrapped by
PutFollowAction) is a PULL design: the follower polls the leader for
operation batches and applies them under its own primary term. The same
loop here, built from seams that already exist:

  * the leader serves ops from `InternalEngine.changes_since` — latest
    op per doc, seqno-ordered (the resync/ops-recovery history source) —
    but only up to its GLOBAL checkpoint: an op above the gcp is acked
    on the primary but not yet durable on every in-sync copy, so a
    leader crash may legally lose it; shipping only ``(from, gcp]``
    means the follower never holds history the leader can roll back.
  * every batch carries a sha256 computed on the leader BEFORE the wire
    (the segment-transfer discipline); a follower-side mismatch
    re-fetches, bounded by ``ES_TPU_REMOTE_RETRIES``.
  * apply is seq-no idempotent via the engine's replica path
    (`index(seq_no=..., op_primary_term=...)` no-ops on stale seqnos) at
    the FOLLOWER's own primary term — leader and follower term spaces
    never entangle — then `fill_seqno_gaps` fast-forwards over seqnos
    collapsed by latest-op-per-doc history, exactly as ops-based
    recovery does.
  * leader unavailability auto-retries on the remote retry budget (inside
    `RemoteClusterService.request`) and again at the next poll tick —
    the loop is re-entrant and makes progress whenever the leader is
    reachable.

`CcrService` runs on BOTH node flavors through a host adapter: the
multi-node `ClusterNode` (ops route to the follower shard's primary via
`internal:index/ccr/apply_ops` and fan to replicas through the existing
`_replicate` path) and the standalone REST `Node` (engines applied
directly). All leader-bound RPCs share the `rpc_ccr_fetch` fault site
(``#part`` = the remote cluster alias), the way every recovery phase
shares `rpc_recovery`.

The port's copy of elasticsearch_tpu/index/ccr.py."""

from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from elasticsearch_tpu_torch.common import faults, metrics
from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuError, IllegalArgumentError, IndexNotFoundError,
)
from elasticsearch_tpu_torch.common.integrity import SegmentCorruptedError
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.index.seqno import NO_OPS_PERFORMED
from elasticsearch_tpu_torch.transport.channels import (
    NodeUnavailableError, RpcTimeoutError,
)

# Follower -> leader (cross-cluster, via RemoteClusterService):
ACTION_CCR_INFO = "internal:index/ccr/leader_info"
ACTION_CCR_FETCH = "internal:index/ccr/fetch_ops"
# Follower-internal (route an op batch to the follower shard's primary):
ACTION_CCR_APPLY = "internal:index/ccr/apply_ops"

# every follower->leader RPC shares one fault site (#part = cluster alias)
CCR_FAULT_SITE = "rpc_ccr_fetch"


def batch_checksum(ops: List[dict]) -> str:
    """sha256 of the canonical JSON of an op batch, computed on the leader
    BEFORE the wire (the `blob_hash` discipline of segment payloads)."""
    return hashlib.sha256(
        json.dumps(ops, sort_keys=True).encode()).hexdigest()


@dataclass
class _Follower:
    """Pull-loop state for one follower index."""

    index: str
    remote_cluster: str
    leader_index: str
    n_shards: int
    paused: bool = False
    # per shard: highest seqno applied AND gap-filled (next fetch is
    # exclusive of this value — the leader's changes_since contract)
    from_seq: Dict[int, int] = field(default_factory=dict)
    # per shard: the leader global checkpoint last seen (lag accounting)
    leader_gcp: Dict[int, int] = field(default_factory=dict)
    last_error: Optional[str] = None


class CcrHost:
    """What CcrService needs from its node. Two implementations below —
    the duck type is the contract, this class is documentation."""

    node_name: str

    def index_info(self, index: str) -> dict: ...
    def ensure_follower_index(self, index: str, n_shards: int,
                              mappings: dict, settings: dict) -> None: ...
    def primary_owner(self, index: str, shard_id: int) -> Optional[str]: ...
    def forward(self, node: str, action: str, payload: dict) -> dict: ...
    def primary_engine(self, index: str, shard_id: int): ...
    def apply_local(self, index: str, shard_id: int, ops: List[dict],
                    fill_to: int) -> dict: ...


class ClusterNodeHost:
    """Adapter over a multi-node ClusterNode: cluster-state lookups,
    channel forwards to the owning primary, replica fan-out through the
    shard service's existing `_replicate` path."""

    def __init__(self, node):
        self.node = node
        self.node_name = node.node_name

    def index_info(self, index: str) -> dict:
        meta = self.node.state.indices.get(index)
        if meta is None:
            raise IndexNotFoundError(index)
        return {"number_of_shards": meta.number_of_shards,
                "mappings": dict(meta.mappings)}

    def ensure_follower_index(self, index: str, n_shards: int,
                              mappings: dict, settings: dict) -> None:
        if index in self.node.state.indices:
            return
        body_settings = {"index.number_of_shards": n_shards,
                         "index.number_of_replicas": 0}
        body_settings.update(settings or {})
        self.node.create_index(index, {"settings": body_settings,
                                       "mappings": mappings})

    def primary_owner(self, index: str, shard_id: int) -> Optional[str]:
        r = self.node.state.primary_of(index, shard_id)
        if r is None or r.node_id is None or not r.serving:
            raise ElasticsearchTpuError(
                f"no started primary for [{index}][{shard_id}]")
        return r.node_id

    def forward(self, node: str, action: str, payload: dict) -> dict:
        return self.node.channels.request(node, action, payload,
                                          source=self.node_name)

    def primary_engine(self, index: str, shard_id: int):
        inst = self.node.shard_service.get_shard(index, shard_id)
        if not inst.primary:
            from elasticsearch_tpu_torch.indices.shard_service import (
                ShardNotFoundError,
            )

            raise ShardNotFoundError(
                f"[{index}][{shard_id}] copy here is not the primary")
        gcp = inst.tracker.global_checkpoint if inst.tracker is not None \
            else inst.engine.local_checkpoint
        return inst.engine, gcp

    def apply_local(self, index: str, shard_id: int, ops: List[dict],
                    fill_to: int) -> dict:
        from elasticsearch_tpu_torch.indices.shard_service import (
            DistributedShardService,
        )

        svc = self.node.shard_service
        inst = svc.get_shard(index, shard_id)
        with inst.lock:
            # the follower's OWN term: leader terms never cross the
            # boundary, so a leader-side primary failover cannot fence
            # the follower's writes (ref: ShardFollowNodeTask applies
            # under the follower primary's term)
            DistributedShardService._apply_recovery_ops(
                inst, ops, inst.primary_term)
            inst.engine.fill_seqno_gaps(fill_to)
            if inst.tracker is not None:
                inst.tracker.update_local_checkpoint(
                    inst.allocation_id, inst.engine.local_checkpoint)
            svc._replicate(inst, ops)
        inst.engine.refresh()
        return {"local_checkpoint": inst.engine.local_checkpoint}


class StandaloneNodeHost:
    """Adapter over the standalone REST Node: one process owns every
    shard, so ownership is always local and apply hits engines directly."""

    def __init__(self, node):
        self.node = node
        self.node_name = node.node_name

    def index_info(self, index: str) -> dict:
        meta = self.node.cluster_state.indices.get(index)
        if meta is None:
            raise IndexNotFoundError(index)
        return {"number_of_shards": meta.number_of_shards,
                "mappings": dict(meta.mappings)}

    def ensure_follower_index(self, index: str, n_shards: int,
                              mappings: dict, settings: dict) -> None:
        if self.node.indices.has(index):
            return
        body_settings = {"index.number_of_shards": n_shards}
        body_settings.update(settings or {})
        self.node.create_index(index, {"settings": body_settings,
                                       "mappings": mappings})

    def primary_owner(self, index: str, shard_id: int) -> Optional[str]:
        return None   # always local

    def forward(self, node: str, action: str, payload: dict) -> dict:
        raise AssertionError("standalone node never forwards")

    def primary_engine(self, index: str, shard_id: int):
        svc = self.node.indices.get(index)
        engine = svc.shards[shard_id]
        return engine, engine.local_checkpoint

    def apply_local(self, index: str, shard_id: int, ops: List[dict],
                    fill_to: int) -> dict:
        engine = self.node.indices.get(index).shards[shard_id]
        for op in ops:
            if op["op"] == "index":
                engine.index(op["id"], op.get("source"),
                             seq_no=op["seq_no"],
                             op_primary_term=engine.primary_term)
            else:
                engine.delete(op["id"], seq_no=op["seq_no"],
                              op_primary_term=engine.primary_term)
        engine.fill_seqno_gaps(fill_to)
        engine.refresh()
        return {"local_checkpoint": engine.local_checkpoint}


class CcrService:
    """Follower-index registry + the leader-side op-shipping handlers.

    One instance per node: the LEADER handlers (`leader_info`,
    `fetch_ops`) answer any remote follower; the FOLLOWER side holds the
    pull-loop state for indices this node was told to `follow`."""

    def __init__(self, host, remotes, transport):
        self.host = host
        self.remotes = remotes
        self._followers: Dict[str, _Follower] = {}   # guarded by: _lock
        self._lock = threading.Lock()
        self._poll_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        transport.register_request_handler(ACTION_CCR_INFO,
                                           self._on_leader_info)
        transport.register_request_handler(ACTION_CCR_FETCH,
                                           self._on_fetch_ops)
        transport.register_request_handler(ACTION_CCR_APPLY,
                                           self._on_apply_ops)

    # ---------------- leader-side handlers ----------------

    def _on_leader_info(self, req) -> dict:
        """Index shape for PutFollow: shard count + mappings, so the
        follower can create a congruent index."""
        return self.host.index_info(req.payload["index"])

    def _on_fetch_ops(self, req) -> dict:
        """One op batch in ``(from_seq_no, global_checkpoint]``, capped at
        `max_ops` (``ES_TPU_CCR_BATCH_OPS``), checksummed pre-wire.

        Ops above the gcp are NOT shipped: they are acked on the primary
        but a leader-cluster crash may lawfully roll them back (resync
        resets to the gcp), and a follower must never hold history its
        leader can lose. A node that doesn't own the primary forwards one
        hop to the owner."""
        p = req.payload
        index, sid = p["index"], p["shard_id"]
        owner = self.host.primary_owner(index, sid)
        if owner is not None and owner != self.host.node_name:
            return self.host.forward(owner, ACTION_CCR_FETCH, p)
        engine, gcp = self.host.primary_engine(index, sid)
        from_seq = int(p.get("from_seq_no", NO_OPS_PERFORMED))
        max_ops = int(p.get("max_ops") or knob("ES_TPU_CCR_BATCH_OPS"))
        ops = [op for op in engine.changes_since(from_seq)
               if op["seq_no"] <= gcp]
        truncated = len(ops) > max_ops
        ops = ops[:max_ops]
        # a complete batch lets the follower fast-forward its checkpoint
        # all the way to the gcp (seqnos in between collapsed away by
        # latest-op-per-doc history); a truncated one only to its last op
        fill_to = ops[-1]["seq_no"] if truncated else max(
            gcp, ops[-1]["seq_no"] if ops else NO_OPS_PERFORMED)
        return {"ops": ops, "fill_to": fill_to, "global_checkpoint": gcp,
                "max_seq_no": engine.max_seq_no,
                "checksum": batch_checksum(ops)}

    def _on_apply_ops(self, req) -> dict:
        """Follower-cluster internal: apply a verified batch on the
        follower shard's primary (forwarding one hop if needed), fan to
        replicas through the existing replication path."""
        p = req.payload
        index, sid = p["index"], p["shard_id"]
        owner = self.host.primary_owner(index, sid)
        if owner is not None and owner != self.host.node_name:
            return self.host.forward(owner, ACTION_CCR_APPLY, p)
        return self.host.apply_local(index, sid, p.get("ops") or [],
                                     int(p["fill_to"]))

    # ---------------- follower lifecycle ----------------

    def follow(self, follower_index: str, remote_cluster: str,
               leader_index: str, settings: Optional[dict] = None) -> dict:
        """POST /{index}/_ccr/follow: create the congruent follower index
        and start pulling (ref: PutFollowAction -> ResumeFollowAction)."""
        self.remotes.get(remote_cluster)   # unknown alias -> 400 here
        with self._lock:
            if follower_index in self._followers \
                    and not self._followers[follower_index].paused:
                raise IllegalArgumentError(
                    f"index [{follower_index}] is already a follower")
        info = self.remotes.request(
            remote_cluster, ACTION_CCR_INFO, {"index": leader_index},
            site=CCR_FAULT_SITE)
        n_shards = int(info["number_of_shards"])
        self.host.ensure_follower_index(
            follower_index, n_shards, info.get("mappings") or {},
            settings or {})
        f = _Follower(index=follower_index, remote_cluster=remote_cluster,
                      leader_index=leader_index, n_shards=n_shards)
        for sid in range(n_shards):
            # resume from whatever the follower copy already holds (an
            # empty ops apply is a checkpoint read)
            cp = self._follower_checkpoint(follower_index, sid)
            f.from_seq[sid] = cp
            f.leader_gcp[sid] = NO_OPS_PERFORMED
        with self._lock:
            self._followers[follower_index] = f
        self._maybe_start_poll_thread()
        return {"follow_index_created": True,
                "follow_index_shards_acked": True,
                "index_following_started": True}

    def pause_follow(self, follower_index: str) -> dict:
        f = self._follower(follower_index)
        f.paused = True
        return {"acknowledged": True}

    def resume_follow(self, follower_index: str) -> dict:
        f = self._follower(follower_index)
        f.paused = False
        self._maybe_start_poll_thread()
        return {"acknowledged": True}

    def _follower(self, index: str) -> _Follower:
        with self._lock:
            f = self._followers.get(index)
        if f is None:
            raise IndexNotFoundError(
                f"[{index}] is not a follower index")
        return f

    def _follower_checkpoint(self, index: str, sid: int) -> int:
        owner = self.host.primary_owner(index, sid)
        if owner is not None and owner != self.host.node_name:
            r = self.host.forward(owner, ACTION_CCR_APPLY,
                                  {"index": index, "shard_id": sid,
                                   "ops": [],
                                   "fill_to": NO_OPS_PERFORMED})
        else:
            r = self.host.apply_local(index, sid, [], NO_OPS_PERFORMED)
        return int(r["local_checkpoint"])

    # ---------------- the pull loop ----------------

    def poll_once(self, index: Optional[str] = None) -> int:
        """One pull round over every (or one) unpaused follower. Returns
        the number of ops applied — tests and the chaos harness pump this
        until 0 instead of racing the background thread
        (``ES_TPU_CCR_POLL_MS=0`` disables the thread entirely)."""
        with self._lock:
            followers = [f for f in self._followers.values()
                         if (index is None or f.index == index)
                         and not f.paused]
        applied = 0
        for f in followers:
            metrics.counter_add("ccr_polls")
            for sid in range(f.n_shards):
                try:
                    applied += self._pull_shard(f, sid)
                    f.last_error = None
                except (NodeUnavailableError, RpcTimeoutError,
                        SegmentCorruptedError,
                        ElasticsearchTpuError) as e:
                    # leader unreachable / mid-failover: the budgeted
                    # retries inside remotes.request already ran — note
                    # it and make progress at the next tick
                    f.last_error = f"{type(e).__name__}: {e}"
        return applied

    def _pull_shard(self, f: _Follower, sid: int) -> int:
        """Fetch-verify-apply until this shard is caught up to the
        leader's global checkpoint (bounded per round by batch size so a
        huge backlog still yields between shards)."""
        applied = 0
        max_ops = max(1, int(knob("ES_TPU_CCR_BATCH_OPS")))
        while True:
            resp = self._fetch_verified(f, sid, max_ops)
            ops = resp["ops"]
            fill_to = int(resp["fill_to"])
            f.leader_gcp[sid] = int(resp["global_checkpoint"])
            if not ops and fill_to <= f.from_seq[sid]:
                return applied
            owner = self.host.primary_owner(f.index, sid)
            payload = {"index": f.index, "shard_id": sid, "ops": ops,
                       "fill_to": fill_to}
            if owner is not None and owner != self.host.node_name:
                self.host.forward(owner, ACTION_CCR_APPLY, payload)
            else:
                self.host.apply_local(f.index, sid, ops, fill_to)
            f.from_seq[sid] = fill_to
            applied += len(ops)
            if len(ops):
                metrics.counter_add("ccr_ops_shipped", len(ops))
            if fill_to >= f.leader_gcp[sid]:
                return applied

    def _fetch_verified(self, f: _Follower, sid: int,
                        max_ops: int) -> dict:
        """One verified fetch: sha256 the received batch against the
        leader's pre-wire checksum; a mismatch (wire bit-rot — the
        `segment_transfer#<cluster>` corruption site models it on the
        receive side) re-fetches, bounded by ``ES_TPU_REMOTE_RETRIES``."""
        retries = max(0, int(knob("ES_TPU_REMOTE_RETRIES")))
        attempt = 0
        while True:
            resp = self.remotes.request(
                f.remote_cluster, ACTION_CCR_FETCH,
                {"index": f.leader_index, "shard_id": sid,
                 "from_seq_no": f.from_seq[sid], "max_ops": max_ops},
                site=CCR_FAULT_SITE)
            metrics.counter_add("ccr_fetches")
            ops = resp["ops"]
            if ops and faults.corruption_fires(f.remote_cluster,
                                               "segment_transfer"):
                # damage a COPY: in-process channels share objects with
                # the leader, and wire rot must never touch its engine
                ops = [dict(ops[0], id=f"{ops[0]['id']}\x00")] + ops[1:]
            if batch_checksum(ops) == resp["checksum"]:
                return dict(resp, ops=ops)
            metrics.counter_add("ccr_checksum_mismatches")
            if attempt >= retries:
                raise SegmentCorruptedError(
                    f"CCR op batch from [{f.remote_cluster}:"
                    f"{f.leader_index}][{sid}] failed sha256 verification "
                    f"{attempt + 1}x (transfer corruption)")
            attempt += 1
            metrics.counter_add("ccr_fetch_retries")

    # ---------------- background poll thread ----------------

    def _maybe_start_poll_thread(self) -> None:
        poll_ms = int(knob("ES_TPU_CCR_POLL_MS"))
        if poll_ms <= 0:
            return
        with self._lock:
            if self._poll_thread is not None and self._poll_thread.is_alive():
                return
            self._stop.clear()
            t = threading.Thread(target=self._poll_loop, daemon=True,
                                 name=f"ccr-poll[{self.host.node_name}]")
            self._poll_thread = t
        t.start()

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            poll_ms = int(knob("ES_TPU_CCR_POLL_MS"))
            if poll_ms <= 0:
                return
            self._stop.wait(poll_ms / 1000.0)
            if self._stop.is_set():
                return
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the loop must survive any
                pass           # transient; per-shard errors are recorded

    def stop(self) -> None:
        self._stop.set()
        t = self._poll_thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    # ---------------- stats ----------------

    def follower_stats(self, index: Optional[str] = None) -> dict:
        """GET /{index}/_ccr/stats shape: per-shard checkpoint, the
        leader gcp last seen, and the lag between them."""
        with self._lock:
            followers = [f for f in self._followers.values()
                         if index is None or f.index == index]
        if index is not None and not followers:
            raise IndexNotFoundError(f"[{index}] is not a follower index")
        out = []
        for f in followers:
            shards = []
            for sid in range(f.n_shards):
                cp = f.from_seq.get(sid, NO_OPS_PERFORMED)
                gcp = f.leader_gcp.get(sid, NO_OPS_PERFORMED)
                shards.append({"shard_id": sid,
                               "follower_checkpoint": cp,
                               "leader_global_checkpoint": gcp,
                               "lag_ops": max(0, gcp - cp)})
            entry = {"index": f.index,
                     "remote_cluster": f.remote_cluster,
                     "leader_index": f.leader_index,
                     "paused": f.paused, "shards": shards}
            if f.last_error:
                entry["last_error"] = f.last_error
            out.append(entry)
        return {"indices": out}

    def stats(self) -> dict:
        """`tpu_ccr` section of GET /_nodes/stats: shipping counters from
        the central registry + this node's follower states."""
        vals = metrics.counter_values()
        return {
            "ops_shipped": vals["ccr_ops_shipped"],
            "fetches": vals["ccr_fetches"],
            "fetch_retries": vals["ccr_fetch_retries"],
            "checksum_mismatches": vals["ccr_checksum_mismatches"],
            "polls": vals["ccr_polls"],
            "followers": self.follower_stats()["indices"],
        }
