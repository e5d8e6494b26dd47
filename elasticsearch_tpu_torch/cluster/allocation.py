"""Shard allocation: assigning shard copies to data nodes.

Re-designs the reference allocation layer (ref:
cluster/routing/allocation/AllocationService.java — reroute() applies
deciders then the balanced allocator;
allocation/allocator/BalancedShardsAllocator.java;
allocation/decider/SameShardAllocationDecider.java;
allocation/decider/FilterAllocationDecider.java) as a deterministic
functional step over the immutable ClusterState:

  * `reroute` assigns UNASSIGNED copies to the least-loaded eligible data
    node (same-shard exclusion: never two copies of one shard on one node),
    marking them INITIALIZING with a fresh allocation id; it then applies
    the maintenance deciders — draining nodes named by
    `cluster.routing.allocation.exclude._name` and rebalancing shard
    counts onto under-loaded (newly joined) nodes — both bounded by the
    concurrent-relocations cap;
  * a relocation is a linked pair: the source flips STARTED -> RELOCATING
    (still serving) and a target copy INITIALIZING is born with a fresh
    allocation id, each naming the other via `relocating_node_id` (ref:
    ShardRouting.relocate/initializeTargetRelocatingShard). Target
    started commits the move (in-sync swap, source removed); target
    failure cancels it (source reverts to STARTED);
  * `disassociate_dead_nodes` removes a departed node's copies — a lost
    primary is replaced by promoting an in-sync STARTED replica (primary
    term bump, ref: IndexMetadata.primaryTerm fencing) and a replacement
    replica goes back to UNASSIGNED, stamped with a delayed-allocation
    deadline (ref: UnassignedInfo.delayed) so a bounced node can rejoin
    and reclaim its own copies;
  * shard-started / shard-failed transitions mirror the master-side
    routing state machine (ref: ShardStateAction.java).

Pure functions of state -> state: the master applies them inside its
single-threaded update queue, publishes, and node-local appliers react.
An injectable clock keeps the delayed-allocation deadline fake-clock
testable.

The port's copy of elasticsearch_tpu/cluster/allocation.py. The REST
node's `_cluster/reroute` runs `reroute` on its own state; the
multi-node master that drives the rest comes with the cluster path
(ROADMAP item 10a).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Set, Tuple

from elasticsearch_tpu_torch.cluster.state import ClusterState, ShardRouting

# dynamic cluster settings consulted by the deciders (set through
# PUT /_cluster/settings and replicated inside ClusterState.settings)
EXCLUDE_NAME_SETTING = "cluster.routing.allocation.exclude._name"
CONCURRENT_RELOC_SETTING = \
    "cluster.routing.allocation.cluster_concurrent_rebalance"
DEFAULT_CONCURRENT_RELOCATIONS = 2


def _new_allocation_id() -> str:
    return uuid.uuid4().hex[:20]


def _data_nodes(state: ClusterState) -> List[str]:
    return sorted(nid for nid, n in state.nodes.items() if "data" in n.roles)


def _excluded_nodes(state: ClusterState) -> Set[str]:
    """Nodes being drained: exclude._name matches node name or id."""
    raw = state.settings.get(EXCLUDE_NAME_SETTING, "")
    names = {p.strip() for p in raw.split(",") if p.strip()}
    if not names:
        return set()
    out: Set[str] = set()
    for nid, n in state.nodes.items():
        if nid in names or n.name in names:
            out.add(nid)
    # a drained node may have already left; keep raw names so its copies
    # (if any remain) are still treated as excluded
    return out | names


def _relocation_cap(state: ClusterState) -> int:
    raw = state.settings.get(CONCURRENT_RELOC_SETTING)
    try:
        return int(raw) if raw is not None else DEFAULT_CONCURRENT_RELOCATIONS
    except ValueError:
        return DEFAULT_CONCURRENT_RELOCATIONS


def _relocations_in_flight(state: ClusterState) -> int:
    return sum(1 for shards in state.routing.values()
               for r in shards if r.state == "RELOCATING")


def _shard_counts(state: ClusterState) -> Dict[str, int]:
    """Copies per node for balance decisions. A moving copy counts at its
    target (where it will land), not at its RELOCATING source — so one
    reroute pass doesn't schedule the same shard twice."""
    counts = {nid: 0 for nid in _data_nodes(state)}
    for shards in state.routing.values():
        for r in shards:
            if r.node_id in counts and r.state in ("INITIALIZING", "STARTED"):
                counts[r.node_id] += 1
    return counts


def _occupied_nodes(shards: List[ShardRouting], shard_id: int) -> Set[str]:
    return {r.node_id for r in shards
            if r.shard_id == shard_id and r.node_id is not None
            and r.state != "UNASSIGNED"}


class AllocationService:
    """Master-side routing computations (pure state transitions)."""

    def __init__(self, clock: Optional[Callable[[], int]] = None):
        # wall-clock in ms; injectable for fake-clock delayed-allocation
        # tests (the master update queue owns the real timer)
        self._clock = clock or (lambda: int(time.time() * 1000))

    def now_ms(self) -> int:
        return self._clock()

    def reroute(self, state: ClusterState,
                now_ms: Optional[int] = None) -> ClusterState:
        """Assign unassigned copies, then run the maintenance deciders
        (drain + rebalance) bounded by the concurrent-relocations cap."""
        if now_ms is None:
            now_ms = self._clock()
        state = self._allocate_unassigned(state, now_ms)
        state = self._drain_excluded(state)
        state = self._rebalance(state)
        return state

    # ---- unassigned allocation (balanced allocator) ----

    def _allocate_unassigned(self, state: ClusterState,
                             now_ms: int) -> ClusterState:
        counts = _shard_counts(state)
        if not counts:
            return state
        excluded = _excluded_nodes(state)
        changed = False
        new_routing: Dict[str, List[ShardRouting]] = {}
        for index, shards in state.routing.items():
            remaining = list(shards)
            out: List[ShardRouting] = []
            # node ids already holding a copy, per shard id
            occupied: Dict[int, Set[str]] = {}
            for r in remaining:
                if r.node_id is not None and r.state != "UNASSIGNED":
                    occupied.setdefault(r.shard_id, set()).add(r.node_id)
                    if r.relocating_node_id and r.state == "RELOCATING":
                        occupied[r.shard_id].add(r.relocating_node_id)
            # primaries first: a replica can only initialize against a
            # started primary (ref: ReplicaShardAllocator waits for primary)
            for want_primary in (True, False):
                for r in list(remaining):
                    if r.primary != want_primary or r.state != "UNASSIGNED":
                        continue
                    if not r.primary:
                        primary = next(
                            (p for p in remaining + out
                             if p.shard_id == r.shard_id and p.primary), None)
                        if primary is None or primary.state not in (
                                "STARTED", "RELOCATING"):
                            continue
                    taken = occupied.get(r.shard_id, set())
                    candidates = [n for n in counts
                                  if n not in taken and n not in excluded]
                    delayed = (r.delayed_until_ms is not None
                               and r.delayed_until_ms > now_ms)
                    if delayed:
                        # inside the window the copy only goes back to the
                        # node that last held it — rejoin reuse, no storm
                        candidates = [n for n in candidates
                                      if n == r.last_node_id]
                    if not candidates:
                        continue
                    target = min(candidates, key=lambda n: (counts[n], n))
                    counts[target] += 1
                    occupied.setdefault(r.shard_id, set()).add(target)
                    remaining.remove(r)
                    out.append(ShardRouting(
                        index=index, shard_id=r.shard_id, node_id=target,
                        primary=r.primary, state="INITIALIZING",
                        allocation_id=_new_allocation_id()))
                    changed = True
            out.extend(remaining)
            out.sort(key=lambda r: (r.shard_id, not r.primary, r.allocation_id))
            new_routing[index] = out
        if not changed:
            return state
        st = state
        for index, entries in new_routing.items():
            st = st.with_routing_updates(index, entries)
        return st

    # ---- relocation state machine ----

    def initiate_relocation(self, state: ClusterState, index: str,
                            shard_id: int, allocation_id: str,
                            target_node: str) -> ClusterState:
        """STARTED copy -> RELOCATING source + INITIALIZING target pair
        (ref: RoutingNodes.relocateShard). Returns state unchanged when
        the move is not legal (missing copy, target already holds one,
        target unknown/excluded-same-shard)."""
        shards = list(state.routing.get(index, []))
        source = next((r for r in shards
                       if r.shard_id == shard_id
                       and r.allocation_id == allocation_id
                       and r.state == "STARTED"), None)
        if source is None or source.node_id == target_node:
            return state
        if target_node not in state.nodes:
            return state
        if target_node in _occupied_nodes(shards, shard_id):
            return state
        i = shards.index(source)
        shards[i] = replace(source, state="RELOCATING",
                            relocating_node_id=target_node)
        shards.append(ShardRouting(
            index=index, shard_id=shard_id, node_id=target_node,
            primary=source.primary, state="INITIALIZING",
            allocation_id=_new_allocation_id(),
            relocating_node_id=source.node_id))
        shards.sort(key=lambda r: (r.shard_id, not r.primary, r.allocation_id))
        return state.with_routing_updates(index, shards)

    def _relocation_pair(self, shards: List[ShardRouting],
                         r: ShardRouting) -> Optional[ShardRouting]:
        """The other half of a relocation: source <-> target."""
        if r.relocating_node_id is None:
            return None
        want_state = "INITIALIZING" if r.state == "RELOCATING" \
            else "RELOCATING"
        for other in shards:
            if (other.shard_id == r.shard_id
                    and other.state == want_state
                    and other.node_id == r.relocating_node_id
                    and other.relocating_node_id == r.node_id):
                return other
        return None

    def _cancel_relocation(self, state: ClusterState, index: str,
                           shards: List[ShardRouting],
                           target: ShardRouting) -> Tuple[List[ShardRouting],
                                                          ClusterState]:
        """Target failed/lost: drop it and revert the source to STARTED
        (still serving — nothing was lost)."""
        from elasticsearch_tpu_torch.common.relocation import count
        shards.remove(target)
        source = self._relocation_pair(shards, target)
        if source is not None:
            shards[shards.index(source)] = replace(
                source, state="STARTED", relocating_node_id=None)
        count("cancels")
        return shards, state

    def apply_started_shard(self, state: ClusterState, index: str,
                            shard_id: int, allocation_id: str) -> ClusterState:
        """INITIALIZING -> STARTED; add to the in-sync set (ref:
        ShardStateAction.ShardStartedClusterStateTaskExecutor +
        IndexMetadataUpdater.applyChanges adds the allocation id). A
        relocation target completing commits the move: the source leaves
        routing and the in-sync set in the same update."""
        shards = list(state.routing.get(index, []))
        started = next((r for r in shards
                        if r.shard_id == shard_id
                        and r.allocation_id == allocation_id
                        and r.state == "INITIALIZING"), None)
        if started is None:
            return state
        source = self._relocation_pair(shards, started)
        removed_aid: Optional[str] = None
        if started.relocating_node_id is not None and source is not None:
            from elasticsearch_tpu_torch.common.relocation import count
            shards.remove(source)
            removed_aid = source.allocation_id
            count("moves")
        shards[shards.index(started)] = replace(
            started, state="STARTED", relocating_node_id=None,
            delayed_until_ms=None, last_node_id=None)
        st = state.with_routing_updates(index, shards)
        meta = st.indices[index]
        in_sync = set(meta.in_sync_allocations.get(shard_id, ()))
        in_sync.add(allocation_id)
        if removed_aid is not None:
            in_sync.discard(removed_aid)
        return st.with_index_metadata(
            meta.with_in_sync(shard_id, tuple(sorted(in_sync))))

    def apply_failed_shard(self, state: ClusterState, index: str,
                           shard_id: int, allocation_id: str) -> ClusterState:
        """Remove a failed copy from routing and the in-sync set, then leave
        an UNASSIGNED replacement (ref: ShardStateAction shard-failed).
        Relocation halves fail specially: a failed target cancels the move
        (source reverts, keeps serving, no replacement); a failed source
        takes its half-recovered target down with it."""
        shards = list(state.routing.get(index, []))
        failed = next((r for r in shards
                       if r.shard_id == shard_id
                       and r.allocation_id == allocation_id), None)
        if failed is None:
            return state
        st = state
        if (failed.state == "INITIALIZING"
                and failed.relocating_node_id is not None):
            pair = self._relocation_pair(shards, failed)
            shards, st = self._cancel_relocation(st, index, shards, failed)
            if pair is None:
                # orphaned target (source already gone): plain removal
                shards.append(ShardRouting(
                    index=index, shard_id=shard_id, node_id=None,
                    primary=False, state="UNASSIGNED"))
            st = st.with_routing_updates(index, shards)
            return self.reroute(st)
        removed = [failed]
        shards.remove(failed)
        if failed.state == "RELOCATING":
            target = self._relocation_pair(shards, failed)
            if target is not None:
                shards.remove(target)
                removed.append(target)
        if failed.primary:
            shards, st = _promote_replacement(st, index, shard_id, shards)
        shards.append(ShardRouting(index=index, shard_id=shard_id,
                                   node_id=None, primary=False,
                                   state="UNASSIGNED"))
        st = st.with_routing_updates(index, shards)
        meta = st.indices[index]
        in_sync = set(meta.in_sync_allocations.get(shard_id, ()))
        for r in removed:
            in_sync.discard(r.allocation_id)
        st = st.with_index_metadata(
            meta.with_in_sync(shard_id, tuple(sorted(in_sync))))
        return self.reroute(st)

    def disassociate_dead_nodes(self, state: ClusterState, dead: Set[str],
                                delayed_ms: Optional[int] = None,
                                ) -> ClusterState:
        """Node-left: drop the node, promote replicas for its primaries,
        queue replacements (ref: NodeRemovalClusterStateTaskExecutor ->
        AllocationService.disassociateDeadNodes). Replacement replicas are
        stamped with a delayed-allocation deadline so a bounced node can
        rejoin and recover its own copies; in-flight relocations touching
        a dead node resolve (dead target -> source reverts; dead source ->
        target dies with it, promotion covers the shard)."""
        if delayed_ms is None:
            from elasticsearch_tpu_torch.common.settings import knob
            delayed_ms = knob("ES_TPU_DELAYED_ALLOC_MS")
        now = self._clock()
        st = state
        for nid in dead:
            st = st.without_node(nid)
        for index in list(st.routing):
            shards = list(st.routing[index])
            lost = [r for r in shards if r.node_id in dead]
            if not lost:
                continue
            # resolve relocations first: a dead target is a clean cancel
            # (the source still serves — no copy was lost)
            for r in list(lost):
                if (r.state == "INITIALIZING"
                        and r.relocating_node_id is not None):
                    shards, st = self._cancel_relocation(st, index, shards, r)
                    lost.remove(r)
            for r in lost:
                shards.remove(r)
            meta = st.indices[index]
            for r in lost:
                if r.state == "RELOCATING":
                    # dead source: the target can't finish recovering from
                    # it — drop the half-built target too
                    target = self._relocation_pair(shards, r)
                    if target is not None:
                        shards.remove(target)
                        in_sync = set(meta.in_sync_allocations.get(
                            r.shard_id, ()))
                        in_sync.discard(target.allocation_id)
                        meta = meta.with_in_sync(
                            r.shard_id, tuple(sorted(in_sync)))
                        st = st.with_index_metadata(meta)
                if r.primary:
                    shards, st = _promote_replacement(st, index, r.shard_id,
                                                      shards)
                    meta = st.indices[index]
                shards.append(ShardRouting(
                    index=index, shard_id=r.shard_id, node_id=None,
                    primary=False, state="UNASSIGNED",
                    delayed_until_ms=(now + delayed_ms) if delayed_ms > 0
                    else None,
                    last_node_id=r.node_id))
            for r in lost:
                in_sync = set(meta.in_sync_allocations.get(r.shard_id, ()))
                # the departed copy leaves the in-sync set only if a live
                # copy remains to serve as primary; otherwise keeping it
                # records which copy a future allocate-stale must find
                survivors = [s for s in shards
                             if s.shard_id == r.shard_id and s.serving]
                if survivors:
                    in_sync.discard(r.allocation_id)
                    meta = meta.with_in_sync(r.shard_id, tuple(sorted(in_sync)))
            st = st.with_index_metadata(meta)
            st = st.with_routing_updates(index, shards)
        return self.reroute(st)

    # ---- maintenance deciders ----

    def _drain_excluded(self, state: ClusterState) -> ClusterState:
        """FilterAllocationDecider analog: relocate STARTED copies off
        nodes named by cluster.routing.allocation.exclude._name."""
        excluded = _excluded_nodes(state)
        if not excluded:
            return state
        budget = _relocation_cap(state) - _relocations_in_flight(state)
        if budget <= 0:
            return state
        counts = _shard_counts(state)
        st = state
        for index in sorted(st.routing):
            for r in sorted(st.routing[index],
                            key=lambda r: (r.shard_id, not r.primary)):
                if budget <= 0:
                    return st
                if r.state != "STARTED" or r.node_id not in excluded:
                    continue
                taken = _occupied_nodes(st.routing[index], r.shard_id)
                candidates = [n for n in counts
                              if n not in taken and n not in excluded]
                if not candidates:
                    continue
                target = min(candidates, key=lambda n: (counts[n], n))
                moved = self.initiate_relocation(
                    st, index, r.shard_id, r.allocation_id, target)
                if moved is not st:
                    counts[target] += 1
                    budget -= 1
                    st = moved
        return st

    def _rebalance(self, state: ClusterState) -> ClusterState:
        """Shard-count rebalancer: move copies from the most- to the
        least-loaded data node while the spread is >= 2 (a newly joined
        empty node attracts copies without thrashing a balanced pair)."""
        budget = _relocation_cap(state) - _relocations_in_flight(state)
        st = state
        excluded = _excluded_nodes(st)
        while budget > 0:
            counts = _shard_counts(st)
            eligible = {n: c for n, c in counts.items() if n not in excluded}
            if len(eligible) < 2:
                return st
            lo = min(eligible, key=lambda n: (eligible[n], n))
            hi = max(eligible, key=lambda n: (eligible[n], n))
            if eligible[hi] - eligible[lo] < 2:
                return st
            moved_any = False
            for index in sorted(st.routing):
                for r in sorted(st.routing[index],
                                key=lambda r: (r.shard_id, not r.primary)):
                    if (r.state != "STARTED" or r.node_id != hi
                            or lo in _occupied_nodes(st.routing[index],
                                                     r.shard_id)):
                        continue
                    moved = self.initiate_relocation(
                        st, index, r.shard_id, r.allocation_id, lo)
                    if moved is not st:
                        st = moved
                        budget -= 1
                        moved_any = True
                        break
                if moved_any:
                    break
            if not moved_any:
                return st
        return st


def _promote_replacement(state: ClusterState, index: str, shard_id: int,
                         shards: List[ShardRouting]):
    """Pick the in-sync STARTED replica to promote to primary; bump the
    shard's primary term (ref: RoutingNodes.promoteActiveReplicaShardToPrimary
    + IndexMetadataUpdater primary-term increment)."""
    meta = state.indices[index]
    in_sync = set(meta.in_sync_allocations.get(shard_id, ()))
    candidates = [r for r in shards
                  if r.shard_id == shard_id and not r.primary
                  and r.state == "STARTED" and r.allocation_id in in_sync]
    if not candidates:
        return shards, state     # red shard: no safe copy to promote
    chosen = sorted(candidates, key=lambda r: r.allocation_id)[0]
    shards[shards.index(chosen)] = ShardRouting(
        index=index, shard_id=shard_id, node_id=chosen.node_id,
        primary=True, state="STARTED", allocation_id=chosen.allocation_id)
    state = state.with_index_metadata(meta.with_primary_term_bump(shard_id))
    return shards, state
