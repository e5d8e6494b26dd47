"""Cluster coordination: Raft-like consensus with voting configurations.

Re-designs the reference coordination layer (ref:
cluster/coordination/Coordinator.java:87, CoordinationState.java,
PreVoteCollector.java, ElectionSchedulerFactory.java, Publication.java,
FollowersChecker.java, LeaderChecker.java) as a transport-agnostic state
machine driven by an injected clock/scheduler, so the SAME code runs in
production (real transport + wall clock) and in the deterministic
simulation harness (virtual time + disruptable transport).

Safety core (CoordinationState):
  * terms: a node votes at most once per term; a candidate needs a quorum
    of joins in BOTH the last-committed and the last-accepted voting
    configurations (joint consensus for reconfiguration).
  * publish: two-phase — leader sends the new state; a quorum of accepts in
    both configs commits it; commits broadcast; followers apply on commit.
  * a join carries the voter's last accepted (term, version) and is only
    granted to candidates whose accepted state is at least as fresh.

Liveness: randomized election scheduling with backoff, pre-vote rounds to
avoid disrupting a live leader, leader/follower fault checkers.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Set


# --------------------------------------------------------------------------
# value + vote model
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PublishedState:
    """The replicated value: an opaque payload + consensus bookkeeping."""

    term: int
    version: int
    value: Any
    config: frozenset            # committed voting configuration (node ids)
    last_committed_config: frozenset

    def quorum(self, votes: Set[str]) -> bool:
        """Joint consensus: quorum in BOTH configs (ref: VotingConfiguration
        + Reconfigurator joint requirement)."""
        return _has_quorum(votes, self.config) and _has_quorum(votes, self.last_committed_config)


def _has_quorum(votes: Set[str], config: frozenset) -> bool:
    return len(votes & config) * 2 > len(config)


@dataclass
class Join:
    voter: str
    target: str
    term: int
    last_accepted_term: int
    last_accepted_version: int


# --------------------------------------------------------------------------
# CoordinationState — the pure safety state machine
# --------------------------------------------------------------------------


class CoordinationError(Exception):
    pass


class CoordinationState:
    """Persisted consensus state of one node (ref: CoordinationState.java).

    `persistor(doc)` — when given — is invoked synchronously BEFORE any
    safety-critical transition returns (vote cast, publish accepted, commit):
    a restarted node must never vote twice in one term or forget an accepted
    publication (ref: gateway/GatewayMetaState.java persisted-state wrapper).
    """

    def __init__(self, node_id: str, initial: PublishedState, persistor=None):
        self.node_id = node_id
        self.current_term = initial.term
        self.accepted = initial               # last accepted (maybe uncommitted)
        self.last_committed_version = initial.version
        # the config of the last state that actually COMMITTED — the joint-
        # consensus base for any new publication. Chaining it off uncommitted
        # accepted states would let an isolated leader shrink its own quorum.
        self.committed_config: frozenset = initial.config
        self.join_vote_term = 0               # term we voted in
        self.election_won = False
        self.join_votes: Set[str] = set()
        self.publish_votes: Set[str] = set()
        self.persistor = persistor

    # ---- durability ----

    def to_doc(self) -> dict:
        return {"current_term": self.current_term,
                "join_vote_term": self.join_vote_term,
                "accepted": _state_to_wire(self.accepted),
                "last_committed_version": self.last_committed_version,
                "committed_config": sorted(self.committed_config)}

    @classmethod
    def from_doc(cls, node_id: str, doc: dict, persistor=None) -> "CoordinationState":
        st = cls(node_id, _state_from_wire(doc["accepted"]), persistor)
        st.current_term = doc["current_term"]
        st.join_vote_term = doc["join_vote_term"]
        st.last_committed_version = doc["last_committed_version"]
        st.committed_config = frozenset(doc["committed_config"])
        return st

    def _persist(self) -> None:
        if self.persistor is not None:
            self.persistor(self.to_doc())

    # ---- term/vote handling ----

    def handle_start_join(self, target: str, term: int) -> Join:
        """A candidate asked us to join its term: bump term, grant the vote."""
        if term <= self.current_term:
            raise CoordinationError(
                f"incoming term {term} not greater than {self.current_term}")
        self.current_term = term
        self.join_vote_term = term
        self.election_won = False
        self.join_votes = set()
        self.publish_votes = set()
        self._persist()     # the vote must be durable before it is cast
        return Join(voter=self.node_id, target=target, term=term,
                    last_accepted_term=self.accepted.term,
                    last_accepted_version=self.accepted.version)

    def handle_join(self, join: Join) -> bool:
        """Candidate side: absorb a join; True when the election is won."""
        if join.term != self.current_term:
            raise CoordinationError(
                f"join term {join.term} != current {self.current_term}")
        # the voter must not know a fresher accepted state than ours
        if (join.last_accepted_term, join.last_accepted_version) > (
                self.accepted.term, self.accepted.version):
            raise CoordinationError("joiner has fresher state")
        self.join_votes.add(join.voter)
        won = self.accepted.quorum(self.join_votes)
        if won and not self.election_won:
            self.election_won = True
        return self.election_won

    # ---- publication (leader) ----

    def handle_client_value(self, value: Any,
                            new_config: Optional[frozenset] = None) -> PublishedState:
        if not self.election_won:
            raise CoordinationError("not leader")
        st = PublishedState(
            term=self.current_term,
            version=self.accepted.version + 1,
            value=value,
            config=new_config if new_config is not None else self.accepted.config,
            last_committed_config=self.committed_config,
        )
        self.publish_votes = set()
        self.accepted = st
        self._persist()
        return st

    # ---- publication (any node) ----

    def handle_publish_request(self, st: PublishedState) -> "PublishResponse":
        if st.term != self.current_term:
            raise CoordinationError(
                f"publish term {st.term} != current {self.current_term}")
        if st.term == self.accepted.term and st.version <= self.accepted.version:
            raise CoordinationError(
                f"publish version {st.version} not newer than accepted "
                f"{self.accepted.version}")
        self.accepted = st
        self._persist()     # accepted state must survive restart before ack
        return PublishResponse(node_id=self.node_id, term=st.term, version=st.version)

    def handle_publish_response(self, resp: "PublishResponse") -> bool:
        """Leader side: True when this publication reached commit quorum."""
        if resp.term != self.current_term:
            raise CoordinationError("stale publish response")
        if resp.version != self.accepted.version:
            return False
        self.publish_votes.add(resp.node_id)
        return self.accepted.quorum(self.publish_votes)

    def handle_commit(self, term: int, version: int) -> PublishedState:
        if term != self.accepted.term or version != self.accepted.version:
            raise CoordinationError(
                f"commit for {term}/{version} but accepted is "
                f"{self.accepted.term}/{self.accepted.version}")
        self.last_committed_version = version
        self.committed_config = self.accepted.config
        committed = replace(self.accepted, last_committed_config=self.accepted.config)
        self.accepted = committed
        self._persist()
        return committed


@dataclass
class PublishResponse:
    node_id: str
    term: int
    version: int


# --------------------------------------------------------------------------
# Coordinator — modes, elections, fault detection
# --------------------------------------------------------------------------

CANDIDATE, LEADER, FOLLOWER = "CANDIDATE", "LEADER", "FOLLOWER"


class Coordinator:
    """One node's coordination behavior (ref: Coordinator.java modes).

    transport: send(to_node_id, message: dict, on_reply, on_error)
    scheduler: schedule_at(delay_ms, fn) -> handle with .cancel()
    on_commit: callback(PublishedState) when a state commits locally.
    """

    ELECTION_INITIAL_MS = 100
    ELECTION_BACKOFF_MS = 100
    ELECTION_MAX_MS = 10_000
    ELECTION_DURATION_MS = 300
    FOLLOWER_CHECK_INTERVAL_MS = 1000
    FOLLOWER_CHECK_RETRIES = 3
    LEADER_CHECK_INTERVAL_MS = 1000
    LEADER_CHECK_RETRIES = 3
    PUBLISH_TIMEOUT_MS = 30_000

    def __init__(self, node_id: str, initial: PublishedState, transport,
                 scheduler, rng, on_commit: Callable[[PublishedState], None],
                 persistor=None, restored: Optional[dict] = None):
        self.node_id = node_id
        if restored is not None:
            self.state = CoordinationState.from_doc(node_id, restored, persistor)
        else:
            self.state = CoordinationState(node_id, initial, persistor)
        self.transport = transport
        self.scheduler = scheduler
        self.rng = rng
        self.on_commit = on_commit
        self.mode = CANDIDATE
        self.leader_id: Optional[str] = None
        self.last_known_peers: Set[str] = set(initial.config)
        self._election_attempt = 0
        self._election_handle = None
        self._checker_handle = None
        self._follower_failures: Dict[str, int] = {}
        self.stopped = False

    # ---- lifecycle ----

    def start(self) -> None:
        self._become_candidate("startup")

    def stop(self) -> None:
        self.stopped = True
        self._cancel_timers()

    def _cancel_timers(self) -> None:
        for h in (self._election_handle, self._checker_handle):
            if h is not None:
                h.cancel()
        self._election_handle = self._checker_handle = None

    # ---- mode transitions ----

    def _become_candidate(self, reason: str) -> None:
        self.mode = CANDIDATE
        self.leader_id = None
        self.state.election_won = False
        self._cancel_timers()
        self._schedule_election()

    def _become_leader(self) -> None:
        self.mode = LEADER
        self.leader_id = self.node_id
        self._cancel_timers()
        self._follower_failures = {}
        self._schedule_follower_checks()
        # republish the current state so the new term commits a state
        # (ref: Coordinator.becomeLeader -> publishes a no-op join state)
        self.publish(self.state.accepted.value)

    def _become_follower(self, leader_id: str) -> None:
        if self.mode == FOLLOWER and self.leader_id == leader_id:
            return
        self.mode = FOLLOWER
        self.leader_id = leader_id
        self._cancel_timers()
        self._schedule_leader_checks()

    # ---- elections ----

    def _schedule_election(self) -> None:
        if self.stopped:
            return
        self._election_attempt += 1
        backoff = min(self.ELECTION_MAX_MS,
                      self.ELECTION_INITIAL_MS
                      + self.ELECTION_BACKOFF_MS * self._election_attempt)
        delay = self.rng.random() * backoff + 10
        self._election_handle = self.scheduler.schedule_at(delay, self._start_prevote)

    def _start_prevote(self) -> None:
        if self.stopped or self.mode != CANDIDATE:
            return
        # pre-vote round (ref: PreVoteCollector): ask peers whether they'd
        # vote for us — avoids term inflation when partitioned
        votes: Set[str] = {self.node_id}
        acc = self.state.accepted
        responded = {"won": False}

        def on_reply(peer, reply):
            leader_hint = reply.get("leader")
            if leader_hint and leader_hint != self.node_id and self.mode == CANDIDATE:
                # a live leader exists: ask it to take us (back) in rather
                # than disrupting it with an election
                self.transport.send(self.node_id, leader_hint,
                                    {"type": "request_rejoin"}, lambda r: None)
            if reply.get("grant") and not responded["won"]:
                votes.add(peer)
                if acc.quorum(votes):
                    responded["won"] = True
                    self._start_election()

        for peer in self._peers():
            self.transport.send(
                self.node_id, peer,
                {"type": "pre_vote", "term": self.state.current_term,
                 "last_accepted_term": acc.term, "last_accepted_version": acc.version},
                lambda reply, peer=peer: on_reply(peer, reply))
        if acc.quorum(votes):          # single-node cluster
            self._start_election()
        if self.mode == CANDIDATE:     # retry with backoff until a leader exists
            self._schedule_election()

    def _start_election(self) -> None:
        if self.stopped or self.mode != CANDIDATE:
            return
        term = self.state.current_term + 1
        try:
            own_join = self.state.handle_start_join(self.node_id, term)
            self._on_join(own_join)
        except CoordinationError:
            return
        for peer in self._peers():
            self.transport.send(
                self.node_id, peer,
                {"type": "start_join", "term": term},
                self._on_join_reply)

    def _on_join_reply(self, reply: dict) -> None:
        if self.stopped or reply.get("type") != "join":
            return
        join = Join(**{k: reply[k] for k in
                       ("voter", "target", "term", "last_accepted_term",
                        "last_accepted_version")})
        self._on_join(join)

    def _on_join(self, join: Join) -> None:
        if join.term != self.state.current_term or join.target != self.node_id:
            return
        if self.mode == LEADER:
            self.state.join_votes.add(join.voter)
            return
        try:
            won = self.state.handle_join(join)
        except CoordinationError:
            return
        if won and self.mode == CANDIDATE:
            self._become_leader()

    # ---- inbound messages ----

    def handle_message(self, sender: str, msg: dict, reply: Callable[[dict], None]) -> None:
        if self.stopped:
            return
        t = msg["type"]
        if t == "pre_vote":
            acc = self.state.accepted
            grant = (msg["term"] >= self.state.current_term
                     and (msg["last_accepted_term"], msg["last_accepted_version"])
                     >= (acc.term, acc.version)
                     and (self.mode != FOLLOWER or self.leader_id is None))
            # leader hint lets an ousted/rejoining candidate find the live
            # leader and ask to be re-added (ref: JoinHelper discovery)
            leader_hint = self.leader_id if self.mode in (FOLLOWER, LEADER) else None
            if self.mode == LEADER:
                leader_hint = self.node_id
            reply({"type": "pre_vote_response", "grant": grant,
                   "leader": leader_hint})
        elif t == "request_rejoin":
            if self.mode == LEADER:
                self.on_node_joined(sender)
        elif t == "start_join":
            try:
                join = self.state.handle_start_join(sender, msg["term"])
            except CoordinationError:
                return
            if self.mode != CANDIDATE:
                self._become_candidate("saw higher term")
            reply({"type": "join", "voter": join.voter, "target": sender,
                   "term": join.term,
                   "last_accepted_term": join.last_accepted_term,
                   "last_accepted_version": join.last_accepted_version})
        elif t == "publish":
            st = _state_from_wire(msg["state"])
            if st.term > self.state.current_term:
                # implicit join of the newer term
                try:
                    self.state.handle_start_join(sender, st.term)
                except CoordinationError:
                    return
            try:
                resp = self.state.handle_publish_request(st)
            except CoordinationError:
                # idempotent re-ack when the leader re-sends the state we
                # already accepted (catch-up of a follower that accepted a
                # version but missed its commit — without this the commit is
                # never re-sent and the follower lags forever)
                if (st.term == self.state.current_term
                        and st.term == self.state.accepted.term
                        and st.version == self.state.accepted.version):
                    self._become_follower(sender)
                    reply({"type": "publish_response", "node_id": self.node_id,
                           "term": st.term, "version": st.version})
                return
            self._become_follower(sender)
            reply({"type": "publish_response", "node_id": resp.node_id,
                   "term": resp.term, "version": resp.version})
        elif t == "commit":
            try:
                committed = self.state.handle_commit(msg["term"], msg["version"])
            except CoordinationError:
                return
            self.last_known_peers = set(committed.config)
            self.on_commit(committed)
            reply({"type": "commit_response"})
        elif t == "follower_check":
            if msg["term"] == self.state.current_term and self.mode == FOLLOWER:
                reply({"type": "follower_check_response", "ok": True,
                       "last_committed_version": self.state.last_committed_version,
                       "last_committed_term": self.state.accepted.term})
            elif msg["term"] >= self.state.current_term:
                # not yet following this leader: adopt its term first, else
                # our stale-term leader_checks would bounce us straight back
                # to candidate (ref: Coordinator.onFollowerCheckRequest calls
                # ensureTermAtLeast before becomeFollower)
                if msg["term"] > self.state.current_term:
                    try:
                        self.state.handle_start_join(sender, msg["term"])
                    except CoordinationError:
                        pass
                self._become_follower(sender)
                reply({"type": "follower_check_response", "ok": True,
                       "last_committed_version": self.state.last_committed_version,
                       "last_committed_term": self.state.accepted.term})
            else:
                reply({"type": "follower_check_response", "ok": False})
        elif t == "leader_check":
            ok = self.mode == LEADER and msg["term"] == self.state.current_term
            reply({"type": "leader_check_response", "ok": ok})

    # ---- publication ----

    def publish(self, value: Any, new_config: Optional[frozenset] = None) -> tuple:
        """Leader: replicate a new state (ref: Coordinator.publish).

        Returns the publication's (term, version) so callers can await THIS
        publication's commit rather than any concurrent commit."""
        if self.mode != LEADER:
            raise CoordinationError("not the leader")
        st = self.state.handle_client_value(value, new_config)
        wire = _state_to_wire(st)
        committed = {"done": False}

        def on_publish_reply(reply: dict) -> None:
            if self.stopped or reply.get("type") != "publish_response":
                return
            resp = PublishResponse(reply["node_id"], reply["term"], reply["version"])
            try:
                ready = self.state.handle_publish_response(resp)
            except CoordinationError:
                return
            if ready and not committed["done"]:
                committed["done"] = True
                self._broadcast_commit(st)

        # handle_client_value already accepted st locally; record our own vote
        try:
            own = PublishResponse(self.node_id, st.term, st.version)
            ready = self.state.handle_publish_response(own)
        except CoordinationError:
            return (st.term, st.version)
        for peer in self._peers(st):
            self.transport.send(self.node_id, peer,
                                {"type": "publish", "state": wire},
                                on_publish_reply)
        if ready and not committed["done"]:
            committed["done"] = True
            self._broadcast_commit(st)

        def on_timeout():
            # a leader that cannot commit has lost its quorum: step down
            # (ref: Publication timeout -> Coordinator.becomeCandidate)
            if not committed["done"] and not self.stopped and self.mode == LEADER \
                    and self.state.accepted.version == st.version \
                    and self.state.current_term == st.term:
                self._become_candidate("publication timed out")

        self.scheduler.schedule_at(self.PUBLISH_TIMEOUT_MS, on_timeout)
        return (st.term, st.version)

    def _broadcast_commit(self, st: PublishedState) -> None:
        try:
            committed = self.state.handle_commit(st.term, st.version)
        except CoordinationError:
            return
        self.last_known_peers = set(committed.config)
        self.on_commit(committed)
        for peer in self._peers(st):
            self.transport.send(self.node_id, peer,
                                {"type": "commit", "term": st.term,
                                 "version": st.version}, lambda r: None)

    # ---- fault detection ----

    def _schedule_follower_checks(self) -> None:
        if self.stopped or self.mode != LEADER:
            return

        def tick():
            if self.stopped or self.mode != LEADER:
                return
            for peer in self._peers():
                self._check_follower(peer)
            self._schedule_follower_checks()

        self._checker_handle = self.scheduler.schedule_at(
            self.FOLLOWER_CHECK_INTERVAL_MS, tick)

    def _check_follower(self, peer: str) -> None:
        def on_reply(reply):
            if reply.get("ok"):
                self._follower_failures[peer] = 0
                # lag detection: a healed/rejoined follower that missed
                # publishes gets the current committed state pushed directly
                # (ref: LagDetector + full-state PublicationTransportHandler)
                if reply.get("last_committed_version", 1 << 62) \
                        < self.state.last_committed_version:
                    self._catch_up(peer)
            else:
                self._note_follower_failure(peer)

        self.transport.send(
            self.node_id, peer,
            {"type": "follower_check", "term": self.state.current_term},
            on_reply, on_error=lambda: self._note_follower_failure(peer))

    def _catch_up(self, peer: str) -> None:
        """Re-send the latest committed state to one lagging follower."""
        st = self.state.accepted
        if st.version != self.state.last_committed_version:
            return   # a publication is in flight; it will cover the gap

        def on_reply(reply):
            if reply.get("type") == "publish_response" and not self.stopped:
                self.transport.send(self.node_id, peer,
                                    {"type": "commit", "term": st.term,
                                     "version": st.version}, lambda r: None)

        self.transport.send(self.node_id, peer,
                            {"type": "publish", "state": _state_to_wire(st)},
                            on_reply)

    def _note_follower_failure(self, peer: str) -> None:
        if self.mode != LEADER:
            return
        n = self._follower_failures.get(peer, 0) + 1
        self._follower_failures[peer] = n
        if n >= self.FOLLOWER_CHECK_RETRIES:
            self._follower_failures[peer] = 0
            self.on_node_failed(peer)

    def on_node_failed(self, peer: str) -> None:
        """Auto-reconfiguration on failure (ref: Reconfigurator +
        NodeRemovalClusterStateTaskExecutor): shrink the voting config so the
        cluster survives further sequential failures. Joint consensus makes
        the shrink itself safe — the publish needs a quorum of BOTH the old
        committed config and the new one."""
        if self.mode != LEADER:
            return
        cfg = self.state.accepted.config
        if peer not in cfg or len(cfg) <= 1:
            return
        new_cfg = frozenset(cfg - {peer})
        try:
            self.publish(self.state.accepted.value, new_config=new_cfg)
        except CoordinationError:
            pass

    def on_node_joined(self, peer: str) -> None:
        """A previously-removed node came back: grow the voting config."""
        if self.mode != LEADER:
            return
        cfg = self.state.accepted.config
        if peer in cfg:
            return
        try:
            self.publish(self.state.accepted.value,
                         new_config=frozenset(cfg | {peer}))
        except CoordinationError:
            pass

    def _schedule_leader_checks(self) -> None:
        if self.stopped or self.mode != FOLLOWER:
            return
        failures = {"n": 0}

        def on_reply(reply):
            if reply.get("ok"):
                failures["n"] = 0
            else:
                note_failure()

        def note_failure():
            failures["n"] += 1
            if failures["n"] >= self.LEADER_CHECK_RETRIES:
                self._become_candidate("leader unresponsive")

        def tick():
            if self.stopped or self.mode != FOLLOWER or self.leader_id is None:
                return
            self.transport.send(self.node_id, self.leader_id,
                                {"type": "leader_check",
                                 "term": self.state.current_term},
                                on_reply, on_error=note_failure)
            self._checker_handle = self.scheduler.schedule_at(
                self.LEADER_CHECK_INTERVAL_MS, tick)

        self._checker_handle = self.scheduler.schedule_at(
            self.LEADER_CHECK_INTERVAL_MS, tick)

    # ---- helpers ----

    def _peers(self, st: Optional[PublishedState] = None) -> List[str]:
        cfg = set((st or self.state.accepted).config) | \
            set((st or self.state.accepted).last_committed_config) | \
            self.last_known_peers
        return sorted(cfg - {self.node_id})


def _state_to_wire(st: PublishedState) -> dict:
    return {"term": st.term, "version": st.version, "value": st.value,
            "config": sorted(st.config),
            "last_committed_config": sorted(st.last_committed_config)}


def _state_from_wire(d: dict) -> PublishedState:
    return PublishedState(term=d["term"], version=d["version"], value=d["value"],
                          config=frozenset(d["config"]),
                          last_committed_config=frozenset(d["last_committed_config"]))
