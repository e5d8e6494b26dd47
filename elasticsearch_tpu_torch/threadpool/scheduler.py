"""Continuous-batching dispatch scheduler: bucketed shapes, double
buffering, SLA tiers.

The fixed-window coalescer's ONE flush window and ONE padded shape force
the device to alternate between starvation (tiny batches after a full
2 ms wait) and giant pads (a stray single riding a 256-wide dispatch).
This module is the continuous-batching discipline of
modern inference servers applied to the search dispatch path:

- **bucketed batch shapes** — a small ladder of padded batch sizes
  (`ES_TPU_SCHED_BUCKETS`, default 1/4/16/64/256). Each bucket is one
  compiled kernel shape (the ladder is pushed into the engine's
  `qc_sizes` compile cache), and every flush picks the smallest bucket
  covering the queries that must go now, so light traffic never pays a
  heavy pad.
- **queue-depth-adaptive flush timing** — a flush fires the moment the
  largest bucket fills or the oldest waiter exceeds its SLA-tier budget;
  there is no fixed window. Under load the queue naturally deepens while
  the device is busy (both in-flight slots taken), so batches grow with
  pressure and shrink when it lifts.
- **double-buffered dispatch** — a dedicated dispatch thread per
  (engine, k) lane and `ES_TPU_SCHED_INFLIGHT` (default 2) in-flight
  slots: host demux + waiter wakeup of batch N overlap the device sweep
  of batch N+1. A slot is released by the LAST waiter to consume its
  batch, so deadline checks and fault accounting stay per-slot.
- **SLA tiers** — every request carries an `interactive` or `bulk` class
  (thread-pool classifier + optional `sla` request param, propagated
  across pool hops and shard RPCs like the trace context), with per-tier
  max-wait budgets (`ES_TPU_SCHED_INTERACTIVE_US` /
  `ES_TPU_SCHED_BULK_US`). A deep bulk backlog can never pin an
  interactive query past its budget: the interactive deadline triggers
  the flush, the bucket is sized to the queries that are DUE, and bulk
  only rides along in the pad slack that would be wasted anyway.

The coalescer's serving contracts are inherited, not re-invented: lanes
are keyed by (engine serial, k) so queries never share a dispatch across
engines or top-k depths; merged rows are bit-identical to solo rows (the
engines score per query-row); a poisoned batch is retried solo per query
(threadpool/coalescer.retry_batch_solo); cooperative `check()` runs only
at the caller boundary so one cancelled task can't fail its batch peers.

`ES_TPU_COALESCE_US=0` still disables batching entirely (every call
dispatches directly), and `ES_TPU_SCHED_MODE=legacy` routes serving
dispatches through the old fixed-window coalescer so the differential
suite can A/B the two schedulers bit-identically.

The port's copy of elasticsearch_tpu/threadpool/scheduler.py. The lane
thread runs each flushed batch through `DispatchCoalescer._run`, which
enters the engine's device scope (`coalescer.device_scope`): a kernel
launched there uses the engine's device and its current stream. A launch
that fails there (`KernelLaunchError`) is retried solo like any poisoned
batch and reaches its waiters as the same error; no plain version serves
it. The lane thread also drops a flushed batch before it waits for the
next, so an idle lane keeps no query (an agg collect's works hold their
layouts) alive. A flush always takes its first waiter, widening the
bucket past the ladder's top rung when that waiter is wider: the
reference builds an empty batch there, whose in-flight slot no waiter
releases, and after two such flushes the lane waits forever (an
autotuned ladder of (1,) and a waiter of two queries). "Compiled shape" below means one dispatch width of the
engine.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common import metrics, tracing
from elasticsearch_tpu_torch.common.settings import knob
from elasticsearch_tpu_torch.tasks import task_manager as _taskmgr
from elasticsearch_tpu_torch.threadpool.coalescer import (
    SMALL_BATCH_MAX, DispatchCoalescer, _engine_key, default_coalescer,
    record_device, retry_batch_solo,
)

TIER_INTERACTIVE = "interactive"
TIER_BULK = "bulk"
_TIERS = (TIER_INTERACTIVE, TIER_BULK)

DEFAULT_BUCKETS = (1, 4, 16, 64, 256)

# ladder autotune (knob unset): derive rungs from the observed flush-time
# demand. The queue-depth histogram (count kind, power-of-2 bucket upper
# bounds) gives the rung positions; the pad-ratio histogram decides
# whether to densify them. Each rung is one compiled kernel shape, so the
# ladder is cached and only re-derived after AUTOTUNE_REOBS more flushes.
AUTOTUNE_MIN_OBS = 64     # flushes before trusting the histograms at all
AUTOTUNE_REOBS = 256      # new flushes between ladder re-derivations
AUTOTUNE_CAP = 512        # largest rung autotune will compile
AUTOTUNE_PAD_P90 = 0.25   # p90 pad waste that triggers densification


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _derive_ladder(depth: dict, pad: Optional[dict]) -> Tuple[int, ...]:
    """Ladder from flush-time demand: rungs at the queue-depth p50/p90/p99
    (already power-of-2 bucket bounds) plus the rounded-up max, always
    anchored at 1 (a lone interactive query must never pad). When the
    observed pad waste stays high anyway, add geometric midpoints between
    adjacent rungs — halving the worst-case pad at the cost of more
    compiled shapes."""
    pts = {1}
    for key in ("p50", "p90", "p99"):
        v = int(depth.get(key, 0))
        if v > 0:
            pts.add(min(_next_pow2(v), AUTOTUNE_CAP))
    mx = int(depth.get("max", 0))
    if mx > 0:
        pts.add(min(_next_pow2(mx), AUTOTUNE_CAP))
    rungs = sorted(pts)
    if (pad and pad.get("count", 0) >= AUTOTUNE_MIN_OBS
            and pad.get("p90", 0.0) > AUTOTUNE_PAD_P90):
        dense = set(rungs)
        for lo, hi in zip(rungs, rungs[1:]):
            if hi >= 4 * lo:
                dense.add(_next_pow2(int((lo * hi) ** 0.5)))
        rungs = sorted(dense)
    return tuple(rungs)

# how long a lane's dispatch thread idles on an empty queue before
# retiring itself (and unregistering the lane, so a snapshot refresh's
# swapped-out engine can be garbage collected)
LANE_IDLE_S = 2.0


# ---------------------------------------------------------------------------
# SLA tier context: which class the current request belongs to. Mirrors the
# tracing.current()/activate() thread-local pattern; threadpool/pool.py
# captures the submitter's tier into each _Task and re-activates it in the
# worker, and action/search_action.py ferries it across shard RPCs.
# ---------------------------------------------------------------------------

_tier_tls = threading.local()


def current_tier() -> str:
    """The active SLA tier, defaulting to interactive (the tighter budget
    — misclassified traffic must not be starved)."""
    t = getattr(_tier_tls, "tier", None)
    return t if t in _TIERS else TIER_INTERACTIVE


@contextmanager
def activate_tier(tier: Optional[str]):
    """Bind the SLA tier for the duration of a request. Unknown/None
    tiers leave the current binding untouched (RPC payloads from older
    nodes simply inherit the worker's default)."""
    prev = getattr(_tier_tls, "tier", None)
    if tier in _TIERS:
        _tier_tls.tier = tier
    try:
        yield
    finally:
        _tier_tls.tier = prev


def _parse_buckets(raw) -> Tuple[int, ...]:
    """`ES_TPU_SCHED_BUCKETS` ("1,4,16,64,256") -> ascending unique
    positive ints; malformed specs fall back to the default ladder (a
    typo'd knob must not take the dispatch path down)."""
    try:
        vals = sorted({int(str(x).strip())
                       for x in str(raw).split(",") if str(x).strip()})
    except (TypeError, ValueError):
        return DEFAULT_BUCKETS
    vals = [v for v in vals if v > 0]
    return tuple(vals) if vals else DEFAULT_BUCKETS


class _Waiter:
    """One dispatch() call parked in a lane queue."""

    __slots__ = ("queries", "tier", "enqueued", "done", "batch", "base",
                 "trace", "error")

    def __init__(self, queries: List, tier: str):
        self.queries = queries
        self.tier = tier
        self.enqueued = time.monotonic()
        self.done = threading.Event()
        self.batch: Optional[_SchedBatch] = None   # set at flush
        self.base = 0                              # row offset in the batch
        self.trace = tracing.current()
        self.error: Optional[BaseException] = None  # lane-thread crash only

    def age(self, now: float) -> float:
        return now - self.enqueued


class _SchedBatch:
    """One flushed device dispatch (result surface shared with the
    coalescer's _PendingBatch so retry_batch_solo applies to both)."""

    __slots__ = ("engine", "k", "queries", "waiters", "bucket", "results",
                 "error", "fault_log", "query_errors", "trace", "_lock",
                 "_remaining")

    def __init__(self, engine, k: int, waiters: List[_Waiter], bucket: int):
        self.engine = engine
        self.k = k
        self.queries: List = []
        self.waiters = waiters
        self.bucket = bucket
        self.results = None
        self.error: Optional[BaseException] = None
        self.fault_log: List = []
        self.query_errors: Dict[int, BaseException] = {}
        # the first waiter's trace plays the coalescer-leader role: the
        # device span lands on exactly one requester's flight record
        self.trace = waiters[0].trace if waiters else None
        self._lock = threading.Lock()
        self._remaining = len(waiters)  # guarded by: _lock
        for w in waiters:
            w.batch = self
            w.base = len(self.queries)
            self.queries.extend(w.queries)

    def consume(self) -> bool:
        """Called once per waiter after it has read its rows; True for
        the LAST waiter out — that consumption releases the batch's
        in-flight slot (this is what makes dispatch double-buffered: the
        slot stays held while any waiter is still demuxing)."""
        with self._lock:
            self._remaining -= 1
            return self._remaining == 0


class _Lane:
    """Per-(engine, k) dispatch queue plus its dedicated dispatch
    thread. The lane object is created/looked up under the scheduler's
    registry lock; its own state is guarded by `lock` below."""

    __slots__ = ("engine", "k", "key", "lock", "cond", "queue", "thread",
                 "slots", "dead")

    def __init__(self, engine, k: int, key, inflight: int):
        self.engine = engine
        self.k = k
        self.key = key
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.queue: List[_Waiter] = []   # guarded by: lock
        self.thread = None               # guarded by: lock
        # the double-buffer: device dispatches in flight for this lane
        self.slots = threading.Semaphore(max(1, inflight))
        self.dead = False                # guarded by: lock


class AdaptiveDispatchScheduler:
    """Continuous-batching scheduler for engine `search_many` dispatches.

    dispatch() parks each small query batch in a per-(engine, k) lane;
    the lane's dispatch thread flushes the queue to the smallest ladder
    bucket covering the queries that are due, runs the merged device
    dispatch (overlapping up to `inflight` batches), and wakes the
    waiters, each of which demuxes its own rows. Constructor arguments
    override the knobs for tests; None means "read the knob per call"
    so a live node follows environment changes."""

    def __init__(self, buckets: Optional[Tuple[int, ...]] = None,
                 interactive_us: Optional[float] = None,
                 bulk_us: Optional[float] = None,
                 inflight: Optional[int] = None,
                 small_batch_max: int = SMALL_BATCH_MAX,
                 idle_s: float = LANE_IDLE_S):
        self._buckets = tuple(buckets) if buckets else None
        self._interactive_us = interactive_us
        self._bulk_us = bulk_us
        self._inflight_cfg = inflight
        self.small_batch_max = small_batch_max
        self._idle_s = idle_s
        self._lock = threading.Lock()
        self._lanes: Dict[Tuple[int, int], _Lane] = {}  # guarded by: _lock
        # stats
        self._direct_dispatches = 0   # guarded by: _lock
        self._flushes = 0             # guarded by: _lock
        self._sched_queries = 0       # guarded by: _lock
        self._batch_retries = 0       # guarded by: _lock
        self._largest_batch = 0       # guarded by: _lock
        self._inflight = 0            # guarded by: _lock
        self._max_inflight = 0        # guarded by: _lock
        self._bucket_counts: Dict[int, int] = {}        # guarded by: _lock
        self._tier_counts: Dict[str, int] = {}          # guarded by: _lock
        self._tier_wait_ms: Dict[str, float] = {}       # guarded by: _lock
        # per-lane in-flight batches, the raw series behind the sampler's
        # per-lane device busy fraction
        self._lane_inflight: Dict[Tuple[int, int], int] = {}  # guarded by: _lock
        # autotuned ladder cache (knob unset); own lock: ladder() is read
        # under _lock by stats(), so the cache must not share it
        self._auto_lock = threading.Lock()
        self._auto_ladder: Optional[Tuple[int, ...]] = None  # guarded by: _auto_lock
        self._auto_obs = 0            # guarded by: _auto_lock

    # ---- knob-or-constructor configuration ----

    def ladder(self) -> Tuple[int, ...]:
        if self._buckets is not None:
            return self._buckets
        raw = knob("ES_TPU_SCHED_BUCKETS", default=None)
        if raw is not None:
            return _parse_buckets(raw)
        return self._autotune_ladder()

    def _autotune_ladder(self) -> Tuple[int, ...]:
        """Knob-unset ladder: DEFAULT_BUCKETS until enough flushes have
        been observed, then the demand-derived ladder, re-derived only
        every AUTOTUNE_REOBS flushes (each rung is a compiled shape — a
        jittery ladder would churn the kernel cache)."""
        depth = metrics.summary("sched_queue_depth") or {}
        n = int(depth.get("count", 0))
        with self._auto_lock:
            if (self._auto_ladder is not None
                    and n - self._auto_obs < AUTOTUNE_REOBS):
                return self._auto_ladder
        if n < AUTOTUNE_MIN_OBS:
            return DEFAULT_BUCKETS
        derived = _derive_ladder(depth,
                                 metrics.summary("coalesce_pad_ratio"))
        with self._auto_lock:
            self._auto_ladder = derived
            self._auto_obs = n
            return self._auto_ladder

    def budget_s(self, tier: str) -> float:
        if tier == TIER_BULK:
            us = self._bulk_us if self._bulk_us is not None \
                else knob("ES_TPU_SCHED_BULK_US")
        else:
            us = self._interactive_us if self._interactive_us is not None \
                else knob("ES_TPU_SCHED_INTERACTIVE_US")
        return max(0.0, float(us)) / 1e6

    def _inflight_slots(self) -> int:
        n = self._inflight_cfg if self._inflight_cfg is not None \
            else knob("ES_TPU_SCHED_INFLIGHT")
        return max(1, int(n))

    # ---- the dispatch entry ----

    def dispatch(self, engine, queries: List, k: int, check=None,
                 fault_log=None, tier: Optional[str] = None):
        """One batch of queries -> (scores [Q,k], partition [Q,k],
        ord [Q,k]) — the engine `search_many` single-batch contract,
        bit-identical to solo execution. Small batches continuous-batch
        with concurrent peers on the same (engine, k) lane; large ones
        (or a zero ES_TPU_COALESCE_US) dispatch directly."""
        if check is not None:
            # cooperative cancellation only at the caller's boundary: a
            # merged dispatch must never fail EVERY waiter because one
            # task was cancelled
            check()
        ct = _taskmgr.current_task()
        if ct is not None:
            # registered-task cancellation (direct or ban-propagated)
            # honors the same boundary-only contract
            ct.check()
            ct.note_dispatch()
        if knob("ES_TPU_COALESCE_US") <= 0 \
                or len(queries) > self.small_batch_max:
            # direct dispatches skip the lane but still belong to an SLA
            # tier — account them so stats()["tiers"] covers ALL traffic
            tier = tier if tier in _TIERS else current_tier()
            with self._lock:
                self._direct_dispatches += 1
                self._tier_counts[tier] = self._tier_counts.get(tier, 0) + 1
            t_dev = time.monotonic()
            out = DispatchCoalescer._run(engine, queries, k, check=check,
                                         fault_log=fault_log)
            record_device(engine, len(queries),
                          (time.monotonic() - t_dev) * 1e3)
            return out

        tier = tier if tier in _TIERS else current_tier()
        w = _Waiter(list(queries), tier)
        lane = self._enqueue(engine, k, w)
        t0 = time.monotonic()
        w.done.wait()
        wait_ms = (time.monotonic() - t0) * 1e3
        # composed name: exactly the declared sched_tier_wait.* pair
        metrics.observe_if_declared(f"sched_tier_wait.{tier}", wait_ms)
        with self._lock:
            self._tier_counts[tier] = self._tier_counts.get(tier, 0) + 1
            self._tier_wait_ms[tier] = \
                self._tier_wait_ms.get(tier, 0.0) + wait_ms
        batch = w.batch
        if batch is None:          # lane thread crashed before the flush
            raise w.error if w.error is not None else \
                RuntimeError("scheduler lane failed before dispatch")
        tc = tracing.current()
        if tc is not None:
            tc.add_span("sched_wait", wait_ms, tier=tier,
                        batch=len(batch.queries), bucket=batch.bucket)
        try:
            if check is not None:
                check()
            if ct is not None:
                # a ban that landed while we were parked in the batch
                # kills only THIS waiter; co-batched peers keep their
                # bit-identical slices
                ct.check()
            if batch.error is not None:
                raise batch.error
            if fault_log is not None and batch.fault_log:
                fault_log.extend(batch.fault_log)
            if batch.query_errors:
                for qi in range(w.base, w.base + len(w.queries)):
                    if qi in batch.query_errors:
                        raise batch.query_errors[qi]
            scores, parts, ords = batch.results
            sl = slice(w.base, w.base + len(w.queries))
            return scores[sl], parts[sl], ords[sl]
        finally:
            if batch.consume():
                lane.slots.release()
                with self._lock:
                    self._inflight -= 1
                    left = self._lane_inflight.get(lane.key, 0) - 1
                    if left > 0:
                        self._lane_inflight[lane.key] = left
                    else:
                        self._lane_inflight.pop(lane.key, None)
                    inflight_now = self._inflight
                metrics.gauge_set("sched_inflight", inflight_now)

    # ---- lane registry ----

    def _enqueue(self, engine, k: int, w: _Waiter) -> _Lane:
        while True:
            lane = self._lane(engine, k)
            with lane.lock:
                if lane.dead:
                    continue       # lost the race with idle expiry: retry
                lane.queue.append(w)
                if lane.thread is None:
                    lane.thread = threading.Thread(
                        target=self._lane_loop, args=(lane,), daemon=True,
                        name=f"es-tpu-sched[{lane.key[0]}/{lane.key[1]}]")
                    lane.thread.start()
                lane.cond.notify()
            return lane

    def _lane(self, engine, k: int) -> _Lane:
        key = (_engine_key(engine), int(k))
        with self._lock:
            lane = self._lanes.get(key)
            if lane is not None and not lane.dead:
                return lane
            lane = _Lane(engine, int(k), key, self._inflight_slots())
            self._lanes[key] = lane
        self._prime_engine(engine)
        return lane

    def _prime_engine(self, engine) -> None:
        """Push the bucket ladder into the engine's compiled-width cache
        (TurboBM25 / ShardedTurbo qc_sizes): each bucket becomes one
        cached kernel shape so a flush to bucket B pads to B, not to the
        engine's default widths. The primed ladder itself is the guard —
        an autotune re-derivation (or a live knob change) re-primes the
        engine before the new rungs ever reach a flush, so the widened
        shapes are traced once up front instead of retracing mid-dispatch.
        Engines without the hook (BlockMax, stubs) keep their own internal
        chunking."""
        ext = getattr(engine, "extend_qc_sizes", None)
        if ext is None:
            return
        ladder = self.ladder()
        if getattr(engine, "_sched_primed_", None) == ladder:
            return
        try:
            ext(ladder)
            engine._sched_primed_ = ladder
        except AttributeError:     # __slots__ engines: re-prime per lane
            pass

    # ---- the per-lane dispatch thread ----

    def _lane_loop(self, lane: _Lane) -> None:
        try:
            while True:
                with lane.lock:
                    if not lane.queue:
                        notified = lane.cond.wait(self._idle_s)
                        if not lane.queue:
                            if notified:
                                continue      # spurious wakeup
                            # idle: retire the thread and unregister the
                            # lane so a swapped-out engine can be GC'd
                            lane.dead = True
                            with self._lock:
                                if self._lanes.get(lane.key) is lane:
                                    del self._lanes[lane.key]
                            return
                    now = time.monotonic()
                    batch, depth = self._build_batch(lane, now)
                    if batch is None:
                        # nothing due and the top bucket not full: sleep
                        # until the oldest waiter's tier budget expires
                        due_at = min(w.enqueued + self.budget_s(w.tier)
                                     for w in lane.queue)
                        lane.cond.wait(max(due_at - now, 1e-4))
                        continue
                # device work happens OUTSIDE the lane lock: late
                # arrivals keep queueing into the next batch while this
                # one is on the device
                self._execute(lane, batch, depth)
                # drop the flushed batch before the next idle wait, so its
                # queries (an agg collect's works, with the layouts they
                # hold) are freed once their waiters are done
                batch = None
        except BaseException as e:  # noqa: BLE001 — fail queued waiters
            with lane.lock:
                lane.dead = True
                orphans = list(lane.queue)
                lane.queue.clear()
                with self._lock:
                    if self._lanes.get(lane.key) is lane:
                        del self._lanes[lane.key]
            for w in orphans:
                w.error = e
                w.done.set()
            raise

    def _build_batch(self, lane: _Lane, now: float):  # tpulint: holds=lock
        """Flush decision + bucket selection. Returns (batch, depth) or
        (None, depth) when the lane should keep waiting. A flush fires
        when the largest bucket fills or any waiter is past its tier
        budget; the bucket is the smallest ladder entry covering the DUE
        queries (everything, on a full queue), and remaining capacity is
        back-filled FIFO with not-yet-due waiters — bulk rides the pad
        slack of an interactive flush instead of widening it."""
        depth = sum(len(w.queries) for w in lane.queue)
        if depth == 0:
            return None, 0
        ladder = self.ladder()
        due = [w for w in lane.queue
               if w.age(now) >= self.budget_s(w.tier)]
        full = depth >= ladder[-1]
        if not due and not full:
            return None, depth
        need = depth if full else sum(len(w.queries) for w in due)
        bucket = next((b for b in ladder if b >= need), ladder[-1])
        # a waiter wider than the top rung (an autotuned ladder can end
        # below small_batch_max) flushes at its own width: a batch with no
        # waiter would hold an in-flight slot that nothing releases
        head = due[0] if due else lane.queue[0]
        if len(head.queries) > bucket:
            bucket = _next_pow2(len(head.queries))
        chosen: List[_Waiter] = []
        n = 0
        for w in due:
            if n + len(w.queries) > bucket:
                break              # overflow backlog: the next flush is
            chosen.append(w)       # immediate (they stay due)
            n += len(w.queries)
        taken = set(id(x) for x in chosen)
        for w in lane.queue:
            if id(w) in taken:
                continue
            if n + len(w.queries) <= bucket:
                chosen.append(w)
                taken.add(id(w))
                n += len(w.queries)
        remaining = [w for w in lane.queue if id(w) not in taken]
        lane.queue.clear()
        lane.queue.extend(remaining)
        return _SchedBatch(lane.engine, lane.k, chosen, bucket), depth

    def _execute(self, lane: _Lane, batch: _SchedBatch, depth: int) -> None:
        # ladder-change re-prime (near-free tuple compare when unchanged):
        # the batch's bucket may be a rung the lane-creation prime never
        # saw if the autotuner re-derived while the lane was alive
        self._prime_engine(lane.engine)
        # take an in-flight slot BEFORE the device call; the last waiter
        # to consume the batch gives it back (double buffering: demux of
        # this batch overlaps the device sweep of the next one)
        lane.slots.acquire()
        n = len(batch.queries)
        with self._lock:
            self._inflight += 1
            if self._inflight > self._max_inflight:
                self._max_inflight = self._inflight
            self._flushes += 1
            self._sched_queries += n
            if n > self._largest_batch:
                self._largest_batch = n
            self._bucket_counts[batch.bucket] = \
                self._bucket_counts.get(batch.bucket, 0) + 1
            self._lane_inflight[lane.key] = \
                self._lane_inflight.get(lane.key, 0) + 1
            inflight_now, lanes_now = self._inflight, len(self._lanes)
        metrics.observe("sched_bucket_size", batch.bucket)
        metrics.observe("sched_queue_depth", depth)
        metrics.gauge_set("sched_inflight", inflight_now)
        metrics.gauge_set("sched_lanes", lanes_now)
        metrics.counter_add("sched_flushes")
        try:
            with tracing.activate(batch.trace):
                t_dev = time.monotonic()
                batch.results = DispatchCoalescer._run(
                    batch.engine, batch.queries, batch.k,
                    fault_log=batch.fault_log)
                record_device(batch.engine, n,
                              (time.monotonic() - t_dev) * 1e3)
                from elasticsearch_tpu_torch.common.overload import (
                    default_overload,
                )

                default_overload().note_success()
        except Exception as e:
            # poison-batch containment (coalescer parity): retry each
            # query solo so only the one tripping the fault sees it —
            # but only while the node-wide retry budget holds out; an
            # exhausted budget ferries the ORIGINAL error to the waiters
            from elasticsearch_tpu_torch.common.overload import default_overload

            if not default_overload().retry_allowed("sched_solo"):
                batch.error = e
            else:
                with self._lock:
                    self._batch_retries += 1
                retry_batch_solo(batch, e)
        except BaseException as e:  # noqa: BLE001 — ferried to waiters
            batch.error = e
        finally:
            for w in batch.waiters:
                w.done.set()

    # ---- observability ----

    def stats(self) -> dict:
        with self._lock:
            flushes = self._flushes
            merged = self._sched_queries
            tiers = {
                t: {"dispatches": self._tier_counts.get(t, 0),
                    "mean_wait_ms": round(
                        self._tier_wait_ms.get(t, 0.0)
                        / max(1, self._tier_counts.get(t, 0)), 3)}
                for t in _TIERS}
            source = ("constructor" if self._buckets is not None
                      else "knob"
                      if knob("ES_TPU_SCHED_BUCKETS", default=None)
                      is not None
                      else "auto" if self._auto_ladder is not None
                      else "default")
            return {
                "buckets": list(self.ladder()),
                "bucket_source": source,
                "interactive_budget_us":
                    self.budget_s(TIER_INTERACTIVE) * 1e6,
                "bulk_budget_us": self.budget_s(TIER_BULK) * 1e6,
                "inflight_slots": self._inflight_slots(),
                "lanes": len(self._lanes),
                "direct_dispatches": self._direct_dispatches,
                "sched_dispatches": flushes,
                "sched_queries": merged,
                "largest_batch": self._largest_batch,
                "mean_batch": round(merged / flushes, 3) if flushes
                else 0.0,
                "sched_batch_retries": self._batch_retries,
                "inflight": self._inflight,
                "max_inflight": self._max_inflight,
                "bucket_counts": {str(b): c for b, c in
                                  sorted(self._bucket_counts.items())},
                "lane_inflight": {f"{e}/{k}": c for (e, k), c in
                                  sorted(self._lane_inflight.items())},
                "tiers": tiers,
            }

    def sample(self) -> dict:
        """Sampler-ring section: per-lane slot occupancy at the sample
        instant, so the history ring yields a device busy-fraction series
        without an external scraper."""
        slots = max(1, self._inflight_slots())
        with self._lock:
            return {
                "inflight": self._inflight,
                "lanes": len(self._lanes),
                "lane_busy_fraction": {
                    f"{e}/{k}": round(min(1.0, c / slots), 4)
                    for (e, k), c in sorted(self._lane_inflight.items())},
            }


# ---------------------------------------------------------------------------
# the process-default scheduler + the serving dispatch facade
# ---------------------------------------------------------------------------

_default = AdaptiveDispatchScheduler()

_MODE_LOCK = threading.Lock()
_MODE_COUNTS = {"adaptive": 0, "legacy": 0}  # guarded by: _MODE_LOCK


def default_scheduler() -> AdaptiveDispatchScheduler:
    return _default


def serving_dispatch(engine, queries: List, k: int, check=None,
                     fault_log=None, tier: Optional[str] = None):
    """THE serving dispatch entry (search/serving.py call sites):
    routes through the adaptive scheduler, or through the legacy
    fixed-window coalescer when ES_TPU_SCHED_MODE=legacy — both honor
    ES_TPU_COALESCE_US=0 as "no batching at all"."""
    if knob("ES_TPU_SCHED_MODE") == "legacy":
        with _MODE_LOCK:
            _MODE_COUNTS["legacy"] += 1
        return default_coalescer().dispatch(engine, queries, k,
                                            check=check,
                                            fault_log=fault_log)
    with _MODE_LOCK:
        _MODE_COUNTS["adaptive"] += 1
    return _default.dispatch(engine, queries, k, check=check,
                             fault_log=fault_log, tier=tier)


def scheduler_stats() -> dict:
    """The `tpu_scheduler` section of GET /_nodes/stats."""
    with _MODE_LOCK:
        modes = dict(_MODE_COUNTS)
    return {"mode": knob("ES_TPU_SCHED_MODE"),
            "mode_dispatches": modes,
            **default_scheduler().stats()}


# every metrics-history sample carries the default scheduler's per-lane
# occupancy snapshot
metrics.register_sample_provider(
    "tpu_scheduler", lambda: default_scheduler().sample())
