"""End-to-end data integrity plane: detect silent bit-rot on every leg.

The reference engine treats corruption as a first-class failure — every
Lucene file carries a footer checksum, `index.shard.check_on_startup`
verifies stores before they serve, and a CorruptIndexException fails the
copy so the master reallocates from a healthy replica. This module is the
shared core of our port of that posture, covering three legs:

  at rest   segment blobs carry a sha256 footer (index/segment_io.py);
            every read verifies; a failure raises `SegmentCorruptedError`,
            drops a ``corrupted-*`` marker in the shard data path, and the
            copy is shard-failed so the master reallocates it from a
            healthy peer (the marker blocks re-serving the corrupt store
            until a fresh recovery overwrites it)
  in flight peer-recovery / relocation segment payloads advertise their
            blob hash; the target verifies before `install_segment` and
            re-fetches on mismatch (indices/shard_service.py)
  in HBM    engines that pin columns register scrub regions here; a
            background scrubber re-downloads one region per tick,
            re-hashes it against the host-side fingerprint, re-uploads
            from the host copy on mismatch, and trips the engine-health
            circuit after repeated hits

Deterministic damage rides the fault grammar: corruption sites
``segment_read`` / ``segment_transfer`` / ``hbm_region`` never raise at
the site — `faults.corruption_fires(part, site)` tells the caller to flip
a bit (see `bitflip`) and the plane must DETECT it downstream.

Counters surface as ``tpu_integrity`` in ``GET /_nodes/stats``
(`integrity_stats()`) and as Prometheus gauges via common/metrics.py.

The port's copy of elasticsearch_tpu/common/integrity.py, whole. No port
engine registers a device scrub region yet, and `_host_bytes` reads host
arrays only.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import threading
import time
import uuid
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.common import metrics
from elasticsearch_tpu_torch.common.settings import knob


class SegmentCorruptedError(Exception):
    """A segment blob failed checksum verification (at rest or on the
    recovery wire). The copy holding it must not serve: the shard is
    failed to the master, which reallocates from a healthy peer."""


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {
    # ---- at rest ----
    "segments_verified": 0,      # v3 blobs whose footer re-hash passed
    "bytes_verified": 0,         # total blob bytes covered by those passes
    "segments_corrupted": 0,     # footer mismatches (any leg)
    "legacy_blobs_read": 0,      # v2 blobs parsed without verification
    "markers_written": 0,        # corrupted-* markers dropped in data paths
    "markers_cleared": 0,        # markers removed after a clean recovery
    "shards_failed_corrupt": 0,  # copies shard-failed over corruption
    "copies_quarantined": 0,     # corrupt replica stores renamed aside
    "startup_checks": 0,         # ES_TPU_CHECK_ON_STARTUP full-store scans
    "startup_failures": 0,       # scans that found corruption
    # ---- in flight ----
    "transfer_hashes_verified": 0,  # recovery payloads that matched
    "transfer_corruptions": 0,      # advertised-hash mismatches at target
    "transfer_retries": 0,          # re-fetches burned on those mismatches
    # ---- in HBM ----
    "scrub_ticks": 0,            # regions examined by the scrubber
    "scrub_clean": 0,            # re-hash matched the fingerprint
    "scrub_baselined": 0,        # first sight of a device-built epoch
    "scrub_mismatches": 0,       # fingerprint mismatches detected
    "scrub_repairs": 0,          # regions re-uploaded / rebuilt
    "scrub_repaired_bytes": 0,   # bytes restored by those repairs
    "scrub_yields": 0,           # ticks skipped (overload not GREEN)
    # ---- snapshots ----
    "repo_verifies": 0,          # POST /_snapshot/{repo}/_verify runs
    "repo_corrupt_blobs": 0,     # corrupt blobs those runs reported
    "restore_cleanups": 0,       # partial indices deleted after a failure
}

for _name, _doc in (
        ("segments_verified", "segment blob footer verifications passed"),
        ("segments_corrupted", "segment blob checksum failures"),
        ("markers_written", "corrupted-* markers written"),
        ("shards_failed_corrupt", "shard copies failed over corruption"),
        ("transfer_corruptions", "recovery payload hash mismatches"),
        ("scrub_mismatches", "HBM scrub fingerprint mismatches"),
        ("scrub_repairs", "HBM regions repaired from host copies"),
):
    metrics.declare_counter(f"tpu_integrity.{_name}", _doc)
metrics.declare_gauge("tpu_integrity.scrub_regions",
                      "HBM regions registered with the scrubber")
_METRIC_KEYS = frozenset({
    "segments_verified", "segments_corrupted", "markers_written",
    "shards_failed_corrupt", "transfer_corruptions", "scrub_mismatches",
    "scrub_repairs",
})


def count(key: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTERS[key] += n
    if key in _METRIC_KEYS:
        metrics.counter_add(f"tpu_integrity.{key}", n)


def integrity_stats() -> dict:
    """`tpu_integrity` node-stats section: every counter above, plus the
    live scrub-registry size."""
    with _LOCK:
        out = dict(_COUNTERS)
    out["scrub_regions"] = scrub_registry_size()
    return out


def reset_for_tests() -> Dict[str, int]:
    with _LOCK:
        prev = dict(_COUNTERS)
        for k in _COUNTERS:
            _COUNTERS[k] = 0
    return prev


# ---------------------------------------------------------------------------
# deterministic damage
# ---------------------------------------------------------------------------

def bitflip(data: bytes) -> bytes:
    """Flip one bit in the middle of `data` — the canonical injected
    corruption for every `corruption_fires()` call site, far enough from
    headers/footers that only the checksum can catch it."""
    if not data:
        return data
    buf = bytearray(data)
    buf[len(buf) // 2] ^= 0x01
    return bytes(buf)


# ---------------------------------------------------------------------------
# corrupted-* markers (shard data path)
# ---------------------------------------------------------------------------
# Ref: Lucene's Store.markStoreCorrupted writes a corrupted_<uuid> file the
# allocator refuses to reuse. Ours is JSON so the runbook can read it.

def write_corruption_marker(data_path: str, reason: str,
                            segment: Optional[str] = None) -> str:
    os.makedirs(data_path, exist_ok=True)
    name = f"corrupted-{uuid.uuid4().hex[:12]}.json"
    path = os.path.join(data_path, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"reason": str(reason)[:500], "segment": segment,
                   "timestamp": time.time()}, f)
    os.replace(tmp, path)
    count("markers_written")
    return path


def corruption_marker(data_path: str) -> Optional[dict]:
    """First readable marker's content, or None when the store is clean."""
    for path in sorted(glob.glob(os.path.join(data_path, "corrupted-*.json"))):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"reason": f"unreadable marker {os.path.basename(path)}"}
    return None


def clear_corruption_markers(data_path: str) -> int:
    cleared = 0
    for path in glob.glob(os.path.join(data_path, "corrupted-*.json")):
        try:
            os.remove(path)
            cleared += 1
        except OSError:
            pass
    if cleared:
        count("markers_cleared", cleared)
    return cleared


# ---------------------------------------------------------------------------
# HBM scrub registry
# ---------------------------------------------------------------------------

class _ScrubRegion:
    """One device-resident region under scrub.

    Two flavors, by provenance of the truth the download is checked
    against:

      host-backed  `expected(owner)` returns the authoritative host numpy
                   array (the engine keeps it anyway, or retains it for
                   this purpose); repair re-uploads it
      baseline     the region is device-built (no host copy is cheap to
                   keep); `epoch(owner)` returns a token that changes on
                   every legitimate rebuild — the first scrub at an epoch
                   records the downloaded fingerprint as trusted, later
                   scrubs at the SAME epoch must match it; repair resets
                   the cache (dropping to a new epoch)

    All callables take the owner so the registry holds only a weakref —
    a dropped engine must not be pinned alive by its scrub entry."""

    def __init__(self, owner, name: str, get_device, expected, repair,
                 epoch):
        self.ref = weakref.ref(owner)
        self.key = (id(owner), name)
        self.name = name
        self.kind = type(owner).__name__
        self.get_device = get_device
        self.expected = expected
        self.repair = repair
        self.epoch = epoch
        self.baseline_epoch: Any = None
        self.baseline_digest: Optional[bytes] = None


_SCRUB_LOCK = threading.Lock()
_REGIONS: List[_ScrubRegion] = []      # guarded by: _SCRUB_LOCK
_HEALTH: Dict[int, Any] = {}           # id(owner) -> EngineHealth (weak)
_CURSOR = [0]                          # round-robin position


def register_scrub_region(owner, name: str,
                          get_device: Callable[[Any], Any], *,
                          expected: Optional[Callable[[Any], Any]] = None,
                          repair: Optional[Callable[[Any], None]] = None,
                          epoch: Optional[Callable[[Any], Any]] = None
                          ) -> None:
    """Register (or re-register) one region. Exactly one of `expected`
    (host-backed) or `epoch` (baseline) must be given."""
    if (expected is None) == (epoch is None):
        raise ValueError("exactly one of expected= / epoch= required")
    region = _ScrubRegion(owner, name, get_device, expected, repair, epoch)
    with _SCRUB_LOCK:
        _prune_locked()
        for i, r in enumerate(_REGIONS):
            if r.key == region.key:
                _REGIONS[i] = region
                break
        else:
            _REGIONS.append(region)
        metrics.gauge_set("tpu_integrity.scrub_regions", len(_REGIONS))


def attach_scrub_health(owner, health) -> None:
    """Wire an EngineHealth circuit to every region of `owner`: repeated
    scrub mismatches trip it exactly like repeated dispatch faults, so a
    persistently rotting engine stops serving from the device."""
    with _SCRUB_LOCK:
        _HEALTH[id(owner)] = health
        weakref.finalize(owner, _HEALTH.pop, id(owner), None)


def _prune_locked() -> None:  # tpulint: holds=_SCRUB_LOCK
    _REGIONS[:] = [r for r in _REGIONS if r.ref() is not None]


def scrub_registry_size() -> int:
    with _SCRUB_LOCK:
        _prune_locked()
        return len(_REGIONS)


def _host_bytes(arr) -> bytes:
    return np.ascontiguousarray(np.asarray(arr)).tobytes()


def scrub_once() -> Optional[dict]:
    """Scrub the next region (round-robin): download, re-hash, compare,
    repair on mismatch. Synchronous — the scrubber thread calls this once
    per tick; tests call it directly. Returns an outcome dict, or None
    when no regions are registered."""
    from elasticsearch_tpu_torch.common import faults

    with _SCRUB_LOCK:
        _prune_locked()
        metrics.gauge_set("tpu_integrity.scrub_regions", len(_REGIONS))
        if not _REGIONS:
            return None
        region = _REGIONS[_CURSOR[0] % len(_REGIONS)]
        _CURSOR[0] += 1
        health = _HEALTH.get(region.key[0])
    owner = region.ref()
    if owner is None:
        return None
    count("scrub_ticks")
    outcome = {"region": f"{region.kind}.{region.name}", "result": "clean"}
    # baseline flavor: read the epoch token BEFORE the download — a
    # legitimate rebuild racing the scrub then re-baselines next pass
    # instead of false-mismatching
    ep = region.epoch(owner) if region.epoch is not None else None
    # the download IS the verification read; an injected hbm_region clause
    # damages this copy (the device never served it), which is exactly the
    # bit the fingerprint must catch
    data = _host_bytes(region.get_device(owner))
    if faults.corruption_fires(region.name, site="hbm_region"):
        data = bitflip(data)
    digest = hashlib.sha256(data).digest()
    if region.expected is not None:
        want = hashlib.sha256(_host_bytes(region.expected(owner))).digest()
    else:
        if ep != region.baseline_epoch or region.baseline_digest is None:
            # first sight of this epoch: trust the download as baseline
            region.baseline_epoch = ep
            region.baseline_digest = digest
            count("scrub_baselined")
            outcome["result"] = "baselined"
            return outcome
        want = region.baseline_digest
    if digest == want:
        count("scrub_clean")
        if health is not None:
            health.record_success()
        return outcome
    count("scrub_mismatches")
    err = SegmentCorruptedError(
        f"HBM scrub mismatch in {region.kind}.{region.name}")
    outcome["result"] = "mismatch"
    if region.repair is not None:
        region.repair(owner)
        region.baseline_epoch = None   # device-built: re-baseline next pass
        region.baseline_digest = None
        count("scrub_repairs")
        count("scrub_repaired_bytes", len(data))
        outcome["repaired"] = True
    if health is not None:
        health.record_fault(err)
    return outcome


def reset_scrub_for_tests() -> None:
    with _SCRUB_LOCK:
        _REGIONS.clear()
        _HEALTH.clear()
        _CURSOR[0] = 0


# ---------------------------------------------------------------------------
# background scrubber
# ---------------------------------------------------------------------------

class IntegrityScrubber:
    """Periodic HBM scrub driver (``ES_TPU_INTEGRITY_SCRUB_S``; 0 = off).

    One region per tick, executed on the node's MANAGEMENT pool so scrub
    downloads never contend with search/write workers for a stage slot;
    the tick is skipped entirely while the overload controller is not
    GREEN (reads the CACHED level — `stats()` — because `evaluate()`
    consumes a deterministic `overload_pressure` fault fire)."""

    def __init__(self, thread_pool=None, overload=None):
        self._thread_pool = thread_pool
        self._overload = overload
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> bool:
        period = float(knob("ES_TPU_INTEGRITY_SCRUB_S"))
        if period <= 0 or self._thread is not None:
            return False
        self._thread = threading.Thread(
            target=self._loop, args=(period,), daemon=True,
            name="es-tpu-integrity-scrub")
        self._thread.start()
        return True

    def _loop(self, period: float) -> None:
        while not self._stop.wait(period):
            try:
                self.tick()
            except Exception:   # noqa: BLE001 — scrub must never kill itself
                pass

    def tick(self) -> None:
        ol = self._overload
        if ol is not None and ol.stats().get("level", "green") != "green":
            count("scrub_yields")
            return
        if self._thread_pool is not None:
            self._thread_pool.execute("management", scrub_once)
        else:
            scrub_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
