"""Deterministic, seedable fault injection (the port's copy of the device,
durability and overload-pressure parts of elasticsearch_tpu/common/faults.py).

Spec grammar (';'-separated clauses), identical to the reference::

    site[#part]:mode[@nth][xcount][=arg][~prob]

`device_errors` wraps runtime errors coming out of a device dispatch into
`DeviceFaultError`. A torch CUDA runtime error is a `RuntimeError`; it is
contained only when its text carries one of the markers below. CUDA out
of memory (`torch.OutOfMemoryError`) is always contained. The port's own kernel errors (`KernelBuildError`,
`KernelLaunchError`) and wrapper checks (`ValueError`, `TypeError`) are
not RuntimeErrors, so a broken kernel is never served around by the host
tier.

`transport_fault_point` raises `NodeUnavailableError` at the transport
RPC sites (the remote-cluster and CCR planes fire them).

`durability_fault_point` raises `DurabilityFaultError` (an OSError) at
the translog and segment-commit sites, and `corruption_fires` tells a
caller at a corruption site to damage its payload instead of raising, as
in the reference. `injected_overload_level` maps the `overload_pressure`
site to a pressure level for `common/overload.py`.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional

from elasticsearch_tpu_torch.common.errors import DeviceFaultError, HbmOomError
from elasticsearch_tpu_torch.common.settings import knob

# Every site name the reference knows, in the reference's groups, so one
# ES_TPU_FAULTS value parses in both packages.
TRANSPORT_SITES = frozenset({
    "rpc_query", "rpc_fetch", "rpc_can_match", "rpc_bulk",
    "rpc_replica_bulk", "rpc_recovery", "rpc_resync", "rpc_relocation",
    "rpc_remote_search", "rpc_ccr_fetch",
})
DURABILITY_SITES = frozenset({
    "translog_fsync", "translog_corrupt", "segment_commit",
})
OVERLOAD_SITES = frozenset({"overload_pressure"})
# bit-flip sites (common/integrity.py): `corruption_fires()` tells the
# caller to damage its payload; they never raise at the site
CORRUPTION_SITES = frozenset({
    "segment_read", "segment_transfer", "hbm_region",
})
KNOWN_SITES = frozenset({
    "turbo_sweep", "fused_dispatch", "merge_kernel", "column_upload",
    "bitset_intersect", "sparse_gather", "blockmax_pass", "agg_reduce",
    "knn_score", "knn_rescore",
}) | TRANSPORT_SITES | DURABILITY_SITES | OVERLOAD_SITES | CORRUPTION_SITES
_NAMED_PART_SITES = TRANSPORT_SITES | CORRUPTION_SITES

_MODES = frozenset({"raise", "oom", "hang"})

# torch raises CUDA OOM as `torch.OutOfMemoryError`, a RuntimeError subclass
_DEVICE_ERROR_NAMES = frozenset({
    "XlaRuntimeError", "JaxRuntimeError", "RuntimeError",
    "InternalError", "ResourceExhaustedError", "OutOfMemoryError",
})
_DEVICE_ERROR_MARKERS = ("RESOURCE_EXHAUSTED", "INTERNAL", "out of memory",
                         "DEADLINE_EXCEEDED")


class FaultSpecError(ValueError):
    """Malformed ES_TPU_FAULTS clause."""


@dataclass
class _Clause:
    site: str
    part: Optional[Any]
    mode: str
    nth: int = 1
    count: float = 1
    arg: float = 0.05
    prob: Optional[float] = None
    calls: int = 0
    fired: int = 0
    rng: Optional[random.Random] = None

    def matches(self, site: str, part: Optional[Any]) -> bool:
        if site != self.site:
            return False
        if self.part is not None and part != self.part \
                and str(part) != str(self.part):
            return False
        return True

    def should_fire(self) -> bool:
        self.calls += 1
        if self.prob is not None:
            if self.rng.random() >= self.prob:
                return False
        elif self.calls < self.nth:
            return False
        if self.fired >= self.count:
            return False
        self.fired += 1
        return True


@dataclass
class FaultRecord:
    """One contained device fault, as reported in `_shards` failures."""
    site: str
    partition: Optional[int]
    error: BaseException
    recovered: bool = True

    @classmethod
    def from_error(cls, e: BaseException, partition: Optional[int] = None,
                   recovered: bool = True) -> "FaultRecord":
        return cls(site=getattr(e, "site", None) or "device",
                   partition=(partition if partition is not None
                              else getattr(e, "part", None)),
                   error=e, recovered=recovered)


def parse_spec(spec: str) -> List[_Clause]:
    seed = knob("ES_TPU_FAULTS_SEED")
    clauses: List[_Clause] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        if ":" not in raw:
            raise FaultSpecError(f"fault clause missing ':': {raw!r}")
        head, tail = raw.split(":", 1)
        part_str: Optional[str] = None
        if "#" in head:
            head, part_str = head.split("#", 1)
            if not part_str:
                raise FaultSpecError(f"bad partition in clause {raw!r}")
        site = head.strip()
        if site not in KNOWN_SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r}; known: {sorted(KNOWN_SITES)}")
        part: Optional[Any] = None
        if part_str is not None:
            try:
                part = int(part_str)
            except ValueError:
                if site in _NAMED_PART_SITES:
                    part = part_str
                else:
                    raise FaultSpecError(
                        f"bad partition in clause {raw!r}")
        c = _Clause(site=site, part=part, mode="")
        for marker, conv, attr in (("~", float, "prob"), ("=", float, "arg"),
                                   ("x", None, "count"), ("@", int, "nth")):
            if marker in tail:
                tail, v = tail.rsplit(marker, 1)
                try:
                    if attr == "count":
                        c.count = float("inf") if v == "inf" else int(v)
                    else:
                        setattr(c, attr, conv(v))
                except ValueError:
                    raise FaultSpecError(f"bad {attr!r} in clause {raw!r}")
        c.mode = tail.strip()
        if c.mode not in _MODES:
            raise FaultSpecError(
                f"unknown fault mode {c.mode!r}; known: {sorted(_MODES)}")
        if c.prob is not None:
            c.rng = random.Random(seed ^ (hash(site) & 0xFFFFFFFF))
        clauses.append(c)
    return clauses


_LOCK = threading.Lock()
_ACTIVE: Optional[List[_Clause]] = None  # guarded by: _LOCK


def install(spec: str) -> None:
    """Install a fault spec process-wide (replaces any previous spec)."""
    global _ACTIVE
    clauses = parse_spec(spec)
    with _LOCK:
        _ACTIVE = clauses or None


def clear() -> None:
    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


@contextlib.contextmanager
def inject(spec: str):
    """Scoped installation: install `spec`, restore the prior state on exit."""
    global _ACTIVE
    clauses = parse_spec(spec)
    with _LOCK:
        prev, _ACTIVE = _ACTIVE, clauses
    try:
        yield
    finally:
        with _LOCK:
            _ACTIVE = prev


def _fire_mode(site: str, part: Optional[Any]) -> Optional[tuple]:
    active = _ACTIVE
    if active is None:
        return None
    with _LOCK:
        if _ACTIVE is not active:
            active = _ACTIVE
            if active is None:
                return None
        for c in active:
            if not c.matches(site, part):
                continue
            if not c.should_fire():
                continue
            return c.mode, c.arg
    return None


def injected_overload_level() -> Optional[str]:
    """Deterministic pressure injection for the overload controller.

    Fires the ``overload_pressure`` site like any other clause (consuming
    one call against @nth/xcount), but maps the mode to a pressure level
    instead of raising: ``hang`` -> ``"yellow"``, ``raise``/``oom`` ->
    ``"red"``. Returns None when no clause fires."""
    hit = _fire_mode("overload_pressure", None)
    if hit is None:
        return None
    mode, _arg = hit
    return "yellow" if mode == "hang" else "red"


def fault_point(site: str, part: Optional[int] = None) -> None:
    """Named dispatch site: raises/oom/hangs when an active clause fires."""
    hit = _fire_mode(site, part)
    if hit is None:
        return
    mode, arg = hit
    if mode == "hang":
        time.sleep(arg)
        return
    if mode == "oom":
        raise HbmOomError(
            f"injected HBM OOM at {site}"
            + (f"#{part}" if part is not None else ""),
            site=site, part=part)
    raise DeviceFaultError(
        f"injected device fault at {site}"
        + (f"#{part}" if part is not None else ""),
        site=site, part=part)



def transport_fault_point(site: str, node: str) -> None:
    """Named transport RPC site (coordinator -> `node`): raises
    `NodeUnavailableError` — the SAME exception an organic dead/partitioned
    node produces, so injected and organic transport faults take identical
    recovery paths through the coordinator — or hangs past the RPC deadline
    (the reply "arrives" after the coordinator stopped waiting)."""
    hit = _fire_mode(site, node)
    if hit is None:
        return
    mode, arg = hit
    if mode == "hang":
        time.sleep(arg)
        return
    # raise and oom both model an unreachable node on a transport site
    from elasticsearch_tpu_torch.transport.channels import NodeUnavailableError

    raise NodeUnavailableError(
        f"injected transport fault at {site}#{node}")

class DurabilityFaultError(OSError):
    """Injected durable-storage failure (fsync / commit) at a named site.

    Deliberately an OSError: the write path must treat an injected fsync
    failure exactly like the organic ENOSPC/EIO it models."""

    def __init__(self, message: str, site: Optional[str] = None,
                 part: Optional[Any] = None):
        super().__init__(message)
        self.site = site
        self.part = part


def durability_fault_point(site: str, part: Optional[Any] = None) -> None:
    """Named durable-storage site (translog fsync, segment commit): raises
    `DurabilityFaultError` — indistinguishable from an organic I/O error —
    or hangs (a stalling disk; the op completes late)."""
    hit = _fire_mode(site, part)
    if hit is None:
        return
    mode, arg = hit
    if mode == "hang":
        time.sleep(arg)
        return
    # raise and oom both model a failed durable write at a storage site
    raise DurabilityFaultError(
        f"injected durability fault at {site}"
        + (f"#{part}" if part is not None else ""), site=site, part=part)


def corruption_fires(part: Optional[Any] = None,
                     site: str = "translog_corrupt") -> bool:
    """True when a corruption clause fires for this call: the caller
    silently damages the payload (bit rot) instead of raising — the damage
    surfaces downstream, at whatever checksum verify guards that leg.
    Defaults to the `translog_corrupt` site; the integrity plane passes
    `segment_read` / `segment_transfer` / `hbm_region`."""
    return _fire_mode(site, part) is not None


def is_device_error(e: BaseException) -> bool:
    if isinstance(e, DeviceFaultError):
        return True
    name = type(e).__name__
    if name in _DEVICE_ERROR_NAMES:
        if name == "RuntimeError":
            s = str(e)
            return any(m in s for m in _DEVICE_ERROR_MARKERS)
        return True
    return False


@contextlib.contextmanager
def device_errors(site: str, part: Optional[int] = None):
    """Translate device-runtime errors at this site into `DeviceFaultError`
    (out-of-memory into `HbmOomError`); everything else passes through."""
    try:
        yield
    except DeviceFaultError:
        raise
    except Exception as e:
        if not is_device_error(e):
            raise
        msg = f"device fault at {site}" + (
            f"#{part}" if part is not None else "") + f": {e}"
        if "RESOURCE_EXHAUSTED" in str(e) or "out of memory" in str(e):
            raise HbmOomError(msg, site=site, part=part) from e
        raise DeviceFaultError(msg, site=site, part=part) from e


@contextlib.contextmanager
def device_dispatch(site: str, part: Optional[int] = None):
    """fault_point + device_errors: the standard wrapper for a dispatch."""
    fault_point(site, part)
    with device_errors(site, part):
        yield


# A malformed spec fails loudly at import, as in the reference.
_env_spec = knob("ES_TPU_FAULTS")
if _env_spec:
    install(_env_spec)
