"""Write-ahead log: checksummed op framing, generations, replay, trim.

Re-designs the reference translog (ref: index/translog/Translog.java,
TranslogWriter.java, Checkpoint.java): every index/delete op is appended as a
length-prefixed, CRC32-checksummed JSON record before it is acknowledged.
Generations roll over on flush; recovery replays ops above the last commit's
checkpoint. Fsync policy mirrors index.translog.durability request/async.

Record framing: [u32 length][u32 crc32 of payload][payload utf-8 json]

Fault ladder: every fsync runs through the ``translog_fsync`` fault
site and surfaces failure as `TranslogFsyncError` — the caller must NOT ack
the op (the shard copy gets failed via the master instead of writing into a
broken WAL). The ``translog_corrupt`` site bit-rots the record being
appended (bad CRC), so the damage surfaces at replay, like the real thing.

The port's copy of elasticsearch_tpu/index/translog.py.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Any, Dict, Iterator, List

from elasticsearch_tpu_torch.common.durability import count as _count
from elasticsearch_tpu_torch.common.durability import register_translog
from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuError
from elasticsearch_tpu_torch.common.faults import corruption_fires, durability_fault_point
from elasticsearch_tpu_torch.common.settings import knob

_HEADER = struct.Struct("<II")


class TranslogCorruptedError(Exception):
    pass


class TranslogFsyncError(ElasticsearchTpuError):
    """A translog fsync failed: the op is NOT durable and must not be acked
    (ref: the reference fails the engine on a tragic translog event —
    Engine.failEngine via TranslogException)."""

    status = 503
    error_type = "translog_fsync_exception"


class Translog:
    def __init__(self, directory: str, durability: str = "request"):
        self.dir = directory
        self.durability = durability
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._generation = self._latest_generation()
        self._file = open(self._gen_path(self._generation), "ab")
        self._ops_since_sync = 0  # guarded by: _lock
        register_translog(self)

    # ---- paths/generations ----

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.dir, f"translog-{gen}.tlog")

    def _latest_generation(self) -> int:
        gens = self.generations()
        return gens[-1] if gens else 1

    def generations(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("translog-") and name.endswith(".tlog"):
                out.append(int(name[len("translog-"):-len(".tlog")]))
        return sorted(out)

    @property
    def generation(self) -> int:
        return self._generation

    # ---- writes ----

    def add(self, op: Dict[str, Any]) -> None:
        payload = json.dumps(op, separators=(",", ":")).encode()
        crc = zlib.crc32(payload)
        if corruption_fires():
            # bit-rot the checksum, not the raise path: real corruption is
            # silent at write time and detected at replay
            crc ^= 0x5A5A5A5A
            _count("translog_corruptions")
        rec = _HEADER.pack(len(payload), crc) + payload
        with self._lock:
            self._file.write(rec)
            if self.durability == "request":
                self._sync_locked()
            else:
                self._ops_since_sync += 1
                # bound the async exposure window: at most N acked-but-
                # unsynced ops can be lost to a crash (ref: the reference's
                # async durability still syncs on the flush interval; an
                # unread counter bounds nothing)
                if self._ops_since_sync >= knob("ES_TPU_TRANSLOG_SYNC_OPS"):
                    self._sync_locked()

    def _sync_locked(self) -> None:  # tpulint: holds=_lock
        """Flush + fsync the active generation; resets the async window.

        On failure (injected via the ``translog_fsync`` site or organic
        EIO/ENOSPC) the record MAY still be in the file — the write preceded
        the failed sync — but the caller must treat the op as NOT durable:
        a write surviving unacked is safe, an acked write lost is not."""
        try:
            durability_fault_point("translog_fsync")
            self._file.flush()
            os.fsync(self._file.fileno())
        except OSError as e:
            _count("fsync_failures")
            raise TranslogFsyncError(f"translog fsync failed: {e}") from e
        self._ops_since_sync = 0
        _count("translog_syncs")

    def sync(self) -> None:
        with self._lock:
            self._sync_locked()

    @property
    def ops_since_sync(self) -> int:
        """Current async-durability exposure: ops appended since the last
        successful fsync (0 under request durability)."""
        return self._ops_since_sync

    def rollover(self) -> int:
        """Start a new generation (called at flush/commit time)."""
        with self._lock:
            self._sync_locked()
            self._file.close()
            self._generation += 1
            self._file = open(self._gen_path(self._generation), "ab")
        return self._generation

    def trim_below(self, generation: int) -> None:
        """Delete generations < `generation` (retention policy after commit)."""
        for gen in self.generations():
            if gen < generation:
                os.remove(self._gen_path(gen))

    def trim_above(self, seq_no: int) -> None:
        """Logically discard ops with seq_no > seq_no from replay — a trim
        marker record, honored in order during reads, so a resynced replica's
        divergent tail cannot be resurrected by crash recovery (ref:
        index/translog/Translog.java trimOperations, called when a replica
        rolls back to the global checkpoint on primary failover)."""
        self.add({"op": "trim", "above": seq_no})

    # ---- reads ----

    def read_ops(self, min_seq_no: int = -1) -> Iterator[Dict[str, Any]]:
        """Replay all ops with seq_no > min_seq_no across generations.

        Trim markers drop earlier-appended ops above their threshold, in log
        order. Replay streams (constant memory): a cheap first pass collects
        the trim markers' positions, the second pass yields ops, suppressing
        any op a later trim covers. A torn final record (crash mid-write) is
        tolerated and ends replay of that generation; a corrupt interior
        record raises.
        """
        with self._lock:
            self._file.flush()
        gens = self.generations()
        trims: List[tuple] = []  # (record_position, trim_above)
        pos = 0
        for gen in gens:
            for op in self._read_gen(gen, -2):
                if op.get("op") == "trim":
                    trims.append((pos, op["above"]))
                pos += 1
        pos = 0
        for gen in gens:
            for op in self._read_gen(gen, -2):
                i = pos
                pos += 1
                if op.get("op") == "trim":
                    continue
                seq = op.get("seq_no", -1)
                if seq <= min_seq_no:
                    continue
                if any(t_pos > i and seq > above for t_pos, above in trims):
                    continue
                yield op

    def _read_gen(self, gen: int, min_seq_no: int) -> Iterator[Dict[str, Any]]:
        path = self._gen_path(gen)
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break
                length, crc = _HEADER.unpack(header)
                payload = f.read(length)
                if len(payload) < length:
                    break  # torn tail record
                if zlib.crc32(payload) != crc:
                    if f.tell() >= size:
                        break  # torn tail
                    raise TranslogCorruptedError(
                        f"translog corruption in generation {gen} at offset {f.tell()}"
                    )
                op = json.loads(payload)
                # trim markers always flow through: they affect replay even
                # when their own record carries no seq_no
                if op.get("op") == "trim" or op.get("seq_no", -1) > min_seq_no:
                    yield op

    def total_ops(self) -> int:
        return sum(1 for _ in self.read_ops())

    def close(self) -> None:
        with self._lock:
            self._file.flush()
            self._file.close()
