"""Blob-store snapshot repository (filesystem backend).

Re-designs the reference's BlobStoreRepository (ref:
repositories/blobstore/BlobStoreRepository.java:152, layout: index-N root
generation, snap-*.dat metadata, indices/{uuid}/{shard}/ blob trees) for
the TPU segment model: a segment is ONE immutable blob, content-addressed
by its payload hash, so incremental snapshots are free — a second snapshot
of an unchanged shard writes zero segment bytes (the reference gets the
same effect from tracking per-file checksums in shard generations).

Layout under the repository root:
    index.json                          — {"snapshots": [name...]}
    snap-{name}.json                    — snapshot-level metadata
    indices/{index}/meta-{name}.json    — settings + mappings AT THAT
                                          snapshot (an index recreated with a
                                          different mapping must not rewrite
                                          older snapshots' metadata)
    indices/{index}/{shard}/manifest-{name}.json
        — ordered [(blob hash, live mask RLE, n_docs)], max_seq_no
    blobs/{sha256}.seg                  — data-only segment blobs (shared;
                                          segment_io format, never pickle —
                                          a repository is an untrusted
                                          shareable directory)

The port's copy of elasticsearch_tpu/snapshots/repository.py: the blob
format is `index.segment_io`'s, so a repository either package wrote
restores in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuError


class RepositoryError(ElasticsearchTpuError):
    status = 500
    error_type = "repository_exception"


class SnapshotMissingError(ElasticsearchTpuError):
    status = 404
    error_type = "snapshot_missing_exception"


def _mask_to_wire(mask: np.ndarray) -> dict:
    """Live mask -> {n, dead: [ords]} — deletions are sparse."""
    dead = np.nonzero(~np.asarray(mask, bool))[0]
    return {"n": int(len(mask)), "dead": [int(d) for d in dead]}


def _mask_from_wire(w: dict) -> np.ndarray:
    mask = np.ones(w["n"], bool)
    if w["dead"]:
        mask[np.asarray(w["dead"], np.int64)] = False
    return mask


class FsRepository:
    """One registered repository rooted at a directory."""

    def __init__(self, name: str, location: str, readonly: bool = False):
        self.name = name
        self.location = location
        self.readonly = readonly
        # serializes create/delete/GC so a concurrent delete can never GC a
        # blob belonging to an in-flight snapshot (the reference serializes
        # snapshot operations through cluster state)
        self.mutation_lock = threading.Lock()
        os.makedirs(os.path.join(location, "blobs"), exist_ok=True)
        if not os.path.exists(self._path("index.json")):
            self._write_json("index.json", {"snapshots": []})

    # ---- paths / io ----

    def _path(self, *parts: str) -> str:
        return os.path.join(self.location, *parts)

    def _write_json(self, rel: str, obj: dict) -> None:
        path = self._path(rel)
        os.makedirs(os.path.dirname(path) or self.location, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _read_json(self, rel: str) -> Optional[dict]:
        try:
            with open(self._path(rel)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    # ---- snapshot registry ----

    def snapshots(self) -> List[str]:
        return (self._read_json("index.json") or {}).get("snapshots", [])

    def snapshot_meta(self, name: str) -> dict:
        meta = self._read_json(f"snap-{name}.json")
        if meta is None:
            raise SnapshotMissingError(
                f"[{self.name}:{name}] is missing")
        return meta

    # ---- blobs (content-addressed segments) ----

    def put_segment_blob(self, payload: bytes) -> tuple[str, bool]:
        """Store a segment payload; returns (hash, newly_written)."""
        h = hashlib.sha256(payload).hexdigest()
        path = self._path("blobs", f"{h}.seg")
        if os.path.exists(path):
            return h, False
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return h, True

    def read_segment_blob(self, h: str) -> bytes:
        try:
            with open(self._path("blobs", f"{h}.seg"), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise RepositoryError(f"segment blob [{h}] missing from "
                                  f"repository [{self.name}]")
        if hashlib.sha256(data).hexdigest() != h:
            raise RepositoryError(
                f"segment blob [{h}] failed checksum verification in "
                f"repository [{self.name}] (corrupted or tampered)")
        return data

    # ---- write a snapshot ----

    def write_snapshot(self, name: str, indices: Dict[str, dict],
                       snap_meta: dict) -> None:
        """indices: {index_name: {"meta": {...}, "shards": [shard manifest]}}
        where a shard manifest = {"segments": [{"blob", "live", "n_docs"}],
        "max_seq_no": int}. Write ORDER is the crash-safety contract: all
        per-snapshot payloads and snap-{name}.json land before the name is
        registered in index.json, so a torn write can never leave a listed
        snapshot whose metadata is unreadable."""
        for index, data in indices.items():
            self._write_json(f"indices/{index}/meta-{name}.json", data["meta"])
            for sid, manifest in enumerate(data["shards"]):
                self._write_json(
                    f"indices/{index}/{sid}/manifest-{name}.json", manifest)
        self._write_json(f"snap-{name}.json", snap_meta)
        idx = self._read_json("index.json") or {"snapshots": []}
        if name not in idx["snapshots"]:
            idx["snapshots"].append(name)
        self._write_json("index.json", idx)

    def read_shard_manifest(self, index: str, shard: int, name: str) -> dict:
        m = self._read_json(f"indices/{index}/{shard}/manifest-{name}.json")
        if m is None:
            raise SnapshotMissingError(
                f"shard manifest [{index}][{shard}] for [{name}] missing")
        return m

    def read_index_meta(self, index: str, name: str) -> dict:
        m = self._read_json(f"indices/{index}/meta-{name}.json")
        if m is None:
            raise SnapshotMissingError(
                f"index metadata [{index}] for snapshot [{name}] missing")
        return m

    # ---- delete + GC ----

    def delete_snapshot(self, name: str) -> None:
        with self.mutation_lock:
            self._delete_snapshot_locked(name)

    def _delete_snapshot_locked(self, name: str) -> None:
        meta = self.snapshot_meta(name)
        idx = self._read_json("index.json") or {"snapshots": []}
        idx["snapshots"] = [s for s in idx["snapshots"] if s != name]
        self._write_json("index.json", idx)
        for index in meta.get("indices", []):
            base = self._path("indices", index)
            if not os.path.isdir(base):
                continue
            mp = os.path.join(base, f"meta-{name}.json")
            if os.path.exists(mp):
                os.remove(mp)
            for sid in os.listdir(base):
                p = os.path.join(base, sid, f"manifest-{name}.json")
                if os.path.exists(p):
                    os.remove(p)
        try:
            os.remove(self._path(f"snap-{name}.json"))
        except FileNotFoundError:
            pass
        self._gc_blobs()

    # ---- verification (integrity plane) ----

    def verify_probe(self) -> None:
        """Write a probe blob, read it back byte-for-byte, delete it.

        Proves the repository location is writable AND readable by this
        node before trusting it for snapshot traffic (ref:
        BlobStoreRepository#startVerification writes a master.dat probe)."""
        import uuid

        name = f"probe-{uuid.uuid4().hex[:12]}.dat"
        payload = name.encode() + os.urandom(64)
        path = self._path(name)
        try:
            with open(path, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            with open(path, "rb") as f:
                back = f.read()
            if back != payload:
                raise RepositoryError(
                    f"repository [{self.name}] probe round-trip mismatch "
                    f"at [{self.location}]")
        except OSError as e:
            raise RepositoryError(
                f"repository [{self.name}] is not accessible at "
                f"[{self.location}]: {e}")
        finally:
            try:
                os.remove(path)
            except OSError:
                pass

    def referenced_blobs_by_index(self) -> Dict[str, set]:
        """{index_name: {blob hash}} across ALL snapshots' manifests."""
        refs: Dict[str, set] = {}
        base = self._path("indices")
        if not os.path.isdir(base):
            return refs
        for index in os.listdir(base):
            for root, _, files in os.walk(os.path.join(base, index)):
                for fn in files:
                    if fn.startswith("manifest-"):
                        with open(os.path.join(root, fn)) as f:
                            m = json.load(f)
                        refs.setdefault(index, set()).update(
                            s["blob"] for s in m.get("segments", []))
        return refs

    def _referenced_blobs(self) -> set:
        refs = set()
        base = self._path("indices")
        if not os.path.isdir(base):
            return refs
        for index in os.listdir(base):
            for root, _, files in os.walk(os.path.join(base, index)):
                for fn in files:
                    if fn.startswith("manifest-"):
                        with open(os.path.join(root, fn)) as f:
                            m = json.load(f)
                        refs.update(s["blob"] for s in m.get("segments", []))
        return refs

    def _gc_blobs(self) -> int:
        refs = self._referenced_blobs()
        removed = 0
        for fn in os.listdir(self._path("blobs")):
            if fn.endswith(".seg") and fn[:-4] not in refs:
                os.remove(self._path("blobs", fn))
                removed += 1
        return removed
