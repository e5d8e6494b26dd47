"""SnapshotsService: create / get / restore / delete snapshots.

Re-designs the reference's snapshot orchestration (ref:
snapshots/SnapshotsService.java:116 createSnapshot state machine,
RestoreService.java restore-into-new-index) at the node level: shards are
flushed+refreshed, each published segment travels to the repository as one
content-addressed blob (unchanged segments are skipped — incremental), and
restore creates a fresh index from the stored metadata and installs the
blobs through the engine's recovery entry point (install_segment), exactly
the path peer recovery uses.

The port's copy of elasticsearch_tpu/snapshots/service.py. A restored
segment is rebuilt on the engine's device (`install_segment`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuError,
    IllegalArgumentError,
    ResourceAlreadyExistsError,
)
from elasticsearch_tpu_torch.snapshots.repository import (
    FsRepository, RepositoryError, SnapshotMissingError, _mask_from_wire,
    _mask_to_wire,
)


class InvalidSnapshotNameError(ElasticsearchTpuError):
    status = 400
    error_type = "invalid_snapshot_name_exception"


class SnapshotsService:
    def __init__(self, indices, create_index: Callable[[str, dict], object],
                 delete_index: Optional[Callable[[str], None]] = None):
        self.indices = indices
        self._create_index = create_index
        self._delete_index = delete_index
        self.repositories: Dict[str, FsRepository] = {}

    # ---- repositories ----

    def put_repository(self, name: str, type_: str, settings: dict) -> None:
        if type_ != "fs":
            raise RepositoryError(f"unknown repository type [{type_}]")
        location = settings.get("location")
        if not location:
            raise RepositoryError("missing location")
        # re-registering the same name+location must keep the existing
        # instance: replacing it would discard the mutation_lock any
        # in-flight create/restore holds, letting a delete via the new
        # instance GC blobs of an in-flight snapshot
        existing = self.repositories.get(name)
        if existing is not None and existing.location == location:
            return
        self.repositories[name] = FsRepository(name, location)

    def repository(self, name: str) -> FsRepository:
        repo = self.repositories.get(name)
        if repo is None:
            raise RepositoryError(f"[{name}] missing repository")
        return repo

    # ---- create ----

    def create(self, repo_name: str, snap_name: str,
               indices: Optional[List[str]] = None) -> dict:
        repo = self.repository(repo_name)
        if not snap_name or snap_name != snap_name.lower() or "/" in snap_name:
            raise InvalidSnapshotNameError(
                f"[{snap_name}] must be lowercase and without '/'")
        names = indices or self.indices.names()
        # hold the repository mutation lock across the exists-check + blob +
        # manifest writes so a concurrent delete's GC cannot reap blobs of
        # this in-flight snapshot and two same-name creates cannot both pass
        # the exists check
        with repo.mutation_lock:
            if snap_name in repo.snapshots():
                raise InvalidSnapshotNameError(
                    f"[{repo_name}:{snap_name}] snapshot already exists")
            return self._create_locked(repo, snap_name, names)

    def _create_locked(self, repo, snap_name, names) -> dict:
        start_ms = int(time.time() * 1000)
        out_indices: Dict[str, dict] = {}
        total_segments = 0
        reused_segments = 0
        for index in names:
            svc = self.indices.get(index)
            meta = svc.meta
            shards = []
            for engine in svc.shards:
                payloads, max_seq_no = engine.segment_payloads()
                segments = []
                for blob_bytes, live in payloads:
                    h, new = repo.put_segment_blob(blob_bytes)
                    total_segments += 1
                    reused_segments += 0 if new else 1
                    segments.append({"blob": h, "live": _mask_to_wire(live),
                                     "n_docs": int(len(live))})
                shards.append({"segments": segments,
                               "max_seq_no": int(max_seq_no)})
            out_indices[index] = {
                "meta": {
                    "settings": meta.settings.as_nested_dict(),
                    "mappings": svc.mapper.mapping(),
                    "number_of_shards": meta.number_of_shards,
                },
                "shards": shards,
            }
        snap_meta = {
            "snapshot": snap_name,
            "uuid": snap_name,
            "state": "SUCCESS",
            "indices": sorted(out_indices),
            "start_time_in_millis": start_ms,
            "end_time_in_millis": int(time.time() * 1000),
            "shards": {"total": sum(len(d["shards"]) for d in out_indices.values()),
                       "failed": 0,
                       "successful": sum(len(d["shards"])
                                         for d in out_indices.values())},
            "stats": {"segments": total_segments,
                      "segments_reused": reused_segments},
        }
        repo.write_snapshot(snap_name, out_indices, snap_meta)
        return snap_meta

    def get(self, repo_name: str, snap_name: str) -> dict:
        return self.repository(repo_name).snapshot_meta(snap_name)

    def list(self, repo_name: str) -> List[dict]:
        repo = self.repository(repo_name)
        return [repo.snapshot_meta(s) for s in repo.snapshots()]

    def delete(self, repo_name: str, snap_name: str) -> None:
        self.repository(repo_name).delete_snapshot(snap_name)

    # ---- restore ----

    def restore(self, repo_name: str, snap_name: str,
                indices: Optional[List[str]] = None,
                rename_pattern: Optional[str] = None,
                rename_replacement: Optional[str] = None) -> dict:
        repo = self.repository(repo_name)
        # restore reads manifests + blobs: hold the mutation lock so a
        # concurrent delete cannot GC them mid-restore
        with repo.mutation_lock:
            meta = repo.snapshot_meta(snap_name)
            return self._restore_locked(
                repo, snap_name, meta, indices, rename_pattern,
                rename_replacement)

    def _restore_locked(self, repo, snap_name, meta, indices,
                        rename_pattern, rename_replacement) -> dict:
        import re

        targets = indices or meta["indices"]
        restored = []
        for index in targets:
            if index not in meta["indices"]:
                raise SnapshotMissingError(
                    f"index [{index}] not in snapshot [{snap_name}]")
            target = index
            if rename_pattern and rename_replacement is not None:
                target = re.sub(rename_pattern, rename_replacement, index)
            if self.indices.has(target):
                raise ResourceAlreadyExistsError(
                    f"cannot restore index [{target}]: an open index "
                    "with the same name already exists", index=target)
            imeta = repo.read_index_meta(index, snap_name)
            body = {"settings": imeta.get("settings", {}),
                    "mappings": imeta.get("mappings", {})}
            self._create_index(target, body)
            try:
                svc = self.indices.get(target)
                if len(svc.shards) != imeta["number_of_shards"]:
                    raise IllegalArgumentError(
                        f"restored index [{target}] shard count mismatch")
                for sid, engine in enumerate(svc.shards):
                    manifest = repo.read_shard_manifest(index, sid, snap_name)
                    for seg in manifest["segments"]:
                        blob = repo.read_segment_blob(seg["blob"])
                        engine.install_segment(
                            blob, _mask_from_wire(seg["live"]))
                    engine.fill_seqno_gaps(int(manifest["max_seq_no"]))
            except Exception:
                # a restore that dies mid-install (corrupt/missing blob,
                # shape mismatch) must not leave a half-populated index
                # behind — it would mask the failure AND block a retry with
                # ResourceAlreadyExists (ref: RestoreService cleans up the
                # restoring index on failure); the ORIGINAL error surfaces
                self._cleanup_failed_restore(target)
                raise
            restored.append(target)
        return {"snapshot": {"snapshot": snap_name, "indices": restored,
                             "shards": {"total": len(restored), "failed": 0,
                                        "successful": len(restored)}}}

    def _cleanup_failed_restore(self, target: str) -> None:
        from elasticsearch_tpu_torch.common import integrity

        try:
            if self._delete_index is not None:
                self._delete_index(target)
            else:
                self.indices.delete_index(target)
            integrity.count("restore_cleanups")
        except Exception:   # noqa: BLE001 — never shadow the restore error
            pass

    # ---- verify ----

    def verify_repository(self, repo_name: str) -> dict:
        """POST /_snapshot/{repo}/_verify: probe write/read round-trip plus
        a full re-hash of every segment blob referenced by any manifest.

        The reference's verify only proves the repository is writable from
        each node; with a content-addressed store we can go further and
        prove every *referenced* byte still matches its address — a bit
        flip in a repository blob is found here, not at restore time."""
        from elasticsearch_tpu_torch.common import integrity

        repo = self.repository(repo_name)
        with repo.mutation_lock:
            repo.verify_probe()
            refs_by_index = repo.referenced_blobs_by_index()
            checked = 0
            corrupt: Dict[str, List[str]] = {}
            seen_bad: Dict[str, bool] = {}
            for index in sorted(refs_by_index):
                bad = []
                for h in sorted(refs_by_index[index]):
                    if h in seen_bad:
                        ok = not seen_bad[h]
                    else:
                        checked += 1
                        try:
                            repo.read_segment_blob(h)
                            ok = True
                        except RepositoryError:
                            ok = False
                        seen_bad[h] = not ok
                        if not ok:
                            integrity.count("repo_corrupt_blobs")
                    if not ok:
                        bad.append(h)
                if bad:
                    corrupt[index] = bad
        integrity.count("repo_verifies")
        return {"repository": repo_name, "probe": "ok",
                "blobs_checked": checked,
                "corrupt_blob_count": sum(len(v) for v in corrupt.values()),
                "corrupt": corrupt,
                "verified": not corrupt}
