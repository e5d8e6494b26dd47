from elasticsearch_tpu_torch.snapshots.repository import (
    FsRepository, RepositoryError, SnapshotMissingError,
)
from elasticsearch_tpu_torch.snapshots.service import (
    InvalidSnapshotNameError, SnapshotsService,
)

__all__ = ["FsRepository", "RepositoryError", "SnapshotMissingError",
           "InvalidSnapshotNameError", "SnapshotsService"]
