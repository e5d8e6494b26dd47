"""Cross-cluster replication: the `tpu_ccr` stats of a node that follows
no index.

The REST node builds a `CcrService`, stops it on close and reports its
`stats()` under `tpu_ccr` in GET /_nodes/stats, as the reference's node
does. Following itself (the /_ccr routes, the follower pull loop over
`RemoteClusterService`, the leader-side op-shipping handlers and their
checksummed batches) comes with ROADMAP item 9c part 2, and its
multi-node host with the cluster path, item 10a, each with its reference
suite. Until then no follower index exists, and the shipping counters
stay at zero.
"""

from __future__ import annotations

from elasticsearch_tpu_torch.common import metrics


class CcrService:
    """Follower-index registry of one node; empty until following is
    ported."""

    def stop(self) -> None:
        """No poll thread runs: nothing to stop."""

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
            "followers": [],
        }
