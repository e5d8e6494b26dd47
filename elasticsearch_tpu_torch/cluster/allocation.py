"""Shard allocation: the dynamic cluster settings its deciders read.

The REST node registers these two settings (node.py), so
`PUT /_cluster/settings` accepts them and they land in
`ClusterState.settings`, as on the reference. A standalone node has
nowhere to relocate a shard, so nothing reads them there yet.
`AllocationService` (reroute, relocation pairs, the drain and rebalance
deciders, dead-node handling) comes with the cluster path, ROADMAP item
10a, together with its reference suite.
"""

# dynamic cluster settings consulted by the deciders (set through
# PUT /_cluster/settings and replicated inside ClusterState.settings)
EXCLUDE_NAME_SETTING = "cluster.routing.allocation.exclude._name"
CONCURRENT_RELOC_SETTING = \
    "cluster.routing.allocation.cluster_concurrent_rebalance"
DEFAULT_CONCURRENT_RELOCATIONS = 2
