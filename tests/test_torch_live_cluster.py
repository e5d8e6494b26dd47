"""tests/test_live_cluster.py on the port: LiveClusterNode over real sockets.

Both cases run the reference's function on the port
(`LiveClusterNode(..., device="cpu")`, through `torch_cluster_twin`) under
its assertions and timeouts: election, join, allocation, replicated
writes, distributed search and node-death failover over the TCP
transport, then rollover, aliases and close. Nothing of two live runs can
be compared (elections, pings and retries race by design), so the
reference's own run of the suite is not repeated here.
"""

from torch_cluster_twin import twin_suite

RACES = "elections, pings and retries over real sockets race by design"

twin_suite("live_cluster", globals(),
           port_only={"test_live_three_node_cluster_end_to_end": RACES,
                      "test_live_lifecycle_rollover_aliases_close": RACES})
