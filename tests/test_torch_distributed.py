"""The port's cluster path against the reference's, on the CPU.

Every case of tests/test_distributed.py but the two heaviest (in
tests/test_torch_distributed_scale.py) runs on both packages through
`torch_cluster_twin`: `form_local_cluster(..., device="cpu")` on the
port, the reference's function as written on the reference. Beyond the
reference's own assertions the two runs must end with equal cluster
states (routing tables, in-sync sets, primary terms), equal engine
histories and checkpoints on every shard copy, and equal search answers:
bitwise when Turbo serves the shard queries (the `__turbo` cases, with
`TURBO_ENV`), else within `assert_blockmax_results`'s bound.
"""

from torch_cluster_twin import twin_suite

HEAVY = ("test_peer_recovery_at_scale_100k_docs",
         "test_shard_serving_fast_path_matches_dense")
SEARCHING = ("test_bulk_via_one_node_search_via_another",
             "test_primary_failover_promotes_and_writes_continue",
             "test_distributed_profile_returns_tree")

twin_suite("distributed", globals(), skip=HEAVY,
           modes={n: "turbo" for n in SEARCHING})
