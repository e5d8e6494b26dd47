"""The two heaviest cases of tests/test_distributed.py on both packages.

As tests/test_torch_distributed.py (the rest of the suite), through
`torch_cluster_twin`: peer recovery of a 100,000-doc shard (engine
histories and checkpoints equal on every copy), and the shard query
phase on the serving engines against the dense executor, also with Turbo
serving the shards (`__turbo`: answers bitwise the reference's).
"""

from torch_cluster_twin import twin_suite

twin_suite("distributed", globals(),
           only=("test_peer_recovery_at_scale_100k_docs",
                 "test_shard_serving_fast_path_matches_dense"),
           modes={"test_shard_serving_fast_path_matches_dense": "turbo"})
