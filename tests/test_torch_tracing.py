"""tests/test_tracing.py on both packages (torch_cluster_twin).

The search flight recorder: latency histograms, trace propagation
coordinator -> shard RPC -> `profile.tpu`, and the slowlog ring, on `form_local_cluster(..., device="cpu")` and on the
reference: the reference's assertions on both runs, then equal cluster
states, engine histories and search answers.
"""

from torch_cluster_twin import twin_suite

twin_suite("tracing", globals())
