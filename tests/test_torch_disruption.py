"""tests/test_disruption.py on both packages (torch_cluster_twin).

Failover, transport circuits, RPC deadlines, can_match fail-open and
fetch isolation under injected transport faults, on
`form_local_cluster(..., device="cpu")` and on the reference: the
reference's assertions on both runs, then equal cluster states, engine
histories and search answers. Two cases race by design; they compare
their final cluster states only. The transport circuit's case runs its
circuits on a StepClock: its 50 ms backoff must not lapse between two
searches the test makes back to back, which a loaded host can make it do.
"""

from torch_cluster_twin import twin_suite

twin_suite("disruption", globals(), loose={
    "test_fetch_failure_drops_one_shard_keeps_rest":
        "which copy serves first follows the nodes' measured service times",
    "test_deadline_expired_mid_fanout_skips_remaining_shards":
        "which shards answer inside the 200 ms budget follows the clock",
}, step_clock={"test_transport_circuit_opens_then_recovers"})
