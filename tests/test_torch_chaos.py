"""tests/test_chaos.py on both packages (torch_cluster_twin).

The acked-writes chaos suite: seeded bulk streams interleaved with
primary kills, promotions, crash-restarts (`testing.chaos`) and
injected durability faults, on `form_local_cluster(..., device="cpu")` and on the
reference: the reference's assertions on both runs, then equal cluster
states, engine histories and search answers.
"""

from torch_cluster_twin import twin_suite

twin_suite("chaos", globals())
