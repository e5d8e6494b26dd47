"""tests/test_relocation.py on both packages (torch_cluster_twin).

The rolling maintenance plane: shard relocation with the warm device
handoff, node drain, delayed allocation, rebalancing, on `form_local_cluster(..., device="cpu")` and on the
reference: the reference's assertions on both runs, then equal cluster
states, engine histories and search answers.
"""

from torch_cluster_twin import twin_suite

twin_suite("relocation", globals())
