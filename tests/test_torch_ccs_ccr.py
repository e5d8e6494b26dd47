"""tests/test_ccs_ccr.py on both packages (torch_cluster_twin).

Cross-cluster search and replication: two in-process clusters joined
by remote registries, CCS fan-out and CCR following through
`ClusterNodeHost`, on `form_local_cluster(..., device="cpu")` and on the
reference: the reference's assertions on both runs, then equal cluster
states, engine histories and search answers.
"""

from torch_cluster_twin import twin_suite

twin_suite("ccs_ccr", globals())
