"""tests/test_task_plane.py on both packages (torch_cluster_twin).

Cross-node task trees, ban-propagated cancellation, hot-threads fan-out
and partial answers over dead peers, on `form_local_cluster(..., device="cpu")` and on the
reference: the reference's assertions on both runs, then equal cluster
states, engine histories and search answers.
"""

from torch_cluster_twin import twin_suite

twin_suite("task_plane", globals())
