"""tests/test_overload.py on both packages (torch_cluster_twin).

The overload control plane's consumers: transport admission, the
node-wide retry budget, piggybacked peer pressure, REST storms, on `form_local_cluster(..., device="cpu")` and on the
reference: the reference's assertions on both runs, then equal cluster
states, engine histories and search answers.
"""

from torch_cluster_twin import twin_suite

twin_suite("overload", globals())
