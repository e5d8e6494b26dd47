"""tests/test_backpressure.py on both packages (torch_cluster_twin).

The bounded coordinator reduce, indexing backpressure and the
data-only aggregation wire codec (`common/wire.py`), on `form_local_cluster(..., device="cpu")` and on the
reference: the reference's assertions on both runs, then equal cluster
states, engine histories and search answers.
"""

from torch_cluster_twin import twin_suite

twin_suite("backpressure", globals())
