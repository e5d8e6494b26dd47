"""The port's replication groups against the reference's, on the CPU.

Every case of tests/test_replication.py runs on both packages through
`torch_cluster_twin`: the reference's function as written, and again on
the port's `index.replication` over `InternalEngine(device="cpu")`. Beyond
the reference's own assertions, every engine of the two runs must end
with the same operation history (op, id, seq_no, version, source), local
checkpoint, max seq_no and primary term.
"""

from torch_cluster_twin import twin_suite

twin_suite("replication", globals())
