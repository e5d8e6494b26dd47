"""The port's consensus layer against the reference's, on the CPU.

Every case of tests/test_coordination.py runs on both packages through
`torch_cluster_twin` (the reference's function as written, and again on
the port's `cluster.coordination` and `testing/`). Each `SimCluster` is
seeded alike, so beyond the reference's own assertions the two runs must
commit the same histories: on every node, the same (term, version, value,
voting configurations) in the same order.
"""

import dataclasses

from torch_cluster_twin import twin_suite


def _committed_histories(mod, mp, observed):
    sims = []
    init = mod.SimCluster.__init__

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        sims.append(self)

    mp.setattr(mod.SimCluster, "__init__", recorded)
    observed["committed"] = lambda: [
        {n: [dataclasses.asdict(s) for s in states]
         for n, states in sim.committed.items()} for sim in sims]


twin_suite("coordination", globals(), observe=_committed_histories)
