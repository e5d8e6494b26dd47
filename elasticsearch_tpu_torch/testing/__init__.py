from elasticsearch_tpu_torch.testing.deterministic import DeterministicTaskQueue
from elasticsearch_tpu_torch.testing.linearizability import LinearizabilityChecker

__all__ = ["DeterministicTaskQueue", "LinearizabilityChecker"]
