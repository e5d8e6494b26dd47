"""Text analysis (the port's copy of elasticsearch_tpu/analysis)."""

from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry, Analyzer

__all__ = ["AnalysisRegistry", "Analyzer"]
