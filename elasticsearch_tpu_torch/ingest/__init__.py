from elasticsearch_tpu_torch.ingest.processors import (
    DropDocument, IngestDocument, IngestProcessorError, PROCESSORS,
)
from elasticsearch_tpu_torch.ingest.service import (
    IngestService, Pipeline, PipelineMissingError,
)

__all__ = ["DropDocument", "IngestDocument", "IngestProcessorError",
           "PROCESSORS", "IngestService", "Pipeline", "PipelineMissingError"]
