from elasticsearch_tpu_torch.transport.service import TransportService, TransportRequest

__all__ = ["TransportService", "TransportRequest"]
