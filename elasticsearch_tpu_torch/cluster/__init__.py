from elasticsearch_tpu_torch.cluster.state import ClusterState, IndexMetadata, DiscoveryNode

__all__ = ["ClusterState", "IndexMetadata", "DiscoveryNode"]
