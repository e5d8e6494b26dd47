"""Query DSL, the dense search path (`execute_search`: query and fetch
phases over the dense executor) and the serving fast paths."""

from elasticsearch_tpu_torch.search.queries import Query, parse_query
from elasticsearch_tpu_torch.search.search_service import execute_search

__all__ = ["Query", "parse_query", "execute_search"]
