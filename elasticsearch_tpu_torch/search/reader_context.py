"""Reader contexts: pinned point-in-time searchers with keepalive.

Re-designs the reference's ReaderContext registry (ref:
search/SearchService.java:198 putReaderContext / :230 keepalive reaper,
search/internal/ReaderContext.java): the query phase pins an immutable
searcher snapshot; fetch (and scroll/PIT continuations) address it by id;
an expiry sweep frees abandoned contexts. Engine segments are immutable, so
a pinned context is just a list of (segment, live-mask) views — no file
handles to leak, only HBM/host arrays to release.

The port's copy of elasticsearch_tpu/search/reader_context.py; its code differs only
in the imports.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, Optional

from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuError


class SearchContextMissingError(ElasticsearchTpuError):
    status = 404
    error_type = "search_context_missing_exception"


@dataclass
class ReaderContext:
    context_id: str
    searcher: object                  # EngineSearcher
    mapper: object                    # MapperService
    index: str
    shard_id: int
    keep_alive_s: float
    expires_at: float
    # scroll state: the cursor the next page continues from
    scroll_state: Optional[dict] = None
    extra: dict = field(default_factory=dict)


class ReaderContextRegistry:
    """Node-level registry; one per SearchService."""

    def __init__(self, default_keep_alive_s: float = 300.0,
                 max_open_contexts: int = 500):
        self._lock = threading.Lock()
        self._contexts: Dict[str, ReaderContext] = {}  # guarded by: _lock
        self.default_keep_alive_s = default_keep_alive_s
        self.max_open_contexts = max_open_contexts

    def create(self, searcher=None, mapper=None, index: str = "",
               shard_id: int = -1, keep_alive_s: Optional[float] = None,
               searchers=None) -> ReaderContext:
        """Pin one shard searcher (per-shard query/fetch contexts) or a list
        of them (`searchers=` — index-wide PIT/scroll contexts; stored in
        .extra['searchers'])."""
        keep = keep_alive_s or self.default_keep_alive_s
        ctx = ReaderContext(
            context_id=uuid.uuid4().hex, searcher=searcher, mapper=mapper,
            index=index, shard_id=shard_id, keep_alive_s=keep,
            expires_at=time.monotonic() + keep)
        if searchers is not None:
            ctx.extra["searchers"] = searchers
        with self._lock:
            if len(self._contexts) >= self.max_open_contexts:
                raise ElasticsearchTpuError(
                    f"too many open reader contexts "
                    f"(>= {self.max_open_contexts})")
            self._contexts[ctx.context_id] = ctx
        return ctx

    def get(self, context_id: str,
            extend_keep_alive: bool = True) -> ReaderContext:
        with self._lock:
            ctx = self._contexts.get(context_id)
            if ctx is None:
                raise SearchContextMissingError(
                    f"No search context found for id [{context_id}]")
            if extend_keep_alive:
                ctx.expires_at = time.monotonic() + ctx.keep_alive_s
            return ctx

    def release(self, context_id: str) -> bool:
        with self._lock:
            return self._contexts.pop(context_id, None) is not None

    def reap(self) -> int:
        """Free expired contexts; returns the number reaped (ref:
        SearchService.Reaper scheduled task)."""
        now = time.monotonic()
        with self._lock:
            dead = [cid for cid, c in self._contexts.items()
                    if c.expires_at < now]
            for cid in dead:
                del self._contexts[cid]
            return len(dead)

    @property
    def open_contexts(self) -> int:
        with self._lock:
            return len(self._contexts)
