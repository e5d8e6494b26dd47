"""Shared response-envelope finalization for every search assembler."""

from __future__ import annotations


def finalize_hits_envelope(resp: dict, request: dict) -> dict:
    """Apply request-driven envelope rules shared by the dense coordinator,
    the serving fast path, the distributed action and the single-shard
    convenience path (ref: ES omits hits.total when track_total_hits=false)."""
    if request.get("track_total_hits") is False:
        resp.get("hits", {}).pop("total", None)
    return resp
