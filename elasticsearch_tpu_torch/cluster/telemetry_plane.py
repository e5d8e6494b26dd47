"""Cluster telemetry plane: nodes-stats and metrics-scrape fan-out.

`GET /_nodes/stats` and `GET /_tpu/metrics` are cluster views, not node
views: the coordinator answers with its own sections plus one RPC per
peer, and a dead/partitioned peer degrades to a `node_failures` entry
instead of failing the whole response — the same partial-answer contract
the transport tier and the task plane established.

The Prometheus rendering stays on the coordinator: peers ship structured
``metrics.scrape_payload()`` dicts over the wire and the coordinator emits
ONE exposition document with a ``node`` label per sample, so a scrape of
any node covers the cluster (plus ``es_tpu_node_up 0`` rows for peers that
did not answer).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common import metrics
from elasticsearch_tpu_torch.transport.channels import (
    NodeUnavailableError, RpcTimeoutError,
)

ACTION_NODES_STATS = "cluster:monitor/nodes/stats"
ACTION_TPU_METRICS = "cluster:monitor/tpu/metrics"

_FANOUT_ERRORS = (NodeUnavailableError, RpcTimeoutError)


def _default_local_stats() -> dict:
    """Module-global sections every process can answer with (a ClusterNode
    has no REST layer — its RPC answers still need real content). A full
    Node passes a richer ``local_stats_fn`` from rest/handlers.py."""
    from elasticsearch_tpu_torch.common import hbm_ledger
    from elasticsearch_tpu_torch.threadpool.scheduler import scheduler_stats

    return {
        "tpu_scheduler": scheduler_stats(),
        "tpu_hbm": hbm_ledger.hbm_stats(),
        "tpu_compile": hbm_ledger.compile_stats(),
        "tpu_search_latency": metrics.search_latency_stats(),
    }


class TelemetryPlane:
    """One node's view of cluster telemetry.

    ``channels``/``state_fn`` are None on a standalone Node — every
    operation then degrades to the local sections, same response shapes.
    """

    def __init__(self, node_name: str,
                 channels=None,
                 state_fn: Optional[Callable[[], object]] = None,
                 transport=None,
                 local_stats_fn: Optional[Callable[[], dict]] = None):
        self.node_name = node_name
        self.channels = channels
        self.state_fn = state_fn
        self.local_stats_fn = local_stats_fn
        if transport is not None:
            transport.register_request_handler(ACTION_NODES_STATS,
                                               self._on_stats)
            transport.register_request_handler(ACTION_TPU_METRICS,
                                               self._on_metrics)

    # ---------------- topology ----------------

    def _peers(self) -> List[str]:
        if self.channels is None or self.state_fn is None:
            return []
        state = self.state_fn()
        out = []
        for nid, n in getattr(state, "nodes", {}).items():
            name = getattr(n, "name", None) or nid
            if name != self.node_name:
                out.append(name)
        return out

    def _failure(self, peer: str, e) -> dict:
        return {
            "type": "failed_node_exception",
            "reason": f"Failed node [{peer}]",
            "node_id": peer,
            "caused_by": {"type": e.error_type, "reason": str(e)},
        }

    # ---------------- fan-outs ----------------

    def _local_stats(self) -> dict:
        out = (self.local_stats_fn() if self.local_stats_fn is not None
               else _default_local_stats())
        out.setdefault("name", self.node_name)
        return out

    def nodes_stats(self) -> Tuple[Dict[str, dict], List[dict]]:
        """Per-node stats sections keyed by node name, plus failures."""
        per_node: Dict[str, dict] = {self.node_name: self._local_stats()}
        failures: List[dict] = []
        for peer in self._peers():
            try:
                r = self.channels.request(peer, ACTION_NODES_STATS, {},
                                          source=self.node_name)
                per_node[peer] = r["stats"]
            except _FANOUT_ERRORS as e:
                failures.append(self._failure(peer, e))
        return per_node, failures

    def scrape(self) -> Tuple[Dict[str, dict], List[dict]]:
        """Per-node ``metrics.scrape_payload()`` dumps, plus failures."""
        per_node: Dict[str, dict] = {self.node_name: metrics.scrape_payload()}
        failures: List[dict] = []
        for peer in self._peers():
            try:
                r = self.channels.request(peer, ACTION_TPU_METRICS, {},
                                          source=self.node_name)
                per_node[peer] = r["payload"]
            except _FANOUT_ERRORS as e:
                failures.append(self._failure(peer, e))
        return per_node, failures

    def prometheus(self) -> Tuple[str, List[dict]]:
        """The /_tpu/metrics response body: one cluster-wide exposition."""
        per_node, failures = self.scrape()
        return metrics.render_prometheus(per_node, failures), failures

    # ---------------- RPC handlers ----------------

    def _on_stats(self, req) -> dict:
        return {"stats": self._local_stats()}

    def _on_metrics(self, req) -> dict:
        return {"payload": metrics.scrape_payload()}
