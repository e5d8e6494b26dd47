"""Shared rollover mechanics (ref: cluster/metadata/
MetadataRolloverService.java) used by BOTH the single-node REST handler
(rest/handlers.rollover) and the distributed coordinator
(cluster_node.rollover) — one implementation of name sequencing,
condition evaluation and the alias swap, so the two paths cannot drift.

The port's copy of elasticsearch_tpu/indices/rollover.py.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError

_SEQ = re.compile(r"^(.*?)-(\d+)$")


def next_rollover_name(old_name: str) -> str:
    """logs-000001 -> logs-000002 (zero-padded to six, like the
    reference's generateRolloverIndexName)."""
    m = _SEQ.match(old_name)
    if not m:
        raise IllegalArgumentError(
            f"index name [{old_name}] does not match pattern '^.*-\\d+$' — "
            "specify the target index name")
    return f"{m.group(1)}-{int(m.group(2)) + 1:06d}"


def evaluate_rollover_conditions(conditions: dict,
                                 metrics: Dict[str, object]) -> Dict[str, bool]:
    """{condition: met} for the given metrics. metrics maps condition name
    -> current value (max_age expects age_ms, sizes expect bytes); a
    condition with no metric available on the calling path raises, so an
    unsupported condition can never silently pass."""
    met: Dict[str, bool] = {}
    for cond, want in (conditions or {}).items():
        if cond not in metrics:
            raise IllegalArgumentError(
                f"unknown rollover condition [{cond}]")
        value = metrics[cond]
        if cond == "max_age":
            from elasticsearch_tpu_torch.tasks.task_manager import parse_timeout_ms

            met[cond] = float(value) >= (parse_timeout_ms(want) or 0)
        elif cond in ("max_size", "max_primary_shard_size"):
            met[cond] = float(value) >= _parse_bytes(want)
        else:                      # max_docs, max_primary_shard_docs
            met[cond] = float(value) >= int(want)
    return met


def _parse_bytes(v) -> int:
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    for suffix, mult in (("pb", 1 << 50), ("tb", 1 << 40), ("gb", 1 << 30),
                         ("mb", 1 << 20), ("kb", 1 << 10), ("b", 1)):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * mult)
    return int(float(s))


def rollover_alias_actions(alias: str, old_name: str, new_name: str,
                           old_spec: Optional[dict]) -> List[dict]:
    """The alias swap as _aliases-style actions: a write-index managed
    alias stays on the old index demoted to is_write_index false; a plain
    alias moves entirely."""
    spec = dict(old_spec or {})
    if spec.get("is_write_index"):
        return [
            {"add": {"index": old_name, "alias": alias,
                     **{**spec, "is_write_index": False}}},
            {"add": {"index": new_name, "alias": alias,
                     **{**spec, "is_write_index": True}}},
        ]
    return [{"remove": {"index": old_name, "alias": alias}},
            {"add": {"index": new_name, "alias": alias, **spec}}]
