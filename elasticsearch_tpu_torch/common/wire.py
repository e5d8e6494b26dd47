"""Data-only wire codec for structured values (aggregation partials).

Extends the segment_io principle (JSON header + raw arrays, never pickle)
to ARBITRARY nested python/numpy values: aggregation partials are monoid
states built from dicts (sometimes with tuple keys — composite buckets),
lists, tuples, numpy arrays/scalars and primitives. Encoding tags each
node; decoding only CONSTRUCTS data — no code ever executes.

Ref: the reference's StreamInput/StreamOutput named-writeable registry
(server/src/main/java/org/elasticsearch/common/io/stream/) — a closed,
code-free set of wire shapes.
"""

from __future__ import annotations

import base64
from typing import Any

import numpy as np


class WireError(ValueError):
    pass


def encode_value(obj: Any):
    """Value -> JSON-safe structure (data only)."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        if obj != obj or obj in (float("inf"), float("-inf")):
            return {"__t": "f", "v": repr(obj)}
        return obj
    if isinstance(obj, np.ndarray):
        return {"__t": "nd", "d": str(obj.dtype), "s": list(obj.shape),
                "b": base64.b64encode(np.ascontiguousarray(obj).tobytes())
                .decode("ascii")}
    if isinstance(obj, np.generic):
        return {"__t": "np", "d": str(obj.dtype),
                "v": encode_value(obj.item())}
    if isinstance(obj, tuple):
        return {"__t": "tu", "v": [encode_value(x) for x in obj]}
    if isinstance(obj, list):
        return {"__t": "li", "v": [encode_value(x) for x in obj]}
    if isinstance(obj, (set, frozenset)):
        return {"__t": "se", "v": [encode_value(x) for x in sorted(
            obj, key=repr)]}
    if isinstance(obj, dict):
        if all(isinstance(k, str) and k != "__t" for k in obj):
            return {"__t": "di",
                    "v": {k: encode_value(v) for k, v in obj.items()}}
        return {"__t": "dk",
                "v": [[encode_value(k), encode_value(v)]
                      for k, v in obj.items()]}
    if isinstance(obj, bytes):
        return {"__t": "by", "b": base64.b64encode(obj).decode("ascii")}
    raise WireError(f"non-wireable type {type(obj).__name__}")


def decode_value(enc: Any):
    """Inverse of encode_value; constructs data only."""
    if enc is None or isinstance(enc, (bool, int, float, str)):
        return enc
    if isinstance(enc, list):
        return [decode_value(x) for x in enc]
    if not isinstance(enc, dict):
        raise WireError(f"malformed wire value {type(enc).__name__}")
    t = enc.get("__t")
    if t == "f":
        return float(enc["v"])
    if t == "nd":
        arr = np.frombuffer(base64.b64decode(enc["b"]),
                            dtype=np.dtype(enc["d"]))
        return arr.reshape([int(x) for x in enc["s"]]).copy()
    if t == "np":
        return np.dtype(enc["d"]).type(decode_value(enc["v"]))
    if t == "tu":
        return tuple(decode_value(x) for x in enc["v"])
    if t == "li":
        return [decode_value(x) for x in enc["v"]]
    if t == "se":
        return set(decode_value(x) for x in enc["v"])
    if t == "di":
        return {k: decode_value(v) for k, v in enc["v"].items()}
    if t == "dk":
        return {decode_value(k): decode_value(v) for k, v in enc["v"]}
    if t == "by":
        return base64.b64decode(enc["b"])
    raise WireError(f"unknown wire tag {t!r}")


def wire_size_estimate(enc: Any) -> int:
    """Rough byte estimate of an ENCODED value (breaker accounting)."""
    if enc is None or isinstance(enc, (bool, int, float)):
        return 8
    if isinstance(enc, str):
        return 8 + len(enc)
    if isinstance(enc, list):
        return 8 + sum(wire_size_estimate(x) for x in enc)
    if isinstance(enc, dict):
        if enc.get("__t") in ("nd", "by"):
            return 16 + (len(enc["b"]) * 3) // 4
        return 8 + sum(8 + len(k) + wire_size_estimate(v)
                       for k, v in enc.items() if k != "__t")
    return 8
