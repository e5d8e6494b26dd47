"""REST dispatch: method+path-pattern routing to handlers.

Re-designs the reference RestController's path trie
(ref: rest/RestController.java:153 registerHandler — patterns like
"/{index}/_search") with the same placeholder syntax. Handlers receive a
RestRequest (params from placeholders + query string, parsed JSON body) and
return a RestResponse. Exceptions map to ES-shaped error bodies with the
status from the error class (ref: ElasticsearchException.status()).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuError, JsonParseError


@dataclass
class RestRequest:
    method: str
    path: str
    params: Dict[str, str] = field(default_factory=dict)
    body: Any = None
    raw_body: bytes = b""
    headers: Dict[str, str] = field(default_factory=dict)

    def param(self, name: str, default=None):
        return self.params.get(name, default)

    def param_bool(self, name: str, default: bool = False) -> bool:
        v = self.params.get(name)
        if v is None:
            return default
        return str(v).lower() in ("true", "1", "")

    def param_int(self, name: str, default: int = 0) -> int:
        v = self.params.get(name)
        return default if v is None else int(v)


@dataclass
class RestResponse:
    status: int = 200
    body: Any = None
    content_type: str = "application/json"
    headers: Dict[str, str] = field(default_factory=dict)

    def encode(self) -> bytes:
        if isinstance(self.body, (bytes,)):
            return self.body
        if isinstance(self.body, str):
            return self.body.encode()
        return json.dumps(self.body, default=_json_default).encode()


def _json_default(o):
    """Numpy scalars leak into responses from columnar code (sort values,
    doc values); serialize them as their Python equivalents."""
    import numpy as np

    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"Object of type {type(o).__name__} is not JSON serializable")


Handler = Callable[[RestRequest], RestResponse]


class _Route:
    __slots__ = ("segments", "handler")

    def __init__(self, pattern: str, handler: Handler):
        self.segments = [s for s in pattern.split("/") if s]
        self.handler = handler

    def match(self, parts: List[str]) -> Optional[Dict[str, str]]:
        if len(parts) != len(self.segments):
            return None
        params: Dict[str, str] = {}
        for seg, part in zip(self.segments, parts):
            if seg.startswith("{") and seg.endswith("}"):
                params[seg[1:-1]] = part
            elif seg != part:
                return None
        return params

    @property
    def specificity(self) -> tuple:
        # literal segments beat placeholders position-by-position
        return tuple(0 if s.startswith("{") else 1 for s in self.segments)


class RestController:
    def __init__(self):
        self._routes: Dict[str, List[_Route]] = {}
        # authn/authz action filter (security/service.py) — runs before
        # every handler when security is enabled (ref: the reference's
        # SecurityActionFilter wrapping the action chain)
        self.security_filter = None
        # overload admission hook (common/overload.py) — called with
        # (method, path, params) before body parse; a non-None RestResponse
        # sheds the request (429 + Retry-After) without running the handler
        self.admission = None

    def register(self, method: str, pattern: str, handler: Handler) -> None:
        self._routes.setdefault(method.upper(), []).append(_Route(pattern, handler))
        self._routes[method.upper()].sort(key=lambda r: r.specificity, reverse=True)

    def dispatch(self, method: str, path: str, params: Dict[str, str] | None = None,
                 body: bytes | str | None = None,
                 headers: Dict[str, str] | None = None) -> RestResponse:
        parts = [p for p in path.split("?")[0].split("/") if p]
        routes = self._routes.get(method.upper(), [])
        for route in routes:
            matched = route.match(parts)
            if matched is not None:
                req_params = dict(params or {})
                req_params.update(matched)
                if self.admission is not None:
                    shed = self.admission(method.upper(), path, req_params)
                    if shed is not None:
                        return shed
                parsed, raw, parse_error = _parse_body(body)
                if parse_error and not _is_ndjson_endpoint(parts):
                    err = JsonParseError("request body is not valid JSON")
                    return RestResponse(status=err.status, body=_error_body(err))
                req = RestRequest(method=method.upper(), path=path, params=req_params,
                                  body=parsed, raw_body=raw,
                                  headers={k.lower(): v for k, v in
                                           (headers or {}).items()})
                try:
                    if self.security_filter is not None:
                        self.security_filter(req, parts)
                    return route.handler(req)
                except ElasticsearchTpuError as e:
                    return RestResponse(status=e.status, body=_error_body(e),
                                        headers=_backoff_headers(e))
                except Exception as e:  # noqa: BLE001 — REST boundary
                    err = ElasticsearchTpuError(str(e))
                    return RestResponse(status=500, body=_error_body(err))
        if method.upper() == "HEAD":
            return RestResponse(status=404, body={})
        return RestResponse(
            status=400,
            body={"error": f"no handler found for uri [{path}] and method [{method.upper()}]"},
        )


def _is_ndjson_endpoint(parts: List[str]) -> bool:
    """bulk/_msearch bodies are newline-delimited JSON, parsed downstream."""
    return any(p in ("_bulk", "_msearch") for p in parts)


def _parse_body(body) -> Tuple[Any, bytes, bool]:
    if body is None:
        return None, b"", False
    raw = body.encode() if isinstance(body, str) else body
    if not raw.strip():
        return None, raw, False
    try:
        return json.loads(raw), raw, False
    except json.JSONDecodeError:
        return None, raw, True


def _error_body(e: ElasticsearchTpuError) -> dict:
    cause = e.to_dict()
    return {"error": {"root_cause": [cause], **cause}, "status": e.status}


def _backoff_headers(e: ElasticsearchTpuError) -> Dict[str, str]:
    """429s carry a Retry-After derived from the rejecting layer's hint
    (pool queue EWMA or the overload controller's backoff)."""
    ra = e.metadata.get("retry_after_s")
    if ra is None:
        return {}
    return {"Retry-After": str(max(1, int(ra)))}
