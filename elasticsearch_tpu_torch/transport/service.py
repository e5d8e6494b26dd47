"""Action-registry RPC: the control-plane transport.

Re-designs the reference transport (ref: transport/TransportService.java —
registerRequestHandler / sendRequest with action-name routing) as a registry
of named handlers. In-process dispatch is the local fast path (the reference
short-circuits local sends the same way); remote dispatch serializes the
request dict as JSON over a length-prefixed TCP frame, mirroring the
reference's framed protocol (ref: transport/TcpTransport.java,
InboundDecoder/OutboundHandler) without its bespoke binary format.

Action names follow the reference convention, e.g.
"indices:data/read/search", "indices:data/write/bulk",
"cluster:monitor/health" (ref: action/ActionModule.java registrations).

The port's copy of elasticsearch_tpu/transport/service.py. A remote
handler's kernel error of the port (`KernelBuildError`,
`KernelLaunchError`) crosses the wire under its class name and is raised
again, with that type, by `send_remote`.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuError, KernelBuildError, KernelLaunchError,
)

_FRAME = struct.Struct("<I")
_KERNEL_ERRORS = {e.__name__: e for e in (KernelBuildError,
                                          KernelLaunchError)}


@dataclass
class TransportRequest:
    action: str
    payload: dict
    source_node: str = "local"


Handler = Callable[[TransportRequest], dict]


class TransportService:
    def __init__(self, node_id: str = "local"):
        self.node_id = node_id
        self._handlers: Dict[str, Handler] = {}
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self.bound_port: Optional[int] = None

    def register_request_handler(self, action: str, handler: Handler) -> None:
        self._handlers[action] = handler

    def handle(self, action: str, payload: dict, source_node: str = "local") -> dict:
        handler = self._handlers.get(action)
        if handler is None:
            raise ElasticsearchTpuError(f"No handler for action [{action}]")
        return handler(TransportRequest(action, payload, source_node))

    # ---- TCP binding (inter-node control plane over DCN) ----

    def bind(self, host: str = "127.0.0.1", port: int = 0) -> int:
        service = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        header = _recv_exact(self.request, _FRAME.size)
                        if header is None:
                            return
                        (length,) = _FRAME.unpack(header)
                        body = _recv_exact(self.request, length)
                        if body is None:
                            return
                        msg = json.loads(body)
                        try:
                            resp = service.handle(msg["action"], msg.get("payload", {}),
                                                  msg.get("source_node", "remote"))
                            out = {"ok": True, "response": resp}
                        except ElasticsearchTpuError as e:
                            out = {"ok": False, "error": e.to_dict(), "status": e.status}
                        except (KernelBuildError, KernelLaunchError) as e:
                            out = {"ok": False, "status": 500,
                                   "kernel_error": type(e).__name__,
                                   "error": {"type": type(e).__name__,
                                             "reason": str(e)}}
                        data = json.dumps(out).encode()
                        self.request.sendall(_FRAME.pack(len(data)) + data)
                except (ConnectionError, OSError):
                    pass

        self._server = socketserver.ThreadingTCPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.bound_port = self._server.server_address[1]
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self.bound_port

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()

    @staticmethod
    def send_remote(host: str, port: int, action: str, payload: dict,
                    source_node: str = "client", timeout: float = 30.0) -> dict:
        msg = json.dumps({"action": action, "payload": payload,
                          "source_node": source_node}).encode()
        with socket.create_connection((host, port), timeout=timeout) as sock:
            sock.sendall(_FRAME.pack(len(msg)) + msg)
            header = _recv_exact(sock, _FRAME.size)
            (length,) = _FRAME.unpack(header)
            body = _recv_exact(sock, length)
        out = json.loads(body)
        kernel_error = _KERNEL_ERRORS.get(out.get("kernel_error"))
        if kernel_error is not None:
            raise kernel_error(out["error"]["reason"])
        if not out.get("ok"):
            err = ElasticsearchTpuError(out.get("error", {}).get("reason", "remote error"))
            err.status = out.get("status", 500)
            raise err
        return out["response"]


def _recv_exact(sock, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf
