"""HTTP frontend: stdlib threaded server hosting the RestController.

The analog of the reference's Netty4HttpServerTransport
(ref: http/AbstractHttpServerTransport.java:59, modules/transport-netty4) —
the HTTP layer is deliberately thin: parse method/path/query/body, dispatch,
encode. Heavy lifting (search execution) releases the GIL inside torch and
the CUDA kernels, so a threaded server keeps the device busy under
concurrent clients.

One difference from the reference's copy: the listening socket's backlog.
socketserver's default of 5 pending connections made a few dozen clients
connecting at once see some of their connections reset; the port listens
with LISTEN_BACKLOG.

When a `ThreadPool` is attached, requests do NOT execute on the accept
threads: each request is classified to a named stage pool (search / write /
get / management / snapshot) and submitted there, so concurrency per stage
is bounded and a saturated pool sheds load with 429
`es_rejected_execution_exception` instead of queueing unboundedly
(ref: the reference's per-action executor dispatch out of the Netty event
loop).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlsplit

from elasticsearch_tpu_torch.rest.controller import (
    RestController, RestResponse, _backoff_headers, _error_body,
)

LISTEN_BACKLOG = 1024


class _Server(ThreadingHTTPServer):
    request_queue_size = LISTEN_BACKLOG


class HttpServer:
    def __init__(self, controller: RestController, host: str = "127.0.0.1",
                 port: int = 9200, thread_pool=None):
        self.controller = controller
        self.thread_pool = thread_pool
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _dispatch(self):
                parts = urlsplit(self.path)
                params = dict(parse_qsl(parts.query, keep_blank_values=True))
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else None
                if outer.thread_pool is None:
                    resp = outer.controller.dispatch(
                        self.command, parts.path, params, body,
                        headers=dict(self.headers))
                else:
                    from elasticsearch_tpu_torch.threadpool import (
                        EsRejectedExecutionError, pool_for_request,
                    )

                    pool = pool_for_request(self.command, parts.path)
                    try:
                        resp = outer.thread_pool.execute(
                            pool, outer.controller.dispatch,
                            self.command, parts.path, params, body,
                            headers=dict(self.headers))
                    except EsRejectedExecutionError as e:
                        resp = RestResponse(status=e.status,
                                            body=_error_body(e),
                                            headers=_backoff_headers(e))
                data = resp.encode()
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-elastic-product", "Elasticsearch")
                for name, value in resp.headers.items():
                    self.send_header(name, value)
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(data)

            do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _dispatch

        self._server = _Server((host, port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]

    def start(self) -> None:
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
