"""`python -m elasticsearch_tpu_torch` — start a single node with the HTTP frontend.

The node serves on the card (``cuda``); ``--device cpu`` asks for the CPU,
where every kernel wrapper runs its plain torch version. Nothing picks the
CPU on its own. ``--port 0`` binds a free port, which the ``started`` line
prints.

The analog of the reference's bin/elasticsearch -> Elasticsearch.main ->
Bootstrap.init -> Node.start (ref: bootstrap/Elasticsearch.java:64,
bootstrap/Bootstrap.java:327).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="elasticsearch-tpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9200)
    ap.add_argument("--data", default=None, help="data path (translog/commits); in-memory if unset")
    ap.add_argument("--name", default="node-0")
    ap.add_argument("--cluster-name", default="elasticsearch-tpu")
    ap.add_argument("--device", default="cuda",
                    help="torch device the indices serve on (cuda or cpu)")
    args = ap.parse_args(argv)

    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.rest import HttpServer, RestController, register_handlers

    node = Node(Settings({"cluster.name": args.cluster_name}),
                data_path=args.data, node_name=args.name, device=args.device)
    rc = RestController()
    register_handlers(node, rc)
    from elasticsearch_tpu_torch.plugins import load_plugins

    loaded = load_plugins(node, rc)
    if loaded:
        print(f"[{args.name}] plugins loaded: {', '.join(loaded)}", flush=True)
    server = HttpServer(rc, host=args.host, port=args.port,
                        thread_pool=node.thread_pool)
    server.start()
    print(f"[{args.name}] started, http on {args.host}:{server.port}", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
