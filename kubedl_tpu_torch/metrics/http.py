"""The ``/metrics`` HTTP endpoint (reference ``pkg/metrics/monitor.go:28``:
the Prometheus scrape server started from ``main.go:121``).

Copied from ``kubedl_tpu/metrics/http.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .registry import Registry


def write_exposition(handler: BaseHTTPRequestHandler,
                     registry: Registry) -> None:
    """Write the Prometheus text exposition onto an open handler — the
    ONE copy of the scrape response contract (operator scrape server and
    the serving predictor's /metrics both call this)."""
    body = registry.expose().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; version=0.0.4")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def serve_metrics(registry: Registry, port: int = 8080,
                  host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Start the scrape endpoint on a daemon thread; returns the server
    (caller may ``.shutdown()`` it)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path != "/metrics":
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            write_exposition(self, registry)

    httpd = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, name="kubedl-metrics",
                     daemon=True).start()
    return httpd
