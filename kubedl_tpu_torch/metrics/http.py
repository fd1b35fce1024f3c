"""The scrape response for ``/metrics`` (copied from
``kubedl_tpu/metrics/http.py``)."""

from __future__ import annotations

from http.server import BaseHTTPRequestHandler

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
