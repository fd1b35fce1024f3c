"""Span exporters: Chrome trace-event JSON and OTLP-JSON.

Both are *renderings* of the same :class:`~.tracer.Span` list:

* :func:`to_chrome_trace` — the ``chrome://tracing`` / Perfetto
  trace-event format (``"X"`` complete events, microsecond timestamps),
  for eyeballing a job's critical path in a timeline UI;
* :func:`to_otlp_json` — the OpenTelemetry OTLP/JSON resource-spans
  shape (nanosecond unix timestamps, typed attribute values), so a
  collector-side pipeline can ingest operator traces without a
  dependency on any OTel SDK in-process.

Copied from ``kubedl_tpu/trace/export.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
from typing import Iterable

from .tracer import Span

_US = 1_000_000
_NS = 1_000_000_000


def _pid(trace_id: str) -> int:
    """Stable numeric process id per trace (the trace-event viewer groups
    rows by pid; hex trace ids don't fit its integer field)."""
    try:
        return int(trace_id[:8], 16)
    except (ValueError, TypeError):
        return 0


def to_chrome_trace(spans: Iterable[Span]) -> dict:
    """Trace-event JSON: one ``X`` (complete) event per span, grouped by
    trace (pid) and component (tid via metadata naming)."""
    events = []
    tids: dict[tuple, int] = {}
    for s in spans:
        key = (s.trace_id, s.component or "other")
        if key not in tids:
            tids[key] = len(tids) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": _pid(s.trace_id),
                "tid": tids[key],
                "args": {"name": s.component or "other"},
            })
        events.append({
            "name": s.name,
            "cat": s.component or "other",
            "ph": "X",
            "ts": round(s.start * _US, 3),
            "dur": round(s.duration * _US, 3),
            "pid": _pid(s.trace_id),
            "tid": tids[key],
            "args": {**s.attributes, "traceId": s.trace_id,
                     "spanId": s.span_id,
                     **({"parentId": s.parent_id} if s.parent_id else {}),
                     "status": s.status},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def chrome_trace_json(spans: Iterable[Span]) -> str:
    """The serialized form (the console's ``format=chrome`` download);
    guaranteed to round-trip through ``json.loads``."""
    return json.dumps(to_chrome_trace(spans), sort_keys=True)


def _otlp_value(v) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    if isinstance(v, (list, tuple)):
        return {"arrayValue": {"values": [_otlp_value(x) for x in v]}}
    return {"stringValue": str(v)}


def to_otlp_json(spans: Iterable[Span],
                 service_name: str = "kubedl-tpu") -> dict:
    """OTLP/JSON ``ExportTraceServiceRequest`` shape (one resource, one
    scope — this process is one service)."""
    out = []
    for s in spans:
        out.append({
            "traceId": s.trace_id,
            "spanId": s.span_id,
            **({"parentSpanId": s.parent_id} if s.parent_id else {}),
            "name": s.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(int(s.start * _NS)),
            "endTimeUnixNano": str(int(s.end * _NS)),
            "attributes": [
                {"key": k, "value": _otlp_value(v)}
                for k, v in sorted(s.attributes.items())
            ] + [{"key": "component",
                  "value": {"stringValue": s.component or "other"}}],
            "status": {"code": 2 if s.status == "error" else 1},
        })
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": service_name}}]},
        "scopeSpans": [{
            "scope": {"name": "kubedl_tpu_torch.trace"},
            "spans": out,
        }],
    }]}
