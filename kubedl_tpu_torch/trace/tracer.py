"""In-process span recorder: the operator's end-to-end tracing core.

The aggregate metric families (docs/metrics.md) answer "how is the fleet
doing"; this subsystem answers "where did THIS job's / THIS request's
time go". Design (docs/tracing.md):

* **spans** — ``(trace_id, span_id, parent_id, name, start, end,
  attributes)`` tuples, recorded post-hoc (a span is written once it has
  both endpoints, so the recorder never holds open handles for the hot
  paths) into a bounded ring buffer — tracing can never OOM the
  operator; overflow drops the *oldest* span and counts the drop;
* **context** — W3C-traceparent-style (``00-<32 hex>-<16 hex>-01``).
  The job's context is *deterministically derived from its UID*, so
  every component (engine, scheduler, console, in-pod trainer) computes
  the same trace without coordination; a client-supplied
  ``kubedl.io/traceparent`` annotation overrides the derivation, the
  engine stamps the annotation when absent and injects
  ``KUBEDL_TRACEPARENT`` into pods so in-container payloads join the
  same trace;
* **off by default** — the disabled tracer's every entry point is one
  attribute check away from a shared no-op (the ``perf``-marked budget
  test in ``tests/test_trace.py`` holds that path to a fixed op count).

Copied from ``kubedl_tpu/trace/tracer.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

#: job annotation carrying the W3C-style trace context (client-suppliable;
#: the engine stamps it when tracing is on and the job has none)
ANNOTATION_TRACEPARENT = "kubedl.io/traceparent"
#: pod env var the engine injects so in-container payloads (trainer,
#: restart agent) attach their spans to the owning job's trace
ENV_TRACEPARENT = "KUBEDL_TRACEPARENT"

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def format_traceparent(trace_id: str, span_id: str) -> str:
    """``00-<trace_id>-<span_id>-01`` (sampled flag always set: recording
    is the tracer's on/off switch, not per-context sampling)."""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: str) -> Optional[tuple]:
    """``(trace_id, span_id)`` or None for anything malformed (a bad
    client annotation degrades to the derived context, never an error)."""
    mt = _TRACEPARENT_RE.match((value or "").strip().lower())
    return (mt.group(1), mt.group(2)) if mt else None


def derive_context(key: str) -> tuple:
    """Deterministic ``(trace_id, root_span_id)`` for a stable key (job
    UID). Every component derives the same pair independently, so spans
    recorded by the engine, the scheduler, and an in-pod trainer land in
    one trace with one shared root — no context-passing plumbing."""
    h = hashlib.sha256(f"kubedl-trace:{key}".encode()).hexdigest()
    return h[:32], h[32:48]


def job_trace_context(job: dict) -> tuple:
    """``(trace_id, root_span_id)`` for a job object: the traceparent
    annotation when present (client-controlled), else derived from UID
    (falling back to ns/name for objects that never got one)."""
    md = job.get("metadata") or {}
    ctx = parse_traceparent((md.get("annotations") or {}).get(
        ANNOTATION_TRACEPARENT, ""))
    if ctx is not None:
        return ctx
    key = md.get("uid") or f"{md.get('namespace', '')}/{md.get('name', '')}"
    return derive_context(key)


@dataclass
class Span:
    trace_id: str
    span_id: str
    name: str
    start: float                      # unix seconds (the api clock)
    end: float
    parent_id: Optional[str] = None
    component: str = ""               # engine|scheduler|serving|train|...
    status: str = "ok"                # ok|error
    attributes: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return max(self.end - self.start, 0.0)

    def to_dict(self) -> dict:
        return {
            "traceId": self.trace_id, "spanId": self.span_id,
            "parentId": self.parent_id, "name": self.name,
            "component": self.component, "status": self.status,
            "start": self.start, "end": self.end,
            "duration": round(self.duration, 9),
            "attributes": dict(self.attributes),
        }


class _NoopSpan:
    """The shared do-nothing context manager the disabled tracer hands
    out: no allocation per call, two no-op dunders per with-block."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attributes) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _ActiveSpan:
    """An open span; records itself into the tracer on ``__exit__`` (an
    exception inside the block marks it ``error``)."""

    __slots__ = ("_tracer", "name", "trace_id", "parent_id", "component",
                 "start", "attributes")

    def __init__(self, tracer, name, trace_id, parent_id, component,
                 attributes):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.component = component
        self.attributes = dict(attributes or {})
        self.start = tracer.clock()

    def set(self, **attributes) -> None:
        self.attributes.update(attributes)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer.record(
            self.name, self.start, self._tracer.clock(),
            trace_id=self.trace_id, parent_id=self.parent_id,
            component=self.component,
            status="error" if exc_type is not None else "ok",
            attributes=self.attributes)
        return False


class Tracer:
    """Bounded in-process span store.

    ``enabled=False`` (the default) is the production-off state: every
    public method returns immediately after one attribute check, and the
    buffers stay empty. ``clock`` is injectable so control-plane spans
    ride the api server's (fake-in-tests) clock; ``metrics`` is an
    optional :class:`~kubedl_tpu_torch.metrics.registry.TraceMetrics`."""

    def __init__(self, enabled: bool = False, capacity: int = 8192,
                 clock=time.time, metrics=None):
        self.enabled = enabled
        self.capacity = int(capacity)
        self.clock = clock
        self.metrics = metrics
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=self.capacity)
        self.dropped = 0

    # -- recording --------------------------------------------------------

    def new_trace_id(self) -> str:
        return os.urandom(16).hex()

    def new_span_id(self) -> str:
        return os.urandom(8).hex()

    def span(self, name: str, trace_id: Optional[str] = None,
             parent_id: Optional[str] = None, component: str = "",
             attributes: Optional[dict] = None):
        """Context manager measuring the block on the tracer clock."""
        if not self.enabled:
            return NOOP_SPAN
        return _ActiveSpan(self, name, trace_id or self.new_trace_id(),
                           parent_id, component, attributes)

    def record(self, name: str, start: float, end: float,
               trace_id: Optional[str] = None,
               span_id: Optional[str] = None,
               parent_id: Optional[str] = None, component: str = "",
               status: str = "ok",
               attributes: Optional[dict] = None) -> Optional[Span]:
        """Write one completed span (explicit timestamps — the scheduler
        records queue waits whose start predates the call by minutes)."""
        if not self.enabled:
            return None
        span = Span(trace_id=trace_id or self.new_trace_id(),
                    span_id=span_id or self.new_span_id(),
                    parent_id=parent_id, name=name, component=component,
                    status=status, start=float(start),
                    end=max(float(end), float(start)),
                    attributes=dict(attributes or {}))
        with self._lock:
            if len(self._spans) >= self.capacity:
                self.dropped += 1
                if self.metrics is not None:
                    self.metrics.dropped.inc()
            self._spans.append(span)
            buffered = len(self._spans)
        if self.metrics is not None:
            self.metrics.spans.inc(component=component or "other")
            self.metrics.buffered.set(buffered)
        return span

    # -- reading ----------------------------------------------------------

    def spans(self, trace_id: Optional[str] = None,
              component: Optional[str] = None) -> list:
        """Snapshot, oldest first, optionally filtered."""
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        if component is not None:
            out = [s for s in out if s.component == component]
        return out

    def find_trace_ids(self, **attr_match) -> list:
        """Trace ids of spans whose attributes contain every given
        key=value pair (the console resolves ``job=ns/name`` with this
        when the job object itself is already gone)."""
        seen, out = set(), []
        for s in self.spans():
            if s.trace_id not in seen and all(
                    s.attributes.get(k) == v for k, v in attr_match.items()):
                seen.add(s.trace_id)
                out.append(s.trace_id)
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


#: the shared disabled tracer components default to when none is wired
NOOP_TRACER = Tracer(enabled=False)
