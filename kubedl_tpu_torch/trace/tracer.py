"""In-process span recorder (copied from ``kubedl_tpu/trace/tracer.py``;
the port imports nothing from the JAX package).

Spans are ``(trace_id, span_id, parent_id, name, start, end,
attributes)`` records written once both endpoints are known into a
bounded ring buffer; overflow drops the oldest span and counts the drop.
The disabled tracer (the default) returns after one attribute check.
The serving engine records its prefill/decode spans here, the trainer its
``train.step`` spans; ``spans()`` reads them back.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

#: pod env var the operator injects so in-container payloads (the trainer)
#: attach their spans to the owning job's trace
ENV_TRACEPARENT = "KUBEDL_TRACEPARENT"

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def parse_traceparent(value: str) -> Optional[tuple]:
    """``(trace_id, span_id)`` of a ``00-<trace>-<span>-<flags>`` value,
    or None for anything malformed (a bad context degrades to a fresh
    trace, never an error)."""
    mt = _TRACEPARENT_RE.match((value or "").strip().lower())
    return (mt.group(1), mt.group(2)) if mt else None


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


class Tracer:
    """Bounded in-process span store.

    ``enabled=False`` (the default) is the production-off state: every
    public method returns immediately after one attribute check, and the
    buffers stay empty. ``clock`` is injectable (tests pass a fake)."""

    def __init__(self, enabled: bool = False, capacity: int = 8192,
                 clock=time.time):
        self.enabled = enabled
        self.capacity = int(capacity)
        self.clock = clock
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=self.capacity)
        self.dropped = 0

    # -- recording --------------------------------------------------------

    def new_trace_id(self) -> str:
        return os.urandom(16).hex()

    def new_span_id(self) -> str:
        return os.urandom(8).hex()

    def record(self, name: str, start: float, end: float,
               trace_id: Optional[str] = None,
               span_id: Optional[str] = None,
               parent_id: Optional[str] = None, component: str = "",
               status: str = "ok",
               attributes: Optional[dict] = None) -> Optional[Span]:
        """Write one completed span with explicit timestamps."""
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
            self._spans.append(span)
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


#: the shared disabled tracer components default to when none is wired
NOOP_TRACER = Tracer(enabled=False)
