"""End-to-end tracing: span recorder, lifecycle phases, exporters,
critical-path analysis (docs/tracing.md). Feature-gated off by default
(``--enable-tracing`` / the ``Tracing`` gate).

Copied from ``kubedl_tpu/trace/__init__.py`` (the port imports nothing of the JAX package).
"""

from .analysis import (assert_well_formed, find_orphans, restart_mttrs,
                       trace_breakdown)
from .export import chrome_trace_json, to_chrome_trace, to_otlp_json
from .lifecycle import PHASES, JobLifecycleTracer, derive_phase
from .tracer import (ANNOTATION_TRACEPARENT, ENV_TRACEPARENT, NOOP_TRACER,
                     Span, Tracer, derive_context, format_traceparent,
                     job_trace_context, parse_traceparent)

__all__ = [
    "ANNOTATION_TRACEPARENT", "ENV_TRACEPARENT", "NOOP_TRACER", "PHASES",
    "JobLifecycleTracer", "Span", "Tracer", "assert_well_formed",
    "chrome_trace_json", "derive_context", "derive_phase", "find_orphans",
    "format_traceparent", "job_trace_context", "parse_traceparent",
    "restart_mttrs", "to_chrome_trace", "to_otlp_json", "trace_breakdown",
]
