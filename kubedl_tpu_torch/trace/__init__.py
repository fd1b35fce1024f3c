"""Span recording for the port's serving and training runtime."""

from .tracer import (ENV_TRACEPARENT, NOOP_TRACER, Span, Tracer,
                     parse_traceparent)

__all__ = ["ENV_TRACEPARENT", "NOOP_TRACER", "Span", "Tracer",
           "parse_traceparent"]
