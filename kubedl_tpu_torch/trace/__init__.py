"""Span recording for the port's serving runtime."""

from .tracer import NOOP_TRACER, Span, Tracer

__all__ = ["NOOP_TRACER", "Span", "Tracer"]
