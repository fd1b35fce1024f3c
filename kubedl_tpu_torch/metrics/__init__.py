"""Prometheus-style metrics (counters/gauges/histograms + text exposition).

Copied from ``kubedl_tpu/metrics/__init__.py`` (the port imports nothing of the JAX package).
"""

from .registry import (ControlPlaneMetrics, Counter,  # noqa: F401
                       ElasticMetrics, Gauge, Histogram, JobMetrics,
                       Registry, SLOMetrics, SchedulerMetrics,
                       TelemetryMetrics, TraceMetrics)
