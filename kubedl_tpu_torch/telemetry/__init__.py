"""Telemetry the port's replays run: the SLO engine (``slo``), a copy of
the JAX package's framework-free module."""
