"""Prometheus metrics for the port's serving runtime."""
