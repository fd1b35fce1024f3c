"""Kubernetes substrate: object model, in-memory API server, client, manager.

Copied from ``kubedl_tpu/core/__init__.py`` (the port imports nothing of the JAX package).
"""

from .clock import SimClock  # noqa: F401  (the shared injectable clock)
