"""Management console: REST backend + static dashboard.

The analog of the reference's ``console/`` tree — a Gin HTTP server
(``console/backend``) plus a React frontend (``console/frontend``) —
re-based on the stdlib HTTP stack and a no-build single-page dashboard so
the console runs anywhere the operator does, with zero extra deps.

Copied from ``kubedl_tpu/console/__init__.py`` (the port imports nothing of the JAX package).
"""

from .proxy import DataProxy
from .server import ConsoleConfig, ConsoleServer

__all__ = ["ConsoleConfig", "ConsoleServer", "DataProxy"]
