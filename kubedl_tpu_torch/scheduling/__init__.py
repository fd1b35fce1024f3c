"""Scheduling & placement: gang schedulers (PodGroup per TPU slice) and
the multi-tenant slice scheduler (queues / elastic quota / preemption /
backfill — docs/scheduling.md).

Copied from ``kubedl_tpu/scheduling/__init__.py`` (the port imports nothing of the JAX package).
"""

from .gang import (  # noqa: F401
    GangScheduler, CoschedulerPlugin, VolcanoPlugin, KubeBatchPlugin,
    gang_registry, is_gang_admitted, is_gang_preempted, new_gang_scheduler,
)
