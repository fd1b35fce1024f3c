"""Queue API object: per-tenant elastic quota over TPU slice capacity.

No direct reference analog — KubeDL delegates queueing to Volcano's Queue
CRD (``spec.queue`` passthrough in ``pkg/gang_schedule/volcano_scheduler``);
this is the native implementation of that seam, shaped after Volcano/Kueue
elastic quota: a queue guarantees ``min`` slices (reclaimable via
preemption when borrowed away) and may *borrow* idle capacity up to
``max``. Quota is denominated in **slices**, the unit of gang atomicity
(one PodGroup = one slice, ``scheduling/gang.py``), not in chips — a queue
holding "2 slices" holds two whole ICI domains regardless of their shape.

Example::

    apiVersion: scheduling.kubedl.io/v1alpha1
    kind: Queue
    metadata: {name: team-ads}
    spec:
      quota: {min: 2, max: 6}     # slices; max omitted = borrow freely
      priority: 100               # preemption precedence (higher wins)
      tenants: [ads]              # kubedl.io/tenancy tenants routed here

Copied from ``kubedl_tpu/api/queue.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

QUEUE_KIND = "Queue"
QUEUE_API_VERSION = "scheduling.kubedl.io/v1alpha1"

#: jobs that name no queue (no ``schedulingPolicy.queue``, no tenancy
#: annotation) land here; it exists implicitly with min=0 / max=unbounded
DEFAULT_QUEUE = "default"


@dataclass(frozen=True)
class QueueSpec:
    name: str = DEFAULT_QUEUE
    #: guaranteed slices: below this the queue may reclaim borrowed
    #: capacity by preempting lower-priority borrowers
    min: int = 0
    #: borrow ceiling in slices; None = bounded only by idle capacity
    max: Optional[int] = None
    #: preemption precedence: higher-priority queues pick victims first
    #: and are themselves picked last
    priority: int = 0
    #: kubedl.io/tenancy tenants attributed to this queue
    tenants: tuple = field(default_factory=tuple)

    @classmethod
    def from_obj(cls, obj: dict) -> "QueueSpec":
        spec = obj.get("spec", {}) or {}
        quota = spec.get("quota", {}) or {}
        mx = quota.get("max")
        return cls(
            name=(obj.get("metadata") or {}).get("name", DEFAULT_QUEUE),
            min=int(quota.get("min", 0) or 0),
            max=int(mx) if mx is not None else None,
            priority=int(spec.get("priority", 0) or 0),
            tenants=tuple(spec.get("tenants", []) or []),
        )

    def to_obj(self, name: Optional[str] = None) -> dict:
        quota: dict = {"min": self.min}
        if self.max is not None:
            quota["max"] = self.max
        spec: dict = {"quota": quota}
        if self.priority:
            spec["priority"] = self.priority
        if self.tenants:
            spec["tenants"] = list(self.tenants)
        return {
            "apiVersion": QUEUE_API_VERSION,
            "kind": QUEUE_KIND,
            "metadata": {"name": name or self.name},
            "spec": spec,
        }


#: the implicit queue's spec: no guarantee, no ceiling, neutral priority
IMPLICIT_DEFAULT = QueueSpec(name=DEFAULT_QUEUE)


def new_queue(name: str, *, min: int = 0, max: Optional[int] = None,
              priority: int = 0, tenants=()) -> dict:
    """Convenience constructor used by tests/benches and the console."""
    return QueueSpec(name=name, min=min, max=max, priority=priority,
                     tenants=tuple(tenants)).to_obj()
