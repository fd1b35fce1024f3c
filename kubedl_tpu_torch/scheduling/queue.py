"""Queue resolution: which queue a job's gangs wait in, and the PodGroup
annotations that carry the scheduling facts (pool / queue / shape /
priority) from the job controllers to the slice scheduler.

Routing order (docs/scheduling.md):

1. ``runPolicy.schedulingPolicy.queue`` — the explicit Volcano-shaped seam
   the reference already passes through (``volcano_scheduler.go:54-189``);
2. the ``kubedl.io/tenancy`` annotation's ``tenant`` (``utils/tenancy``) —
   multi-tenant clusters route by attribution without touching job specs;
3. the implicit ``default`` queue.

Copied from ``kubedl_tpu/scheduling/queue.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from ..api import common as c
from ..api.common import SchedulingPolicy
from ..api.queue import DEFAULT_QUEUE, IMPLICIT_DEFAULT, QueueSpec
from ..core import meta as m
from ..utils import tenancy


def job_queue_name(job: dict,
                   policy: Optional[SchedulingPolicy] = None) -> str:
    if policy is not None and policy.queue:
        return policy.queue
    try:
        ten = tenancy.get_tenancy(job)
    except ValueError:
        ten = None  # malformed tenancy must not wedge scheduling
    if ten is not None and ten.tenant:
        return ten.tenant
    return DEFAULT_QUEUE


def gang_annotations(job: dict, policy: Optional[SchedulingPolicy],
                     slice_spec=None, num_slices: int = 1) -> dict:
    """The stamps ``GangScheduler.create_gang`` writes on every PodGroup.

    ``slice_spec`` is the job's resolved ``tpu.topology.SliceSpec`` (None
    for CPU-only gangs, which hold no slice and carry an empty pool).
    Besides the routed primary pool, the gang carries its **eligibility
    set** — every pool that can host its shape (``schedulingPolicy.pools``
    allowlist when given, else shape-compatible generations from
    ``tpu/topology.py``) — and its throughput-profile key, so the scored
    placement pass (docs/scheduling.md) never re-derives facts from the
    job."""
    pool = ""
    eligible: list = []
    if slice_spec is not None:
        pool = f"{slice_spec.gke_accelerator}/{slice_spec.topology_str}"
        if policy is not None and policy.pools:
            eligible = [str(p) for p in policy.pools]
        else:
            from ..tpu import topology
            eligible = topology.compatible_pools(slice_spec)
    priority = 0
    if policy is not None and policy.priority is not None:
        priority = int(policy.priority)
    # profile key: the job's declared model (schedulingPolicy.profile —
    # model-keyed profiles are what train.step spans with a model
    # attribute and serving stats persist under), else the kind-level
    # default the telemetry layer folds anonymous step spans into
    profile = ((policy.profile if policy is not None else "")
               or (job.get("kind") or "job")).lower()
    want = max(int(num_slices or 1), 1)
    out = {
        c.ANNOTATION_SCHED_POOL: pool,
        c.ANNOTATION_SCHED_QUEUE: job_queue_name(job, policy),
        c.ANNOTATION_SCHED_NUM_SLICES: str(want),
        c.ANNOTATION_SCHED_PRIORITY: str(priority),
        c.ANNOTATION_SCHED_POOLS: ",".join(eligible),
        c.ANNOTATION_SCHED_PROFILE: profile,
    }
    # elastic slice range (docs/elastic.md): stamped ONLY when the job
    # declares minSlices, so fixed-width gangs keep their exact
    # pre-elastic annotation shape (the gate-off byte-identity contract)
    if policy is not None and policy.min_slices is not None:
        mn = max(min(int(policy.min_slices), want), 1)
        mx = want if policy.max_slices is None \
            else max(min(int(policy.max_slices), want), mn)
        out[c.ANNOTATION_SCHED_MIN_SLICES] = str(mn)
        out[c.ANNOTATION_SCHED_MAX_SLICES] = str(mx)
    return out


def load_queue_specs(api) -> dict:
    """Name → QueueSpec for every Queue object, plus the implicit default.
    (The scheduler keeps its own incremental cache; this is the scan path
    used by rescans and the console.)"""
    out = {DEFAULT_QUEUE: IMPLICIT_DEFAULT}
    for obj in api.list("Queue"):
        spec = QueueSpec.from_obj(obj)
        out[spec.name] = spec
    return out
