"""Gang scheduling: slice-atomic PodGroups.

Port of the reference's plugin seam (``pkg/gang_schedule/interface.go:33-57``
with the three implementations under ``pkg/gang_schedule/{coscheduler,
volcano_scheduler,batch_scheduler}``), re-pointed at TPU semantics: the unit
of gang atomicity is a **TPU slice** (SURVEY.md §2-P). A single-slice job
gets one PodGroup with ``minMember = hosts-per-slice``; a multislice job
gets one PodGroup *per slice* (ICI requires whole slices; losing part of a
slice is losing the slice), each pinned by topology nodeSelectors rendered
at pod level. Non-TPU replica types (AIMaster, PS, launchers) join the
job-level gang of slice 0 so the whole job starts atomically.

Copied from ``kubedl_tpu/scheduling/gang.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from ..api import common as c
from ..api.common import SchedulingPolicy
from ..core import meta as m
from ..core.apiserver import APIServer, AlreadyExists, NotFound


def gang_name(job_name: str, slice_id: int = 0, num_slices: int = 1) -> str:
    return job_name if num_slices <= 1 else f"{job_name}-slice-{slice_id}"


# -- PodGroup condition vocabulary (the slice scheduler's write surface) ----

def pg_has_condition(pg: dict, cond_type: str) -> bool:
    for cond in m.get_in(pg, "status", "conditions", default=[]) or []:
        if cond.get("type") == cond_type and cond.get("status", "True") == "True":
            return True
    return False


def is_gang_admitted(pg: dict) -> bool:
    """True when the slice scheduler has granted this gang its slice; the
    job controllers gate pod creation on it (engine ``gate_on_gang_admission``)."""
    return pg_has_condition(pg, c.PG_COND_ADMITTED)


def is_gang_preempted(pg: dict) -> bool:
    """True while a scheduler-initiated eviction of this gang is in flight
    (pods marked DisruptionTarget, slice-atomic teardown pending)."""
    return pg_has_condition(pg, c.PG_COND_PREEMPTED)


def set_gang_condition(pg: dict, cond_type: str, reason: str = "",
                       message: str = "", now: float = None) -> None:
    """Idempotently set one True condition on a (mutable) PodGroup copy."""
    conds = pg.setdefault("status", {}).setdefault("conditions", [])
    for cond in conds:
        if cond.get("type") == cond_type:
            cond["status"] = "True"
            cond["reason"] = reason or cond.get("reason", "")
            return
    conds.append({"type": cond_type, "status": "True", "reason": reason,
                  "message": message,
                  "lastTransitionTime": m.rfc3339(now)})


class GangScheduler:
    """Interface (reference ``interface.go:33-57``)."""

    name = ""                 # plugin registry name (--gang-scheduler-name)
    scheduler_name = ""       # pod.spec.schedulerName to set
    pod_group_kind = ""
    pod_group_api_version = ""
    pod_group_label = ""      # label pods carry to join the gang

    def __init__(self, api: APIServer):
        self.api = api

    # -- lifecycle --------------------------------------------------------

    def create_gang(self, job: dict, min_members: list[int],
                    policy: Optional[SchedulingPolicy] = None,
                    annotations: Optional[dict] = None) -> list[dict]:
        """Ensure one PodGroup per slice exists; returns them.

        ``min_members[i]`` is the pod count required for slice i's gang to
        go (hosts-per-slice, plus non-TPU roles folded into slice 0).
        ``annotations`` (the scheduler pool/queue/priority stamps) are set
        on creation and reconciled on existing groups, so a job moved to a
        new queue re-routes without recreating its gangs.
        """
        groups = []
        n = len(min_members)
        for sid, mm in enumerate(min_members):
            name = gang_name(m.name(job), sid, n)
            existing = self.api.try_get(self.pod_group_kind, m.namespace(job), name)
            if existing is not None:
                changed = False
                if self._min_member_of(existing) != mm:
                    self._set_min_member(existing, mm)
                    changed = True
                desired = dict(annotations or {})
                if desired and is_gang_admitted(existing):
                    # the slice scheduler owns the pool stamp once the
                    # gang is admitted: scored placement may have moved
                    # it off the routed primary (docs/scheduling.md),
                    # and re-stamping here would flap the inventory's
                    # pool accounting against the scheduler every
                    # reconcile
                    desired.pop(c.ANNOTATION_SCHED_POOL, None)
                if desired and any(
                        m.get_annotations(existing).get(k) != v
                        for k, v in desired.items()):
                    m.annotations(existing).update(desired)
                    changed = True
                if changed:
                    existing = self.api.update(existing)
                groups.append(existing)
                continue
            pg = m.new_obj(self.pod_group_api_version, self.pod_group_kind,
                           name, m.namespace(job),
                           labels={c.LABEL_GANG_JOB_NAME: m.name(job)},
                           annotations=annotations)
            pg["spec"] = self._pod_group_spec(mm, policy)
            m.set_controller_ref(pg, job)
            try:
                groups.append(self.api.create(pg))
            except AlreadyExists:
                groups.append(self.api.get(self.pod_group_kind, m.namespace(job), name))
        return groups

    def delete_gang(self, job: dict) -> None:
        for pg in self.api.list(self.pod_group_kind, m.namespace(job),
                                selector={c.LABEL_GANG_JOB_NAME: m.name(job)}):
            try:
                self.api.delete(self.pod_group_kind, m.namespace(pg), m.name(pg))
            except NotFound:
                pass

    def get_gangs(self, job: dict) -> list[dict]:
        return self.api.list(self.pod_group_kind, m.namespace(job),
                             selector={c.LABEL_GANG_JOB_NAME: m.name(job)})

    def readmit_slice(self, job: dict, slice_id: int = 0,
                      num_slices: int = 1) -> None:
        """Delete one slice's PodGroup so the next reconcile's
        ``create_gang`` recreates it from scratch — the disrupted slice
        re-enters gang admission as a unit instead of its surviving pods
        keeping a half-dead gang alive (slice-atomic failover: the PJRT
        world is fixed at startup, so a patched-in replacement pod can
        never rejoin the old world anyway)."""
        name = gang_name(m.name(job), slice_id, num_slices)
        try:
            self.api.delete(self.pod_group_kind, m.namespace(job), name)
        except NotFound:
            pass

    def bind_pod_to_gang(self, job: dict, pod_template: dict,
                         slice_id: int = 0, num_slices: int = 1) -> None:
        """Label/annotate the pod into its slice's gang and pin the
        scheduler (reference coscheduler ``scheduler.go:52-55,140-144``)."""
        name = gang_name(m.name(job), slice_id, num_slices)
        labels = m.get_in(pod_template, "metadata", "labels")
        if labels is None:
            m.set_in(pod_template, "metadata", "labels", {})
            labels = pod_template["metadata"]["labels"]
        labels[self.pod_group_label] = name
        pod_template.setdefault("spec", {})["schedulerName"] = self.scheduler_name

    # -- plugin internals -------------------------------------------------

    def _pod_group_spec(self, min_member: int, policy: Optional[SchedulingPolicy]) -> dict:
        raise NotImplementedError

    def _min_member_of(self, pg: dict) -> int:
        return int(m.get_in(pg, "spec", "minMember", default=0))

    def _set_min_member(self, pg: dict, mm: int) -> None:
        m.set_in(pg, "spec", "minMember", mm)


class CoschedulerPlugin(GangScheduler):
    """scheduler-plugins coscheduling (reference ``coscheduler/scheduler.go``)."""

    name = "coscheduler"
    scheduler_name = "default-scheduler"
    pod_group_kind = "PodGroup"
    pod_group_api_version = "scheduling.sigs.k8s.io/v1alpha1"
    pod_group_label = "pod-group.scheduling.sigs.k8s.io/name"

    def _pod_group_spec(self, min_member, policy):
        spec = {"minMember": min_member}
        if policy and policy.priority_class_name:
            spec["priorityClassName"] = policy.priority_class_name
        return spec


class VolcanoPlugin(GangScheduler):
    """Volcano (reference ``volcano_scheduler/scheduler.go:54-189``)."""

    name = "volcano"
    scheduler_name = "volcano"
    pod_group_kind = "PodGroup"
    pod_group_api_version = "scheduling.volcano.sh/v1beta1"
    pod_group_label = "scheduling.k8s.io/group-name"

    def _pod_group_spec(self, min_member, policy):
        spec = {"minMember": min_member}
        if policy:
            if policy.queue:
                spec["queue"] = policy.queue
            if policy.priority_class_name:
                spec["priorityClassName"] = policy.priority_class_name
        return spec


class KubeBatchPlugin(GangScheduler):
    """kube-batch (reference ``batch_scheduler/scheduler.go:64-130``)."""

    name = "kube-batch"
    scheduler_name = "kube-batch"
    pod_group_kind = "PodGroup"
    pod_group_api_version = "scheduling.incubator.k8s.io/v1alpha1"
    pod_group_label = "scheduling.k8s.io/group-name"

    def _pod_group_spec(self, min_member, policy):
        return {"minMember": min_member}


gang_registry = {p.name: p for p in (CoschedulerPlugin, VolcanoPlugin, KubeBatchPlugin)}

#: every plugin's pod→group membership label, derived from the registry so
#: a new plugin cannot silently desync the slice scheduler's victim-pod
#: lookup or the console's gang/queue tables
GANG_POD_LABELS = tuple(dict.fromkeys(
    p.pod_group_label for p in gang_registry.values()))


def new_gang_scheduler(name: str, api: APIServer) -> GangScheduler:
    if name not in gang_registry:
        raise ValueError(f"unknown gang scheduler {name!r} (know {sorted(gang_registry)})")
    return gang_registry[name](api)
