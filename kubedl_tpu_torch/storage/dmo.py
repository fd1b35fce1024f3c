"""DMO (data-mapped object) row types and object→row converters.

The Python rendering of the reference's ``pkg/storage/dmo/types.go`` (Job /
Pod / Event rows, ``:29-140``) and ``pkg/storage/dmo/converters`` — flat,
database-friendly records aggregated from the live API objects, so the
console can keep listing jobs after etcd/apiserver GC'd them.

Rows serialize to plain dicts (``to_row``/``from_row``) that the SQL
backend stores column-per-field and the HTTP layer returns as JSON.

Copied from ``kubedl_tpu/storage/dmo.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional

from ..api import common as c
from ..core import meta as m
from ..utils.quota import parse_quantity, pod_request
from ..utils.tenancy import get_tenancy

#: record not deleted / deleted markers (reference dmo.Job.Deleted tinyint)
NOT_DELETED = 0
DELETED = 1


def _latest_condition(status: dict) -> str:
    """Job display status = the type of the newest True condition, the same
    aggregation the reference converters use (``dmo/converters/job.go``)."""
    conds = (status or {}).get("conditions") or []
    for cond in reversed(conds):
        if cond.get("status", "True") == "True":
            return cond.get("type", c.JOB_CREATED)
    return c.JOB_CREATED


@dataclass
class JobRecord:
    """Reference ``dmo.Job`` (``types.go:66-110``)."""
    name: str = ""
    namespace: str = ""
    job_id: str = ""            # metadata.uid
    version: str = ""           # resourceVersion
    kind: str = ""
    status: str = c.JOB_CREATED
    #: {"Worker": {"replicas": 2, "resources": {...}}} JSON (types.go:78-88)
    resources: str = ""
    deploy_region: str = ""
    tenant: str = ""
    owner: str = ""
    deleted: int = NOT_DELETED
    is_in_etcd: int = 1
    remark: str = ""
    gmt_created: str = ""
    gmt_modified: str = ""
    gmt_job_running: str = ""
    gmt_job_finished: str = ""

    def to_row(self) -> dict:
        return asdict(self)

    @classmethod
    def from_row(cls, row: dict) -> "JobRecord":
        return cls(**{k: row[k] for k in cls.__dataclass_fields__ if k in row})


@dataclass
class PodRecord:
    """Reference ``dmo.Pod`` (``types.go:29-64``)."""
    name: str = ""
    namespace: str = ""
    pod_id: str = ""            # metadata.uid
    version: str = ""
    status: str = c.POD_PENDING
    image: str = ""
    job_id: str = ""            # owning job's uid
    replica_type: str = ""
    resources: str = ""         # JSON ResourceRequirements summary
    restarts: int = 0           # max container restartCount (in-place
                                # elastic restarts move this, engine.py)
    host_ip: str = ""
    pod_ip: str = ""
    deploy_region: str = ""
    deleted: int = NOT_DELETED
    is_in_etcd: int = 1
    remark: str = ""
    gmt_created: str = ""
    gmt_modified: str = ""
    gmt_started: str = ""
    gmt_finished: str = ""

    def to_row(self) -> dict:
        return asdict(self)

    @classmethod
    def from_row(cls, row: dict) -> "PodRecord":
        return cls(**{k: row[k] for k in cls.__dataclass_fields__ if k in row})


@dataclass
class EventRecord:
    """Reference ``dmo.Event`` (``types.go:112+``)."""
    name: str = ""
    kind: str = ""              # involved object kind
    type: str = ""
    obj_namespace: str = ""
    obj_name: str = ""
    obj_uid: str = ""
    reason: str = ""
    message: str = ""
    count: int = 1
    region: str = ""
    first_timestamp: str = ""
    last_timestamp: str = ""

    def to_row(self) -> dict:
        return asdict(self)

    @classmethod
    def from_row(cls, row: dict) -> "EventRecord":
        return cls(**{k: row[k] for k in cls.__dataclass_fields__ if k in row})


@dataclass
class NotebookRecord:
    """Reference ``dmo.Notebook``."""
    name: str = ""
    namespace: str = ""
    notebook_id: str = ""
    version: str = ""
    status: str = ""
    url: str = ""
    deleted: int = NOT_DELETED
    is_in_etcd: int = 1
    gmt_created: str = ""
    gmt_modified: str = ""

    def to_row(self) -> dict:
        return asdict(self)

    @classmethod
    def from_row(cls, row: dict) -> "NotebookRecord":
        return cls(**{k: row[k] for k in cls.__dataclass_fields__ if k in row})


@dataclass
class WorkspaceRecord:
    """Reference ``model.WorkspaceInfo``
    (``console/backend/pkg/model/workspace.go:7-39``): a named bundle of
    compute quota + a PVC-backed storage area that jobs/notebooks mount."""
    name: str = ""
    namespace: str = ""
    username: str = ""
    type: str = ""              # storage class of workspace ("pvc", "hostpath")
    pvc_name: str = ""
    local_path: str = ""
    description: str = ""
    cpu: int = 0
    memory: int = 0
    tpu: int = 0                # reference counts GPUs; TPU chips here
    storage: int = 0            # GiB
    status: str = "Created"     # Created | Ready (pvc bound)
    deleted: int = NOT_DELETED
    create_time: str = ""
    update_time: str = ""

    def to_row(self) -> dict:
        return asdict(self)

    @classmethod
    def from_row(cls, row: dict) -> "WorkspaceRecord":
        return cls(**{k: row[k] for k in cls.__dataclass_fields__ if k in row})


# ---------------------------------------------------------------------------
# Converters (reference pkg/storage/dmo/converters/{job,pod,event}.go)
# ---------------------------------------------------------------------------


def _replica_specs(job: dict) -> dict:
    """Find the per-kind replica-specs field (``tfReplicaSpecs``,
    ``pytorchReplicaSpecs``, plain ``replicaSpecs``, ...)."""
    spec = job.get("spec", {}) or {}
    for key, val in spec.items():
        if key.lower().endswith("replicaspecs") and isinstance(val, dict):
            return val
    return {}


def job_to_record(job: dict, region: str = "") -> JobRecord:
    md = m.meta(job)
    status = job.get("status", {}) or {}
    specs = _replica_specs(job)
    resources = {}
    for rtype, spec in specs.items():
        pod_spec = m.get_in(spec, "template", "spec", default={}) or {}
        resources[rtype] = {
            "replicas": spec.get("replicas", 1),
            "resources": pod_request(pod_spec),
        }
    try:
        tenancy = get_tenancy(job)
    except (ValueError, TypeError):
        tenancy = None
    return JobRecord(
        name=m.name(job),
        namespace=m.namespace(job),
        job_id=m.uid(job),
        version=str(m.resource_version(job)),
        kind=m.kind(job),
        status=_latest_condition(status),
        resources=json.dumps(resources, sort_keys=True),
        deploy_region=region,
        tenant=tenancy.tenant if tenancy else "",
        owner=tenancy.user if tenancy else "",
        deleted=DELETED if m.is_deleting(job) else NOT_DELETED,
        is_in_etcd=1,
        gmt_created=md.get("creationTimestamp", ""),
        gmt_modified=md.get("creationTimestamp", ""),
        gmt_job_running=status.get("startTime", "") or "",
        gmt_job_finished=status.get("completionTime", "") or "",
    )


def pod_to_record(pod: dict, region: str = "",
                  default_container: str = "") -> PodRecord:
    md = m.meta(pod)
    status = pod.get("status", {}) or {}
    containers = m.get_in(pod, "spec", "containers", default=[]) or []
    image = ""
    for ct in containers:
        if not default_container or ct.get("name") == default_container:
            image = ct.get("image", "")
            break
    ref = m.get_controller_ref(pod) or {}
    started = finished = ""
    restarts = 0
    for cs in status.get("containerStatuses", []) or []:
        restarts = max(restarts, int(cs.get("restartCount", 0) or 0))
        st = cs.get("state", {}) or {}
        if "running" in st:
            started = started or st["running"].get("startedAt", "")
        if "terminated" in st:
            started = started or st["terminated"].get("startedAt", "")
            finished = st["terminated"].get("finishedAt", "") or finished
    return PodRecord(
        name=m.name(pod),
        namespace=m.namespace(pod),
        pod_id=m.uid(pod),
        version=str(m.resource_version(pod)),
        status=status.get("phase", c.POD_PENDING),
        image=image,
        job_id=ref.get("uid", ""),
        replica_type=m.get_labels(pod).get(c.LABEL_REPLICA_TYPE, ""),
        resources=json.dumps(pod_request(pod.get("spec", {}) or {}),
                             sort_keys=True),
        restarts=restarts,
        host_ip=status.get("hostIP", "") or "",
        pod_ip=status.get("podIP", "") or "",
        deploy_region=region,
        deleted=DELETED if m.is_deleting(pod) else NOT_DELETED,
        is_in_etcd=1,
        gmt_created=md.get("creationTimestamp", ""),
        gmt_modified=md.get("creationTimestamp", ""),
        gmt_started=started,
        gmt_finished=finished,
    )


def event_to_record(event: dict, region: str = "") -> EventRecord:
    involved = event.get("involvedObject", {}) or {}
    return EventRecord(
        name=m.name(event),
        kind=involved.get("kind", ""),
        type=event.get("type", ""),
        obj_namespace=involved.get("namespace", ""),
        obj_name=involved.get("name", ""),
        obj_uid=involved.get("uid", ""),
        reason=event.get("reason", ""),
        message=event.get("message", ""),
        count=int(event.get("count", 1)),
        region=region,
        first_timestamp=event.get("firstTimestamp", "") or "",
        last_timestamp=event.get("lastTimestamp", "") or "",
    )


def notebook_to_record(nb: dict, region: str = "") -> NotebookRecord:
    md = m.meta(nb)
    status = nb.get("status", {}) or {}
    return NotebookRecord(
        name=m.name(nb),
        namespace=m.namespace(nb),
        notebook_id=m.uid(nb),
        version=str(m.resource_version(nb)),
        status=status.get("condition", ""),
        url=status.get("url", ""),
        deleted=DELETED if m.is_deleting(nb) else NOT_DELETED,
        is_in_etcd=1,
        gmt_created=md.get("creationTimestamp", ""),
        gmt_modified=md.get("creationTimestamp", ""),
    )
