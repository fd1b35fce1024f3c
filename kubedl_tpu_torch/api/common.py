"""Shared job vocabulary every workload kind embeds.

The Python rendering of the reference's common job API
(``pkg/job_controller/api/v1/types.go:26-314`` and ``constants.go:6-83``):
``ReplicaSpec`` / ``JobStatus`` / ``RunPolicy`` / conditions / restart
policies / labels. Wire shape (camelCase JSON) is kept identical so job
manifests written for the reference parse unchanged.

Dataclasses parse from / serialize to the dict-shaped objects stored in the
API server; ``template`` stays a raw PodTemplateSpec dict (the engine and
the TPU placement layer rewrite it structurally).

Copied from ``kubedl_tpu/api/common.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# Label / annotation constants (constants.go:6-83). The kubedl.io prefix is
# kept verbatim so annotations on existing user manifests keep working.
# ---------------------------------------------------------------------------

KUBEDL_PREFIX = "kubedl.io"

LABEL_REPLICA_INDEX = "replica-index"
LABEL_REPLICA_TYPE = "replica-type"
LABEL_REPLICA_NAME = "replica-name"
LABEL_GROUP_NAME = "group-name"
LABEL_JOB_NAME = "job-name"
LABEL_JOB_ROLE = "job-role"

ANNOTATION_GIT_SYNC_CONFIG = KUBEDL_PREFIX + "/git-sync-config"
ANNOTATION_TENANCY_INFO = KUBEDL_PREFIX + "/tenancy"
ANNOTATION_NETWORK_MODE = KUBEDL_PREFIX + "/network-mode"
ANNOTATION_ENABLE_ELASTIC = KUBEDL_PREFIX + "/enable-elastic-training"
ANNOTATION_ELASTIC_SCALE_STATE = KUBEDL_PREFIX + "/scale-state"
ANNOTATION_TENSORBOARD_CONFIG = KUBEDL_PREFIX + "/tensorboard-config"

# TPU-native additions (no reference analog: the reference assumes GPU pools)
ANNOTATION_GCS_SYNC_CONFIG = KUBEDL_PREFIX + "/gcs-sync-config"
ANNOTATION_TPU_TOPOLOGY = KUBEDL_PREFIX + "/tpu-topology"
ANNOTATION_TPU_ACCELERATOR = KUBEDL_PREFIX + "/tpu-accelerator"
ANNOTATION_TPU_NUM_SLICES = KUBEDL_PREFIX + "/tpu-num-slices"

LABEL_INFERENCE_NAME = KUBEDL_PREFIX + "/inference-name"
LABEL_PREDICTOR_NAME = KUBEDL_PREFIX + "/predictor-name"
LABEL_MODEL_VERSION = KUBEDL_PREFIX + "/model-version"
LABEL_CRON_NAME = KUBEDL_PREFIX + "/cron-name"
LABEL_GANG_JOB_NAME = KUBEDL_PREFIX + "/gang-job-name"
LABEL_GENERATION = KUBEDL_PREFIX + "/job-generation"
LABEL_SLICE_INDEX = KUBEDL_PREFIX + "/tpu-slice-index"  # TPU-native: multislice

FINALIZER_PREEMPT_PROTECTOR = KUBEDL_PREFIX + "/preempt-protector"

# slice-scheduler vocabulary (docs/scheduling.md): the engine stamps every
# PodGroup it creates with the gang's pool / queue / shape so the scheduler
# (and the console) never have to re-derive them from the owning job
ANNOTATION_SCHED_POOL = KUBEDL_PREFIX + "/scheduler-pool"
ANNOTATION_SCHED_QUEUE = KUBEDL_PREFIX + "/scheduler-queue"
ANNOTATION_SCHED_NUM_SLICES = KUBEDL_PREFIX + "/scheduler-num-slices"
ANNOTATION_SCHED_PRIORITY = KUBEDL_PREFIX + "/scheduler-priority"
#: comma-joined pool eligibility set (docs/scheduling.md "Placement
#: scoring"): every pool that can host the gang's shape — compatible
#: generations from tpu/topology.py, or the job's explicit
#: schedulingPolicy.pools allowlist. Consumed only when the
#: TPUPlacementScoring gate is on; the primary scheduler-pool annotation
#: stays authoritative otherwise.
ANNOTATION_SCHED_POOLS = KUBEDL_PREFIX + "/scheduler-pools"
#: throughput-profile key of the job (kind, lowercased — the same default
#: key the telemetry layer folds train.step spans under), letting the
#: scheduler look the gang up in the ThroughputProfileStore
ANNOTATION_SCHED_PROFILE = KUBEDL_PREFIX + "/scheduler-profile"
#: W3C-traceparent-style trace context (docs/tracing.md): client-settable
#: on jobs; the engine stamps it when tracing is on and propagates it to
#: PodGroups (for the scheduler) and into pods via $KUBEDL_TRACEPARENT
ANNOTATION_TRACEPARENT = KUBEDL_PREFIX + "/traceparent"

# concurrency-elastic gangs (docs/elastic.md "Elastic slices"): the gang
# advertises a min..max slice range instead of one fixed count. Stamped
# on PodGroups only when the job declares schedulingPolicy.minSlices, so
# the PodGroup shape of non-elastic jobs is byte-identical with the
# TPUElasticSlices gate off.
ANNOTATION_SCHED_MIN_SLICES = KUBEDL_PREFIX + "/scheduler-min-slices"
ANNOTATION_SCHED_MAX_SLICES = KUBEDL_PREFIX + "/scheduler-max-slices"
#: the engine's record of the slice ids the job is CURRENTLY running on
#: (comma-joined, e.g. "0,1,3"); a divergence between this record and
#: the admitted PodGroup set is what triggers a restart-free
#: reconfiguration through the 2-phase checkpoint protocol
ANNOTATION_ELASTIC_SLICES = KUBEDL_PREFIX + "/elastic-slices"
#: when the in-flight reconfiguration's checkpoint was requested — the
#: start of the reconfiguration window the MTTR accounting and the
#: ``elastic.reconfigure`` trace span measure
ANNOTATION_ELASTIC_RECONFIGURE_AT = \
    KUBEDL_PREFIX + "/elastic-reconfigure-at"
#: the checkpoint version gating the IN-FLIGHT reconfiguration ("0" =
#: none). Without it, "ack landed" and "no request in flight" are
#: indistinguishable once requested == completed, and the controller
#: would re-request forever instead of executing the resize.
ANNOTATION_ELASTIC_CKPT_VERSION = \
    KUBEDL_PREFIX + "/elastic-ckpt-version"

#: PodGroup conditions the slice scheduler owns: ``Admitted`` gates the job
#: controllers' pod creation; ``Preempted`` marks a gang whose eviction is
#: in flight (so a scheduling pass never double-preempts it)
PG_COND_ADMITTED = "Admitted"
PG_COND_PREEMPTED = "Preempted"

# elastic checkpoint 2-phase protocol (controllers/pytorch/elastic_scale.go:35-39)
ANNOTATION_CKPT_REQUESTED_VERSION = KUBEDL_PREFIX + "/ckpt-requested-version"
ANNOTATION_CKPT_COMPLETED_VERSION = KUBEDL_PREFIX + "/ckpt-completed-version"
ANNOTATION_READY_TO_START_WORKER = KUBEDL_PREFIX + "/ready-to-start-worker"
ANNOTATION_IMMEDIATELY_START_WORKER = KUBEDL_PREFIX + "/immediately-start-worker"
#: in-place restart request (portable CRR analog, elastic_scale.go:~330-400):
#: the in-container restart agent exits the trainer when this moves past the
#: generation its container started at
ANNOTATION_RESTART_REQUESTED_GENERATION = \
    KUBEDL_PREFIX + "/restart-requested-generation"
#: restartCount recorded when the restart was requested — the controller
#: confirms the in-place restart happened by watching this move (the CRR
#: status analog), and falls back to delete+recreate if it never does
ANNOTATION_RESTART_BASIS_RESTARTS = \
    KUBEDL_PREFIX + "/restart-basis-restartcount"
ANNOTATION_RESTART_REQUESTED_AT = KUBEDL_PREFIX + "/restart-requested-at"

ELASTIC_SCALE_INFLIGHT = "inflight"
ELASTIC_SCALE_DONE = "done"

NETWORK_MODE_HOST = "host"

# replica types shared across kinds
REPLICA_AIMASTER = "AIMaster"
REPLICA_TENSORBOARD = "TensorBoard"

# resource names
RESOURCE_TPU = "google.com/tpu"  # TPU-native analog of nvidia.com/gpu

# ---------------------------------------------------------------------------
# Conditions / policies
# ---------------------------------------------------------------------------

JOB_CREATED = "Created"
#: Queuing = the gang exists but the slice scheduler has not admitted it;
#: the job controllers hold off creating pods until admission lands
JOB_QUEUING = "Queuing"
JOB_RUNNING = "Running"
JOB_RESTARTING = "Restarting"
JOB_SUCCEEDED = "Succeeded"
JOB_FAILED = "Failed"

RESTART_ALWAYS = "Always"
RESTART_ON_FAILURE = "OnFailure"
RESTART_NEVER = "Never"
RESTART_EXIT_CODE = "ExitCode"

CLEAN_POD_UNDEFINED = ""
CLEAN_POD_ALL = "All"
CLEAN_POD_RUNNING = "Running"
CLEAN_POD_NONE = "None"

SUCCESS_POLICY_DEFAULT = ""
SUCCESS_POLICY_ALL_WORKERS = "AllWorkers"

CONCURRENCY_ALLOW = "Allow"
CONCURRENCY_FORBID = "Forbid"
CONCURRENCY_REPLACE = "Replace"

POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"
POD_UNKNOWN = "Unknown"

#: pod condition set by kube-scheduler/kubelet when a pod is about to be
#: terminated by a voluntary disruption (preemption, drain, spot reclaim);
#: the engine treats any gang member carrying it as a whole-slice loss
POD_COND_DISRUPTION_TARGET = "DisruptionTarget"


def _drop_none(d: dict) -> dict:
    return {k: v for k, v in d.items() if v is not None and v != {} and v != []}


# ---------------------------------------------------------------------------
# Dataclasses
# ---------------------------------------------------------------------------

@dataclass
class SpotReplicaSpec:
    spot_replica_number: int = 0
    priority_class_name: str = ""
    labels: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[dict]):
        if d is None:
            return None
        return cls(
            spot_replica_number=int(d.get("spotReplicaNumber", 0)),
            priority_class_name=d.get("priorityClassName", ""),
            labels=dict(d.get("labels", {}) or {}),
        )

    def to_dict(self) -> dict:
        return _drop_none({
            "spotReplicaNumber": self.spot_replica_number or None,
            "priorityClassName": self.priority_class_name or None,
            "labels": self.labels or None,
        })


@dataclass
class DAGCondition:
    upstream: str = ""
    on_phase: str = POD_RUNNING

    @classmethod
    def from_dict(cls, d: dict):
        return cls(upstream=d.get("upstream", ""), on_phase=d.get("onPhase", POD_RUNNING))

    def to_dict(self) -> dict:
        return {"upstream": self.upstream, "onPhase": self.on_phase}


@dataclass
class ReplicaSpec:
    replicas: Optional[int] = None
    template: dict = field(default_factory=dict)  # PodTemplateSpec (raw)
    restart_policy: str = ""
    spot_replica_spec: Optional[SpotReplicaSpec] = None
    depend_on: list = field(default_factory=list)  # list[DAGCondition]

    @classmethod
    def from_dict(cls, d: Optional[dict]):
        if d is None:
            return None
        return cls(
            replicas=d.get("replicas"),
            template=d.get("template", {}) or {},
            restart_policy=d.get("restartPolicy", ""),
            spot_replica_spec=SpotReplicaSpec.from_dict(d.get("spotReplicaSpec")),
            depend_on=[DAGCondition.from_dict(x) for x in d.get("dependOn", []) or []],
        )

    def to_dict(self) -> dict:
        return _drop_none({
            "replicas": self.replicas,
            "template": self.template or None,
            "restartPolicy": self.restart_policy or None,
            "spotReplicaSpec": self.spot_replica_spec.to_dict() if self.spot_replica_spec else None,
            "dependOn": [c.to_dict() for c in self.depend_on] or None,
        })


@dataclass
class SchedulingPolicy:
    min_available: Optional[int] = None
    priority: Optional[int] = None
    priority_class_name: str = ""
    queue: str = ""
    #: explicit pool-eligibility allowlist (docs/scheduling.md "Placement
    #: scoring"): restricts the scored candidate set to exactly these
    #: inventory pool keys; empty = shape-compatible pools
    pools: tuple = ()
    #: throughput-profile key override for the placement scorer: set it
    #: to the model id the job trains/serves so placement reads the
    #: MODEL's learned ThroughputProfile (train.step spans with a model
    #: attribute and all serving stats persist under model keys); empty
    #: = the job kind, lowercased
    profile: str = ""
    #: concurrency-elastic slice range (docs/elastic.md "Elastic
    #: slices"): the job tolerates running on any slice count in
    #: [minSlices, tpuPolicy.numSlices]. None (default) = fixed-width
    #: gang, byte-identical pre-elastic semantics. maxSlices defaults to
    #: the job's declared numSlices; it exists for forward-compat with
    #: opportunistic growth beyond the declared shape.
    min_slices: Optional[int] = None
    max_slices: Optional[int] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]):
        if d is None:
            return None
        return cls(
            min_available=d.get("minAvailable"),
            priority=d.get("priority"),
            priority_class_name=d.get("priorityClassName", ""),
            queue=d.get("queue", ""),
            pools=tuple(d.get("pools", []) or []),
            profile=str(d.get("profile", "") or ""),
            min_slices=d.get("minSlices"),
            max_slices=d.get("maxSlices"),
        )

    def to_dict(self) -> dict:
        return _drop_none({
            "minAvailable": self.min_available,
            "priority": self.priority,
            "priorityClassName": self.priority_class_name or None,
            "queue": self.queue or None,
            "minSlices": self.min_slices,
            "maxSlices": self.max_slices,
        })


@dataclass
class CronPolicy:
    schedule: str = ""
    concurrency_policy: str = CONCURRENCY_ALLOW
    suspend: Optional[bool] = None
    deadline: Optional[str] = None
    history_limit: Optional[int] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]):
        if d is None:
            return None
        return cls(
            schedule=d.get("schedule", ""),
            concurrency_policy=d.get("concurrencyPolicy", CONCURRENCY_ALLOW) or CONCURRENCY_ALLOW,
            suspend=d.get("suspend"),
            deadline=d.get("deadline"),
            history_limit=d.get("historyLimit"),
        )

    def to_dict(self) -> dict:
        return _drop_none({
            "schedule": self.schedule or None,
            "concurrencyPolicy": self.concurrency_policy if self.concurrency_policy != CONCURRENCY_ALLOW else None,
            "suspend": self.suspend,
            "deadline": self.deadline,
            "historyLimit": self.history_limit,
        })


@dataclass
class RunPolicy:
    clean_pod_policy: Optional[str] = None
    ttl_seconds_after_finished: Optional[int] = None
    active_deadline_seconds: Optional[int] = None
    backoff_limit: Optional[int] = None
    scheduling_policy: Optional[SchedulingPolicy] = None
    cron_policy: Optional[CronPolicy] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]):
        d = d or {}
        return cls(
            clean_pod_policy=d.get("cleanPodPolicy"),
            ttl_seconds_after_finished=d.get("ttlSecondsAfterFinished"),
            active_deadline_seconds=d.get("activeDeadlineSeconds"),
            backoff_limit=d.get("backoffLimit"),
            scheduling_policy=SchedulingPolicy.from_dict(d.get("schedulingPolicy")),
            cron_policy=CronPolicy.from_dict(d.get("cronPolicy")),
        )

    def to_dict(self) -> dict:
        return _drop_none({
            "cleanPodPolicy": self.clean_pod_policy,
            "ttlSecondsAfterFinished": self.ttl_seconds_after_finished,
            "activeDeadlineSeconds": self.active_deadline_seconds,
            "backoffLimit": self.backoff_limit,
            "schedulingPolicy": self.scheduling_policy.to_dict() if self.scheduling_policy else None,
            "cronPolicy": self.cron_policy.to_dict() if self.cron_policy else None,
        })


@dataclass
class JobCondition:
    type: str = ""
    status: str = "True"
    reason: str = ""
    message: str = ""
    last_update_time: str = ""
    last_transition_time: str = ""

    @classmethod
    def from_dict(cls, d: dict):
        return cls(
            type=d.get("type", ""),
            status=d.get("status", "True"),
            reason=d.get("reason", ""),
            message=d.get("message", ""),
            last_update_time=d.get("lastUpdateTime", ""),
            last_transition_time=d.get("lastTransitionTime", ""),
        )

    def to_dict(self) -> dict:
        return _drop_none({
            "type": self.type,
            "status": self.status,
            "reason": self.reason or None,
            "message": self.message or None,
            "lastUpdateTime": self.last_update_time or None,
            "lastTransitionTime": self.last_transition_time or None,
        })


@dataclass
class ReplicaStatus:
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    evicted: int = 0

    @classmethod
    def from_dict(cls, d: Optional[dict]):
        d = d or {}
        return cls(
            active=int(d.get("active", 0)),
            succeeded=int(d.get("succeeded", 0)),
            failed=int(d.get("failed", 0)),
            evicted=int(d.get("evicted", 0)),
        )

    def to_dict(self) -> dict:
        return _drop_none({
            "active": self.active or None,
            "succeeded": self.succeeded or None,
            "failed": self.failed or None,
            "evicted": self.evicted or None,
        }) or {}


@dataclass
class JobStatus:
    conditions: list = field(default_factory=list)  # list[JobCondition]
    replica_statuses: dict = field(default_factory=dict)  # type -> ReplicaStatus
    start_time: Optional[str] = None
    completion_time: Optional[str] = None
    last_reconcile_time: Optional[str] = None
    model_version_name: str = ""
    cache_backend_name: str = ""
    #: cumulative failure rounds counted against RunPolicy.backoffLimit.
    #: Lives in status (not operator memory) so an operator restart cannot
    #: reset a job's failure history (reference reconstructs from live pod
    #: restartCounts, job.go:555-594; delete+recreate restart policies need
    #: this durable counter as well)
    failure_rounds: int = 0
    #: slice-atomic failover bookkeeping, also durable in status so the
    #: backoff gate survives operator restarts: total restarts performed,
    #: the current backoff round (reset after a stable running window),
    #: and when the last restart fired
    restart_count: int = 0
    restart_rounds: int = 0
    last_restart_time: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]):
        d = d or {}
        return cls(
            conditions=[JobCondition.from_dict(c) for c in d.get("conditions", []) or []],
            replica_statuses={k: ReplicaStatus.from_dict(v)
                              for k, v in (d.get("replicaStatuses", {}) or {}).items()},
            start_time=d.get("startTime"),
            completion_time=d.get("completionTime"),
            last_reconcile_time=d.get("lastReconcileTime"),
            model_version_name=d.get("modelVersionName", ""),
            cache_backend_name=d.get("cacheBackendName", ""),
            failure_rounds=int(d.get("failureRounds", 0) or 0),
            restart_count=int(d.get("restartCount", 0) or 0),
            restart_rounds=int(d.get("restartRounds", 0) or 0),
            last_restart_time=d.get("lastRestartTime"),
        )

    def to_dict(self) -> dict:
        return _drop_none({
            "conditions": [c.to_dict() for c in self.conditions] or None,
            "replicaStatuses": {k: v.to_dict() for k, v in self.replica_statuses.items()},
            "startTime": self.start_time,
            "completionTime": self.completion_time,
            "lastReconcileTime": self.last_reconcile_time,
            "modelVersionName": self.model_version_name or None,
            "cacheBackendName": self.cache_backend_name or None,
            "failureRounds": self.failure_rounds or None,
            "restartCount": self.restart_count or None,
            "restartRounds": self.restart_rounds or None,
            "lastRestartTime": self.last_restart_time,
        })
