"""The generic job reconciliation engine.

Behavioral port of the reference's core engine (``pkg/job_controller/
job.go:71-370``, ``pod.go:237-448``, ``service.go:197-322``,
``status.go:19-41``) with the pod/service symmetry collapsed into one typed
child-resource diff loop and the GPU-era placement replaced by TPU slice
rendering (``kubedl_tpu_torch.tpu.placement``).

One ``JobEngine`` instance serves one workload kind (its
``WorkloadController`` plugin provides the framework seams); the engine owns:

* pod/service diff loops with stable ``{job}-{rt}-{index}`` naming,
* restart semantics (ExitCode retryability, restart-policy mapping),
* backoff limit / active deadline / TTL-after-finished / clean-pod policy,
* gang lifecycle (one PodGroup per TPU slice, all-or-nothing),
* DAG stage gating (``dag_sched.go:29-67``) and the AIMaster gate,
* job condition state machine + replica status counting,
* launch-delay metrics and lifecycle events,
* ModelVersion creation on success (``job.go:500-541``) via hook.

Copied from ``kubedl_tpu/controllers/engine.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import copy
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api import common as c
from ..api.common import JobStatus, ReplicaSpec, RunPolicy
from ..core import meta as m
from ..core.apiserver import (AlreadyExists, APIServer, Conflict, NotFound,
                              ServerError)
from ..core.events import Recorder, TYPE_NORMAL, TYPE_WARNING
from ..core.manager import Reconciler, Request, Result
from ..metrics import JobMetrics
from ..platform.cache import CacheError, reconcile_job_cache
from ..platform.codesync import inject_code_sync_init_containers
from ..platform.models import add_model_path_env, build_model_version_spec
from ..platform.tensorboard import reconcile_tensorboard
from ..scheduling import queue as qsched
from ..scheduling.gang import GangScheduler, is_gang_admitted
from ..tpu import placement as pl
from ..trace import (ENV_TRACEPARENT, NOOP_TRACER, JobLifecycleTracer,
                     derive_phase, format_traceparent, job_trace_context)
from ..utils import status as st
from ..utils import train
from ..utils.retry import RetryPolicy, restart_delay, retry_transient
from . import hostnetwork as hn
from .elastic import ANNOTATION_WORLD_SIZE
from .expectations import Expectations
from .interface import TPUPolicy, WorkloadController

log = logging.getLogger("kubedl_tpu_torch.engine")


@dataclass
class EngineConfig:
    enable_gang_scheduling: bool = True
    enable_dag_scheduling: bool = True
    #: slice-scheduler admission gate (docs/scheduling.md): when True, no
    #: pod is created until every PodGroup of the job carries the
    #: scheduler's ``Admitted`` condition — the job waits in its queue
    #: (``Queuing`` condition) instead of racing pods into the cluster
    gate_on_gang_admission: bool = False
    dns_domain: str = ""
    default_ttl_seconds: Optional[int] = None
    #: (base, size) for hostnetwork random ports (reference main.go:69
    #: --hostnetwork-port-range, default [20000, 30000))
    hostnetwork_port_range: tuple = hn.DEFAULT_PORT_RANGE
    #: HostNetWithHeadlessSvc gate: keep headless services even in
    #: hostnetwork mode (reference features.go:36-40)
    hostnet_with_headless_svc: bool = False
    #: transient-error (5xx/timeout) retry bounds for every api write the
    #: engine issues; ``retry_sleep`` is injectable so deterministic tests
    #: advance a fake clock instead of blocking
    retry_policy: RetryPolicy = field(default_factory=RetryPolicy)
    retry_sleep: Callable = time.sleep
    #: slice-atomic failover backoff: round r waits a decorrelated-jitter
    #: delay in [base, cap] (docs/failover.md has the formula); the round
    #: counter resets after ``restart_backoff_reset`` seconds of stability
    restart_backoff_base: float = 10.0
    restart_backoff_cap: float = 300.0
    restart_backoff_reset: float = 600.0
    #: seeds the retry/backoff jitter; None (default) takes OS entropy so
    #: operator replicas de-correlate — pin in tests for reproducibility
    backoff_jitter_seed: Optional[int] = None
    #: how long an unobserved create/delete expectation blocks reconciles
    #: before it is declared lost (dropped watch event) and cleared
    expectation_timeout: float = Expectations.TIMEOUT
    #: admission-gate dropped-event net: a Queuing job re-reconciles this
    #: often even if no PodGroup admission event arrives. The event path
    #: (PodGroup watch) does the real work — at fleet scale (hundreds of
    #: queued jobs) a tight poll is a thundering herd, so the cluster
    #: replay widens it; 5s keeps the historical single-job snappiness
    gate_requeue_s: float = 5.0
    #: concurrency-elastic slices (docs/elastic.md, TPUElasticSlices
    #: gate): jobs declaring ``schedulingPolicy.minSlices`` run on any
    #: admitted width in [min, numSlices]; scheduler shrink preemptions
    #: of surplus slices become restart-free world reconfigurations
    #: driven through the 2-phase checkpoint protocol instead of
    #: whole-gang failover. False (default) = byte-identical pre-elastic
    #: engine behavior.
    elastic_slices: bool = False


@dataclass
class _ReplicaPlan:
    """Resolved TPU shape for one job (or None for CPU-only jobs).

    ``offsets[rtype]`` maps a TPU replica type to its base in the *global*
    TPU process index space (reconcile order over TPU types, cumulative
    replicas) — e.g. Master(1) + Worker(3) on a 4-host slice gives Master
    process 0 and Workers processes 1..3, preserving the reference's
    Master/Worker shape while keeping one flat SPMD index space.
    """
    policy: Optional[TPUPolicy] = None
    slice_spec: object = None
    num_slices: int = 1
    offsets: dict = field(default_factory=dict)
    global_dns: list = field(default_factory=list)  # hostname per global id


@dataclass
class _ElasticPlan:
    """One reconcile's concurrency-elastic view of the gang
    (docs/elastic.md): which slice ids are admitted-and-live
    (``active``), which the scheduler marked for in-place shedding
    (``leaving``), and the slice set the job is RECORDED as running on
    (the ``kubedl.io/elastic-slices`` annotation; None before the first
    world forms). ``active != recorded`` is what triggers a
    reconfiguration. Built only when the active width is at or above the
    gang's min — below the floor, pre-elastic whole-gang semantics
    apply unchanged."""
    min_slices: int
    num_slices: int
    active: tuple            # sorted admitted, non-preempted slice ids
    leaving: tuple           # sorted admitted-but-preempted slice ids
    recorded: Optional[tuple]

    @property
    def exempt(self) -> tuple:
        """Slices the slice-atomic failover must NOT treat as disrupted:
        everything outside the active set (leaving slices are being shed
        in place; pending slices have no world to tear down)."""
        act = set(self.active)
        return tuple(s for s in range(self.num_slices) if s not in act)


def _gang_slice_id(pg_name: str, job_name: str) -> Optional[int]:
    """Slice id encoded in a multislice gang's PodGroup name
    (``gang_name``: ``{job}-slice-{sid}``), or None for foreign names."""
    prefix = job_name + "-slice-"
    if pg_name.startswith(prefix):
        try:
            return int(pg_name[len(prefix):])
        except ValueError:
            return None
    return 0 if pg_name == job_name else None


@dataclass
class _FailoverDecision:
    """What ``_slice_failover`` decided this round: ``fail`` (permanent
    exit code — job dies via ``_fail_permanently``), ``wait`` (disruption
    seen but the backoff gate holds; the ``frozen`` slices must not be
    touched by the diff loops while reconciliation otherwise proceeds), or
    ``restart`` (slice torn down; recreation rides the next reconcile)."""
    action: str
    requeue: float = 0.0
    message: str = ""
    frozen: tuple = ()


class JobEngine(Reconciler):
    def __init__(self, api: APIServer, controller: WorkloadController,
                 config: Optional[EngineConfig] = None,
                 metrics: Optional[JobMetrics] = None,
                 recorder: Optional[Recorder] = None,
                 gang: Optional[GangScheduler] = None,
                 tracer=None, telemetry=None, elastic_metrics=None):
        self.api = api
        self.controller = controller
        self.config = config or EngineConfig()
        self.metrics = metrics or JobMetrics()
        self.recorder = recorder or Recorder(api)
        self.gang = gang
        #: fleet telemetry bundle (docs/telemetry.md): goodput harvest at
        #: job retirement + the straggler scan driver; None when the
        #: FleetTelemetry gate is off (every hook is one None check)
        self.telemetry = telemetry
        #: kubedl_elastic_* families (docs/elastic.md); None when the
        #: TPUElasticSlices gate is off
        self.elastic_metrics = elastic_metrics
        #: span recorder (docs/tracing.md); the shared disabled tracer by
        #: default, so every trace call below is one attribute check
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.lifecycle = JobLifecycleTracer(self.tracer)
        self.expectations = Expectations(
            clock=api.now, timeout=self.config.expectation_timeout)
        self._jitter_rng = random.Random(self.config.backoff_jitter_seed)
        self.kind = controller.kind
        # PodGroup admission flips must re-trigger the owning job when the
        # scheduler gate is on (PodGroups are controller-owned by the job)
        self.owns = ("Pod", "Service") + (
            ("PodGroup",) if self.config.gate_on_gang_admission else ())
        self._job_states: dict[str, str] = {}  # job uid -> running|pending
        self._tb_jobs: set = set()  # uids that have carried a TB annotation
        self._tb_reap_checked: set = set()  # uids whose TB reap ran at least once
        #: pod uids whose deletionTimestamp has been counted against the
        #: deletion expectation (finalizer-held pods emit several MODIFIED
        #: events while deleting; only the transition counts)
        self._deletion_seen: set = set()
        #: job uid -> outage start (first restart-round stamp of the
        #: current outage); popped into the restart-MTTR histogram on the
        #: first all-active reconcile after it
        self._mttr_start: dict[str, float] = {}
        api.watch(self._observe)

    def _retry(self, fn):
        """Run one api write with bounded decorrelated-jitter retries on
        transient (5xx/timeout) errors; anything else propagates."""
        return retry_transient(
            fn, self.config.retry_policy, retry_on=(ServerError,),
            rng=self._jitter_rng, sleep=self.config.retry_sleep,
            on_retry=lambda n, delay, e: log.warning(
                "transient api error (retry %d in %.3fs): %s", n, delay, e))

    # ------------------------------------------------------------------
    # watch observation (expectations bookkeeping + deletion metrics)
    # ------------------------------------------------------------------

    def _observe(self, event_type: str, obj: dict) -> None:
        kd = m.kind(obj)
        if kd == self.kind:
            # incremental running/pending gauges (avoids a cluster-wide list
            # per reconcile) + per-job bookkeeping cleanup on deletion
            uid = m.uid(obj)
            if event_type == "DELETED":
                self.metrics.deleted.inc(kind=self.kind)
                self._job_states.pop(uid, None)
                self.lifecycle.forget(uid)
                if self.telemetry is not None:
                    self.telemetry.forget(uid)
                self._tb_jobs.discard(uid)
                self._tb_reap_checked.discard(uid)
                self._mttr_start.pop(uid, None)
                self.expectations.delete_prefix(m.key(obj))
            else:
                s = JobStatus.from_dict(obj.get("status"))
                if st.is_finished(s):
                    self._job_states.pop(uid, None)
                else:
                    self._job_states[uid] = "running" if st.is_running(s) else "pending"
            states = list(self._job_states.values())
            self.metrics.running.set(states.count("running"), kind=self.kind)
            self.metrics.pending.set(states.count("pending"), kind=self.kind)
            return
        if kd not in ("Pod", "Service"):
            return
        ref = m.get_controller_ref(obj)
        if not ref or ref.get("kind") != self.kind:
            return
        job_key = f"{m.namespace(obj)}/{ref['name']}"
        rt = m.meta(obj).get("labels", {}).get(c.LABEL_REPLICA_TYPE, "")
        key_fn = (Expectations.pods_key if kd == "Pod" else Expectations.services_key)
        if event_type == "ADDED":
            self.expectations.creation_observed(key_fn(job_key, rt))
        elif event_type == "DELETED":
            if m.uid(obj) not in self._deletion_seen:
                self.expectations.deletion_observed(key_fn(job_key, rt))
            self._deletion_seen.discard(m.uid(obj))
        elif event_type == "MODIFIED" and m.is_deleting(obj) \
                and m.uid(obj) not in self._deletion_seen:
            # a finalizer-held pod (preempt protector) never emits DELETED
            # until a reconcile releases the finalizer — but an unsatisfied
            # deletion expectation would block exactly that reconcile. The
            # deletionTimestamp appearing proves our delete call landed, so
            # count it once per pod uid here (the reference escapes this
            # deadlock by GC'ing finalizers outside ReconcileJobs,
            # pytorchjob_controller.go:335-355); the DELETED branch skips
            # uids already counted so a pod is never observed twice
            self._deletion_seen.add(m.uid(obj))
            self.expectations.deletion_observed(key_fn(job_key, rt))

    # ------------------------------------------------------------------
    # top-level reconcile
    # ------------------------------------------------------------------

    def reconcile(self, req: Request) -> Optional[Result]:
        if self.telemetry is not None:
            # rate-limited straggler scan rides the reconcile stream (the
            # detector itself bounds how often a scan actually runs)
            self.telemetry.maybe_scan(self.api.now())
        job = self.api.try_get(self.kind, req.namespace, req.name)
        if job is None or m.is_deleting(job):
            return None
        self.controller.set_defaults(job)
        raw_specs = m.get_in(job, "spec", self.controller.replica_specs_field_name,
                             default={}) or {}
        # model-output volume + KUBEDL_MODEL_PATH env (reference job.go:471-498)
        mv_spec = m.get_in(job, "spec", "modelVersion")
        if mv_spec:
            add_model_path_env(raw_specs, mv_spec)
        replicas = self.controller.get_replica_specs(job)
        run_policy = self.controller.get_run_policy(job)
        job_key = m.key(job)

        # stale-cache gate (reference SatisfyExpectations, job.go:129 area).
        # When blocked, requeue for when the expectation would expire: if
        # the awaited watch event was dropped, nothing else is guaranteed
        # to re-trigger this reconcile, and the expiry path in
        # Expectations.satisfied can only run when somebody calls it
        for rt in replicas:
            for key in (Expectations.pods_key(job_key, rt),
                        Expectations.services_key(job_key, rt)):
                if not self.expectations.satisfied(key):
                    return Result(requeue_after=max(
                        0.01, self.expectations.expires_in(key)))

        status = JobStatus.from_dict(job.get("status"))
        old_status = copy.deepcopy(status)

        # scheduled jobs convert themselves into a Cron wrapper
        # (reference job.go:372-455)
        if run_policy.cron_policy and run_policy.cron_policy.schedule:
            self._reconcile_cron(job, run_policy)
            return None

        if not status.conditions:
            st.update_job_conditions(
                status, c.JOB_CREATED, st.REASON_JOB_CREATED,
                f"{self.kind} {req.name} is created.", now=self.api.now())
            self.metrics.created.inc(kind=self.kind)
            self.recorder.event(job, TYPE_NORMAL, st.REASON_JOB_CREATED,
                                f"{self.kind} {req.name} is created.")
        if self.tracer.enabled:
            self._ensure_traceparent(job)

        pods = self.get_pods_for_job(job)
        services = self.get_services_for_job(job)

        # ---- backoff limit / active deadline ---------------------------
        # preempted pods (DisruptionTarget) are a voluntary disruption, not
        # the job's fault: spot/preemptible TPU training must survive any
        # number of them without burning backoffLimit budget
        failed_now = sum(1 for p in pods if _pod_phase(p) == c.POD_FAILED
                         and not _has_disruption_target(p))
        prev_failed = sum(rs.failed for rs in status.replica_statuses.values())
        exceeds, failure_msg = False, ""
        if run_policy.backoff_limit is not None:
            if failed_now > prev_failed and not st.is_finished(status):
                # counted in job.status so an operator restart cannot
                # forget a job's failure history (round-2 VERDICT missing
                # #3; reference reconstructs from restartCounts). Terminal
                # jobs never count again: the terminal path skips
                # _reconcile_pods, so prev_failed stays stale and an
                # unguarded increment would re-fire on every status event
                status.failure_rounds += 1
            restarts = _total_restart_count(pods)
            if (status.failure_rounds > run_policy.backoff_limit
                    or restarts > run_policy.backoff_limit):
                exceeds = True
                failure_msg = (f"{self.kind} {req.name} has failed because it "
                               f"has reached the specified backoff limit")
        deadline_requeue = 0.0
        if not exceeds and run_policy.active_deadline_seconds is not None \
                and status.start_time:
            elapsed = self.api.now() - _parse_ts(status.start_time)
            if elapsed >= run_policy.active_deadline_seconds:
                exceeds = True
                failure_msg = (f"{self.kind} {req.name} has failed because it "
                               f"was active longer than specified deadline")
            else:
                deadline_requeue = run_policy.active_deadline_seconds - elapsed

        # ---- terminal path ---------------------------------------------
        if st.is_finished(status) or exceeds:
            return self._finish(job, replicas, run_policy, status, old_status,
                                pods, exceeds, failure_msg)

        # git/GCS code-sync init containers (reference job.go:110), after the
        # terminal gate so a bad config fails the job but still lets the next
        # pass reach _finish and clean up pods
        try:
            inject_code_sync_init_containers(job, raw_specs)
        except ValueError as e:
            return self._fail_permanently(
                job, f"invalid code-sync config: {e}",
                "InvalidCodeSyncConfig", status, old_status)

        # dataset cache: create CacheBackend, wait for its PVC, mount it
        # (reference job.go:117-132 → job_controller.go:202-315)
        cache_spec = m.get_in(job, "spec", "cacheBackend")
        if cache_spec:
            try:
                cache_requeue = reconcile_job_cache(self.api, job, cache_spec,
                                                    raw_specs, status)
            except CacheError as e:
                return self._fail_permanently(job, str(e), "CacheFailed",
                                              status, old_status)
            if cache_requeue:
                self._flush_status(job, status, old_status)
                return Result(requeue_after=cache_requeue)
        replicas = self.controller.get_replica_specs(job)

        try:
            plan = self._resolve_tpu(job, replicas)
        except ValueError as e:
            # invalid slice shape is a permanent config error: fail the job
            # loudly instead of retrying forever
            return self._fail_permanently(job, f"invalid tpuPolicy: {e}",
                                          "InvalidTPUPolicy", status, old_status)

        # ---- gang: one PodGroup per slice ------------------------------
        if self.config.enable_gang_scheduling and self.gang is not None:
            gang_ann = qsched.gang_annotations(
                job, run_policy.scheduling_policy, plan.slice_spec,
                plan.num_slices if plan.policy is not None else 1)
            if self.tracer.enabled:
                # the scheduler attaches its queue-wait / preemption spans
                # to the job's trace via this PodGroup annotation
                gang_ann = {**gang_ann,
                            c.ANNOTATION_TRACEPARENT:
                                format_traceparent(*job_trace_context(job))}
            self._retry(lambda: self.gang.create_gang(
                job, self._gang_min_members(replicas, plan),
                run_policy.scheduling_policy, annotations=gang_ann))

        # ---- concurrency-elastic context (docs/elastic.md) -------------
        # built BEFORE failover: slices the scheduler is shedding in
        # place (Preempted PodGroups with >= min survivors) must be
        # exempt from the whole-gang disruption scan, or the shrink
        # would degrade into exactly the full restart it exists to avoid
        elastic = None
        if (self.config.elastic_slices and plan.policy is not None
                and plan.num_slices > 1
                and self.config.gate_on_gang_admission
                and self.config.enable_gang_scheduling
                and self.gang is not None):
            elastic = self._elastic_plan(job, run_policy, plan)

        # ---- slice-atomic failover (TPU jobs only) ---------------------
        # A gang-scheduled slice whose member was preempted/killed is a
        # dead world: the PJRT coordinator topology is fixed at startup,
        # so recovery replaces the whole slice, never a single pod
        slice_wait, slice_frozen = None, ()
        if plan.policy is not None:
            dec = self._slice_failover(job, status, old_status, pods,
                                       replicas, plan,
                                       exempt=(elastic.exempt
                                               if elastic is not None
                                               else ()))
            if dec is not None:
                if dec.action == "fail":
                    return self._fail_permanently(
                        job, dec.message, "PermanentExitCode",
                        status, old_status)
                if dec.action == "restart":
                    # recount replica statuses from the (pre-teardown) pods
                    # before the early return: leaving them stale would make
                    # the failure-round accounting above re-count the same
                    # failed pod next round
                    self._recount_replica_statuses(status, replicas, pods)
                    self._trace_phase(job, status, pods, replicas)
                    flushed = self._flush_status(job, status, old_status)
                    # deletion events re-trigger reconcile; a failed flush
                    # still needs a timed nudge
                    return None if flushed else Result(requeue_after=1.0)
                # wait: the disrupted slices are frozen until the backoff
                # gate opens, but reconciliation continues so *other*
                # slices (e.g. one torn down just before this disruption)
                # still get their pods recreated on time
                slice_wait, slice_frozen = dec.requeue, dec.frozen
                slice_wait_msg = dec.message

        # ---- slice-scheduler admission gate ----------------------------
        # pods are never created ahead of admission: the job sits Queuing
        # until the scheduler stamps every PodGroup Admitted. Placed after
        # the failover block on purpose — a preempted slice must finish its
        # teardown (which deletes the PodGroup via readmit_slice) before
        # the gate sees the recreated, un-admitted gang and parks the job
        if self.config.gate_on_gang_admission \
                and self.config.enable_gang_scheduling and self.gang is not None:
            # an elastic gang at or above its min width runs NOW on the
            # admitted subset (docs/elastic.md); pending surplus slices
            # regrow later instead of parking the whole job
            waiting = [] if elastic is not None \
                else [m.name(g) for g in self.gang.get_gangs(job)
                      if not is_gang_admitted(g)]
            if waiting:
                st.update_job_conditions(
                    status, c.JOB_QUEUING, st.REASON_JOB_QUEUING,
                    f"{self.kind} {req.name} waiting for gang admission "
                    f"({len(waiting)} PodGroup(s) pending)",
                    now=self.api.now())
                self._recount_replica_statuses(status, replicas, pods)
                self._trace_phase(job, status, pods, replicas)
                flushed = self._flush_status(job, status, old_status)
                # admission flips re-trigger via the PodGroup watch; the
                # timed requeue is the safety net for a dropped event (a
                # failed flush polls faster)
                return Result(requeue_after=self.config.gate_requeue_s
                              if flushed else 1.0)
            for cond in status.conditions:
                # admitted: the queue wait is over even though pods are
                # only now being created (Running flips it too, but the
                # gap between admission and first pod running should not
                # read as still-queued)
                if cond.type == c.JOB_QUEUING and cond.status == "True":
                    cond.status = "False"
                    cond.message = "gang admitted"
                    # the Admitted phase marks the queue-exit instant; pod
                    # creation (below, same pass) opens PodsCreated
                    self.lifecycle.transition(
                        job, "Admitted", self.api.now(),
                        created_at=_parse_ts(
                            m.meta(job).get("creationTimestamp")))

        # ---- restart-free world reconfiguration (docs/elastic.md) ------
        # shrink: leaving slices tear down AFTER the checkpoint ack;
        # grow: new slices' pods are created only after the ack, so the
        # survivors reshard from a state the whole new world agrees on
        reconf_requeue = None
        elastic_allowed: Optional[set] = None
        if elastic is not None:
            reconf_requeue, elastic_allowed = self._elastic_reconfigure(
                job, status, plan, elastic, pods)

        # ---- elastic scaling hook --------------------------------------
        # scale_out/scale_in may return a requeue delay while waiting to
        # confirm in-place restarts (the CRR-status analog)
        elastic_requeue = None
        if st.is_running(old_status) and \
                self.controller.enable_elastic_scaling(job, run_policy):
            if self.controller.checkpoint_if_necessary(job, pods) \
                    and m.generation(job) > 1:
                total = sum(int(rs.replicas or 1) for rs in replicas.values())
                latest = _replicas_at_generation(pods, m.generation(job))
                if total > latest:
                    elastic_requeue = self.controller.scale_out(
                        job, replicas, pods, services)
                elif total < latest:
                    elastic_requeue = self.controller.scale_in(
                        job, replicas, pods, services)

        # ---- per-replica-type diff loops -------------------------------
        # a pending (backoff-gated) slice restart counts as restarting so
        # _update_job_status keeps the job Restarting instead of Failed
        restart = [slice_wait is not None]
        if elastic_allowed is not None:
            # pods exist only on the allowed slice set: the recorded
            # world plus, once a reconfiguration completes, the grown one
            slice_frozen = tuple(sorted(
                set(slice_frozen)
                | {s for s in range(plan.num_slices)
                   if s not in elastic_allowed}))
        # hostnetwork: replica -> live port, re-learned every round so
        # service targetPorts track fail-overed pods (reference pod.go:337-340)
        hostnet_ports: Optional[dict] = \
            {} if hn.enable_hostnetwork(job) else None
        for rtype in self._orders(replicas):
            spec = replicas.get(rtype)
            if spec is None:
                continue
            # AIMaster gate (reference job.go:293-298): AIMaster is always
            # first in _orders, so breaking here never starves it
            if (c.REPLICA_AIMASTER in replicas and rtype != c.REPLICA_AIMASTER
                    and not _aimaster_ready(pods)):
                break
            if (self.config.enable_dag_scheduling and spec.depend_on
                    and not self._dag_ready(pods, spec.depend_on)):
                continue
            try:
                self._reconcile_pods(job, status, pods, rtype, spec, replicas,
                                     run_policy, plan, restart, hostnet_ports,
                                     frozen_slices=slice_frozen)
            except ValueError as e:
                return self._fail_permanently(
                    job, f"invalid {self.kind} spec: {e}", "InvalidJobSpec",
                    status, old_status)
            if self.controller.needs_service(rtype, job):
                self._reconcile_services(job, services, rtype, spec,
                                         hostnet_ports)

        self._update_job_status(job, replicas, status, restart[0], pods)
        if slice_wait is not None:
            # the surviving members of the frozen slice look healthy, so
            # _update_job_status just promoted Running — but their PJRT
            # world is dead; the honest state until the gate opens is
            # Restarting (Running and Restarting are mutually exclusive)
            st.update_job_conditions(status, c.JOB_RESTARTING,
                                     st.REASON_JOB_RESTARTING,
                                     slice_wait_msg, now=self.api.now())
        self.controller.on_job_running(job)
        tb_requeue = self._reconcile_tb(job, status, replicas)

        # ---- launch-delay metrics (job.go:339-356) ---------------------
        created_at = _parse_ts(m.meta(job).get("creationTimestamp"))
        if st.is_created(old_status) and st.is_running(status) and created_at:
            self.metrics.first_pod_launch_delay.observe(
                self.api.now() - created_at, kind=self.kind)
        total = sum(int(rs.replicas or 1) for rs in replicas.values())
        if (sum(rs.active for rs in status.replica_statuses.values()) == total
                and sum(rs.active for rs in old_status.replica_statuses.values()) < total
                and not st.is_restarting(old_status) and created_at):
            self.metrics.all_pods_launch_delay.observe(
                self.api.now() - created_at, kind=self.kind)
            # TPU analog: gang (PodGroup) creation -> whole slice running
            if self.gang is not None:
                gang_ts = [_parse_ts(m.meta(g).get("creationTimestamp"))
                           for g in self.gang.get_gangs(job)]
                gang_ts = [t for t in gang_ts if t]
                if gang_ts:
                    self.metrics.gang_to_all_running.observe(
                        self.api.now() - min(gang_ts), kind=self.kind)
                # rendezvous-ready timestamp: every gang pod reports
                # Running, so the PJRT world can form — the event's
                # timestamp bounds rendezvous latency for traces and
                # humans alike instead of leaving it inferred
                self.recorder.event(
                    job, TYPE_NORMAL, st.REASON_RENDEZVOUS_READY,
                    f"all {total} gang pod(s) of {self.kind} {req.name} "
                    f"are running; rendezvous can complete")
        # restart-MTTR: first disruption of the outage (marked when
        # _slice_failover stamps a restart round, or when an elastic
        # reconfiguration is requested) -> every replica of the CURRENT
        # world active again. Consecutive restart rounds extend one
        # outage window. For elastic jobs the expected count is the
        # allowed width's pods, not the full declared shape.
        uid = m.uid(job)
        eff_total = total
        if elastic_allowed is not None and plan.policy is not None:
            eff_total = total - plan.slice_spec.num_hosts * (
                plan.num_slices - len(elastic_allowed))
        if (eff_total and uid in self._mttr_start
                and sum(rs.active
                        for rs in status.replica_statuses.values())
                == eff_total):
            self.metrics.restart_mttr.observe(
                self.api.now() - self._mttr_start.pop(uid), kind=self.kind)

        self._trace_phase(job, status, pods, replicas)
        flushed = self._flush_status(job, status, old_status)
        requeues = [r for r in (deadline_requeue, tb_requeue, elastic_requeue,
                                reconf_requeue, slice_wait)
                    if r and r > 0]
        if not flushed:
            requeues.append(1.0)  # status write kept failing: try again soon
        if requeues:
            return Result(requeue_after=min(requeues))
        return None

    def _reconcile_tb(self, job, status: JobStatus, replicas) -> Optional[float]:
        """TensorBoard sync with a cheap common-case skip: jobs that never
        carried the annotation don't pay the reap lookups — but each uid
        pays them at least once, so TB resources created before an operator
        restart (when ``_tb_jobs`` starts empty) still get reaped after the
        annotation is removed."""
        uid = m.uid(job)
        has_cfg = c.ANNOTATION_TENSORBOARD_CONFIG in m.annotations(job)
        had = has_cfg or uid in self._tb_jobs or uid not in self._tb_reap_checked
        if has_cfg:
            self._tb_jobs.add(uid)
        r = reconcile_tensorboard(self.api, job, status,
                                  self._tb_master_spec(replicas),
                                  recorder=self.recorder, had_config=had)
        if not has_cfg:
            self._tb_jobs.discard(uid)
            self._tb_reap_checked.add(uid)
        return r

    def _tb_master_spec(self, replicas) -> dict:
        """The replica template a TensorBoard pod derives from: the master's
        when present, else the first in reconcile order."""
        masters = self.controller.master_replica_types(replicas)
        order = masters + [rt for rt in self._orders(replicas)
                           if rt not in masters]
        for rt in order:
            spec = replicas.get(rt)
            if spec is not None and spec.template:
                return {"template": spec.template}
        return {"template": {}}

    def _fail_permanently(self, job, msg: str, reason: str,
                          status: Optional[JobStatus] = None,
                          old_status: Optional[JobStatus] = None) -> None:
        """Fail the job on a permanent config error (no retry would fix it).
        Idempotent: a job already failed records nothing new. Pass the
        round's live status/old_status to keep its mutations; otherwise they
        are re-read from the object."""
        if status is None:
            status = JobStatus.from_dict(job.get("status"))
            old_status = copy.deepcopy(status)
        if st.is_failed(status):
            return None
        self.recorder.event(job, TYPE_WARNING, reason, msg)
        st.update_job_conditions(status, c.JOB_FAILED, st.REASON_JOB_FAILED,
                                 msg, now=self.api.now())
        if status.completion_time is None:
            status.completion_time = m.rfc3339(self.api.now())
        self.metrics.failed.inc(kind=self.kind)
        self._trace_phase(job, status, attrs={"reason": reason})
        if not self._flush_status(job, status, old_status):
            return Result(requeue_after=1.0)
        return None

    # ------------------------------------------------------------------
    # tracing (docs/tracing.md) — every hook is a no-op unless enabled
    # ------------------------------------------------------------------

    def _trace_phase(self, job, status: JobStatus, pods=None, replicas=None,
                     attrs: Optional[dict] = None) -> None:
        """Report the job's current lifecycle phase to the span recorder
        (the lifecycle tracer turns phase *changes* into spans)."""
        if not self.tracer.enabled:
            return
        phase = derive_phase(status, pods, replicas, st, m)
        attributes = dict(attrs or {})
        if phase == "Restarting":
            attributes.setdefault("restartRound", status.restart_rounds)
            attributes.setdefault("restartCount", status.restart_count)
        self.lifecycle.transition(
            job, phase, self.api.now(), attributes=attributes,
            created_at=_parse_ts(m.meta(job).get("creationTimestamp")))

    def _ensure_traceparent(self, job) -> None:
        """Stamp the job with its (UID-derived) traceparent annotation so
        clients and out-of-process tools see the trace id. Best-effort:
        the derivation is deterministic, so a failed patch only loses the
        annotation's visibility, never span correlation."""
        if c.ANNOTATION_TRACEPARENT in m.get_annotations(job):
            return
        value = format_traceparent(*job_trace_context(job))
        try:
            self.api.patch_merge(
                self.kind, m.namespace(job), m.name(job),
                {"metadata": {"annotations": {
                    c.ANNOTATION_TRACEPARENT: value}}})
        except (Conflict, NotFound, ServerError):
            pass

    # ------------------------------------------------------------------
    # terminal path
    # ------------------------------------------------------------------

    def _finish(self, job, replicas, run_policy: RunPolicy, status: JobStatus,
                old_status: JobStatus, pods, exceeds: bool,
                failure_msg: str) -> Optional[Result]:
        self._delete_pods_and_services(job, run_policy, pods)
        if exceeds:
            self.recorder.event(job, TYPE_NORMAL, st.REASON_JOB_FAILED, failure_msg)
            if status.completion_time is None:
                status.completion_time = m.rfc3339(self.api.now())
            st.update_job_conditions(status, c.JOB_FAILED, st.REASON_JOB_FAILED,
                                     failure_msg, now=self.api.now())
            if not st.is_failed(old_status):
                self.metrics.failed.inc(kind=self.kind)

        if st.is_succeeded(status):
            for rs in status.replica_statuses.values():
                rs.succeeded += rs.active
                rs.active = 0
            self._create_model_version(job, pods, status)

        if self.config.enable_gang_scheduling and self.gang is not None:
            self.gang.delete_gang(job)

        self.controller.on_job_finished(job, pods)
        # TensorBoard outlives the job for its own TTL (tensorboard.go:99-135)
        tb_requeue = self._reconcile_tb(job, status, replicas)
        self._trace_phase(job, status, pods, replicas)
        if self.telemetry is not None:
            # the lifecycle root span is closed by the _trace_phase above,
            # so the full trace is harvestable — goodput decomposition +
            # throughput-profile observations. Idempotent per job UID
            # (terminal reconciles repeat on TTL requeues)
            self.telemetry.on_job_terminal(job)
        flushed = self._flush_status(job, status, old_status)

        requeues = [tb_requeue] if tb_requeue else []
        if not flushed:
            requeues.append(1.0)
        # TTL-after-finished cleanup (reference job.go:596-620)
        ttl = run_policy.ttl_seconds_after_finished
        if ttl is None:
            ttl = self.config.default_ttl_seconds
        if ttl is not None:
            finished_at = _parse_ts(status.completion_time) or self.api.now()
            remaining = finished_at + ttl - self.api.now()
            if remaining <= 0:
                try:
                    self.api.delete(self.kind, m.namespace(job), m.name(job))
                except NotFound:
                    pass
                return None
            requeues.append(remaining)
        if requeues:
            return Result(requeue_after=min(requeues))
        return None

    def _delete_pods_and_services(self, job, run_policy: RunPolicy, pods) -> None:
        policy = run_policy.clean_pod_policy or c.CLEAN_POD_RUNNING
        if policy == c.CLEAN_POD_NONE:
            return
        for pod in pods:
            if policy == c.CLEAN_POD_RUNNING and _pod_phase(pod) != c.POD_RUNNING:
                continue
            try:
                self._retry(lambda p=pod: self.api.delete(
                    "Pod", m.namespace(p), m.name(p)))
            except NotFound:
                pass
            # services share the pod's name (reference job.go:60-64)
            try:
                self._retry(lambda p=pod: self.api.delete(
                    "Service", m.namespace(p), m.name(p)))
            except NotFound:
                pass

    def _create_model_version(self, job, pods, status: JobStatus) -> None:
        """On success, emit a ModelVersion CR (reference job.go:500-541)."""
        mv_spec = m.get_in(job, "spec", "modelVersion")
        if not mv_spec or status.model_version_name:
            return
        name = f"mv-{m.name(job)}-{m.uid(job)[:5]}"
        mv = m.new_obj("model.kubedl.io/v1alpha1", "ModelVersion", name,
                       m.namespace(job),
                       spec=build_model_version_spec(job, mv_spec, pods))
        m.set_controller_ref(mv, job)
        try:
            self.api.create(mv)
        except AlreadyExists:
            pass
        status.model_version_name = name

    # ------------------------------------------------------------------
    # children: pods
    # ------------------------------------------------------------------

    def get_pods_for_job(self, job) -> list:
        return self._claim(job, "Pod")

    def get_services_for_job(self, job) -> list:
        return self._claim(job, "Service")

    def _claim(self, job, kind: str) -> list:
        """List + adopt orphans matching our selector (reference
        ``pod.go:532-554`` / ``service_ref_manager.go``)."""
        sel = self.gen_labels(m.name(job))
        out = []
        for obj in self.api.list(kind, m.namespace(job), selector=sel):
            ref = m.get_controller_ref(obj)
            if ref is None and not m.is_deleting(job):
                lbl = m.get_labels(obj)
                if not (lbl.get(c.LABEL_REPLICA_TYPE)
                        and lbl.get(c.LABEL_REPLICA_INDEX, "").isdigit()):
                    continue  # orphan we couldn't manage; leave it alone
                # list() hands out shared snapshots: copy before adopting
                obj = m.deep_copy(obj)
                m.set_controller_ref(obj, job)
                try:
                    obj = self.api.update(obj)
                except (Conflict, NotFound):
                    continue
            elif ref is not None and ref.get("uid") != m.uid(job):
                continue  # controlled by someone else
            out.append(obj)
        return out

    def gen_labels(self, job_name: str) -> dict:
        return {
            c.LABEL_GROUP_NAME: self.controller.group_name,
            c.LABEL_JOB_NAME: job_name.replace("/", "-"),
        }

    def _reconcile_pods(self, job, status: JobStatus, all_pods, rtype: str,
                        spec: ReplicaSpec, replicas, run_policy: RunPolicy,
                        plan: _ReplicaPlan, restart: list,
                        hostnet_ports: Optional[dict] = None,
                        frozen_slices: tuple = ()) -> None:
        rt = rtype.lower()
        tpu_managed = plan.policy is not None and rtype in plan.offsets

        def slice_of(index: int):
            if not tpu_managed:
                return None
            return (plan.offsets[rtype] + index) // plan.slice_spec.num_hosts
        pods = [p for p in all_pods
                if m.labels(p).get(c.LABEL_REPLICA_TYPE) == rt]
        num = int(spec.replicas or 1)
        status.replica_statuses.setdefault(rtype, c.ReplicaStatus())
        rs = status.replica_statuses[rtype]
        rs.active = rs.succeeded = rs.failed = rs.evicted = 0

        by_index: dict[int, list] = {}
        job_key = m.key(job)
        for p in pods:
            idx_str = m.labels(p).get(c.LABEL_REPLICA_INDEX, "")
            if not idx_str.isdigit():
                # a pod of ours with a broken index is unmanageable: delete it
                # or it skews failure counting forever while staying invisible
                self.recorder.event(job, TYPE_WARNING, "DeletePod",
                                    f"pod {m.key(p)} has invalid replica-index "
                                    f"label {idx_str!r}; deleting")
                self._delete_pod(job_key, rtype, p)
                continue
            by_index.setdefault(int(idx_str), []).append(p)
        for index in range(max([num] + [i + 1 for i in by_index])):
            slice_pods = by_index.get(index, [])
            if len(slice_pods) > 1:
                log.warning("too many pods for %s %s %d", job_key, rt, index)
            elif not slice_pods:
                if index >= num:
                    continue
                if slice_of(index) in frozen_slices:
                    # this slice's teardown is waiting out restart backoff:
                    # recreating members piecemeal would patch pods into
                    # the dead world the wait exists to replace
                    continue
                self.expectations.expect_creations(
                    Expectations.pods_key(job_key, rtype), 1)
                try:
                    self._create_pod(job, rtype, index, spec, replicas,
                                     run_policy, plan, hostnet_ports)
                except AlreadyExists:
                    # the AlreadyExists trap (reference pod.go:282-307):
                    # balance the expectation we just set or reconcile stalls
                    self.expectations.creation_observed(
                        Expectations.pods_key(job_key, rtype))
                except ValueError:
                    # permanent config error from set_cluster_spec (e.g. two
                    # PyTorch masters): balance the expectation, then let
                    # reconcile() fail the job loudly
                    self.expectations.creation_observed(
                        Expectations.pods_key(job_key, rtype))
                    raise
                except ServerError:
                    # transient retries exhausted: balance the expectation
                    # (nothing was created) and surface the error so the
                    # manager requeues with backoff
                    self.expectations.creation_observed(
                        Expectations.pods_key(job_key, rtype))
                    raise
                continue
            else:
                pod = slice_pods[0]
                if hostnet_ports is not None:
                    port = hn.get_pod_hostnetwork_port(
                        pod, self.controller.default_container_name,
                        self.controller.default_port_name)
                    if port is not None:
                        hostnet_ports[(rt, index)] = port
                if index >= num:  # scale-in: out-of-range index
                    if not m.is_deleting(pod):
                        self.recorder.event(
                            job, TYPE_NORMAL, "DeletePod",
                            f"pod {m.key(pod)} with index {index} is out of "
                            f"expected replicas {num} and should be deleted")
                        self._delete_pod(job_key, rtype, pod)
                    continue
                exit_code = _exit_code(pod, self.controller.default_container_name)
                # TPU replicas are restarted slice-atomically by
                # _slice_failover; the per-pod delete below would patch a
                # single pod into a dead PJRT world
                if spec.restart_policy == c.RESTART_EXIT_CODE \
                        and _pod_phase(pod) == c.POD_FAILED \
                        and not tpu_managed:
                    reason = m.get_in(pod, "status", "reason", default="")
                    if (exit_code is not None and train.is_retryable_exit_code(exit_code)) \
                            or train.is_retryable_pod_failed_reason(reason):
                        self.recorder.event(job, TYPE_WARNING, "RestartPod",
                                            f"need to restart the pod {m.key(pod)}")
                        self._delete_pod(job_key, rtype, pod)
                        restart[0] = True
                # the failed pod still counts this round (reference pod.go:
                # 356-360 falls through to updateJobReplicaStatuses), which is
                # what lets UpdateJobStatus flip the job to Restarting
                _count_pod(rs, pod, spec.restart_policy)

    def _delete_pod(self, job_key: str, rtype: str, pod) -> None:
        self.expectations.expect_deletions(Expectations.pods_key(job_key, rtype), 1)
        try:
            self._retry(lambda: self.api.delete("Pod", m.namespace(pod),
                                                m.name(pod)))
        except (NotFound, ServerError):
            # NotFound: already gone (a timed-out delete may have landed);
            # exhausted transient errors: the pod is still there, so balance
            # the expectation and let the next reconcile retry the delete
            self.expectations.deletion_observed(Expectations.pods_key(job_key, rtype))

    def _create_pod(self, job, rtype: str, index: int, spec: ReplicaSpec,
                    replicas, run_policy: RunPolicy, plan: _ReplicaPlan,
                    hostnet_ports: Optional[dict] = None) -> None:
        rt = rtype.lower()
        template = m.deep_copy(spec.template) or {}
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": m.deep_copy(template.get("metadata", {})),
            "spec": m.deep_copy(template.get("spec", {})),
        }
        labels = self.gen_labels(m.name(job))
        labels[c.LABEL_REPLICA_TYPE] = rt
        labels[c.LABEL_REPLICA_INDEX] = str(index)
        master = self.controller.is_master_role(replicas, rtype, index)
        if master:
            labels[c.LABEL_JOB_ROLE] = "master"
        if self.controller.enable_elastic_scaling(job, run_policy):
            m.finalizers(pod).append(c.FINALIZER_PREEMPT_PROTECTOR)
            labels[c.LABEL_GENERATION] = str(m.generation(job))
        md = pod["metadata"]
        md["name"] = pl.replica_name(m.name(job), rt, index)
        md["namespace"] = m.namespace(job)
        md["labels"] = {**(md.get("labels") or {}), **labels}

        # replica restart policy overrides template (reference pod.go:410)
        pod["spec"]["restartPolicy"] = (
            c.RESTART_NEVER if spec.restart_policy in (c.RESTART_EXIT_CODE, "")
            else spec.restart_policy)

        # hostnetwork: random port per replica (reference pod.go:509-521)
        hostnet_port: Optional[int] = None
        if hostnet_ports is not None:
            port = hn.random_port(self.config.hostnetwork_port_range,
                                  exclude=set(hostnet_ports.values()))
            if hn.setup_pod_hostnetwork(
                    pod, self.controller.default_container_name,
                    self.controller.default_port_name, port):
                hostnet_port = port

        # TPU slice placement + PJRT rendezvous env. Non-TPU roles of a
        # multislice job still gang with slice 0 (their minMember home).
        slice_id = 0
        num_slices = plan.num_slices if plan.policy is not None else 1
        if plan.policy is not None and rtype in plan.offsets:
            global_id = plan.offsets[rtype] + index
            slice_id = global_id // plan.slice_spec.num_hosts
            pl.render_tpu_worker(
                pod, slice_spec=plan.slice_spec, job_name=m.name(job),
                namespace=m.namespace(job), replica_type=rt, worker_id=global_id,
                num_slices=num_slices,
                container_name=self.controller.default_container_name,
                dns_domain=self.config.dns_domain,
                worker_hostnames=plan.global_dns,
                coordinator_address=f"{plan.global_dns[0]}:{pl.DEFAULT_COORDINATOR_PORT}")

        # job self-identity env: lets in-container agents (the elastic
        # checkpoint half of the 2-phase protocol, train/checkpoint.py
        # ElasticCheckpointAgent; python -m kubedl_tpu_torch.train) find their
        # own CR without guessing from pod labels
        identity_env = [("KUBEDL_JOB_KIND", self.kind),
                        ("KUBEDL_JOB_NAMESPACE", m.namespace(job)),
                        ("KUBEDL_JOB_NAME", m.name(job))]
        if self.tracer.enabled:
            # in-container payloads (trainer step/checkpoint spans) join
            # the job's trace through this context
            identity_env.append((ENV_TRACEPARENT,
                                 format_traceparent(*job_trace_context(job))))
        for container in m.get_in(pod, "spec", "containers",
                                  default=[]) or []:
            env = container.setdefault("env", [])
            for k, v in identity_env:
                if not any(e.get("name") == k for e in env):
                    env.append({"name": k, "value": v})

        # framework-specific rendezvous on top (THE plugin seam)
        self.controller.set_cluster_spec(job, pod, rtype, index)

        if self.config.enable_gang_scheduling and self.gang is not None:
            self.gang.bind_pod_to_gang(job, pod, slice_id, num_slices)

        # spot replica overlay (reference pod.go:437-461)
        if spec.spot_replica_spec is not None:
            num = int(spec.replicas or 1)
            if index >= num - spec.spot_replica_spec.spot_replica_number:
                if spec.spot_replica_spec.priority_class_name:
                    pod["spec"]["priorityClassName"] = \
                        spec.spot_replica_spec.priority_class_name
                md["labels"].update(spec.spot_replica_spec.labels)

        m.set_controller_ref(pod, job)
        self._retry(lambda: self.api.create(pod))
        # record the host port only once the pod really exists; on
        # AlreadyExists the next round re-learns the live pod's port instead
        if hostnet_ports is not None and hostnet_port is not None:
            hostnet_ports[(rt, index)] = hostnet_port
        self.recorder.event(job, TYPE_NORMAL, "SuccessfulCreatePod",
                            f"Created pod: {md['name']}")

    # ------------------------------------------------------------------
    # children: services
    # ------------------------------------------------------------------

    def _reconcile_services(self, job, all_services, rtype: str,
                            spec: ReplicaSpec,
                            hostnet_ports: Optional[dict] = None) -> None:
        rt = rtype.lower()
        services = [s for s in all_services
                    if m.labels(s).get(c.LABEL_REPLICA_TYPE) == rt]
        num = int(spec.replicas or 1)
        by_index = {}
        for s in services:
            try:
                by_index.setdefault(
                    int(m.labels(s).get(c.LABEL_REPLICA_INDEX, "-1")), []).append(s)
            except ValueError:
                continue
        job_key = m.key(job)
        for index in range(max([num] + [i + 1 for i in by_index])):
            group = by_index.get(index, [])
            if not group:
                if index >= num:
                    continue
                self.expectations.expect_creations(
                    Expectations.services_key(job_key, rtype), 1)
                try:
                    self._create_service(job, rtype, index, spec, hostnet_ports)
                except (AlreadyExists, ServerError) as e:
                    self.expectations.creation_observed(
                        Expectations.services_key(job_key, rtype))
                    if isinstance(e, ServerError):
                        raise
            elif index >= num and not m.is_deleting(group[0]):
                self.expectations.expect_deletions(
                    Expectations.services_key(job_key, rtype), 1)
                try:
                    self._retry(lambda g=group[0]: self.api.delete(
                        "Service", m.namespace(g), m.name(g)))
                except (NotFound, ServerError):
                    self.expectations.deletion_observed(
                        Expectations.services_key(job_key, rtype))
            elif hostnet_ports is not None:
                # fail-over port re-sync (reference service.go:236-250): the
                # replica's pod may have restarted on a new random host port;
                # point the stable service at wherever it listens now
                svc = group[0]
                live = hostnet_ports.get((rt, index))
                ports = m.get_in(svc, "spec", "ports", default=[]) or []
                if live is not None and ports \
                        and ports[0].get("targetPort") != live:
                    # svc is a shared list() snapshot: mutate a copy
                    svc = m.deep_copy(svc)
                    svc["spec"]["ports"][0]["targetPort"] = live
                    try:
                        self.api.update(svc)
                    except (Conflict, NotFound):
                        pass

    def _create_service(self, job, rtype: str, index: int, spec: ReplicaSpec,
                        hostnet_ports: Optional[dict] = None) -> None:
        rt = rtype.lower()
        labels = self.gen_labels(m.name(job))
        labels[c.LABEL_REPLICA_TYPE] = rt
        labels[c.LABEL_REPLICA_INDEX] = str(index)
        port = _port_from_template(spec.template,
                                   self.controller.default_container_name,
                                   self.controller.default_port_name) \
            or self.controller.default_port
        # headless services can't remap ports, so hostnetwork mode uses a
        # normal service whose targetPort tracks the pod's random host port
        # (reference service.go:276-305), unless HostNetWithHeadlessSvc
        cluster_ip = "None"
        target_port = port
        if hostnet_ports is not None and not self.config.hostnet_with_headless_svc:
            cluster_ip = ""
            target_port = hostnet_ports.get((rt, index), port)
        svc = m.new_obj("v1", "Service", pl.replica_name(m.name(job), rt, index),
                        m.namespace(job), labels=labels)
        svc["spec"] = {
            "clusterIP": cluster_ip,  # "None" = headless DNS fabric
            "selector": dict(labels),
            "ports": [{"name": self.controller.default_port_name,
                       "port": port, "targetPort": target_port}],
        }
        m.set_controller_ref(svc, job)
        self._retry(lambda: self.api.create(svc))

    # ------------------------------------------------------------------
    # status
    # ------------------------------------------------------------------

    def _update_job_status(self, job, replicas, status: JobStatus,
                           restart: bool, pods) -> None:
        """Generalized form of the per-framework updateGeneralJobStatus
        (reference ``controllers/tensorflow/status.go:69-228``)."""
        name = m.name(job)
        previous_restarting = st.is_restarting(status)
        previous_failed = st.is_failed(status)
        if status.start_time is None:
            status.start_time = m.rfc3339(self.api.now())

        worker0_completed = self._worker0_completed(pods)
        has_master = self.controller.contains_master_spec(replicas)
        master_types = {t.lower() for t in self.controller.master_replica_types(replicas)}

        for rtype, spec in replicas.items():
            rs = status.replica_statuses.get(rtype)
            if rs is None:
                continue
            expected = int(spec.replicas or 1) - rs.succeeded
            if has_master and rtype.lower() in master_types:
                if rs.active > 0:
                    st.update_job_conditions(
                        status, c.JOB_RUNNING, st.REASON_JOB_RUNNING,
                        f"{self.kind} {name} is running.", now=self.api.now())
                if expected == 0:
                    self._mark_succeeded(job, status)
            elif not has_master and rtype == self.controller.worker_replica_type():
                if self.controller.judge_worker_success(
                        job, int(spec.replicas or 1), rs.succeeded,
                        worker0_completed):
                    self._mark_succeeded(job, status)
                elif rs.active > 0:
                    st.update_job_conditions(
                        status, c.JOB_RUNNING, st.REASON_JOB_RUNNING,
                        f"{self.kind} {name} is running.", now=self.api.now())
            if rs.failed > 0:
                if restart:
                    st.update_job_conditions(
                        status, c.JOB_RESTARTING, st.REASON_JOB_RESTARTING,
                        f"{self.kind} {name} is restarting because "
                        f"{rs.failed} {rtype} replica(s) failed.",
                        now=self.api.now())
                    self.recorder.event(job, TYPE_WARNING, st.REASON_JOB_RESTARTING,
                                        f"{rs.failed} {rtype} replica(s) failed")
                    if not previous_restarting:
                        self.metrics.failed.inc(kind=self.kind)
                        self.metrics.restarted.inc(kind=self.kind)
                else:
                    if status.completion_time is None:
                        status.completion_time = m.rfc3339(self.api.now())
                    st.update_job_conditions(
                        status, c.JOB_FAILED, st.REASON_JOB_FAILED,
                        f"{self.kind} {name} is failed because "
                        f"{rs.failed} {rtype} replica(s) failed.",
                        now=self.api.now())
                    self.recorder.event(job, TYPE_NORMAL, st.REASON_JOB_FAILED,
                                        f"{rs.failed} {rtype} replica(s) failed")
                    if not previous_failed:
                        self.metrics.failed.inc(kind=self.kind)

    def _mark_succeeded(self, job, status: JobStatus) -> None:
        if st.is_succeeded(status):
            return
        if status.completion_time is None:
            status.completion_time = m.rfc3339(self.api.now())
        st.update_job_conditions(
            status, c.JOB_SUCCEEDED, st.REASON_JOB_SUCCEEDED,
            f"{self.kind} {m.name(job)} successfully completed.",
            now=self.api.now())
        self.recorder.event(job, TYPE_NORMAL, st.REASON_JOB_SUCCEEDED,
                            f"{self.kind} {m.name(job)} successfully completed.")
        self.metrics.successful.inc(kind=self.kind)

    def _worker0_completed(self, pods) -> bool:
        wt = self.controller.worker_replica_type().lower()
        for p in pods:
            lbl = m.labels(p)
            if lbl.get(c.LABEL_REPLICA_TYPE) == wt \
                    and lbl.get(c.LABEL_REPLICA_INDEX) == "0":
                code = _exit_code(p, self.controller.default_container_name)
                return _pod_phase(p) == c.POD_SUCCEEDED and (code in (0, None))
        return False

    def _flush_status(self, job, status: JobStatus, old_status: JobStatus) -> bool:
        """Write the round's status back. A 409 means another writer moved
        the object under us: re-read for a fresh resourceVersion and
        re-apply our status delta (the controller owns ``.status``, and
        this round's conditions were computed from live pods — dropping
        them would lose a phase transition), bounded so a pathological
        conflict storm degrades to a requeue instead of a livelock.
        Transient 5xx/timeouts retry with jitter inside each attempt.
        Returns False only when the flush could not land (caller requeues)."""
        status.last_reconcile_time = m.rfc3339(self.api.now())
        old_status.last_reconcile_time = status.last_reconcile_time
        if status.to_dict() == old_status.to_dict():
            return True
        for _ in range(8):
            fresh = self.api.try_get(self.kind, m.namespace(job), m.name(job))
            if fresh is None:
                return True  # job deleted: nothing to flush
            fresh["status"] = status.to_dict()
            try:
                self._retry(lambda f=fresh: self.api.update_status(f))
                return True
            except Conflict:
                continue
            except ServerError as e:
                log.warning("status flush for %s failed: %s", m.key(job), e)
                return False
        log.warning("status flush for %s kept conflicting; will requeue",
                    m.key(job))
        return False

    # ------------------------------------------------------------------
    # TPU plan / gang membership / DAG / cron
    # ------------------------------------------------------------------

    def _resolve_tpu(self, job, replicas) -> _ReplicaPlan:
        policy = TPUPolicy.from_job(job)
        if policy is None:
            return _ReplicaPlan()
        slice_spec = policy.resolve()
        num_slices = max(1, policy.num_slices)
        # one flat TPU process index space across TPU replica types, in
        # reconcile order (Master first => Master is process 0)
        orders = self._orders(replicas)
        offsets, total = {}, 0
        for rtype in orders:
            spec = replicas.get(rtype)
            if spec is not None and self.controller.is_tpu_replica(rtype):
                offsets[rtype] = total
                total += int(spec.replicas or 1)
        want = slice_spec.num_hosts * num_slices
        if total != want:
            raise ValueError(
                f"TPU replica count mismatch: {total} TPU replica(s) "
                f"({', '.join(offsets) or 'none'}) but "
                f"{policy.accelerator_type or slice_spec.accelerator_type} x "
                f"{num_slices} slice(s) needs exactly {want} worker pod(s) "
                f"(one per TPU host)")
        global_dns = []
        for rtype, off in sorted(offsets.items(), key=lambda kv: kv[1]):
            n = int(replicas[rtype].replicas or 1)
            global_dns += [
                pl.service_dns(m.name(job), rtype.lower(), i, m.namespace(job),
                               self.config.dns_domain)
                for i in range(n)]
        return _ReplicaPlan(policy=policy, slice_spec=slice_spec,
                            num_slices=num_slices, offsets=offsets,
                            global_dns=global_dns)

    def _orders(self, replicas) -> list[str]:
        """Reconcile order with AIMaster forced first (its gate freezes all
        other types, so it must be created before any of them)."""
        orders = [rt for rt in (self.controller.get_reconcile_orders() or list(replicas))
                  if rt in replicas]
        for rt in replicas:
            if rt not in orders:
                orders.append(rt)
        if c.REPLICA_AIMASTER in orders:
            orders.remove(c.REPLICA_AIMASTER)
            orders.insert(0, c.REPLICA_AIMASTER)
        return orders

    def _gang_min_members(self, replicas, plan: _ReplicaPlan) -> list[int]:
        """minMember per slice gang: hosts-per-slice for TPU workers, with
        non-TPU roles folded into slice 0 (SURVEY.md §2-P gang row)."""
        if plan.policy is None:
            return [sum(int(rs.replicas or 1) for rs in replicas.values())]
        members = [0] * plan.num_slices
        hosts = plan.slice_spec.num_hosts
        for rtype, rs in replicas.items():
            n = int(rs.replicas or 1)
            if rtype in plan.offsets:
                for idx in range(n):
                    members[(plan.offsets[rtype] + idx) // hosts] += 1
            else:
                members[0] += n
        return members

    def _slice_failover(self, job, status: JobStatus, old_status: JobStatus,
                        pods, replicas, plan: _ReplicaPlan,
                        exempt: tuple = ()
                        ) -> Optional[_FailoverDecision]:
        """Slice-atomic recovery for gang-scheduled TPU jobs.

        A slice is *disrupted* when any member pod carries a
        ``DisruptionTarget`` condition, failed with a retryable exit code /
        reason, or — once the job has been running — is simply missing
        (preemption deleted it). Recovery tears down the **whole** slice
        and re-enters gang admission: the surviving pods belong to a PJRT
        world whose membership died with the lost worker, so patching one
        replacement in can never converge. Permanent exit codes fail the
        job instead; a *failed* pod under restartPolicy ``Never`` defers to
        the normal failure path, while a *missing* pod is self-heal
        territory — the engine has always recreated missing pods for any
        policy, and on TPU the slice-atomic form of that self-heal is the
        only one that converges. Repeated restarts wait out a growing
        decorrelated-jitter
        delay persisted in ``JobStatus`` (restartRounds/lastRestartTime) so
        a flapping node can't hot-loop slice recreation.
        """
        hosts = plan.slice_spec.num_hosts
        container = self.controller.default_container_name
        rt_of = {rt.lower(): rt for rt in plan.offsets}
        members: dict[int, list] = {sid: [] for sid in range(plan.num_slices)}
        for p in pods:
            lbl = m.labels(p)
            rtype = rt_of.get(lbl.get(c.LABEL_REPLICA_TYPE, ""))
            idx = lbl.get(c.LABEL_REPLICA_INDEX, "")
            if rtype is None or not idx.isdigit():
                continue  # non-TPU roles keep per-pod semantics
            sid = (plan.offsets[rtype] + int(idx)) // hosts
            if 0 <= sid < plan.num_slices:
                members[sid].append((rtype, p))

        was_up = st.is_running(old_status) or st.is_restarting(old_status)
        disrupted: set[int] = set()
        for sid in range(plan.num_slices):
            if sid in exempt:
                # concurrency-elastic exemption (docs/elastic.md): this
                # slice is being shed in place or has no world yet —
                # its disruption marks are the reconfiguration protocol
                # at work, not a failure to recover from
                continue
            mem = members[sid]
            if was_up and 0 < len(mem) < hosts \
                    and any(_pod_phase(p) != c.POD_PENDING for _, p in mem):
                # a member vanished out from under a slice whose world had
                # started. An all-Pending partial slice is just a rollout
                # interrupted mid-create (e.g. a transient error aborted
                # the diff loop): no world formed yet, so completing the
                # creation converges — tearing it down would burn a
                # backoff round per hiccup
                disrupted.add(sid)
            for rtype, p in mem:
                spec = replicas.get(rtype)
                policy = (spec.restart_policy if spec else "") or c.RESTART_NEVER
                if _pod_disrupted(p, container):
                    if policy != c.RESTART_NEVER:
                        disrupted.add(sid)
                elif policy == c.RESTART_EXIT_CODE \
                        and _pod_phase(p) == c.POD_FAILED:
                    code = _exit_code(p, container)
                    if code is not None and not train.is_retryable_exit_code(code):
                        return _FailoverDecision(
                            "fail", message=(
                                f"replica {m.name(p)} exited with permanent "
                                f"code {code}; not restarting the slice"))
        if not disrupted:
            return None

        # ---- backoff gate (persisted in JobStatus) ---------------------
        now = self.api.now()
        rounds = status.restart_rounds
        last = _parse_ts(status.last_restart_time)
        if last is not None and rounds \
                and now - last >= self.config.restart_backoff_reset:
            rounds = status.restart_rounds = 0  # stable long enough: decay
        # seed 0 unless pinned: the per-job delay must be stable across
        # operator restarts (the job uid already de-correlates jobs)
        delay = restart_delay(rounds, self.config.restart_backoff_base,
                              self.config.restart_backoff_cap,
                              key=m.uid(job),
                              seed=self.config.backoff_jitter_seed or 0)
        if last is not None and delay > 0:
            remaining = last + delay - now
            if remaining > 0:
                st.update_job_conditions(
                    status, c.JOB_RESTARTING, st.REASON_JOB_RESTARTING,
                    f"{self.kind} {m.name(job)} slice restart backing off "
                    f"{delay:.1f}s (round {rounds})", now=now)
                return _FailoverDecision(
                    "wait", requeue=remaining,
                    message=(f"{self.kind} {m.name(job)} slice restart "
                             f"backing off {delay:.1f}s (round {rounds})"),
                    frozen=tuple(sorted(disrupted)))

        # ---- teardown: the whole slice goes together -------------------
        job_key = m.key(job)
        deleted = 0
        for sid in sorted(disrupted):
            for rtype, p in members[sid]:
                if not m.is_deleting(p):
                    self._delete_pod(job_key, rtype, p)
                    deleted += 1
            if self.config.enable_gang_scheduling and self.gang is not None:
                try:
                    self._retry(lambda s=sid: self.gang.readmit_slice(
                        job, s, plan.num_slices))
                except ServerError as e:
                    # pods are already gone: keep the restart bookkeeping
                    # below (losing it would defeat the backoff gate) and
                    # accept the stale PodGroup — create_gang reconciles
                    # its minMember on the next pass
                    log.warning("gang re-admission for slice %d of %s "
                                "failed: %s", sid, job_key, e)
        status.restart_count += 1
        status.restart_rounds = rounds + 1
        status.last_restart_time = m.rfc3339(now)
        # outage-start mark for the restart-MTTR histogram: only the
        # FIRST round of an outage sets it (round 2 of the same outage
        # must not shrink the measured window)
        self._mttr_start.setdefault(m.uid(job), now)
        msg = (f"slice(s) {sorted(disrupted)} of {self.kind} {m.name(job)} "
               f"disrupted; restarting all {deleted} slice pod(s) together "
               f"(restart #{status.restart_count})")
        st.update_job_conditions(status, c.JOB_RESTARTING,
                                 st.REASON_JOB_RESTARTING, msg, now=now)
        self.recorder.event(job, TYPE_WARNING, "SliceRestart", msg)
        self.metrics.restarted.inc(kind=self.kind)
        return _FailoverDecision("restart")

    # ------------------------------------------------------------------
    # concurrency-elastic slices (docs/elastic.md)
    # ------------------------------------------------------------------

    def _elastic_plan(self, job, run_policy: RunPolicy,
                      plan: _ReplicaPlan) -> Optional[_ElasticPlan]:
        """The gang's elastic view this round, or None when pre-elastic
        semantics apply: the job declares no slice range, or the live
        width fell below its min (whole-gang failover is then the only
        move that converges — a world under the floor cannot train)."""
        policy = run_policy.scheduling_policy
        mn = policy.min_slices if policy is not None else None
        if not mn:
            return None
        mn = max(min(int(mn), plan.num_slices), 1)
        if mn >= plan.num_slices:
            return None
        active, leaving = [], []
        for g in self.gang.get_gangs(job):
            sid = _gang_slice_id(m.name(g), m.name(job))
            if sid is None or not (0 <= sid < plan.num_slices) \
                    or not is_gang_admitted(g) or m.is_deleting(g):
                continue
            from ..scheduling.gang import is_gang_preempted
            if is_gang_preempted(g):
                leaving.append(sid)
            else:
                active.append(sid)
        if len(active) < mn:
            return None
        raw = m.get_annotations(job).get(c.ANNOTATION_ELASTIC_SLICES)
        recorded = None
        if raw is not None:
            try:
                recorded = tuple(sorted(
                    int(x) for x in raw.split(",") if x != ""))
            except ValueError:
                recorded = None
        return _ElasticPlan(min_slices=mn, num_slices=plan.num_slices,
                            active=tuple(sorted(active)),
                            leaving=tuple(sorted(leaving)),
                            recorded=recorded)

    def _elastic_reconfigure(self, job, status: JobStatus,
                             plan: _ReplicaPlan, ctx: _ElasticPlan,
                             pods) -> tuple:
        """Drive one restart-free world reconfiguration through the
        2-phase checkpoint protocol (docs/elastic.md):

        1. *Request*: the admitted width diverged from the recorded
           world — bump ``ckpt-requested-version``; the in-container
           agent (``ElasticCheckpointAgent``) saves and acks via
           ``ckpt-completed-version``. The job keeps Running; leaving
           slices keep computing until the checkpoint is down.
        2. *Execute* (ack landed): leaving slices' pods are deleted and
           their PodGroups re-enter gang admission (``readmit_slice`` —
           the regrow source); survivors get a fresh ``world-size``
           annotation (the downward-API in-place restart contract);
           the job's ``elastic-slices`` record adopts the new set. The
           job never transitions back to Created/Queuing.

        Returns ``(requeue_or_None, allowed_slice_set)`` — the diff
        loops create pods only for allowed slices.
        """
        now = self.api.now()
        ann = m.get_annotations(job)
        active = set(ctx.active)
        sig = ",".join(str(s) for s in ctx.active)
        if ctx.recorded is None:
            # first world: record the width the job is starting at
            self._patch_job_annotations(
                job, {c.ANNOTATION_ELASTIC_SLICES: sig})
            return None, active
        if tuple(sorted(ctx.recorded)) == ctx.active and not ctx.leaving:
            return None, active
        survivors = active & set(ctx.recorded)
        has_world = any(_pod_phase(p) == c.POD_RUNNING for p in pods)
        if not has_world and not ctx.leaving:
            # no live world yet: adopt the grown width for free — there
            # is nothing to checkpoint or reshard
            self._patch_job_annotations(
                job, {c.ANNOTATION_ELASTIC_SLICES: sig})
            return None, active
        requested = int(
            ann.get(c.ANNOTATION_CKPT_REQUESTED_VERSION, 0) or 0)
        completed = int(
            ann.get(c.ANNOTATION_CKPT_COMPLETED_VERSION, 0) or 0)
        #: the version gating the in-flight reconfiguration; 0 = none.
        #: Needed because requested == completed is ambiguous between
        #: "our ack just landed" and "nothing in flight"
        gate_v = int(
            ann.get(c.ANNOTATION_ELASTIC_CKPT_VERSION, 0) or 0)
        uid = m.uid(job)
        if gate_v <= 0:
            # phase 1: request a checkpoint for this reconfiguration
            version = max(requested, completed) + 1
            if self._patch_job_annotations(job, {
                    c.ANNOTATION_CKPT_REQUESTED_VERSION: str(version),
                    c.ANNOTATION_ELASTIC_CKPT_VERSION: str(version),
                    c.ANNOTATION_ELASTIC_RECONFIGURE_AT:
                        m.rfc3339(now)}):
                self._mttr_start.setdefault(uid, now)
                self.recorder.event(
                    job, TYPE_NORMAL, "ElasticCheckpointRequested",
                    f"world change {len(ctx.recorded)} -> "
                    f"{len(ctx.active)} slice(s): checkpoint "
                    f"v{version} requested before reconfiguration")
            return 2.0, survivors
        if completed < gate_v:
            return 2.0, survivors       # phase 2 pending: no ack yet
        # ---- execute: the checkpoint is down ---------------------------
        hosts = plan.slice_spec.num_hosts
        rt_of = {rt.lower(): rt for rt in plan.offsets}
        members: dict[int, list] = {}
        for p in pods:
            lbl = m.labels(p)
            rtype = rt_of.get(lbl.get(c.LABEL_REPLICA_TYPE, ""))
            idx = lbl.get(c.LABEL_REPLICA_INDEX, "")
            if rtype is None or not idx.isdigit():
                continue
            sid = (plan.offsets[rtype] + int(idx)) // hosts
            members.setdefault(sid, []).append((rtype, p))
        job_key = m.key(job)
        removed = sorted((set(ctx.recorded) | set(ctx.leaving)) - active)
        for sid in removed:
            for rtype, p in members.get(sid, []):
                if not m.is_deleting(p):
                    self._delete_pod(job_key, rtype, p)
            try:
                self._retry(lambda s=sid: self.gang.readmit_slice(
                    job, s, plan.num_slices))
            except ServerError as e:
                log.warning("elastic re-admission for slice %d of %s "
                            "failed: %s", sid, job_key, e)
        world = hosts * len(active)
        for sid in sorted(survivors):
            for rtype, p in members.get(sid, []):
                try:
                    self._retry(lambda pp=p: self.api.patch_merge(
                        "Pod", m.namespace(pp), m.name(pp),
                        {"metadata": {"annotations": {
                            ANNOTATION_WORLD_SIZE: str(world)}}}))
                except (Conflict, NotFound, ServerError):
                    pass                # downward-API visibility only
        t0 = _parse_ts(
            ann.get(c.ANNOTATION_ELASTIC_RECONFIGURE_AT)) or now
        direction = "shrink" if len(active) < len(ctx.recorded) else "grow"
        self._patch_job_annotations(
            job, {c.ANNOTATION_ELASTIC_SLICES: sig,
                  c.ANNOTATION_ELASTIC_CKPT_VERSION: "0"})
        self.recorder.event(
            job, TYPE_NORMAL, "ElasticReconfigured",
            f"reconfigured in place ({direction}): {len(ctx.recorded)} "
            f"-> {len(active)} slice(s), world size {world} process(es); "
            f"the job never left Running")
        if self.elastic_metrics is not None:
            self.elastic_metrics.reconfigurations.inc(
                kind=self.kind, direction=direction)
            self.elastic_metrics.reconfigure_seconds.observe(
                max(now - t0, 0.0), kind=self.kind)
        if self.tracer.enabled:
            trace_id, root = job_trace_context(job)
            self.tracer.record(
                "elastic.reconfigure", t0, now, trace_id=trace_id,
                parent_id=root, component="engine",
                attributes={"direction": direction,
                            "fromSlices": len(ctx.recorded),
                            "toSlices": len(active),
                            "world": world})
        return None, active

    def _patch_job_annotations(self, job, ann: dict) -> bool:
        """Merge-patch job annotations with bounded conflict re-reads
        plus transient retries — the ack-write discipline shared with
        ``ElasticCheckpointAgent`` (docs/elastic.md): a chaos 409 must
        re-apply, never silently drop a protocol step."""
        for _ in range(8):
            try:
                self._retry(lambda: self.api.patch_merge(
                    self.kind, m.namespace(job), m.name(job),
                    {"metadata": {"annotations": dict(ann)}}))
                return True
            except Conflict:
                continue
            except NotFound:
                return False
            except ServerError as e:
                log.warning("annotation patch for %s failed: %s",
                            m.key(job), e)
                return False
        log.warning("annotation patch for %s kept conflicting",
                    m.key(job))
        return False

    def _recount_replica_statuses(self, status: JobStatus, replicas,
                                  pods) -> None:
        """Refresh per-type active/succeeded/failed counters from live pods
        without running the create/delete diff (used when slice failover
        short-circuits the normal per-replica loops)."""
        for rtype in replicas:
            rt = rtype.lower()
            rs = status.replica_statuses.setdefault(rtype, c.ReplicaStatus())
            rs.active = rs.succeeded = rs.failed = rs.evicted = 0
            for p in pods:
                if m.labels(p).get(c.LABEL_REPLICA_TYPE) == rt:
                    _count_pod(rs, p, replicas[rtype].restart_policy)

    def _dag_ready(self, pods, conditions) -> bool:
        """DAG stage gating (reference ``dag_sched.go:29-67``): all upstream
        replicas must have reached the condition's phase."""
        order = [c.POD_PENDING, c.POD_RUNNING, c.POD_SUCCEEDED]
        for cond in conditions:
            upstream = [p for p in pods
                        if m.labels(p).get(c.LABEL_REPLICA_TYPE) == cond.upstream.lower()]
            if not upstream:
                return False
            for p in upstream:
                phase = _pod_phase(p)
                if phase == c.POD_FAILED:
                    return False
                want = cond.on_phase
                if want in order and phase in order:
                    if order.index(phase) < order.index(want):
                        return False
                elif phase != want:
                    return False
        return True

    def _reconcile_cron(self, job, run_policy: RunPolicy) -> None:
        """A job carrying CronPolicy converts itself into a Cron CR wrapping
        a cleaned copy of the job (reference job.go:372-455)."""
        existing = self.api.try_get("Cron", m.namespace(job), m.name(job))
        if existing is not None:
            return
        workload = copy.deepcopy(job)
        wmeta = workload.get("metadata", {})
        for k in ("resourceVersion", "uid", "creationTimestamp", "generation",
                  "ownerReferences", "managedFields"):
            wmeta.pop(k, None)
        workload.pop("status", None)
        workload.get("spec", {}).pop("cronPolicy", None)
        cp = run_policy.cron_policy
        cron = m.new_obj("apps.kubedl.io/v1alpha1", "Cron", m.name(job),
                         m.namespace(job))
        cron["spec"] = {
            "schedule": cp.schedule,
            "concurrencyPolicy": cp.concurrency_policy,
            "template": {"workload": workload},
        }
        if cp.suspend is not None:
            cron["spec"]["suspend"] = cp.suspend
        if cp.deadline is not None:
            cron["spec"]["deadline"] = cp.deadline
        if cp.history_limit is not None:
            cron["spec"]["historyLimit"] = cp.history_limit
        m.set_controller_ref(cron, job)
        try:
            self.api.create(cron)
            self.recorder.event(job, TYPE_NORMAL, "CronCreated",
                                f"created cron {m.name(job)} for scheduled job")
        except AlreadyExists:
            pass


# ---------------------------------------------------------------------------
# module helpers
# ---------------------------------------------------------------------------

def _pod_phase(pod) -> str:
    return m.get_in(pod, "status", "phase", default=c.POD_PENDING)


def _count_pod(rs, pod, restart_policy: str = "") -> None:
    """Reference ``status.go:19-41``: Pending counts as active only once
    scheduled with init containers passed. Disruption-marked failures are
    tracked as ``evicted``, not ``failed`` — keeping ``rs.failed``
    symmetric with the backoff-limit accounting's live count, which also
    excludes voluntary disruptions (a preemption must never mask or fake
    a genuine failure round). Exception: under restartPolicy ``Never``
    (the default) there is no restart path to absorb the disruption, so
    it also counts as ``failed`` — otherwise a preempted-but-not-deleted
    pod would leave the job Running forever."""
    phase = _pod_phase(pod)
    if phase == c.POD_PENDING:
        if m.get_in(pod, "spec", "nodeName") and _init_containers_passed(pod):
            rs.active += 1
    elif phase == c.POD_RUNNING:
        rs.active += 1
    elif phase == c.POD_SUCCEEDED:
        rs.succeeded += 1
    elif phase == c.POD_FAILED:
        if _has_disruption_target(pod):
            rs.evicted += 1
            if (restart_policy or c.RESTART_NEVER) == c.RESTART_NEVER:
                rs.failed += 1
        else:
            rs.failed += 1
            if m.get_in(pod, "status", "reason", default="") == "Evicted":
                rs.evicted += 1


def _has_disruption_target(pod) -> bool:
    """True when the scheduler/kubelet marked this pod for voluntary
    disruption (preemption, drain, spot reclaim)."""
    for cond in m.get_in(pod, "status", "conditions", default=[]) or []:
        if cond.get("type") == c.POD_COND_DISRUPTION_TARGET \
                and cond.get("status", "True") == "True":
            return True
    return False


def _pod_disrupted(pod, container_name: str) -> bool:
    """A transiently-lost pod: disruption-marked, or failed in a way the
    exit-code taxonomy (``utils.train``) classifies as retryable."""
    if _has_disruption_target(pod):
        return True
    if _pod_phase(pod) != c.POD_FAILED:
        return False
    if train.is_retryable_pod_failed_reason(
            m.get_in(pod, "status", "reason", default="")):
        return True
    code = _exit_code(pod, container_name)
    return code is not None and train.is_retryable_exit_code(code)


def _init_containers_passed(pod) -> bool:
    for cs in m.get_in(pod, "status", "initContainerStatuses", default=[]) or []:
        state = cs.get("state", {})
        if "terminated" not in state and "running" not in state:
            return False
    return True


def _exit_code(pod, container_name: str) -> Optional[int]:
    for cs in m.get_in(pod, "status", "containerStatuses", default=[]) or []:
        if cs.get("name") == container_name:
            term = m.get_in(cs, "state", "terminated")
            if term is not None:
                return int(term.get("exitCode", 0))
    return None


def _total_restart_count(pods) -> int:
    total = 0
    for p in pods:
        for cs in m.get_in(p, "status", "containerStatuses", default=[]) or []:
            total += int(cs.get("restartCount", 0))
    return total


def _replicas_at_generation(pods, generation: int) -> int:
    return sum(1 for p in pods
               if m.labels(p).get(c.LABEL_GENERATION) == str(generation))


def _aimaster_ready(pods) -> bool:
    for p in pods:
        if m.labels(p).get(c.LABEL_REPLICA_TYPE) == c.REPLICA_AIMASTER.lower():
            return _pod_phase(p) == c.POD_RUNNING
    return False


def _parse_ts(ts) -> Optional[float]:
    if not ts:
        return None
    import calendar
    import time as _time
    try:
        return calendar.timegm(_time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ"))
    except (ValueError, TypeError):
        return None


def _port_from_template(template: dict, container_name: str,
                        port_name: str) -> Optional[int]:
    for ct in m.get_in(template, "spec", "containers", default=[]) or []:
        if ct.get("name") == container_name:
            for p in ct.get("ports", []) or []:
                if p.get("name") == port_name:
                    return int(p.get("containerPort"))
    return None
