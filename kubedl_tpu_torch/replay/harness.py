"""The cluster-day replay: real control plane, scheduler, chaos, traces.

Drives a :class:`~kubedl_tpu_torch.replay.workload.Workload`'s job day through
the REAL stack — ``APIServer`` (wrapped in a seeded ``ChaosAPIServer``
for the operator's writes), ``Manager``, ``JobEngine`` with the
slice-scheduler admission gate, ``CoschedulerPlugin`` gangs, and
``SliceScheduler`` — on one shared :class:`SimClock`. The harness plays
only the roles the system does not own:

* the **client** (creates Job objects at their arrival times, deletes
  retired ones),
* the **kubelet** (flips Pending pods Running after a fixed simulated
  start latency; stamps terminal phases at completion time),
* the **chaos scheduler** (scripted node preemptions of running jobs).

Everything the scorecard reports is read back from the system's own
observability: lifecycle trace spans (queue delay, restart MTTR,
critical paths), the scheduler's inventory/metrics (utilization,
admission/preemption/backfill counters), and the control-plane metrics
(reconcile counts). The loop is event-driven in simulated time — the
next round happens at ``min(next workload event, Manager.next_deadline())``
— so requeue nets, restart backoffs, and TTL reaps all fire exactly when
the system scheduled them, and two runs with the same seed produce
identical timelines.

Copied from ``kubedl_tpu/replay/harness.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import heapq
from typing import Optional

from ..api import common as c
from ..api.common import JobStatus
from ..api.queue import new_queue
from ..api.slo import new_slo
from ..chaos.campaign import CampaignRunner, control_plane_digest
from ..controllers.chaos import ChaosAPIServer, ChaosConfig
from ..controllers.engine import EngineConfig, JobEngine
from ..controllers.testing import TestJobController, new_test_job, \
    set_pod_phase
from ..core import meta as m
from ..core.apiserver import APIServer, NotFound
from ..core.clock import SimClock
from ..metrics.registry import (ControlPlaneMetrics, JobMetrics, Registry,
                                SchedulerMetrics, TelemetryMetrics,
                                TraceMetrics)
from ..telemetry import GoodputAccountant
from ..telemetry.slo import SLOEvaluator
from ..scheduling.gang import CoschedulerPlugin
from ..scheduling.inventory import SliceInventory
from ..scheduling.scheduler import SliceScheduler
from ..trace import Tracer, job_trace_context
from ..trace.analysis import (assert_well_formed, restart_mttrs,
                              restart_windows, trace_breakdown)
from ..utils import status as st
from ..utils.retry import RetryPolicy
from .workload import (HOSTS_PER_SLICE, POOL_ACCELERATOR, POOL_CHIPS,
                       POOL_COSTS, POOL_SPOT, QUEUES, Workload)

#: event kinds, in same-time processing order (arrivals before
#: completions before preemptions before retirements before campaign
#: actions before checkpoint acks keeps ties stable)
(_EV_ARRIVAL, _EV_COMPLETE, _EV_PREEMPT, _EV_RETIRE, _EV_CAMPAIGN,
 _EV_CKPT_ACK) = 0, 1, 2, 3, 4, 5

#: sim-time comparison slack: ``t0 + sim_t - t0`` loses an ulp at
#: day-epoch magnitudes, so strict ``<=`` against ``clock.elapsed``
#: would spin forever on an event the clock just advanced to
_EPS = 1e-6


def default_job_slos(profile) -> list:
    """The replay's declared objectives over the job day (docs/slo.md),
    scaled to the profile (the goodput floor tracks the profile's
    absolute gate). Every object carries an explicit uid so its create
    never consumes the deterministic uid factory the job timeline keys
    on — adding an SLO must not move a single job's trace id."""
    if profile.name == "adversarial":
        return adversarial_job_slos(profile)
    window = 4.0 * profile.sim_seconds      # covers day + settle tail
    goodput_floor = {"smoke": 0.10, "day": 0.20}.get(profile.name, 0.20)
    return [
        new_slo("fleet-goodput", "fleet_goodput", goodput_floor,
                goal=0.95, window_s=window, uid="slo-fleet-goodput"),
        new_slo("queue-delay-p99", "queue_delay_p99", 28800.0,
                window_s=window, uid="slo-queue-delay-p99"),
        new_slo("restart-mttr-p50", "restart_mttr_p50", 1800.0,
                window_s=window, uid="slo-restart-mttr-p50"),
    ]


def adversarial_job_slos(profile) -> list:
    """The adversarial campaign's declared objectives (docs/chaos.md):
    looser goals than the day profile (a campaign is SUPPOSED to burn
    budget) with burn thresholds a correlated-failure wave can actually
    reach inside its alert windows — the gate is survival (budget never
    exhausts, every page clears), not cleanliness. Burn thresholds must
    stay <= 1/budget or the pair can mathematically never fire."""
    window = 4.0 * profile.sim_seconds
    return [
        new_slo("fleet-goodput", "fleet_goodput", 0.05,
                goal=0.90, window_s=window, uid="slo-fleet-goodput"),
        # goal 0.75 => 25% error budget; page at 2x budget pace means
        # >= half the jobs retiring across BOTH a 5m and a 30m window
        # waited longer than 20 minutes — a correlated outage signature,
        # not a noisy blip
        new_slo("queue-delay-p75", "queue_delay_p75", 1200.0,
                window_s=window, uid="slo-queue-delay-p75",
                alerting=[
                    {"severity": "page", "shortSeconds": 300.0,
                     "longSeconds": 1800.0, "burn": 2.0},
                    {"severity": "ticket", "shortSeconds": 3600.0,
                     "longSeconds": 4 * 3600.0, "burn": 1.0},
                ]),
        new_slo("restart-mttr-p50", "restart_mttr_p50", 1800.0,
                window_s=window, uid="slo-restart-mttr-p50",
                alerting=[
                    {"severity": "page", "shortSeconds": 300.0,
                     "longSeconds": 1800.0, "burn": 1.6},
                    {"severity": "ticket", "shortSeconds": 3600.0,
                     "longSeconds": 4 * 3600.0, "burn": 1.0},
                ]),
    ]


class _JobState:
    __slots__ = ("spec", "remaining", "run_start", "token", "running",
                 "succeeded", "completion_ordinal", "width_frac")

    def __init__(self, spec):
        self.spec = spec
        self.remaining = spec.duration_s
        self.run_start: Optional[float] = None
        self.token = 0               # run epoch; stale completions skip
        self.running = False
        self.succeeded = False
        self.completion_ordinal = -1
        #: fraction of the declared width the job currently runs at
        #: (docs/elastic.md): a shrunk job makes proportionally slower
        #: progress — ``remaining`` is banked in full-width seconds and
        #: burned at ``width_frac`` per wall second. Always 1.0 outside
        #: elastic replays, keeping the arithmetic bit-identical
        #: (x * 1.0 == x and x / 1.0 == x exactly in IEEE754).
        self.width_frac = 1.0


class ClusterReplay:
    """One job-day replay. ``run()`` returns the raw observation dict the
    scorecard aggregates (lists of trace-derived samples + final metric
    reads), all in simulated seconds."""

    def __init__(self, workload: Workload, shards: int = 1,
                 campaign=None, journal_dir: Optional[str] = None,
                 replication_followers: int = 0, elastic: bool = False,
                 clock: Optional[SimClock] = None):
        self.workload = workload
        profile = workload.profile
        seed = workload.seed
        #: concurrency-elastic slices (docs/elastic.md): multi-slice
        #: jobs declare min = half their width, the engine/scheduler run
        #: with the TPUElasticSlices gate on, and the harness plays the
        #: in-container checkpoint agent (acking ckpt requests after
        #: ``ckpt_ack_s`` of simulated save time). False (every
        #: committed BENCH_CLUSTER scorecard) = byte-identical replays.
        self.elastic = bool(elastic)
        self.ckpt_ack_s = 20.0
        #: chaos campaign (docs/chaos.md): a compiled fault script the
        #: runner executes at its scheduled sim times; None = the plain
        #: day (every committed smoke/day scorecard)
        self.campaign = campaign
        self.campaign_runner = None
        #: reconcile-shard count threaded to the Manager
        #: (docs/durability.md). The default 1 keeps every committed
        #: BENCH_CLUSTER.json metric byte-identical; any value is
        #: timeline-identical too, because the manager's synchronous
        #: drain pops in globally-earliest-(ready_at, seq) order
        #: regardless of shard count (pinned by tests/test_replay.py).
        self.shards = max(int(shards), 1)
        #: an injected clock makes this replay one REGION of a larger
        #: simulation (docs/federation.md): N replays sharing one
        #: SimClock advance in lockstep under a federation driver. The
        #: default — own clock — is every committed scorecard's path.
        self.clock = clock if clock is not None else SimClock()
        self.registry = Registry()
        # deterministic uids: trace ids and per-job restart-backoff
        # jitter derive from uids, so uuid4 would make every run's
        # timeline (and scorecard) unique
        self._uid_n = 0

        def uid_factory() -> str:
            self._uid_n += 1
            return f"replay-{seed}-{self._uid_n:08d}"

        #: durable control plane (docs/durability.md): the adversarial
        #: profile journals every commit so the slow-fsync primitive has
        #: a real group-commit path to slow down. The journal's latency
        #: timer is the SIM clock, so kubedl_journal_fsync_seconds
        #: measures exactly the injected delay — deterministic.
        self.journal = None
        if journal_dir is not None:
            from ..core.journal import Journal
            from ..metrics.registry import DurabilityMetrics
            # clock= stamps each WAL record's ts with sim time and
            # retain_all keeps every generation, so the forensics
            # WorldLine can reconstruct the store at ANY rv of the
            # campaign day (docs/forensics.md)
            self.journal = Journal(journal_dir, snapshot_every=4096,
                                   fsync_every=64, timer=self.clock,
                                   clock=self.clock, retain_all=True)
            self.inner = APIServer(
                clock=self.clock, uid_factory=uid_factory,
                journal=self.journal, watch_ring=8192,
                durability_metrics=DurabilityMetrics(self.registry))
        else:
            self.inner = APIServer(clock=self.clock,
                                   uid_factory=uid_factory)
        #: replicated control plane (docs/replication.md): N warm
        #: follower stores fed by WAL shipping at the group-commit
        #: fsync boundary, promotable by the leader_kill primitive.
        #: 0 (every committed scorecard) = no replication object, no
        #: shipping hooks, byte-identical timelines.
        self.replication = None
        self.replication_report: Optional[dict] = None
        if replication_followers:
            if self.journal is None:
                raise ValueError("replication_followers requires "
                                 "journal_dir (WAL shipping ships the "
                                 "journal's sealed fsync batches)")
            from ..core.replication import ReplicatedControlPlane
            from ..metrics.registry import ReplicationMetrics
            # lease cadence in sim seconds: coarse enough that renewals
            # don't dominate the WAL, tight enough that promotion lands
            # well inside the day
            self.replication = ReplicatedControlPlane(
                self.inner, self.journal,
                followers=replication_followers, clock=self.clock,
                metrics=ReplicationMetrics(self.registry),
                lease_duration=60.0, retry_period=15.0,
                identity="leader-0")
        self.chaos = ChaosAPIServer(self.inner, ChaosConfig(
            seed=seed,
            conflict_on_status_update=profile.chaos_conflict,
            error_on_create=profile.chaos_create_error,
            drop_watch_events=profile.chaos_drop_watch,
            max_faults=profile.chaos_max_faults), clock=self.clock)
        if self.journal is not None:
            self.journal.fsync_hook = self.chaos.fsync_hook
        self.tracer = Tracer(enabled=True, capacity=profile.trace_capacity,
                             clock=self.clock,
                             metrics=TraceMetrics(self.registry))
        self.cp_metrics = ControlPlaneMetrics(self.registry)
        # the manager's reconcile spans are volume without scorecard
        # signal at fleet scale (they would wrap the ring over the
        # lifecycle spans); reconcile latency lives in cp_metrics instead
        from ..core.manager import Manager
        self.manager = Manager(self.chaos, clock=self.clock,
                               metrics=self.cp_metrics,
                               shards=self.shards)
        self.job_metrics = JobMetrics(self.registry)
        self.elastic_metrics = None
        if self.elastic:
            from ..metrics.registry import ElasticMetrics
            self.elastic_metrics = ElasticMetrics(self.registry)
        self.engine = JobEngine(
            self.chaos, TestJobController(),
            EngineConfig(
                enable_gang_scheduling=True,
                gate_on_gang_admission=True,
                gate_requeue_s=60.0,
                retry_policy=RetryPolicy(attempts=5, base=0.05, cap=2.0),
                retry_sleep=self.clock.advance,
                backoff_jitter_seed=seed + 1,
                restart_backoff_base=5.0,
                restart_backoff_cap=120.0,
                elastic_slices=self.elastic),
            metrics=self.job_metrics,
            gang=CoschedulerPlugin(self.chaos), tracer=self.tracer,
            elastic_metrics=self.elastic_metrics)
        self.manager.register(self.engine)
        self.sched_metrics = SchedulerMetrics(self.registry)
        self.inventory = SliceInventory(self.chaos,
                                        static_capacity=dict(profile.capacity))
        self.scheduler = SliceScheduler(
            self.chaos, inventory=self.inventory,
            metrics=self.sched_metrics, tracer=self.tracer,
            retry_policy=RetryPolicy(attempts=5, base=0.05, cap=2.0),
            retry_sleep=self.clock.advance,
            elastic=self.elastic, elastic_metrics=self.elastic_metrics)
        self.manager.register(self.scheduler)
        for q in QUEUES:
            self.inner.create(new_queue(**q))

        # harness-side informers (watch-fed, like every other component;
        # never polled): job phase transitions + the Pending-pod set the
        # simulated kubelet serves
        self._jobs: dict[str, _JobState] = {}
        self._pending_pods: dict[tuple, tuple] = {}
        self._completion_retry: set = set()
        self._events: list = []
        self._seq = 0
        self.inner.watch(self._observe)

        # fleet goodput accounting (docs/telemetry.md): every retired
        # job's trace breakdown folds in, so the scorecard's
        # fleet_goodput column is the telemetry layer's own math run at
        # day scale — the proof the layer works, not a bench-local copy
        self.goodput = GoodputAccountant(
            metrics=TelemetryMetrics(self.registry))

        # SLO engine over the job day (docs/slo.md): the replay installs
        # a default objective set and rides the real evaluator, so the
        # scorecard's slo block is the engine's own math at day scale.
        # recorder=None: alert Events would consume the uid factory and
        # shift every later job's trace id; conditions (update_status)
        # don't allocate uids, so the lifecycle still lands on the
        # objects. SLOMetrics rides the same registry as everything else.
        from ..metrics.registry import SLOMetrics
        for obj in default_job_slos(profile):
            self.inner.create(obj)
        self.slo = SLOEvaluator(api=self.inner, clock=self.clock,
                                metrics=SLOMetrics(self.registry),
                                goodput=self.goodput,
                                evaluate_interval_s=60.0)

        # observation accumulators (trace-derived samples + counters)
        self.queue_delays: list = []
        self.mttrs: list = []
        self.restart_rounds_seen = 0
        #: (start, end, job) of every traced Restarting phase — the
        #: incident timeline's restart-round stream (docs/forensics.md)
        self.restart_windows: list = []
        self.orphan_violations: list = []
        self.sampled_traces = 0
        self.chaos_preempts_executed = 0
        self._completions = 0
        self._util_slice_seconds = 0.0
        self._last_t: Optional[float] = None
        self.rounds = 0
        self._handlers = {
            _EV_ARRIVAL: self._on_arrival,
            _EV_COMPLETE: lambda p: self._on_complete(*p),
            _EV_PREEMPT: self._on_preempt,
            _EV_RETIRE: self._on_retire,
            _EV_CAMPAIGN: self._on_campaign,
            _EV_CKPT_ACK: lambda p: self._on_ckpt_ack(*p),
        }
        # placement telemetry (docs/scheduling.md "Placement scoring"):
        # derived observations only — the replay's scheduling decisions
        # are untouched, so every pre-existing scorecard metric stays
        # byte-identical and the placement block is purely additive
        self._util_by_pool: dict = {p: 0.0 for p in profile.capacity}
        self._ms_gangs_observed = 0
        self._ms_gangs_packed = 0
        #: jobs that took a scripted chaos node preemption (the replay's
        #: model of a spot eviction) — scheduler-reclaim restarts must
        #: NOT count as spot evictions
        self._chaos_preempted_jobs: set = set()
        self.spot_evictions_survived = 0
        #: elastic observations (docs/elastic.md; populated only when
        #: ``elastic=True`` — the day/smoke result dicts are untouched):
        #: per-retired-job elastic.reconfigure span durations, the jobs
        #: that reconfigured, and any trace showing a reconfigured job
        #: leaving Running (the zero-transitions-back-to-Created gate)
        self.reconfig_durations: list = []
        self.reconfigured_jobs: set = set()
        self.elastic_phase_violations: list = []
        self._acks_scheduled: set = set()
        if campaign is not None:
            self.campaign_runner = CampaignRunner(campaign, self)

    # ------------------------------------------------------------------
    # watch-fed job state
    # ------------------------------------------------------------------

    def _observe(self, event_type: str, obj: dict) -> None:
        kd = m.kind(obj)
        if kd == "Pod":
            key = (m.namespace(obj), m.name(obj))
            phase = (obj.get("status") or {}).get("phase", "Pending")
            if event_type != "DELETED" and phase == "Pending" \
                    and not m.is_deleting(obj):
                self._pending_pods[key] = key
            else:
                self._pending_pods.pop(key, None)
            return
        if kd != "TestJob" or event_type == "DELETED":
            return
        name = m.name(obj)
        rec = self._jobs.get(name)
        if rec is None or rec.succeeded:
            return
        s = JobStatus.from_dict(obj.get("status"))
        now = self.clock()
        running = st.is_running(s)
        if self.elastic:
            self._observe_elastic(name, rec, obj, running, now)
        if running and not rec.running:
            rec.running = True
            rec.run_start = now
            rec.token += 1
            self._push(now - self.clock.t0
                       + rec.remaining / rec.width_frac, _EV_COMPLETE,
                       (name, rec.token))
            if rec.spec.num_slices > 1:
                # ICI packedness of the multi-slice gang as placed (the
                # inventory's domain assignment; read-only)
                spans = self.inventory.gang_domains(
                    "default", name, rec.spec.pool)
                if spans is not None:
                    self._ms_gangs_observed += 1
                    if spans <= 1:
                        self._ms_gangs_packed += 1
        elif not running and rec.running:
            # preempted / restarting mid-run: bank the progress made
            # (at the width the job was actually running at)
            rec.running = False
            rec.remaining = max(
                rec.remaining - (now - rec.run_start) * rec.width_frac,
                1.0)
            rec.run_start = None
        if st.is_succeeded(s):
            rec.succeeded = True

    def _observe_elastic(self, name: str, rec, obj: dict, running: bool,
                         now: float) -> None:
        """The harness's elastic roles (docs/elastic.md): play the
        in-container checkpoint agent — schedule an ack ``ckpt_ack_s``
        of simulated save time after each request — and model a shrunk
        job's proportionally slower progress by re-banking ``remaining``
        whenever the engine's elastic-slices record changes width."""
        ann = m.get_annotations(obj)
        requested = int(
            ann.get(c.ANNOTATION_CKPT_REQUESTED_VERSION, 0) or 0)
        completed = int(
            ann.get(c.ANNOTATION_CKPT_COMPLETED_VERSION, 0) or 0)
        if requested > completed \
                and (name, requested) not in self._acks_scheduled:
            self._acks_scheduled.add((name, requested))
            self._push(self.clock.elapsed + self.ckpt_ack_s,
                       _EV_CKPT_ACK, (name, requested))
        sig = ann.get(c.ANNOTATION_ELASTIC_SLICES)
        width = len([x for x in sig.split(",") if x != ""]) if sig \
            else rec.spec.num_slices
        frac = width / rec.spec.num_slices
        if frac == rec.width_frac:
            return
        if rec.running and running:
            # width changed mid-run: bank progress at the old rate and
            # re-arm the completion at the new one
            rec.remaining = max(
                rec.remaining - (now - rec.run_start) * rec.width_frac,
                1.0)
            rec.run_start = now
            rec.width_frac = frac
            rec.token += 1
            self._push(now - self.clock.t0
                       + rec.remaining / rec.width_frac, _EV_COMPLETE,
                       (name, rec.token))
        else:
            rec.width_frac = frac

    def _on_ckpt_ack(self, name: str, version: int) -> None:
        """The in-container agent's ack (docs/elastic.md): the simulated
        save finished — write ``ckpt-completed-version``. Uses the raw
        store like the kubelet helpers: the agent has its own apiserver
        connection, operator-aimed chaos must not fault it."""
        job = self.inner.try_get("TestJob", "default", name)
        if job is None:
            return
        ann = m.get_annotations(job)
        requested = int(
            ann.get(c.ANNOTATION_CKPT_REQUESTED_VERSION, 0) or 0)
        completed = int(
            ann.get(c.ANNOTATION_CKPT_COMPLETED_VERSION, 0) or 0)
        if requested <= completed:
            return                       # already acked (idempotent)
        self.inner.patch_merge("TestJob", "default", name, {
            "metadata": {"annotations": {
                c.ANNOTATION_CKPT_COMPLETED_VERSION: str(requested)}}})
        self.manager.run_until_idle(max_iterations=1_000_000)

    # ------------------------------------------------------------------
    # event machinery
    # ------------------------------------------------------------------

    def _push(self, sim_t: float, kind: int, payload) -> None:
        self._seq += 1
        heapq.heappush(self._events, (sim_t, kind, self._seq, payload))

    def _make_job(self, spec) -> dict:
        hosts = HOSTS_PER_SLICE[spec.pool]
        queue = next(q for q in QUEUES if q["name"] == spec.queue)
        policy = {"queue": spec.queue, "priority": queue["priority"]}
        if self.elastic and spec.num_slices > 1:
            # elastic range (docs/elastic.md): a multi-slice job
            # tolerates running at half its declared width
            policy["minSlices"] = max(spec.num_slices // 2, 1)
        return new_test_job(
            spec.name, workers=hosts * spec.num_slices,
            restart_policy="ExitCode",
            tpu_policy={"acceleratorType": POOL_ACCELERATOR[spec.pool],
                        "numSlices": spec.num_slices},
            run_policy={"schedulingPolicy": policy})

    def _owned_pods(self, name: str) -> list:
        job = self.inner.try_get("TestJob", "default", name)
        if job is None:
            return []
        return self.inner.list_owned("Pod", m.uid(job), namespace="default")

    def _kubelet_round(self) -> None:
        """Flip every Pending pod Running after the simulated node-start
        latency, until the world has none (a flip can admit more work
        only via the manager, so drain between passes). The Pending set
        is informer-maintained — an idle round costs one dict check."""
        for _ in range(64):
            if not self._pending_pods:
                return
            pending = sorted(self._pending_pods)
            self.clock.advance(self.workload.profile.pod_start_s)
            for ns, name in pending:
                pod = self.inner.try_get("Pod", ns, name)
                if pod is not None and not m.is_deleting(pod):
                    set_pod_phase(self.inner, pod, "Running")
            self.manager.run_until_idle(max_iterations=1_000_000)
        raise RuntimeError("kubelet rounds did not drain (pods keep "
                           "reappearing Pending)")

    # ------------------------------------------------------------------
    # event handlers
    # ------------------------------------------------------------------

    def _on_arrival(self, spec) -> None:
        self._jobs[spec.name] = _JobState(spec)
        self.inner.create(self._make_job(spec))

    def _on_complete(self, name: str, token: int) -> None:
        rec = self._jobs[name]
        retrying = (name, token) in self._completion_retry
        if rec.succeeded or rec.token != token \
                or (not rec.running and not retrying):
            self._completion_retry.discard((name, token))
            return                       # stale epoch (preempted meanwhile)
        for p in sorted(self._owned_pods(name), key=m.name):
            if (p.get("status") or {}).get("phase") == "Running":
                set_pod_phase(self.inner, p, "Succeeded", exit_code=0)
        self.manager.run_until_idle(max_iterations=1_000_000)
        job = self.inner.try_get("TestJob", "default", name)
        s = JobStatus.from_dict(job.get("status")) if job is not None \
            else None
        if job is None or not st.is_succeeded(s):
            # a chaos-conflicted status flush lands on a later manager
            # deadline; re-check shortly (the token keeps this from
            # racing a genuine preempt-and-rerun)
            self._completion_retry.add((name, token))
            self._push(self.clock.elapsed + 2.0, _EV_COMPLETE,
                       (name, token))
            return
        self._completion_retry.discard((name, token))
        rec.succeeded = True
        rec.completion_ordinal = self._completions
        self._completions += 1
        self._push(self.clock.elapsed + self.workload.profile.retire_after_s,
                   _EV_RETIRE, name)

    def preempt_job(self, name: str) -> bool:
        """Chaos-preempt one running pod of ``name`` (slice-atomic
        failover tears down and restarts the whole gang). Returns
        whether a pod was actually disrupted — the campaign runner's
        primitives and the workload's scripted preemptions share this
        one path so every injected eviction lands in the same ledgers."""
        rec = self._jobs.get(name)
        if rec is None or rec.succeeded or not rec.running:
            return False
        pods = sorted(self._owned_pods(name), key=m.name)
        victims = [p for p in pods
                   if (p.get("status") or {}).get("phase") == "Running"]
        if not victims:
            return False
        self.chaos.preempt("default", m.name(victims[0]))
        self.chaos_preempts_executed += 1
        self._chaos_preempted_jobs.add(name)
        return True

    def kill_leader(self) -> dict:
        """The ``leader_kill`` primitive (docs/replication.md): SIGKILL
        the control-plane leader mid-day and promote the most-caught-up
        WAL follower. The dead leader's journal is never closed — its
        tail past the last group-commit fsync is only write(2)-flushed
        — and the promoted follower inherits it, replaying the
        acknowledged tail exactly like single-process recovery.

        Process model: after promotion the replay keeps driving its
        live store, having AUDITED (and recorded, for the e2e gate)
        that the promoted follower's world is identical to it — every
        acknowledged object at its exact rv, the rv counter resumed.
        That identity is what lets the single in-process stack stand in
        for "every client re-resolved to the new leader": continuing on
        a bit-identical world is indistinguishable from switching
        stores, and the real client-side resume (an informer moving to
        the promoted store by rv bookmark with zero relists) is proven
        separately in tests/test_replication.py and the
        bench_controlplane replication leg."""
        rcp = self.replication
        if rcp is None:
            raise RuntimeError(
                "leader_kill fired but the replay has no replication "
                "(pass replication_followers > 0 with journal_dir)")
        report = rcp.kill_and_promote_audited(takeover_api=self.inner)
        report.pop("follower")
        self.replication_report = report
        return self.replication_report

    def preempt_gang(self, name: str) -> bool:
        """Spot-evict EVERY slice of one running job at once (one pod
        per slice disrupted, so slice-atomic failover tears the complete
        gang down in a single round) — the whole-gang spot reclaim the
        level-based ``spot_dry`` baseline sweeps with (docs/elastic.md).
        Single-pod preemption would leave a partially-held gang whose
        lone pending slice can starve behind a fully-evicted queue
        head's reservation; a real capacity reclaim takes the gang
        whole."""
        rec = self._jobs.get(name)
        if rec is None or rec.succeeded or not rec.running:
            return False
        hosts = HOSTS_PER_SLICE[rec.spec.pool]
        seen: set = set()
        hit = False
        for p in sorted(self._owned_pods(name), key=m.name):
            if (p.get("status") or {}).get("phase") != "Running":
                continue
            try:
                idx = int(m.labels(p).get(c.LABEL_REPLICA_INDEX, "0")
                          or 0)
            except ValueError:
                idx = 0
            sid = idx // hosts
            if sid in seen:
                continue
            seen.add(sid)
            self.chaos.preempt("default", m.name(p))
            hit = True
        if hit:
            self.chaos_preempts_executed += 1
            self._chaos_preempted_jobs.add(name)
        return hit

    def _on_preempt(self, ordinal: int) -> None:
        running = sorted(n for n, r in self._jobs.items()
                         if r.running and not r.succeeded)
        if not running:
            return                       # nothing to disrupt right now
        self.preempt_job(running[ordinal % len(running)])

    def _on_campaign(self, action) -> None:
        self.campaign_runner.execute(action)

    def _on_retire(self, name: str) -> None:
        """Harvest the job's trace (the scorecard's per-job samples),
        then delete the object — bounding the world like a TTL reaper."""
        job = self.inner.try_get("TestJob", "default", name)
        if job is None:
            return
        rec = self._jobs[name]
        if rec.spec.pool in POOL_SPOT and rec.token > 1 \
                and name in self._chaos_preempted_jobs:
            # a spot-pool gang that lost slices to a node preemption
            # (the spot-eviction model) yet rode the slice-atomic
            # failover to completion; scheduler-reclaim restarts are
            # deliberately excluded
            self.spot_evictions_survived += 1
        tid, _root = job_trace_context(job)
        spans = self.tracer.spans(trace_id=tid)
        bd = trace_breakdown(spans, tid, dropped=self.tracer.dropped)
        self.goodput.observe(bd)
        queue_delay = bd["byPhase"].get("Queuing", 0.0)
        mttrs = restart_mttrs(bd["phases"])
        # the SLO engine sees exactly the samples the scorecard reports;
        # the job label rides along purely for forensic attribution
        # (selectors never match on it; window math is label-blind)
        now = self.clock()
        self.slo.observe("queue_delay", queue_delay, now,
                         {"queue": rec.spec.queue, "job": name})
        for v in mttrs:
            self.slo.observe("restart_mttr", v, now,
                             {"queue": rec.spec.queue, "job": name})
        self.queue_delays.append(queue_delay)
        self.mttrs.extend(mttrs)
        if self.elastic:
            # elastic.reconfigure windows are recovery samples too
            # (docs/elastic.md: the restart-MTTR SLO covers shrink
            # events) — and a reconfigured job's trace must show it
            # never fell back out of Running
            reconfs = [e.get("duration", 0.0)
                       for e in bd.get("events") or []
                       if e.get("component") == "engine"
                       and e.get("name") == "elastic.reconfigure"]
            if reconfs:
                self.reconfigured_jobs.add(name)
                self.reconfig_durations.extend(reconfs)
                self.mttrs.extend(reconfs)
                for v in reconfs:
                    self.slo.observe("restart_mttr", v, now,
                                     {"queue": rec.spec.queue,
                                      "job": name})
                seen_running = False
                for p in bd["phases"]:
                    if p["name"] == "Running":
                        seen_running = True
                    elif seen_running and p["name"] in (
                            "Created", "Queuing", "Restarting"):
                        self.elastic_phase_violations.append(
                            f"{name}: {p['name']} after Running")
        for start, end in restart_windows(bd["phases"]):
            self.restart_rounds_seen += 1
            self.restart_windows.append((start, end, name))
        profile = self.workload.profile
        stride = max(1, profile.jobs // max(profile.sample_traces, 1))
        if rec.completion_ordinal % stride == 0:
            self.sampled_traces += 1
            try:
                assert_well_formed(spans)
            except AssertionError as e:
                self.orphan_violations.append(f"{name}: {e}")
        try:
            self.inner.delete("TestJob", "default", name)
        except NotFound:
            pass
        self.manager.run_until_idle(max_iterations=1_000_000)

    # ------------------------------------------------------------------
    # the day loop
    # ------------------------------------------------------------------

    def _integrate_util(self) -> None:
        now = self.clock()
        if self._last_t is not None and now > self._last_t:
            dt = now - self._last_t
            held = 0
            for p in self.workload.profile.capacity:
                h = self.inventory.held_slices(p)
                held += h
                self._util_by_pool[p] += h * dt
            self._util_slice_seconds += held * dt
        self._last_t = now

    # The day loop is split into stepper methods so a federation driver
    # (docs/federation.md) can interleave N regions on ONE shared clock:
    # prepare() seeds the heap, next_wake() reports when this region
    # needs the clock, service() runs one round at the current time, and
    # finalize() settles the end of day. run() composes them in exactly
    # the original operation order, so every committed scorecard stays
    # byte-identical (pinned by the bench regression gates).

    def prepare(self) -> None:
        """Seed the event heap from the workload and arm the utilization
        integrator — everything ``run()`` did before its first round."""
        for spec in self.workload.jobs:
            self._push(spec.arrival_s, _EV_ARRIVAL, spec)
        for pe in self.workload.preemptions:
            self._push(pe.time_s, _EV_PREEMPT, pe.ordinal)
        if self.campaign is not None:
            for action in self.campaign.actions:
                self._push(action.time_s, _EV_CAMPAIGN, action)
        self._last_t = self.clock()

    def next_wake(self) -> Optional[float]:
        """Sim-relative time of this replay's next scheduled work: the
        event heap's head or the manager's earliest deadline, whichever
        comes first (None = nothing scheduled)."""
        nxt = self._events[0][0] if self._events else None
        dl = self.manager.next_deadline()
        if dl is not None:
            dl_sim = dl - self.clock.t0
            nxt = dl_sim if nxt is None else min(nxt, dl_sim)
        return nxt

    def service(self) -> None:
        """One round at the CURRENT clock time: pop every due event,
        drain the manager, run the kubelet, settle utilization, and step
        the SLO evaluator + replication election. The caller advances
        the clock (``run()`` to :meth:`next_wake`; a federation driver
        to the global minimum across regions)."""
        while self._events \
                and self._events[0][0] <= self.clock.elapsed + _EPS:
            _, kind, _, payload = heapq.heappop(self._events)
            self._handlers[kind](payload)
        self.manager.run_until_idle(max_iterations=1_000_000)
        self._kubelet_round()
        self._integrate_util()
        self.slo.maybe_evaluate(self.clock())
        if self.replication is not None:
            # lease renewals + standby expiry observations on the
            # retry cadence (sim time) — the watching that lets a
            # promotion land within one lease term of a kill
            self.replication.maybe_step_election(self.clock())

    @property
    def finished(self) -> bool:
        """No pending events and every tracked job succeeded."""
        return not self._events and all(
            r.succeeded for r in self._jobs.values())

    def inject_job(self, spec) -> None:
        """Mid-run arrival injection — the federation layer's global-
        routing and evacuation seam (docs/federation.md): identical to a
        workload arrival landing at the current sim time."""
        self._on_arrival(spec)

    def finalize(self) -> None:
        """End of day: final SLO windows + verdicts, WAL tail seal, and
        the scheduler's inventory-parity check."""
        self.slo.evaluate(self.clock())     # final windows + verdicts
        if self.replication is not None:
            # orderly end of day: seal the WAL tail so the shipping
            # stream drains and the followers report their true lag.
            # The group's journal, not self.journal — after a mid-day
            # promotion the live journal is the successor the new
            # leader opened over the same directory
            self.replication.journal.flush()
        if hasattr(self.scheduler, "check_parity"):
            self.scheduler.check_parity()

    def run(self) -> dict:
        profile = self.workload.profile
        self.prepare()
        max_rounds = 80 * profile.jobs + 10_000
        while not self.finished:
            self.rounds += 1
            if self.rounds > max_rounds:
                raise RuntimeError(
                    f"replay exceeded {max_rounds} rounds — wedged?")
            nxt = self.next_wake()
            if nxt is None:
                unfinished = [n for n, r in self._jobs.items()
                              if not r.succeeded]
                raise RuntimeError(
                    f"replay wedged: no events, no manager deadlines, "
                    f"{len(unfinished)} job(s) unfinished "
                    f"(e.g. {unfinished[:5]})")
            self._integrate_util()
            self.clock.advance_to(nxt + _EPS)
            self.service()
        self.finalize()
        return self._result()

    def _placement_block(self) -> dict:
        """The scorecard's placement telemetry (docs/scheduling.md
        "Placement scoring"): ICI-packed fraction of multi-slice gangs,
        spot evictions survived, $-weighted slice-hours, and the
        normalized-throughput weighting of fleet goodput — all derived
        from observations the replay already makes, so the block is
        additive and deterministic."""
        from ..scheduling.scoring import seed_rate
        pools = sorted(self.workload.profile.capacity)
        seeds = {p: seed_rate(p) for p in pools}
        best = max(seeds.values(), default=0.0) or 1.0
        norm = {p: seeds[p] / best for p in pools}
        busy_total = sum(self._util_by_pool.values())
        norm_util = (sum(norm[p] * self._util_by_pool[p] for p in pools)
                     / busy_total) if busy_total > 0 else 0.0
        cost_hours = sum(
            self._util_by_pool[p] / 3600.0
            * POOL_COSTS.get(p, 1.0) * POOL_CHIPS.get(p, 1)
            for p in pools)
        goodput = self.goodput.summary(ndigits=6).get("fleetGoodput", 0.0)
        return {
            "ici_packed_fraction": round(
                self._ms_gangs_packed / self._ms_gangs_observed, 4)
            if self._ms_gangs_observed else 1.0,
            "multi_slice_gangs_observed": self._ms_gangs_observed,
            "spot_evictions_survived": self.spot_evictions_survived,
            "cost_weighted_slice_hours": round(cost_hours, 2),
            "normalized_throughput_utilization": round(norm_util, 4),
            "normalized_throughput_weighted_goodput": round(
                goodput * norm_util, 4),
            "util_slice_seconds_by_pool": {
                p: round(self._util_by_pool[p], 1) for p in pools},
        }

    def _chaos_attribution(self) -> dict:
        """The scorecard's chaos ledger (docs/chaos.md): what the
        injector says it did vs what the system's own metric registries
        attribute to it. Every number is read from the chaos server's
        ledgers or an existing metric family — zero bench-local
        bookkeeping, so a missing restart here is a product bug, not a
        counting bug."""
        by_op_kind: dict[str, int] = {}
        for op, kind, _target, _detail in self.chaos.faults:
            key = f"{op}/{kind}"
            by_op_kind[key] = by_op_kind.get(key, 0) + 1
        sm = self.sched_metrics
        return {
            "faults_injected": dict(sorted(by_op_kind.items())),
            "faults_total": len(self.chaos.faults),
            "latency_injections": len(self.chaos.latencies),
            "latency_seconds_injected": round(
                sum(lat[3] for lat in self.chaos.latencies), 3),
            "preemptions_injected": len(self.chaos.preemptions),
            "restarts_observed": self.job_metrics.restarted.value(
                kind="TestJob"),
            "restart_rounds_traced": self.restart_rounds_seen,
            "mttr_observed": self.job_metrics.restart_mttr.count(
                kind="TestJob"),
            "scheduler_preemptions": sum(
                sm.preempted.value(queue=q["name"]) for q in QUEUES),
        }

    def _slo_health(self) -> dict:
        """Alert-lifecycle survival (docs/chaos.md): onset counts per
        severity, plus anything STRANDED at end of run — a firing flag
        or a True SLOBurnRate condition that never cleared. The
        adversarial gate holds both stranded counts to zero."""
        from ..telemetry.slo import SLO_BURN_RATE
        fired = 0
        pages_fired = 0
        stranded_alerts = 0
        min_budget = 1.0
        for s in self.slo.statuses():
            if "invalid" in s:
                continue
            min_budget = min(min_budget, s["budgetRemaining"])
            for severity, a in s["alerts"].items():
                fired += a["fired"]
                if severity == "page":
                    pages_fired += a["fired"]
                if a["firing"]:
                    stranded_alerts += 1
        stranded_conditions = 0
        for obj in self.inner.list("SLO"):
            for cond in (obj.get("status") or {}).get("conditions", []):
                if cond.get("type") == SLO_BURN_RATE \
                        and cond.get("status") == "True":
                    stranded_conditions += 1
        return {
            "alerts_fired": fired,
            "pages_fired": pages_fired,
            "stranded_alerts": stranded_alerts,
            "stranded_conditions": stranded_conditions,
            "min_budget_remaining": round(min_budget, 6),
        }

    def control_plane_state(self) -> dict:
        """Object-level end state for the recovery-parity gate: the
        spec-digest of every surviving object (statuses excluded) plus
        the scheduler inventory's residual holds. A campaign run must
        land on the same digest as a fault-free reference run."""
        state = dict(control_plane_digest(self.inner))
        state["held_slices"] = sum(
            self.inventory.held_slices(p)
            for p in self.workload.profile.capacity)
        return state

    def _result(self) -> dict:
        profile = self.workload.profile
        capacity = sum(profile.capacity.values())
        makespan = max(self.clock.elapsed, 1e-9)
        demand = sum(j.num_slices * j.duration_s for j in self.workload.jobs)
        sm, cm = self.sched_metrics, self.cp_metrics
        out = {
            "jobs_submitted": len(self.workload.jobs),
            "jobs_completed": self._completions,
            "makespan_s": round(makespan, 1),
            "rounds": self.rounds,
            # scheduler-inventory-integrated busy slice-seconds over
            # capacity x the busy window (offered load bounds it)
            "slice_utilization": round(
                self._util_slice_seconds / (capacity * makespan), 4),
            "offered_load": round(
                demand / (capacity * profile.sim_seconds), 4),
            "queue_delays_s": self.queue_delays,
            "restart_mttrs_s": self.mttrs,
            "restart_rounds_traced": self.restart_rounds_seen,
            "chaos_preemptions_executed": self.chaos_preempts_executed,
            "scheduler": {
                "passes": self.scheduler.passes,
                "admitted": sum(sm.admitted.value(queue=q["name"])
                                for q in QUEUES),
                "preempted": sum(sm.preempted.value(queue=q["name"])
                                 for q in QUEUES),
                "backfills": sum(sm.backfills.value(queue=q["name"])
                                 for q in QUEUES),
                "resyncs": sm.resyncs.value(),
                "drift": sm.drift.value(),
            },
            "controlplane": {
                "reconciles": self.manager.reconcile_count,
                "reconciles_per_job": round(
                    self.manager.reconcile_count
                    / max(len(self.workload.jobs), 1), 2),
                "max_queue_depth": self.manager.max_queue_depth,
            },
            "engine_metrics": {
                "restarted": self.job_metrics.restarted.value(
                    kind="TestJob"),
                "mttr_observed": self.job_metrics.restart_mttr.count(
                    kind="TestJob"),
                "mttr_sum_s": round(self.job_metrics.restart_mttr.sum(
                    kind="TestJob"), 1),
            },
            "goodput": self.goodput.summary(ndigits=4),
            "placement": self._placement_block(),
            "slo": self.slo.summary(ndigits=4),
            "slo_health": self._slo_health(),
            "chaos": {"attribution": self._chaos_attribution()},
            "trace": {
                "sampled_jobs": self.sampled_traces,
                "orphan_violations": len(self.orphan_violations),
                "orphan_examples": self.orphan_violations[:3],
                "spans_dropped": self.tracer.dropped,
            },
        }
        if self.elastic:
            from ..utils.stats import summarize
            em = self.elastic_metrics
            pools = sorted(profile.capacity)
            out["elastic"] = {
                "jobs_reconfigured": len(self.reconfigured_jobs),
                "reconfigurations": {
                    "shrink": em.reconfigurations.value(
                        kind="TestJob", direction="shrink"),
                    "grow": em.reconfigurations.value(
                        kind="TestJob", direction="grow"),
                },
                "shrunk_slices": {
                    p: em.shrunk_slices.value(pool=p) for p in pools
                    if em.shrunk_slices.value(pool=p)},
                "regrown_slices": {
                    p: em.regrown_slices.value(pool=p) for p in pools
                    if em.regrown_slices.value(pool=p)},
                "reconfigure_s": summarize(
                    self.reconfig_durations, percentiles=(0.5, 0.99),
                    ndigits=1),
                "phase_violations": len(self.elastic_phase_violations),
                "phase_violation_examples":
                    self.elastic_phase_violations[:3],
            }
        if self.replication is not None:
            out["replication"] = {
                "status": self.replication.status(),
                "report": self.replication_report,
            }
        if self.campaign_runner is not None:
            out["campaign"] = self.campaign_runner.summary()
            out["forensics"] = self._forensics_block(
                out["campaign"], out["slo_health"])
        return out

    def _forensics_block(self, campaign_summary: dict,
                         slo_health: dict) -> dict:
        """The campaign postmortem (docs/forensics.md): merge the fault
        script, alert transitions, chaos preemptions, and traced restart
        rounds into one causal timeline. Every input is deterministic
        for a fixed seed (times normalize to sim-relative seconds), so
        the block rides the same bit-for-bit determinism gate as the
        rest of the result."""
        from ..forensics import IncidentTimeline, build_postmortem
        tl = IncidentTimeline(epoch=self.clock.t0)
        tl.add_campaign(self.campaign)
        tl.add_alert_log(self.slo.alert_log, self.slo.specs())
        tl.add_preemptions(self.campaign_runner.preemption_log)
        tl.add_restarts(self.restart_windows)
        tl.add_bad_samples(self.slo.bad_samples)
        return build_postmortem(
            self.campaign.scenario, self.workload.seed,
            campaign_summary["fingerprint"], tl.build(),
            slo_health=slo_health)


