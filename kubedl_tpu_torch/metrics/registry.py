"""Metrics registry with Prometheus text exposition.

Stdlib-only equivalent of the reference's ``pkg/metrics`` (``job_metrics.go:
34-62,120-195``, documented in ``docs/metrics.md``). Metric names are kept
verbatim (``kubedl_jobs_created`` etc.) so existing dashboards keep working;
the launch-delay histograms gain a TPU-flavored sibling measuring
gang-schedule-to-all-running — the operator half of the BASELINE
"gang-schedule-to-first-step" target.

Copied from ``kubedl_tpu/metrics/registry.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

_DEFAULT_BUCKETS = (0.5, 1, 2.5, 5, 10, 20, 40, 60, 90, 120, 180, 300, 600)


class _Metric:
    def __init__(self, name: str, help_text: str, label_names: tuple):
        self.name = name
        self.help = help_text
        self.label_names = label_names
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def _key(self, labels: dict) -> tuple:
        return tuple(str(labels.get(ln, "")) for ln in self.label_names)

    def sample(self, **labels):
        """``value()`` that distinguishes "never written" from a real
        0.0 — returns None for an absent label series. The SLO engine's
        ``metric:`` reader uses this so a typo'd family/selector yields
        no samples instead of a fabricated always-0.0 signal."""
        with self._lock:
            return self._values.get(self._key(labels))

    def remove(self, **labels) -> None:
        """Drop one label series from the exposition entirely. Gauges
        describing a deleted object (an SLO's budget/burn series) must
        disappear, not freeze at their last value — dashboards alerting
        on 'budget < X' would keep acting on an objective that no
        longer exists."""
        with self._lock:
            self._values.pop(self._key(labels), None)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        with self._lock:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels):
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text, label_names, buckets: Iterable[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, **labels):
        with self._lock:
            k = self._key(labels)
            counts = self._counts.setdefault(k, [0] * (len(self.buckets) + 1))
            self._sums[k] = self._sums.get(k, 0.0) + value
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1  # +Inf

    def count(self, **labels) -> int:
        k = self._key(labels)
        return self._counts.get(k, [0])[-1]

    def sum(self, **labels) -> float:
        return self._sums.get(self._key(labels), 0.0)

    def quantile(self, q: float, **labels):
        """Estimate the ``q``-quantile from the cumulative bucket counts
        (the SLO engine's read point for ``metric:`` signals over
        histograms, docs/slo.md): linear interpolation within the
        winning bucket, the way ``histogram_quantile`` does it. Samples
        landing only in the ``+Inf`` bucket clamp to the largest finite
        bound — a histogram cannot say more. Returns None when no
        samples were observed."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self._counts.get(self._key(labels), ()))
        if not counts or counts[-1] == 0:
            return None
        rank = q * counts[-1]
        prev_cum, lower = 0, 0.0
        for i, bound in enumerate(self.buckets):
            cum = counts[i]
            if cum >= rank and cum > prev_cum:
                frac = (rank - prev_cum) / (cum - prev_cum)
                return lower + (bound - lower) * frac
            prev_cum, lower = cum, bound
        return float(self.buckets[-1])      # +Inf bucket: clamp


class Registry:
    def __init__(self):
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def counter(self, name, help_text="", labels=()):
        mt = Counter(name, help_text, tuple(labels))
        with self._lock:
            self._metrics.append(mt)
        return mt

    def gauge(self, name, help_text="", labels=()):
        mt = Gauge(name, help_text, tuple(labels))
        with self._lock:
            self._metrics.append(mt)
        return mt

    def histogram(self, name, help_text="", labels=(), buckets=_DEFAULT_BUCKETS):
        mt = Histogram(name, help_text, tuple(labels), buckets)
        with self._lock:
            self._metrics.append(mt)
        return mt

    def find(self, name: str):
        """The registered metric with this exposition name, or None (the
        SLO engine resolves ``metric:<family>`` signals through this)."""
        with self._lock:
            for mt in self._metrics:
                if mt.name == name:
                    return mt
        return None

    def expose(self) -> str:
        """Prometheus text exposition format. Snapshots each metric under
        its lock so a scrape never races a concurrent observe/inc/set."""
        out = []
        for mt in self._metrics:
            out.append(f"# HELP {mt.name} {mt.help}")
            out.append(f"# TYPE {mt.name} {mt.kind}")
            if isinstance(mt, Histogram):
                with mt._lock:
                    counts_snap = {k: list(v) for k, v in mt._counts.items()}
                    sums_snap = dict(mt._sums)
                for k, counts in counts_snap.items():
                    lbl = _fmt_labels(mt.label_names, k)
                    for i, b in enumerate(mt.buckets):
                        le = f'le="{b}"'
                        out.append(f"{mt.name}_bucket{_merge(lbl, le)} {counts[i]}")
                    inf = 'le="+Inf"'
                    out.append(f"{mt.name}_bucket{_merge(lbl, inf)} {counts[-1]}")
                    out.append(f"{mt.name}_sum{_wrap(lbl)} {sums_snap.get(k, 0.0)}")
                    out.append(f"{mt.name}_count{_wrap(lbl)} {counts[-1]}")
            else:
                with mt._lock:
                    values_snap = dict(mt._values)
                for k, v in values_snap.items():
                    out.append(f"{mt.name}{_wrap(_fmt_labels(mt.label_names, k))} {v}")
        return "\n".join(out) + "\n"


def _escape_label(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped or the exposition line is
    unparseable (label values are user-influenced — queue names, kinds)."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt_labels(names: tuple, values: tuple) -> str:
    return ",".join(f'{n}="{_escape_label(v)}"'
                    for n, v in zip(names, values) if v != "")


def _wrap(lbl: str) -> str:
    return f"{{{lbl}}}" if lbl else ""


def _merge(lbl: str, extra: str) -> str:
    return f"{{{lbl},{extra}}}" if lbl else f"{{{extra}}}"


#: reconcile latencies are control-plane-fast (sub-ms to seconds), not the
#: job-launch-delay scale the default buckets cover
_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class ControlPlaneMetrics:
    """Workqueue + reconcile instrumentation (the controller-runtime
    workqueue/controller metric set): queue depth and in-flight gauges,
    queue-wait and reconcile-latency histograms, dispatch counter. The
    Manager maintains these on its hot path; ``bench_controlplane.py``
    and the ``/metrics`` endpoint read them."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.queue_depth = r.gauge(
            "kubedl_workqueue_depth",
            "Distinct request keys waiting in the controller workqueue")
        self.queue_inflight = r.gauge(
            "kubedl_workqueue_inflight",
            "Request keys being reconciled right now")
        self.queue_latency = r.histogram(
            "kubedl_workqueue_duration_seconds",
            "Time from a request becoming ready to a worker claiming it",
            buckets=_LATENCY_BUCKETS)
        self.reconciles = r.counter(
            "kubedl_reconciles_total",
            "Reconcile dispatches by primary kind", ("kind",))
        self.reconcile_latency = r.histogram(
            "kubedl_reconcile_latency_seconds",
            "Wall-clock latency of one reconcile dispatch",
            ("kind",), buckets=_LATENCY_BUCKETS)


class PagedKVMetrics:
    """Paged KV-cache pool instrumentation for the serving predictor's
    ``/metrics``: pool occupancy (capacity planning), the shared-block
    ratio (how much HBM prefix copy-on-write sharing is saving), and the
    preemption counter (a rising rate means the pool is undersized for
    the offered load). Refreshed from the engine's ``pool_stats()``
    snapshot on scrape."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.blocks_total = r.gauge(
            "kubedl_serving_kv_blocks_total",
            "Usable KV pool blocks (excludes the garbage sink)")
        self.blocks_free = r.gauge(
            "kubedl_serving_kv_blocks_free",
            "KV pool blocks currently unreferenced")
        self.blocks_pinned = r.gauge(
            "kubedl_serving_kv_blocks_pinned",
            "KV pool blocks pinned by registered prefixes")
        self.shared_ratio = r.gauge(
            "kubedl_serving_kv_shared_block_ratio",
            "Fraction of in-use KV blocks referenced by more than one "
            "holder (prefix sharing)")
        # a true Counter (not a gauge wearing the _total suffix):
        # rate()/increase() and reset detection need counter semantics,
        # so refresh() feeds it the delta since the last snapshot
        self.preemptions = r.counter(
            "kubedl_serving_kv_preemptions_total",
            "Lanes evicted back to the queue because the pool ran dry")
        self._preempt_seen = 0
        self.peak_active = r.gauge(
            "kubedl_serving_peak_active_lanes",
            "Peak simultaneously-active continuous-batching lanes")

    def refresh(self, stats: dict) -> None:
        """Push one ``ContinuousBatchingEngine.pool_stats()`` snapshot."""
        self.peak_active.set(stats.get("peak_active", 0))
        if "blocks_total" not in stats:
            return                       # dense mode: no pool
        self.blocks_total.set(stats["blocks_total"])
        self.blocks_free.set(stats["blocks_free"])
        self.blocks_pinned.set(stats["blocks_pinned"])
        used = stats["blocks_used"]
        self.shared_ratio.set(stats["blocks_shared"] / used if used else 0.0)
        delta = stats["preempted"] - self._preempt_seen
        if delta > 0:
            self.preemptions.inc(delta)
            self._preempt_seen = stats["preempted"]


#: queue waits span sub-second test admissions to hours of real quota
#: starvation; reuse launch-delay-style buckets with a short head
_QUEUE_WAIT_BUCKETS = (0.1, 0.5, 1, 5, 15, 60, 300, 900, 1800, 3600,
                       7200, 14400, 43200)


class SchedulerMetrics:
    """Slice-scheduler instrumentation (docs/scheduling.md): pending work
    per queue, admission/preemption/backfill counters, the queue-wait
    histogram, and the inventory resync health pair (a rising drift count
    means watch events are being lost faster than resyncs repair them)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.pending_gangs = r.gauge(
            "kubedl_scheduler_pending_gangs",
            "Complete gangs waiting for admission, per queue", ("queue",))
        self.held_slices = r.gauge(
            "kubedl_scheduler_held_slices",
            "Slices held by admitted gangs, per queue", ("queue",))
        self.free_slices = r.gauge(
            "kubedl_scheduler_free_slices",
            "Unheld slices per pool (pools with known capacity)", ("pool",))
        self.admitted = r.counter(
            "kubedl_scheduler_admitted_total",
            "Gangs admitted, per queue", ("queue",))
        self.preempted = r.counter(
            "kubedl_scheduler_preempted_total",
            "Gangs evicted to reclaim min quota, per victim queue",
            ("queue",))
        self.backfills = r.counter(
            "kubedl_scheduler_backfills_total",
            "Admissions that jumped a capacity-blocked queue head",
            ("queue",))
        self.passes = r.counter(
            "kubedl_scheduler_passes_total", "Scheduling passes run")
        self.resyncs = r.counter(
            "kubedl_scheduler_inventory_resyncs_total",
            "Full inventory rescans performed")
        self.drift = r.counter(
            "kubedl_scheduler_inventory_drift_total",
            "Rescans that found divergence (lost watch events repaired)")
        self.queue_wait = r.histogram(
            "kubedl_scheduler_queue_wait_seconds",
            "Gang creation to admission, per queue", ("queue",),
            buckets=_QUEUE_WAIT_BUCKETS)
        # placement scoring (docs/scheduling.md "Placement scoring");
        # the families register unconditionally, they only move while
        # the TPUPlacementScoring gate is on
        self.scored_placements = r.counter(
            "kubedl_scheduler_scored_placements_total",
            "Scored gang placements, per chosen pool", ("pool",))
        self.ici_straddled = r.counter(
            "kubedl_scheduler_ici_straddled_total",
            "Scored placements spanning more than one ICI domain",
            ("pool",))


class TelemetryMetrics:
    """Fleet goodput / straggler / throughput-profile families
    (docs/telemetry.md): the operator-facing products distilled from the
    trace spans and metric registries by ``kubedl_tpu_torch.telemetry``. The
    families register unconditionally like TraceMetrics; they only move
    while the FleetTelemetry gate is on (off = all zeroes)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.fleet_goodput = r.gauge(
            "kubedl_goodput_fleet_ratio",
            "Fraction of observed chip wall-clock spent in productive "
            "train.step time, across all retired jobs")
        self.goodput_seconds = r.counter(
            "kubedl_goodput_seconds_total",
            "Retired-job wall-clock seconds by goodput category "
            "(productive plus each overhead bucket)", ("category",))
        self.jobs_observed = r.counter(
            "kubedl_goodput_jobs_observed_total",
            "Retired jobs whose traces were folded into the goodput "
            "accounting")
        self.slow_slices = r.counter(
            "kubedl_telemetry_slow_slices_total",
            "SlowSlice detections (one per skew onset, not per scan)",
            ("kind",))
        self.slow_slice_active = r.gauge(
            "kubedl_telemetry_slow_slice_active",
            "Jobs currently carrying a True SlowSlice condition")
        self.profile_tokens_per_s = r.gauge(
            "kubedl_throughput_profile_tokens_per_s",
            "Online decayed throughput estimate per (profile, pool)",
            ("profile", "pool"))
        self.profile_samples = r.counter(
            "kubedl_throughput_profile_samples_total",
            "Observations folded into each throughput profile",
            ("profile", "pool"))


class SLOMetrics:
    """SLO engine families (docs/slo.md): how much error budget each
    objective has left, the live burn rates behind the multi-window
    verdicts, and alert onsets. Constructed only when the SLOEngine gate
    is on — the disabled operator's exposition carries no ``kubedl_slo_*``
    family at all (the byte-identical-disabled convention)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.budget_remaining = r.gauge(
            "kubedl_slo_budget_remaining_ratio",
            "Error budget left over the objective's compliance window "
            "(1.0 = untouched, 0.0 = spent, negative = violated)",
            ("slo",))
        self.burn_rate = r.gauge(
            "kubedl_slo_burn_rate",
            "Error-budget burn rate per alert window (1.0 = spending "
            "exactly the budget over the compliance window)",
            ("slo", "window"))
        self.alerts = r.counter(
            "kubedl_slo_alerts_total",
            "Burn-rate alert onsets (one per onset, not per evaluation)",
            ("slo", "severity"))
        self.alerts_active = r.gauge(
            "kubedl_slo_alerts_active",
            "Alert severities currently firing per objective", ("slo",))


class DurabilityMetrics:
    """Durable-control-plane families (docs/durability.md): WAL append
    throughput and fsync group-commit latency, snapshot cadence, watch
    relists the bookmark ring could not avoid, and the sharded
    workqueue's per-shard occupancy. Constructed only when the
    DurableControlPlane gate is on — the disabled operator's exposition
    carries none of these families (the byte-identical-disabled
    convention)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.journal_appends = r.counter(
            "kubedl_journal_appends_total",
            "Write-ahead-journal records appended (commits + deletes)")
        self.journal_fsync = r.histogram(
            "kubedl_journal_fsync_seconds",
            "Group-commit fsync latency (one fsync per fsync_every "
            "appended records)", buckets=_LATENCY_BUCKETS)
        self.snapshot_writes = r.counter(
            "kubedl_snapshot_writes_total",
            "Store snapshots serialized (WAL rotations)")
        self.watch_relists = r.counter(
            "kubedl_watch_relists_total",
            "Bookmark-resumed watches that fell back to a full relist, "
            "by reason (too_old = ring evicted the bookmark, "
            "ring_disabled = no event ring on this store)", ("reason",))
        self.shard_owned_keys = r.gauge(
            "kubedl_shard_owned_keys",
            "Live queued request keys per reconcile shard", ("shard",))
        self.journal_recovered = r.gauge(
            "kubedl_journal_recovered_info",
            "Provenance of the last journal recovery (info pattern: "
            "value 1, labels carry which snapshot generation the world "
            "came from and how much WAL tail was replayed) — the "
            "post-crash forensics anchor (docs/forensics.md)",
            ("snapshot_rv", "snapshot_file", "wal_records",
             "torn_records", "objects", "rv"))


class ReplicationMetrics:
    """Replicated-control-plane families (docs/replication.md): how far
    each follower's applied rv trails the leader, the shipping stream's
    volume, promotion count, and the live stream epoch (the fencing
    token — a bumped epoch means a failover happened). Constructed only
    when replication is on (``--replication-followers`` > 0) — the
    disabled operator's exposition carries none of these families (the
    byte-identical-disabled convention)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.follower_lag = r.gauge(
            "kubedl_replication_follower_lag_rv",
            "Leader resourceVersion minus the follower's applied rv "
            "(0 = fully caught up)", ("follower",))
        self.shipped_batches = r.counter(
            "kubedl_replication_shipped_batches_total",
            "Sealed group-commit WAL batches shipped to followers")
        self.shipped_bytes = r.counter(
            "kubedl_replication_shipped_bytes_total",
            "Serialized WAL bytes shipped to followers")
        self.promotions = r.counter(
            "kubedl_replication_promotions_total",
            "Followers promoted to leader after a leader loss")
        self.epoch = r.gauge(
            "kubedl_replication_epoch",
            "Current replication stream epoch (bumped on every "
            "promotion; a follower rejects frames from older epochs)")
        self.stale_frames = r.counter(
            "kubedl_replication_stale_frames_total",
            "Frames rejected for carrying a deposed leader's epoch "
            "(the zombie fence)", ("follower",))


class ElasticMetrics:
    """Concurrency-elastic training families (docs/elastic.md "Elastic
    slices"): restart-free reconfigurations by direction, slices shed by
    the scheduler's shrink pass / regrown on returning capacity, and the
    reconfiguration-window histogram (the shrink analog of restart
    MTTR). Constructed only when the TPUElasticSlices gate is on — the
    disabled operator's exposition carries no ``kubedl_elastic_*``
    family at all (the byte-identical-disabled convention)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.reconfigurations = r.counter(
            "kubedl_elastic_reconfigurations_total",
            "Restart-free world reconfigurations driven to completion, "
            "by direction (shrink / grow)", ("kind", "direction"))
        self.shrunk_slices = r.counter(
            "kubedl_elastic_shrunk_slices_total",
            "Slices shed in place by the scheduler's shrink pass "
            "(surplus-only preemptions; the job kept Running)", ("pool",))
        self.regrown_slices = r.counter(
            "kubedl_elastic_regrown_slices_total",
            "Slices admitted to an already-running elastic gang "
            "(regrow after a shrink, or completing a partial-width "
            "start)", ("pool",))
        self.reconfigure_seconds = r.histogram(
            "kubedl_elastic_reconfigure_seconds",
            "Checkpoint request to reconfigured world (the elastic "
            "analog of restart MTTR)", ("kind",),
            buckets=_MTTR_BUCKETS)


class ServingFleetMetrics:
    """Serving-fleet families (docs/serving_fleet.md): the per-replica
    engine health gauges the ServingAutoscaler consumes (free pool
    blocks, queue depth, active lanes), fleet size / scale events, the
    router's placement counters, and prefill→decode block-table
    handoffs. Constructed only when the ServingFleet gate is on — the
    disabled exposition carries none of these families (the
    byte-identical-disabled convention). ``multi_model=True`` (the
    MultiModelServing gate, docs/multimodel.md) adds the adapter
    families; off, not one ``kubedl_serving_adapter_*`` family exists —
    the same convention, one gate deeper."""

    def __init__(self, registry: Optional[Registry] = None,
                 multi_model: bool = False):
        self.registry = registry or Registry()
        self.multi_model = bool(multi_model)
        r = self.registry
        self.free_blocks = r.gauge(
            "kubedl_serving_free_blocks",
            "Unreferenced KV pool blocks per serving replica (the "
            "autoscaler's memory-pressure signal)", ("replica",))
        self.queue_depth = r.gauge(
            "kubedl_serving_queue_depth",
            "Requests queued per serving replica (admitted to no lane "
            "yet)", ("replica",))
        self.active_lanes = r.gauge(
            "kubedl_serving_active_lanes",
            "Lanes holding an in-flight request per serving replica "
            "(parked prefill lanes included)", ("replica",))
        self.replicas = r.gauge(
            "kubedl_serving_fleet_replicas",
            "Live serving replicas (draining replicas included until "
            "reaped)")
        self.draining = r.gauge(
            "kubedl_serving_fleet_draining",
            "Replicas currently draining (no new placements; in-flight "
            "streams finishing)")
        self.scale_events = r.counter(
            "kubedl_serving_fleet_scale_events_total",
            "Autoscaler actions by direction (up = replica added, "
            "drain = scale-down began, reap = drained replica removed)",
            ("direction",))
        self.router_prefix_hits = r.counter(
            "kubedl_serving_router_prefix_hits_total",
            "Requests placed on a replica already holding their shared "
            "prefix blocks")
        self.router_prefix_misses = r.counter(
            "kubedl_serving_router_prefix_misses_total",
            "Prefix-bearing requests placed on a replica without their "
            "prefix resident")
        self.router_tenant_spills = r.counter(
            "kubedl_serving_router_tenant_spills_total",
            "Placements diverted off the preferred replica because the "
            "tenant's queue already held its fair share there",
            ("queue",))
        self.handoffs = r.counter(
            "kubedl_serving_prefill_handoffs_total",
            "Prefill→decode block-table handoffs per replica "
            "(disaggregated lanes only)", ("replica",))
        if self.multi_model:
            self.adapter_faults = r.counter(
                "kubedl_serving_adapter_faults_total",
                "Cold adapter fault-ins through the paged pool by model "
                "(a resident adapter costs none; the router-quality "
                "signal)", ("model",))
            self.adapter_resident = r.gauge(
                "kubedl_serving_adapter_resident",
                "Adapters currently resident per serving replica",
                ("replica",))
            self.adapter_pages = r.gauge(
                "kubedl_serving_adapter_pages",
                "Pool blocks pinned by resident adapter weights per "
                "serving replica (HBM shared with KV blocks)",
                ("replica",))
        self._handoffs_seen: dict = {}
        self._adapter_faults_seen: dict = {}
        self._replicas_seen: set = set()

    def note_reaped(self, replica: str, handoffs_total: int,
                    adapter_faults: Optional[dict] = None) -> None:
        """Flush a reaped replica's final handoff delta into the counter
        BEFORE its engine disappears from ``fleet.health()`` — without
        this, handoffs performed between the last refresh and the reap
        would vanish from the exposition (the bench's fleet-lifetime
        rollup keeps them, and the two must agree). ``adapter_faults``
        (a per-model dict) does the same for a multi-model replica's
        fault counters."""
        delta = handoffs_total - self._handoffs_seen.pop(replica, 0)
        if delta > 0:
            self.handoffs.inc(delta, replica=replica)
        if self.multi_model:
            for model, total in (adapter_faults or {}).items():
                d = total - self._adapter_faults_seen.pop(
                    (replica, model), 0)
                if d > 0:
                    self.adapter_faults.inc(d, model=model)
            self._adapter_faults_seen = {
                k: v for k, v in self._adapter_faults_seen.items()
                if k[0] != replica}

    def refresh(self, fleet) -> None:
        """Push one fleet health snapshot (gauges per live replica;
        series of reaped replicas are removed, not frozen)."""
        live = set()
        draining = 0
        for h in fleet.health():
            name = h["replica"]
            live.add(name)
            if h.get("draining"):
                draining += 1
            self.free_blocks.set(h.get("free_blocks") or 0, replica=name)
            self.queue_depth.set(h["queue_depth"], replica=name)
            self.active_lanes.set(h["active_lanes"], replica=name)
            delta = h["handoffs"] - self._handoffs_seen.get(name, 0)
            if delta > 0:
                self.handoffs.inc(delta, replica=name)
                self._handoffs_seen[name] = h["handoffs"]
            if self.multi_model and "resident_adapters" in h:
                self.adapter_resident.set(
                    h["resident_adapters"], replica=name)
                self.adapter_pages.set(h["adapter_pages"], replica=name)
                for model, total in (h.get("adapter_faults")
                                     or {}).items():
                    d = total - self._adapter_faults_seen.get(
                        (name, model), 0)
                    if d > 0:
                        self.adapter_faults.inc(d, model=model)
                        self._adapter_faults_seen[(name, model)] = total
        for name in self._replicas_seen - live:
            self.free_blocks.remove(replica=name)
            self.queue_depth.remove(replica=name)
            self.active_lanes.remove(replica=name)
            self._handoffs_seen.pop(name, None)
            if self.multi_model:
                # a reaped replica's per-replica adapter series go with
                # it (fault totals were flushed by note_reaped)
                self.adapter_resident.remove(replica=name)
                self.adapter_pages.remove(replica=name)
                self._adapter_faults_seen = {
                    k: v for k, v in self._adapter_faults_seen.items()
                    if k[0] != name}
        self._replicas_seen = live
        self.replicas.set(len(live))
        self.draining.set(draining)


class FederationMetrics:
    """Multi-region federation families (docs/federation.md): the
    cross-region WAL shipping stream's retry/exhaustion counters, global
    queue-routing decisions, evacuation outcomes, and the follower-read
    path. Constructed only when the Federation gate is on — the disabled
    operator's exposition carries no ``kubedl_federation_*`` family at
    all (the byte-identical-disabled convention)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.ship_retries = r.counter(
            "kubedl_federation_ship_retries_total",
            "Cross-region WAL ship attempts retried after a transient "
            "failure (exponential backoff; bounded)", ("region",))
        self.ship_frames = r.counter(
            "kubedl_federation_ship_frames_total",
            "Cross-region WAL frames delivered to a peer region's "
            "standby", ("region",))
        self.ship_exhausted = r.counter(
            "kubedl_federation_ship_exhausted_total",
            "Frames abandoned after the retry budget ran out (a Warning "
            "Event fires; the standby catches up by snapshot resync)",
            ("region",))
        self.jobs_routed = r.counter(
            "kubedl_federation_jobs_routed_total",
            "Jobs landed by the global router, by chosen region",
            ("region",))
        self.jobs_evacuated = r.counter(
            "kubedl_federation_jobs_evacuated_total",
            "Jobs emigrated out of a dead region (object-store restore "
            "in a survivor)", ("region",))
        self.follower_reads = r.counter(
            "kubedl_federation_follower_reads_total",
            "Cross-region reads served from a peer region's standby",
            ("region",))
        self.read_redirects = r.counter(
            "kubedl_federation_read_redirects_total",
            "Cross-region reads redirected because the standby was "
            "mid-promotion (never a torn read)", ("region",))
        self.streams_rerouted = r.counter(
            "kubedl_federation_streams_rerouted_total",
            "Serving streams re-homed off a dead region's catalog "
            "partition", ("region",))
        self.regions_down = r.gauge(
            "kubedl_federation_regions_down",
            "Regions currently evacuated")


class RLMetrics:
    """RL post-training flywheel families (docs/rl.md): rollout-tenant
    throughput against its declared floor, rollout batches consumed by
    the learner, the off-policy staleness gap, weight publishes rolled
    across the fleet, and floor violations. Constructed only when the
    RLFlywheel gate is on — the disabled operator's exposition carries
    no ``kubedl_rl_*`` family at all (the byte-identical-disabled
    convention)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.rollout_tokens_per_s = r.gauge(
            "kubedl_rl_rollout_tokens_per_s",
            "Rollout generation throughput per RLJob (decode tokens "
            "completed through the fleet, windowed)", ("job",))
        self.batches_consumed = r.counter(
            "kubedl_rl_batches_consumed_total",
            "Versioned rollout batches the learner has stepped on",
            ("job",))
        self.staleness = r.gauge(
            "kubedl_rl_staleness",
            "Off-policy gap per RLJob: learner policy version minus the "
            "version that generated the batch being consumed", ("job",))
        self.publishes = r.counter(
            "kubedl_rl_publishes_total",
            "Policy weight versions rolled across the serving fleet "
            "(publish-between-drains; never a torn version)", ("job",))
        self.floor_violations = r.counter(
            "kubedl_rl_floor_violations_total",
            "Observation windows where rollout throughput fell below "
            "the RLJob's declared floor (flash crowds squeezing the "
            "rollout tenant)", ("job",))


class TraceMetrics:
    """Span-recorder health (docs/tracing.md): recorded-span throughput
    per component, ring-buffer occupancy, and the overflow-drop counter
    (a rising drop rate means the buffer is undersized for the span
    volume — raise ``--trace-buffer`` capacity or narrow what's traced).
    Maintained by :class:`kubedl_tpu_torch.trace.Tracer` only while tracing is
    enabled; with the gate off the families exist but stay at zero."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.spans = r.counter(
            "kubedl_trace_spans_total",
            "Spans recorded, by instrumented component", ("component",))
        self.dropped = r.counter(
            "kubedl_trace_spans_dropped_total",
            "Spans evicted from the ring buffer on overflow")
        self.buffered = r.gauge(
            "kubedl_trace_buffer_spans",
            "Spans currently held in the ring buffer")


#: job launch delays at fleet scale INCLUDE queue wait (the admission
#: gate holds pod creation until the scheduler admits the gang), so the
#: distribution runs from sub-second test admissions to hours of quota
#: starvation. The generic ``_DEFAULT_BUCKETS`` top out at 600s — under
#: the measured fleet-shape queue delays (BENCH_SCHEDULER.json p50
#: 295-595s) that clamps most of the mass into +Inf.
_JOB_DELAY_BUCKETS = (0.5, 1, 2.5, 5, 10, 30, 60, 120, 300, 600,
                      1200, 1800, 3600, 7200, 14400, 43200)

#: restart MTTR runs from seconds (in-place slice recreation) through
#: backoff rounds and a re-queue stint to, pathologically, hours
_MTTR_BUCKETS = (1, 2.5, 5, 10, 20, 40, 60, 120, 300, 600,
                 1200, 1800, 3600, 7200)


class JobMetrics:
    """The reference's per-kind job metric set (``pkg/metrics/job_metrics.go``)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.created = r.counter("kubedl_jobs_created", "Counts number of jobs created", ("kind",))
        self.deleted = r.counter("kubedl_jobs_deleted", "Counts number of jobs deleted", ("kind",))
        self.successful = r.counter("kubedl_jobs_successful", "Counts number of jobs successfully finished", ("kind",))
        self.failed = r.counter("kubedl_jobs_failed", "Counts number of jobs failed", ("kind",))
        self.restarted = r.counter("kubedl_jobs_restarted", "Counts number of jobs restarted", ("kind",))
        self.running = r.gauge("kubedl_jobs_running", "Counts number of jobs running currently", ("kind",))
        self.pending = r.gauge("kubedl_jobs_pending", "Counts number of jobs pending currently", ("kind",))
        self.first_pod_launch_delay = r.histogram(
            "kubedl_jobs_first_pod_launch_delay_seconds",
            "Histogram for recording launch delay duration (from job created to first pod running)",
            ("kind",), buckets=_JOB_DELAY_BUCKETS)
        self.all_pods_launch_delay = r.histogram(
            "kubedl_jobs_all_pods_launch_delay_seconds",
            "Histogram for recording launch delay duration (from job created to all pods running)",
            ("kind",), buckets=_JOB_DELAY_BUCKETS)
        # TPU-native: the operator half of gang-schedule-to-first-step
        self.gang_to_all_running = r.histogram(
            "kubedl_jobs_gang_schedule_to_all_running_seconds",
            "Histogram from gang (PodGroup) creation to all slice workers running",
            ("kind",), buckets=_JOB_DELAY_BUCKETS)
        # TPU-native: slice disruption -> every replica active again (the
        # whole outage window: teardown + backoff + re-queue + recreate +
        # rendezvous). The engine marks the outage start when it stamps a
        # restart round and observes here on the first all-active
        # reconcile after it.
        self.restart_mttr = r.histogram(
            "kubedl_jobs_restart_mttr_seconds",
            "Histogram from slice disruption to all replicas active again",
            ("kind",), buckets=_MTTR_BUCKETS)
