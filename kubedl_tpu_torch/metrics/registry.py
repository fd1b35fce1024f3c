"""Metrics registry with Prometheus text exposition.

Copied from ``kubedl_tpu/metrics/registry.py`` (the port imports nothing
from the JAX package): ``Registry``, ``Counter``, ``Gauge`` and
``Histogram``; ``PagedKVMetrics``, the part the predictor server's
``/metrics`` uses; and the families the replays record into:
``TraceMetrics`` (the span recorder's health), ``ServingFleetMetrics``
(replica health, router placements, prefill handoffs) and ``RLMetrics``
(the RL flywheel's rollout floor, staleness and publishes).
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


class PagedKVMetrics:
    """Paged KV-cache pool instrumentation for the serving predictor's
    ``/metrics``: pool occupancy (capacity planning), the shared-block
    ratio (how much memory prefix copy-on-write sharing is saving), and
    the preemption counter (a rising rate means the pool is undersized
    for the offered load). Refreshed from the engine's ``pool_stats()``
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
