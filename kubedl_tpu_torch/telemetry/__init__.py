"""Fleet goodput & straggler telemetry (docs/telemetry.md).

The observability stack's distillation layer: the lifecycle traces and the
metric registries record *what happened*; this package turns them into
the four operator-facing products the fleet questions actually need —

* **goodput accounting** (:mod:`.goodput`) — per-job and fleet-aggregate
  decomposition of wall-clock into productive ``train.step`` time vs
  queue / scheduling / pod-start / rendezvous / restart / checkpoint
  overhead, harvested from lifecycle traces at job retirement;
* **online throughput profiles** (:mod:`.profiles`) — per-(job-kind or
  model, pool) decayed tokens/s estimates from trainer step spans and
  serving ``decode_tokens_per_s``, persisted as cluster-scoped
  ThroughputProfile objects for the scheduler to consume;
* **straggler detection** (:mod:`.straggler`) — cross-replica step-time
  skew raises a ``SlowSlice`` job condition + Event, cleared when the
  skew stops;
* the **pending-job explainer** (:mod:`.explainer`) — a structured "why
  is this job not running" verdict computed read-only from live
  ``SliceScheduler`` state, served at ``/api/v1/explain/{ns}/{job}``.

Feature-gated off by default (``--enable-telemetry`` / the
``FleetTelemetry`` gate); the disabled operator carries no telemetry
object at all, so the cost is literally one ``is None`` check per hook.

Copied from ``kubedl_tpu/telemetry/__init__.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import logging
from typing import Optional

from ..core import meta as m
from ..trace import job_trace_context, restart_mttrs, trace_breakdown
from .explainer import explain_pending  # noqa: F401
from .goodput import (GoodputAccountant, OVERHEAD_CATEGORIES,  # noqa: F401
                      goodput_breakdown)
from .profiles import ThroughputProfileStore  # noqa: F401
from .slo import (REASON_SLO_BURN, REASON_SLO_RECOVERED,  # noqa: F401
                  SLO_BURN_RATE, SLOEvaluator)
from .straggler import (JOB_SLOW_SLICE, REASON_SLOW_SLICE,  # noqa: F401
                        REASON_SLOW_SLICE_RESOLVED, StragglerDetector)

log = logging.getLogger("kubedl_tpu_torch.telemetry")

__all__ = [
    "FleetTelemetry", "GoodputAccountant", "JOB_SLOW_SLICE",
    "OVERHEAD_CATEGORIES", "REASON_SLOW_SLICE",
    "REASON_SLOW_SLICE_RESOLVED", "REASON_SLO_BURN",
    "REASON_SLO_RECOVERED", "SLO_BURN_RATE", "SLOEvaluator",
    "StragglerDetector", "ThroughputProfileStore", "explain_pending",
    "goodput_breakdown", "job_pool",
]


def job_pool(job: dict) -> str:
    """The scheduler-pool key of a job's slices
    (``gke-accelerator/topology``, the same string the inventory and the
    gang annotations use), derived from ``spec.tpuPolicy``; "" for
    CPU-only jobs or unparseable shapes (profiles then aggregate under
    the unknown pool)."""
    accel = m.get_in(job, "spec", "tpuPolicy", "acceleratorType",
                     default="")
    if not accel:
        return ""
    try:
        from ..tpu import topology as topo
        spec = topo.parse_accelerator(str(accel))
        return f"{spec.gke_accelerator}/{spec.topology_str}"
    except (ValueError, KeyError):
        return ""


class FleetTelemetry:
    """The operator-side bundle the engines/console talk to. One instance
    per operator when the gate is on; None when off (every call site is
    ``if telemetry is not None``)."""

    def __init__(self, api, tracer, metrics=None, recorder=None,
                 job_kinds=(), scan_interval_s: float = 30.0,
                 profile_halflife_s: float = 3600.0,
                 skew_factor: float = 2.0, slo=None):
        self.api = api
        self.tracer = tracer
        self.metrics = metrics
        self.goodput = GoodputAccountant(metrics=metrics)
        self.profiles = ThroughputProfileStore(
            halflife_s=profile_halflife_s, clock=api.now, metrics=metrics)
        self.straggler = StragglerDetector(
            api, tracer, recorder=recorder, metrics=metrics,
            job_kinds=job_kinds, skew_factor=skew_factor)
        #: the SLO engine (docs/slo.md) when the SLOEngine gate is on;
        #: None otherwise — telemetry can run without judgment
        self.slo = slo
        if slo is not None and slo.goodput is None:
            # the fleet_goodput gauge signal reads this bundle's accountant
            slo.goodput = self.goodput
        self.scan_interval_s = float(scan_interval_s)
        self._next_scan = 0.0
        self._harvested: set = set()
        self.profiles.load(api)

    # -- retirement harvest (engine terminal path) ----------------------

    def on_job_terminal(self, job: dict) -> Optional[dict]:
        """Distill one finished job's trace: goodput decomposition +
        throughput-profile observations. Idempotent per job UID; returns
        the per-job goodput dict (None when the job left no trace)."""
        uid = m.uid(job) or f"{m.namespace(job)}/{m.name(job)}"
        if uid in self._harvested:
            return None
        self._harvested.add(uid)
        tid, _root = job_trace_context(job)
        spans = self.tracer.spans(trace_id=tid)
        if not spans:
            return None
        bd = trace_breakdown(spans, tid, dropped=self.tracer.dropped)
        gp = self.goodput.observe(bd)
        if self.slo is not None:
            # lifecycle-trace signals (docs/slo.md): one queue-delay
            # sample per retired job, one restart-MTTR sample per outage
            now = self.api.now()
            labels = {"queue": self._job_queue(job),
                      "kind": job.get("kind") or ""}
            self.slo.observe("queue_delay",
                             bd["byPhase"].get("Queuing", 0.0), now,
                             labels)
            for v in restart_mttrs(bd["phases"]):
                self.slo.observe("restart_mttr", v, now, labels)
        pool = job_pool(job)
        default_key = (job.get("kind") or "job").lower()
        for s in spans:
            if s.component == "train" and s.name == "train.step" \
                    and s.duration > 0 and "tokens" in s.attributes:
                key = str(s.attributes.get("model") or default_key)
                try:
                    self.profiles.observe(key, pool,
                                          float(s.attributes["tokens"]),
                                          s.duration, now=s.end)
                except (TypeError, ValueError):
                    continue
        self.profiles.flush(self.api)
        return gp

    def forget(self, uid: str) -> None:
        """Drop the harvest-dedup entry for a deleted job (keeps the set
        bounded across a long-lived operator)."""
        self._harvested.discard(uid)

    # -- serving signal --------------------------------------------------

    def observe_serving_stats(self, model: str, pool: str,
                              stats: dict) -> None:
        """Fold one serving stats snapshot (``decode_tokens_per_s``) into
        the model's profile — the serving half of the Gavel currency."""
        tps = (stats or {}).get("decode_tokens_per_s", 0.0)
        if tps and tps > 0:
            self.profiles.observe_rate(str(model or "serving").lower(),
                                       pool, float(tps))

    # -- straggler scan driver -------------------------------------------

    def maybe_scan(self, now: Optional[float] = None) -> Optional[list]:
        """Rate-limited :meth:`StragglerDetector.scan` (engines call this
        once per reconcile; one scan per interval actually runs). The
        SLO engine's own rate-limited evaluation rides the same hook."""
        now = self.api.now() if now is None else now
        if self.slo is not None:
            self.slo.maybe_evaluate(now)
        if now < self._next_scan:
            return None
        self._next_scan = now + self.scan_interval_s
        return self.straggler.scan()

    @staticmethod
    def _job_queue(job: dict) -> str:
        """The queue a job's gangs route to (the scheduler's own routing
        rule), labelling its SLO samples for tenant/queue selectors.
        Kinds disagree on where runPolicy lives (some inline its fields
        directly into spec), so both shapes are read."""
        from ..api.common import SchedulingPolicy
        from ..scheduling.queue import job_queue_name
        sp = (m.get_in(job, "spec", "runPolicy", "schedulingPolicy")
              or m.get_in(job, "spec", "schedulingPolicy"))
        return job_queue_name(job, SchedulingPolicy.from_dict(sp)
                              if sp else None)
