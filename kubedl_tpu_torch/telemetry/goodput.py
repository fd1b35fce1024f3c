"""Goodput accounting: where did the fleet's chip wall-clock go?

"Goodput" is the fraction of a job's wall-clock (creation → terminal)
spent in **productive training** — the ``Running`` lifecycle phase minus
time the trainer spent checkpointing — as opposed to the overhead
buckets every operator question starts from: queue wait, scheduling
decision gaps, pod start, PJRT rendezvous, restart rounds. The
decomposition is derived entirely from the job's lifecycle trace at
retirement (``trace_breakdown`` — the phase spans partition the job's
wall-clock by construction, docs/tracing.md), so the components sum to
the trace wall-clock to within float error; nothing is re-measured.

Categories (docs/telemetry.md has the full definition table)::

    productive   Running            − train.checkpoint span time
    queue        Queuing            (initial + every re-queue stint)
    scheduling   Created, Admitted  (operator pickup + admission→pods gap)
    podStart     PodsCreated
    rendezvous   Rendezvous
    restart      Restarting         (teardown + backoff + recreate)
    checkpoint   Σ train.checkpoint span durations (carved from Running)
    other        any phase outside the vocabulary (forward-compat)

Copied from ``kubedl_tpu/telemetry/goodput.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

#: lifecycle phase -> overhead bucket (Running is handled separately;
#: terminal phases are zero-duration points)
_PHASE_CATEGORY = {
    "Queuing": "queue",
    "Created": "scheduling",
    "Admitted": "scheduling",
    "PodsCreated": "podStart",
    "Rendezvous": "rendezvous",
    "Restarting": "restart",
}

#: every overhead bucket, in stable output order. ``reconfiguration`` is
#: the elastic shrink/regrow window (docs/elastic.md): the
#: ``elastic.reconfigure`` spans the engine records while a job
#: reshapes its world WITHOUT leaving Running — carved out of the
#: productive bucket exactly like checkpoint time, so a restart-free
#: resize is still honestly accounted as overhead, just a much smaller
#: one than the restart round it replaces.
OVERHEAD_CATEGORIES = ("queue", "scheduling", "podStart", "rendezvous",
                       "restart", "checkpoint", "reconfiguration", "other")

#: LAZY category (docs/rl.md): rollout-generation windows (``rl.rollout``
#: spans, component ``rl``) are carved from productive time exactly like
#: checkpoint/reconfiguration — the learner is waiting on the serving
#: fleet, not training — but the key appears in a breakdown ONLY when
#: such spans exist. Non-RL jobs (and every committed pre-RL scorecard)
#: keep their exact ``overheadSeconds`` shape.
ROLLOUT_CATEGORY = "rollout"


def goodput_breakdown(breakdown: dict, ndigits: int = 6) -> Optional[dict]:
    """Fold one job's ``trace_breakdown`` dict into the goodput
    decomposition, or None when the trace carries no phase spans (job
    never traced / tracing enabled mid-flight)."""
    by_phase = breakdown.get("byPhase") or {}
    if not by_phase:
        return None
    overhead = {k: 0.0 for k in OVERHEAD_CATEGORIES}
    productive = 0.0
    for phase, seconds in by_phase.items():
        if phase == "Running":
            productive += seconds
        elif phase in ("Succeeded", "Failed"):
            continue                      # zero-duration terminal points
        else:
            overhead[_PHASE_CATEGORY.get(phase, "other")] += seconds
    # checkpoint time is carved OUT of the productive bucket (the trainer
    # records train.checkpoint spans inside the Running window), so the
    # decomposition total is preserved; elastic reconfiguration windows
    # (engine elastic.reconfigure spans, docs/elastic.md) are carved the
    # same way
    ckpt = sum(e.get("duration", 0.0)
               for e in breakdown.get("events") or []
               if e.get("component") == "train"
               and e.get("name") == "train.checkpoint")
    ckpt = min(ckpt, productive)
    productive -= ckpt
    overhead["checkpoint"] = ckpt
    reconf = sum(e.get("duration", 0.0)
                 for e in breakdown.get("events") or []
                 if e.get("component") == "engine"
                 and e.get("name") == "elastic.reconfigure")
    reconf = min(reconf, productive)
    productive -= reconf
    overhead["reconfiguration"] = reconf
    rollout = sum(e.get("duration", 0.0)
                  for e in breakdown.get("events") or []
                  if e.get("component") == "rl"
                  and e.get("name") == "rl.rollout")
    if rollout:
        rollout = min(rollout, productive)
        productive -= rollout
        overhead[ROLLOUT_CATEGORY] = rollout
    wall = productive + sum(overhead.values())
    return {
        "wallSeconds": round(wall, ndigits),
        "productiveSeconds": round(productive, ndigits),
        "goodput": round(productive / wall, ndigits) if wall > 0 else 0.0,
        "overheadSeconds": {k: round(v, ndigits)
                            for k, v in overhead.items()},
        "restartRounds": sum(1 for p in breakdown.get("phases") or []
                             if p.get("name") == "Restarting"),
    }


class GoodputAccountant:
    """Fleet-aggregate goodput over retired jobs.

    ``observe`` folds one job's trace breakdown in (weighting by
    wall-clock seconds, so a day-long job counts more than a smoke
    test); gauges on :class:`~kubedl_tpu_torch.metrics.registry
    .TelemetryMetrics` track the running aggregate. Pure accumulation —
    deterministic given a deterministic observation order, which is what
    lets the cluster replay put ``fleet_goodput`` on the scorecard."""

    def __init__(self, metrics=None):
        self.metrics = metrics
        self.jobs = 0
        self.productive_s = 0.0
        self.overhead_s = {k: 0.0 for k in OVERHEAD_CATEGORIES}

    def observe(self, breakdown: dict) -> Optional[dict]:
        """Fold one retired job's ``trace_breakdown`` in; returns the
        per-job decomposition (also what the console job detail shows)."""
        gp = goodput_breakdown(breakdown)
        if gp is None:
            return None
        self.jobs += 1
        self.productive_s += gp["productiveSeconds"]
        for k, v in gp["overheadSeconds"].items():
            # .get: the lazy rollout category appears only on RL jobs
            self.overhead_s[k] = self.overhead_s.get(k, 0.0) + v
        if self.metrics is not None:
            mt = self.metrics
            mt.jobs_observed.inc()
            if gp["productiveSeconds"]:
                mt.goodput_seconds.inc(gp["productiveSeconds"],
                                       category="productive")
            for k, v in gp["overheadSeconds"].items():
                if v:
                    mt.goodput_seconds.inc(v, category=k)
            mt.fleet_goodput.set(self.fleet_goodput())
        return gp

    def wall_seconds(self) -> float:
        return self.productive_s + sum(self.overhead_s.values())

    def fleet_goodput(self) -> float:
        wall = self.wall_seconds()
        return self.productive_s / wall if wall > 0 else 0.0

    def summary(self, ndigits: int = 4) -> dict:
        """Deterministic fleet rollup (the scorecard's ``goodput``
        block)."""
        return {
            "jobsObserved": self.jobs,
            "fleetGoodput": round(self.fleet_goodput(), ndigits),
            "productiveSeconds": round(self.productive_s, 1),
            "wallSeconds": round(self.wall_seconds(), 1),
            "overheadSeconds": {k: round(v, 1)
                                for k, v in self.overhead_s.items()},
        }
