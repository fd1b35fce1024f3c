"""ServingAutoscaler: SLO-driven replica-count reconcile.

The operator side of the serving fleet (docs/serving_fleet.md). Its
control inputs are exactly the signals the fleet already produces —
nothing bench-local, nothing re-derived:

* the SLO engine's burn-rate VERDICTS (docs/slo.md): a firing
  page-severity alert on any serving objective is the primary
  scale-up trigger — the fleet is burning its error budget at page
  pace, add capacity *now*;
* each replica's paged-pool **free-block gauge** (the engines'
  ``health()`` / ``kubedl_serving_free_blocks``): a pool running dry
  while work queues means admissions are block-starved, not
  lane-starved — more lanes on the same replica would not help, a new
  replica (a new pool) does;
* **queue depth** per replica: sustained backlog beyond what the
  active lanes drain.

Scale-down never drops a stream: the youngest replica is DRAINED — the
router stops placing onto it, its queue and lanes run to completion —
and only an idle drained replica is reaped. ``step(now)`` is a
reconcile: idempotent, clock-driven, safe to call at any cadence
(cooldowns bound the actuation rate, not the observation rate).

Copied from ``kubedl_tpu/controllers/servingfleet.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    #: replicas added per scale-up actuation
    scale_up_step: int = 1
    #: mean queue depth per active replica that reads as backlog
    queue_high: int = 6
    #: free-block floor: at or under this (with work queued) the pool
    #: is the bottleneck
    free_blocks_low: int = 4
    #: adapter fault-ins per reconcile (summed over active replicas)
    #: that read as residency thrash on a multi-model fleet
    #: (docs/multimodel.md); 0 disables the signal
    adapter_faults_high: int = 0
    #: seconds between actuations (either direction)
    cooldown_s: float = 60.0
    #: quiet seconds (no pressure, no firing alert, empty queues)
    #: before a scale-down drain begins
    scale_down_idle_s: float = 300.0


@dataclass
class _ScaleEvent:
    t: float
    action: str                         # up | drain | reap
    detail: str = ""
    replicas: int = 0

    def to_dict(self) -> dict:
        return {"t": round(self.t, 3), "action": self.action,
                "detail": self.detail, "replicas": self.replicas}


class ServingAutoscaler:
    """Reconcile loop over a :class:`ServingFleet`."""

    def __init__(self, fleet, slo=None, config: Optional[AutoscalerConfig]
                 = None, clock=None, metrics=None):
        self.fleet = fleet
        #: SLOEvaluator whose serving objectives gate the fleet
        #: (headless or api-backed; only ``statuses()`` is read)
        self.slo = slo
        self.config = config or AutoscalerConfig()
        self.clock = clock
        self.metrics = metrics
        self.scale_ups = 0
        self.drains = 0
        self.reaped = 0
        self.log: list = []
        self._last_actuation = float("-inf")
        self._quiet_since: Optional[float] = None
        #: fleet-wide adapter fault-ins seen at the last reconcile (the
        #: multi-model pressure signal is the DELTA, not the lifetime
        #: total — a fleet that thrashed yesterday is not thrashing now)
        self._adapter_faults_seen = 0

    # -- signals ----------------------------------------------------------

    def page_firing(self) -> bool:
        """Any page-severity burn-rate alert currently firing across
        the registered objectives (the SLO engine's verdict, not a
        re-derivation of its window math)."""
        if self.slo is None:
            return False
        for s in self.slo.statuses():
            if "invalid" in s:
                continue
            page = (s.get("alerts") or {}).get("page")
            if page and page.get("firing"):
                return True
        return False

    def _pressure(self) -> Optional[str]:
        """The scale-up verdict with its reason, or None."""
        if self.page_firing():
            return "page-severity burn"
        active = [h for h in self.fleet.health() if not h["draining"]]
        if not active:
            return "no active replica"
        qd = sum(h["queue_depth"] for h in active)
        if qd > self.config.queue_high * len(active):
            return f"queue depth {qd} over {len(active)} replicas"
        frees = [h["free_blocks"] for h in active
                 if h["free_blocks"] is not None]
        if frees and min(frees) <= self.config.free_blocks_low and qd > 0:
            return (f"free blocks at {min(frees)} with {qd} queued "
                    "(pool-starved)")
        if self.config.adapter_faults_high > 0:
            # multi-model residency thrash: too many cold adapter
            # fault-ins since the last reconcile while work is queued
            # means the catalog's working set no longer fits the
            # fleet's pools — a new replica adds a pool AND another
            # consistent-hash home to partition the catalog over
            total = sum(sum((h.get("adapter_faults") or {}).values())
                        for h in self.fleet.health())
            total += getattr(self.fleet, "reaped_adapter_faults", 0)
            delta = max(total - self._adapter_faults_seen, 0)
            self._adapter_faults_seen = max(total,
                                            self._adapter_faults_seen)
            if delta >= self.config.adapter_faults_high and qd > 0:
                return (f"{delta} adapter fault-ins since last "
                        "reconcile (residency thrash)")
        return None

    # -- the reconcile ----------------------------------------------------

    def step(self, now: Optional[float] = None) -> list:
        """One reconcile pass; returns the actions actuated (strings).
        Reaping is unconditional (an idle drained replica is dead
        weight); scale up/down honor the cooldown."""
        now = self.clock() if now is None and self.clock is not None \
            else (now or 0.0)
        cfg = self.config
        actions = []
        for name in self.fleet.reap():
            self.reaped += 1
            actions.append(f"reap {name}")
            self.log.append(_ScaleEvent(now, "reap", name,
                                        self.fleet.size))
            if self.metrics is not None:
                self.metrics.scale_events.inc(direction="reap")
        reason = self._pressure()
        active = len(self.fleet.active())
        if reason is not None:
            self._quiet_since = None
            if active < cfg.max_replicas \
                    and now - self._last_actuation >= cfg.cooldown_s:
                # a draining replica is instant capacity (its engine
                # never stopped): un-drain it before paying for a fresh
                # replica — and count it as an up actuation either way
                undrained = self.fleet.cancel_drain()
                if undrained is not None:
                    actions.append(
                        f"undrain {undrained.name} ({reason})")
                    self.log.append(_ScaleEvent(now, "undrain", reason,
                                                self.fleet.size))
                    if self.metrics is not None:
                        self.metrics.scale_events.inc(
                            direction="undrain")
                else:
                    for _ in range(min(
                            cfg.scale_up_step,
                            cfg.max_replicas - self.fleet.size)):
                        rep = self.fleet.add_replica()
                        actions.append(
                            f"scale-up {rep.name} ({reason})")
                    self.log.append(_ScaleEvent(now, "up", reason,
                                                self.fleet.size))
                    if self.metrics is not None:
                        self.metrics.scale_events.inc(direction="up")
                self.scale_ups += 1
                self._last_actuation = now
        else:
            busy = any(h["queue_depth"] or h["active_lanes"]
                       for h in self.fleet.health() if not h["draining"])
            if busy:
                self._quiet_since = None
            elif self._quiet_since is None:
                self._quiet_since = now
            elif now - self._quiet_since >= cfg.scale_down_idle_s \
                    and active > cfg.min_replicas \
                    and now - self._last_actuation >= cfg.cooldown_s:
                rep = self.fleet.begin_drain()
                if rep is not None:
                    self.drains += 1
                    self._last_actuation = now
                    self._quiet_since = now
                    actions.append(f"drain {rep.name}")
                    self.log.append(_ScaleEvent(now, "drain", rep.name,
                                                self.fleet.size))
                    if self.metrics is not None:
                        self.metrics.scale_events.inc(direction="drain")
        self.fleet.refresh_metrics()
        return actions

    def status(self) -> dict:
        """The console's autoscaler block (docs/serving_fleet.md)."""
        return {
            "config": {
                "minReplicas": self.config.min_replicas,
                "maxReplicas": self.config.max_replicas,
                "cooldownSeconds": self.config.cooldown_s,
            },
            "scaleUps": self.scale_ups,
            "drains": self.drains,
            "reaped": self.reaped,
            "pageFiring": self.page_firing(),
            "events": [e.to_dict() for e in self.log],
        }


__all__ = ["AutoscalerConfig", "ServingAutoscaler"]
