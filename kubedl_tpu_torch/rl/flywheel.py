"""RLFlywheel: one RLJob's closed loop, composed and reconciled.

Glue for the three halves (docs/rl.md): harvest a finished rollout
generation into the learner, publish on the RLJob's cadence
(``publishEvery`` batches), tick the publisher's roll, and submit the
next generation pinned to the freshest version the fleet serves. One
``step(now)`` is a reconcile — idempotent, sim-clock driven, safe at
any cadence — so the replay ticks it right next to the autoscaler's.

The flywheel also owns the RLJob's OBSERVABILITY surface:

* the throughput floor (``rolloutFloorTokensPerSecond``): per
  observation window, harvested completion tokens / elapsed — below
  the floor counts a violation (the flash crowd squeezed the rollout
  tenant past its declared minimum; the spec said how much squeeze is
  acceptable);
* ``rl.rollout`` trace spans (component ``rl``), one per generation —
  the telemetry layer carves these out of productive time as the
  ``rollout`` goodput category;
* :meth:`status` — the console's ``/api/v1/rl/{ns}/{job}`` body.

Copied from ``kubedl_tpu/rl/flywheel.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from typing import Callable, Optional


class RLFlywheel:
    """Drive rollouts -> learner -> publisher for one RLJob."""

    def __init__(self, namespace: str, name: str, rollouts, learner,
                 publisher, next_prompts: Callable,
                 publish_every: int = 2,
                 rollout_floor_tokens_per_s: float = 0.0,
                 clock: Optional[Callable] = None, metrics=None,
                 tracer=None):
        self.namespace = namespace
        self.name = name
        self.rollouts = rollouts
        self.learner = learner
        self.publisher = publisher
        #: ``next_prompts() -> list[token_list] | None`` — the RLJob's
        #: prompt stream; None pauses submission (exhausted or gated)
        self.next_prompts = next_prompts
        self.publish_every = max(int(publish_every), 1)
        self.floor = float(rollout_floor_tokens_per_s)
        self.clock = clock or (lambda: 0.0)
        self.metrics = metrics
        self.tracer = tracer
        self.floor_violations = 0
        self.rate_last: Optional[float] = None
        self._published_at_batch = 0
        self._gen_started: Optional[float] = None
        self._win_t: Optional[float] = None
        self._win_tokens = 0

    # -- the loop ---------------------------------------------------------

    def serving_version(self) -> int:
        """The freshest policy version any active replica advertises —
        what the next generation pins to. Mid-publish this is already
        the new version (its replicas are placement candidates the
        moment each swap commits), so staleness shrinks as the roll
        lands instead of waiting for it to finish."""
        reps = self.publisher.fleet.active()
        return max((r.policy_version for r in reps), default=0)

    def step(self, now: Optional[float] = None) -> list:
        """One reconcile pass; returns the actions taken (strings)."""
        now = self.clock() if now is None else now
        actions = []
        rb = self.rollouts.try_harvest()
        if rb is not None:
            if self.tracer is not None and self.tracer.enabled \
                    and self._gen_started is not None:
                self.tracer.record(
                    "rl.rollout", self._gen_started, now,
                    component="rl",
                    attributes={"job": self.name, "version": rb.version,
                                "tokens": rb.tokens})
            self._gen_started = None
            self._win_tokens += rb.tokens
            loss = self.learner.step(rb)
            actions.append(
                f"learned batch v{rb.version} "
                f"(staleness {self.learner.staleness_last}, "
                f"loss {loss:.4f})")
            if self.learner.batches_consumed - self._published_at_batch \
                    >= self.publish_every and self.publisher.idle:
                params = self.learner.publish()
                self.publisher.begin_publish(self.learner.version,
                                             params)
                self._published_at_batch = self.learner.batches_consumed
                actions.append(f"begin publish v{self.learner.version}")
        act = self.publisher.step()
        if act is not None:
            actions.append(act)
        if not self.rollouts._reqs:
            prompts = self.next_prompts()
            if prompts:
                version = self.serving_version()
                n = self.rollouts.submit_prompts(prompts,
                                                 version=version)
                self._gen_started = now
                actions.append(f"submitted {n} rollouts @ v{version}")
        return actions

    # -- observability ----------------------------------------------------

    def observe(self, now: Optional[float] = None) -> Optional[float]:
        """Close one throughput window: harvested completion tokens per
        second since the last ``observe``. Below the declared floor
        counts a violation. Call at a fixed cadence (the replay uses
        the SLO evaluator's); returns the window's rate."""
        now = self.clock() if now is None else now
        if self._win_t is None:
            self._win_t = now
            self._win_tokens = 0
            return None
        dt = now - self._win_t
        if dt <= 0:
            return None
        rate = self._win_tokens / dt
        self.rate_last = rate
        self._win_t = now
        self._win_tokens = 0
        if self.metrics is not None:
            self.metrics.rollout_tokens_per_s.set(
                round(rate, 6), job=self.name)
        if self.floor > 0 and rate < self.floor:
            self.floor_violations += 1
            if self.metrics is not None:
                self.metrics.floor_violations.inc(job=self.name)
        return rate

    def status(self) -> dict:
        """The console's RL job body (docs/rl.md)."""
        fleet = self.publisher.fleet
        router = self.rollouts.router
        return {
            "namespace": self.namespace,
            "job": self.name,
            "policyVersion": self.learner.version,
            "servingVersions": {r.name: r.policy_version
                                for r in fleet.replicas},
            "batchesConsumed": self.learner.batches_consumed,
            "staleness": self.learner.staleness_last,
            "stalenessMax": self.learner.staleness_max,
            "publishes": self.publisher.publishes,
            "replicasRolled": self.publisher.replicas_rolled,
            "publishRolling": self.publisher.target,
            "rolloutTokens": self.rollouts.tokens_total,
            "rolloutBatches": self.rollouts.batches_built,
            "rolloutPending": self.rollouts.pending(),
            "rolloutTokensPerS": round(self.rate_last, 4)
            if self.rate_last is not None else None,
            "rolloutFloorTokensPerS": self.floor,
            "floorViolations": self.floor_violations,
            "tenantSpills": router.tenant_spills,
            "lossLast": round(self.learner.losses[-1], 6)
            if self.learner.losses else None,
            "elasticResizes": self.learner.resizes,
        }

    def job_status(self, namespace: str, name: str) -> Optional[dict]:
        """The DataProxy seam: this flywheel's status when (ns, name)
        names it, else None (404 upstream)."""
        if namespace == self.namespace and name == self.name:
            return self.status()
        return None


__all__ = ["RLFlywheel"]
