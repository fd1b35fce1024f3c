"""WeightPublisher: roll a policy version across the fleet between drains.

The deployment half of the flywheel (docs/rl.md). Two invariants, both
load-bearing for everything downstream:

* **never drop a stream**: a replica's weights swap only while it is
  DRAINED AND IDLE — the router stopped placing onto it, its queue and
  lanes ran to completion. In-flight decodes always finish on the
  weights that started them;
* **never serve a torn version**: a replica advertises exactly ONE
  ``policy_version``, flipped only AFTER the new params are fully
  installed. While the swap is open the replica is marked
  ``weight_swap`` — ``ServingFleet.cancel_drain`` (autoscaler pressure
  mid-publish) skips it rather than handing the router a half-loaded
  replica, and ``ServingFleet.reap`` leaves it alone even though
  drained-and-idle is exactly what reap looks for.

The roll is one replica at a time and never takes the LAST active
replica — user traffic keeps flowing through the rest of the fleet for
the whole publish. :meth:`step` is a reconcile: idempotent, safe at any
cadence, sim-clock friendly (the replay ticks it alongside the
autoscaler's).

Copied from ``kubedl_tpu/rl/publisher.py`` (the port imports nothing of the
JAX package), with one change: a replica installs a version through
``ContinuousBatchingEngine.load_weights``, which copies the params into
the tensors it serves and prefills its registered prefixes again under
them. The JAX publisher assigns ``engine.params``, so its prefixes keep
the K/V of the weights they were registered under.
"""

from __future__ import annotations

from typing import Optional


class WeightPublisher:
    """Reconcile the fleet's advertised policy versions to a target."""

    def __init__(self, fleet, metrics=None, job: str = ""):
        self.fleet = fleet
        self.metrics = metrics
        self.job = job
        #: completed rolls (every active replica flipped)
        self.publishes = 0
        #: individual replica swaps performed
        self.replicas_rolled = 0
        self.log: list = []
        self._target: Optional[int] = None
        self._params = None
        self._swapping = None

    @property
    def idle(self) -> bool:
        """No publish in progress (the flywheel's begin-next gate)."""
        return self._target is None

    @property
    def target(self) -> Optional[int]:
        return self._target

    def begin_publish(self, version: int, params) -> None:
        """Start rolling ``params`` as ``version`` across the fleet."""
        if self._target is not None:
            raise RuntimeError(
                f"publish v{self._target} still rolling; one version "
                "rolls at a time (a second would race the drains)")
        self._target = int(version)
        self._params = params

    def step(self) -> Optional[str]:
        """One reconcile pass; returns the action taken (or None).

        Order matters: finish the open swap first (install + flip +
        hand the replica back to the router), then drain the next
        stale replica — so at most one replica is ever out of the
        placement set on the publisher's account."""
        if self._target is None:
            return None
        if self._swapping is not None:
            rep = self._swapping
            if not rep.idle():
                return None           # streams still finishing; wait
            # copied into the tensors the replica serves (its captured
            # decode graphs read them), its prefixes refilled in place
            rep.engine.load_weights(self._params)
            rep.policy_version = self._target
            rep.weight_swap = False
            rep.draining = False      # back into the placement set
            self._swapping = None
            self.replicas_rolled += 1
            self.log.append(f"installed v{self._target} on {rep.name}")
            return self.log[-1]
        stale = next((r for r in self.fleet.replicas
                      if not r.draining
                      and r.policy_version != self._target), None)
        if stale is None:
            # every active replica advertises the target: landed.
            # (Replicas still draining for scale-down keep serving
            # their old version to completion — never torn, and the
            # router's version pin excludes them anyway.)
            version = self._target
            self._target = None
            self._params = None
            self.publishes += 1
            if self.metrics is not None:
                self.metrics.publishes.inc(job=self.job)
            self.log.append(f"published v{version}")
            return self.log[-1]
        if len(self.fleet.active()) <= 1:
            return None               # never take the last active replica
        self.fleet.begin_drain(stale.name)
        stale.weight_swap = True
        self._swapping = stale
        self.log.append(f"drain {stale.name} for v{self._target}")
        return self.log[-1]


__all__ = ["WeightPublisher"]
