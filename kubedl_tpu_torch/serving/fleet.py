"""Serving fleet: N continuous-batching replicas behind one front door.

One :class:`~kubedl_tpu_torch.serving.batching.ContinuousBatchingEngine`
serves one model replica; a production fleet runs many and needs three
things in front of them (docs/serving_fleet.md):

* a **fleet** object owning replica lifecycle — add on scale-up, DRAIN
  on scale-down (new placements stop, in-flight streams and the
  replica's own queue finish; streams are never dropped), reap once
  idle;
* a **router** placing each request (``serving/router.py``:
  prefix-cache-aware placement with per-tenant fairness);
* an **autoscaler** closing the loop from measured signals
  (``controllers/servingfleet.py``: SLO burn-rate verdicts + the
  engines' free-block/queue-depth health gauges).

The fleet is engine-substrate-only: it never touches the control plane.
The operator exposes its status through the console
(``/api/v1/serving/fleet``) and its health through
:class:`~kubedl_tpu_torch.metrics.registry.ServingFleetMetrics`, both gated on
``--enable-serving-fleet`` / the ``ServingFleet`` feature gate.

Copied from ``kubedl_tpu/serving/fleet.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from typing import Callable, Optional


class ServingReplica:
    """One engine + its fleet bookkeeping."""

    __slots__ = ("name", "engine", "draining", "policy_version",
                 "weight_swap")

    def __init__(self, name: str, engine, policy_version: int = 0):
        self.name = name
        self.engine = engine
        self.draining = False
        #: the ONE policy version this replica serves (docs/rl.md): a
        #: weight publish flips it atomically only after the new params
        #: are fully installed — a replica never advertises a version
        #: it cannot serve, and the router can pin placements to one
        self.policy_version = policy_version
        #: True while a publisher holds this replica mid-swap; guards
        #: :meth:`ServingFleet.cancel_drain` from un-draining a replica
        #: whose weights are torn (satellite: drain/publish composition)
        self.weight_swap = False

    def health(self) -> dict:
        h = self.engine.health()
        h["replica"] = self.name
        h["draining"] = self.draining
        h["policy_version"] = self.policy_version
        return h

    def idle(self) -> bool:
        """No queued work, no in-flight lane (safe to reap: ``stop()``
        on an idle engine cancels nothing)."""
        h = self.engine.health()
        return (h["queue_depth"] == 0 and h["active_lanes"] == 0
                and h["parked_lanes"] == 0)


class ServingFleet:
    """Replica lifecycle + health rollup.

    ``engine_factory(index)`` builds one engine per replica (closing
    over shared read-only params; each engine owns its cache/pool).
    Replica names are stable (``replica-<ordinal>``) and never reused —
    metric series and drain logs stay unambiguous across scale cycles.
    """

    def __init__(self, engine_factory: Callable[[int], object],
                 replicas: int = 1, metrics=None,
                 name_prefix: str = "replica"):
        self._factory = engine_factory
        self._prefix = name_prefix
        self._ordinal = 0
        self.metrics = metrics
        self.replicas: list[ServingReplica] = []
        #: drained replicas removed so far (names, in reap order)
        self.reaped: list[str] = []
        #: counters carried over from reaped replicas (their engines
        #: are gone; fleet-lifetime rollups must not lose them)
        self.reaped_handoffs = 0
        self.reaped_prefill_tokens = 0
        self.reaped_adapter_faults = 0
        for _ in range(max(int(replicas), 1)):
            self.add_replica()

    # -- lifecycle --------------------------------------------------------

    def add_replica(self) -> ServingReplica:
        name = f"{self._prefix}-{self._ordinal}"
        engine = self._factory(self._ordinal)
        self._ordinal += 1
        rep = ServingReplica(name, engine)
        self.replicas.append(rep)
        return rep

    def begin_drain(self, name: Optional[str] = None) \
            -> Optional[ServingReplica]:
        """Mark one replica draining (the youngest non-draining one by
        default): the router stops placing onto it, its own queue and
        lanes run to completion, and :meth:`reap` removes it once idle.
        Returns the replica, or None when nothing is drainable."""
        if name is not None:
            rep = next((r for r in self.replicas if r.name == name), None)
        else:
            rep = next((r for r in reversed(self.replicas)
                        if not r.draining), None)
        if rep is None or rep.draining:
            return None
        rep.draining = True
        return rep

    def cancel_drain(self) -> Optional[ServingReplica]:
        """Un-drain the youngest draining replica (pressure returned
        before its streams finished): its engine never stopped, so
        marking it active restores capacity instantly — strictly better
        than paying a fresh replica's spin-up while one is standing
        right there. A replica mid-weight-swap is SKIPPED: the
        publisher drained it to install new params, and handing it back
        to the router before the swap commits would serve a torn
        version (docs/rl.md "publish between drains"). Returns the
        replica, or None when nothing is (safely) un-drainable."""
        rep = next((r for r in reversed(self.replicas)
                    if r.draining and not r.weight_swap), None)
        if rep is None:
            return None
        rep.draining = False
        return rep

    def reap(self) -> list:
        """Remove every draining replica that has gone idle (its engine
        stopped — nothing in flight, so no stream is cancelled). A
        replica mid-weight-swap is exempt: drained-and-idle is exactly
        the publish window, and the publisher hands it back (or the
        autoscaler reaps it on a later pass if it stays draining).
        Returns the reaped names."""
        done = [r for r in self.replicas
                if r.draining and not r.weight_swap and r.idle()]
        for rep in done:
            rep.engine.stop()
            self.replicas.remove(rep)
            self.reaped.append(rep.name)
            self.reaped_handoffs += rep.engine.handoffs
            self.reaped_prefill_tokens += rep.engine.prefill_tokens_total
            faults = getattr(rep.engine, "adapter_status", None)
            faults = faults()["faults"] if faults is not None and \
                getattr(rep.engine, "multi_model", False) else None
            if faults:
                self.reaped_adapter_faults += sum(faults.values())
            if self.metrics is not None:
                # flush the final counter delta before the engine's
                # health vanishes from refresh()'s view
                self.metrics.note_reaped(rep.name, rep.engine.handoffs,
                                         adapter_faults=faults)
        return [r.name for r in done]

    # -- reads ------------------------------------------------------------

    def active(self) -> list:
        """Placement candidates: every non-draining replica."""
        return [r for r in self.replicas if not r.draining]

    @property
    def size(self) -> int:
        return len(self.replicas)

    def health(self) -> list:
        return [r.health() for r in self.replicas]

    def busy(self) -> bool:
        """Any replica holding queued or in-flight work."""
        return any(not r.idle() for r in self.replicas)

    def step(self) -> bool:
        """One inline scheduler tick on every replica (sim-clock
        callers); True while any replica reports work left."""
        busy = False
        for rep in list(self.replicas):
            busy = rep.engine.step() or busy
        return busy

    def refresh_metrics(self) -> None:
        if self.metrics is not None:
            self.metrics.refresh(self)

    def status(self) -> dict:
        """The console's fleet snapshot (docs/serving_fleet.md)."""
        return {
            "replicas": self.size,
            "draining": sum(1 for r in self.replicas if r.draining),
            "reaped": list(self.reaped),
            "health": self.health(),
        }

    def stop(self) -> None:
        """Tear the whole fleet down (tests / process exit); in-flight
        requests are cancelled — scale-down paths use drain+reap."""
        for rep in self.replicas:
            rep.engine.stop()
        self.replicas = []
