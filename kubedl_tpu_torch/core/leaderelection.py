"""Lease-based leader election for HA operator deployments.

The analog of controller-runtime's leader election as enabled in the
reference (``main.go:81-88``: ``LeaderElection: true, LeaderElectionID:
"kubedl-election"``): N replicas of the manager run, exactly one reconciles.
Implemented on ``coordination.k8s.io/v1 Lease`` objects through the
``APIServer`` interface, so it works identically against a real cluster
(``KubeAPIServer``) and the in-memory control plane (tests).

Semantics (mirroring client-go's leaderelection package):

* acquire: create the Lease, or take it over when the holder's
  ``renewTime + leaseDurationSeconds`` has passed;
* renew: the holder refreshes ``renewTime`` every ``retry_period``;
  failing to renew within ``renew_deadline`` demotes it;
* every transition bumps ``leaseTransitions``; optimistic concurrency
  (Conflict on update) resolves races between candidates.

Copied from ``kubedl_tpu/core/leaderelection.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Optional

from . import meta as m
from .apiserver import AlreadyExists, ApiError, Conflict, NotFound

log = logging.getLogger("kubedl_tpu_torch.leaderelection")

DEFAULT_ELECTION_ID = "kubedl-election"   # reference main.go:84


def default_identity() -> str:
    return f"{socket.gethostname()}_{os.getpid()}_{uuid.uuid4().hex[:6]}"


@dataclass
class LeaderElectionConfig:
    namespace: str = "kubedl-system"
    name: str = DEFAULT_ELECTION_ID
    identity: str = ""
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0

    def __post_init__(self):
        if not self.identity:
            self.identity = default_identity()
        if not (self.retry_period < self.renew_deadline < self.lease_duration):
            raise ValueError(
                "need retry_period < renew_deadline < lease_duration, got "
                f"{self.retry_period}/{self.renew_deadline}/{self.lease_duration}")


class LeaderElector:
    def __init__(self, api, config: Optional[LeaderElectionConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.api = api
        self.config = config or LeaderElectionConfig()
        self._clock = clock or time.time
        self.is_leader = False
        self._observed_record: tuple = ()
        self._observed_at = 0.0

    # -- single protocol step ---------------------------------------------

    def try_acquire_or_renew(self) -> bool:
        """One election round; returns True while this candidate holds the
        lease. Never raises on ApiError — an unreachable api-server means
        'not leader' (and demotion once renew_deadline passes)."""
        c = self.config
        now = self._clock()
        try:
            lease = self.api.try_get("Lease", c.namespace, c.name)
            if lease is None:
                lease = self._new_lease(now)
                try:
                    self.api.create(lease)
                except AlreadyExists:
                    return False  # lost the creation race; next round reads it
                log.info("%s acquired lease %s/%s (created)",
                         c.identity, c.namespace, c.name)
                self.is_leader = True
                return True

            spec = lease.setdefault("spec", {})
            holder = spec.get("holderIdentity", "")
            duration = float(spec.get("leaseDurationSeconds")
                             or c.lease_duration)

            if holder == c.identity:
                spec["renewTime"] = m.rfc3339_micro(now)
                self.api.update(lease)
                self.is_leader = True
                return True

            if holder and not self._record_stale(spec, now, duration):
                self.is_leader = False
                return False

            # stale holder: take over
            self._takeover_write(lease, now)
            log.info("%s took over lease %s/%s from %r",
                     c.identity, c.namespace, c.name, holder)
            self.is_leader = True
            return True
        except Conflict:
            # another candidate won this round's write
            self.is_leader = False
            return False
        except Exception as e:  # noqa: BLE001 — the elector loop must
            # survive ANY failure (a raised exception would kill the
            # elector thread silently: the operator keeps reconciling with
            # no lease while a successor takes over — permanent dual-leader)
            log.warning("election round failed: %s", e)
            return False

    # -- shared expiry / takeover mechanics --------------------------------

    def _record_stale(self, spec: dict, now: float,
                      duration: Optional[float] = None) -> bool:
        """Client-go expiry semantics, shared by the acquisition and
        standby paths: measure staleness purely on OUR clock from the
        last time the lease record changed — never against the holder's
        renewTime (a skewed holder clock would read as permanently
        expired and split-brain the operators)."""
        if duration is None:
            duration = float(spec.get("leaseDurationSeconds")
                             or self.config.lease_duration)
        record = (spec.get("holderIdentity", ""), spec.get("renewTime"),
                  spec.get("acquireTime"))
        if record != self._observed_record:
            self._observed_record = record
            self._observed_at = now
        return (now - self._observed_at) > duration

    def _takeover_write(self, lease: dict, now: float) -> None:
        """Rewrite an existing Lease with this candidate as holder,
        bumping leaseTransitions — the one takeover write, shared by
        the stale-holder path and the promotion path."""
        spec = lease.setdefault("spec", {})
        prev = int(spec.get("leaseTransitions") or 0)
        spec.update(self._spec(now))
        spec["leaseTransitions"] = prev + 1
        self.api.update(lease)

    # -- standby-side protocol (docs/replication.md) ----------------------

    def lease_expired(self) -> bool:
        """Whether the observed lease record has gone stale on THIS
        candidate's clock (the same client-go expiry semantics
        :meth:`try_acquire_or_renew` uses), WITHOUT attempting the
        acquisition write. A warm standby calls this on its renew
        cadence so its observation clock tracks the holder's renewals
        as they arrive — promotion then completes within one lease term
        of the holder's death instead of one term after the standby
        first looks. True when the record is absent, held by this
        candidate, or unrenewed for longer than its lease duration;
        False while a live holder keeps renewing (or the api is
        unreachable — an unreachable store proves nothing expired)."""
        c = self.config
        now = self._clock()
        try:
            lease = self.api.try_get("Lease", c.namespace, c.name)
        except ApiError:
            return False
        if lease is None:
            return True
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity", "")
        if not holder or holder == c.identity:
            return True
        return self._record_stale(spec, now)

    def observe(self) -> None:
        """Refresh the expiry observation without acting on it — the
        follower half of the replication group's election step."""
        self.lease_expired()

    def take_over(self) -> None:
        """Unconditionally write this candidate as the holder — the
        promotion path's final step, run only AFTER expiry was
        established via :meth:`lease_expired` (possibly against another
        replica of the same replicated Lease record). Split from the
        wait so the takeover write can land on the store that will
        serve the new leader's rv stream, ordered after the inherited
        WAL tail replay."""
        c = self.config
        now = self._clock()
        lease = self.api.try_get("Lease", c.namespace, c.name)
        if lease is None:
            self.api.create(self._new_lease(now))
        else:
            self._takeover_write(lease, now)
        log.info("%s took over lease %s/%s (promotion)",
                 c.identity, c.namespace, c.name)
        self.is_leader = True

    def _new_lease(self, now: float) -> dict:
        c = self.config
        lease = m.new_obj("coordination.k8s.io/v1", "Lease", c.name,
                          namespace=c.namespace)
        lease["spec"] = self._spec(now)
        return lease

    def _spec(self, now: float) -> dict:
        c = self.config
        return {
            "holderIdentity": c.identity,
            "leaseDurationSeconds": int(c.lease_duration),
            "acquireTime": m.rfc3339_micro(now),
            "renewTime": m.rfc3339_micro(now),
            "leaseTransitions": 0,
        }

    # -- blocking loop -----------------------------------------------------

    def run(self, stop: threading.Event,
            on_started_leading: Optional[Callable[[], None]] = None,
            on_stopped_leading: Optional[Callable[[], None]] = None) -> None:
        """Block until leadership is acquired, call ``on_started_leading``,
        then renew until demoted (→ ``on_stopped_leading``) or ``stop``."""
        c = self.config
        while not stop.is_set():
            if self.try_acquire_or_renew():
                break
            stop.wait(c.retry_period)
        if stop.is_set():
            return
        if on_started_leading:
            on_started_leading()
        last_renew = self._clock()
        while not stop.is_set():
            stop.wait(c.retry_period)
            if stop.is_set():
                break
            if self.try_acquire_or_renew():
                last_renew = self._clock()
            elif self._clock() - last_renew > c.renew_deadline:
                self.is_leader = False
                log.error("%s lost leadership of %s/%s",
                          c.identity, c.namespace, c.name)
                if on_stopped_leading:
                    on_stopped_leading()
                return
        # graceful release so a successor doesn't wait out the lease
        if self.is_leader:
            self.release()

    def release(self) -> None:
        c = self.config
        try:
            lease = self.api.try_get("Lease", c.namespace, c.name)
            if lease and m.get_in(lease, "spec", "holderIdentity") == c.identity:
                lease["spec"]["holderIdentity"] = ""
                lease["spec"]["renewTime"] = None
                self.api.update(lease)
        except ApiError:
            pass
        self.is_leader = False


class ShardLeaseSet:
    """Per-shard reconcile-ownership leases (docs/durability.md).

    The sharded ``Manager`` partitions its workqueue by
    ``manager.shard_for(namespace, name, shards)``; this class decides
    *which process* drains each shard: one independent
    :class:`LeaderElector` per shard, on Leases named
    ``<prefix>-<shard>``, all under this candidate's single identity.
    Every process runs the same election set; a shard's workers only pop
    while ``owns(shard)`` is True, so losing a lease hands the shard off
    — the successor holds an identically-hashed copy of the queue (its
    own watch stream populated it) and simply starts draining.

    ``step()`` runs one election round across all shards and returns the
    owned set; callers drive it on their retry cadence (an operator
    binary from a renewal thread, tests by hand against a sim clock).
    """

    def __init__(self, api, shards: int, identity: str = "",
                 namespace: str = "kubedl-system",
                 prefix: str = "kubedl-shard",
                 lease_duration: float = 15.0,
                 renew_deadline: float = 10.0,
                 retry_period: float = 2.0,
                 clock: Optional[Callable[[], float]] = None):
        self.shards = max(int(shards), 1)
        self.identity = identity or default_identity()
        self.retry_period = retry_period
        self.electors = [
            LeaderElector(api, LeaderElectionConfig(
                namespace=namespace, name=f"{prefix}-{i}",
                identity=self.identity,
                lease_duration=lease_duration,
                renew_deadline=renew_deadline,
                retry_period=retry_period), clock=clock)
            for i in range(self.shards)]

    def step(self) -> set:
        """One acquire-or-renew round per shard; returns the shard
        indices this candidate now holds."""
        return {i for i, el in enumerate(self.electors)
                if el.try_acquire_or_renew()}

    def owns(self, shard: int) -> bool:
        """The ``Manager.shard_owner`` predicate."""
        return self.electors[shard].is_leader

    def owned(self) -> set:
        return {i for i, el in enumerate(self.electors) if el.is_leader}

    def run(self, stop: threading.Event) -> None:
        """Blocking renewal loop (standalone binary): step every
        ``retry_period`` until stopped, then release everything held."""
        while not stop.is_set():
            self.step()
            stop.wait(self.retry_period)
        self.release_all()

    def release_all(self) -> None:
        for el in self.electors:
            if el.is_leader:
                el.release()
