"""Replicated control plane: WAL shipping, warm followers, promotion.

ROADMAP item 3 (docs/replication.md). The journal made the control plane
durable but single-process: one journal writer, one store, and a leader
crash meant a full local recovery with no standby able to take over
inside a lease term. This layer goes the rest of the way to the HA
deployment shape:

* the **leader** ships each sealed group-commit batch — the journal's
  fsync unit, via :attr:`Journal.on_seal` — to N :class:`FollowerStore`\\ s
  as :class:`ShipFrame`\\ s carrying the stream **epoch** and the batch's
  **rv range**. Anything fsynced has been offered to the followers;
  anything shipped has been fsynced.
* each **follower** applies frames into its own copy-on-write store
  (``APIServer.apply_replicated``) under the level-based informer-cache
  rules, so duplicated, re-shipped, and torn-then-resent frames are
  idempotent; it serves reads and bookmark-resumed ``watch_from`` off
  its own event ring and tracks ``applied_rv`` lag.
* **leader loss** (the SIGKILL model: the journal is never closed, its
  tail only ``write(2)``-flushed) promotes the most-caught-up follower
  through the existing :class:`~.leaderelection.LeaderElector` / Lease
  machinery: the standby's elector has been observing the replicated
  Lease's renewals all along, so expiry lands within one lease term of
  the death; the winner then **inherits the WAL** (``Journal
  .successor()`` over the same directory), replays the acknowledged
  tail beyond its ``applied_rv`` exactly like single-process recovery
  (torn final line tolerated and sealed), **bumps the epoch**
  (persisted in the journal directory) so a zombie ex-leader's late
  frames are rejected, and resumes the rv counter — the stream never
  moves backwards, so surviving clients re-resolve and resume watches
  by rv bookmark with zero relists.

Process model: followers live in-process (the transport is a function
call), which makes shipping synchronous with the fsync boundary — the
in-memory analog of synchronous log shipping to a standby on the same
failure domain as the WAL disk. The Lease is itself replicated state:
the leader renews it through its own store, the record ships like any
object, and each standby measures expiry against its own replica on its
own clock (client-go semantics — a skewed holder clock cannot
split-brain the group).

Gate-off contract: nothing in this module is constructed unless
``--replication-followers`` > 0 (which requires ``--enable-durability``
+ ``--journal-dir``); the journal's ship hooks stay None and the
``kubedl_replication_*`` families never register.

Copied from ``kubedl_tpu/core/replication.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Optional

from . import meta as m
from .apiserver import APIServer
from .journal import Journal
from .leaderelection import LeaderElectionConfig, LeaderElector

#: epoch persistence file inside the journal directory — promotion bumps
#: it durably (tmp+fsync+rename; the tmp rides the journal's orphan
#: sweep) so the fencing token survives a full-group restart
EPOCH_FILE = "epoch"


def read_epoch(dirpath: str) -> int:
    """The persisted stream epoch for a journal directory (0 when the
    group has never promoted)."""
    try:
        with open(os.path.join(dirpath, EPOCH_FILE)) as f:
            return int(json.load(f)["epoch"])
    except (OSError, ValueError, KeyError, TypeError):
        return 0


def write_epoch(dirpath: str, epoch: int) -> None:
    """Durably persist the stream epoch (promotion's fencing bump)."""
    final = os.path.join(dirpath, EPOCH_FILE)
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"epoch": int(epoch)}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


@dataclass(frozen=True)
class ShipFrame:
    """One shipped unit, framed with the stream epoch and its rv range.

    ``kind``:

    * ``wal`` — ``records`` holds the sealed group-commit batch
      (parsed WAL record dicts); ``from_rv`` is the previous frame's
      ``to_rv`` (exclusive), ``to_rv`` the batch's maximum rv.
    * ``snapshot`` — a checkpoint manifest at ``to_rv``. With
      ``objects`` None it is a cadence marker (the follower notes the
      leader checkpointed); with ``objects`` set it is a full catch-up
      world for a follower that fell behind the stream.
    * ``epoch`` — an empty fencing announcement: a freshly promoted
      leader raises every surviving follower's epoch before its first
      real batch, so a zombie ex-leader's late frames are rejected
      even in the promotion-to-first-write window.
    """
    epoch: int
    from_rv: int
    to_rv: int
    kind: str = "wal"
    records: tuple = ()
    objects: Optional[tuple] = None


class FollowerStore:
    """One warm replica: its own COW store fed by shipped frames.

    Reads (:meth:`list` / :meth:`get`) and bookmark watches
    (:meth:`watch_from`) are served from the follower's own store and
    event ring — read traffic scales with follower count and never
    touches the leader. Frame application is level-based and therefore
    idempotent: a duplicated frame, a frame replayed across a follower
    restart, a torn frame later re-sent whole, and a stale-epoch frame
    from a deposed leader all leave the store byte-identical to a
    single clean apply (pinned by tests/test_replication.py).
    """

    def __init__(self, name: str, clock=None, watch_ring: int = 8192):
        self.name = name
        self.api = APIServer(clock=clock or time.time,
                             watch_ring=watch_ring)
        #: the stream epoch this follower currently accepts
        self.epoch = 0
        #: highest shipped rv applied (the lag/promotion yardstick)
        self.applied_rv = 0
        #: newest snapshot-manifest rv the leader announced
        self.manifest_rv = 0
        self.frames_applied = 0
        self.records_applied = 0
        self.records_skipped = 0
        self.frames_rejected_stale = 0
        self.snapshots_installed = 0
        self.gaps = 0
        #: set when a wal frame arrived above ``applied_rv`` — the
        #: shipper answers with a full snapshot frame
        self.needs_resync = False

    # -- apply path --------------------------------------------------------

    def apply(self, frame: ShipFrame) -> bool:
        """Apply one frame; False when rejected (stale epoch) or gapped
        (``needs_resync`` set — the shipper sends a catch-up snapshot)."""
        if frame.epoch < self.epoch:
            self.frames_rejected_stale += 1
            return False
        self.epoch = frame.epoch
        if frame.kind == "epoch":
            return True
        if frame.kind == "snapshot":
            if frame.objects is None:
                self.manifest_rv = max(self.manifest_rv, frame.to_rv)
                return True
            if frame.to_rv <= self.applied_rv and not self.needs_resync:
                return True             # already past it: dup manifest
            self.api.install_replica_snapshot(frame.to_rv, frame.objects)
            self.applied_rv = max(self.applied_rv, frame.to_rv)
            self.snapshots_installed += 1
            self.needs_resync = False
            return True
        if frame.from_rv > self.applied_rv:
            # a gap in the stream (this follower joined late or missed
            # frames): applying would silently skip history
            self.gaps += 1
            self.needs_resync = True
            return False
        for rec in frame.records:
            if self.api.apply_replicated(rec):
                self.records_applied += 1
            else:
                self.records_skipped += 1
            # advance by the records actually SEEN, never frame.to_rv:
            # a torn frame (truncated in transit) must leave applied_rv
            # at its last delivered record so the whole re-sent frame
            # is not skipped as already-applied
            self.applied_rv = max(self.applied_rv, int(rec["rv"]))
        self.frames_applied += 1
        return True

    # -- read surface (the follower's whole point) ------------------------

    def list(self, kind, namespace=None, selector=None,
             field_selector=None):
        return self.api.list(kind, namespace, selector, field_selector)

    def get(self, kind, namespace, name):
        return self.api.get(kind, namespace, name)

    def try_get(self, kind, namespace, name):
        return self.api.try_get(kind, namespace, name)

    def watch(self, fn):
        return self.api.watch(fn)

    def watch_from(self, fn, resource_version, kinds=None):
        return self.api.watch_from(fn, resource_version, kinds=kinds)

    def latest_resource_version(self) -> int:
        return self.api.latest_resource_version()

    def status(self, leader_rv: Optional[int] = None) -> dict:
        out = {
            "name": self.name,
            "epoch": self.epoch,
            "appliedRv": self.applied_rv,
            "manifestRv": self.manifest_rv,
            "framesApplied": self.frames_applied,
            "recordsApplied": self.records_applied,
            "recordsSkipped": self.records_skipped,
            "staleFramesRejected": self.frames_rejected_stale,
            "snapshotsInstalled": self.snapshots_installed,
            "gaps": self.gaps,
            "objects": len(self.api),
        }
        if leader_rv is not None:
            out["lagRv"] = max(int(leader_rv) - self.applied_rv, 0)
        return out


class WalShipper:
    """The leader side of the stream: installed on the journal's seal /
    snapshot hooks, frames each sealed batch and delivers it to every
    follower, answering gaps with a full catch-up snapshot."""

    def __init__(self, api, journal: Journal, followers, epoch: int,
                 metrics=None, counters: Optional[dict] = None,
                 keep_frames: bool = False,
                 from_rv: Optional[int] = None):
        self.api = api
        self.journal = journal
        self.followers = list(followers)
        self.epoch = int(epoch)
        self.metrics = metrics
        self.counters = counters if counters is not None \
            else {"frames": 0, "bytes": 0}
        #: every frame shipped, retained for replay-style tests only
        #: (a day's WAL in memory otherwise)
        self.shipped: Optional[list] = [] if keep_frames else None
        #: a detached shipper is a dead process: it frames nothing
        #: (the SIGKILL model — and the zombie's already-framed late
        #: deliveries are what the epoch fence rejects)
        self.detached = False
        self.last_shipped_rv = (int(from_rv) if from_rv is not None
                                else api.latest_resource_version())
        # lock-order contract (see Journal.seal_guard): every seal path
        # takes the store lock before the journal lock, so the deliver
        # path below may touch the store without inverting against a
        # committer that holds the store lock while appending
        journal.seal_guard = getattr(api, "commit_lock", None)
        journal.on_seal = self._on_seal
        journal.on_snapshot = self._on_snapshot

    def _on_seal(self, records: list, nbytes: int) -> None:
        if self.detached or not records:
            return
        to_rv = max(int(r["rv"]) for r in records)
        frame = ShipFrame(epoch=self.epoch, from_rv=self.last_shipped_rv,
                          to_rv=to_rv, kind="wal", records=tuple(records))
        self.last_shipped_rv = max(self.last_shipped_rv, to_rv)
        self.counters["frames"] += 1
        self.counters["bytes"] += int(nbytes)
        if self.metrics is not None:
            self.metrics.shipped_batches.inc()
            self.metrics.shipped_bytes.inc(nbytes)
        self._deliver(frame)

    def _on_snapshot(self, rv: int) -> None:
        if self.detached:
            return
        self._deliver(ShipFrame(epoch=self.epoch, from_rv=0,
                                to_rv=int(rv), kind="snapshot"))

    def announce_epoch(self) -> None:
        """Fence the survivors: raise every follower's epoch before the
        new leader's first real batch."""
        self._deliver(ShipFrame(epoch=self.epoch,
                                from_rv=self.last_shipped_rv,
                                to_rv=self.last_shipped_rv, kind="epoch"))

    def _deliver(self, frame: ShipFrame) -> None:
        if self.shipped is not None:
            self.shipped.append(frame)
        for f in self.followers:
            stale_before = f.frames_rejected_stale
            ok = f.apply(frame)
            if not ok and f.needs_resync:
                # gapped follower: catch it up with the full world (the
                # COW store's immutable snapshots, grabbed shallow)
                rv, snaps = self.api.world_snapshot()
                f.apply(ShipFrame(epoch=self.epoch, from_rv=0, to_rv=rv,
                                  kind="snapshot",
                                  objects=tuple(snaps.values())))
            if self.metrics is not None \
                    and f.frames_rejected_stale > stale_before:
                self.metrics.stale_frames.inc(follower=f.name)
        if self.metrics is not None:
            # one store-lock touch per frame, and only when someone is
            # reading the gauge — not on the metrics-less hot path
            leader_rv = self.api.latest_resource_version()
            for f in self.followers:
                self.metrics.follower_lag.set(
                    max(leader_rv - f.applied_rv, 0), follower=f.name)


class ReplicatedControlPlane:
    """Leader + N followers + the shipping stream + promotion.

    ``clock`` is the injectable time source the whole group runs on
    (the store's clock: a ``SimClock`` in replays and benches — which
    makes promotion latency measurable in sim time, bit-for-bit per
    seed — wall time in production). :meth:`promote` needs the clock to
    be *advanceable* (``clock.advance``) to wait out the dead leader's
    lease synchronously; a production deployment instead runs each
    candidate's elector loop on real threads.
    """

    def __init__(self, api, journal: Journal, followers: int = 2,
                 clock=None, metrics=None,
                 lease_duration: float = 15.0, retry_period: float = 2.0,
                 lease_namespace: str = "kubedl-system",
                 lease_name: str = "kubedl-replication",
                 identity: str = "leader-0",
                 keep_frames: bool = False, follower_ring: int = 8192):
        if followers < 1:
            raise ValueError(f"need >= 1 follower, got {followers}")
        self.api = api
        self.journal = journal
        self.metrics = metrics
        self._now = clock if callable(clock) else time.time
        self._advance = getattr(clock, "advance", None)
        self.lease_duration = float(lease_duration)
        self.retry_period = float(retry_period)
        self.lease_namespace = lease_namespace
        self.lease_name = lease_name
        #: the stream epoch (persisted in the journal dir across
        #: restarts — the fencing token)
        self.epoch = read_epoch(journal.dir)
        self.role = "leader"
        self.leader_name = identity
        self.killed_at_rv: Optional[int] = None
        self.promotions = 0
        self.last_promotion: Optional[dict] = None
        #: the dead leader's shipper after kill_leader() (tests poke it
        #: to prove zombie frames are fenced)
        self.zombie: Optional[WalShipper] = None
        self.followers = [FollowerStore(f"follower-{i}", clock=self._now,
                                        watch_ring=follower_ring)
                          for i in range(int(followers))]
        for f in self.followers:
            f.epoch = self.epoch
        self.counters = {"frames": 0, "bytes": 0}
        self._keep_frames = bool(keep_frames)
        self.shipper = WalShipper(api, journal, self.followers,
                                  epoch=self.epoch, metrics=metrics,
                                  counters=self.counters,
                                  keep_frames=keep_frames)
        self._leader_elector = LeaderElector(
            api, self._lease_config(identity), clock=self._now)
        self._electors = {
            f.name: LeaderElector(f.api, self._lease_config(f.name),
                                  clock=self._now)
            for f in self.followers}
        self._last_election_step: Optional[float] = None
        if metrics is not None:
            metrics.epoch.set(self.epoch)

    def _lease_config(self, identity: str) -> LeaderElectionConfig:
        # renew_deadline must sit strictly between retry and duration
        return LeaderElectionConfig(
            namespace=self.lease_namespace, name=self.lease_name,
            identity=identity, lease_duration=self.lease_duration,
            renew_deadline=(self.retry_period + self.lease_duration) / 2.0,
            retry_period=self.retry_period)

    # -- steady state ------------------------------------------------------

    def step_election(self) -> None:
        """One election round for the whole group: the leader renews
        its (replicated) Lease; every standby refreshes its expiry
        observation against its own replica — the watching that makes
        promotion land within one lease term of a leader death."""
        if self.role == "leader":
            self._leader_elector.try_acquire_or_renew()
        for f in self.followers:
            self._electors[f.name].observe()

    def maybe_step_election(self, now: float) -> None:
        """Rate-limited :meth:`step_election` on the retry cadence —
        what a driver calls from its event loop."""
        if self._last_election_step is None \
                or now - self._last_election_step >= self.retry_period:
            self._last_election_step = now
            self.step_election()

    def most_caught_up(self) -> FollowerStore:
        """Highest ``applied_rv`` wins; ties break by name (in the real
        deployment the shared Lease's optimistic concurrency arbitrates
        — here the deterministic choice stands in for it)."""
        return sorted(self.followers,
                      key=lambda f: (-f.applied_rv, f.name))[0]

    # -- failover ----------------------------------------------------------

    def kill_leader(self) -> None:
        """The SIGKILL model: the leader process is gone. Its journal
        is NOT closed — the tail past the last group-commit fsync is
        only ``write(2)``-flushed — and its shipper frames nothing
        more; whatever it already framed is a zombie delivery the
        epoch fence must reject."""
        if self.role != "leader":
            raise RuntimeError(f"no live leader to kill (role={self.role})")
        self.role = "dead"
        self.killed_at_rv = self.api.latest_resource_version()
        self.zombie = self.shipper
        self.shipper.detached = True

    def promote(self, takeover_api=None) -> dict:
        """Promote the most-caught-up follower, in the deployment's
        order: wait out the dead leader's lease on the standby's own
        replica and clock, inherit the WAL (successor journal over the
        same directory), replay the acknowledged tail beyond
        ``applied_rv`` (torn final line tolerated) and seal it, bump +
        persist the epoch, adopt the journal for future writes, fence
        the surviving followers, and only then write the Lease takeover
        — the first rv the new leader mints is above everything it
        inherited, so the stream never moves backwards.

        ``takeover_api`` designates the store that serves the new
        leader's writes; it defaults to the winner's own store (the
        real deployment shape). The replay harness passes its live
        store after asserting bit-identity with the winner — the
        in-process analog of every client re-resolving to the new
        leader (docs/replication.md, "process model").
        """
        if self.role != "dead":
            raise RuntimeError(
                f"promote() follows leader loss (role={self.role})")
        t0 = self._now()
        winner = self.most_caught_up()
        elector = self._electors[winner.name]
        rounds = 0
        while not elector.lease_expired():
            if self._advance is None:
                raise RuntimeError(
                    "the dead leader's lease has not expired and the "
                    "clock is not advanceable; drive the electors "
                    "yourself or pass a SimClock")
            if rounds > 1_000_000:
                raise RuntimeError("lease never expired")
            self._advance(self.retry_period)
            rounds += 1
        lease_wait_s = self._now() - t0

        # inherit the WAL: the acknowledged (write(2)-flushed) tail
        # beyond what shipping delivered, replayed exactly like
        # single-process recovery — then seal the torn line
        nj = self.journal.successor()
        counts: dict = {}
        base_rv = winner.applied_rv
        # a winner that lagged past a checkpoint rotation cannot be
        # caught up from the WAL alone: records at or below the newest
        # snapshot's rv may live only in pruned generations, folded
        # into the snapshot file. Seed from the newest parseable
        # snapshot above applied_rv first (recovery's own recipe —
        # torn files fall back a generation), then replay the tail;
        # the retention contract guarantees the retained WAL covers
        # everything above the newest snapshot's rv.
        seeded_rv = None
        for snap_rv, path in reversed(nj.snapshots()):
            if snap_rv <= winner.applied_rv:
                break
            try:
                rv, objs = Journal.read_snapshot(path)
            except (OSError, ValueError, KeyError):
                continue
            winner.api.install_replica_snapshot(rv, tuple(objs.values()))
            winner.applied_rv = max(winner.applied_rv, rv)
            seeded_rv = rv
            break
        tail_applied = tail_skipped = 0
        for rec in nj.iter_records(from_rv=winner.applied_rv,
                                   counts=counts):
            if winner.api.apply_replicated(rec):
                tail_applied += 1
            else:
                tail_skipped += 1
            winner.applied_rv = max(winner.applied_rv, int(rec["rv"]))
        nj.reopen()

        # fencing: bump + persist the epoch before serving writes
        self.epoch += 1
        write_epoch(nj.dir, self.epoch)

        api = takeover_api if takeover_api is not None else winner.api
        api.adopt_journal(nj)
        self.api = api
        self.journal = nj
        self.followers = [f for f in self.followers if f is not winner]
        self._electors.pop(winner.name, None)
        self.shipper = WalShipper(api, nj, self.followers,
                                  epoch=self.epoch, metrics=self.metrics,
                                  counters=self.counters,
                                  keep_frames=self._keep_frames,
                                  from_rv=winner.applied_rv)
        self.shipper.announce_epoch()

        # Lease takeover ON THE SERVING STORE, after the tail replay:
        # the takeover's minted rv continues the inherited stream
        self._leader_elector = LeaderElector(
            api, self._lease_config(winner.name), clock=self._now)
        self._leader_elector.take_over()
        self.role = "leader"
        self.leader_name = winner.name
        self.promotions += 1
        if self.metrics is not None:
            self.metrics.promotions.inc()
            self.metrics.epoch.set(self.epoch)
        self.last_promotion = {
            "promotedFrom": winner.name,
            "epoch": self.epoch,
            "leaseWaitSeconds": round(lease_wait_s, 3),
            "promotionSeconds": round(self._now() - t0, 3),
            "leaseDurationSeconds": self.lease_duration,
            "baseRv": base_rv,
            "snapshotSeededRv": seeded_rv,
            "atRv": winner.applied_rv,
            "tailRecordsReplayed": tail_applied,
            "tailRecordsSkipped": tail_skipped,
            "tailTornRecords": counts.get("torn", 0),
            "followersRemaining": len(self.followers),
        }
        return dict(self.last_promotion, follower=winner)

    def kill_and_promote_audited(self, takeover_api=None) -> dict:
        """:meth:`kill_leader` + :meth:`promote` with the zero-loss
        audit both gates share (the replay's ``leader_kill`` primitive
        and the bench's replication leg): snapshot the acknowledged
        world — every committed object's rv, minus the replication
        Lease, which the takeover itself rewrites — at the instant of
        death, then count objects lost or resurrected across the
        failover and whether the rv stream resumed. One definition, so
        the two gates cannot silently diverge on what "acknowledged"
        means."""
        pre_rv = self.api.latest_resource_version()
        pre = {k: m.resource_version(o)
               for k, o in self.api._objs.items() if k[0] != "Lease"}
        self.kill_leader()
        promo = self.promote(takeover_api=takeover_api)
        winner = promo["follower"]
        wobjs = winner.api._objs
        lost = sum(1 for k, rv in pre.items()
                   if k not in wobjs
                   or m.resource_version(wobjs[k]) != rv)
        extra = sum(1 for k in wobjs
                    if k not in pre and k[0] != "Lease")
        promo.update({
            "killedAtRv": self.killed_at_rv,
            "ackObjectsAtKill": len(pre),
            "ackObjectsLost": lost,
            "extraObjects": extra,
            "rvResumed": winner.api.latest_resource_version() >= pre_rv,
        })
        return promo

    # -- introspection (console /api/v1/replication/status) ---------------

    def status(self) -> dict:
        leader_rv = self.api.latest_resource_version()
        return {
            "role": self.role,
            "leader": self.leader_name,
            "epoch": self.epoch,
            "leaderRv": leader_rv,
            "shippedFrames": self.counters["frames"],
            "shippedBytes": self.counters["bytes"],
            "promotions": self.promotions,
            "lastPromotion": (dict(self.last_promotion)
                              if self.last_promotion else None),
            "followers": [f.status(leader_rv) for f in self.followers],
        }
