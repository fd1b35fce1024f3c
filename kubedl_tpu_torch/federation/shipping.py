"""Cross-region WAL shipping: each region's stream, mirrored to a peer.

``core/replication.py`` ships sealed group-commit batches to in-process
followers synchronously — the transport is a function call on the same
failure domain. Across regions the wire is real: frames can transiently
fail, so this layer queues each sealed batch and pumps the queue with
**bounded retry + exponential backoff** (docs/federation.md "Shipping
and retry"). The invariants the satellite tests pin:

* a transient failure NEVER silently strands the standby — the frame
  stays queued (head-of-line: order is the stream's correctness) and
  retries on the backoff schedule, counted per region in
  ``kubedl_federation_ship_retries_total``;
* exhausted retries (``max_attempts``) emit a Warning Event through the
  standard :class:`~kubedl_tpu_torch.core.events.Recorder` and DROP the frame
  rather than wedge the queue — the standby then sees a gap on the next
  frame, sets ``needs_resync``, and the shipper answers with a full
  catch-up snapshot exactly like the in-process
  :class:`~kubedl_tpu_torch.core.replication.WalShipper` does. Zero-loss
  holds because loss is *detected and repaired*, never papered over.

:class:`CrossRegionStandby` is the receiving side: a peer-region
:class:`~kubedl_tpu_torch.core.replication.FollowerStore` that, on region
death, catches up from the dead region's journal (``Journal
.successor()`` read-only — the dead region never writes again) so the
evacuation's zero-loss audit reads a complete acknowledged world.
:class:`ReadGateway` fronts it for cross-region read traffic: reads
during a promotion window return a counted redirect, never a torn
world.

Copied from ``kubedl_tpu/federation/shipping.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import random
from typing import Optional

from ..core.events import TYPE_WARNING
from ..core.journal import Journal
from ..core.replication import FollowerStore, ShipFrame


class CrossRegionShipper:
    """One region's outbound stream to its peer-region standby.

    Chains onto the journal's ``on_seal`` hook AFTER the in-region
    :class:`~kubedl_tpu_torch.core.replication.WalShipper` (local followers
    stay synchronous with the fsync boundary; the cross-region hop is
    asynchronous and lossy, which is the whole point). ``fail_rate`` is
    the injected transient-wire-failure probability, deterministic per
    ``(seed, region)``.
    """

    def __init__(self, region: str, api, journal, standby,
                 epoch_fn, seed: int = 0, max_attempts: int = 5,
                 backoff_base_s: float = 0.5, backoff_cap_s: float = 30.0,
                 fail_rate: float = 0.0, metrics=None, recorder=None):
        self.region = region
        self.api = api
        self.journal = journal
        self.standby = standby
        self._epoch_fn = epoch_fn
        self.max_attempts = max(int(max_attempts), 1)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.fail_rate = float(fail_rate)
        self.metrics = metrics
        self.recorder = recorder
        self._rng = random.Random(f"{seed}:fedship:{region}")
        #: [frame, attempts, earliest-next-attempt (abs sim time)]
        self.queue: list = []
        self.frames_shipped = 0
        self.retries = 0
        self.frames_dropped = 0
        self.resyncs = 0
        #: region death detaches the stream (nothing more to frame)
        self.detached = False
        self.last_shipped_rv = api.latest_resource_version()
        self._prev_on_seal = journal.on_seal
        journal.on_seal = self._on_seal

    # -- enqueue (the journal's seal hook) ---------------------------------

    def _on_seal(self, records: list, nbytes: int) -> None:
        # the in-region shipper runs first: local followers are always
        # at least as caught up as the cross-region standby
        if self._prev_on_seal is not None:
            self._prev_on_seal(records, nbytes)
        if self.detached or not records:
            return
        to_rv = max(int(r["rv"]) for r in records)
        frame = ShipFrame(epoch=self._epoch_fn(),
                          from_rv=self.last_shipped_rv, to_rv=to_rv,
                          kind="wal", records=tuple(records))
        self.last_shipped_rv = max(self.last_shipped_rv, to_rv)
        self.queue.append([frame, 0, 0.0])

    def detach(self) -> None:
        """Region death: restore the chained hook and frame nothing
        more (queued frames are abandoned — the standby catches up from
        the journal instead, see :meth:`CrossRegionStandby
        .catch_up_from_journal`)."""
        self.detached = True
        self.journal.on_seal = self._prev_on_seal
        self.queue.clear()

    # -- pump (the driver's per-round call) --------------------------------

    def pump(self, now: float) -> int:
        """Attempt queued deliveries due at ``now``; head-of-line
        ordered (frame order IS stream order). Returns frames
        delivered this call."""
        delivered = 0
        while self.queue and not self.detached:
            entry = self.queue[0]
            frame, attempts, next_at = entry
            if next_at > now:
                break
            if self._rng.random() < self.fail_rate:
                attempts += 1
                if attempts >= self.max_attempts:
                    # never wedge: drop, warn, and let the gap-detect /
                    # snapshot-resync machinery repair the stream
                    self.queue.pop(0)
                    self.frames_dropped += 1
                    if self.metrics is not None:
                        self.metrics.ship_exhausted.inc(region=self.region)
                    self._warn_exhausted(frame, attempts)
                    continue
                entry[1] = attempts
                entry[2] = now + min(
                    self.backoff_cap_s,
                    self.backoff_base_s * (2.0 ** (attempts - 1)))
                self.retries += 1
                if self.metrics is not None:
                    self.metrics.ship_retries.inc(region=self.region)
                break
            self.queue.pop(0)
            self._deliver(frame)
            delivered += 1
        return delivered

    def _deliver(self, frame: ShipFrame) -> None:
        store = self.standby.store
        ok = store.apply(frame)
        if not ok and store.needs_resync:
            rv, snaps = self.api.world_snapshot()
            store.apply(ShipFrame(epoch=self._epoch_fn(), from_rv=0,
                                  to_rv=rv, kind="snapshot",
                                  objects=tuple(snaps.values())))
            self.resyncs += 1
        self.frames_shipped += 1
        if self.metrics is not None:
            self.metrics.ship_frames.inc(region=self.region)

    def _warn_exhausted(self, frame: ShipFrame, attempts: int) -> None:
        if self.recorder is None:
            return
        lease = self.api.try_get("Lease", "kubedl-system",
                                 "kubedl-replication")
        if lease is None:
            return
        self.recorder.event(
            lease, TYPE_WARNING, "CrossRegionShipExhausted",
            f"dropped WAL frame rv ({frame.from_rv}, {frame.to_rv}] to "
            f"standby for region {self.region} after {attempts} "
            f"attempts; standby will resync from snapshot")

    def status(self) -> dict:
        return {
            "region": self.region,
            "queued": len(self.queue),
            "framesShipped": self.frames_shipped,
            "retries": self.retries,
            "framesDropped": self.frames_dropped,
            "resyncs": self.resyncs,
            "detached": self.detached,
        }


class CrossRegionStandby:
    """A peer-region warm replica of one region's control plane.

    ``source`` is the region being mirrored, ``host`` the region whose
    failure domain holds the replica — the pair the evacuation relies
    on: when ``source`` dies, its acknowledged world survives in
    ``host``.
    """

    def __init__(self, source: str, host: str, clock=None):
        self.source = source
        self.host = host
        self.store = FollowerStore(f"standby-{source}@{host}", clock=clock)
        #: "following" in steady state; "promoting" while catching up
        #: from the dead region's journal — the window the read gateway
        #: answers with redirects instead of a possibly-torn world
        self.state = "following"
        self.last_catch_up: Optional[dict] = None

    def catch_up_from_journal(self, journal, probe=None) -> dict:
        """Region death: replay the dead region's acknowledged WAL tail
        beyond ``applied_rv`` into the standby — the same recipe as
        :meth:`~kubedl_tpu_torch.core.replication.ReplicatedControlPlane
        .promote`, but strictly read-only (``Journal.successor()`` is
        never reopened for append: the dead region writes nothing ever
        again). ``probe`` is called once mid-replay — the promotion-race
        test's hook for reading through the gateway DURING the window.
        """
        self.state = "promoting"
        try:
            nj = journal.successor()
            counts: dict = {}
            seeded_rv = None
            for snap_rv, path in reversed(nj.snapshots()):
                if snap_rv <= self.store.applied_rv:
                    break
                try:
                    rv, objs = Journal.read_snapshot(path)
                except (OSError, ValueError, KeyError):
                    continue
                self.store.api.install_replica_snapshot(
                    rv, tuple(objs.values()))
                self.store.applied_rv = max(self.store.applied_rv, rv)
                seeded_rv = rv
                break
            applied = skipped = 0
            probed = False
            for rec in nj.iter_records(from_rv=self.store.applied_rv,
                                       counts=counts):
                if probe is not None and not probed:
                    probed = True
                    probe()
                if self.store.api.apply_replicated(rec):
                    applied += 1
                else:
                    skipped += 1
                self.store.applied_rv = max(self.store.applied_rv,
                                            int(rec["rv"]))
            if probe is not None and not probed:
                probe()
            self.last_catch_up = {
                "snapshotSeededRv": seeded_rv,
                "tailRecordsReplayed": applied,
                "tailRecordsSkipped": skipped,
                "tailTornRecords": counts.get("torn", 0),
                "atRv": self.store.applied_rv,
            }
            return dict(self.last_catch_up)
        finally:
            self.state = "following"

    def status(self) -> dict:
        return {
            "source": self.source,
            "host": self.host,
            "state": self.state,
            "store": self.store.status(),
            "lastCatchUp": (dict(self.last_catch_up)
                            if self.last_catch_up else None),
        }


class ReadGateway:
    """Cross-region read traffic, served off the peer standby.

    The satellite-3 invariant: a read racing the standby's catch-up
    (``state == "promoting"``) returns ``("redirect", None)`` — counted
    in ``kubedl_federation_read_redirects_total`` — instead of a world
    that mixes pre- and post-replay state. Any ``("ok", obj)`` answer
    is a consistent snapshot of the standby's COW store.
    """

    def __init__(self, standby: CrossRegionStandby, region: str,
                 metrics=None):
        self.standby = standby
        self.region = region
        self.metrics = metrics
        self.reads = 0
        self.redirects = 0

    def get(self, kind: str, namespace: str, name: str) -> tuple:
        if self.standby.state == "promoting":
            self.redirects += 1
            if self.metrics is not None:
                self.metrics.read_redirects.inc(region=self.region)
            return "redirect", None
        self.reads += 1
        if self.metrics is not None:
            self.metrics.follower_reads.inc(region=self.region)
        return "ok", self.standby.store.try_get(kind, namespace, name)

    def list(self, kind: str, namespace=None) -> tuple:
        if self.standby.state == "promoting":
            self.redirects += 1
            if self.metrics is not None:
                self.metrics.read_redirects.inc(region=self.region)
            return "redirect", None
        self.reads += 1
        if self.metrics is not None:
            self.metrics.follower_reads.inc(region=self.region)
        return "ok", self.standby.store.list(kind, namespace)
