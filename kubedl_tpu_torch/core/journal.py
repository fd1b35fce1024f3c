"""Write-ahead journal + snapshots for the in-memory control plane.

ROADMAP item 1 (docs/durability.md): the ``APIServer`` is the store of
record in standalone mode, and before this layer existed it lost the
world on restart — MTTR after an operator crash was "replay nothing,
relist everything". The journal makes the store durable with the classic
WAL + checkpoint split:

* **WAL** (``wal-<rv>.log``): every commit/delete appends one compact
  JSON record. Appends are ``write(2)``-flushed per record (a process
  crash loses nothing the store acknowledged) and ``fsync``ed in groups
  of ``fsync_every`` records (the power-loss durability knob) — classic
  group commit, so the write hot path stays O(append).
* **Snapshots** (``snap-<rv>.json``): every ``snapshot_every`` commits
  the store's copy-on-write read snapshots are serialized as-is — the store
  guarantees every commit produces an immutable per-object snapshot, so
  the dump serializes shared frozen trees instead of copying the world —
  and the WAL rotates. Old generations are removed only after the new
  snapshot is durably renamed into place, so a crash at any point leaves
  a recoverable (snapshot, WAL-tail) pair on disk.

**Recovery** (:meth:`Journal.recover`): load the newest parseable
snapshot, then replay every WAL record with ``rv`` greater than the
snapshot's, in file order, tolerating a torn final line (a crash
mid-append). The caller resumes its ``resourceVersion`` counter from the
recovered maximum, so a restarted operator continues the same rv stream
— the watch-bookmark contract (docs/durability.md) depends on rv never
moving backwards across a restart.

Record format (one JSON object per line, keys kept one-letter compact —
the WAL is the write hot path)::

    {"t": "c", "rv": 1234, "ts": 1700000042.5, "k": ["Pod", "default", "p-0"], "o": {...}}
    {"t": "d", "rv": 1240, "ts": 1700000050.0, "k": ["Pod", "default", "p-0"]}

``t`` is the record type (``c`` commit, ``d`` delete), ``rv`` the store
resourceVersion counter after the write (deletes allocate an rv while
durability is on, mirroring etcd's revision-per-delete — the ``rv > S``
replay filter needs every post-snapshot record above the snapshot's rv),
``ts`` the store clock at the write (sim time in replays, wall time in
production — the forensics layer's per-commit timestamp; readers must
tolerate its absence, pre-forensics WALs don't carry it), ``k`` the
(kind, namespace, name) key, and ``o`` the committed object.

The **read side** is public (docs/forensics.md): :meth:`Journal
.iter_records` streams parsed records for an rv range with the same
torn-tail tolerance recovery uses, and :meth:`Journal.snapshots` /
:meth:`Journal.read_snapshot` expose the checkpoint generations — one
reader shared by :meth:`recover`, the forensics ``WorldLine``, and the
replication layer's WAL followers, instead of each re-parsing the files.

The **ship side** (docs/replication.md) hangs off the group-commit
boundary: when an ``on_seal`` hook is installed, every record appended
since the last fsync is buffered and handed to the hook — as parsed
dicts plus their serialized byte count — the moment the fsync that
makes them durable returns. The sealed batch is the replication
shipping unit: anything fsynced has been offered to the followers,
anything shipped has been fsynced. ``on_snapshot(rv)`` fires after a
checkpoint lands durably (the follower-visible snapshot manifest
cadence). Both hooks default to None and cost one attribute check on
the hot path, so a non-replicated journal is byte-identical to the unreplicated one.

Copied from ``kubedl_tpu/core/journal.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

_SNAP_PREFIX = "snap-"
_WAL_PREFIX = "wal-"


def _gen_name(prefix: str, rv: int) -> str:
    return f"{prefix}{rv:016d}"


def _gen_rv(name: str, prefix: str) -> Optional[int]:
    stem = name[len(prefix):].split(".", 1)[0]
    try:
        return int(stem)
    except ValueError:
        return None


class JournalCorrupt(Exception):
    """No snapshot generation in the journal directory could be parsed
    (WAL-only recovery from rv 0 still works; this is only raised when a
    snapshot file exists but every generation is unreadable)."""


class Journal:
    """Append-side and recovery-side of the WAL (one instance per store).

    File operations take the journal's own lock: appends arrive under
    the APIServer's store lock (the serialization WAL order relies on),
    but checkpoints (:meth:`write_snapshot`) deliberately run *outside*
    it — serializing the world must not stall every read and write — so
    the WAL rotation has to be safe against a concurrent append.
    Records committed while a checkpoint is in flight may land in the
    pre-rotation generation; recovery's ``rv > snapshot_rv`` filter
    replays them regardless of which file they sit in.
    """

    def __init__(self, dirpath: str, snapshot_every: int = 4096,
                 fsync_every: int = 64, metrics=None,
                 timer=time.perf_counter, fsync_hook=None,
                 clock=time.time, retain_all: bool = False):
        self.dir = dirpath
        self._lock = threading.Lock()
        self.snapshot_every = max(int(snapshot_every), 1)
        self.fsync_every = max(int(fsync_every), 1)
        self.metrics = metrics
        self._timer = timer
        #: timestamp source for the per-record ``ts`` field (the store's
        #: clock: sim time in replays, wall time in production)
        self._clock = clock or time.time
        #: keep every snapshot + WAL generation instead of pruning to the
        #: active pair — the forensics retention mode: ``WorldLine`` can
        #: then reconstruct the store at ANY rv back to the journal's
        #: birth (docs/forensics.md). Off by default: a long-lived
        #: operator's journal would otherwise grow without bound.
        self.retain_all = bool(retain_all)
        #: chaos seam (docs/chaos.md): called inside every group-commit
        #: fsync, between the latency timer's start and the real
        #: ``os.fsync``. A slow-disk campaign installs
        #: ``ChaosAPIServer.fsync_hook`` here so the injected delay is
        #: measured by ``kubedl_journal_fsync_seconds`` exactly like a
        #: genuinely slow WAL device would be.
        self.fsync_hook = fsync_hook
        #: replication ship seam (docs/replication.md): called as
        #: ``on_seal(records, nbytes)`` after each group-commit fsync
        #: with the parsed records that fsync sealed — the WAL-shipping
        #: unit. None (default) = no buffering, no shipping.
        self.on_seal = None
        #: called as ``on_snapshot(rv)`` after a checkpoint is durably
        #: renamed into place (the snapshot-manifest cadence followers
        #: hear about). None = no-op.
        self.on_snapshot = None
        #: lock-order guard for the ship hooks (set by the WalShipper
        #: to the store's commit lock): every journal path that can
        #: seal+ship acquires it BEFORE the journal lock, so the global
        #: order is store -> journal everywhere. Without it, a thread
        #: that fsyncs without the store lock (the async checkpoint
        #: worker, a shutdown flush) would hold the journal lock while
        #: on_seal reaches for the store — the exact ABBA inversion of
        #: a committer holding the store lock while appending. None
        #: (replication off) = zero overhead.
        self.seal_guard = None
        self._pending_ship: list = []
        self._pending_bytes = 0
        os.makedirs(dirpath, exist_ok=True)
        # sweep checkpoint tmp orphans: a crash between write_snapshot's
        # tmp+fsync and the rename leaves ``*.tmp`` behind, and recovery
        # deliberately ignores tmp files — without this sweep the orphan
        # accumulates forever (and a half-written one could be confused
        # for a real generation by out-of-tree tooling)
        for name in os.listdir(dirpath):
            if name.endswith(".tmp"):
                try:
                    os.unlink(os.path.join(dirpath, name))
                except OSError:
                    pass
        self._f = None
        self._since_fsync = 0
        self._since_snapshot = 0
        #: total WAL records appended by this instance
        self.appends = 0
        #: snapshots written by this instance
        self.snapshots_written = 0
        #: how the last recover() rebuilt the world (test/debug surface)
        self.recovered_from: dict = {}

    # -- read side (public: recovery, WorldLine, future followers) ---------

    def _generations(self, prefix: str) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith(prefix) and not name.endswith(".tmp"):
                rv = _gen_rv(name, prefix)
                if rv is not None:
                    out.append((rv, os.path.join(self.dir, name)))
        out.sort()
        return out

    def snapshots(self) -> list:
        """``[(rv, path)]`` of on-disk snapshot generations, rv-sorted."""
        return self._generations(_SNAP_PREFIX)

    def wal_generations(self) -> list:
        """``[(base_rv, path)]`` of on-disk WAL generations, rv-sorted.
        A generation's name bounds its MINIMUM record rv (a commit racing
        a checkpoint lands in the pre-rotation file), never a maximum."""
        return self._generations(_WAL_PREFIX)

    @staticmethod
    def read_snapshot(path: str) -> tuple:
        """Parse one snapshot file into ``(rv, {key: obj})``. Raises
        ``OSError``/``ValueError``/``KeyError`` for a torn or unreadable
        file — callers fall back a generation, exactly like recovery."""
        with open(path) as f:
            doc = json.load(f)
        rv = int(doc["rv"])
        objs: dict[tuple, dict] = {}
        for o in doc["objects"]:
            md = o.get("metadata") or {}
            objs[(o.get("kind", ""),
                  md.get("namespace", "default"),
                  md.get("name", ""))] = o
        return rv, objs

    def iter_records(self, from_rv: int = 0, to_rv: Optional[int] = None,
                     counts: Optional[dict] = None):
        """Stream parsed WAL records with ``from_rv < rv <= to_rv`` in
        file order (the exact replay order recovery uses; ``to_rv=None``
        is unbounded). Torn lines — a crash mid-append — are tolerated
        and skipped, tallied into ``counts['torn']`` when a dict is
        passed (``counts['records']`` tallies the yields). Records are
        plain dicts; pre-forensics records carry no ``ts`` key, so
        readers must treat ``rec.get('ts')`` as optional. A generation
        vanishing between the listing and the open (a live journal's
        checkpoint pruned it — its records are folded into a newer
        snapshot) is skipped, not an error: forensics readers run on
        console threads against the operator's live journal."""
        for _base_rv, path in self.wal_generations():
            try:
                f = open(path)
            except OSError:
                continue
            with f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        if counts is not None:
                            counts["torn"] = counts.get("torn", 0) + 1
                        continue
                    rv = int(rec["rv"])
                    if rv <= from_rv or (to_rv is not None and rv > to_rv):
                        continue
                    if counts is not None:
                        counts["records"] = counts.get("records", 0) + 1
                    yield rec

    def recover(self) -> tuple:
        """Rebuild ``(max_rv, {key: obj})`` from newest snapshot + WAL
        tail. An empty/new directory recovers to ``(0, {})``. Also
        positions the journal to append to the newest WAL generation."""
        snaps = self.snapshots()
        objs: dict[tuple, dict] = {}
        snap_rv = 0
        snap_used = None
        for rv, path in reversed(snaps):
            try:
                snap_rv, objs = self.read_snapshot(path)
                snap_used = path
                break
            except (OSError, ValueError, KeyError):
                continue           # torn snapshot: fall back a generation
        if snaps and snap_used is None:
            raise JournalCorrupt(
                f"no parseable snapshot generation in {self.dir}")
        max_rv = snap_rv
        counts: dict = {}
        for rec in self.iter_records(from_rv=snap_rv, counts=counts):
            k = tuple(rec["k"])
            if rec["t"] == "c":
                objs[k] = rec["o"]
            elif rec["t"] == "d":
                objs.pop(k, None)
            max_rv = max(max_rv, int(rec["rv"]))
        self.recovered_from = {
            "snapshot_rv": snap_rv,
            "snapshot_file": os.path.basename(snap_used) if snap_used
            else None,
            "wal_records": counts.get("records", 0),
            "torn_records": counts.get("torn", 0),
            "objects": len(objs),
            "rv": max_rv,
        }
        return max_rv, objs

    # -- append path -------------------------------------------------------

    def _wal_file(self):
        if self._f is None:
            gens = self._generations(_WAL_PREFIX)
            path = (gens[-1][1] if gens else
                    os.path.join(self.dir, _gen_name(_WAL_PREFIX, 0)
                                 + ".log"))
            torn_tail = False
            if os.path.exists(path) and os.path.getsize(path) > 0:
                with open(path, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    torn_tail = rf.read(1) != b"\n"
            self._f = open(path, "a")
            if torn_tail:
                # a prior crash tore the final line (that record was
                # never acknowledged): terminate the garbage as its own
                # unparseable line, or the NEXT acknowledged append
                # would glue onto it and be lost at the following
                # recovery
                self._f.write("\n")
                self._f.flush()
        return self._f

    def _guard(self):
        """The seal-order guard (store lock before journal lock) when
        shipping is on; free otherwise. Committing threads already hold
        the store lock — an RLock, so re-acquiring is order-keeping,
        not blocking."""
        g = self.seal_guard
        return g if g is not None else contextlib.nullcontext()

    def _append(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        with self._guard(), self._lock:
            f = self._wal_file()
            f.write(line)
            # flush every record: write(2)-level durability (survives a
            # process crash); fsync (power loss) is the batched one
            f.flush()
            self.appends += 1
            self._since_fsync += 1
            if self.on_seal is not None:
                self._pending_ship.append(rec)
                self._pending_bytes += len(line)
            if self._since_fsync >= self.fsync_every:
                self._fsync()
        if self.metrics is not None:
            self.metrics.journal_appends.inc()

    def _fsync(self) -> None:
        """Caller holds ``self._lock``."""
        if self._f is None:
            return
        t0 = self._timer()
        if self.fsync_hook is not None:
            self.fsync_hook()
        os.fsync(self._f.fileno())
        if self.metrics is not None:
            self.metrics.journal_fsync.observe(
                max(self._timer() - t0, 0.0))
        self._since_fsync = 0
        if self.on_seal is not None and self._pending_ship:
            # the batch this fsync just made durable IS the replication
            # shipping unit (docs/replication.md): hand it over before
            # anything else can append. Still under the journal lock, so
            # batches ship in seal order; followers must never write
            # back through this journal (documented, and they don't —
            # they apply into their own stores).
            batch, nbytes = self._pending_ship, self._pending_bytes
            self._pending_ship, self._pending_bytes = [], 0
            self.on_seal(batch, nbytes)

    def append_commit(self, key: tuple, obj: dict, rv: int) -> None:
        self._append({"t": "c", "rv": rv,
                      "ts": round(self._clock(), 6),
                      "k": list(key), "o": obj})
        self._since_snapshot += 1

    def append_delete(self, key: tuple, rv: int) -> None:
        self._append({"t": "d", "rv": rv,
                      "ts": round(self._clock(), 6), "k": list(key)})

    def snapshot_due(self) -> bool:
        return self._since_snapshot >= self.snapshot_every

    def claim_snapshot(self) -> bool:
        """Atomically claim the due checkpoint (resets the commit
        counter so concurrent writers don't double-snapshot). The
        APIServer calls this under its store lock together with the
        O(dict-size) shallow grab of the snapshot values, then runs
        :meth:`write_snapshot` with the lock released."""
        if self._since_snapshot < self.snapshot_every:
            return False
        self._since_snapshot = 0
        return True

    def write_snapshot(self, rv: int, snaps: dict) -> None:
        """Checkpoint: serialize the store's (already immutable)
        per-object read snapshots, rotate the WAL, drop old generations.
        Runs OUTSIDE the store lock — commits racing the checkpoint land
        in the pre-rotation WAL generation and are replayed by the
        ``rv > snapshot_rv`` filter. Crash-safe at every step — the old
        (snapshot, WAL) pair survives until the new snapshot is durably
        renamed into place."""
        # 1. durable snapshot first: tmp -> fsync -> rename (no journal
        # state touched yet, so a crash here leaves the old pair whole)
        final = os.path.join(self.dir, _gen_name(_SNAP_PREFIX, rv)
                             + ".json")
        tmp = final + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"rv": rv, "ts": round(self._clock(), 6),
                       "objects": list(snaps.values())}, f,
                      separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        # seal_guard before the journal lock (lock-order contract): the
        # async checkpoint worker reaches this without the store lock,
        # and the rotation's _fsync may ship
        with self._guard(), self._lock:
            # 2. seal the current WAL and open the post-rv generation
            if self._f is not None:
                self._fsync()
                self._f.close()
            self._f = open(os.path.join(self.dir,
                                        _gen_name(_WAL_PREFIX, rv)
                                        + ".log"), "a")
            # 3. old snapshots are redundant; old WAL generations are
            # NOT judged by their filename rv — the name bounds a file's
            # MINIMUM record rv, and the generation just sealed can hold
            # records ABOVE this snapshot's rv (commits racing the
            # checkpoint land there by design). Keep the current and the
            # most recent sealed generation; anything older was sealed
            # before the previous checkpoint claimed its rv, so all its
            # records are <= this snapshot's rv and safely folded in.
            # Recovery's rv filter makes the retained extra file free.
            # retain_all (forensics mode) keeps every generation so
            # WorldLine can time-travel to any rv since journal birth.
            if not self.retain_all:
                for gen_rv, path in self._generations(_SNAP_PREFIX):
                    if gen_rv < rv:
                        os.unlink(path)
                wals = self._generations(_WAL_PREFIX)
                for gen_rv, path in wals[:-2]:
                    os.unlink(path)
            self.snapshots_written += 1
        if self.metrics is not None:
            self.metrics.snapshot_writes.inc()
        if self.on_snapshot is not None:
            self.on_snapshot(rv)

    def reopen(self) -> None:
        """Position the journal to append — sealing any torn tail a
        crashed writer left — WITHOUT running recovery. The promotion
        path (docs/replication.md): the new leader's store is already
        caught up from shipped batches plus the tail replay, so only the
        file positioning half of single-process recovery is needed."""
        with self._lock:
            self._wal_file()

    def successor(self) -> "Journal":
        """A fresh journal over the same directory with the same knobs —
        what a promoted follower opens to inherit the dead leader's WAL
        (docs/replication.md). The dead instance's handle is abandoned
        un-closed, exactly as a SIGKILL leaves it; the successor's first
        append (or an explicit :meth:`reopen`) seals any torn tail."""
        return Journal(self.dir, snapshot_every=self.snapshot_every,
                       fsync_every=self.fsync_every, metrics=self.metrics,
                       timer=self._timer, fsync_hook=self.fsync_hook,
                       clock=self._clock, retain_all=self.retain_all)

    def flush(self) -> None:
        """Force the fsync boundary (shutdown path)."""
        with self._guard(), self._lock:
            self._fsync()

    def close(self) -> None:
        with self._guard(), self._lock:
            if self._f is not None:
                self._fsync()
                self._f.close()
                self._f = None
