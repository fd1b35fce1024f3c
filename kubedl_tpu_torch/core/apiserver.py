"""In-memory Kubernetes-compatible API server with an indexed read path.

Plays two roles, mirroring how the reference tests everything against
controller-runtime's fake client (reference ``controllers/suite_tests/
suite_test.go:40-66`` builds ``fake.NewFakeClientWithScheme``):

1. the **fake client** for the whole test pyramid (no cluster needed), and
2. a **standalone control plane**: kubedl-tpu can run self-hosted on a TPU VM
   with no Kubernetes at all, reconciling CRs submitted through this store.

Semantics implemented (the subset the operator relies on):

* CRUD with optimistic concurrency (``resourceVersion`` conflict on update),
* ``metadata.generation`` bump on spec change (k8s semantics: status updates
  do not bump generation),
* finalizers: delete sets ``deletionTimestamp`` while finalizers remain; the
  object is removed once the last finalizer is stripped,
* cascading deletion of controller-owned dependents (background GC),
* watch fan-out: subscribers receive ``(event_type, obj)`` tuples for
  ADDED / MODIFIED / DELETED, the signal controller-runtime feeds workqueues
  from (reference ``controllers/pytorch/pytorchjob_controller.go:148-185``).

Read-path scale model (docs/control-plane-perf.md):

* **Copy-on-write storage.** Every write commits a fresh object (the store
  never mutates a committed object in place) plus one shared read snapshot.
  ``list()``/``list_indexed()``/``list_owned()`` and watch callbacks all
  hand out that *shared* snapshot — mutating it cannot corrupt the store
  (the canonical object is separate), but readers must treat what they are
  handed as frozen; copy before mutating (``get()`` still returns a private
  copy, it is the mutate-then-``update()`` API).
* **Informer-style indexes**, maintained incrementally on every commit:
  kind, (kind, namespace), label postings, ownerReference UID, plus custom
  indexers registered with :meth:`add_indexer` (client-go ``cache.Indexer``
  shape). ``list(kind, ns, selector)`` touches only matching objects
  instead of scanning the world.
* **Modes** (``list_mode`` attribute, env ``KUBEDL_LIST_MODE``):
  ``index`` (default), ``scan`` (the pre-index brute-force path with a
  deepcopy per match — kept as the benchmark baseline), and ``parity``
  (compute both, raise if they ever diverge — chaos/property tests run in
  this mode to keep the indexes honest).

Copied from ``kubedl_tpu/core/apiserver.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import copy
import os
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional

from . import meta as m

Obj = dict

ENV_LIST_MODE = "KUBEDL_LIST_MODE"
LIST_MODES = ("index", "scan", "parity")


class ApiError(Exception):
    pass


class NotFound(ApiError):
    pass


class AlreadyExists(ApiError):
    pass


class Conflict(ApiError):
    pass


class Invalid(ApiError):
    pass


class ServerError(ApiError):
    """Transient 5xx-class failure (apiserver overloaded, etcd leader
    election, connection reset). The in-memory store never raises this on
    its own; the chaos harness (``controllers.chaos``) injects it, and the
    engine's jittered retry helper is what must absorb it."""


class Timeout(ServerError):
    """Request timed out — the caller cannot know whether the write
    committed, so retries must tolerate AlreadyExists/NotFound echoes."""


class IndexParityError(AssertionError):
    """Raised in ``parity`` mode when an indexed read disagrees with the
    brute-force scan — an index-maintenance bug (or a reader mutating a
    shared snapshot it was handed)."""


class TooOldResourceVersion(ApiError):
    """A bookmark-resumed watch (``watch_from``) asked for events older
    than the bounded event ring still holds (or the ring is disabled):
    the caller must fall back to a full relist, exactly like a client-go
    reflector on a 410 Gone."""


_ts = m.rfc3339

#: the JSON-tree copier (``meta.deep_copy``); the ``scan`` baseline keeps
#: stock ``copy.deepcopy`` so benchmarks compare the true pre-index path
_fast_deepcopy = m.deep_copy


_labels_of = m.get_labels


def _owner_refs_of(obj: Obj) -> list:
    return (obj.get("metadata") or {}).get("ownerReferences") or []


def _event_involved_uid(ev: Obj) -> list:
    uid = (ev.get("involvedObject") or {}).get("uid")
    return [uid] if uid else []


def _event_involved_name(ev: Obj) -> list:
    name = (ev.get("involvedObject") or {}).get("name")
    return [name] if name else []


class APIServer:
    """Thread-safe in-memory object store with watch fan-out."""

    def __init__(self, clock: Callable[[], float] = time.time,
                 admission=None, list_mode: Optional[str] = None,
                 uid_factory: Optional[Callable[[], str]] = None,
                 preset_uid_kinds: tuple = ("SLO",),
                 journal=None, watch_ring: int = 0,
                 durability_metrics=None, async_snapshots: bool = False):
        self._clock = clock
        #: kinds whose creates honor a caller-supplied metadata.uid (the
        #: deterministic-replay seam — see create()). Deliberately an
        #: explicit allowlist of cluster-scoped control objects: honoring
        #: preset uids globally would let a stale fetched dict recreate
        #: an object under its OLD uid, confusing every uid-keyed
        #: controller state map
        self._preset_uid_kinds = tuple(preset_uid_kinds)
        #: uid source for created objects. Defaults to random uuid4; the
        #: replay rig injects a counter-derived factory because uids feed
        #: deterministic derivations downstream (trace ids, per-job
        #: restart-backoff jitter keys) and the scorecard must be
        #: bit-for-bit reproducible for a fixed seed
        self._new_uid = uid_factory or m.new_uid
        #: canonical committed objects — server-private, never handed out
        self._objs: dict[tuple[str, str, str], Obj] = {}
        #: shared read snapshots, one per object, replaced on every commit;
        #: what list()/watch hand out (readers share them, the store does
        #: not read them back, so a misbehaving reader cannot corrupt state)
        self._snaps: dict[tuple[str, str, str], Obj] = {}
        # -- incremental indexes (all map to key sets into _objs) ----------
        self._kind_keys: dict[str, set] = {}
        self._ns_keys: dict[tuple[str, str], set] = {}
        self._label_idx: dict[tuple[str, str, str], set] = {}
        self._owner_idx: dict[str, set] = {}
        self._custom_idx: dict[tuple[str, str, str], set] = {}
        self._indexers: dict[str, dict[str, Callable[[Obj], Iterable]]] = {}
        self._rv = 0
        self._lock = threading.RLock()
        self._watchers: list[Callable[[str, Obj], None]] = []
        #: optional AdmissionChain run at create/update (webhook analog:
        #: defaulting + validation happen at admission, not mid-reconcile)
        self.admission = admission
        mode = list_mode or os.environ.get(ENV_LIST_MODE, "") or "index"
        if mode not in LIST_MODES:
            raise ValueError(f"unknown list mode {mode!r} (know {LIST_MODES})")
        self.list_mode = mode
        # Event lookups the Recorder/console need (involvedObject is not an
        # ownerReference when the involved object had no uid yet)
        self.add_indexer("Event", "involved-uid", _event_involved_uid)
        self.add_indexer("Event", "involved-name", _event_involved_name)
        # -- durability (docs/durability.md; all None/0 by default so the
        # gate-off store is byte-identical to the pre-durability path) ----
        self._journal = None
        self._ring_size = 0
        self._event_ring: dict[str, object] = {}
        self._ring_floor: dict[str, int] = {}
        self._ring_base = 0
        self._dur_metrics = None
        #: replication apply levels for DELETED records (docs/
        #: replication.md): removal pops the object and with it the rv
        #: the level guards compare against, so a re-shipped stale
        #: commit could resurrect a deleted object without this map.
        #: Populated only by apply_replicated — a non-follower store
        #: never touches it. Bounded, insertion-ordered.
        self._replica_dead: dict[tuple, int] = {}
        # async checkpointing (docs/replication.md): the O(world)
        # snapshot serializer runs on a dedicated worker so neither
        # commits nor WAL shipping ever wait on it. Off by default —
        # the synchronous path is the unreplicated behavior.
        self._snap_async = bool(async_snapshots)
        self._ckpt_queue = None
        self._ckpt_thread = None
        if journal is not None or watch_ring or durability_metrics:
            self.enable_durability(journal=journal, watch_ring=watch_ring,
                                   metrics=durability_metrics)

    # -- durability (WAL + snapshots + resumable watches) ------------------

    def enable_durability(self, journal=None, watch_ring: int = 4096,
                          metrics=None,
                          async_snapshots: Optional[bool] = None) -> None:
        """Attach the durability layer (docs/durability.md): a
        :class:`~kubedl_tpu_torch.core.journal.Journal` whose existing state is
        recovered into the store (resuming the ``resourceVersion``
        counter), and a bounded per-kind event ring serving
        bookmark-resumed watches (:meth:`watch_from`). Call before the
        first write — recovered objects do not re-run admission and do
        not emit watch events (a restarting operator relists once).

        While durability is on, deletes allocate a resourceVersion
        (etcd's revision-per-delete): WAL replay and ring bookmarks both
        need every post-snapshot mutation ordered above the snapshot."""
        with self._lock:
            if metrics is not None:
                self._dur_metrics = metrics
            if async_snapshots is not None:
                self._snap_async = bool(async_snapshots)
            if watch_ring and not self._ring_size:
                # the ring's base marks "events before this rv are not
                # replayable" — set once, when buffering starts
                self._ring_size = max(int(watch_ring), 0)
                self._ring_base = self._rv
            if journal is not None and self._journal is None:
                self._journal = journal
                if self._dur_metrics is not None and journal.metrics is None:
                    journal.metrics = self._dur_metrics
                rv, objs = journal.recover()
                for k, obj in objs.items():
                    self._objs[k] = obj
                    self._index_add(k, obj)
                    self._snaps[k] = self._dc(obj)
                self._rv = max(self._rv, rv)
                self._ring_base = max(self._ring_base, self._rv)
                if self._dur_metrics is not None:
                    # recovery provenance as an info metric — which
                    # snapshot generation this world came from, for
                    # post-crash forensics (docs/forensics.md)
                    rf = journal.recovered_from
                    self._dur_metrics.journal_recovered.set(
                        1.0,
                        snapshot_rv=rf["snapshot_rv"],
                        snapshot_file=rf["snapshot_file"] or "",
                        wal_records=rf["wal_records"],
                        torn_records=rf["torn_records"],
                        objects=rf["objects"], rv=rf["rv"])

    @property
    def _durable(self) -> bool:
        return self._journal is not None or self._ring_size > 0

    def _ring_append(self, kind: str, event_type: str, snap: Obj,
                     seq: int) -> None:
        ring = self._event_ring.get(kind)
        if ring is None:
            ring = self._event_ring[kind] = deque()
        if len(ring) >= self._ring_size:
            evicted = ring.popleft()
            floor = self._ring_floor.get(kind, self._ring_base)
            self._ring_floor[kind] = max(floor, evicted[0])
        ring.append((seq, event_type, snap))

    def _journal_commit(self, k, snap: Obj, old: Optional[Obj]) -> None:
        """Durability hooks for one commit — caller holds the lock and
        just cut ``snap`` at resourceVersion ``self._rv``."""
        if self._ring_size:
            self._ring_append(k[0], "ADDED" if old is None else "MODIFIED",
                              snap, self._rv)
        if self._journal is not None:
            self._journal.append_commit(k, snap, self._rv)

    def _maybe_snapshot(self) -> None:
        """Checkpoint when due — called on the write entry points AFTER
        the store lock is released. The O(world) serialization must not
        stall reads/writes, so only the shallow value grab happens under
        the lock (the per-object snapshots are immutable by contract —
        the dump serializes them in place); commits racing the dump land
        in the pre-rotation WAL and replay via the rv filter."""
        j = self._journal
        if j is None or not j.snapshot_due():
            return
        with self._lock:
            if not j.claim_snapshot():
                return                  # another writer claimed it
            rv, snaps = self._rv, dict(self._snaps)
        if self._snap_async:
            # truly non-blocking checkpoints (docs/replication.md): the
            # (rv, snaps) pair was captured under the lock — the
            # per-object snapshots are immutable by the COW contract, so
            # the serializer can run fully concurrent with commits AND
            # with WAL shipping; only the file dump is deferred
            self._ckpt_submit(j, rv, snaps)
            return
        j.write_snapshot(rv, snaps)

    def _ckpt_submit(self, journal, rv: int, snaps: dict) -> None:
        import queue
        with self._lock:
            if self._ckpt_queue is None:
                self._ckpt_queue = queue.Queue()
                self._ckpt_thread = threading.Thread(
                    target=self._ckpt_worker, name="kubedl-checkpoint",
                    daemon=True)
                self._ckpt_thread.start()
        self._ckpt_queue.put((journal, rv, snaps))

    def _ckpt_worker(self) -> None:
        while True:
            journal, rv, snaps = self._ckpt_queue.get()
            try:
                journal.write_snapshot(rv, snaps)
            except Exception:  # noqa: BLE001 — a failed checkpoint must
                # not kill the worker: the WAL alone still recovers, and
                # the next due checkpoint retries the dump
                import logging
                logging.getLogger("kubedl_tpu_torch.apiserver").exception(
                    "async checkpoint at rv %d failed", rv)
            finally:
                self._ckpt_queue.task_done()

    def wait_for_checkpoints(self) -> None:
        """Block until every queued async checkpoint has been written
        (tests and orderly shutdown; a no-op in synchronous mode)."""
        if self._ckpt_queue is not None:
            self._ckpt_queue.join()

    # -- replication (docs/replication.md) --------------------------------

    def world_snapshot(self) -> tuple:
        """``(rv, {key: snapshot})`` — the same shallow grab of the
        immutable per-object snapshots a checkpoint claims, for shipping
        a catch-up manifest to a gapped follower."""
        with self._lock:
            return self._rv, dict(self._snaps)

    def adopt_journal(self, journal) -> None:
        """Attach an already-positioned journal WITHOUT running recovery
        — the promotion seam: the store is already caught up (shipped
        batches + the inherited WAL tail replay), so re-reading the
        journal would be wasted work at best and a double-apply at
        worst. Future commits append through the adopted journal."""
        with self._lock:
            self._journal = journal
            if self._dur_metrics is not None and journal.metrics is None:
                journal.metrics = self._dur_metrics

    def apply_replicated(self, rec: dict) -> bool:
        """Apply one shipped WAL record ({"t","rv","k","o"}) under the
        level-based informer-cache rules (docs/replication.md), so
        duplicated, re-shipped, and reordered batches are idempotent:

        * a commit applies only when its rv is above BOTH the stored
          object's rv and any remembered deletion level for the key;
        * a delete applies only when its rv is above the stored rv, and
          its level is remembered so a stale re-shipped commit cannot
          resurrect the object;
        * the store's rv counter only ever moves forward.

        Applied records ride the watch ring and fan out to watchers —
        a follower serves reads and ``watch_from`` like any store.
        Never journals (the records already live in the leader's WAL).
        Returns whether the record changed the store."""
        k = tuple(rec["k"])
        rv = int(rec["rv"])
        snap = None
        event = None
        with self._lock:
            cur = self._objs.get(k)
            cur_rv = m.resource_version(cur) if cur is not None else 0
            if rv <= max(cur_rv, self._replica_dead.get(k, 0)):
                return False
            self._rv = max(self._rv, rv)
            if rec["t"] == "c":
                obj = rec["o"]
                if cur is not None:
                    self._index_remove(k, cur)
                # the shipped object is the leader's frozen read
                # snapshot — immutable by contract, safe to adopt as
                # this store's canonical; the follower cuts its OWN
                # read snapshot so its readers share nothing mutable
                self._objs[k] = obj
                self._index_add(k, obj)
                snap = self._dc(obj)
                self._snaps[k] = snap
                self._replica_dead.pop(k, None)
                event = "ADDED" if cur is None else "MODIFIED"
                if self._ring_size:
                    self._ring_append(k[0], event, snap, rv)
            else:                       # "d"
                self._replica_dead[k] = rv
                while len(self._replica_dead) > 4096:
                    self._replica_dead.pop(next(iter(self._replica_dead)))
                if cur is None:
                    return True         # level advanced; nothing stored
                self._index_remove(k, cur)
                del self._objs[k]
                snap = self._snaps.pop(k, None) or self._dc(cur)
                snap = dict(snap)
                snap["metadata"] = dict(snap.get("metadata") or {},
                                        resourceVersion=rv)
                event = "DELETED"
                if self._ring_size:
                    self._ring_append(k[0], event, snap, rv)
        if event is not None:
            self._emit(event, snap)
        return True

    def install_replica_snapshot(self, rv: int, objects) -> None:
        """Replace the whole world from a shipped snapshot manifest —
        the catch-up path for a follower that joined late or fell
        behind the shipping stream. Watchers are NOT notified (a
        follower being resynced has no caught-up consumers by
        definition — they resume by bookmark afterwards); the ring
        restarts at ``rv`` since pre-manifest history is gone."""
        rv = int(rv)
        with self._lock:
            for k in list(self._objs):
                self._index_remove(k, self._objs[k])
            self._objs.clear()
            self._snaps.clear()
            self._replica_dead.clear()
            for obj in objects:
                md = obj.get("metadata") or {}
                k = (obj.get("kind", ""), md.get("namespace", "default"),
                     md.get("name", ""))
                self._objs[k] = obj
                self._index_add(k, obj)
                self._snaps[k] = self._dc(obj)
            self._rv = max(self._rv, rv)
            self._event_ring.clear()
            self._ring_floor.clear()
            self._ring_base = self._rv

    def watch_from(self, fn: Callable[[str, Obj], None],
                   resource_version: int,
                   kinds: Optional[Iterable[str]] = None):
        """Bookmark-resumed watch: replay buffered events with
        ``rv > resource_version`` from the bounded per-kind ring, then
        stream live. Returns ``(cancel, caught_up_rv)`` — the caller's
        next bookmark. Raises :class:`TooOldResourceVersion` (counted in
        ``kubedl_watch_relists_total{reason}``) when the bookmark has
        been evicted, or the ring is disabled: fall back to a full
        relist, like a reflector on 410 Gone.

        Replayed events are delivered after the live subscription is
        registered; with concurrent writers a replayed event can arrive
        after a newer live one — consumers must be level-based and drop
        events whose resourceVersion is older than what they hold (the
        informer cache guards every apply exactly so)."""
        bookmark = int(resource_version)
        with self._lock:
            if not self._ring_size:
                if self._dur_metrics is not None:
                    self._dur_metrics.watch_relists.inc(
                        reason="ring_disabled")
                raise TooOldResourceVersion("watch event ring disabled")
            ks = tuple(kinds) if kinds is not None \
                else tuple(self._event_ring)
            for kd in ks:
                floor = self._ring_floor.get(kd, self._ring_base)
                if bookmark < floor:
                    if self._dur_metrics is not None:
                        self._dur_metrics.watch_relists.inc(
                            reason="too_old")
                    raise TooOldResourceVersion(
                        f"bookmark {bookmark} older than the {kd} ring "
                        f"floor {floor}")
            replay = sorted(
                e for kd in ks for e in self._event_ring.get(kd, ())
                if e[0] > bookmark)
            caught_up = self._rv
            self._watchers.append(fn)

        def cancel():
            with self._lock:
                if fn in self._watchers:
                    self._watchers.remove(fn)

        for _seq, event_type, snap in replay:
            fn(event_type, snap)
        return cancel, caught_up

    # -- helpers ----------------------------------------------------------

    def now(self) -> float:
        return self._clock()

    def _key(self, kind: str, namespace: str, name: str):
        return (kind, namespace, name)

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    def _dc(self, o):
        """The store's object copier: seed-exact ``copy.deepcopy`` in scan
        mode, the JSON-tree fast path otherwise."""
        return copy.deepcopy(o) if self.list_mode == "scan" else _fast_deepcopy(o)

    def _emit(self, event_type: str, snap: Obj):
        """Fan an event out to every watcher. All watchers share ONE
        snapshot per event (it is already distinct from the canonical
        stored object). ``scan`` mode keeps the pre-index behavior —
        one deepcopy per watcher — as the benchmark baseline."""
        if self.list_mode == "scan":
            for w in list(self._watchers):
                w(event_type, copy.deepcopy(snap))
            return
        for w in list(self._watchers):
            w(event_type, snap)

    def watch(self, fn: Callable[[str, Obj], None]) -> Callable[[], None]:
        """Subscribe to all object events. Returns an unsubscribe fn.

        Delivered objects are shared snapshots: treat them as frozen.
        Mutating one cannot corrupt the store, but it will corrupt what
        every other watcher and cached reader of the same event sees."""
        with self._lock:
            self._watchers.append(fn)

        def cancel():
            with self._lock:
                if fn in self._watchers:
                    self._watchers.remove(fn)
        return cancel

    # -- index maintenance -------------------------------------------------

    def add_indexer(self, kind: str, name: str,
                    fn: Callable[[Obj], Iterable]) -> None:
        """Register a custom index over ``kind`` (client-go ``cache.Indexer``
        shape): ``fn(obj)`` returns the index values the object files under.
        Existing objects are backfilled; query with :meth:`list_indexed`."""
        with self._lock:
            self._indexers.setdefault(kind, {})[name] = fn
            for k in self._kind_keys.get(kind, ()):
                obj = self._objs[k]
                for v in fn(obj) or ():
                    self._custom_idx.setdefault((kind, name, str(v)),
                                                set()).add(k)

    def _index_add(self, k, obj: Obj) -> None:
        kind, ns = k[0], k[1]
        self._kind_keys.setdefault(kind, set()).add(k)
        self._ns_keys.setdefault((kind, ns), set()).add(k)
        for lk, lv in _labels_of(obj).items():
            self._label_idx.setdefault((kind, lk, str(lv)), set()).add(k)
        for ref in _owner_refs_of(obj):
            uid = ref.get("uid")
            if uid:
                self._owner_idx.setdefault(uid, set()).add(k)
        for name, fn in self._indexers.get(kind, {}).items():
            for v in fn(obj) or ():
                self._custom_idx.setdefault((kind, name, str(v)), set()).add(k)

    def _index_remove(self, k, obj: Obj) -> None:
        kind, ns = k[0], k[1]

        def drop(table: dict, tk) -> None:
            keys = table.get(tk)
            if keys is not None:
                keys.discard(k)
                if not keys:
                    del table[tk]

        drop(self._kind_keys, kind)
        drop(self._ns_keys, (kind, ns))
        for lk, lv in _labels_of(obj).items():
            drop(self._label_idx, (kind, lk, str(lv)))
        for ref in _owner_refs_of(obj):
            uid = ref.get("uid")
            if uid:
                drop(self._owner_idx, uid)
        for name, fn in self._indexers.get(kind, {}).items():
            for v in fn(obj) or ():
                drop(self._custom_idx, (kind, name, str(v)))

    def _commit(self, k, new: Obj) -> Obj:
        """Replace (or insert) the canonical object at ``k`` and cut the
        shared read snapshot. Caller holds the lock and relinquishes all
        references to ``new``. Returns the snapshot to emit.

        Baseline-cost accounting (scan mode): the snapshot deepcopy here
        stands in for the pre-index path's store-side deepcopy (the seed
        did ``self._objs[k] = copy.deepcopy(new)`` on every write), so
        scan-mode writes pay the same copy count as the seed; the only
        extra is the index bookkeeping (~2% of write cost), which keeps
        the benchmark baseline honest without forking the write path."""
        old = self._objs.get(k)
        if old is not None:
            self._index_remove(k, old)
        self._objs[k] = new
        self._index_add(k, new)
        snap = self._dc(new)
        self._snaps[k] = snap
        if self._durable:
            self._journal_commit(k, snap, old)
        return snap

    # -- CRUD -------------------------------------------------------------

    def create(self, obj: Obj) -> Obj:
        obj = self._dc(obj)
        md = m.meta(obj)
        if not md.get("name"):
            if md.get("generateName"):
                # the uid's TAIL: unique under both uuid4 (random hex)
                # and counter-based factories ("replay-0-00000042",
                # whose first 8 chars are a constant prefix)
                md["name"] = md["generateName"] + self._new_uid()[-8:]
            else:
                raise Invalid("object has no metadata.name")
        md.setdefault("namespace", "default")
        if self.admission is not None and self.admission.handles(m.kind(obj)):
            obj = self.admission.admit(obj)  # raises Invalid on rejection
            md = m.meta(obj)
        k = self._key(m.kind(obj), md["namespace"], md["name"])
        with self._lock:
            if k in self._objs:
                raise AlreadyExists(f"{m.kind(obj)} {md['namespace']}/{md['name']} already exists")
            # a pre-set uid is honored for allowlisted control kinds
            # only (deterministic-replay seam: the cluster replay
            # creates its default SLO set with explicit uids so control
            # objects never consume the counter-derived factory that
            # job trace ids and backoff jitter key on); every other
            # kind always gets a fresh uid — uid-keyed controller state
            # must never see a recreated object under its old identity
            if not md.get("uid") \
                    or m.kind(obj) not in self._preset_uid_kinds:
                md["uid"] = self._new_uid()
            md["resourceVersion"] = self._next_rv()
            md["generation"] = 1
            md["creationTimestamp"] = _ts(self.now())
            snap = self._commit(k, obj)
        self._emit("ADDED", snap)
        self._maybe_snapshot()
        return self._dc(snap)

    def get(self, kind: str, namespace: str, name: str) -> Obj:
        """A private deep copy — the one read API whose result the caller
        may mutate and hand back to ``update()``."""
        with self._lock:
            k = self._key(kind, namespace, name)
            if k not in self._objs:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            return self._dc(self._objs[k])

    def try_get(self, kind: str, namespace: str, name: str) -> Optional[Obj]:
        try:
            return self.get(kind, namespace, name)
        except NotFound:
            return None

    # -- list (indexed read path) -----------------------------------------

    def list(self, kind: str, namespace: Optional[str] = None,
             selector: Optional[dict] = None,
             field_selector: Optional[object] = None) -> list[Obj]:
        """Objects of ``kind`` matching namespace/label/field filters,
        sorted by (namespace, name). Returns shared snapshots — treat them
        as frozen (copy before mutating)."""
        fields = _parse_field_selector(field_selector)
        with self._lock:
            if self.list_mode == "scan":
                return self._scan_list(kind, namespace, selector, fields,
                                       copy_out=True)
            out = self._indexed_list(kind, namespace, selector, fields)
            if self.list_mode == "parity":
                want = self._scan_list(kind, namespace, selector, fields,
                                       copy_out=False)
                self._check_parity("list", (kind, namespace, selector,
                                            field_selector), out, want)
            return out

    def list_indexed(self, kind: str, index: str, value,
                     namespace: Optional[str] = None) -> list[Obj]:
        """Objects of ``kind`` filed under ``value`` in the custom ``index``
        (see :meth:`add_indexer`). Shared snapshots, sorted."""
        with self._lock:
            fn = self._indexers.get(kind, {}).get(index)
            if fn is None:
                raise KeyError(f"no index {index!r} on kind {kind!r}")
            if self.list_mode != "scan":
                keys = self._custom_idx.get((kind, index, str(value)), ())
                if namespace is not None:
                    keys = [k for k in keys if k[1] == namespace]
                out = sorted((self._snaps[k] for k in keys),
                             key=lambda o: (m.namespace(o), m.name(o)))
                if self.list_mode == "parity":
                    want = self._scan_indexed(kind, fn, value, namespace)
                    self._check_parity("list_indexed",
                                       (kind, index, value, namespace),
                                       out, want)
                return out
            return [copy.deepcopy(o)
                    for o in self._scan_indexed(kind, fn, value, namespace)]

    def list_owned(self, kind: str, owner_uid: str,
                   namespace: Optional[str] = None) -> list[Obj]:
        """Objects of ``kind`` carrying an ownerReference to ``owner_uid``
        — the owner-pod lookup every reconcile does, without scanning the
        namespace. Shared snapshots, sorted."""
        with self._lock:
            if self.list_mode != "scan":
                keys = [k for k in self._owner_idx.get(owner_uid, ())
                        if k[0] == kind
                        and (namespace is None or k[1] == namespace)]
                out = sorted((self._snaps[k] for k in keys),
                             key=lambda o: (m.namespace(o), m.name(o)))
                if self.list_mode == "parity":
                    want = self._scan_owned(kind, owner_uid, namespace)
                    self._check_parity("list_owned",
                                       (kind, owner_uid, namespace),
                                       out, want)
                return out
            return [copy.deepcopy(o)
                    for o in self._scan_owned(kind, owner_uid, namespace)]

    def _candidate_keys(self, kind: str, namespace: Optional[str],
                        selector: Optional[dict]):
        base = (self._ns_keys.get((kind, namespace), set())
                if namespace is not None
                else self._kind_keys.get(kind, set()))
        if not base or not selector:
            return base
        ml = (selector.get("matchLabels", {})
              if ("matchLabels" in selector or "matchExpressions" in selector)
              else selector)
        postings = [self._label_idx.get((kind, lk, str(lv)), set())
                    for lk, lv in (ml or {}).items()]
        if not postings:
            return base
        if any(not p for p in postings):
            return set()
        # intersect starting from the rarest posting list
        postings.sort(key=len)
        out = postings[0] & base
        for p in postings[1:]:
            out &= p
        return out

    def _indexed_list(self, kind, namespace, selector, fields) -> list[Obj]:
        out = []
        for k in self._candidate_keys(kind, namespace, selector):
            obj = self._objs[k]
            # label postings prefilter only; matchExpressions (and exact
            # equality semantics) are re-applied so index and scan agree
            if selector is not None and not m.match_labels(
                    _labels_of(obj), selector):
                continue
            if any(str(m.get_in(obj, *path.split("."), default=""))
                   != want for path, want in fields):
                continue
            out.append(self._snaps[k])
        out.sort(key=lambda o: (m.namespace(o), m.name(o)))
        return out

    def _scan_list(self, kind, namespace, selector, fields,
                   copy_out: bool) -> list[Obj]:
        """The pre-index brute-force path, verbatim: scan the world, filter,
        deepcopy each match (``copy_out=False`` skips the copies when the
        result is only compared for parity)."""
        out = []
        for (kd, ns, _), obj in self._objs.items():
            if kd != kind:
                continue
            if namespace is not None and ns != namespace:
                continue
            if selector is not None and not m.match_labels(
                    _labels_of(obj), selector):
                continue
            if any(str(m.get_in(obj, *path.split("."), default=""))
                   != want for path, want in fields):
                continue
            out.append(copy.deepcopy(obj) if copy_out else obj)
        out.sort(key=lambda o: (m.namespace(o), m.name(o)))
        return out

    def _scan_indexed(self, kind, fn, value, namespace) -> list[Obj]:
        out = [obj for k, obj in self._objs.items()
               if k[0] == kind and (namespace is None or k[1] == namespace)
               and str(value) in {str(v) for v in fn(obj) or ()}]
        out.sort(key=lambda o: (m.namespace(o), m.name(o)))
        return out

    def _scan_owned(self, kind, owner_uid, namespace) -> list[Obj]:
        out = [obj for k, obj in self._objs.items()
               if k[0] == kind and (namespace is None or k[1] == namespace)
               and any(r.get("uid") == owner_uid for r in _owner_refs_of(obj))]
        out.sort(key=lambda o: (m.namespace(o), m.name(o)))
        return out

    def _check_parity(self, op: str, query, indexed: list, scanned: list):
        if indexed != scanned:
            got = [(m.namespace(o), m.name(o), m.resource_version(o))
                   for o in indexed]
            want = [(m.namespace(o), m.name(o), m.resource_version(o))
                    for o in scanned]
            raise IndexParityError(
                f"index/scan divergence in {op}{query!r}: "
                f"indexed={got} scan={want}"
                + ("" if got != want else
                   " (same objects, differing content — a reader mutated "
                   "a shared snapshot)"))

    # -- writes ------------------------------------------------------------

    def update(self, obj: Obj, subresource: Optional[str] = None) -> Obj:
        """Full replace with optimistic concurrency.

        ``subresource="status"`` replaces only ``.status`` (generation not
        bumped); otherwise spec/meta are replaced and generation bumps when
        the spec changed.
        """
        if subresource == "status":
            # the status path only reads metadata (RV check) and copies
            # ``.status``; skip deepcopying the caller's whole object
            md = obj.get("metadata") or {}
        else:
            obj = self._dc(obj)
            if (self.admission is not None
                    and self.admission.handles(m.kind(obj))):
                obj = self.admission.admit(obj)
            md = m.meta(obj)
        k = self._key(m.kind(obj), md.get("namespace", "default"), md.get("name", ""))
        with self._lock:
            if k not in self._objs:
                raise NotFound(f"{m.kind(obj)} {md.get('namespace')}/{md.get('name')} not found")
            cur = self._objs[k]
            cur_rv = m.resource_version(cur)
            if md.get("resourceVersion") and int(md["resourceVersion"]) != cur_rv:
                raise Conflict(
                    f"resourceVersion mismatch for {k}: stored {cur_rv}, "
                    f"caller supplied {md.get('resourceVersion')}")
            if subresource == "status":
                # copy-on-write: the new canonical object shares spec/meta
                # subtrees with the one it replaces — committed objects are
                # never mutated in place, so sharing between server-private
                # versions is safe (readers get full-copy snapshots)
                new = dict(cur)
                new["metadata"] = dict(cur.get("metadata") or {})
                if "status" in obj:
                    new["status"] = self._dc(obj["status"])
                else:
                    new.pop("status", None)
            else:
                new = obj
                # immutable / server-managed fields
                nm = m.meta(new)
                nm["uid"] = m.uid(cur)
                nm["creationTimestamp"] = m.meta(cur).get("creationTimestamp")
                if m.is_deleting(cur):  # deletionTimestamp is immutable once set
                    nm["deletionTimestamp"] = m.deletion_timestamp(cur)
                if "status" not in new and "status" in cur:
                    # shared with the outgoing canonical version (see the
                    # status-path comment: committed objects are frozen)
                    new["status"] = cur["status"]
                if new.get("spec") != cur.get("spec"):
                    nm["generation"] = m.generation(cur) + 1
                else:
                    nm["generation"] = m.generation(cur)
            m.meta(new)["resourceVersion"] = self._next_rv()
            # non-mutating read, and BEFORE the snapshot is cut: a
            # setdefault here would fork canonical from snapshot
            finalizing = (m.is_deleting(new) and not
                          (new.get("metadata") or {}).get("finalizers"))
            snap = self._commit(k, new)
        if finalizing:
            # last finalizer removed while deleting -> actually remove
            self._remove_key(k)
        else:
            self._emit("MODIFIED", snap)
        self._maybe_snapshot()
        return self._dc(snap)

    def update_status(self, obj: Obj) -> Obj:
        return self.update(obj, subresource="status")

    def patch_merge(self, kind: str, namespace: str, name: str, patch: Obj) -> Obj:
        """Strategic-ish merge patch: dicts merge recursively, lists replace.

        Mirrors the reference's patch utilities (``pkg/util/patch``) used for
        annotation updates in the elastic-checkpoint protocol. Retry-on-
        conflict rather than holding the store lock across ``update`` —
        emitting watch events under the lock would deadlock subscribers
        that take their own lock before reading the store (real api-server
        patches are optimistic for the same reason).
        """
        for _ in range(10):
            cur = self.get(kind, namespace, name)
            merged = _merge(cur, copy.deepcopy(patch))
            m.meta(merged)["resourceVersion"] = m.resource_version(cur)
            try:
                return self.update(merged)
            except Conflict:
                continue
        raise Conflict(f"patch of {kind} {namespace}/{name} kept conflicting")

    def delete(self, kind: str, namespace: str, name: str) -> None:
        k = self._key(kind, namespace, name)
        snap = None
        with self._lock:
            if k not in self._objs:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            obj = self._objs[k]
            if m.meta(obj).get("finalizers"):
                if not m.is_deleting(obj):
                    # copy-on-write: commit a new object (sharing frozen
                    # subtrees) rather than mutating the stored one under
                    # readers' feet
                    new = dict(obj)
                    new["metadata"] = dict(obj.get("metadata") or {})
                    new["metadata"]["deletionTimestamp"] = _ts(self.now())
                    new["metadata"]["resourceVersion"] = self._next_rv()
                    snap = self._commit(k, new)
                if snap is None:
                    return
        if snap is not None:
            self._emit("MODIFIED", snap)
            self._maybe_snapshot()
            return
        self._remove_key(k)
        self._maybe_snapshot()

    def _remove_key(self, k) -> None:
        with self._lock:
            removed = self._objs.pop(k, None)
            if removed is None:
                return
            self._index_remove(k, removed)
            snap = self._snaps.pop(k, None)
            if snap is None:
                snap = self._dc(removed)
            if self._durable:
                # deletes allocate an rv while durability is on (etcd
                # revision semantics): WAL replay and ring bookmarks
                # need post-snapshot deletes ordered above the snapshot.
                # The tombstone handed to watchers carries that rv (as a
                # real api-server's DELETED event does) so bookmarks
                # advance past the deletion
                seq = self._next_rv()
                snap = dict(snap)
                snap["metadata"] = dict(snap.get("metadata") or {},
                                        resourceVersion=seq)
                if self._ring_size:
                    self._ring_append(k[0], "DELETED", snap, seq)
                if self._journal is not None:
                    self._journal.append_delete(k, seq)
        self._emit("DELETED", snap)
        self._gc_dependents(removed)

    def _gc_dependents(self, owner: Obj) -> None:
        """Background-policy cascading GC of controller-owned dependents
        (owner-UID index lookup, not a world scan)."""
        owner_uid = m.uid(owner)
        with self._lock:
            # sorted: the owner index is a set of (kind, ns, name)
            # tuples, and set order follows the per-process string hash
            # seed — an unsorted walk deletes dependents (and allocates
            # their delete rvs / emits their DELETED events) in an order
            # that varies across processes and repeat in-process runs,
            # which seeded chaos replay and the campaign determinism
            # contract (docs/chaos.md) both forbid
            dependents = sorted(self._owner_idx.get(owner_uid, ()))
        for kd, ns, nm in dependents:
            try:
                self.delete(kd, ns, nm)
            except NotFound:
                pass

    # -- test/introspection helpers --------------------------------------

    @property
    def commit_lock(self):
        """The store's commit RLock — the journal's ``seal_guard``
        (docs/replication.md): WAL shipping acquires it before the
        journal lock so the global lock order is store -> journal on
        every seal path."""
        return self._lock

    def latest_resource_version(self) -> int:
        """Current store RV (list+watch consistency for HTTP frontends)."""
        with self._lock:
            return self._rv

    def kinds(self) -> set:
        with self._lock:
            return {k for k, keys in self._kind_keys.items() if keys}

    def __len__(self):
        with self._lock:
            return len(self._objs)


def _parse_field_selector(field_selector) -> list:
    """``{"status.phase": "Running"}`` or ``"metadata.name=x,..."`` →
    [(path, value)] (the subset of fieldSelector semantics kube-apiservers
    support: exact equality on dotted paths)."""
    if not field_selector:
        return []
    if isinstance(field_selector, str):
        pairs = (cond.partition("=") for cond in field_selector.split(","))
        return [(path, want) for path, _, want in pairs if path]
    return [(path, str(want)) for path, want in sorted(field_selector.items())]


def _merge(base, patch):
    if isinstance(base, dict) and isinstance(patch, dict):
        out = dict(base)
        for k, v in patch.items():
            if v is None:
                out.pop(k, None)
            elif k in out:
                out[k] = _merge(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
        return out
    return patch
