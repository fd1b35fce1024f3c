"""Shared informers and listers.

The analog of the reference's generated informer/lister tree
(``client/informers/externalversions``, ``client/listers``): a shared
factory hands out one informer per kind; each informer keeps a local cache
(indexed by namespace/name, bucketed by namespace for listers) synced from
the API server's watch stream, replays the initial list to late-added
handlers, and exposes a ``Lister`` over the cache so reads don't hit the
store.

Ownership rule (docs/control-plane-perf.md): cached objects are the API
server's shared snapshots — handlers and lister callers must treat them as
frozen and copy before mutating, exactly like client-go informer caches.

Copied from ``kubedl_tpu/client/informers.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..core import meta as m
from ..core.apiserver import APIServer, TooOldResourceVersion
from .clientset import KIND_TABLE


class Lister:
    """Cache-backed reads (``client/listers/.../tfjob.go`` shape)."""

    def __init__(self, informer: "Informer"):
        self._informer = informer

    def get(self, namespace: str, name: str) -> Optional[dict]:
        return self._informer._cache_get(namespace, name)

    def list(self, namespace: Optional[str] = None,
             selector: Optional[dict] = None) -> list:
        return self._informer._cache_list(namespace, selector)


class Informer:
    """One kind's shared informer: local cache + event handlers."""

    def __init__(self, api: APIServer, kind: str):
        self.api = api
        self.kind = kind
        self._cache: dict[tuple[str, str], dict] = {}
        #: namespace -> {key -> obj}: listers filter per-namespace without
        #: scanning the whole cache (mirror of the server-side ns index)
        self._by_ns: dict[str, dict[tuple[str, str], dict]] = {}
        self._handlers: list[dict] = []
        self._lock = threading.RLock()
        self._synced = False
        self._syncing = False
        self._sync_tombstones: set = set()  # deletes seen during initial sync
        self._cancel: Optional[Callable[[], None]] = None
        #: resourceVersion bookmark: the newest rv this informer has seen
        #: (docs/durability.md). ``resume()`` reconnects from here so a
        #: dropped watch replays the gap from the server's bounded event
        #: ring instead of forcing a full relist.
        self.last_rv = 0
        #: reconnects served from the bookmark ring (relists avoided)
        self.bookmark_resumes = 0
        #: reconnects that had to fall back to a full list+watch
        self.full_relists = 0
        #: resume-in-flight guard: two racing resume() calls must not
        #: register duplicate watch subscriptions
        self._resuming = False
        #: recent deletions' tombstone rvs (bounded, insertion-ordered):
        #: deletion pops the cache and with it the level information the
        #: staleness guards need — without this, a bookmark-replayed
        #: MODIFIED landing after a live DELETED would resurrect the
        #: object (old is None -> cache_put). A genuine recreate carries
        #: a HIGHER rv and clears the tombstone.
        self._dead: dict[tuple[str, str], int] = {}

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Subscribe to the watch stream and sync the initial list.

        The API-server calls (watch/list) run *outside* the informer lock:
        holding it across them would deadlock against a concurrent writer
        whose watch fan-out blocks on this lock (ABBA with the store lock).
        """
        with self._lock:
            if self._cancel is not None:
                return
            self._syncing = True
            self._sync_tombstones.clear()
            self._cancel = self.api.watch(self._on_event)
        snapshot = self.api.list(self.kind)
        with self._lock:
            for obj in snapshot:
                key = (m.namespace(obj), m.name(obj))
                self.last_rv = max(self.last_rv, m.resource_version(obj))
                # skip keys the watch already saw — including DELETED
                # events for snapshot objects, which must not resurrect
                if key not in self._cache and key not in self._sync_tombstones:
                    self._cache_put(key, obj)
                    self._dispatch("add", None, obj)
            self._syncing = False
            self._sync_tombstones.clear()
            self._synced = True
        # list+watch consistency: the initial list reflects the store at
        # its current rv, so the bookmark starts there (real reflectors
        # take the LIST response's resourceVersion the same way)
        if hasattr(self.api, "latest_resource_version"):
            rv = self.api.latest_resource_version()
            if rv > self.last_rv:
                self.last_rv = rv

    def resume(self) -> None:
        """Reconnect from the ``last_rv`` bookmark (docs/durability.md):
        the server replays the missed events from its bounded per-kind
        ring, so a restarted/briefly-disconnected informer catches up
        without relisting the world. A too-old bookmark (ring evicted
        past it, or no ring on this store) falls back to a full
        :meth:`start` — counted in ``full_relists`` informer-side and
        ``kubedl_watch_relists_total{reason}`` server-side."""
        with self._lock:
            if self._cancel is not None or self._resuming:
                return             # still connected / resume in flight
            self._resuming = True
        try:
            # resolved OUTSIDE the try below: a missing seam (a
            # real-cluster adapter) must relist, but an AttributeError
            # raised by a user handler during the synchronous replay
            # must propagate — swallowing it would mask the handler bug
            # AND leak a duplicate subscription via the fallback
            watch_from = getattr(self.api, "watch_from", None)
            if watch_from is None:
                self.full_relists += 1
                self._relist()
                return
            try:
                cancel, caught_up = watch_from(
                    self._on_event, self.last_rv, kinds=(self.kind,))
            except TooOldResourceVersion:
                self.full_relists += 1
                self._relist()
                return
            with self._lock:
                self._cancel = cancel
                self.last_rv = max(self.last_rv, caught_up)
                self._synced = True
                self.bookmark_resumes += 1
        finally:
            with self._lock:
                self._resuming = False

    def _relist(self) -> None:
        """Full list+watch over a non-empty cache (client-go
        ``Replace()`` semantics): vanished keys get synthesized delete
        events, changed keys get updates, new keys get adds. ``start()``
        alone only ADDS missing keys — after a gap the ring could not
        cover, that would serve deleted objects forever."""
        with self._lock:
            if self._cancel is not None:
                self._cancel()
            self._syncing = True
            self._sync_tombstones.clear()
            self._cancel = self.api.watch(self._on_event)
        # captured BEFORE the list: the vanished-key sweep below spares
        # cached objects with rv > list_rv (created during the relist,
        # delivered live) — reading the counter after the list could
        # cover such a creation and synthesize a delete for a live
        # object; an underestimate only spares too much, never deletes
        list_rv = 0
        if hasattr(self.api, "latest_resource_version"):
            list_rv = self.api.latest_resource_version()
        snapshot = self.api.list(self.kind)
        with self._lock:
            fresh = {}
            for obj in snapshot:
                key = (m.namespace(obj), m.name(obj))
                fresh[key] = obj
                if key in self._sync_tombstones:
                    continue            # deleted while we listed
                old = self._cache.get(key)
                if old is None:
                    self._cache_put(key, obj)
                    self._dispatch("add", None, obj)
                elif m.resource_version(obj) > m.resource_version(old):
                    self._cache_put(key, obj)
                    self._dispatch("update", old, obj)
            for key in [k for k in self._cache if k not in fresh]:
                old = self._cache[key]
                if list_rv and m.resource_version(old) > list_rv:
                    continue            # created after the list: live
                self._cache_pop(key)
                self._dispatch("delete", None, old)
            self._syncing = False
            self._sync_tombstones.clear()
            self._synced = True
            if list_rv > self.last_rv:
                self.last_rv = list_rv

    def disconnect(self) -> None:
        """Drop the watch subscription but KEEP the cache and bookmark
        (the dropped-connection half of a resume cycle; ``stop()`` is
        the full teardown)."""
        with self._lock:
            if self._cancel is not None:
                self._cancel()
                self._cancel = None

    def stop(self) -> None:
        with self._lock:
            if self._cancel is not None:
                self._cancel()
                self._cancel = None
            self._synced = False

    def has_synced(self) -> bool:
        return self._synced

    # -- handlers ---------------------------------------------------------

    def add_event_handler(self, on_add: Optional[Callable] = None,
                          on_update: Optional[Callable] = None,
                          on_delete: Optional[Callable] = None) -> None:
        """Handlers get (obj) for add/delete and (old, new) for update.
        A handler added after start() gets the current cache replayed as
        adds (client-go semantics)."""
        handler = {"add": on_add, "update": on_update, "delete": on_delete}
        with self._lock:
            self._handlers.append(handler)
            if self._synced and on_add is not None:
                for obj in list(self._cache.values()):
                    on_add(obj)

    def lister(self) -> Lister:
        return Lister(self)

    # -- internals --------------------------------------------------------

    def _cache_put(self, key: tuple[str, str], obj: dict) -> None:
        self._cache[key] = obj
        self._by_ns.setdefault(key[0], {})[key] = obj

    def _cache_pop(self, key: tuple[str, str]) -> None:
        self._cache.pop(key, None)
        bucket = self._by_ns.get(key[0])
        if bucket is not None:
            bucket.pop(key, None)
            if not bucket:
                del self._by_ns[key[0]]

    def _on_event(self, event_type: str, obj: dict) -> None:
        # the bookmark tracks the GLOBAL rv stream: this subscription
        # sees every kind's events (the kind filter is ours), so after a
        # quiescent point last_rv equals the store's counter — which is
        # what makes a post-restart resume land exactly on the recovered
        # store's ring base (k8s reflectors get this from BOOKMARK
        # events; here the fan-out itself carries it). GIL-atomic max.
        rv = m.resource_version(obj)
        if rv > self.last_rv:
            self.last_rv = rv
        if m.kind(obj) != self.kind:
            return
        key = (m.namespace(obj), m.name(obj))
        with self._lock:
            if event_type in ("ADDED", "MODIFIED"):
                dead_rv = self._dead.get(key)
                if dead_rv is not None:
                    if rv <= dead_rv:
                        # a stale replayed event for an object a newer
                        # DELETED already removed: applying it would
                        # resurrect the deleted object (the cache pop
                        # erased the level the guards below compare to)
                        return
                    del self._dead[key]      # genuine recreate
            if event_type == "ADDED":
                prev = self._cache.get(key)
                if prev is not None and \
                        m.resource_version(prev) >= m.resource_version(obj):
                    # already replayed by start()'s list snapshot: an object
                    # created while start() held the lock would otherwise be
                    # dispatched as 'add' twice
                    return
                self._cache_put(key, obj)
                self._dispatch("add", None, obj)
            elif event_type == "MODIFIED":
                old = self._cache.get(key)
                if old is not None and \
                        m.resource_version(old) >= rv:
                    # stale or duplicate (a bookmark replay racing a
                    # live delivery, a chaos-duplicated event): the
                    # cache is level-based, never regressed
                    return
                self._cache_put(key, obj)
                if old is None:
                    self._dispatch("add", None, obj)
                else:
                    self._dispatch("update", old, obj)
            elif event_type == "DELETED":
                old = self._cache.get(key)
                if old is not None and m.resource_version(old) > rv:
                    # a stale replayed tombstone must not delete the
                    # newer (recreated) object the live stream put here
                    return
                self._dead[key] = max(rv, self._dead.get(key, 0))
                while len(self._dead) > 1024:   # bounded, oldest first
                    self._dead.pop(next(iter(self._dead)))
                if self._syncing:
                    self._sync_tombstones.add(key)
                self._cache_pop(key)
                self._dispatch("delete", None, obj)

    def _dispatch(self, which: str, old: Optional[dict], obj: dict) -> None:
        for handler in list(self._handlers):
            fn = handler.get(which)
            if fn is None:
                continue
            if which == "update":
                fn(old, obj)
            else:
                fn(obj)

    def _cache_get(self, namespace: str, name: str) -> Optional[dict]:
        with self._lock:
            return self._cache.get((namespace, name))

    def _cache_list(self, namespace: Optional[str],
                    selector: Optional[dict]) -> list:
        with self._lock:
            if namespace is not None:
                candidates = list(self._by_ns.get(namespace, {}).values())
            else:
                candidates = list(self._cache.values())
            out = []
            for obj in candidates:
                if selector is not None and not m.match_labels(
                        m.get_labels(obj), selector):
                    continue
                out.append(obj)
        out.sort(key=lambda o: (m.namespace(o), m.name(o)))
        return out


class SharedInformerFactory:
    """``externalversions.SharedInformerFactory``: one informer per kind,
    shared across consumers; ``start()`` starts them all."""

    def __init__(self, api: APIServer):
        self.api = api
        self._informers: dict[str, Informer] = {}
        self._lock = threading.Lock()

    def informer(self, kind: str) -> Informer:
        if kind not in KIND_TABLE:
            raise KeyError(f"unknown kind {kind!r}")
        with self._lock:
            inf = self._informers.get(kind)
            if inf is None:
                inf = Informer(self.api, kind)
                self._informers[kind] = inf
            return inf

    def lister(self, kind: str) -> Lister:
        return self.informer(kind).lister()

    def start(self) -> None:
        with self._lock:
            informers = list(self._informers.values())
        for inf in informers:
            inf.start()

    def stop(self) -> None:
        with self._lock:
            informers = list(self._informers.values())
        for inf in informers:
            inf.stop()

    def wait_for_cache_sync(self) -> bool:
        return all(inf.has_synced() for inf in self._informers.values())
