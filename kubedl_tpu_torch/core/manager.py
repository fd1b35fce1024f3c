"""Controller manager: watch → workqueue → reconcile loops.

The structural analog of controller-runtime's ``Manager`` as wired in the
reference ``main.go:81-126``: controllers register for a primary kind plus
the kinds they own; events on owned objects are mapped back to the owning
primary's request key; a deduplicating workqueue drives ``Reconcile``.

Two execution modes:

* ``run_until_idle()`` — synchronous draining, the test mode (the reference
  tests drive reconciles by hand against the fake client; this is the same
  determinism with the routing kept honest), and
* ``run()`` — a background thread pool for standalone operation. Workers
  block on their shard's condition variable until the next heap deadline
  (or an ``enqueue`` notify) instead of polling on a fixed tick.

Hot-path structure (docs/control-plane-perf.md): events route through
kind→reconcilers maps built at registration (``_on_event`` never iterates
reconcilers that cannot care), and a key that receives an event while its
reconcile is in flight is re-queued the moment that reconcile finishes —
not parked on a busy-spin timer.

Sharded ownership (docs/durability.md): the workqueue is partitioned into
``shards`` independent lanes, each with its own heap, dedup map, in-flight
set, and condition variable — no dispatch lock is global. A request lands
on the shard named by :func:`shard_for`, a stable consistent hash of its
(namespace, name) identity, so every operator process computes the same
partition and a key's ordering guarantees (single reconcile in flight,
respin on mid-flight events) hold per shard exactly as they did globally.
``shard_owner`` (per-shard leases, ``core.leaderelection.ShardLeaseSet``)
gates which lanes this process drains; an unowned shard's queue simply
waits for the lease holder. With ``shards=1`` (the default) behavior is
byte-identical to the unsharded manager, and ``run_until_idle`` always
drains in the globally-earliest-(ready_at, seq) order regardless of shard
count, so sim-clock replays are bit-for-bit stable across shard configs.

Copied from ``kubedl_tpu/core/manager.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import hashlib
import heapq
import itertools
import logging
import threading
import traceback
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from . import meta as m
from .apiserver import APIServer
from ..metrics.registry import ControlPlaneMetrics

log = logging.getLogger("kubedl_tpu_torch.manager")


def shard_for(namespace: str, name: str, shards: int) -> int:
    """The consistent shard hash (docs/durability.md): stable across
    processes and Python runs (``hashlib``, not the salted builtin), so
    N operator replicas agree on ownership without coordination. The
    request key's (namespace, name) IS the job identity at workqueue
    granularity — uids aren't part of request keys."""
    if shards <= 1:
        return 0
    digest = hashlib.sha256(f"{namespace}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "big") % shards


@dataclass(frozen=True)
class Request:
    kind: str
    namespace: str
    name: str


@dataclass
class Result:
    requeue: bool = False
    requeue_after: float = 0.0


class Reconciler:
    """Interface each controller implements."""

    #: primary kind this reconciler owns, e.g. "PyTorchJob"
    kind: str = ""
    #: kinds of dependent objects whose events map (via controller ownerRef
    #: of the matching primary kind) back to the primary
    owns: tuple = ()
    #: extra kinds watched raw (event's own namespace/name is enqueued)
    watches: tuple = ()

    def reconcile(self, req: Request) -> Optional[Result]:  # pragma: no cover
        raise NotImplementedError


class _Shard:
    """One workqueue lane: private heap/dedup/in-flight under a private
    condition variable."""

    __slots__ = ("index", "cond", "heap", "queued", "inflight", "respin")

    def __init__(self, index: int):
        self.index = index
        self.cond = threading.Condition()
        self.heap: list = []          # (ready_at, seq, req)
        self.queued: dict = {}        # req -> earliest ready_at queued
        self.inflight: set = set()
        self.respin: set = set()


class Manager:
    def __init__(self, api: APIServer, clock=None,
                 metrics: Optional[ControlPlaneMetrics] = None,
                 tracer=None, shards: int = 1,
                 shard_owner: Optional[Callable[[int], bool]] = None,
                 durability_metrics=None):
        self.api = api
        #: span recorder (kubedl_tpu_torch.trace.Tracer); None or disabled =
        #: the dispatch hot path pays one attribute check and nothing else
        self.tracer = tracer
        self._clock = clock or api.now
        self._reconcilers: list[Reconciler] = []
        self._by_kind: dict[str, list[Reconciler]] = {}
        # event-routing maps, built at register() time so _on_event is a
        # dict lookup instead of a scan over every reconciler
        self._route_primary: dict[str, list[Reconciler]] = {}
        self._route_owner: dict[str, list[Reconciler]] = {}
        self.shards = max(int(shards), 1)
        #: per-shard ownership predicate (lease-backed in HA deployments);
        #: None = this process owns every shard
        self.shard_owner = shard_owner
        self._shardset = [_Shard(i) for i in range(self.shards)]
        #: global sequence: the tie-break that makes the cross-shard pop
        #: order identical to a single heap's (next() is GIL-atomic)
        self._seq_counter = itertools.count(1)
        self._stats_lock = threading.Lock()
        self._stopped = False
        self._max_retries_backoff = 64.0
        self._failures: dict[Request, int] = {}
        self.metrics = metrics or ControlPlaneMetrics()
        #: durability metric families (kubedl_shard_owned_keys) — present
        #: only when the DurableControlPlane gate is on
        self._dur_metrics = durability_metrics
        #: total reconciles dispatched (cheap regression guard for tests)
        self.reconcile_count = 0
        #: high-water mark of distinct queued keys (all shards)
        self.max_queue_depth = 0
        #: when True, per-dispatch wall-clock latencies are appended to
        #: ``latency_samples`` (bench_controlplane's p50/p99 source) and
        #: the owning shard index to ``latency_shards`` in lockstep
        self.record_latency = False
        self.latency_samples: deque = deque(maxlen=400_000)
        self.latency_shards: deque = deque(maxlen=400_000)
        api.watch(self._on_event)

    # -- registration -----------------------------------------------------

    def register(self, rec: Reconciler):
        self._reconcilers.append(rec)
        self._by_kind.setdefault(rec.kind, []).append(rec)
        primary = {rec.kind, *rec.watches}
        primary.discard("")
        for kd in primary:
            self._route_primary.setdefault(kd, []).append(rec)
        for kd in rec.owns:
            self._route_owner.setdefault(kd, []).append(rec)
        return rec

    def watched_kinds(self) -> set:
        """Every kind any registered reconciler needs events for — what a
        real-cluster api adapter must list+watch (``KubeAPIServer.start``)."""
        kinds = set()
        for rec in self._reconcilers:
            kinds.add(rec.kind)
            kinds.update(rec.owns)
            kinds.update(rec.watches)
        kinds.discard("")
        return kinds

    # -- event routing ----------------------------------------------------

    def _on_event(self, event_type: str, obj: dict):
        kd = m.kind(obj)
        primary = self._route_primary.get(kd)
        owners = self._route_owner.get(kd)
        if not primary and not owners:
            return
        ns, name = m.namespace(obj), m.name(obj)
        for rec in primary or ():
            # primary event, or a watched kind mapped by same ns/name
            self.enqueue(Request(rec.kind, ns, name))
        if owners:
            # route via ANY owner ref of the matching kind, not just the
            # controller ref: a ModelVersion is controller-owned by the
            # job that produced it but also owned by its Model, and both
            # owners' reconcilers need the event
            refs = m.meta(obj).get("ownerReferences", []) or []
            for rec in owners:
                for ref in refs:
                    if ref.get("kind") == rec.kind:
                        self.enqueue(Request(rec.kind, ns, ref["name"]))

    # -- queueing ---------------------------------------------------------

    def _shard_of(self, req: Request) -> _Shard:
        return self._shardset[shard_for(req.namespace, req.name,
                                        self.shards)]

    def enqueue(self, req: Request, after: float = 0.0):
        """Add with dedup. An immediate event always supersedes a pending
        *delayed* requeue for the same key (a watch event during a long
        requeue_after window must not wait out the timer — controller-runtime
        workqueue semantics)."""
        sh = self._shard_of(req)
        with sh.cond:
            self._enqueue_shard(sh, req, after)

    def _enqueue_shard(self, sh: _Shard, req: Request,
                       after: float = 0.0):
        """Caller holds ``sh.cond``."""
        ready_at = self._clock() + max(after, 0.0)
        prev = sh.queued.get(req)
        if prev is not None and prev <= ready_at:
            return  # an equal-or-sooner entry is already queued
        sh.queued[req] = ready_at
        heapq.heappush(sh.heap, (ready_at, next(self._seq_counter), req))
        self._note_depth(sh)
        sh.cond.notify_all()

    def _note_depth(self, sh: _Shard) -> None:
        depth = sum(len(s.queued) for s in self._shardset)
        if depth > self.max_queue_depth:
            self.max_queue_depth = depth
        self.metrics.queue_depth.set(depth)
        if self._dur_metrics is not None:
            self._dur_metrics.shard_owned_keys.set(
                len(sh.queued), shard=str(sh.index))

    # -- execution --------------------------------------------------------

    def _owned(self, sh: _Shard) -> bool:
        owner = self.shard_owner
        return owner is None or bool(owner(sh.index))

    def _live_head(self, sh: _Shard):
        """Drop superseded heap entries; return the live head tuple or
        None. Caller holds ``sh.cond``."""
        while sh.heap:
            ready_at, seq, req = sh.heap[0]
            if sh.queued.get(req) != ready_at:
                heapq.heappop(sh.heap)  # superseded (stale) entry
                continue
            return sh.heap[0]
        return None

    def _claim(self, sh: _Shard, now: float) -> Optional[Request]:
        """Pop the shard's head (known ready). Caller holds ``sh.cond``.
        A ready key whose reconcile is still in flight moves to the
        respin set — it is re-queued by ``_dispatch`` the moment that
        reconcile finishes (single-reconcile-per-key semantics)."""
        while True:
            head = self._live_head(sh)
            if head is None:
                return None
            ready_at, _, req = head
            if ready_at > now:
                return None
            heapq.heappop(sh.heap)
            del sh.queued[req]
            if req in sh.inflight:
                sh.respin.add(req)
                continue
            sh.inflight.add(req)
            self._note_depth(sh)
            self.metrics.queue_inflight.set(
                sum(len(s.inflight) for s in self._shardset))
            self.metrics.queue_latency.observe(max(now - ready_at, 0.0))
            return req

    def _pop_ready_shard(self, sh: _Shard):
        """One shard's pop: ``(req, None)`` claimed, ``(None, wait)``
        future head, ``(None, None)`` empty. Caller holds ``sh.cond``."""
        now = self._clock()
        req = self._claim(sh, now)
        if req is not None:
            return req, None
        head = self._live_head(sh)
        if head is None:
            return None, None
        return None, head[0] - now

    def _pop_ready(self) -> Optional[Request]:
        """The deterministic global pop: claim the globally earliest
        (ready_at, seq) ready request across owned shards — exactly the
        order a single shared heap would produce, for any shard count."""
        while True:
            now = self._clock()
            best = None
            best_sh = None
            for sh in self._shardset:
                if not self._owned(sh):
                    continue
                with sh.cond:
                    head = self._live_head(sh)
                if head is None or head[0] > now:
                    continue
                if best is None or head[:2] < best[:2]:
                    best, best_sh = head, sh
            if best is None:
                return None
            with best_sh.cond:
                # re-verify under the lock (a worker may have claimed it)
                head = self._live_head(best_sh)
                if head != best:
                    continue
                req = self._claim(best_sh, now)
            if req is not None:
                return req
            # claimed key was in flight (moved to respin): look again

    def _dispatch(self, req: Request) -> None:
        t0 = self._clock()
        try:
            for rec in self._by_kind.get(req.kind, []):
                try:
                    res = rec.reconcile(req)
                except Exception:
                    n = self._failures.get(req, 0) + 1
                    self._failures[req] = n
                    backoff = min(0.005 * (2 ** n), self._max_retries_backoff)
                    log.error("reconcile %s failed (retry %d in %.3fs):\n%s",
                              req, n, backoff, traceback.format_exc())
                    self.enqueue(req, after=backoff)
                    continue
                self._failures.pop(req, None)
                if res and (res.requeue or res.requeue_after > 0):
                    self.enqueue(req, after=max(res.requeue_after, 0.0))
        finally:
            elapsed = max(self._clock() - t0, 0.0)
            tr = self.tracer
            if tr is not None and tr.enabled:
                tr.record("reconcile", t0, t0 + elapsed, component="manager",
                          attributes={"kind": req.kind,
                                      "namespace": req.namespace,
                                      "name": req.name})
            self.metrics.reconciles.inc(kind=req.kind)
            self.metrics.reconcile_latency.observe(elapsed, kind=req.kind)
            sh = self._shard_of(req)
            with self._stats_lock:
                self.reconcile_count += 1
                if self.record_latency:
                    self.latency_samples.append(elapsed)
                    self.latency_shards.append(sh.index)
            with sh.cond:
                sh.inflight.discard(req)
                self.metrics.queue_inflight.set(
                    sum(len(s.inflight) for s in self._shardset))
                if req in sh.respin:
                    # an event arrived mid-reconcile: the run just finished
                    # may have read stale state, so go again now
                    sh.respin.discard(req)
                    self._enqueue_shard(sh, req)

    def run_until_idle(self, max_iterations: int = 10000,
                       include_delayed: bool = False) -> int:
        """Synchronously drain the queue. Returns reconcile count.

        ``include_delayed`` also runs items scheduled in the future (tests
        that want to fast-forward TTL/backoff timers use a fake clock
        instead; this flag is a blunt fallback).
        """
        n = 0
        while n < max_iterations:
            req = self._pop_ready()
            if req is None and include_delayed:
                # same globally-earliest order as the ready path: take
                # the earliest (ready_at, seq) future entry across
                # owned shards, not the first non-empty shard's
                best, best_sh = None, None
                for sh in self._shardset:
                    if not self._owned(sh):
                        continue
                    with sh.cond:
                        head = self._live_head(sh)
                    if head is not None and (best is None
                                             or head[:2] < best[:2]):
                        best, best_sh = head, sh
                if best is not None:
                    with best_sh.cond:
                        head = self._live_head(best_sh)
                        if head is not None:
                            heapq.heappop(best_sh.heap)
                            del best_sh.queued[head[2]]
                            req = head[2]
            if req is None:
                break
            self._dispatch(req)
            n += 1
        return n

    def pending(self) -> int:
        return sum(len(sh.heap) for sh in self._shardset)

    def next_deadline(self) -> Optional[float]:
        """Earliest ``ready_at`` (absolute clock time) among live queued
        requests, or None when the queue is empty. Event-driven drivers
        (the cluster replay harness) advance their sim clock to
        ``min(next external event, next_deadline())`` so delayed requeues
        — admission-gate nets, restart backoffs, TTL reaps — fire instead
        of being starved between external events. Each shard's ``queued``
        holds its requests' single live deadlines (heap entries they
        superseded are skipped on pop), so the min over shards is exact.
        Read-only."""
        deadlines = []
        for sh in self._shardset:
            with sh.cond:
                if sh.queued:
                    deadlines.append(min(sh.queued.values()))
        return min(deadlines) if deadlines else None

    def run(self, workers: int = 1):
        """Background processing loop (standalone mode). Every shard gets
        at least one worker thread; extra workers distribute round-robin.
        A worker sleeps on its shard's condition variable until the next
        heap deadline; ``enqueue`` wakes exactly that shard. The wait is
        capped so a fake-clock advance (tests) or a missed notify degrades
        to a 1 s tick, never a hang. A worker whose shard's lease is held
        elsewhere (``shard_owner``) parks without popping until the lease
        comes back — shard handoff is the other process starting to drain
        its identically-hashed copy of the queue."""
        self._stopped = False

        def worker(sh: _Shard):
            while True:
                with sh.cond:
                    while True:
                        if self._stopped:
                            return
                        if not self._owned(sh):
                            sh.cond.wait(timeout=0.2)
                            continue
                        req, delay = self._pop_ready_shard(sh)
                        if req is not None:
                            break
                        timeout = 1.0 if delay is None else min(delay, 1.0)
                        sh.cond.wait(timeout=timeout)
                self._dispatch(req)

        count = max(max(workers, 1), self.shards)
        threads = [threading.Thread(
            target=worker, args=(self._shardset[i % self.shards],),
            daemon=True) for i in range(count)]
        for t in threads:
            t.start()
        return threads

    def stop(self):
        self._stopped = True
        for sh in self._shardset:
            with sh.cond:
                sh.cond.notify_all()

    # -- introspection back-compat (merged views over the shards) ---------

    @property
    def _queued(self) -> dict:
        out: dict = {}
        for sh in self._shardset:
            out.update(sh.queued)
        return out

    @property
    def _respin(self) -> set:
        out: set = set()
        for sh in self._shardset:
            out |= sh.respin
        return out

    @property
    def _inflight(self) -> set:
        out: set = set()
        for sh in self._shardset:
            out |= sh.inflight
        return out
