"""Prefix-cache-aware request routing with per-tenant fairness.

The fleet's placement layer (docs/serving_fleet.md): a request whose
prompt starts with a registered shared prefix should land on the replica
ALREADY holding that prefix's pool blocks — the refcounted
:class:`~kubedl_tpu_torch.serving.batching.BlockPool` makes residency a pure
host-side read (``engine.prefix_residency``), so placement costs no
device work. Two guards keep affinity honest:

* **router-driven registration**: a declared prefix the chosen replica
  has never seen is registered there on first placement (the engine's
  least-recently-hit eviction means this can never wedge a warm
  replica's full prefix cache);
* **per-tenant fairness**, reusing the Queue API's tenant routing
  (``api/queue.QueueSpec.tenants`` — the same attribution the slice
  scheduler routes jobs by): when the preferred replica is hot (its
  queue is backed up) and one tenant's queue already holds its fair
  share of that replica's outstanding work, the placement spills to the
  next-best replica instead of letting the hot tenant monopolize the
  prefix-warm one.

:class:`RandomRouter` is the control arm the routing leg of
``bench_serving_fleet.py`` compares against: identical traffic,
identical router-driven registration, placement by seeded uniform draw.

Copied from ``kubedl_tpu/serving/router.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import hashlib
import random
from typing import Optional, Sequence

from ..api.queue import DEFAULT_QUEUE


def _prefix_home(prefix, n: int) -> int:
    """Stable home replica for a cold prefix: a consistent hash of its
    tokens over the active set, so the fleet's prefix caches partition
    the catalog instead of every replica churning through all of it."""
    digest = hashlib.sha256(
        ",".join(str(int(t)) for t in prefix).encode()).digest()
    return int.from_bytes(digest[:8], "big") % n


def _model_home(model: str, n: int) -> int:
    """Stable home replica for a cold MODEL (adapter id): the same
    consistent-hash partitioning as cold prefixes, applied to the
    adapter catalog — each replica's pool holds a stable slice of the
    catalog instead of every replica faulting through all of it
    (docs/multimodel.md)."""
    digest = hashlib.sha256(model.encode()).digest()
    return int.from_bytes(digest[:8], "big") % n


class RandomRouter:
    """Uniform placement over non-draining replicas (the baseline)."""

    def __init__(self, fleet, seed: int = 0, max_prefixes: int = 8,
                 metrics=None, cache_residency: bool = True):
        self.fleet = fleet
        self.rng = random.Random(f"{seed}:router")
        #: per-replica prefix-cache cap for router-driven registration
        self.max_prefixes = int(max_prefixes)
        self.metrics = metrics
        #: probe residency from per-replica snapshots cached on the
        #: engine's residency_epoch instead of taking each engine's
        #: scheduler lock on every probe: a submit is O(1) pool reads
        #: amortized, and placement decisions are IDENTICAL to the
        #: uncached path (the snapshot walk mirrors
        #: _match_prefix_blocks; pinned by a test on the routing leg)
        self.cache_residency = bool(cache_residency)
        self._res_cache: dict = {}   # replica name -> snapshot tuple
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.tenant_spills = 0
        self.routed: dict = {}           # replica name -> placements

    # -- cached residency --------------------------------------------------

    def _snapshot(self, rep):
        eng = rep.engine
        cached = self._res_cache.get(rep.name)
        if cached is None or cached[0] != eng.residency_epoch:
            # epoch moved (prefix registered/evicted, adapter
            # faulted/evicted, engine recovered) — or first sight of
            # this replica: take one locked snapshot, then every probe
            # until the next change is a pure host-side walk
            cached = eng.residency_snapshot()
            self._res_cache[rep.name] = cached
        return cached

    def _residency(self, rep, probe, model: str = "") -> int:
        """``engine.prefix_residency`` through the snapshot cache (or
        live, when caching is off / the engine predates snapshots)."""
        eng = rep.engine
        if not self.cache_residency or \
                not hasattr(eng, "residency_snapshot"):
            if model:
                return eng.prefix_residency(probe, model=model)
            return eng.prefix_residency(probe)
        _, prefixes, _, kv_block = self._snapshot(rep)
        probe_t = tuple(int(t) for t in probe)
        n = len(probe_t)
        for pmodel, key, nblocks in prefixes:   # longest-first, like
            if pmodel == model and n >= len(key) \
                    and probe_t[:len(key)] == key:  # _match_prefix_blocks
                return min(nblocks, (n - 1) // kv_block)
        return 0

    def _adapter_resident(self, rep, model: str) -> bool:
        eng = rep.engine
        if not self.cache_residency or \
                not hasattr(eng, "residency_snapshot"):
            fn = getattr(eng, "adapter_resident", None)
            return bool(fn(model)) if fn is not None else False
        return model in self._snapshot(rep)[2]

    # -- placement --------------------------------------------------------

    def select(self, prompt: Sequence[int], tenant: Optional[str] = None,
               prefix: Optional[Sequence[int]] = None,
               version: Optional[int] = None,
               model: Optional[str] = None):
        reps = self._candidates(version)
        return reps[self.rng.randrange(len(reps))]

    def _candidates(self, version: Optional[int]) -> list:
        """Active replicas, optionally pinned to one policy version —
        the rollout path's guarantee that every completion in a batch
        came from the SAME weights (docs/rl.md: a mixed-version batch
        has no well-defined behavior policy)."""
        reps = self.fleet.active()
        if version is not None:
            reps = [r for r in reps
                    if getattr(r, "policy_version", 0) == version]
            if not reps:
                raise RuntimeError(
                    f"no active replica serving policy version "
                    f"{version} (mid-publish, or the version was "
                    "already rolled past)")
        if not reps:
            raise RuntimeError("no active serving replica (fleet empty "
                               "or fully draining)")
        return reps

    def _ensure_prefix(self, rep, prefix, model: str = "") -> None:
        # model-scoped both ways: the warm-check and the registration
        # key on (model, tokens) — model kwargs only when scoped, so
        # engines/stubs that predate multi-model keep working
        if model:
            if not rep.engine.has_prefix(prefix, model=model):
                rep.engine.register_prefix(list(prefix),
                                           max_prefixes=self.max_prefixes,
                                           model=model)
        elif not rep.engine.has_prefix(prefix):
            rep.engine.register_prefix(list(prefix),
                                       max_prefixes=self.max_prefixes)

    def _account(self, rep, prefix, model: str = "") -> None:
        self.routed[rep.name] = self.routed.get(rep.name, 0) + 1
        if prefix is not None:
            if self._residency(rep, prefix, model) > 0:
                self.prefix_hits += 1
                if self.metrics is not None:
                    self.metrics.router_prefix_hits.inc()
            else:
                self.prefix_misses += 1
                if self.metrics is not None:
                    self.metrics.router_prefix_misses.inc()

    def submit(self, prompt: Sequence[int], max_new: int,
               tenant: Optional[str] = None,
               prefix: Optional[Sequence[int]] = None,
               version: Optional[int] = None,
               model: Optional[str] = None, **kw):
        """Place + submit one request; returns ``(Request, replica)``.
        ``prefix`` is the client-declared shared prefix (system prompt)
        — the placement signal and the router-driven registration
        unit. ``version`` pins placement to replicas advertising that
        policy version (the rollout tenant's same-weights guarantee).
        ``model`` is the adapter id for multi-model fleets
        (docs/multimodel.md): it scopes the prefix work and rides down
        to ``engine.submit`` so admission gates on residency."""
        model = model or ""
        rep = self.select(prompt, tenant=tenant, prefix=prefix,
                          version=version, model=model)
        self._account(rep, prefix, model)
        if prefix is not None:
            self._ensure_prefix(rep, prefix, model)
        if model:
            kw = dict(kw, model=model)
        req = rep.engine.submit(prompt, max_new, **kw)
        self._note_submitted(rep, tenant, req)
        return req, rep

    def _note_submitted(self, rep, tenant, req) -> None:
        """Fairness bookkeeping hook (no-op for the random baseline)."""

    def stats(self) -> dict:
        total = self.prefix_hits + self.prefix_misses
        return {
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_rate": round(self.prefix_hits / total, 4)
            if total else None,
            "tenant_spills": self.tenant_spills,
            "routed": {k: self.routed[k] for k in sorted(self.routed)},
        }


class PrefixAwareRouter(RandomRouter):
    """Place on the replica already holding the request's shared prefix
    blocks; fairness spills a hot tenant off the warm replica."""

    def __init__(self, fleet, seed: int = 0, max_prefixes: int = 8,
                 queues: Sequence = (), hot_queue_depth: int = 4,
                 metrics=None, cache_residency: bool = True,
                 adapter_affinity: bool = True):
        super().__init__(fleet, seed=seed, max_prefixes=max_prefixes,
                         metrics=metrics, cache_residency=cache_residency)
        #: multi-model placement (docs/multimodel.md): prefer replicas
        #: where the request's adapter is already resident; a cold
        #: model gets a consistent-hash home. Off = adapter-BLIND
        #: routing (the bench_multimodel comparison arm): the model
        #: still rides to the engine, but placement ignores it.
        self.adapter_affinity = bool(adapter_affinity)
        #: tenant -> queue name, from the Queue API's tenant lists (the
        #: slice scheduler's exact routing rule, docs/scheduling.md);
        #: unrouted tenants land on the implicit default queue
        self._tenant_queue: dict = {}
        for q in queues:
            for t in getattr(q, "tenants", ()) or ():
                self._tenant_queue.setdefault(t, q.name)
        #: replica hotness bar: at or past this queue depth the replica
        #: is contended and fairness applies
        self.hot_queue_depth = int(hot_queue_depth)
        #: (replica name, queue) -> live Requests (pruned lazily on
        #: reads, and swept every ``_SWEEP_EVERY`` submits so a
        #: long-lived server below the hotness bar — where _over_share
        #: never reads — cannot grow this without bound, and keys of
        #: reaped replicas don't live forever)
        self._outstanding: dict = {}
        self._submits_since_sweep = 0

    def queue_for(self, tenant: Optional[str]) -> str:
        if not tenant:
            return DEFAULT_QUEUE
        return self._tenant_queue.get(tenant, DEFAULT_QUEUE)

    # -- fairness bookkeeping --------------------------------------------

    def _live(self, rep_name: str, queue: str) -> int:
        reqs = self._outstanding.get((rep_name, queue))
        if not reqs:
            return 0
        live = [r for r in reqs if not r.done.is_set()]
        self._outstanding[(rep_name, queue)] = live
        return len(live)

    _SWEEP_EVERY = 256

    def _note_submitted(self, rep, tenant, req) -> None:
        key = (rep.name, self.queue_for(tenant))
        reqs = self._outstanding.setdefault(key, [])
        if len(reqs) >= 8:
            self._outstanding[key] = reqs = [
                r for r in reqs if not r.done.is_set()]
        reqs.append(req)
        self._submits_since_sweep += 1
        if self._submits_since_sweep >= self._SWEEP_EVERY:
            self._submits_since_sweep = 0
            live_names = {r.name for r in self.fleet.replicas}
            self._outstanding = {
                k: live for k, v in self._outstanding.items()
                if k[0] in live_names
                and (live := [r for r in v if not r.done.is_set()])}
            # reaped replicas' residency snapshots go with them (the
            # reap side of snapshot invalidation; epoch mismatches
            # handle every registration/eviction on live replicas)
            self._res_cache = {name: snap for name, snap
                               in self._res_cache.items()
                               if name in live_names}

    def _over_share(self, rep, queue: str) -> bool:
        """Would this queue exceed its fair share of ``rep``'s
        outstanding work? Share = replica lanes split evenly over the
        queues currently holding work there (at least one lane each)."""
        holders = {q for (name, q), reqs in self._outstanding.items()
                   if name == rep.name and self._live(name, q) > 0}
        holders.add(queue)
        share = max(rep.engine.lanes // len(holders), 1)
        return self._live(rep.name, queue) >= share

    # -- placement --------------------------------------------------------

    def select(self, prompt: Sequence[int], tenant: Optional[str] = None,
               prefix: Optional[Sequence[int]] = None,
               version: Optional[int] = None,
               model: Optional[str] = None):
        reps = self._candidates(version)
        probe = prefix if prefix is not None else prompt
        model = (model or "") if self.adapter_affinity else ""
        # adapter residency DOMINATES prefix residency: adapter weight
        # pages are the heavier thing to move (a fault allocates pages
        # and may evict another model), and a prefix can be registered
        # cheaply wherever the adapter lives — never the reverse
        scored = [(1 if model and self._adapter_resident(rep, model)
                   else 0,
                   self._residency(rep, probe, model),
                   -rep.engine.queue_depth, -i, rep)
                  for i, rep in enumerate(reps)]
        scored.sort(reverse=True)   # adapter desc, residency desc,
        best = scored[0][4]         # depth asc, FIFO
        if model and scored[0][0] == 0:
            # model resident nowhere: give it a stable consistent-hash
            # home so the fleet PARTITIONS the catalog — each replica's
            # pool converges on its slice of the models instead of
            # every replica churning through all of them
            best = reps[_model_home(model, len(reps))]
        elif not model and scored[0][1] == 0 and prefix is not None:
            # (model requests skip prefix homing: wherever the adapter
            # lives — or was just homed — is where the prefix belongs)
            # nowhere warm: give the prefix a stable home so its NEXT
            # requests find it resident (and other prefixes' homes stay
            # unpolluted) instead of piling every cold prefix onto the
            # emptiest replica
            best = reps[_prefix_home(prefix, len(reps))]
        queue = self.queue_for(tenant)
        if len(scored) > 1 and best.engine.queue_depth \
                >= self.hot_queue_depth and self._over_share(best, queue):
            # the warm replica is contended AND this tenant's queue
            # already holds its share of it: spill to the least-loaded
            # other replica instead of monopolizing the prefix-warm one
            others = sorted(((rep.engine.queue_depth, i, rep)
                             for i, (_, _, _, _, rep) in enumerate(scored)
                             if rep is not best))
            self.tenant_spills += 1
            if self.metrics is not None:
                self.metrics.router_tenant_spills.inc(queue=queue)
            return others[0][2]
        return best
