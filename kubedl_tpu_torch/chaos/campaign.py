"""Seeded chaos campaigns: correlated fault primitives, pure of wall time.

A **campaign** is a time-sorted script of :class:`FaultAction`\\ s — a
pure function of ``(scenario, seed, profile)`` exactly like
``replay/workload.py``'s day generator, with the same
:meth:`Campaign.fingerprint` contract: identical inputs reproduce the
identical script bit for bit, so an adversarial scorecard is replayable
from its committed seed. The grammar (docs/chaos.md):

* **scenario** — a named builder in :data:`SCENARIOS` that draws every
  fault time/target/rate from one namespaced ``random.Random`` stream;
* **primitive** — one correlated fault the :class:`CampaignRunner` knows
  how to execute against a live :class:`~kubedl_tpu_torch.replay.harness
  .ClusterReplay`:

  ===================  ====================================================
  ``domain_outage``    every gang the inventory's per-domain accounting
                       places in one ICI domain loses a node at once
                       (slice-atomic failover must restart each whole gang)
  ``spot_dry``         ``_start``/``_end`` pair: a pool's spot capacity
                       vanishes in one sweep — every gang holding slices
                       there is preempted together AND the pool's capacity
                       drops to zero for the window (evicted and arriving
                       work must queue or land elsewhere until capacity
                       returns)
  ``drain``            one running job in a pool is drained (several
                       ``drain`` actions spaced by an interval make a
                       rolling drain)
  ``watch_storm``      ``_start``/``_end`` pair: watch events drop and
                       duplicate at storm rates (stresses the expectations
                       machinery, bookmark rings, and relist fallback)
  ``hot_loop``         one reconcile shard spins: every live job hashing
                       to the shard is re-enqueued (a bad release's
                       busy-looping controller)
  ``slow_fsync``       ``_start``/``_end`` pair: the WAL's group-commit
                       fsync takes extra injected seconds (a dying disk),
                       advancing the sim clock — never sleeping
  ``leader_kill``      the control-plane leader dies SIGKILL-style mid-
                       day (journal never closed, tail only write(2)-
                       flushed) and the most-caught-up WAL follower is
                       promoted through the Lease machinery — requires
                       the replay's ``replication_followers`` > 0
                       (docs/replication.md)
  ``region_down``      ``_start``/``_end`` pair: an entire REGION dies at
                       once — its leader, followers, and every pool —
                       and the federation layer evacuates (elastic jobs
                       emigrate via the object-store checkpoint tier,
                       serving streams re-route). Requires a federation
                       driver (``FederationReplay``); a single-cluster
                       replay raises loudly (docs/federation.md)
  ===================  ====================================================

Faults are injected through the seeded :class:`ChaosAPIServer`
machinery, so everything a campaign does lands in the injector's own
ledgers (``faults`` / ``latencies`` / ``preemptions``) and the
scorecard's ``chaos.attribution`` block needs zero bench-local
bookkeeping.

Copied from ``kubedl_tpu/chaos/campaign.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass

from ..core.manager import Request, shard_for

#: executable fault primitives (window primitives appear as _start/_end)
PRIMITIVES = frozenset({
    "domain_outage", "drain", "hot_loop",
    "spot_dry_start", "spot_dry_end",
    "watch_storm_start", "watch_storm_end",
    "slow_fsync_start", "slow_fsync_end",
    "leader_kill",
    "region_down_start", "region_down_end",
})


@dataclass(frozen=True)
class FaultAction:
    """One scheduled fault: ``params`` is a sorted tuple of (key, value)
    pairs so actions hash, compare, and serialize canonically."""
    time_s: float
    primitive: str
    params: tuple = ()

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default


def _params(**kw) -> tuple:
    return tuple(sorted(kw.items()))


@dataclass(frozen=True)
class Campaign:
    """A compiled scenario: the full fault schedule, time-sorted."""
    scenario: str
    seed: int
    actions: tuple                # FaultAction, time-sorted

    def fingerprint(self) -> str:
        """sha256 over the canonical JSON rendering — same determinism
        probe as ``Workload.fingerprint`` (docs/benchmarks.md)."""
        doc = {
            "scenario": self.scenario, "seed": self.seed,
            "actions": [{"t": a.time_s, "p": a.primitive,
                         "params": [list(p) for p in a.params]}
                        for a in self.actions],
        }
        blob = json.dumps(doc, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()

    def window(self) -> tuple:
        """(first, last) action times, or (0, 0) for an empty script."""
        if not self.actions:
            return 0.0, 0.0
        return self.actions[0].time_s, self.actions[-1].time_s


# ---------------------------------------------------------------------------
# primitive emitters (build-time: pure, rng-streamed)
# ---------------------------------------------------------------------------


def _watch_storm(at: float, duration: float, drop: float,
                 dup: float) -> list:
    return [
        FaultAction(round(at, 3), "watch_storm_start",
                    _params(drop=round(drop, 4), dup=round(dup, 4))),
        FaultAction(round(at + duration, 3), "watch_storm_end"),
    ]


def _slow_fsync(at: float, duration: float, seconds: float) -> list:
    return [
        FaultAction(round(at, 3), "slow_fsync_start",
                    _params(seconds=round(seconds, 4))),
        FaultAction(round(at + duration, 3), "slow_fsync_end"),
    ]


def _hot_loop(at: float, duration: float, interval: float,
              shard: int) -> list:
    out = []
    t = at
    while t < at + duration:
        out.append(FaultAction(round(t, 3), "hot_loop",
                               _params(shard=shard)))
        t += interval
    return out


def _rolling_drain(at: float, count: int, interval: float, pool: str,
                   rng: random.Random) -> list:
    return [FaultAction(round(at + i * interval, 3), "drain",
                        _params(pool=pool, ordinal=rng.randrange(1 << 16)))
            for i in range(count)]


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def _pools(profile) -> list:
    return sorted(profile.capacity)


def _spot_pools(profile, spot_pools) -> list:
    if spot_pools is not None:
        return sorted(p for p in spot_pools if p in profile.capacity)
    # late import: the replay package imports this module at load time,
    # so the fleet's spot-class constant is resolved at build time
    from ..replay.workload import POOL_SPOT
    return sorted(p for p in POOL_SPOT if p in profile.capacity)


def _biggest_pool(profile) -> str:
    """The pool with the most slices (ties: name order) — where a
    domain outage has the most correlated blast radius."""
    return max(_pools(profile), key=lambda p: (profile.capacity[p], p))


def _scn_domain_outage(rng, profile, spot_pools) -> list:
    day = profile.sim_seconds
    return [FaultAction(round(rng.uniform(0.35, 0.45) * day, 3),
                        "domain_outage",
                        _params(pool=_biggest_pool(profile),
                                domain=rng.randrange(1 << 16)))]


def _scn_spot_dryness(rng, profile, spot_pools) -> list:
    day = profile.sim_seconds
    spots = _spot_pools(profile, spot_pools) or _pools(profile)
    at = rng.uniform(0.45, 0.52) * day
    duration = rng.uniform(1500.0, 2100.0)
    return [
        FaultAction(round(at, 3), "spot_dry_start",
                    _params(pool=spots[0])),
        FaultAction(round(at + duration, 3), "spot_dry_end",
                    _params(pool=spots[0])),
    ]


def _scn_spot_shrink(rng, profile, spot_pools) -> list:
    """Partial spot dryness (docs/elastic.md): the spot pool's capacity
    halves for a window instead of vanishing. With the elastic gate on
    the scheduler sheds surplus slices in place (shrink); with it off
    every holder is swept (the full-restart baseline) — the SAME script
    drives both legs of the shrink-vs-evict comparison."""
    day = profile.sim_seconds
    spots = _spot_pools(profile, spot_pools) or _pools(profile)
    pool = spots[0]
    at = rng.uniform(0.38, 0.46) * day
    duration = rng.uniform(2000.0, 2600.0)
    level = max(profile.capacity.get(pool, 2) // 2, 1)
    return [
        FaultAction(round(at, 3), "spot_dry_start",
                    _params(pool=pool, level=level)),
        FaultAction(round(at + duration, 3), "spot_dry_end",
                    _params(pool=pool)),
    ]


def _scn_rolling_drain(rng, profile, spot_pools) -> list:
    day = profile.sim_seconds
    return _rolling_drain(rng.uniform(0.60, 0.70) * day, count=4,
                          interval=150.0, pool=_biggest_pool(profile),
                          rng=rng)


def _scn_watch_storm(rng, profile, spot_pools) -> list:
    day = profile.sim_seconds
    return _watch_storm(rng.uniform(0.15, 0.25) * day,
                        duration=rng.uniform(180.0, 300.0),
                        drop=0.15, dup=0.30)


def _scn_hot_loop(rng, profile, spot_pools) -> list:
    day = profile.sim_seconds
    return _hot_loop(rng.uniform(0.40, 0.50) * day, duration=300.0,
                     interval=15.0, shard=rng.randrange(1 << 16))


def _scn_slow_fsync(rng, profile, spot_pools) -> list:
    day = profile.sim_seconds
    return _slow_fsync(rng.uniform(0.25, 0.35) * day, duration=600.0,
                       seconds=0.25)


def _scn_adversarial(rng, profile, spot_pools) -> list:
    """The bench scenario: every primitive, staggered across the day so
    each wave lands on a fleet still digesting the previous one. Clause
    order is fixed; every time/target draws from the one rng stream."""
    acts = []
    acts += _scn_watch_storm(rng, profile, spot_pools)
    acts += _scn_slow_fsync(rng, profile, spot_pools)
    acts += _scn_domain_outage(rng, profile, spot_pools)
    acts += _scn_hot_loop(rng, profile, spot_pools)
    acts += _scn_spot_dryness(rng, profile, spot_pools)
    acts += _scn_rolling_drain(rng, profile, spot_pools)
    # a second, shorter watch storm riding the recovery tail of the
    # spot sweep — correlated faults rarely arrive alone
    acts += _watch_storm(rng.uniform(0.72, 0.78) * profile.sim_seconds,
                         duration=rng.uniform(120.0, 200.0),
                         drop=0.10, dup=0.20)
    return acts


def _scn_leader_kill(rng, profile, spot_pools) -> list:
    """The full adversarial day PLUS a SIGKILL of the control-plane
    leader landing on the recovery tail of the spot sweep — failover
    exercised under correlated faults, not in a quiet lab. Draw order
    is fixed (adversarial's clauses first, then the kill time), and the
    scenario name seeds its own rng stream, so the committed
    ``adversarial`` scenario's script is untouched bit for bit."""
    acts = _scn_adversarial(rng, profile, spot_pools)
    acts.append(FaultAction(
        round(rng.uniform(0.55, 0.65) * profile.sim_seconds, 3),
        "leader_kill"))
    return acts


def _scn_region_evacuation(rng, profile, spot_pools, regions) -> list:
    """The federation tentpole (docs/federation.md): one region dies
    whole at mid-day — leader, followers, and pools in a single sweep —
    and stays down long enough that evacuation, emigration, and the
    global SLO verdicts all land inside the window. The victim is drawn
    from the sorted region names so the script is a pure function of
    ``(seed, profile, regions)``."""
    if not regions:
        raise ValueError("region-evacuation scenario needs regions=")
    day = profile.sim_seconds
    names = sorted(regions)
    victim = names[rng.randrange(len(names))]
    at = rng.uniform(0.45, 0.55) * day
    duration = rng.uniform(1500.0, 2100.0)
    return [
        FaultAction(round(at, 3), "region_down_start",
                    _params(region=victim)),
        FaultAction(round(at + duration, 3), "region_down_end",
                    _params(region=victim)),
    ]


SCENARIOS = {
    "domain-outage": _scn_domain_outage,
    "spot-dryness": _scn_spot_dryness,
    "spot-shrink": _scn_spot_shrink,
    "rolling-drain": _scn_rolling_drain,
    "watch-storm": _scn_watch_storm,
    "hot-loop": _scn_hot_loop,
    "slow-fsync": _scn_slow_fsync,
    "adversarial": _scn_adversarial,
    "leader-kill": _scn_leader_kill,
    "region-evacuation": _scn_region_evacuation,
}

#: scenarios whose builders take the region-name list as a 4th argument;
#: every other builder keeps its 3-arg signature, so pre-existing
#: scenario scripts stay bit-identical whether or not ``regions`` is
#: passed to :func:`build_campaign`
_REGION_SCENARIOS = frozenset({"region-evacuation"})


def build_campaign(scenario: str, seed: int, profile,
                   spot_pools=None, regions=None) -> Campaign:
    """Compile ``scenario`` for ``(seed, profile)`` — pure: no wall
    clock, no ambient entropy, one namespaced rng stream. ``spot_pools``
    overrides the fleet's spot-class set (defaults to the replay
    workload's ``POOL_SPOT``); ``regions`` is the sorted-then-drawn
    victim set for region scenarios (ignored elsewhere)."""
    builder = SCENARIOS.get(scenario)
    if builder is None:
        raise ValueError(f"unknown scenario {scenario!r}: want one of "
                         f"{', '.join(sorted(SCENARIOS))}")
    rng = random.Random(f"{seed}:campaign:{scenario}")
    if scenario in _REGION_SCENARIOS:
        actions = builder(rng, profile, spot_pools, regions)
    else:
        actions = builder(rng, profile, spot_pools)
    bad = sorted({a.primitive for a in actions} - PRIMITIVES)
    if bad:
        raise ValueError(f"scenario {scenario!r} emitted unknown "
                         f"primitives {bad}")
    return Campaign(scenario=scenario, seed=seed,
                    actions=tuple(sorted(actions,
                                         key=lambda a: (a.time_s,
                                                        a.primitive,
                                                        a.params))))


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


class CampaignRunner:
    """Executes a :class:`Campaign` against a live ``ClusterReplay``.

    The replay schedules each action on its event heap and calls
    :meth:`execute` when sim time reaches it; primitives act only
    through surfaces the system itself owns — the chaos server's
    preemption/latency/watch machinery, the scheduler inventory's
    per-domain accounting, the manager's workqueue — so the blast is
    exactly what production would see, not a bench-side shortcut."""

    def __init__(self, campaign: Campaign, replay):
        self.campaign = campaign
        self.replay = replay
        #: primitive -> times executed (an action that found no victim
        #: still counts as executed; ``gangs_preempted`` says who bled)
        self.executed: dict[str, int] = {}
        #: distinct (job, primitive) gang preemptions performed
        self.gang_preemptions: list = []
        #: the same evictions with their sim times, for the incident
        #: timeline (docs/forensics.md): {"t", "job", "primitive"}
        self.preemption_log: list = []
        #: watch-storm rate stack: each _start pushes the rates it
        #: found, each _end restores the most recent push (overlapping
        #: windows degrade to nested semantics instead of a mid-storm
        #: fall-back to baseline or a no-op _end)
        self._storm_stack: list = []
        #: pool -> stack of static capacity entries to restore (None =
        #: the pool had NO static entry and goes back to Node-derived
        #: capacity); a stack for the same reason as _storm_stack —
        #: overlapping windows nest instead of ending the outage early
        self._dry_base: dict[str, list] = {}

    # -- dispatch ----------------------------------------------------------

    def execute(self, action: FaultAction) -> None:
        handler = getattr(self, "_do_" + action.primitive, None)
        if handler is None:
            raise ValueError(f"no handler for primitive "
                             f"{action.primitive!r}")
        self.executed[action.primitive] = \
            self.executed.get(action.primitive, 0) + 1
        handler(action)

    def summary(self) -> dict:
        return {
            "scenario": self.campaign.scenario,
            "fingerprint": self.campaign.fingerprint(),
            "actions_total": len(self.campaign.actions),
            "actions_executed": dict(sorted(self.executed.items())),
            "gangs_preempted": len(self.gang_preemptions),
            "gangs_preempted_by_primitive": self._gangs_by_primitive(),
        }

    def _gangs_by_primitive(self) -> dict:
        out: dict[str, int] = {}
        for _job, primitive in self.gang_preemptions:
            out[primitive] = out.get(primitive, 0) + 1
        return dict(sorted(out.items()))

    # -- correlated preemption primitives ---------------------------------

    def _preempt_jobs(self, names, primitive: str, fn=None) -> None:
        """Preempt ``names`` via ``fn`` (default: the replay's one-pod
        ``preempt_job``), recording each hit in the shared ledgers."""
        for name in names:
            hit = (fn(name) if fn is not None
                   else self.replay.preempt_job(name))
            if hit:
                self.gang_preemptions.append((name, primitive))
                self.preemption_log.append({
                    "t": self.replay.clock(), "job": name,
                    "primitive": primitive})

    def _running_in_pool(self, pool: str) -> list:
        return sorted(n for n, r in self.replay._jobs.items()
                      if r.running and not r.succeeded
                      and r.spec.pool == pool)

    def _do_domain_outage(self, action: FaultAction) -> None:
        pool = action.param("pool")
        inv = self.replay.inventory
        gangs = inv.domain_gangs(pool)
        free = inv.domain_free_map(pool)
        if not gangs or not free:
            return
        dom = action.param("domain", 0) % len(free)
        victims = sorted(job for (_ns, job), doms in gangs.items()
                         if dom in doms)
        self._preempt_jobs(victims, "domain_outage")

    def _do_spot_dry_start(self, action: FaultAction) -> None:
        pool = action.param("pool")
        #: partial dryness (docs/elastic.md): ``level`` pins capacity at
        #: a floor instead of zero. Absent (every committed scenario)
        #: the classic total-dryness semantics apply bit for bit.
        level = action.param("level")
        inv = self.replay.inventory
        # save the STATIC entry, not capacity_slices(): a pool with
        # Node-derived capacity has no static entry, and restoring
        # must remove the 0-pin (None), not freeze a snapshot of
        # the node count as a permanent static override
        self._dry_base.setdefault(pool, []).append(
            inv.static_capacity.get(pool))
        # capacity vanishes FIRST, then the response: evicted gangs must
        # not be re-admitted into a pool that no longer exists
        inv.set_static_capacity(pool, 0 if level is None else int(level))
        if level is not None:
            if getattr(self.replay, "elastic", False):
                # the scheduler's shrink pass is the authority over an
                # overcommitted pool (docs/elastic.md): elastic gangs
                # shed surplus slices in place, only the remainder
                # evicts whole — one nudged pass, no harness-side sweep
                self.replay.scheduler.schedule_pass()
                return
            # baseline (gate off): partial dryness still reclaims WHOLE
            # gangs — one pod per slice, so slice-atomic failover tears
            # each gang down in a single round and it re-enters its
            # queue complete (a lone pending slice would starve behind
            # a fully-evicted head's reservation forever)
            holders = sorted({h.job for h in inv.held_records()
                              if h.pool == pool})
            self._preempt_jobs(holders, "spot_dry",
                               fn=self.replay.preempt_gang)
            return
        holders = sorted({h.job for h in inv.held_records()
                          if h.pool == pool})
        self._preempt_jobs(holders, "spot_dry")

    def _do_spot_dry_end(self, action: FaultAction) -> None:
        pool = action.param("pool")
        stack = self._dry_base.get(pool)
        if not stack:
            return                       # no matching _start
        base = stack.pop()
        if not stack:
            del self._dry_base[pool]
        self.replay.inventory.set_static_capacity(pool, base)

    def _do_drain(self, action: FaultAction) -> None:
        running = self._running_in_pool(action.param("pool"))
        if not running:
            return
        name = running[action.param("ordinal", 0) % len(running)]
        self._preempt_jobs([name], "drain")

    # -- watch storm -------------------------------------------------------

    def _do_watch_storm_start(self, action: FaultAction) -> None:
        cfg = self.replay.chaos.config
        self._storm_stack.append((cfg.drop_watch_events,
                                  cfg.duplicate_watch_events))
        cfg.drop_watch_events = float(action.param("drop", 0.0))
        cfg.duplicate_watch_events = float(action.param("dup", 0.0))

    def _do_watch_storm_end(self, action: FaultAction) -> None:
        if not self._storm_stack:
            return                       # no matching _start
        cfg = self.replay.chaos.config
        cfg.drop_watch_events, cfg.duplicate_watch_events = \
            self._storm_stack.pop()

    # -- hot-looping controller -------------------------------------------

    def _do_hot_loop(self, action: FaultAction) -> None:
        mgr = self.replay.manager
        shard = action.param("shard", 0) % mgr.shards
        for name in sorted(self.replay._jobs):
            rec = self.replay._jobs[name]
            if rec.succeeded:
                continue
            if shard_for("default", name, mgr.shards) == shard:
                mgr.enqueue(Request("TestJob", "default", name))

    # -- leader kill -------------------------------------------------------

    def _do_leader_kill(self, action: FaultAction) -> None:
        """SIGKILL the control-plane leader and promote the most-
        caught-up WAL follower (docs/replication.md). The replay owns
        the process model; it raises loudly when the campaign was run
        without ``replication_followers`` — a silently skipped failover
        would gut the scenario's whole point."""
        self.replay.kill_leader()

    # -- region down -------------------------------------------------------

    def _do_region_down_start(self, action: FaultAction) -> None:
        """Kill an entire region — leader, followers, pools — and hand
        evacuation to the federation driver (docs/federation.md). Like
        ``leader_kill``, a replay that cannot evacuate raises loudly: a
        silently skipped region death would gut the scenario. Evacuated
        jobs land in the shared preemption ledgers so the forensics
        timeline can chain their pages to the ``region_down`` window."""
        region = action.param("region")
        evacuate = getattr(self.replay, "region_down", None)
        if evacuate is None:
            raise RuntimeError(
                "region_down needs a federation driver (FederationReplay"
                "); a single-cluster replay has no region to kill")
        for name in evacuate(region):
            self.gang_preemptions.append((name, "region_down"))
            self.preemption_log.append({
                "t": self.replay.clock(), "job": name,
                "primitive": "region_down"})

    def _do_region_down_end(self, action: FaultAction) -> None:
        """Close the forensics window. The region does NOT come back —
        evacuation is one-way for the day (a revived region would need a
        rejoin/backfill protocol this layer doesn't model yet); the
        driver only notes the window so timeline attribution can pair
        start and end by region param."""
        region = action.param("region")
        restore = getattr(self.replay, "region_down_end", None)
        if restore is not None:
            restore(region)

    # -- slow fsync --------------------------------------------------------

    def _do_slow_fsync_start(self, action: FaultAction) -> None:
        seconds = float(action.param("seconds", 0.1))
        self.replay.chaos.config.op_latency["fsync"] = (1.0, seconds)

    def _do_slow_fsync_end(self, action: FaultAction) -> None:
        self.replay.chaos.config.op_latency.pop("fsync", None)


# ---------------------------------------------------------------------------
# recovery parity
# ---------------------------------------------------------------------------


def control_plane_digest(api, exclude_kinds=("Event",)) -> dict:
    """Deterministic digest of the store's object-level state: every
    (kind, namespace, name) with its spec, statuses excluded (a campaign
    legitimately writes alert conditions; *object-level* parity means
    the same world of objects with the same declared intent). The
    adversarial gate holds a post-campaign run to the same digest as a
    fault-free reference run of the identical workload."""
    rows = []
    for kind in sorted(api.kinds()):
        if kind in exclude_kinds:
            continue
        for obj in api.list(kind):
            md = obj.get("metadata") or {}
            rows.append({
                "kind": kind,
                "namespace": md.get("namespace", "default"),
                "name": md.get("name", ""),
                "spec": obj.get("spec"),
            })
    rows.sort(key=lambda r: (r["kind"], r["namespace"], r["name"]))
    blob = json.dumps(rows, sort_keys=True).encode()
    return {"objects": len(rows),
            "digest": hashlib.sha256(blob).hexdigest()}
