"""FederationReplay: N regions in lockstep, evacuation, survival gate.

The tentpole driver (docs/federation.md): one
:class:`~kubedl_tpu_torch.core.clock.SimClock` shared by N simulated regions,
each a full :class:`~kubedl_tpu_torch.replay.harness.ClusterReplay` — its own
durable, replicated control plane (leader + follower via
``core/replication.py``), scheduler, inventory, and elastic gate — plus
a per-region serving fleet. The federation layer above them:

* **global queue routing** — every workload arrival is routed by the
  :class:`~kubedl_tpu_torch.federation.routing.GlobalRouter` (per-region
  placement scores ÷ the topology's latency/egress factor) and injected
  into the winning region;
* **cross-region serving catalog** — cold-prefix homes partitioned
  across regions with geo-affinity
  (:class:`~kubedl_tpu_torch.federation.catalog.GlobalServingCatalog`), each
  region's :class:`~kubedl_tpu_torch.serving.router.PrefixAwareRouter`
  placing within its fleet;
* **cross-region WAL shipping** — each region's journal mirrored to a
  peer-region standby with bounded retry/backoff
  (:mod:`~kubedl_tpu_torch.federation.shipping`);
* **region evacuation** — the ``region_down`` chaos primitive kills one
  region's leader, followers, and pools at once. The peer standby
  catches up from the dead region's WAL (the zero-acknowledged-loss
  audit reads it), elastic jobs emigrate with their object-store-banked
  progress (the object-store tier, modeled as a fixed publish cadence
  + restore cost), serving streams re-route through surviving fleets,
  and the federation SLO set pages — then clears — with every page
  causally linked to the ``region_down`` window by the forensics
  timeline.

The emigration model: elastic jobs publish checkpoints to the object
store every :data:`REGION_CKPT_INTERVAL_S` of progress, so an evacuee
restarts in the survivor from its last banked interval, paying
:data:`OBJECT_RESTORE_S` of restore plus the un-banked tail as lost
work. Both constants are the replay-side stand-in for
``train/checkpoint.py``'s ``CheckpointTiers`` object-store tier running
on real hardware.

Everything here is deterministic for a fixed ``(topology, seed)``:
every rng is namespaced, every iteration order sorted, and the campaign
is a pure function of its inputs — ``bench_federation.py`` gates on two
in-process runs being bit-for-bit identical.

Copied from ``kubedl_tpu/federation/replay.py`` (the port imports nothing
of the JAX package), statement for statement, with one addition:
:class:`FederationReplay` takes ``model=`` (``(config, params)``, by
default the replays' tiny model, shared by every replica of every region
since nothing writes it) and ``device=`` (the card unless the caller
names the CPU), handed to the tiny model and to every engine the fleets'
factory builds, the evacuation's included.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional

from .._device import resolve_device
from ..chaos.campaign import CampaignRunner, build_campaign
from ..core import meta as m
from ..core.clock import SimClock
from ..core.events import Recorder
from ..api.slo import new_slo
from ..metrics.registry import FederationMetrics, Registry
from ..replay.harness import ClusterReplay, _EPS
from ..replay.serving import _tiny_model
from ..replay.workload import PROFILES, Workload, generate
from ..scheduling.scoring import PlacementScorer
from ..serving.fleet import ServingFleet
from ..serving.router import PrefixAwareRouter
from ..telemetry.slo import SLOEvaluator
from .catalog import GlobalServingCatalog
from .routing import GlobalRouter, region_of
from .shipping import CrossRegionShipper, CrossRegionStandby, ReadGateway
from .topology import RegionTopology

#: object-store checkpoint publish cadence, in full-width progress
#: seconds: an evacuee's banked progress is floor(done / interval) ×
#: interval (train/checkpoint.py's object tier at replay scale)
REGION_CKPT_INTERVAL_S = 600.0

#: restore cost in the surviving region: object-store read + rehydrate
OBJECT_RESTORE_S = 45.0

#: fed event kinds (same-time order: jobs route before streams before
#: campaign actions, matching the single-cluster heap convention)
_FEV_JOB, _FEV_STREAM, _FEV_CAMPAIGN = 0, 1, 2


def federation_slos(profile) -> list:
    """The federation's declared objectives (docs/federation.md "The
    zero-loss gate"). ``evac_restore`` samples are the survival pager:
    every emigration observes ``OBJECT_RESTORE_S + lost_work`` (always
    past the 30 s target — an evacuation is SUPPOSED to page) and every
    evacuee's completion in its new region observes a passing ack, so
    the page fires inside the ``region_down`` window, burns budget
    without exhausting it, and clears before end of day. Page-only
    alerting: a ticket pair's multi-hour long window could outlive the
    settle tail and strand the alert."""
    window = 4.0 * profile.sim_seconds
    return [
        new_slo("fed-evac-restore", "evac_restore", 30.0, goal=0.25,
                window_s=window, uid="slo-fed-evac-restore",
                alerting=[{"severity": "page", "shortSeconds": 300.0,
                           "longSeconds": 1800.0, "burn": 1.2}]),
        new_slo("fed-evac-lostwork", "evac_lostwork",
                1.5 * REGION_CKPT_INTERVAL_S, window_s=window,
                uid="slo-fed-evac-lostwork"),
    ]


class FederationReplay:
    """One federated day: N regions, one shared clock, one global layer.

    ``journal_root`` hosts one journal directory per region (each
    region's control plane is durable + replicated — the federation
    refuses to run without that substrate, mirroring the
    ``--enable-federation`` / ``--enable-durability`` flag coupling).
    """

    def __init__(self, topology: RegionTopology, journal_root: str,
                 seed: int = 0, scenario: str = "region-evacuation",
                 profile: str = "federation", model=None, device=None):
        import os
        device = resolve_device(device)
        self.topology = topology
        self.seed = int(seed)
        self.clock = SimClock()
        self.registry = Registry()
        self.metrics = FederationMetrics(self.registry)
        self.workload = generate(profile, seed=self.seed)
        prof = self.workload.profile
        self.campaign = build_campaign(scenario, self.seed, prof,
                                       regions=topology.regions)
        self.campaign_runner = CampaignRunner(self.campaign, self)

        # -- the regions (sorted order everywhere) -------------------------
        empty = Workload(profile=prof, seed=self.seed, jobs=(),
                         preemptions=(), serving=(), serving_prefixes=())
        self.regions: dict = {}
        for name in topology.regions:
            self.regions[name] = ClusterReplay(
                empty, journal_dir=os.path.join(journal_root, name),
                replication_followers=1, elastic=True, clock=self.clock)
        self.alive = set(topology.regions)

        # -- global routing ------------------------------------------------
        self.router = GlobalRouter(topology, metrics=self.metrics)
        for name in topology.regions:
            reg = self.regions[name]
            self.router.add_region(
                name, PlacementScorer(reg.inventory),
                sorted(prof.capacity))

        # -- cross-region shipping (standby hosted in the nearest peer) ----
        self.standbys: dict = {}
        self.shippers: dict = {}
        self.gateways: dict = {}
        for name in topology.regions:
            reg = self.regions[name]
            host = next(r for r in topology.nearest(name) if r != name)
            standby = CrossRegionStandby(name, host, clock=self.clock)
            rcp = reg.replication
            self.standbys[name] = standby
            self.shippers[name] = CrossRegionShipper(
                name, reg.inner, reg.journal, standby,
                epoch_fn=lambda rcp=rcp: rcp.epoch, seed=self.seed,
                metrics=self.metrics,
                recorder=Recorder(reg.inner, "federation-shipper"))
            self.gateways[name] = ReadGateway(standby, name,
                                              metrics=self.metrics)

        # -- serving: one fleet + prefix router per region -----------------
        cfg, params = (_tiny_model(device=device) if model is None
                       else model)
        self.fleets: dict = {}
        self.serving_routers: dict = {}
        for ri, name in enumerate(topology.regions):
            def factory(ordinal, ri=ri):
                from ..serving.batching import ContinuousBatchingEngine
                return ContinuousBatchingEngine(
                    cfg, params, lanes=prof.lanes, max_len=prof.max_len,
                    kv_mode="paged", kv_block=prof.kv_block,
                    pool_blocks=prof.pool_blocks,
                    seed=self.seed + 101 * ri + ordinal, device=device)
            fleet = ServingFleet(factory, replicas=2,
                                 name_prefix=f"{name}-replica")
            self.fleets[name] = fleet
            self.serving_routers[name] = PrefixAwareRouter(
                fleet, seed=f"{self.seed}:{name}")
        origins = {
            p: region_of("prefix:" + ",".join(str(int(t)) for t in p),
                         topology.regions)
            for p in self.workload.serving_prefixes}
        self.catalog = GlobalServingCatalog(topology, origins,
                                            affinity=2,
                                            metrics=self.metrics)

        # -- federation SLO engine (headless, shared clock) ----------------
        self.slo = SLOEvaluator(clock=self.clock,
                                evaluate_interval_s=60.0)
        for obj in federation_slos(prof):
            self.slo.add(obj)

        # -- bookkeeping ---------------------------------------------------
        self._events: list = []
        self._seq = 0
        self.rounds = 0
        #: stream records: name, prefix, region, req, outcome flags
        self.streams: list = []
        self.streams_rerouted = 0
        #: evacuee -> destination region (drained as completions land)
        self._evac_pending: dict = {}
        self._evac_completed: list = []
        #: region -> evacuation record (audit + emigration manifest)
        self.evacuations: dict = {}
        self._job_region: dict = {}

    # ------------------------------------------------------------------
    # fed events
    # ------------------------------------------------------------------

    def _push(self, sim_t: float, kind: int, payload) -> None:
        self._seq += 1
        heapq.heappush(self._events, (sim_t, kind, self._seq, payload))

    def prepare(self) -> None:
        for spec in self.workload.jobs:
            self._push(spec.arrival_s, _FEV_JOB, spec)
        for idx, a in enumerate(self.workload.serving):
            self._push(a.arrival_s, _FEV_STREAM, (idx, a))
        for action in self.campaign.actions:
            self._push(action.time_s, _FEV_CAMPAIGN, action)
        for name in self.topology.regions:
            self.regions[name].prepare()

    def _on_job(self, spec) -> None:
        origin = region_of(spec.name, self.topology.regions)
        region, pool = self.router.route(
            spec.name, key="TestJob", demand=spec.num_slices,
            origin=origin, pools=[spec.pool])
        self._job_region[spec.name] = region
        self.regions[region].inject_job(
            dataclasses.replace(spec, pool=pool))

    def _live_home(self, origin: str) -> str:
        """Nearest live region to ``origin`` (origin itself when up)."""
        for r in self.topology.nearest(origin):
            if r in self.alive:
                return r
        raise RuntimeError("no live region left")

    def _on_stream(self, idx: int, a) -> None:
        name = f"rs-{idx:05d}"
        prefix = (self.workload.serving_prefixes[a.prefix_rank]
                  if a.prefix_rank >= 0 else None)
        if prefix is not None:
            home = self.catalog.home(prefix)
            initial = self.catalog.initial_homes[tuple(prefix)]
        else:
            initial = region_of(name, self.topology.regions)
            home = self._live_home(initial)
        if home != initial:
            self.streams_rerouted += 1
            self.metrics.streams_rerouted.inc(region=initial)
        req, _rep = self.serving_routers[home].submit(
            list(a.prompt), a.max_new, prefix=prefix)
        # a stream re-homed AT ARRIVAL (its initial home already dead)
        # is served normally and stays inside the zero-drop gate; only
        # mid-flight evacuation sets the evacuated flag
        self.streams.append({
            "name": name, "prefix": prefix, "region": home,
            "initial": initial, "req": req, "evacuated": False,
            "done": False, "ok": False,
        })

    def _on_campaign(self, action) -> None:
        self.campaign_runner.execute(action)

    # ------------------------------------------------------------------
    # the lockstep loop
    # ------------------------------------------------------------------

    def _next_wake(self) -> Optional[float]:
        wakes = []
        if self._events:
            wakes.append(self._events[0][0])
        for name in sorted(self.alive):
            w = self.regions[name].next_wake()
            if w is not None:
                wakes.append(w)
            if self.shippers[name].queue:
                wakes.append(min(
                    self.clock.elapsed + 1.0,
                    max(self.shippers[name].queue[0][2] - self.clock.t0,
                        self.clock.elapsed)))
        if any(self.fleets[n].busy() for n in self.alive):
            wakes.append(self.clock.elapsed
                         + self.workload.profile.tick_s)
        return min(wakes) if wakes else None

    def _service(self) -> None:
        while self._events \
                and self._events[0][0] <= self.clock.elapsed + _EPS:
            _, kind, _, payload = heapq.heappop(self._events)
            if kind == _FEV_JOB:
                self._on_job(payload)
            elif kind == _FEV_STREAM:
                self._on_stream(*payload)
            else:
                self._on_campaign(payload)
        for name in sorted(self.alive):
            self.regions[name].service()
        for name in sorted(self.alive):
            self.shippers[name].pump(self.clock())
        for name in sorted(self.alive):
            fleet = self.fleets[name]
            if fleet.busy():
                fleet.step()
        self._harvest_streams()
        self._poll_evacuated()
        self.slo.maybe_evaluate(self.clock())

    def _harvest_streams(self) -> None:
        for s in self.streams:
            if s["done"]:
                continue
            req = s["req"]
            if req.done.is_set():
                s["done"] = True
                s["ok"] = (not req.cancelled) and (req.error is None)

    def _poll_evacuated(self) -> None:
        """An evacuee finishing in its new region is the evacuation's
        ack: a passing restore sample (clears the page's burn) and the
        all-jobs-complete gate's evidence."""
        if not self._evac_pending:
            return
        now = self.clock()
        for name in sorted(self._evac_pending):
            target = self._evac_pending[name]
            rec = self.regions[target]._jobs.get(name)
            if rec is not None and rec.succeeded:
                del self._evac_pending[name]
                self._evac_completed.append(name)
                self.slo.observe("evac_restore", 1.0, now,
                                 {"job": name})

    def _done(self) -> bool:
        return (not self._events
                and all(self.regions[n].finished
                        for n in sorted(self.alive))
                and not any(self.fleets[n].busy()
                            for n in sorted(self.alive))
                and all(s["done"] for s in self.streams))

    def run(self) -> dict:
        prof = self.workload.profile
        self.prepare()
        max_rounds = (200 * len(self.workload.jobs)
                      + 64 * len(self.workload.serving) + 20_000)
        while not self._done():
            self.rounds += 1
            if self.rounds > max_rounds:
                raise RuntimeError(
                    f"federation exceeded {max_rounds} rounds — wedged?")
            nxt = self._next_wake()
            if nxt is None:
                raise RuntimeError(
                    "federation wedged: no events, no region deadlines, "
                    "work unfinished")
            self.clock.advance_to(nxt + _EPS)
            self._service()
        for name in sorted(self.alive):
            self.regions[name].finalize()
        self.slo.evaluate(self.clock())
        return self._result()

    # ------------------------------------------------------------------
    # region evacuation (the CampaignRunner's region_down seam)
    # ------------------------------------------------------------------

    def region_down(self, region: str) -> list:
        """The ``region_down`` primitive: the region's leader, follower,
        and pools die in one sweep. Returns the evacuated job names (the
        runner folds them into its shared preemption ledgers). The
        evacuation state machine, in order (docs/federation.md):

        1. the global router stops routing into the region;
        2. the leader is SIGKILLed (journal never closed) and the
           cross-region shipper detaches — queued frames are abandoned,
           exactly like a real region losing its egress;
        3. the peer-region standby catches up from the dead region's WAL
           (read-only successor), and the **zero-loss audit** compares
           every acknowledged object's rv at the instant of death
           against the caught-up standby;
        4. every unfinished job emigrates: progress banked at the
           object-store checkpoint cadence, the remainder re-routed to
           the best surviving region, restore + lost work observed as
           federation SLO samples;
        5. the serving catalog drops the region, live streams there are
           re-submitted to their new homes, and the fleet dies (its
           in-flight requests were already re-homed).
        """
        if region not in self.alive:
            raise RuntimeError(f"region {region!r} is already down")
        reg = self.regions[region]
        now = self.clock()
        self.router.remove_region(region)

        rcp = reg.replication
        pre = {k: m.resource_version(o)
               for k, o in reg.inner._objs.items() if k[0] != "Lease"}
        rcp.kill_leader()
        self.shippers[region].detach()
        standby = self.standbys[region]
        catch_up = standby.catch_up_from_journal(rcp.journal)
        wobjs = standby.store.api._objs
        lost = sum(1 for k, rv in pre.items()
                   if k not in wobjs
                   or m.resource_version(wobjs[k]) != rv)

        evacuated = []
        manifests = []
        for name in sorted(reg._jobs):
            jrec = reg._jobs[name]
            if jrec.succeeded:
                continue
            # the survivor reads the evacuee's object through the peer
            # standby's gateway — the cross-region read path, counted
            self.gateways[region].get("TestJob", "default", name)
            spec = jrec.spec
            done = spec.duration_s - jrec.remaining
            if jrec.running and jrec.run_start is not None:
                done += (now - jrec.run_start) * jrec.width_frac
            banked = (math.floor(max(done, 0.0) / REGION_CKPT_INTERVAL_S)
                      * REGION_CKPT_INTERVAL_S)
            lost_work = max(done - banked, 0.0)
            remaining = max(spec.duration_s - banked, 1.0)
            origin = region_of(name, self.topology.regions)
            target, pool = self.router.route(
                f"{name}:evac", key="TestJob", demand=spec.num_slices,
                origin=origin, pools=[spec.pool])
            self.regions[target].inject_job(dataclasses.replace(
                spec, arrival_s=round(self.clock.elapsed, 3),
                duration_s=remaining, pool=pool))
            self._evac_pending[name] = target
            self._job_region[name] = target
            self.metrics.jobs_evacuated.inc(region=region)
            self.slo.observe("evac_restore",
                             OBJECT_RESTORE_S + lost_work, now,
                             {"job": name})
            self.slo.observe("evac_lostwork", lost_work, now,
                             {"job": name})
            evacuated.append(name)
            manifests.append({
                "job": name, "target": target,
                "bankedSeconds": round(banked, 1),
                "lostWorkSeconds": round(lost_work, 1),
                "restoreSeconds": OBJECT_RESTORE_S,
            })

        moved = self.catalog.evacuate(region)
        streams_moved = 0
        for s in self.streams:
            if s["done"] or s["region"] != region:
                continue
            prefix = s["prefix"]
            if prefix is not None:
                new_home = self.catalog.home(prefix)
            else:
                new_home = self._live_home(s["initial"])
            req, _rep = self.serving_routers[new_home].submit(
                list(s["req"].prompt), s["req"].max_new, prefix=prefix)
            s["req"] = req
            s["region"] = new_home
            s["evacuated"] = True
            streams_moved += 1
            self.streams_rerouted += 1
            self.metrics.streams_rerouted.inc(region=region)
        self.fleets[region].stop()
        self.alive.discard(region)
        self.metrics.regions_down.set(
            len(self.topology.regions) - len(self.alive))

        self.evacuations[region] = {
            "region": region,
            "atSimSeconds": round(self.clock.elapsed, 1),
            "ackObjectsAtKill": len(pre),
            "ackObjectsLost": lost,
            "standbyCatchUp": catch_up,
            "jobsEvacuated": len(evacuated),
            "emigrations": manifests,
            "prefixHomesMoved": len(moved),
            "streamsRerouted": streams_moved,
        }
        return evacuated

    def region_down_end(self, region: str) -> None:
        """Window close only: evacuation is one-way for the day (a
        revived region would need a rejoin/backfill protocol this layer
        doesn't model). The forensics timeline pairs start/end by the
        region param; nothing to execute."""

    # ------------------------------------------------------------------
    # the console surface
    # ------------------------------------------------------------------

    def status(self) -> dict:
        """The console's ``/api/v1/federation/status`` document: the
        live global layer — region liveness, routing spread, catalog
        homes, shipping health, standby state — as it stands NOW (the
        scorecard in :meth:`_result` is the end-of-day rollup)."""
        return {
            "regions": list(self.topology.regions),
            "regionsAlive": sorted(self.alive),
            "routing": self.router.status(),
            "catalog": self.catalog.status(),
            "shipping": {n: self.shippers[n].status()
                         for n in self.topology.regions},
            "standbys": {n: self.standbys[n].status()
                         for n in self.topology.regions},
            "evacuatedRegions": sorted(self.evacuations),
        }

    # ------------------------------------------------------------------
    # the scorecard
    # ------------------------------------------------------------------

    def _slo_health(self) -> dict:
        fired = pages = stranded = 0
        min_budget = 1.0
        for s in self.slo.statuses():
            if "invalid" in s:
                continue
            if s.get("budgetRemaining") is not None:
                min_budget = min(min_budget, s["budgetRemaining"])
            for severity, a in s["alerts"].items():
                fired += a["fired"]
                if severity == "page":
                    pages += a["fired"]
                if a["firing"]:
                    stranded += 1
        return {
            "alerts_fired": fired,
            "pages_fired": pages,
            "stranded_alerts": stranded,
            "min_budget_remaining": round(min_budget, 6),
        }

    def _forensics_block(self, campaign_summary: dict,
                         slo_health: dict) -> dict:
        from ..forensics import IncidentTimeline, build_postmortem
        tl = IncidentTimeline(epoch=self.clock.t0)
        tl.add_campaign(self.campaign)
        tl.add_alert_log(self.slo.alert_log, self.slo.specs())
        tl.add_preemptions(self.campaign_runner.preemption_log)
        tl.add_bad_samples(self.slo.bad_samples)
        return build_postmortem(
            self.campaign.scenario, self.seed,
            campaign_summary["fingerprint"], tl.build(),
            slo_health=slo_health)

    def _result(self) -> dict:
        job_done = {
            spec.name: any(
                r._jobs.get(spec.name) is not None
                and r._jobs[spec.name].succeeded
                for r in self.regions.values())
            for spec in self.workload.jobs}
        unfinished = sorted(n for n, ok in job_done.items() if not ok)
        dropped = sorted(
            s["name"] for s in self.streams
            if not s["evacuated"] and not (s["done"] and s["ok"]))
        evac_ok = sorted(
            s["name"] for s in self.streams
            if s["evacuated"] and s["done"] and s["ok"])
        slo_health = self._slo_health()
        campaign_summary = self.campaign_runner.summary()
        out = {
            "regions": list(self.topology.regions),
            "regions_alive": sorted(self.alive),
            "topology_fingerprint": self.topology.fingerprint(),
            "makespan_s": round(self.clock.elapsed, 1),
            "rounds": self.rounds,
            "jobs": {
                "submitted": len(self.workload.jobs),
                "completed": sum(1 for ok in job_done.values() if ok),
                "unfinished": unfinished,
                "evacuated": sum(e["jobsEvacuated"]
                                 for e in self.evacuations.values()),
                "evacuated_completed": len(self._evac_completed),
                "evacuated_pending": sorted(self._evac_pending),
            },
            "serving": {
                "streams": len(self.streams),
                "completed_ok": sum(1 for s in self.streams
                                    if s["done"] and s["ok"]),
                "rerouted": self.streams_rerouted,
                "evacuated_completed_ok": len(evac_ok),
                "dropped_non_evacuated": dropped,
            },
            "routing": self.router.status(),
            "catalog": self.catalog.status(),
            "shipping": {n: self.shippers[n].status()
                         for n in self.topology.regions},
            "standbys": {n: self.standbys[n].status()
                         for n in self.topology.regions},
            "reads": {n: {"served": self.gateways[n].reads,
                          "redirected": self.gateways[n].redirects}
                      for n in self.topology.regions},
            "evacuations": {r: dict(v)
                            for r, v in sorted(self.evacuations.items())},
            "per_region": {
                n: {"alive": n in self.alive,
                    "jobs_completed": self.regions[n]._completions,
                    "rounds": self.regions[n].rounds}
                for n in self.topology.regions},
            "slo": self.slo.summary(ndigits=4),
            "slo_health": slo_health,
            "campaign": campaign_summary,
            "forensics": self._forensics_block(campaign_summary,
                                               slo_health),
        }
        return out
