"""Serving-fleet replay: replicas + router + autoscaler on sim time.

The multi-replica sibling of :mod:`replay/serving
<kubedl_tpu_torch.replay.serving>` (docs/serving_fleet.md): a seeded,
tenant-labelled request day drives a REAL :class:`ServingFleet` of
continuous-batching engines through the real
:class:`~kubedl_tpu_torch.serving.router.PrefixAwareRouter` and
:class:`~kubedl_tpu_torch.controllers.servingfleet.ServingAutoscaler`, all on
one :class:`SimClock`. Everything the block reports comes from the
system's own observability — request spans, router counters, engine
``health()``, the headless SLO evaluator — never bench-local clocks.

**The prefill cost model** (the one simulated quantity): a chunked
prefill of ``P`` prompt tokens occupies a COMBINED replica's single
device for ``P * prefill_token_s`` simulated seconds — the replay
parks that replica (its decode cadence stalls, its queue keeps
growing) for exactly that long, which is what interleaved
prefill/decode on one device does. A DISAGGREGATED replica's prefill
lanes absorb the same work on the modeled prefill device, so its
decode ticks never stall; the request still pays admission + the
block-table handoff inside the engine. Token outputs are identical
either way (greedy decoding; pinned by
``tests/test_serving_fleet.py``) — the model only moves *time*.

Copied from ``kubedl_tpu/replay/fleet.py`` (the port imports nothing of the
JAX package), with two changes: ``ServingFleetReplay`` and the
comparison legs take ``device=`` (the card unless the caller names the
CPU), handed to every engine, and the weights each replica serves come
from the ``_replica_params`` seam.
"""

from __future__ import annotations

import random
from dataclasses import asdict, dataclass
from typing import Optional

import hashlib
import json

from ..api.queue import QueueSpec
from ..api.slo import new_slo
from ..controllers.servingfleet import AutoscalerConfig, ServingAutoscaler
from ..core.clock import SimClock
from ..metrics.registry import Registry, ServingFleetMetrics, TraceMetrics
from ..serving.fleet import ServingFleet
from ..serving.router import PrefixAwareRouter, RandomRouter
from ..telemetry.slo import RequestSpanHarvester, SLOEvaluator
from ..trace import Tracer
from ..utils.stats import summarize
from .workload import _burst_windows, _pick, _zipf_weights


@dataclass(frozen=True)
class FleetProfile:
    """One fleet-replay scale — a pure value, fingerprinted with the
    workload (the committed blocks are bit-for-bit replayable)."""
    name: str
    sim_seconds: float
    requests: int
    bursts: int
    burst_frac: float = 0.85
    # -- engine shape -----------------------------------------------------
    decode_lanes: int = 8
    prefill_lanes: int = 2        # reserved only when disaggregated
    max_len: int = 64
    kv_block: int = 8
    pool_blocks: int = 80
    # -- prefix mix -------------------------------------------------------
    prefixes: int = 10
    prefix_share: float = 0.75
    #: Zipf exponent over prefix ranks (lower = flatter tail — the
    #: regime where per-replica cache caps actually bind)
    zipf_s: float = 1.1
    max_prefixes_per_replica: int = 4
    long_prompt_frac: float = 0.0
    # -- fleet ------------------------------------------------------------
    replicas: int = 3
    max_replicas: int = 4
    tenants: tuple = ("ads", "search", "free")
    tenant_weights: tuple = (0.5, 0.3, 0.2)
    # -- time model -------------------------------------------------------
    tick_s: float = 0.05
    prefill_token_s: float = 0.004
    drain_every: int = 64
    # -- SLO --------------------------------------------------------------
    ttft_target_s: float = 5.0
    ttft_goal: float = 0.75
    #: page pair: windows sized so one flash crowd dominates the long
    #: window; burn <= 1/budget or the pair can never fire (docs/slo.md)
    page_short_s: float = 60.0
    page_long_s: float = 300.0
    page_burn: float = 1.5
    trace_capacity: int = 32768


#: the three committed legs (BENCH_SERVING_FLEET.json + the
#: ``serving.fleet`` block of BENCH_CLUSTER.json):
FLEET_PROFILES = {
    # prefix-aware vs random placement at equal traffic: 15 flat-ish
    # Zipf prefixes over a per-replica cache of 6 — consistent-hash
    # affinity partitions the catalog (each home replica's share fits
    # its cache), uniform placement makes every replica churn through
    # all 15 and the LRU cap binds
    "routing": FleetProfile(
        name="routing", sim_seconds=1800.0, requests=3000, bursts=24,
        replicas=3, max_replicas=3, prefix_share=0.8, prefixes=15,
        max_prefixes_per_replica=6, zipf_s=0.6),
    # long-prompt-heavy mix: half the prompts near the cache cap, so a
    # combined replica's decode cadence stalls behind chunked prefills
    # while the disaggregated one hands block tables to decode lanes
    "disagg": FleetProfile(
        name="disagg", sim_seconds=1200.0, requests=2400, bursts=30,
        replicas=2, max_replicas=2, prefix_share=0.35,
        long_prompt_frac=0.5, pool_blocks=120, prefill_token_s=0.003),
    # flash crowd against a one-replica fleet: the TTFT objective pages,
    # replicas scale up, the burn clears without exhausting the budget,
    # and the post-crowd quiet drains the fleet back down
    "autoscaler": FleetProfile(
        name="autoscaler", sim_seconds=7200.0, requests=2400, bursts=1,
        burst_frac=0.25, replicas=1, max_replicas=4,
        ttft_target_s=5.0, ttft_goal=0.75, page_burn=2.0),
}


@dataclass(frozen=True)
class FleetArrival:
    arrival_s: float
    prompt: tuple
    max_new: int
    tenant: str
    prefix_rank: int              # -1 = no shared prefix


@dataclass(frozen=True)
class FleetWorkload:
    profile: FleetProfile
    seed: int
    arrivals: tuple               # FleetArrival, arrival-sorted
    prefixes: tuple               # token tuples, rank order

    def fingerprint(self) -> str:
        doc = {"profile": asdict(self.profile), "seed": self.seed,
               "arrivals": [asdict(a) for a in self.arrivals],
               "prefixes": [list(p) for p in self.prefixes]}
        blob = json.dumps(doc, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


def generate_fleet(profile: FleetProfile | str,
                   seed: int = 0) -> FleetWorkload:
    """The fleet request day, reproducibly (namespaced rng streams
    only, exactly like :func:`replay.workload.generate`)."""
    if isinstance(profile, str):
        profile = FLEET_PROFILES[profile]
    rng = random.Random(f"{seed}:fleet:{profile.name}")
    day = profile.sim_seconds
    prefixes = tuple(
        tuple(rng.randrange(1, 127)
              for _ in range(rng.randrange(20, 33)))
        for _ in range(profile.prefixes))
    zipf = list(zip(range(profile.prefixes),
                    _zipf_weights(profile.prefixes, s=profile.zipf_s)))
    tenants = list(zip(profile.tenants, profile.tenant_weights))
    bursts = _burst_windows(rng, profile.bursts, day, 2.0, 15.0)
    out = []
    for _ in range(profile.requests):
        if bursts and rng.random() < profile.burst_frac:
            t0, width = bursts[rng.randrange(len(bursts))]
            arrival = min(t0 + rng.uniform(0.0, width), day - 1.0)
        else:
            arrival = rng.uniform(0.0, day)
        if rng.random() < profile.prefix_share:
            rank = _pick(rng, zipf)
            body = list(prefixes[rank])
        else:
            rank = -1
            body = [rng.randrange(1, 127)
                    for _ in range(rng.randrange(4, 17))]
        if profile.long_prompt_frac and \
                rng.random() < profile.long_prompt_frac:
            # long-prompt mix (the disagg leg's subject): suffix sized
            # so the prompt lands near the cache cap
            lo = max(profile.max_len // 2 - len(body), 1)
            hi = max(profile.max_len - 9 - len(body), lo + 1)
            suffix_n = rng.randrange(lo, hi)
        else:
            suffix_n = rng.randrange(3, 13)
        suffix = [rng.randrange(1, 127) for _ in range(suffix_n)]
        prompt = tuple(body + suffix)
        max_new = rng.randrange(3, 11)
        room = profile.max_len - 1 - len(prompt)
        max_new = max(1, min(max_new, room))
        out.append(FleetArrival(
            arrival_s=round(arrival, 3), prompt=prompt, max_new=max_new,
            tenant=_pick(rng, tenants), prefix_rank=rank))
    return FleetWorkload(
        profile=profile, seed=seed,
        arrivals=tuple(sorted(out, key=lambda a: (a.arrival_s,
                                                  a.prompt))),
        prefixes=prefixes)


def fleet_queues(profile: FleetProfile) -> list:
    """One Queue per tenant (the Queue API's tenant routing the router
    reuses, docs/scheduling.md): tenant ``t`` lands on queue ``t``."""
    return [QueueSpec(name=t, tenants=(t,)) for t in profile.tenants]


def fleet_slos(profile: FleetProfile) -> list:
    """The fleet day's declared objective: TTFT under target for
    ``ttft_goal`` of requests over the whole day, paging on the
    multi-window pair a flash crowd can actually trip."""
    window = 4.0 * profile.sim_seconds
    return [new_slo(
        "fleet-ttft-p", "ttft_p99", profile.ttft_target_s,
        goal=profile.ttft_goal, window_s=window,
        alerting=[
            {"severity": "page", "shortSeconds": profile.page_short_s,
             "longSeconds": profile.page_long_s,
             "burn": profile.page_burn},
            {"severity": "ticket", "shortSeconds": 1800.0,
             "longSeconds": 2 * 3600.0, "burn": 1.0},
        ])]


class ServingFleetReplay:
    """One fleet-day replay. ``run()`` returns the raw observation
    dict the comparison blocks aggregate."""

    def __init__(self, workload: FleetWorkload, router: str = "prefix",
                 disaggregate: bool = False, autoscale: bool = False,
                 model=None, device=None):
        from .._device import resolve_device
        from .serving import _tiny_model
        profile = workload.profile
        self.workload = workload
        #: the card unless the caller names the CPU
        self.device = resolve_device(device)
        self.disaggregate = bool(disaggregate)
        self.autoscale = bool(autoscale)
        self.clock = SimClock()
        self.registry = Registry()
        self.tracer = Tracer(enabled=True,
                             capacity=profile.trace_capacity,
                             clock=self.clock,
                             metrics=TraceMetrics(self.registry))
        self.metrics = self._make_metrics()
        cfg, params = model if model is not None \
            else _tiny_model(self.device)
        self._model = (cfg, params)
        seed = workload.seed

        def factory(idx: int):
            from ..serving.batching import ContinuousBatchingEngine
            return ContinuousBatchingEngine(
                cfg, self._replica_params(idx), device=self.device,
                **self._engine_kwargs(idx))

        self.fleet = ServingFleet(factory, replicas=profile.replicas,
                                  metrics=self.metrics)
        router_cls = {"prefix": PrefixAwareRouter,
                      "random": RandomRouter}[router]
        kw = {"seed": seed,
              "max_prefixes": profile.max_prefixes_per_replica,
              "metrics": self.metrics}
        if router_cls is PrefixAwareRouter:
            kw["queues"] = fleet_queues(profile)
        kw.update(self._router_kwargs(router_cls))
        self.router = router_cls(self.fleet, **kw)
        self.slo = SLOEvaluator(clock=self.clock,
                                evaluate_interval_s=15.0)
        for obj in fleet_slos(profile):
            self.slo.add(obj)
        self.autoscaler = None
        if self.autoscale:
            self.autoscaler = ServingAutoscaler(
                self.fleet, slo=self.slo,
                config=AutoscalerConfig(
                    min_replicas=profile.replicas,
                    max_replicas=profile.max_replicas,
                    cooldown_s=20.0, scale_down_idle_s=120.0),
                clock=self.clock, metrics=self.metrics)
        # span-derived accumulators (the ONE ttft/queue derivation the
        # SLO engine and scorecards share, docs/slo.md)
        self._harvester = RequestSpanHarvester(prune=False)
        self.ttfts: list = []
        self.queue_waits: list = []
        self.completed = 0
        self.errors = 0
        self.tokens_out = 0
        self.shared_block_admissions = 0
        self.ticks = 0
        self.replicas_peak = profile.replicas
        #: combined-mode prefill stalls: replica name -> sim time its
        #: device frees up (the cost model; empty for disaggregated)
        self._busy_until: dict = {}

    # -- subclass seams ---------------------------------------------------

    def _make_metrics(self):
        """Subclass seam: the ServingFleetMetrics bundle (the
        multi-model replay turns the adapter families on)."""
        return ServingFleetMetrics(self.registry)

    def _engine_kwargs(self, idx: int) -> dict:
        """Subclass seam: per-replica engine kwargs — the multi-model
        replay adds the shared adapter catalog and the per-replica
        residency cap on top of these."""
        profile = self.workload.profile
        pf = profile.prefill_lanes if self.disaggregate else 0
        return dict(lanes=profile.decode_lanes + pf,
                    max_len=profile.max_len, kv_mode="paged",
                    kv_block=profile.kv_block,
                    pool_blocks=profile.pool_blocks,
                    seed=self.workload.seed + 17 * idx,
                    tracer=self.tracer, prefill_lanes=pf)

    def _replica_params(self, idx: int) -> dict:
        """Subclass seam: the weights replica ``idx`` serves. By default
        the one tree every replica shares (an engine copies nothing onto
        the device its weights already lie on, and nothing writes them);
        the RL replay gives each replica tensors of its own, since a
        publish copies new weights into the tensors a replica serves."""
        return self._model[1]

    def _router_kwargs(self, router_cls) -> dict:
        """Subclass seam: extra router kwargs (the multi-model replay's
        adapter-blind arm passes ``adapter_affinity=False``)."""
        return {}

    # -- span drain -------------------------------------------------------

    def _filter_spans(self, spans: list) -> list:
        """Subclass seam: spans to fold into the USER-facing
        accumulators (ttft/queue/completed/SLO). The RL replay diverts
        rollout-tenant request spans here — rollout TTFT is a different
        population with its own floor, and mixing it in would corrupt
        the user SLO the flywheel is required not to violate."""
        return spans

    def _fold_signals(self, spans: list) -> None:
        """Subclass seam: harvest span-derived signals into the
        accumulators and the SLO evaluator. The multi-model replay
        overrides this to label each sample with its request's model
        (``feed_traced`` + a trace→model map) so per-model objectives
        see only their own traffic."""
        for signal, value, t in self._harvester.feed(spans):
            if signal == "ttft":
                self.ttfts.append(value)
            self.slo.observe(signal, value, t)

    def _drain(self) -> None:
        spans = self.tracer.spans()
        if spans:
            self.tracer.clear()
            spans = self._filter_spans(spans)
            self._fold_signals(spans)
            for s in spans:
                if s.name == "request.queue":
                    self.queue_waits.append(s.duration)
                elif s.name == "request.prefill":
                    if s.attributes.get("sharedBlocks", 0) > 0:
                        self.shared_block_admissions += 1
                elif s.name == "serving.request":
                    self.completed += 1
                    if s.status != "ok":
                        self.errors += 1
                    self.tokens_out += int(s.attributes.get("tokens", 0))
        self.slo.maybe_evaluate(self.clock())
        if self.autoscaler is not None:
            self.autoscaler.step(self.clock())
        else:
            self.fleet.refresh_metrics()
        self.replicas_peak = max(self.replicas_peak, self.fleet.size)

    # -- the day loop -----------------------------------------------------

    def _submit_arrival(self, a, prefix):
        """Subclass seam: route + submit one arrival (the multi-model
        replay threads the arrival's model id through the router)."""
        req, _rep = self.router.submit(
            list(a.prompt), a.max_new, tenant=a.tenant, prefix=prefix)
        return req

    def _step_fleet(self) -> None:
        now = self.clock.elapsed
        for rep in list(self.fleet.replicas):
            if self._busy_until.get(rep.name, 0.0) > now + 1e-9:
                continue              # device parked mid-prefill stall
            rep.engine.step()
            if not self.disaggregate and rep.engine.prefill_tokens_step:
                # the combined device just spent this much real time on
                # chunked prefill; its decode cadence resumes after
                self._busy_until[rep.name] = now + \
                    rep.engine.prefill_tokens_step \
                    * self.workload.profile.prefill_token_s

    def run(self) -> dict:
        profile = self.workload.profile
        arrivals = self.workload.arrivals
        prefixes = self.workload.prefixes
        self.slo.evaluate(self.clock())
        requests = []
        i, n = 0, len(arrivals)
        while i < n or self.fleet.busy() or \
                any(t > self.clock.elapsed
                    for t in self._busy_until.values()):
            if i < n and not self.fleet.busy() \
                    and arrivals[i].arrival_s > self.clock.elapsed \
                    and not any(t > self.clock.elapsed
                                for t in self._busy_until.values()):
                self.clock.advance_to(arrivals[i].arrival_s + 1e-6)
            while i < n and arrivals[i].arrival_s \
                    <= self.clock.elapsed + 1e-6:
                a = arrivals[i]
                prefix = (list(prefixes[a.prefix_rank])
                          if a.prefix_rank >= 0 else None)
                requests.append(self._submit_arrival(a, prefix))
                i += 1
            self.clock.advance(profile.tick_s)
            self._step_fleet()
            self.ticks += 1
            if self.ticks % profile.drain_every == 0:
                self._drain()
        self._drain()
        if self.autoscaler is not None:
            # post-day quiet: let the autoscaler observe the idle fleet
            # long enough to drain and reap back to the floor (bounded;
            # sim time only)
            cfg = self.autoscaler.config
            deadline = self.clock.elapsed + 6 * cfg.scale_down_idle_s
            while self.clock.elapsed < deadline and (
                    len(self.fleet.active()) > cfg.min_replicas
                    or any(r.draining for r in self.fleet.replicas)):
                self.clock.advance(10.0)
                self.slo.maybe_evaluate(self.clock())
                self.autoscaler.step(self.clock())
        self.slo.evaluate(self.clock())
        self._drain()
        undone = sum(1 for r in requests if not r.done.is_set())
        dropped = sum(1 for r in requests
                      if r.done.is_set() and r.cancelled)
        return {
            "requests_submitted": len(requests),
            "requests_completed": self.completed,
            "requests_unfinished": undone,
            "dropped_streams": dropped,
            "errors": self.errors,
            "prefix_requests": sum(1 for a in arrivals
                                   if a.prefix_rank >= 0),
            "shared_prefix_admissions": self.shared_block_admissions,
            "tokens_generated": self.tokens_out,
            "engine_ticks": self.ticks,
            "sim_span_s": round(self.clock.elapsed, 1),
            "decode_tokens_per_s": round(
                self.tokens_out / max(self.clock.elapsed, 1e-9), 3),
            "ttfts_s": self.ttfts,
            "queue_waits_s": self.queue_waits,
            "router": self.router.stats(),
            "handoffs": self.fleet.reaped_handoffs + sum(
                r.engine.handoffs for r in self.fleet.replicas),
            "prefill_tokens": self.fleet.reaped_prefill_tokens + sum(
                r.engine.prefill_tokens_total
                for r in self.fleet.replicas),
            "fleet": self._fleet_block(),
            "slo": self.slo.summary(ndigits=4),
            "slo_health": self._slo_health(),
        }

    def _fleet_block(self) -> dict:
        out = {
            "replicas_start": self.workload.profile.replicas,
            "replicas_peak": self.replicas_peak,
            "replicas_end": self.fleet.size,
            "reaped": list(self.fleet.reaped),
        }
        if self.autoscaler is not None:
            st = self.autoscaler.status()
            out.update({
                "scale_ups": st["scaleUps"],
                "drains": st["drains"],
                "reaped_count": st["reaped"],
                "events": st["events"],
            })
        return out

    def _slo_health(self) -> dict:
        """Headless analog of the harness's alert-survival block."""
        fired = pages = stranded = 0
        min_budget = 1.0
        for s in self.slo.statuses():
            if "invalid" in s:
                continue
            min_budget = min(min_budget, s["budgetRemaining"])
            for severity, a in s["alerts"].items():
                fired += a["fired"]
                if severity == "page":
                    pages += a["fired"]
                if a["firing"]:
                    stranded += 1
        return {"alerts_fired": fired, "pages_fired": pages,
                "stranded_alerts": stranded,
                "min_budget_remaining": round(min_budget, 6)}


# ----------------------------------------------------------------------
# comparison legs (bench_serving_fleet.py + BENCH_CLUSTER serving.fleet)
# ----------------------------------------------------------------------

def _leg(res: dict) -> dict:
    """One run's comparison row."""
    pr = max(res["prefix_requests"], 1)
    return {
        "completed_fraction": round(
            res["requests_completed"]
            / max(res["requests_submitted"], 1), 4),
        "errors": res["errors"],
        "ttft_s": summarize(res["ttfts_s"],
                            percentiles=(0.5, 0.9, 0.99), ndigits=3),
        "queue_s": summarize(res["queue_waits_s"],
                             percentiles=(0.5, 0.99), ndigits=3),
        "decode_tokens_per_s": res["decode_tokens_per_s"],
        "tokens_generated": res["tokens_generated"],
        # the ROUTER's placement hit rate: requests landing on a
        # replica ALREADY holding their prefix blocks. (The span-side
        # shared_admission_rate below is near 1.0 for ANY router —
        # router-driven registration warms the chosen replica before
        # submit — so it measures sharing, not placement quality.)
        "prefix_hit_rate": res["router"]["prefix_hit_rate"] or 0.0,
        "shared_admission_rate": round(
            res["shared_prefix_admissions"] / pr, 4),
        "router": res["router"],
        "prefill_tokens": res["prefill_tokens"],
        "sim_span_s": res["sim_span_s"],
    }


def run_routing_comparison(seed: int = 0,
                           profile: str = "routing", device=None) -> dict:
    """Prefix-aware vs random placement on the identical workload."""
    wl = generate_fleet(profile, seed)
    aware = _leg(ServingFleetReplay(wl, router="prefix",
                                    device=device).run())
    rand = _leg(ServingFleetReplay(generate_fleet(profile, seed),
                                   router="random", device=device).run())
    ratio = (round(aware["prefix_hit_rate"] / rand["prefix_hit_rate"], 4)
             if rand["prefix_hit_rate"] else None)
    return {
        "seed": seed,
        "workload_fingerprint": wl.fingerprint(),
        "prefix_aware": aware,
        "random": rand,
        "hit_rate_ratio": ratio,
    }


def run_disagg_comparison(seed: int = 0,
                          profile: str = "disagg", device=None) -> dict:
    """Disaggregated prefill/decode vs the combined engine on a
    long-prompt-heavy mix. Same decode-lane count on both sides; the
    disaggregated replica's prefill lanes stand in for the prefill
    device a real split deployment adds."""
    wl = generate_fleet(profile, seed)
    dis_res = ServingFleetReplay(wl, router="prefix",
                                 disaggregate=True, device=device).run()
    comb_res = ServingFleetReplay(generate_fleet(profile, seed),
                                  router="prefix",
                                  disaggregate=False, device=device).run()
    dis, comb = _leg(dis_res), _leg(comb_res)
    dis["handoffs"] = dis_res["handoffs"]
    return {
        "seed": seed,
        "workload_fingerprint": wl.fingerprint(),
        "disaggregated": dis,
        "combined": comb,
        # > 1.0 = the split fleet serves first tokens faster at the tail
        "ttft_p99_ratio": round(
            comb["ttft_s"]["p99"] / dis["ttft_s"]["p99"], 4)
        if dis["ttft_s"]["p99"] else None,
        # >= 1.0 = no decode-throughput loss from reserving prefill lanes
        "decode_tokens_ratio": round(
            dis["decode_tokens_per_s"] / comb["decode_tokens_per_s"], 4)
        if comb["decode_tokens_per_s"] else None,
    }


def run_autoscaler_leg(seed: int = 0,
                       profile: str = "autoscaler", device=None) -> dict:
    """Flash crowd → page → scale-up → burn clears → drain down."""
    wl = generate_fleet(profile, seed)
    res = ServingFleetReplay(wl, router="prefix", autoscale=True,
                             device=device).run()
    leg = _leg(res)
    leg.update({
        "requests_unfinished": res["requests_unfinished"],
        "dropped_streams": res["dropped_streams"],
        "fleet": res["fleet"],
        "slo": res["slo"],
        "pages_fired": res["slo_health"]["pages_fired"],
        "stranded_alerts": res["slo_health"]["stranded_alerts"],
        "min_budget_remaining":
            res["slo_health"]["min_budget_remaining"],
    })
    leg["workload_fingerprint"] = wl.fingerprint()
    leg["seed"] = seed
    return leg


def run_fleet_comparison(seed: int = 0, device=None) -> dict:
    """All three legs — the ``serving.fleet`` block of
    BENCH_CLUSTER.json and the body of BENCH_SERVING_FLEET.json."""
    return {
        "routing": run_routing_comparison(seed, device=device),
        "disagg": run_disagg_comparison(seed, device=device),
        "autoscaler": run_autoscaler_leg(seed, device=device),
    }
