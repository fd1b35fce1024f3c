"""Multi-model fleet replay: a Zipf adapter catalog over the fleet day.

The multi-model sibling of :mod:`replay/fleet
<kubedl_tpu_torch.replay.fleet>` (docs/multimodel.md): the same seeded
request day, with each request optionally carrying an adapter id drawn
Zipf over a ~30-model catalog. A REAL :class:`AdapterCatalog` is
shared by every replica; each engine pages adapter weights through its
own refcounted pool; the :class:`PrefixAwareRouter`'s adapter affinity
(or its absence — the adapter-BLIND comparison arm) decides where each
model's requests land. Per-model SLO objectives ride the ``model``
label on harvested samples (``RequestSpanHarvester.feed_traced`` + a
trace→model map), so every model gets its own TTFT compliance column.

**The adapter-fault cost model** (the one quantity this replay adds to
the fleet replay's prefill model): a cold adapter fault-in of ``P``
weight pages parks the replica's device for
``P * adapter_fault_page_s`` simulated seconds — loading LoRA weights
into HBM stalls the decode cadence exactly like a chunked prefill
does. Token outputs are identical across arms (greedy decoding; the
residency layer is host-side accounting) — the model only moves
*time*, which is what keeps both arms bit-for-bit deterministic.

These dataclasses deliberately do NOT extend ``FleetProfile`` /
``FleetArrival`` with new serialized fields in place — the committed
BENCH_SERVING_FLEET.json embeds ``asdict`` of those, and the gate-off
byte-identity contract forbids growing them. The subclasses here own
their extra fields; only this replay serializes them.

Copied from ``kubedl_tpu/replay/multimodel.py`` (the port imports nothing
of the JAX package), statement for statement, with one addition:
``MultiModelReplay`` and ``run_multimodel_comparison`` take ``device=``
(the card unless the caller names the CPU), handed to every replica's
engine as the port's ``ServingFleetReplay`` does, and
``run_multimodel_comparison`` takes ``model=`` (``(config, params)``, by
default the replays' tiny model), as ``FlywheelReplay`` does.
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import asdict, dataclass

from ..api.slo import new_slo
from ..metrics.registry import ServingFleetMetrics
from ..serving.adapters import AdapterCatalog, AdapterSpec
from ..serving.router import PrefixAwareRouter
from ..utils.stats import summarize
from .fleet import FleetProfile, ServingFleetReplay, generate_fleet
from .workload import _burst_windows, _pick, _zipf_weights


@dataclass(frozen=True)
class MultiModelProfile(FleetProfile):
    """The fleet profile plus the adapter catalog's shape."""
    #: catalog size (the ~30-adapter day the bench gates on)
    adapters: int = 30
    #: pool blocks one adapter's LoRA weights pin while resident
    adapter_pages: int = 2
    #: Zipf exponent over adapter ranks (lower = flatter — the regime
    #: where per-replica residency caps actually bind)
    adapter_zipf_s: float = 1.0
    #: fraction of requests carrying an adapter id ("" = base model)
    adapter_share: float = 0.75
    #: per-replica resident-adapter cap (engine ``max_adapters``)
    max_adapters_per_replica: int = 12
    #: sim seconds one weight page costs to fault in (the cost model)
    adapter_fault_page_s: float = 0.03


MULTIMODEL_PROFILES = {
    # the committed multi-model day (BENCH_MULTIMODEL.json): 30
    # adapters at 2 pages over three 128-block pools with a 12-adapter
    # residency cap per replica — adapter-affine routing partitions the
    # catalog (each home replica's slice fits its cap), blind routing
    # makes every replica churn through all 30 and the LRU cap binds
    "multimodel": MultiModelProfile(
        name="multimodel", sim_seconds=1800.0, requests=1600, bursts=24,
        replicas=3, max_replicas=3, decode_lanes=8, pool_blocks=128,
        prefixes=12, prefix_share=0.5, zipf_s=0.8,
        max_prefixes_per_replica=6,
        adapters=30, adapter_pages=2, adapter_zipf_s=1.0,
        adapter_share=0.75, max_adapters_per_replica=12,
        adapter_fault_page_s=0.03),
}


@dataclass(frozen=True)
class MultiModelArrival:
    arrival_s: float
    prompt: tuple
    max_new: int
    tenant: str
    prefix_rank: int              # -1 = no shared prefix
    model: str = ""               # "" = base model


@dataclass(frozen=True)
class MultiModelWorkload:
    profile: MultiModelProfile
    seed: int
    arrivals: tuple               # MultiModelArrival, arrival-sorted
    prefixes: tuple               # token tuples, rank order
    models: tuple                 # adapter ids, rank order

    def fingerprint(self) -> str:
        doc = {"profile": asdict(self.profile), "seed": self.seed,
               "arrivals": [asdict(a) for a in self.arrivals],
               "prefixes": [list(p) for p in self.prefixes],
               "models": list(self.models)}
        blob = json.dumps(doc, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


def generate_multimodel(profile: MultiModelProfile | str,
                        seed: int = 0) -> MultiModelWorkload:
    """The multi-model request day, reproducibly (namespaced rng
    streams only, exactly like :func:`replay.fleet.generate_fleet`)."""
    if isinstance(profile, str):
        profile = MULTIMODEL_PROFILES[profile]
    rng = random.Random(f"{seed}:multimodel:{profile.name}")
    day = profile.sim_seconds
    models = tuple(f"m{i:02d}" for i in range(profile.adapters))
    prefixes = tuple(
        tuple(rng.randrange(1, 127)
              for _ in range(rng.randrange(20, 33)))
        for _ in range(profile.prefixes))
    zipf = list(zip(range(profile.prefixes),
                    _zipf_weights(profile.prefixes, s=profile.zipf_s)))
    mzipf = list(zip(range(profile.adapters),
                     _zipf_weights(profile.adapters,
                                   s=profile.adapter_zipf_s)))
    tenants = list(zip(profile.tenants, profile.tenant_weights))
    bursts = _burst_windows(rng, profile.bursts, day, 2.0, 15.0)
    out = []
    modeled = 0
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
        suffix = [rng.randrange(1, 127)
                  for _ in range(rng.randrange(3, 13))]
        prompt = tuple(body + suffix)
        max_new = rng.randrange(3, 11)
        max_new = max(1, min(max_new,
                             profile.max_len - 1 - len(prompt)))
        if rng.random() < profile.adapter_share:
            ridx = _pick(rng, mzipf)
            if modeled < profile.adapters:
                # coverage floor: the first |catalog| model-bearing
                # requests round-robin the catalog, so EVERY model's
                # compliance column has at least one sample (the bench
                # gates on all of them reporting)
                ridx = modeled % profile.adapters
            model = models[ridx]
            modeled += 1
        else:
            model = ""
        out.append(MultiModelArrival(
            arrival_s=round(arrival, 3), prompt=prompt, max_new=max_new,
            tenant=_pick(rng, tenants), prefix_rank=rank, model=model))
    return MultiModelWorkload(
        profile=profile, seed=seed,
        arrivals=tuple(sorted(out, key=lambda a: (a.arrival_s,
                                                  a.prompt))),
        prefixes=prefixes, models=models)


def catalog_for(workload: MultiModelWorkload) -> AdapterCatalog:
    """The fleet-wide catalog the workload's models register into."""
    cat = AdapterCatalog()
    for m in workload.models:
        cat.register(AdapterSpec(model=m,
                                 pages=workload.profile.adapter_pages))
    return cat


def multimodel_slos(workload: MultiModelWorkload) -> list:
    """One TTFT objective PER MODEL on top of the fleet-wide one the
    base replay registers: each selects on its ``model`` label, so a
    model's compliance column reflects only its own traffic
    (docs/multimodel.md "per-model SLOs")."""
    profile = workload.profile
    window = 4.0 * profile.sim_seconds
    return [new_slo(
        f"ttft-{m}", "ttft_p99", profile.ttft_target_s,
        goal=profile.ttft_goal, window_s=window,
        selector={"model": m},
        alerting=[
            {"severity": "page", "shortSeconds": profile.page_short_s,
             "longSeconds": profile.page_long_s,
             "burn": profile.page_burn},
        ]) for m in workload.models]


class MultiModelReplay(ServingFleetReplay):
    """One multi-model fleet day. ``adapter_affinity=False`` is the
    adapter-BLIND comparison arm: the model id still rides to the
    engine (admission faults adapters in either way), but placement
    ignores residency — the fleet pays the thrash the affine router
    avoids."""

    def __init__(self, workload: MultiModelWorkload,
                 adapter_affinity: bool = True, model=None, device=None):
        # set before super().__init__: the engine factory and router
        # construction inside it read these through the seams
        self._affinity = bool(adapter_affinity)
        self.catalog = catalog_for(workload)
        self._trace_model: dict = {}
        self._model_ttfts: dict = {}
        super().__init__(workload, router="prefix", model=model,
                         device=device)
        for obj in multimodel_slos(workload):
            self.slo.add(obj)

    # -- seams -------------------------------------------------------------

    def _make_metrics(self):
        return ServingFleetMetrics(self.registry, multi_model=True)

    def _engine_kwargs(self, idx: int) -> dict:
        kw = super()._engine_kwargs(idx)
        kw.update(adapters=self.catalog,
                  max_adapters=self.workload.profile
                  .max_adapters_per_replica)
        return kw

    def _router_kwargs(self, router_cls) -> dict:
        if router_cls is PrefixAwareRouter:
            return {"adapter_affinity": self._affinity}
        return {}

    def _submit_arrival(self, a, prefix):
        req, _rep = self.router.submit(
            list(a.prompt), a.max_new, tenant=a.tenant, prefix=prefix,
            model=a.model or None)
        if a.model and req.trace_id:
            self._trace_model[req.trace_id] = a.model
        return req

    def _fold_signals(self, spans: list) -> None:
        # the traced feed: identical samples, plus the trace id that
        # keys the model attribution — per-model objectives see only
        # their own traffic, the fleet-wide one still sees everything
        # (an empty selector matches any labels)
        for signal, value, t, trace in self._harvester.feed_traced(
                spans):
            model = self._trace_model.get(trace, "")
            if signal == "ttft":
                self.ttfts.append(value)
                self._model_ttfts.setdefault(model, []).append(value)
            self.slo.observe(signal, value, t,
                             labels={"model": model} if model else None)

    def _step_fleet(self) -> None:
        now = self.clock.elapsed
        profile = self.workload.profile
        for rep in list(self.fleet.replicas):
            if self._busy_until.get(rep.name, 0.0) > now + 1e-9:
                continue
            rep.engine.step()
            stall = 0.0
            if not self.disaggregate and rep.engine.prefill_tokens_step:
                stall += rep.engine.prefill_tokens_step \
                    * profile.prefill_token_s
            if rep.engine.adapter_fault_pages_step:
                # the cost model: faulted weight pages park this
                # replica's device like a chunked prefill does
                stall += rep.engine.adapter_fault_pages_step \
                    * profile.adapter_fault_page_s
            if stall:
                self._busy_until[rep.name] = now + stall

    # -- the day ------------------------------------------------------------

    def run(self) -> dict:
        res = super().run()
        res["multi_model"] = self._multi_model_block(res)
        return res

    def _multi_model_block(self, res: dict) -> dict:
        profile = self.workload.profile
        statuses = {r.name: r.engine.adapter_status()
                    for r in self.fleet.replicas}
        faults = self.fleet.reaped_adapter_faults + sum(
            sum(st["faults"].values()) for st in statuses.values())
        evictions = sum(st["evictions"] for st in statuses.values())
        peak_pages = sum(st["peak_pages"] for st in statuses.values())
        model_requests = sum(1 for a in self.workload.arrivals
                             if a.model)
        slo = res["slo"]
        per_model = {}
        for m in self.workload.models:
            col = slo.get(f"ttft-{m}") or {}
            per_model[m] = {
                "requests": sum(1 for a in self.workload.arrivals
                                if a.model == m),
                "ttft_s": summarize(self._model_ttfts.get(m, []),
                                    percentiles=(0.5, 0.99), ndigits=3),
                "slo_compliance": col.get("compliance"),
                "slo_samples": col.get("samples", 0),
            }
        model_ttfts = [v for m, vals in self._model_ttfts.items()
                       if m for v in vals]
        return {
            "models": len(self.workload.models),
            # every model's compliance column observed at least one
            # sample (the bench gates on all of them reporting)
            "models_reported": sum(
                1 for v in per_model.values() if v["slo_samples"]),
            "model_requests": model_requests,
            "adapter_faults": faults,
            "fault_rate": round(faults / max(model_requests, 1), 4),
            "adapter_evictions": evictions,
            "model_ttft_s": summarize(model_ttfts,
                                      percentiles=(0.5, 0.99),
                                      ndigits=3),
            "hbm": {
                "pool_blocks_per_replica": profile.pool_blocks,
                "replicas": len(statuses),
                "budget_blocks": profile.pool_blocks * len(statuses),
                "adapter_page_cap": profile.max_adapters_per_replica
                * profile.adapter_pages * len(statuses),
                "peak_adapter_pages": peak_pages,
                "within_cap": int(
                    peak_pages <= profile.max_adapters_per_replica
                    * profile.adapter_pages * len(statuses)),
            },
            "per_replica": statuses,
            "per_model": per_model,
        }


def run_multimodel_comparison(seed: int = 0,
                              profile: str = "multimodel", model=None,
                              device=None) -> dict:
    """Adapter-aware vs adapter-blind routing on the identical
    multi-model day (the body of BENCH_MULTIMODEL.json)."""
    wl = generate_multimodel(profile, seed)
    aware_res = MultiModelReplay(wl, adapter_affinity=True, model=model,
                                 device=device).run()
    blind_res = MultiModelReplay(generate_multimodel(profile, seed),
                                 adapter_affinity=False, model=model,
                                 device=device).run()
    aware, blind = _mm_leg(aware_res), _mm_leg(blind_res)
    a_mm, b_mm = aware["multi_model"], blind["multi_model"]
    return {
        "seed": seed,
        "workload_fingerprint": wl.fingerprint(),
        "adapter_aware": aware,
        "adapter_blind": blind,
        # > 1.0 = affinity faults fewer adapters per model request
        "fault_rate_ratio": round(
            b_mm["fault_rate"] / a_mm["fault_rate"], 4)
        if a_mm["fault_rate"] else None,
        # > 1.0 = affinity serves model traffic's first tokens faster
        # at the tail
        "model_ttft_p99_ratio": round(
            blind["multi_model"]["model_ttft_s"]["p99"]
            / aware["multi_model"]["model_ttft_s"]["p99"], 4)
        if aware["multi_model"]["model_ttft_s"]["p99"] else None,
    }


def _mm_leg(res: dict) -> dict:
    """One arm's comparison row (the fleet `_leg` shape + the
    multi-model block)."""
    from .fleet import _leg
    leg = _leg(res)
    leg["requests_unfinished"] = res["requests_unfinished"]
    leg["dropped_streams"] = res["dropped_streams"]
    leg["multi_model"] = res["multi_model"]
    leg["slo"] = res["slo"]
    return leg
