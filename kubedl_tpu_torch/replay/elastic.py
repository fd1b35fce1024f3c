"""The concurrency-elastic comparison leg (docs/elastic.md).

One seed, one workload, one ``spot-shrink`` campaign script, two runs
through the REAL stack:

* **elastic** — ``ClusterReplay(elastic=True)``: the spot pool's
  capacity halves mid-day; the scheduler's shrink pass sheds surplus
  slices from elastic gangs in place, the engine drives restart-free
  reconfigurations through the 2-phase checkpoint protocol, and
  returning capacity regrows the shrunk gangs;
* **baseline** — the identical workload and capacity drop with the gate
  off: every holder of the shrinking pool is swept whole-gang (the
  pre-elastic response to spot dryness) and rides slice-atomic failover.

The block the scorecard embeds (``jobs.elastic`` in BENCH_CLUSTER.json,
and per-seed in BENCH_ELASTIC.json) is derived entirely from the two
runs' own observability — goodput decompositions, trace-derived recovery
samples, the kubedl_elastic_* registries — and is deterministic for a
fixed seed like every other replay product.

Copied from ``kubedl_tpu/replay/elastic.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import random

from ..chaos import build_campaign
from ..utils.stats import summarize
from .harness import ClusterReplay
from .workload import (POOL_V5E, POOL_V5P, JobArrival, Workload,
                       generate)

#: the campaign script both legs share (same times, same capacity floor)
ELASTIC_SCENARIO = "spot-shrink"


def elastic_workload(seed: int, profile: str = "elastic") -> Workload:
    """The comparison leg's job day: the ``elastic`` profile with a
    purpose-built job mix — multi-slice gangs dominating the spot pool,
    arrivals early enough that the fleet is running when the
    ``spot-shrink`` window halves capacity. Pure function of ``seed``
    (its own namespaced rng stream), fingerprinted like every workload,
    so both legs replay the identical day bit for bit.

    The generic day generator is 82% single-slice; a comparison run on
    it measures mostly jobs that CANNOT shrink. This mix measures the
    claimed mechanism: elastic gangs shedding surplus width in place
    versus the same gangs being evicted whole."""
    base = generate(profile, seed)
    rng = random.Random(f"{seed}:elastic-jobs")
    day = base.profile.sim_seconds
    jobs = []
    for i in range(16):
        slices = 4 if rng.random() < 0.40 else 2
        pool = POOL_V5E if rng.random() < 0.75 else POOL_V5P
        dur = rng.uniform(2600.0, 4200.0)
        arrival = rng.uniform(0.02, 0.30) * day
        jobs.append(JobArrival(
            arrival_s=round(arrival, 3), name=f"el-{i:03d}",
            queue="best", pool=pool, num_slices=slices,
            duration_s=round(dur, 1)))
    return dataclasses.replace(
        base, jobs=tuple(sorted(jobs,
                                key=lambda j: (j.arrival_s, j.name))),
        preemptions=())


def _leg(res: dict) -> dict:
    """One run's comparison row, from its own result dict."""
    return {
        "completed_fraction": round(
            res["jobs_completed"] / max(res["jobs_submitted"], 1), 4),
        "fleet_goodput": (res.get("goodput") or {}).get(
            "fleetGoodput", 0.0),
        "reconfiguration_s": (res.get("goodput") or {}).get(
            "overheadSeconds", {}).get("reconfiguration", 0.0),
        "restart_s": (res.get("goodput") or {}).get(
            "overheadSeconds", {}).get("restart", 0.0),
        "restart_rounds": res["restart_rounds_traced"],
        "recovery_s": summarize(res["restart_mttrs_s"],
                                percentiles=(0.5, 0.99), ndigits=1),
        "makespan_s": res["makespan_s"],
        "queue_delay_p99_s": summarize(
            res["queue_delays_s"], percentiles=(0.99,),
            ndigits=1).get("p99"),
    }


def build_elastic_block(workload, campaign, elastic_res: dict,
                        baseline_res: dict) -> dict:
    """Fold the two runs into the committed comparison block."""
    e, b = _leg(elastic_res), _leg(baseline_res)
    e_p50 = (e["recovery_s"] or {}).get("p50") or 0.0
    b_p50 = (b["recovery_s"] or {}).get("p50") or 0.0
    gains = {
        # > 1.0 = the elastic leg kept more of the fleet's wall-clock
        # productive through the same capacity drop
        "goodput_gain": round(e["fleet_goodput"] / b["fleet_goodput"], 4)
        if b["fleet_goodput"] > 0 else None,
        # < 1.0 = a median recovery (reconfiguration window vs restart
        # round) resolves faster than the full-restart baseline's
        "recovery_p50_ratio": round(e_p50 / b_p50, 4)
        if b_p50 > 0 else None,
        "restart_rounds_avoided":
            b["restart_rounds"] - e["restart_rounds"],
    }
    return {
        "scenario": campaign.scenario,
        "seed": workload.seed,
        "workload_fingerprint": workload.fingerprint(),
        "campaign_fingerprint": campaign.fingerprint(),
        "elastic": {**e, **(elastic_res.get("elastic") or {})},
        "baseline": b,
        "gains": gains,
    }


def run_elastic_comparison(seed: int = 0,
                           profile: str = "elastic") -> dict:
    """Run both legs for one seed and return the comparison block."""
    workload = elastic_workload(seed, profile)
    campaign = build_campaign(ELASTIC_SCENARIO, seed, workload.profile)
    elastic_res = ClusterReplay(workload, campaign=campaign,
                                elastic=True).run()
    baseline_res = ClusterReplay(
        elastic_workload(seed, profile),
        campaign=build_campaign(ELASTIC_SCENARIO, seed,
                                workload.profile)).run()
    return build_elastic_block(workload, campaign, elastic_res,
                               baseline_res)
