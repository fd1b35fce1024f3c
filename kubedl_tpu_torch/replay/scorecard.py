"""The fleet scorecard: one JSON every future PR must move.

``build_scorecard`` folds the two replay legs' raw observations into the
``BENCH_CLUSTER.json`` document: deterministic (no wall clocks, floats
rounded, keys sorted at serialization) so a fixed ``(profile, seed)``
reproduces it bit-for-bit. ``evaluate_gates`` applies the absolute
acceptance gates; ``check_regression`` compares a fresh scorecard
against the committed artifact so ``make bench-cluster`` fails when a PR
regresses the fleet numbers it is supposed to move.

Copied from ``kubedl_tpu/replay/scorecard.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from ..utils.stats import summarize
from .workload import Workload

#: absolute gates per profile: (path into the scorecard, op, threshold).
#: Thresholds carry headroom over the seeded baseline — they catch
#: collapses, while drift is caught by check_regression against the
#: committed artifact.
_GATES = {
    "smoke": (
        ("jobs.completed_fraction", ">=", 1.0),
        ("jobs.trace.orphan_violations", "<=", 0),
        ("jobs.slice_utilization", ">=", 0.10),
        ("jobs.fleet_goodput", ">=", 0.10),
        ("jobs.controlplane.reconciles_per_job", "<=", 120.0),
        ("serving.completed_fraction", ">=", 1.0),
        ("serving.errors", "<=", 0),
        # SLO engine (docs/slo.md): every installed objective must have
        # seen samples, and the latency objectives must end the day with
        # budget to spare (the compliance window covers the whole run,
        # so this is "the fleet met its declared SLOs")
        ("slo.objectives.fleet-goodput.samples", ">=", 1),
        ("slo.objectives.queue-delay-p99.samples", ">=", 1),
        ("slo.objectives.serving-ttft-p99.samples", ">=", 1),
        ("slo.objectives.serving-ttft-p99.budgetRemaining", ">=", 0.0),
        ("slo.objectives.queue-delay-p99.budgetRemaining", ">=", 0.0),
    ),
    "day": (
        ("jobs.completed_fraction", ">=", 1.0),
        ("jobs.trace.orphan_violations", "<=", 0),
        ("jobs.slice_utilization", ">=", 0.30),
        ("jobs.fleet_goodput", ">=", 0.20),
        ("jobs.queue_delay_s.p99", "<=", 28800.0),
        ("jobs.controlplane.reconciles_per_job", "<=", 120.0),
        ("jobs.chaos_preemptions_executed", ">=", 1),
        ("serving.completed_fraction", ">=", 1.0),
        ("serving.errors", "<=", 0),
        ("serving.ttft_s.p99", "<=", 600.0),
        ("slo.objectives.fleet-goodput.samples", ">=", 1),
        ("slo.objectives.queue-delay-p99.samples", ">=", 1),
        ("slo.objectives.restart-mttr-p50.samples", ">=", 1),
        ("slo.objectives.serving-ttft-p99.samples", ">=", 1),
        ("slo.objectives.serving-ttft-p99.budgetRemaining", ">=", 0.0),
        ("slo.objectives.serving-queue-p99.budgetRemaining", ">=", 0.0),
        ("slo.objectives.queue-delay-p99.budgetRemaining", ">=", 0.0),
        ("slo.objectives.restart-mttr-p50.budgetRemaining", ">=", 0.0),
        ("slo.objectives.fleet-goodput.budgetRemaining", ">=", 0.0),
        # concurrency-elastic leg (docs/elastic.md): the spot-shrink
        # window must shrink jobs in place (>=1 shrink AND >=1 regrow,
        # zero reconfigured-job transitions out of Running) and beat the
        # full-restart baseline on both sticks — goodput strictly
        # better, median recovery at most half the baseline's
        ("jobs.elastic.elastic.completed_fraction", ">=", 1.0),
        ("jobs.elastic.baseline.completed_fraction", ">=", 1.0),
        ("jobs.elastic.elastic.phase_violations", "<=", 0),
        ("jobs.elastic.elastic.reconfigurations.shrink", ">=", 1),
        ("jobs.elastic.elastic.reconfigurations.grow", ">=", 1),
        ("jobs.elastic.elastic.restart_rounds", "<=", 0),
        ("jobs.elastic.gains.goodput_gain", ">=", 1.02),
        ("jobs.elastic.gains.recovery_p50_ratio", "<=", 0.5),
        # serving-fleet leg (docs/serving_fleet.md), folded in
        # additively: prefix-aware routing must beat random placement
        # on hit rate, disaggregated prefill/decode must beat the
        # combined engine on tail TTFT at no decode-throughput loss,
        # and the autoscaler leg must page, scale, recover without
        # budget exhaustion, and drain without dropping a stream
        ("serving.fleet.routing.hit_rate_ratio", ">=", 1.5),
        ("serving.fleet.disagg.ttft_p99_ratio", ">=", 1.3),
        ("serving.fleet.disagg.decode_tokens_ratio", ">=", 1.0),
        ("serving.fleet.disagg.disaggregated.handoffs", ">=", 1),
        ("serving.fleet.autoscaler.pages_fired", ">=", 1),
        ("serving.fleet.autoscaler.stranded_alerts", "<=", 0),
        ("serving.fleet.autoscaler.min_budget_remaining", ">=", 0.0),
        ("serving.fleet.autoscaler.dropped_streams", "<=", 0),
        ("serving.fleet.autoscaler.requests_unfinished", "<=", 0),
        ("serving.fleet.autoscaler.fleet.scale_ups", ">=", 1),
        ("serving.fleet.autoscaler.fleet.drains", ">=", 1),
        ("serving.fleet.autoscaler.fleet.reaped_count", ">=", 1),
    ),
}

#: regression tolerances vs the committed artifact:
#: (path, direction, relative slack, absolute grace)
_REGRESSION = (
    ("jobs.slice_utilization", "higher_better", 0.05, 0.01),
    ("jobs.fleet_goodput", "higher_better", 0.05, 0.01),
    ("jobs.queue_delay_s.p99", "lower_better", 0.12, 10.0),
    ("jobs.restart_mttr_s.p99", "lower_better", 0.20, 10.0),
    ("jobs.controlplane.reconciles_per_job", "lower_better", 0.15, 1.0),
    ("jobs.scheduler.passes", "lower_better", 0.20, 50.0),
    # placement telemetry (docs/scheduling.md "Placement scoring"):
    # multi-slice gangs quietly fragmenting across ICI domains, or the
    # fleet's throughput-weighted goodput sliding toward slow pools, is
    # a placement regression even when raw utilization holds
    ("jobs.placement.ici_packed_fraction", "higher_better", 0.05, 0.02),
    ("jobs.placement.normalized_throughput_weighted_goodput",
     "higher_better", 0.05, 0.01),
    ("serving.ttft_s.p99", "lower_better", 0.12, 0.5),
    ("serving.queue_s.p99", "lower_better", 0.12, 0.5),
    # SLO columns (docs/slo.md): compliance and remaining budget must
    # not backslide past tolerance — an objective quietly burning more
    # budget than the committed day is a fleet regression even when the
    # absolute gate still passes
    ("slo.objectives.serving-ttft-p99.compliance",
     "higher_better", 0.02, 0.002),
    ("slo.objectives.serving-ttft-p99.budgetRemaining",
     "higher_better", 0.10, 0.05),
    ("slo.objectives.serving-queue-p99.budgetRemaining",
     "higher_better", 0.10, 0.05),
    ("slo.objectives.queue-delay-p99.budgetRemaining",
     "higher_better", 0.10, 0.05),
    ("slo.objectives.restart-mttr-p50.budgetRemaining",
     "higher_better", 0.10, 0.05),
    ("slo.objectives.fleet-goodput.budgetRemaining",
     "higher_better", 0.10, 0.05),
    # chaos attribution (docs/chaos.md): the injected-fault ledger vs
    # the restarts/evictions the system's own registries attribute to
    # chaos. More restarts per injected fault than the committed day is
    # a failover regression even when every job still completes.
    ("jobs.chaos.attribution.restarts_observed",
     "lower_better", 0.25, 5.0),
    ("jobs.chaos.attribution.faults_total", "lower_better", 0.25, 10.0),
    # concurrency-elastic leg (docs/elastic.md): the shrink-vs-evict
    # margin must not quietly thin — a goodput gain sliding toward 1.0
    # or the recovery ratio creeping toward the baseline is an elastic
    # regression even while the absolute gates still pass
    ("jobs.elastic.gains.goodput_gain", "higher_better", 0.05, 0.02),
    ("jobs.elastic.gains.recovery_p50_ratio", "lower_better", 0.50, 0.01),
    ("jobs.elastic.elastic.fleet_goodput", "higher_better", 0.05, 0.01),
    # serving-fleet leg (docs/serving_fleet.md): the routing and
    # disaggregation margins must not quietly thin, and the autoscaler
    # leg's surviving budget must not erode, even while the absolute
    # gates still pass
    ("serving.fleet.routing.hit_rate_ratio", "higher_better", 0.05, 0.02),
    ("serving.fleet.routing.prefix_aware.prefix_hit_rate",
     "higher_better", 0.05, 0.02),
    ("serving.fleet.disagg.ttft_p99_ratio", "higher_better", 0.10, 0.05),
    ("serving.fleet.disagg.decode_tokens_ratio",
     "higher_better", 0.02, 0.01),
    ("serving.fleet.autoscaler.min_budget_remaining",
     "higher_better", 0.10, 0.05),
)

#: adversarial-campaign gates, applied inside EVERY seed block of the
#: campaign scorecard (docs/chaos.md "SLO-survival gate"): the campaign
#: must burn — at least one page fires, gangs bleed — but the fleet must
#: survive: budgets never exhaust, every alert clears, the control plane
#: recovers to object-level parity with the fault-free reference run,
#: and the whole thing is bit-for-bit reproducible from its seed.
_CAMPAIGN_GATES = (
    ("jobs.completed_fraction", ">=", 1.0),
    ("jobs.trace.orphan_violations", "<=", 0),
    ("slo.health.pages_fired", ">=", 1),
    ("slo.health.alerts_fired", ">=", 1),
    ("slo.health.stranded_alerts", "<=", 0),
    ("slo.health.stranded_conditions", "<=", 0),
    ("slo.health.min_budget_remaining", ">=", 0.0),
    ("recovery.parity", ">=", 1),
    ("recovery.held_slices_end", "<=", 0),
    ("campaign.gangs_preempted", ">=", 4),
    ("chaos.attribution.restarts_observed", ">=", 1),
    ("deterministic", ">=", 1),
    # forensics (docs/forensics.md): every fired page must be causally
    # linked to at least one injected fault, every incident must close,
    # and the postmortem must actually cover the campaign's faults — an
    # unexplainable page means either a real unknown failure mode or a
    # broken attribution chain, both blockers
    ("forensics.summary.pages", ">=", 1),
    ("forensics.summary.pages_unlinked", "<=", 0),
    ("forensics.summary.pages_linked", ">=", 1),
    ("forensics.summary.unresolved_incidents", "<=", 0),
    ("forensics.summary.faults", ">=", 1),
)

#: per-seed regression tolerances vs the committed campaign artifact
#: (same rule grammar as _REGRESSION; paths are seed-block-relative)
_CAMPAIGN_REGRESSION = (
    ("jobs.fleet_goodput", "higher_better", 0.08, 0.02),
    ("jobs.queue_delay_s.p99", "lower_better", 0.15, 60.0),
    ("jobs.restart_mttr_s.p99", "lower_better", 0.20, 30.0),
    ("jobs.reconciles_per_job", "lower_better", 0.20, 5.0),
    ("slo.health.min_budget_remaining", "higher_better", 0.10, 0.05),
    ("slo.health.alerts_fired", "lower_better", 0.50, 2.0),
    ("chaos.attribution.restarts_observed", "lower_better", 0.25, 5.0),
    # forensics (docs/forensics.md): the attribution chain must not
    # quietly thin out — fewer causal links or fewer attributed bad
    # samples than the committed postmortem means the timeline lost
    # evidence even if the hard pages_unlinked zero still holds
    ("forensics.summary.links_total", "higher_better", 0.30, 1.0),
    ("forensics.summary.bad_samples", "higher_better", 0.30, 5.0),
)


def _get(doc: dict, path: str):
    cur = doc
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def build_scorecard(workload: Workload, cluster: dict,
                    serving: dict) -> dict:
    profile = workload.profile
    jobs = dict(cluster)
    q_delays = jobs.pop("queue_delays_s")
    mttrs = jobs.pop("restart_mttrs_s")
    jobs["completed_fraction"] = round(
        jobs["jobs_completed"] / max(jobs["jobs_submitted"], 1), 4)
    jobs["queue_delay_s"] = summarize(q_delays, percentiles=(0.5, 0.9, 0.99),
                                      ndigits=1)
    jobs["restart_mttr_s"] = summarize(mttrs, percentiles=(0.5, 0.99),
                                       ndigits=1)
    jobs["jobs_per_sim_hour"] = round(
        jobs["jobs_completed"] / (jobs["makespan_s"] / 3600.0), 2)
    # the telemetry layer's goodput decomposition at day scale: the
    # headline ratio is lifted to a first-class column so the gates and
    # the regression check can hold it like utilization
    jobs["fleet_goodput"] = (jobs.get("goodput") or {}).get(
        "fleetGoodput", 0.0)

    # SLO engine rollup (docs/slo.md): one block merging both legs'
    # objectives (names are disjoint by construction: the job-day set
    # vs the serving-* set)
    slo_objectives = {**(jobs.pop("slo", None) or {})}

    srv = dict(serving)
    slo_objectives.update(srv.pop("slo", None) or {})
    q_waits = srv.pop("queue_waits_s")
    ttfts = srv.pop("ttfts_s")
    srv["completed_fraction"] = round(
        srv["requests_completed"] / max(srv["requests_submitted"], 1), 4)
    srv["queue_s"] = summarize(q_waits, percentiles=(0.5, 0.9, 0.99),
                               ndigits=3)
    srv["ttft_s"] = summarize(ttfts, percentiles=(0.5, 0.9, 0.99),
                              ndigits=3)

    return {
        "benchmark": "cluster_trace_replay",
        "profile": profile.name,
        "seed": workload.seed,
        "workload_fingerprint": workload.fingerprint(),
        "workload": {
            "sim_day_s": profile.sim_seconds,
            "jobs": len(workload.jobs),
            "chaos_preemptions_planned": len(workload.preemptions),
            "serving_requests": len(workload.serving),
            "capacity_slices": dict(profile.capacity),
            "queues": sorted({j.queue for j in workload.jobs}),
        },
        "jobs": jobs,
        "serving": srv,
        "slo": {"objectives": {k: slo_objectives[k]
                               for k in sorted(slo_objectives)}},
    }


def evaluate_gates(scorecard: dict,
                   profile_name: Optional[str] = None) -> dict:
    """Apply the profile's absolute gates; returns the gate table with
    an overall ``passed``. The table is embedded into the scorecard (it
    is deterministic too)."""
    name = profile_name or scorecard.get("profile", "day")
    results = []
    ok = True
    for path, op, threshold in _GATES.get(name, ()):
        value = _get(scorecard, path)
        passed = (value is not None
                  and (value >= threshold if op == ">=" else
                       value <= threshold))
        ok = ok and passed
        results.append({"metric": path, "op": op, "threshold": threshold,
                        "value": value, "passed": passed})
    return {"checks": results, "passed": ok}


def check_tolerances(new: dict, old: dict, rules) -> list:
    """The ONE per-metric tolerance engine: compare ``new`` against the
    committed ``old`` under ``rules`` — tuples of (dotted path,
    "higher_better"|"lower_better", relative slack, absolute grace).
    Metrics absent from either side are skipped, so a freshly-added rule
    only bites once both artifacts know the metric. Shared by the
    cluster scorecard and ``bench_scheduler.py``'s regression gate."""
    problems = []
    for path, direction, rel, grace in rules:
        ov, nv = _get(old, path), _get(new, path)
        if ov is None or nv is None:
            continue
        if direction == "higher_better":
            floor = ov * (1.0 - rel) - grace
            if nv < floor:
                problems.append(
                    f"{path}: {nv} < {round(floor, 4)} "
                    f"(committed {ov}, tolerance -{rel * 100:g}%)")
        else:
            ceil = ov * (1.0 + rel) + grace
            if nv > ceil:
                problems.append(
                    f"{path}: {nv} > {round(ceil, 4)} "
                    f"(committed {ov}, tolerance +{rel * 100:g}%)")
    return problems


def build_campaign_scorecard(scenario: str, legs: list) -> dict:
    """Fold the adversarial legs into the committed campaign scorecard
    (``BENCH_CLUSTER_ADVERSARIAL.json``, docs/chaos.md). Each leg is one
    seed's run set::

        {"workload": Workload, "result": campaign-run observations,
         "state": campaign-run control_plane_state(),
         "reference": fault-free same-workload observations,
         "reference_state": its control_plane_state(),
         "deterministic": repeat-run JSON equality (bool)}

    Deterministic like :func:`build_scorecard`: floats arrive rounded
    from the replay, keys sort at serialization, no wall clocks."""
    profile = legs[0]["workload"].profile
    seeds = {}
    for leg in legs:
        wl, res = leg["workload"], leg["result"]
        state, ref_state = leg["state"], leg["reference_state"]
        ref = leg["reference"]
        seeds[str(wl.seed)] = {
            "workload_fingerprint": wl.fingerprint(),
            "campaign": res["campaign"],
            "jobs": {
                "completed_fraction": round(
                    res["jobs_completed"]
                    / max(res["jobs_submitted"], 1), 4),
                "makespan_s": res["makespan_s"],
                "fleet_goodput": (res.get("goodput") or {}).get(
                    "fleetGoodput", 0.0),
                "queue_delay_s": summarize(
                    res["queue_delays_s"],
                    percentiles=(0.5, 0.9, 0.99), ndigits=1),
                "restart_mttr_s": summarize(
                    res["restart_mttrs_s"],
                    percentiles=(0.5, 0.99), ndigits=1),
                "reconciles_per_job":
                    res["controlplane"]["reconciles_per_job"],
                "trace": {"orphan_violations":
                          res["trace"]["orphan_violations"]},
            },
            "slo": {"objectives": res["slo"],
                    "health": res["slo_health"]},
            "chaos": res["chaos"],
            # the campaign postmortem (docs/forensics.md): rendered to
            # markdown by `make postmortem`; its summary rows are gated
            # and regression-checked like every other block
            "forensics": res.get("forensics") or {},
            "recovery": {
                # 1/0, not true/false: the gate table compares with >=
                "parity": int(state["digest"] == ref_state["digest"]),
                "objects": state["objects"],
                "digest": state["digest"],
                "held_slices_end": state["held_slices"],
                "reference_digest": ref_state["digest"],
                "reference_completed_fraction": round(
                    ref["jobs_completed"]
                    / max(ref["jobs_submitted"], 1), 4),
                "reference_makespan_s": ref["makespan_s"],
            },
            "deterministic": int(bool(leg["deterministic"])),
        }
    return {
        "benchmark": "cluster_chaos_campaign",
        "profile": profile.name,
        "scenario": scenario,
        "workload": {
            "sim_day_s": profile.sim_seconds,
            "jobs": profile.jobs,
            "capacity_slices": dict(profile.capacity),
        },
        "seeds": {k: seeds[k] for k in sorted(seeds)},
    }


def evaluate_campaign_gates(scorecard: dict) -> dict:
    """Apply :data:`_CAMPAIGN_GATES` inside every seed block; same
    result shape as :func:`evaluate_gates` (the table is embedded into
    the committed artifact)."""
    results = []
    ok = True
    seeds = scorecard.get("seeds") or {}
    for seed in sorted(seeds):
        for path, op, threshold in _CAMPAIGN_GATES:
            full = f"seeds.{seed}.{path}"
            value = _get(scorecard, full)
            passed = (value is not None
                      and (value >= threshold if op == ">=" else
                           value <= threshold))
            ok = ok and passed
            results.append({"metric": full, "op": op,
                            "threshold": threshold, "value": value,
                            "passed": passed})
    if not seeds:
        ok = False
        results.append({"metric": "seeds", "op": ">=", "threshold": 2,
                        "value": 0, "passed": False})
    return {"checks": results, "passed": ok}


def check_campaign_regression(new: dict, old: dict) -> list:
    """Per-seed regression check vs the committed campaign artifact,
    riding the shared :func:`check_tolerances` engine. Only seeds
    present in BOTH artifacts are compared; scenario or profile drift is
    a new baseline, not a regression."""
    if old.get("profile") != new.get("profile") \
            or old.get("scenario") != new.get("scenario"):
        return []
    problems = []
    shared = sorted(set(new.get("seeds") or ())
                    & set(old.get("seeds") or ()))
    for seed in shared:
        rules = [(f"seeds.{seed}.{path}", direction, rel, grace)
                 for path, direction, rel, grace in _CAMPAIGN_REGRESSION]
        problems.extend(check_tolerances(new, old, rules))
        for path in ("slo.health.stranded_alerts",
                     "slo.health.stranded_conditions",
                     "forensics.summary.pages_unlinked",
                     "forensics.summary.unresolved_incidents",
                     "jobs.trace.orphan_violations"):
            if _get(new, f"seeds.{seed}.{path}"):
                problems.append(f"seeds.{seed}.{path} must stay 0")
        if _get(new, f"seeds.{seed}.recovery.parity") != 1:
            problems.append(
                f"seeds.{seed}.recovery.parity must stay 1 (campaign "
                f"run must converge to the fault-free reference world)")
    return problems


def check_regression(new: dict, old: dict) -> list:
    """Compare a fresh scorecard against the committed artifact.
    Returns a list of human-readable regression strings (empty = pass).
    Only applies when profile and seed match — a re-scaled run is a new
    baseline, not a regression."""
    if old.get("profile") != new.get("profile") \
            or old.get("seed") != new.get("seed"):
        return []
    problems = check_tolerances(new, old, _REGRESSION)
    if _get(new, "jobs.trace.orphan_violations"):
        problems.append("jobs.trace.orphan_violations must stay 0")
    return problems
