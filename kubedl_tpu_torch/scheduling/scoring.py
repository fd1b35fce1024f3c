"""Placement scoring: throughput-, contention-, and cost-aware pool choice.

The Gavel insight (PAPERS.md, arxiv 2008.09213) applied to the slice
scheduler: pools are not interchangeable slice counts. Every eligible
pool of a gang is scored

    score(pool) = normalized_throughput / (contention_penalty × cost)

* **normalized throughput** — the gang's profile key (job kind or model,
  stamped on its PodGroups) looked up in the live
  :class:`~kubedl_tpu_torch.telemetry.profiles.ThroughputProfileStore`;
  pools with no learned estimate yet fall back to static per-generation
  seeds, calibrated against whatever the store HAS learned for the key
  so a half-learned profile compares apples to apples. Normalized to the
  best candidate (best = 1.0, the Gavel currency).
* **contention penalty** — grows with ICI-domain fragmentation: the
  inventory previews where a new gang of this size would land
  (:meth:`SliceInventory.placement_spans`) and every domain past the
  first costs ``contention_alpha`` (arxiv 2207.07817: ring-collective
  jobs degrade with cross-domain hops).
* **cost** — the pool's ``$/chip-hour``
  (:meth:`SliceInventory.economics`: Node labels or ``--pool-cost``)
  times the slice's chip count, so a cheap spot pool wins the tie and a
  premium pool must earn it in throughput.

Pure reads — scoring never writes; the scheduler applies the ranking and
the explainer replays it verbatim (`telemetry/explainer.py`).

Copied from ``kubedl_tpu/scheduling/scoring.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from ..tpu import topology

#: static per-generation throughput seeds (tokens/s per chip, relative
#: units): the scheduler's prior before any ThroughputProfile exists.
#: Shaped from the public per-chip peak-compute ratios across
#: generations — only the ORDER and rough ratios matter (profiles take
#: over as soon as the fleet observes real steps).
GENERATION_SEED_TPS_PER_CHIP = {
    "v2": 0.06, "v3": 0.12, "v4": 0.45,
    "v5e": 0.35, "v5p": 1.0, "v6e": 0.9,
}


def seed_rate(pool: str) -> float:
    """Static throughput seed for a pool (tokens/s, relative units):
    per-chip generation seed × slice chip count. Unknown shapes score a
    neutral 1.0 so they neither win nor lose on the seed alone."""
    gen = topology.pool_generation(pool)
    chips = topology.pool_slice_chips(pool)
    if gen is None or chips is None:
        return 1.0
    return GENERATION_SEED_TPS_PER_CHIP.get(gen.name, 0.5) * chips


class PlacementScorer:
    """Ranks a gang's eligible pools. Stateless between calls except for
    the injected inventory/profile references."""

    def __init__(self, inventory, profiles=None,
                 contention_alpha: float = 0.5):
        self.inventory = inventory
        #: the live ThroughputProfileStore (None = seeds only)
        self.profiles = profiles
        #: penalty per ICI domain past the first a gang would straddle
        self.contention_alpha = float(contention_alpha)

    # -- throughput -------------------------------------------------------

    def rates(self, key: str, pools: list) -> dict:
        """tokens/s estimate per candidate pool: learned profile values
        where they exist, seeds calibrated to the learned scale
        elsewhere (a profile that knows one pool must not make every
        unknown pool look 40x slower just because seeds are relative)."""
        learned: dict = {}
        if self.profiles is not None and key:
            for pool in pools:
                est = self.profiles.estimate(key, pool)
                if est is not None and est > 0:
                    learned[pool] = est
        scale = 1.0
        if learned:
            ratios = [v / max(seed_rate(p), 1e-9)
                      for p, v in learned.items()]
            scale = sum(ratios) / len(ratios)
        return {p: learned.get(p, seed_rate(p) * scale) for p in pools}

    # -- the ranking ------------------------------------------------------

    def rank(self, key: str, pools: list, demand: int,
             region=None) -> list:
        """Score every candidate pool for a ``demand``-slice gang;
        returns score rows sorted best-first (ties: candidate order, so
        the routed primary pool wins a dead heat). Pure read.

        ``region`` is the federation layer's per-region cost context
        (``federation/topology.RegionCost``, docs/federation.md): any
        object with ``name`` / ``latency_ms`` / ``egress_per_gb`` /
        ``factor``. When present, the factor divides the score — data
        gravity and wire distance price a far region down exactly like
        an expensive pool — and the rows carry the region terms so the
        pending-job explainer can name them. When absent (every
        single-cluster caller), the rows and scores are byte-identical
        to before the federation layer existed."""
        rates = self.rates(key, pools)
        best = max(rates.values(), default=0.0)
        rows = []
        for order, pool in enumerate(pools):
            spans = self.inventory.placement_spans(pool, demand)
            penalty = 1.0 if spans is None \
                else 1.0 + self.contention_alpha * (spans - 1)
            econ = self.inventory.economics(pool)
            chips = topology.pool_slice_chips(pool) or 1
            cost = max(econ.cost_per_chip_hour, 1e-9) * chips
            norm = rates[pool] / best if best > 0 else 0.0
            row = {
                "pool": pool,
                "tokensPerSecond": round(rates[pool], 4),
                "normalizedThroughput": round(norm, 4),
                "spansDomains": spans,
                "contentionPenalty": round(penalty, 4),
                "costPerSliceHour": round(cost, 4),
                "spot": econ.spot,
                "score": round(norm / (penalty * cost), 6),
                "_order": order,
            }
            if region is not None:
                rfac = max(float(region.factor), 1e-9)
                row["region"] = region.name
                row["regionLatencyMs"] = round(
                    float(region.latency_ms), 4)
                row["regionEgressPerGB"] = round(
                    float(region.egress_per_gb), 4)
                row["regionFactor"] = round(rfac, 6)
                row["score"] = round(norm / (penalty * cost * rfac), 6)
            rows.append(row)
        rows.sort(key=lambda r: (-r["score"], r["_order"]))
        for r in rows:
            del r["_order"]
        return rows
