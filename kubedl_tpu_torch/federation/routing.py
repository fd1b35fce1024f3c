"""Global queue routing: jobs land in the region whose pools score best.

The federation half of placement scoring (docs/federation.md "Routing
score terms"): each region contributes its own
:class:`~kubedl_tpu_torch.scheduling.scoring.PlacementScorer` ranking —
normalized throughput over contention × cost — and the global router
divides every row by the region's :class:`~kubedl_tpu_torch.federation
.topology.RegionCost` factor (wire latency + egress pricing from the
static topology). The best row across all live regions wins; the
pending-job explainer document names the chosen region AND the
runner-up, because "why didn't my job land near its data" is the first
question a multi-region operator asks.

Pure reads over the regions' scorers; the federation driver applies the
decision (``region.inject_job``) and records it here so the console's
``/api/v1/federation/status`` can replay every decision verbatim.

Copied from ``kubedl_tpu/federation/routing.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import hashlib
from typing import Optional


def region_of(name: str, regions) -> str:
    """Stable origin region for a piece of named work: a consistent
    hash over the sorted region set (the same recipe as the serving
    router's ``_prefix_home`` — deterministic across runs, uniform
    across regions)."""
    ordered = sorted(regions)
    digest = hashlib.sha256(str(name).encode()).digest()
    return ordered[int.from_bytes(digest[:8], "big") % len(ordered)]


class GlobalRouter:
    """Ranks (region, pool) candidates for each arriving gang."""

    def __init__(self, topology, metrics=None):
        self.topology = topology
        self.metrics = metrics
        #: region -> (scorer, pools) — live placement surfaces
        self._regions: dict = {}
        #: region -> jobs landed there (the spread the console shows)
        self.routed: dict = {}
        #: job name -> explainer document for its routing decision
        self.decisions: dict = {}

    # -- membership --------------------------------------------------------

    def add_region(self, name: str, scorer, pools) -> None:
        self.topology._check(name)
        self._regions[name] = (scorer, list(pools))

    def remove_region(self, name: str) -> None:
        """A dead region stops being a candidate (evacuation keeps its
        routing history — the explainer must still answer for jobs
        routed before the outage)."""
        self._regions.pop(name, None)

    @property
    def live_regions(self) -> list:
        return sorted(self._regions)

    # -- the ranking -------------------------------------------------------

    def rank_regions(self, key: str, demand: int,
                     origin: Optional[str] = None,
                     pools: Optional[list] = None) -> list:
        """Best pool row per live region, region-factor applied,
        best-first. ``origin`` is the job's data-gravity region
        (defaults to the first live region); ``pools`` restricts the
        candidates (a job's declared pool class travels with it — the
        global layer chooses the REGION, not the accelerator shape)."""
        if not self._regions:
            raise RuntimeError("no live region to route into")
        origin = origin or self.live_regions[0]
        best_rows = []
        for region in self.live_regions:
            scorer, region_pools = self._regions[region]
            cand = list(pools) if pools is not None else region_pools
            ctx = self.topology.cost(origin, region)
            rows = scorer.rank(key, cand, demand, region=ctx)
            if rows:
                best_rows.append(rows[0])
        # ties break toward the origin-nearer region (then name), so a
        # dead heat lands next to the data instead of alphabetically
        order = {r: i for i, r in enumerate(self.topology.nearest(origin))}
        best_rows.sort(key=lambda r: (-r["score"],
                                      order.get(r["region"], len(order)),
                                      r["region"]))
        return best_rows

    def route(self, job: str, key: str, demand: int,
              origin: Optional[str] = None,
              pools: Optional[list] = None) -> tuple:
        """Choose the region + pool for one gang; returns
        ``(region, pool)`` and records the explainer document."""
        rows = self.rank_regions(key, demand, origin=origin, pools=pools)
        chosen = rows[0]
        self.routed[chosen["region"]] = \
            self.routed.get(chosen["region"], 0) + 1
        if self.metrics is not None:
            self.metrics.jobs_routed.inc(region=chosen["region"])
        self.decisions[job] = {
            "job": job,
            "origin": origin or self.live_regions[0],
            "chosenRegion": chosen["region"],
            "chosenPool": chosen["pool"],
            "runnerUp": (rows[1]["region"] if len(rows) > 1 else None),
            "rows": rows,
        }
        return chosen["region"], chosen["pool"]

    # -- the explainer -----------------------------------------------------

    def explain(self, job: str) -> Optional[dict]:
        """The pending-job explainer's federation block: the full
        ranked rows plus the chosen region and runner-up — the replayed
        decision, not a reconstruction."""
        doc = self.decisions.get(job)
        return dict(doc) if doc is not None else None

    def status(self) -> dict:
        return {
            "liveRegions": self.live_regions,
            "routed": {k: self.routed[k] for k in sorted(self.routed)},
            "decisions": len(self.decisions),
        }
