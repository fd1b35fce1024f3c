"""Cross-region serving catalog: geo-affine cold-prefix homes.

``serving/router.py`` gave each cold prefix a stable home REPLICA via a
consistent hash over the active set, so a fleet's prefix caches
partition the catalog. This module lifts the same idea one level up
(docs/federation.md): each prefix first gets a home REGION — the
identical ``_prefix_home`` hash, but over the ``affinity`` regions
nearest the prefix's origin (the topology's latency order), so prefix
traffic stays geographically close to its tenants while still spreading
across more than one region. Inside the chosen region the per-region
:class:`~kubedl_tpu_torch.serving.router.PrefixAwareRouter` picks the replica
exactly as before — the two hash levels compose, neither changes.

Evacuation (``region_down``): the dead region leaves the alive set, and
every prefix homed there re-hashes over the surviving nearest set —
deterministically, so both runs of the bench re-route the same streams
to the same survivors. One-way for the day, like the chaos primitive.

Copied from ``kubedl_tpu/federation/catalog.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from ..serving.router import _prefix_home


class GlobalServingCatalog:
    """Prefix → home region, geo-affine, evacuation-aware."""

    def __init__(self, topology, origins, affinity: int = 2,
                 metrics=None):
        """``origins`` maps each registered prefix (a token tuple) to
        its origin region — where the tenant that declared it lives;
        ``affinity`` is how many nearest regions a prefix's home may
        hash across (1 = always the origin itself)."""
        self.topology = topology
        self.affinity = max(int(affinity), 1)
        self.metrics = metrics
        self.origins = {tuple(p): o for p, o in origins.items()}
        self.alive = set(topology.regions)
        #: prefix -> home region under the FULL topology (the pre-chaos
        #: partition; re-route accounting compares against this)
        self.initial_homes = {p: self.home(p) for p in self.origins}

    def origin_of(self, prefix) -> str:
        origin = self.origins.get(tuple(prefix))
        if origin is None:
            raise KeyError(f"prefix {tuple(prefix)!r} was never "
                           f"registered with the catalog")
        return origin

    def home(self, prefix) -> str:
        """The prefix's current home region: consistent hash over the
        ``affinity`` nearest LIVE regions to its origin. Raises when
        every region is dead — there is no fleet left to serve."""
        origin = self.origin_of(prefix)
        candidates = [r for r in self.topology.nearest(origin)
                      if r in self.alive][:self.affinity]
        if not candidates:
            raise RuntimeError("no live region left in the catalog")
        return candidates[_prefix_home(prefix, len(candidates))]

    def evacuate(self, region: str) -> dict:
        """Remove a dead region; returns ``{prefix: new_home}`` for
        every prefix whose home moved (the streams-to-re-route set)."""
        self.topology._check(region)
        if region not in self.alive:
            return {}
        before = {p: self.home(p) for p in self.origins}
        self.alive.discard(region)
        moved = {}
        for p in sorted(self.origins):
            new = self.home(p)
            if before[p] != new:
                moved[p] = new
        return moved

    def status(self) -> dict:
        """The console's catalog snapshot (docs/federation.md)."""
        per_region: dict = {r: 0 for r in sorted(self.alive)}
        for p in self.origins:
            per_region[self.home(p)] = per_region.get(self.home(p), 0) + 1
        return {
            "prefixes": len(self.origins),
            "affinity": self.affinity,
            "aliveRegions": sorted(self.alive),
            "homesPerRegion": per_region,
        }
