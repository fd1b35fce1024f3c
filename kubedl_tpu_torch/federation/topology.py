"""Static region topology: the federation's wire distances and data gravity.

The grammar (docs/federation.md "Region topology grammar") is one
semicolon-joined string, flag-friendly like ``--feature-gates``::

    us-east,us-west,eu-west;us-east~us-west=65/0.02;us-east~eu-west=140/0.05

* the FIRST clause names the regions (comma-separated, order
  irrelevant — the topology sorts them);
* every other clause is one undirected edge ``A~B=latencyMs/egressPerGB``
  (symmetric: declaring ``A~B`` also prices ``B~A``);
* pairs with no declared edge fall back to :data:`DEFAULT_LATENCY_MS` /
  :data:`DEFAULT_EGRESS_PER_GB`; a region to itself is always 0/0.

The scorer consumes the topology as :class:`RegionCost` contexts: one
``(origin, target)`` pair's latency + egress terms folded into a single
multiplicative ``factor`` that divides the placement score exactly like
an expensive pool's ``$/chip-hour`` does (``scheduling/scoring.py``) —
the arxiv 2304.06381 energy/egress-aware direction priced in the Gavel
currency. Pure data: parsing is deterministic, :meth:`fingerprint` is
the determinism probe every committed federation scorecard pins.

Copied from ``kubedl_tpu/federation/topology.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

#: undeclared inter-region edges price like a mid-continent hop
DEFAULT_LATENCY_MS = 100.0
DEFAULT_EGRESS_PER_GB = 0.05

#: 1000 ms of one-way latency doubles the distance term — wire distance
#: matters but never swamps a real throughput/cost gap
LATENCY_SCALE_MS = 1000.0


@dataclass(frozen=True)
class RegionCost:
    """One (origin → target) cost context, scorer-facing: ``factor`` is
    the multiplicative penalty the target region pays for being far
    from the job's data (1.0 for the local region)."""
    origin: str
    name: str                     # the target region being scored
    latency_ms: float
    egress_per_gb: float

    @property
    def factor(self) -> float:
        return (1.0 + self.latency_ms / LATENCY_SCALE_MS
                + self.egress_per_gb)


class RegionTopology:
    """Parsed region graph; every read is a pure function of the spec."""

    def __init__(self, regions, edges=None):
        names = sorted(set(regions))
        if len(names) < 2:
            raise ValueError(
                f"a federation needs >= 2 regions, got {names}")
        self.regions: tuple = tuple(names)
        #: frozenset({a, b}) -> (latency_ms, egress_per_gb)
        self._edges: dict = {}
        for (a, b), (lat, egress) in (edges or {}).items():
            if a not in names or b not in names:
                raise ValueError(f"edge {a}~{b} names an unknown region")
            if a == b:
                raise ValueError(f"self-edge {a}~{b} is implicit (0/0)")
            self._edges[frozenset((a, b))] = (float(lat), float(egress))

    # -- parsing -----------------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "RegionTopology":
        """Parse the flag grammar (see module docstring)."""
        clauses = [c.strip() for c in (spec or "").split(";")
                   if c.strip()]
        if not clauses:
            raise ValueError("empty region topology spec")
        regions = [r.strip() for r in clauses[0].split(",") if r.strip()]
        edges = {}
        for clause in clauses[1:]:
            if "~" not in clause or "=" not in clause:
                raise ValueError(
                    f"edge clause {clause!r} is not A~B=latencyMs/"
                    f"egressPerGB")
            pair, _, cost = clause.partition("=")
            a, _, b = pair.partition("~")
            lat, sep, egress = cost.partition("/")
            if not sep:
                raise ValueError(
                    f"edge clause {clause!r} is missing the "
                    f"/egressPerGB half")
            edges[(a.strip(), b.strip())] = (float(lat), float(egress))
        return cls(regions, edges)

    # -- reads -------------------------------------------------------------

    def edge(self, a: str, b: str) -> tuple:
        """(latency_ms, egress_per_gb) for an ordered pair (symmetric;
        self = (0, 0); undeclared = defaults)."""
        self._check(a)
        self._check(b)
        if a == b:
            return 0.0, 0.0
        return self._edges.get(frozenset((a, b)),
                               (DEFAULT_LATENCY_MS, DEFAULT_EGRESS_PER_GB))

    def cost(self, origin: str, target: str) -> RegionCost:
        """The scorer context for placing ``origin``-gravity work in
        ``target``."""
        lat, egress = self.edge(origin, target)
        return RegionCost(origin=origin, name=target, latency_ms=lat,
                          egress_per_gb=egress)

    def nearest(self, origin: str) -> list:
        """Every region sorted by distance from ``origin`` (latency,
        then egress, then name — origin itself first at distance 0).
        The serving catalog's geo-affinity order."""
        self._check(origin)
        return sorted(self.regions,
                      key=lambda r: (*self.edge(origin, r), r))

    def _check(self, region: str) -> None:
        if region not in self.regions:
            raise ValueError(f"unknown region {region!r}: topology has "
                             f"{', '.join(self.regions)}")

    # -- introspection -----------------------------------------------------

    def describe(self) -> dict:
        """The console's topology document (docs/federation.md)."""
        edges = []
        for a in self.regions:
            for b in self.regions:
                if a < b:
                    lat, egress = self.edge(a, b)
                    edges.append({"a": a, "b": b,
                                  "latencyMs": round(lat, 4),
                                  "egressPerGB": round(egress, 4)})
        return {"regions": list(self.regions), "edges": edges}

    def fingerprint(self) -> str:
        """sha256 over the canonical rendering — the same determinism
        probe as ``Workload.fingerprint`` (docs/benchmarks.md)."""
        blob = json.dumps(self.describe(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()
