"""Multi-region federation: a global layer over N replicated clusters.

ROADMAP item 4 (docs/federation.md): each region runs its own
``ClusterReplay``-backed control plane (leader + followers via
``core/replication.py``) on ONE shared :class:`~kubedl_tpu_torch.core.clock
.SimClock`; this package adds the thin global layer over them —

* :mod:`topology <kubedl_tpu_torch.federation.topology>` — the static region
  graph (inter-region latency + egress pricing) and the per-pair cost
  contexts the placement scorer folds in;
* :mod:`routing <kubedl_tpu_torch.federation.routing>` — global queue
  routing: jobs land in the region whose pools score best, and the
  pending-job explainer names the chosen region and runner-up;
* :mod:`catalog <kubedl_tpu_torch.federation.catalog>` — the cross-region
  serving catalog: cold-prefix consistent-hash homes partitioned across
  regions with geo-affinity;
* :mod:`shipping <kubedl_tpu_torch.federation.shipping>` — cross-region WAL
  shipping with bounded retry/backoff, the peer-region standby the
  zero-loss audit reads, and the follower read gateway;
* :mod:`replay <kubedl_tpu_torch.federation.replay>` — the
  :class:`FederationReplay` driver: N regions in lockstep, the
  ``region_down`` evacuation, and the survival scorecard.

Everything ships behind the ``Federation`` gate / ``--enable-federation``
(off = byte-identical: no new metric families, console federation
endpoints answer 501, every committed single-cluster scorecard
untouched).

Copied from ``kubedl_tpu/federation/__init__.py`` (the port imports nothing of the JAX package).
"""

from .catalog import GlobalServingCatalog
from .replay import FederationReplay
from .routing import GlobalRouter, region_of
from .shipping import CrossRegionShipper, CrossRegionStandby, ReadGateway
from .topology import RegionCost, RegionTopology

__all__ = [
    "CrossRegionShipper", "CrossRegionStandby", "FederationReplay",
    "GlobalRouter", "GlobalServingCatalog", "ReadGateway", "RegionCost",
    "RegionTopology", "region_of",
]
