"""Declarative chaos campaigns over the fault-injecting control plane.

:mod:`kubedl_tpu_torch.controllers.chaos` injects *uncorrelated* faults — one
409, one dropped event, one preempted pod. Real TPU fleets fail in
*correlated* ways (docs/chaos.md): a whole ICI domain's OCS links flap
at once, a pool's spot capacity vanishes in one sweep, a bad release
hot-loops one controller shard, the WAL disk slows to 1/100th speed.
This package is the campaign layer on top: seeded, sim-clock-scheduled
scenario scripts composed from correlated fault primitives, executed
against the REAL stack through the cluster replay harness, and gated on
SLO survival by ``bench_cluster.py --profile adversarial``.

Copied from ``kubedl_tpu/chaos/__init__.py`` (the port imports nothing of the JAX package).
"""

from .campaign import (Campaign, CampaignRunner, FaultAction, PRIMITIVES,
                       SCENARIOS, build_campaign, control_plane_digest)

__all__ = [
    "Campaign", "CampaignRunner", "FaultAction", "PRIMITIVES",
    "SCENARIOS", "build_campaign", "control_plane_digest",
]
