"""Feature gates.

Behavioral analog of the reference's k8s component-base gates
(``pkg/features/features.go:24-55``): a named on/off switch registry with
per-gate defaults and a ``--feature-gates=K=V,...`` / ``KUBEDL_FEATURE_GATES``
parser. Gates keep the reference's names plus TPU-native additions.

Copied from ``kubedl_tpu/core/features.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

# reference gates (features.go:24-40)
GANG_SCHEDULING = "GangScheduling"
DAG_SCHEDULING = "DAGScheduling"
PYTORCH_LOCAL_MASTER_ADDR = "PyTorchLocalMasterAddr"
HOSTNET_WITH_HEADLESS_SVC = "HostNetWithHeadlessSvc"
# TPU-native gates
TPU_MULTISLICE = "TPUMultislice"          # allow numSlices > 1 (DCN megascale env)
JAX_PROFILER_UPLOAD = "JAXProfilerUpload"  # render XProf profile-dir env
#: multi-tenant slice scheduler (queues/quota/preemption/backfill,
#: docs/scheduling.md); off by default so the pre-scheduler behavior —
#: every gang races pod creation — is preserved until opted into
TPU_SLICE_SCHEDULER = "TPUSliceScheduler"
#: end-to-end tracing (docs/tracing.md): job-lifecycle spans, scheduler
#: and serving request traces, console trace endpoints; off by default —
#: the disabled tracer's hot path is one attribute check (the `perf`
#: budget test in tests/test_trace.py holds it there)
TRACING = "Tracing"
#: fleet goodput & straggler telemetry (docs/telemetry.md): goodput
#: accounting, online throughput profiles, SlowSlice detection, the
#: pending-job explainer endpoint; off by default — enabling it also
#: turns the tracer on (the telemetry layer distills trace spans)
FLEET_TELEMETRY = "FleetTelemetry"
#: SLO engine (docs/slo.md): objective CRD, error budgets, multi-window
#: burn-rate alerting, console /api/v1/slo endpoints; off by default —
#: enabling it also turns on telemetry (and with it the tracer), since
#: the evaluator samples the signals those layers produce
SLO_ENGINE = "SLOEngine"
#: throughput-, contention-, and cost-aware slice placement
#: (docs/scheduling.md "Placement scoring"): gangs carry pool-eligibility
#: sets, admission scores every eligible pool as normalized-throughput /
#: (ICI-contention-penalty x $/chip-hour), multi-slice gangs pack into
#: one ICI domain when possible, spot pools join the fleet; off by
#: default — the unscored pass stays byte-identical (pinned by test).
#: Requires the slice scheduler (the gate is a no-op without it).
TPU_PLACEMENT_SCORING = "TPUPlacementScoring"
#: durable, sharded control plane (docs/durability.md): write-ahead
#: journal + snapshots over the COW store, crash-recovery replay,
#: resumable watch bookmarks, and N-way sharded reconcile ownership
#: with per-shard leases; off by default — the gate-off store/manager
#: paths are byte-identical to the pre-durability control plane
#: (pinned by tests/test_durability.py)
DURABLE_CONTROL_PLANE = "DurableControlPlane"
#: concurrency-elastic training (docs/elastic.md "Elastic slices"):
#: gangs advertise min..max slices, spot dryness shrinks jobs in place
#: (surplus slices preempted, the job keeps Running) instead of evicting
#: whole gangs, returning capacity regrows them, and the engine drives
#: restart-free trainer reconfiguration through the 2-phase checkpoint
#: protocol; off by default — the fixed-width admission pass stays
#: byte-identical (pinned by test). Requires the slice scheduler.
TPU_ELASTIC_SLICES = "TPUElasticSlices"
#: SLO-driven serving fleet (docs/serving_fleet.md): replica
#: autoscaling on burn-rate verdicts + engine health gauges,
#: prefix-cache-aware request routing with per-tenant fairness, and
#: disaggregated prefill/decode lanes with block-table handoff; off by
#: default — no ServingFleet object exists, no kubedl_serving_fleet_*/
#: kubedl_serving_free_blocks families register, and the console fleet
#: endpoint answers 501 (the byte-identical-disabled convention)
SERVING_FLEET = "ServingFleet"
#: multi-region federation (docs/federation.md): a global layer over N
#: replicated clusters — topology-priced queue routing, a cross-region
#: serving catalog with geo-affine prefix homes, follower-served
#: cross-region reads, and region-evacuation chaos; off by default — no
#: kubedl_federation_* family registers, the console federation
#: endpoints answer 501, and every committed single-cluster scorecard
#: stays byte-identical. Requires the durable control plane (regions
#: replicate through the WAL shipping stream).
FEDERATION = "Federation"
#: RL post-training flywheel (docs/rl.md): RLJob rides the serving
#: fleet as a dedicated low-priority rollout tenant — the RolloutClient
#: submits prompt groups through the prefix-aware router (flash crowds
#: squeeze rollouts via the fairness spill, idle decode capacity feeds
#: them), the FlywheelLearner drives the GRPO loss on the sharded
#: elastic-width Trainer, and the WeightPublisher rolls new policy
#: versions across replicas between drains; off by default — no
#: kubedl_rl_* family registers, the console /api/v1/rl endpoints
#: answer 501, and every committed serving/cluster scorecard stays
#: byte-identical. Requires the serving fleet (rollouts ARE fleet
#: traffic; there is no tenant queue to ride without it).
RL_FLYWHEEL = "RLFlywheel"
#: multi-model serving (docs/multimodel.md): LoRA adapter multiplexing
#: on the paged fleet — an AdapterCatalog whose weight pages allocate
#: from the same refcounted BlockPool as KV blocks (load pins, requests
#: refcount, idle adapters LRU-evict under the register_prefix
#: contract), model-scoped prefix caches, adapter-affine routing with
#: consistent-hash homes for cold models, and per-model SLO columns;
#: off by default — no kubedl_serving_adapter_* family registers, the
#: console /api/v1/serving/models endpoint answers 501, and every
#: committed scorecard stays byte-identical. Requires the serving
#: fleet (adapters are replica residency; there is no replica pool to
#: page them through without it).
MULTI_MODEL_SERVING = "MultiModelServing"

_DEFAULTS = {
    GANG_SCHEDULING: True,           # Beta
    DAG_SCHEDULING: True,            # Beta
    PYTORCH_LOCAL_MASTER_ADDR: True,  # Beta
    HOSTNET_WITH_HEADLESS_SVC: False,  # Alpha
    TPU_MULTISLICE: True,
    JAX_PROFILER_UPLOAD: False,
    TPU_SLICE_SCHEDULER: False,      # Alpha
    TRACING: False,                  # Alpha
    FLEET_TELEMETRY: False,          # Alpha
    SLO_ENGINE: False,               # Alpha
    TPU_PLACEMENT_SCORING: False,    # Alpha
    DURABLE_CONTROL_PLANE: False,    # Alpha
    TPU_ELASTIC_SLICES: False,       # Alpha
    SERVING_FLEET: False,            # Alpha
    FEDERATION: False,               # Alpha
    RL_FLYWHEEL: False,              # Alpha
    MULTI_MODEL_SERVING: False,      # Alpha
}

ENV_FEATURE_GATES = "KUBEDL_FEATURE_GATES"


class UnknownFeature(KeyError):
    pass


@dataclass
class FeatureGates:
    """An isolated gate set (tests build their own; the operator uses the
    process-wide ``default_gates``)."""

    overrides: dict = field(default_factory=dict)

    def enabled(self, name: str) -> bool:
        if name not in _DEFAULTS:
            raise UnknownFeature(name)
        return self.overrides.get(name, _DEFAULTS[name])

    def set(self, name: str, value: bool) -> None:
        if name not in _DEFAULTS:
            raise UnknownFeature(name)
        self.overrides[name] = bool(value)

    def parse(self, spec: str) -> None:
        """Parse ``Gate1=true,Gate2=false`` (the --feature-gates syntax)."""
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"feature gate {part!r} is not in K=V form")
            name, _, raw = part.partition("=")
            raw = raw.strip().lower()
            if raw not in ("true", "false"):
                raise ValueError(f"feature gate {name} value {raw!r} is not a bool")
            self.set(name.strip(), raw == "true")

    def parse_env(self, env: dict | None = None) -> None:
        env = env if env is not None else dict(os.environ)
        if env.get(ENV_FEATURE_GATES):
            self.parse(env[ENV_FEATURE_GATES])

    def known(self) -> dict:
        return {k: self.enabled(k) for k in _DEFAULTS}


default_gates = FeatureGates()
