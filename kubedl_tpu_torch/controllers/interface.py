"""The workload-controller plugin contract.

Python rendering of the reference's ``ControllerInterface`` + the elastic
scaling contract (``pkg/job_controller/api/v1/interface.go:12-90``). Every
framework controller (PyTorch/XLA, TF, JAX, XGBoost, XDL, Mars, ElasticDL)
implements this; the generic engine owns everything else. ``set_cluster_spec``
is deliberately kept as THE single point where a framework's rendezvous
contract lives (SURVEY.md §7 "hard parts").

TPU-native addition: ``TPUPolicy`` — a job-level declaration of the slice
shape (``spec.tpuPolicy`` or annotations). The engine uses it to render
every TPU replica with slice placement + PJRT env before the framework's
``set_cluster_spec`` runs, so frameworks only add their own glue on top.

Copied from ``kubedl_tpu/controllers/interface.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..api import common as c
from ..api.common import ReplicaSpec, RunPolicy
from ..core import meta as m
from ..tpu import topology
from ..tpu.topology import SliceSpec


@dataclass
class TPUPolicy:
    accelerator_type: str = ""       # "v5p-32"
    generation: str = ""             # alternative: generation + topology
    topology: str = ""               # "2x2x4"
    num_slices: int = 1
    host_chips: Optional[int] = None  # force v5e/v6e host machine shape

    @classmethod
    def from_spec(cls, d: dict) -> "TPUPolicy":
        """Parse a ``tpuPolicy`` spec dict. "accelerator" is the friendly
        alias: a full type ("v5p-32") or a bare generation ("v5p") paired
        with topology."""
        alias = d.get("accelerator", "")
        accel = d.get("acceleratorType", "") or (
            alias if "-" in alias else "")
        gen = d.get("generation", "") or (
            alias if alias and "-" not in alias else "")
        return cls(
            accelerator_type=accel,
            generation=gen,
            topology=d.get("topology", ""),
            num_slices=int(d.get("numSlices", 1) or 1),
            host_chips=d.get("hostChips"),
        )

    @classmethod
    def from_job(cls, job: dict) -> Optional["TPUPolicy"]:
        d = m.get_in(job, "spec", "tpuPolicy")
        if d:
            return cls.from_spec(d)
        ann = m.meta(job).get("annotations", {}) or {}
        if c.ANNOTATION_TPU_ACCELERATOR in ann or c.ANNOTATION_TPU_TOPOLOGY in ann:
            accel_ann = ann.get(c.ANNOTATION_TPU_ACCELERATOR, "")
            topo = ann.get(c.ANNOTATION_TPU_TOPOLOGY, "")
            # the accelerator annotation may be a full type ("v5p-32") or a
            # bare generation ("v5p") paired with the topology annotation
            if accel_ann and "-" in accel_ann:
                accel, gen = accel_ann, ""
            else:
                accel, gen = "", accel_ann
            if topo and not _looks_like_topology(topo):
                topo = ""
            return cls(accelerator_type=accel, generation=gen, topology=topo,
                       num_slices=int(ann.get(c.ANNOTATION_TPU_NUM_SLICES, 1) or 1))
        return None

    def resolve(self) -> SliceSpec:
        if self.accelerator_type:
            spec = topology.parse_accelerator(self.accelerator_type)
            if self.host_chips:
                spec = topology.from_chips(spec.generation.name, spec.chips,
                                           host_chips=self.host_chips)
            return spec
        if self.generation and self.topology:
            import math
            chips = math.prod(int(x) for x in self.topology.lower().split("x"))
            return topology.from_chips(self.generation, chips, self.topology,
                                       host_chips=self.host_chips)
        raise ValueError("tpuPolicy needs acceleratorType or generation+topology")


def _looks_like_topology(s: str) -> bool:
    parts = s.lower().split("x")
    return len(parts) >= 2 and all(p.isdigit() for p in parts)


class WorkloadController:
    """Base class per-framework controllers extend (reference
    ``interface.go:12-72``). Attributes identify the kind; methods are the
    framework-specific seams the generic engine calls into."""

    kind: str = ""
    api_version: str = "training.kubedl.io/v1alpha1"
    group_name: str = "kubedl.io"
    #: name of the framework's main container in pod templates
    default_container_name: str = "main"
    default_port_name: str = "kubedl-port"
    default_port: int = 8476
    #: spec field holding map[ReplicaType]ReplicaSpec (wire-compatible with
    #: the reference's irregular names: tfReplicaSpecs, pytorchReplicaSpecs,
    #: xgbReplicaSpecs, ...)
    replica_specs_field_name: str = "replicaSpecs"

    def __init__(self, api=None):
        #: API-server handle for controllers that manage extra resources
        #: (MPI hostfile ConfigMaps, elastic checkpoint patches); None in
        #: pure-rendering unit tests.
        self.api = api
        #: cluster DNS suffix, set by the operator registry from
        #: OperatorConfig.dns_domain so controller-rendered endpoints match
        #: the engine-rendered TPU env.
        self.dns_domain = ""

    # -- identity / spec access ------------------------------------------

    def get_replica_specs(self, job: dict) -> dict[str, ReplicaSpec]:
        raw = m.get_in(job, "spec", self.replica_specs_field_name, default={}) or {}
        return {rt: ReplicaSpec.from_dict(rs) for rt, rs in raw.items()}

    def get_run_policy(self, job: dict) -> RunPolicy:
        # reference kinds inline RunPolicy fields at spec top level
        return RunPolicy.from_dict(job.get("spec", {}))

    def validate(self, job: dict) -> None:
        """Kind-specific validation hook, run by the admission chain after
        the generic job validators. Raise ValueError to reject."""

    def set_defaults(self, job: dict) -> None:
        """Defaulting webhook analog (reference ``apis/training/v1alpha1/
        *_defaults.go``): replicas=1, restart policy, port."""
        raw = m.get_in(job, "spec", self.replica_specs_field_name, default={}) or {}
        for rt, rs in raw.items():
            rs.setdefault("replicas", 1)
            rs.setdefault("restartPolicy", self.default_restart_policy(rt))
        spec = job.setdefault("spec", {})
        spec.setdefault("cleanPodPolicy", c.CLEAN_POD_RUNNING)

    def default_restart_policy(self, rtype: str) -> str:
        return c.RESTART_NEVER

    # -- reconcile behavior ----------------------------------------------

    def get_reconcile_orders(self) -> list[str]:
        """Replica types in creation order (AIMaster first when present)."""
        return []

    def is_master_role(self, replicas: dict, rtype: str, index: int) -> bool:
        return rtype.lower() in ("master", "chief")

    def needs_service(self, rtype: str, job: Optional[dict] = None) -> bool:
        """Whether this replica type gets a headless service (PyTorch: master
        only, reference ``job.go:320-326``; MPI/ElasticDL: none). TPU jobs
        need per-replica DNS regardless — TPU_WORKER_HOSTNAMES resolves
        through these services — so controllers should return True for TPU
        replicas when the job carries a tpuPolicy."""
        return True

    def is_tpu_replica(self, rtype: str) -> bool:
        """Which replica types run on TPU hosts (get slice placement + PJRT
        env). PS/scheduler/launcher-style roles stay on CPU nodes."""
        return rtype.lower() in ("worker", "master", "chief")

    def set_cluster_spec(self, job: dict, pod_template: dict, rtype: str,
                         index: int) -> None:
        """Framework-specific rendezvous env injection. THE plugin seam."""

    # -- success semantics -----------------------------------------------

    def contains_master_spec(self, replicas: dict) -> bool:
        return any(rt.lower() in ("master", "chief") for rt in replicas)

    def success_policy(self, job: dict) -> str:
        return m.get_in(job, "spec", "successPolicy", default=c.SUCCESS_POLICY_DEFAULT) or ""

    def master_replica_types(self, replicas: dict) -> list[str]:
        return [rt for rt in replicas if rt.lower() in ("master", "chief")]

    def worker_replica_type(self) -> str:
        return "Worker"

    def judge_worker_success(self, job: dict, total: int, succeeded: int,
                             worker0_completed: bool) -> bool:
        """Whether a master-less job counts as succeeded given its worker
        tally (reference TF ``status.go:170-171``; XDL overrides with its
        min-finish-work-rate)."""
        if succeeded >= total:
            return True
        return (worker0_completed
                and self.success_policy(job) != c.SUCCESS_POLICY_ALL_WORKERS)

    # -- optional hooks ---------------------------------------------------

    def enable_elastic_scaling(self, job: dict, run_policy: RunPolicy) -> bool:
        return m.annotations(job).get(c.ANNOTATION_ENABLE_ELASTIC) == "true"

    def checkpoint_if_necessary(self, job: dict, pods: list) -> bool:
        """Returns True when no checkpoint is in flight (scaling may go)."""
        return True

    def scale_out(self, job: dict, replicas: dict, pods: list, services: list) -> None:
        pass

    def scale_in(self, job: dict, replicas: dict, pods: list, services: list) -> None:
        pass

    def on_job_finished(self, job: dict, pods: list) -> None:
        """Post-terminal hook (e.g. TensorBoard TTL, MPI launcher cleanup)."""

    def on_job_running(self, job: dict) -> None:
        """Hook fired while job is live (e.g. TensorBoard reconcile)."""
