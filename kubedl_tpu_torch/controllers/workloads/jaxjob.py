"""JAXJob: the first-class TPU-native workload kind.

No direct reference analog — this is the TPU-idiomatic successor of the
reference's MPIJob rendezvous role (SURVEY.md §2-P: "MPIJob → JAX
multi-process data parallel"). A JAXJob is a pure SPMD slice workload:
one Worker replica type, one pod per TPU host, ``jax.distributed``
rendezvous entirely through the engine-injected env
(``KUBEDL_COORDINATOR_ADDRESS``/``KUBEDL_NUM_PROCESSES``/
``KUBEDL_PROCESS_ID`` + ``TPU_WORKER_*``), consumed in-container by
``kubedl_tpu_torch.runtime.bootstrap``. Multislice (ICI+DCN) comes from
``tpuPolicy.numSlices`` (BASELINE config 4).

Copied from ``kubedl_tpu/controllers/workloads/jaxjob.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from ...api import common as c
from ...core import meta as m
from ...tpu import placement as pl
from ..elastic import ElasticInPlaceMixin
from ..interface import WorkloadController


class JAXJobController(ElasticInPlaceMixin, WorkloadController):
    kind = "JAXJob"
    api_version = "training.kubedl.io/v1alpha1"
    default_container_name = "jax"
    default_port_name = "jaxjob-port"
    default_port = pl.DEFAULT_COORDINATOR_PORT
    replica_specs_field_name = "jaxReplicaSpecs"

    #: a JAX trainer's world is its process count: the elastic
    #: downward-API fieldRef re-resolves KUBEDL_NUM_PROCESSES (the
    #: bootstrap rendezvous contract, runtime/bootstrap.py) on each
    #: in-place container restart
    elastic_world_size_env = pl.ENV_NUM_PROCESSES

    def get_reconcile_orders(self):
        return [c.REPLICA_AIMASTER, "Worker"]

    def is_master_role(self, replicas, rtype, index):
        return rtype.lower() == "worker" and index == 0  # process 0

    def is_tpu_replica(self, rtype):
        return rtype.lower() == "worker"

    def set_cluster_spec(self, job, pod, rtype, index):
        # everything rendezvous-related is already injected by the TPU
        # placement layer; add the JAX runtime switches
        if rtype == c.REPLICA_AIMASTER:
            return
        replicas = self.get_replica_specs(job)
        world = self.elastic_world(replicas)
        elastic = self.enable_elastic_scaling(job, None)
        for ct in m.get_in(pod, "spec", "containers", default=[]) or []:
            pl.upsert_env(ct, "JAX_PLATFORMS", "tpu,cpu")
            pl.upsert_env(ct, "ENABLE_PJRT_COMPATIBILITY", "true")
            if not any(e.get("name") == pl.ENV_PROCESS_ID
                       for e in ct.get("env", [])):
                # off-TPU JAXJob (no tpuPolicy: placement layer skipped):
                # render the FULL bootstrap contract — coord + nproc +
                # process id — so rendezvous_from_env engages instead of
                # silently treating every worker as a lone process
                pl.upsert_env(ct, pl.ENV_COORDINATOR_ADDRESS,
                              f"{m.name(job)}-worker-0:{self.default_port}")
                pl.upsert_env(ct, pl.ENV_PROCESS_ID, int(index))
                pl.upsert_env(ct, pl.ENV_NUM_PROCESSES, world)
            if elastic:
                # overrides the literal world size with the annotation
                # fieldRef (set_cluster_spec runs after placement env
                # injection — engine.py ordering)
                self.render_elastic_world(pod, ct, world)
