"""ElasticDLJob controller.

Parity with reference ``controllers/elasticdl``: a master-only launcher
(the ElasticDL master itself spawns/scales workers through the API server);
no services (``pkg/job_controller/job.go:315-317``); master pod named
``elasticdl-{job}-master`` semantics preserved via the standard
``{job}-master-0`` naming plus a compat label.

Copied from ``kubedl_tpu/controllers/workloads/elasticdl.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from ...api import common as c
from ...core import meta as m
from ...tpu import placement as pl
from ..interface import WorkloadController


class ElasticDLJobController(WorkloadController):
    kind = "ElasticDLJob"
    api_version = "training.kubedl.io/v1alpha1"
    default_container_name = "elasticdl"
    default_port_name = "elasticdljob-port"
    default_port = 50001
    replica_specs_field_name = "elasticdlReplicaSpecs"

    def get_reconcile_orders(self):
        return ["Master"]

    def is_master_role(self, replicas, rtype, index):
        return rtype.lower() == "master"

    def is_tpu_replica(self, rtype):
        return False

    def needs_service(self, rtype, job=None):
        return False

    def set_cluster_spec(self, job, pod, rtype, index):
        for ct in m.get_in(pod, "spec", "containers", default=[]) or []:
            pl.upsert_env(ct, "ELASTICDL_JOB_NAME", m.name(job))
            pl.upsert_env(ct, "ELASTICDL_NAMESPACE", m.namespace(job))
