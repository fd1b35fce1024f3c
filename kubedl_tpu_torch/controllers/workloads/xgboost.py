"""XGBoostJob controller.

Parity with reference ``controllers/xgboost``: Master/Worker rabit-tracker
env — every replica gets ``MASTER_ADDR``/``MASTER_PORT`` (the tracker on
master-0), ``WORLD_SIZE`` and its own ``RANK`` (``pod.go:56-120``). CPU-side
workload (no TPU replicas by default — XGBoost doesn't target XLA).

Copied from ``kubedl_tpu/controllers/workloads/xgboost.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from ...api import common as c
from ...core import meta as m
from ...tpu import placement as pl
from ..interface import WorkloadController


class XGBoostJobController(WorkloadController):
    kind = "XGBoostJob"
    api_version = "training.kubedl.io/v1alpha1"
    default_container_name = "xgboostjob"
    default_port_name = "xgboostjob-port"
    default_port = 9999
    replica_specs_field_name = "xgbReplicaSpecs"

    def get_reconcile_orders(self):
        return [c.REPLICA_AIMASTER, "Master", "Worker"]

    def is_master_role(self, replicas, rtype, index):
        return rtype.lower() == "master"

    def is_tpu_replica(self, rtype):
        return False

    def set_cluster_spec(self, job, pod, rtype, index):
        rt = rtype.lower()
        replicas = self.get_replica_specs(job)
        master_addr = pl.service_dns(m.name(job), "master", 0, m.namespace(job),
                                     self.dns_domain)
        master_port = self.default_port
        master_spec = replicas.get("Master")
        if master_spec is not None:
            for ct0 in m.get_in(master_spec.template, "spec", "containers",
                                default=[]) or []:
                for p in ct0.get("ports", []) or []:
                    if p.get("name") == self.default_port_name:
                        master_port = int(p.get("containerPort", master_port))
        world = sum(int(rs.replicas or 1) for rt_, rs in replicas.items()
                    if rt_ != c.REPLICA_AIMASTER)
        rank = int(index) if rt == "master" else int(index) + \
            int((replicas.get("Master") and replicas["Master"].replicas) or 0)
        for ct in m.get_in(pod, "spec", "containers", default=[]) or []:
            pl.upsert_env(ct, "MASTER_PORT", master_port)
            pl.upsert_env(ct, "MASTER_ADDR", master_addr)
            pl.upsert_env(ct, "WORLD_SIZE", world)
            pl.upsert_env(ct, "RANK", rank)
            pl.upsert_env(ct, "PYTHONUNBUFFERED", "0")
