"""XDLJob controller.

Parity with reference ``controllers/xdl``: PS/Scheduler/Worker/ExtendRole
topology; appends the job UID to the ZooKeeper address env and sets
``TASK_NAME``/``TASK_INDEX`` per replica (``xdljob_controller.go:197-223``);
min-finish-work-rate success policy on workers.

Copied from ``kubedl_tpu/controllers/workloads/xdl.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from ...api import common as c
from ...core import meta as m
from ...tpu import placement as pl
from ..interface import WorkloadController

ZK_ADDR_ENV = "ZK_ADDR"


class XDLJobController(WorkloadController):
    kind = "XDLJob"
    api_version = "training.kubedl.io/v1alpha1"
    default_container_name = "xdl"
    default_port_name = "xdljob-port"
    default_port = 9999
    replica_specs_field_name = "xdlReplicaSpecs"

    def get_reconcile_orders(self):
        return [c.REPLICA_AIMASTER, "PS", "Scheduler", "Worker", "ExtendRole"]

    def is_master_role(self, replicas, rtype, index):
        return rtype.lower() == "scheduler"

    def is_tpu_replica(self, rtype):
        return False

    def contains_master_spec(self, replicas):
        return False  # success is judged on workers (min finish rate)

    def judge_worker_success(self, job, total, succeeded, worker0_completed):
        """minFinishWorkRate: percentage of workers that must finish
        (reference xdljob min-finish-work-rate success policy; default all)."""
        rate = m.get_in(job, "spec", "minFinishWorkRate")
        threshold = float(rate) / 100.0 if rate else 1.0
        import math
        return succeeded >= math.ceil(total * threshold)

    def set_cluster_spec(self, job, pod, rtype, index):
        for ct in m.get_in(pod, "spec", "containers", default=[]) or []:
            for env in ct.get("env", []) or []:
                if env.get("name") == ZK_ADDR_ENV and "value" in env:
                    sep = "" if env["value"].endswith("/") else "/"
                    env["value"] = env["value"] + sep + m.uid(job)
            pl.upsert_env(ct, "TASK_NAME", rtype.lower())
            pl.upsert_env(ct, "TASK_INDEX", index)
