"""TFJob controller.

Parity with reference ``controllers/tensorflow``: PS/Worker/Chief/Master/
Evaluator topology; ``TF_CONFIG`` cluster-spec JSON rendered from
headless-service DNS names (``tensorflow.go:75-152``) with the Evaluator
excluded from the cluster spec (``:112-116``); success policy worker-0 vs
all-workers (``status.go:170-171``).

TPU-native: Worker replicas may run on TPU hosts (tpuPolicy) — TF's own
TPU bring-up reads ``TPU_WORKER_ID``/``TPU_WORKER_HOSTNAMES`` which the
engine injects; PS/Chief/Evaluator stay CPU-side.

Copied from ``kubedl_tpu/controllers/workloads/tensorflow.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json

from ...api import common as c
from ...core import meta as m
from ...tpu import placement as pl
from ..interface import WorkloadController


class TFJobController(WorkloadController):
    kind = "TFJob"
    api_version = "training.kubedl.io/v1alpha1"
    default_container_name = "tensorflow"
    default_port_name = "tfjob-port"
    default_port = 2222
    replica_specs_field_name = "tfReplicaSpecs"

    def get_reconcile_orders(self):
        return [c.REPLICA_AIMASTER, "PS", "Master", "Chief", "Worker", "Evaluator"]

    def is_master_role(self, replicas, rtype, index):
        return rtype.lower() in ("chief", "master")

    def is_tpu_replica(self, rtype):
        return rtype.lower() == "worker"

    def contains_master_spec(self, replicas):
        return any(rt.lower() in ("chief", "master") for rt in replicas)

    def master_replica_types(self, replicas):
        return [rt for rt in replicas if rt.lower() in ("chief", "master")]

    def set_cluster_spec(self, job, pod, rtype, index):
        cluster = self._gen_cluster_spec(job)
        tf_config = {
            "cluster": cluster,
            "task": {"type": rtype.lower(), "index": int(index)},
            "environment": "cloud",
        }
        containers = m.get_in(pod, "spec", "containers", default=[]) or []
        named = [ct for ct in containers
                 if ct.get("name") == self.default_container_name]
        for ct in (named or containers):
            pl.upsert_env(ct, "TF_CONFIG", json.dumps(tf_config))

    def _gen_cluster_spec(self, job) -> dict:
        """Endpoints per replica type, evaluator excluded
        (reference tensorflow.go:108-152)."""
        replicas = self.get_replica_specs(job)
        cluster = {}
        for rtype, spec in replicas.items():
            rt = rtype.lower()
            if rt in ("evaluator", c.REPLICA_AIMASTER.lower()):
                continue
            port = self.default_port
            for ct in m.get_in(spec.template, "spec", "containers", default=[]) or []:
                for p in ct.get("ports", []) or []:
                    if p.get("name") == self.default_port_name:
                        port = int(p.get("containerPort", port))
            cluster[rt] = [
                f"{pl.service_dns(m.name(job), rt, i, m.namespace(job), self.dns_domain)}:{port}"
                for i in range(int(spec.replicas or 1))]
        return cluster
