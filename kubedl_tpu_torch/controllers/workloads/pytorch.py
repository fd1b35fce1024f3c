"""PyTorchJob controller (torch_xla on TPU).

Parity with reference ``controllers/pytorch/pytorchjob_controller.go``:
Master/Worker topology, ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
``WORLD_SIZE`` injection (``:207-303``), master-only headless service
(``pkg/job_controller/job.go:321-324``), elastic scaling with the 2-phase
checkpoint protocol (``elastic_scale.go``), AIMaster-first reconcile order
(``:320-326``).

TPU-native: when the job carries a tpuPolicy, replicas also get slice
placement + PJRT env from the engine, and this controller adds
``PJRT_DEVICE=TPU`` so torch_xla picks the PJRT TPU runtime; every TPU
replica gets a headless service (TPU_WORKER_HOSTNAMES resolves through
them), not just the master.

Copied from ``kubedl_tpu/controllers/workloads/pytorch.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from ...api import common as c
from ...core import meta as m
from ...tpu import placement as pl
from ..elastic import (ANNOTATION_WORLD_SIZE, PODINFO_MOUNT_PATH,
                       PODINFO_VOLUME, ElasticInPlaceMixin)
from ..interface import TPUPolicy, WorkloadController

__all__ = ["PyTorchJobController", "ANNOTATION_WORLD_SIZE",
           "PODINFO_VOLUME", "PODINFO_MOUNT_PATH"]


class PyTorchJobController(ElasticInPlaceMixin, WorkloadController):
    kind = "PyTorchJob"
    api_version = "training.kubedl.io/v1alpha1"
    default_container_name = "pytorch"
    default_port_name = "pytorchjob-port"
    default_port = 23456
    replica_specs_field_name = "pytorchReplicaSpecs"

    def get_reconcile_orders(self):
        return [c.REPLICA_AIMASTER, "Master", "Worker"]

    def is_master_role(self, replicas, rtype, index):
        return rtype.lower() == "master"

    def needs_service(self, rtype, job=None):
        if rtype.lower() == "master" or rtype == c.REPLICA_AIMASTER:
            return True
        if job is not None and TPUPolicy.from_job(job) is not None:
            return True
        # master-less SPMD shape: worker-0 anchors the rendezvous, so the
        # workers need DNS even off-TPU
        if rtype.lower() == "worker" and job is not None:
            raw = m.get_in(job, "spec", self.replica_specs_field_name,
                           default={}) or {}
            return not any(r.lower() == "master" for r in raw)
        return False

    def is_tpu_replica(self, rtype):
        return rtype.lower() in ("master", "worker")

    def default_restart_policy(self, rtype):
        return c.RESTART_ON_FAILURE if rtype.lower() == "worker" else c.RESTART_NEVER

    def set_cluster_spec(self, job, pod, rtype, index):
        rt = rtype.lower()
        if rt == c.REPLICA_AIMASTER.lower():
            return
        replicas = self.get_replica_specs(job)
        has_master = any(rt_.lower() == "master" for rt_ in replicas)
        # master-less jobs anchor the rendezvous on worker-0 so RANK=0
        # exists and MASTER_ADDR resolves to a real service
        master_addr = (f"{m.name(job)}-master-0" if has_master
                       else f"{m.name(job)}-worker-0")
        master_port = self.default_port
        master_spec = replicas.get("Master") or replicas.get("Worker")
        if master_spec is not None:
            for ct0 in m.get_in(master_spec.template, "spec", "containers",
                                default=[]) or []:
                for p in ct0.get("ports", []) or []:
                    if p.get("name") == self.default_port_name:
                        master_port = int(p.get("containerPort", master_port))

        rank = int(index)
        if rt == "master":
            if rank != 0:
                raise ValueError("there should be a single master with index=0")
        elif has_master:
            rank += 1  # workers follow the master (reference :238)

        world = self.elastic_world(replicas)
        elastic = self.enable_elastic_scaling(job, None)
        for ct in m.get_in(pod, "spec", "containers", default=[]) or []:
            pl.upsert_env(ct, "MASTER_PORT", master_port)
            pl.upsert_env(ct, "MASTER_ADDR", master_addr)
            pl.upsert_env(ct, "RANK", rank)
            pl.upsert_env(ct, "PYTHONUNBUFFERED", "0")
            if TPUPolicy.from_job(job) is not None:
                pl.upsert_env(ct, "PJRT_DEVICE", "TPU")
            if elastic:
                self.render_elastic_world(pod, ct, world)
            else:
                pl.upsert_env(ct, "WORLD_SIZE", world)
