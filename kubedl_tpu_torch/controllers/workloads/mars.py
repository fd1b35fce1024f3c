"""MarsJob controller.

Parity with reference ``controllers/mars``: Scheduler/Worker/WebService
roles; ``MARS_CONFIG`` cluster JSON + resource/memory-tuning env
(``marsjob_controller.go:182-270``) — spill dirs, plasma store, cache size
with a tmpfs emptyDir mount; WebService ingress is handled by the notebook-
style ingress helper at platform level.

Copied from ``kubedl_tpu/controllers/workloads/mars.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json

from ...api import common as c
from ...core import meta as m
from ...tpu import placement as pl
from ..interface import WorkloadController


class MarsJobController(WorkloadController):
    kind = "MarsJob"
    api_version = "training.kubedl.io/v1alpha1"
    default_container_name = "mars"
    default_port_name = "mars-port"
    default_port = 7103
    replica_specs_field_name = "marsReplicaSpecs"

    def get_reconcile_orders(self):
        return [c.REPLICA_AIMASTER, "Scheduler", "Worker", "WebService"]

    def is_master_role(self, replicas, rtype, index):
        return rtype.lower() == "scheduler"

    def is_tpu_replica(self, rtype):
        return False

    def master_replica_types(self, replicas):
        return [rt for rt in replicas if rt.lower() == "scheduler"]

    def contains_master_spec(self, replicas):
        return any(rt.lower() == "scheduler" for rt in replicas)

    def set_cluster_spec(self, job, pod, rtype, index):
        rt = rtype.lower()
        replicas = self.get_replica_specs(job)
        cluster = {}
        for rtype_, spec in replicas.items():
            rt_ = rtype_.lower()
            if rt_ == c.REPLICA_AIMASTER.lower():
                continue
            cluster[rt_] = [
                f"{pl.service_dns(m.name(job), rt_, i, m.namespace(job), self.dns_domain)}"
                f":{self.default_port}"
                for i in range(int(spec.replicas or 1))]
        mars_config = json.dumps(
            {"cluster": cluster, "task": {"type": rt, "index": int(index)}})

        for ct in m.get_in(pod, "spec", "containers", default=[]) or []:
            if ct.get("name") != self.default_container_name and \
                    len(m.get_in(pod, "spec", "containers", default=[])) > 1:
                continue
            res = ct.get("resources", {})
            cpu = _resource_amount(res, "cpu")
            mem = _resource_amount(res, "memory")
            pl.upsert_env(ct, "MARS_CPU_TOTAL", cpu)
            pl.upsert_env(ct, "MARS_MEMORY_TOTAL", mem)
            pl.upsert_env(ct, "MARS_CPU_USE_PROCESS_STAT", "1")
            pl.upsert_env(ct, "MARS_MEM_USE_CGROUP_STAT", "1")
            pl.upsert_env(ct, "MARS_BIND_PORT", self.default_port)
            pl.upsert_env(ct, "MARS_K8S_GROUP_LABELS", c.LABEL_JOB_NAME)
            pl.upsert_env(ct, "MARS_CONTAINER_IP",
                          value_from={"fieldRef": {"fieldPath": "status.podIP"}})
            pl.upsert_env(ct, "MARS_K8S_POD_NAME",
                          value_from={"fieldRef": {"fieldPath": "metadata.name"}})
            pl.upsert_env(ct, "MARS_K8S_POD_NAMESPACE",
                          value_from={"fieldRef": {"fieldPath": "metadata.namespace"}})
            pl.upsert_env(ct, "MARS_CONFIG", mars_config)
            if rt == "worker":
                self._apply_memory_tuning(job, pod, ct, mem)

    def _apply_memory_tuning(self, job, pod, ct, mem_total: int) -> None:
        policy = m.get_in(job, "spec", "workerMemoryTuningPolicy")
        if not policy:
            return
        spill_dirs = policy.get("spillDirs") or []
        if spill_dirs:
            pl.upsert_env(ct, "MARS_SPILL_DIRS", ",".join(spill_dirs))
            vols = pod["spec"].setdefault("volumes", [])
            mounts = ct.setdefault("volumeMounts", [])
            for i, d in enumerate(spill_dirs):
                vname = f"mars-spill-{i}"
                if not any(v.get("name") == vname for v in vols):
                    vols.append({"name": vname, "emptyDir": {}})
                    mounts.append({"name": vname, "mountPath": d})
        if policy.get("plasmaStore"):
            pl.upsert_env(ct, "MARS_PLASMA_DIRS", policy["plasmaStore"])
        if policy.get("lockFreeFileIO") is not None:
            pl.upsert_env(ct, "MARS_LOCK_FREE_FILEIO",
                          1 if policy["lockFreeFileIO"] else 0)
        ratio = policy.get("workerCacheRatio")
        cache = policy.get("workerCacheSize")
        cache_size = int(cache) if cache else (
            int(mem_total * float(ratio)) if ratio and mem_total else 0)
        if cache_size > 0:
            pl.upsert_env(ct, "MARS_CACHE_MEM_SIZE", cache_size)
            mount_path = policy.get("plasmaStore") or "/etc/mars/cache"
            vols = pod["spec"].setdefault("volumes", [])
            if not any(v.get("name") == "mars-shared-cache" for v in vols):
                vols.append({"name": "mars-shared-cache",
                             "emptyDir": {"medium": "Memory",
                                          "sizeLimit": str(cache_size)}})
                ct.setdefault("volumeMounts", []).append(
                    {"name": "mars-shared-cache", "mountPath": mount_path})


def _resource_amount(resources: dict, key: str) -> int:
    val = (resources.get("limits", {}).get(key)
           or resources.get("requests", {}).get(key) or 0)
    return _parse_quantity(val)


def _parse_quantity(val) -> int:
    """k8s quantity -> integer base units (cpu cores / bytes)."""
    if isinstance(val, (int, float)):
        return int(val)
    s = str(val).strip()
    if not s:
        return 0
    suffixes = {"m": 1e-3, "k": 1e3, "K": 1e3, "M": 1e6, "G": 1e9, "T": 1e12,
                "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40}
    for suf in sorted(suffixes, key=len, reverse=True):
        if s.endswith(suf):
            return int(float(s[:-len(suf)]) * suffixes[suf])
    try:
        return int(float(s))
    except ValueError:
        return 0
