"""Dataset cache: the CacheBackend CRD, cache-engine plugins, and the job
engine's mount integration.

Behavioral analog of ``apis/cache/v1alpha1`` + ``pkg/cache_backend`` +
``controllers/cache`` + the job-engine hooks at
``pkg/job_controller/job_controller.go:202-315``:

* a job spec carries an inline ``cacheBackend`` (mountPath + dataset
  sources + engine choice); the engine creates a ``CacheBackend`` CR owned
  by the job and records its name in job status,
* the CacheBackend controller drives an engine plugin until a PVC with the
  cache's name exists (status CacheCreating → PVCCreating → PVCCreated),
* once the PVC exists the job engine mounts it into every replica at
  ``mountPath`` and injects ``KUBEDL_CACHE_NAME``; until then the job waits.

Engine plugins (the ``CacheEngine`` seam, reference ``interface.go:9-13``):

* ``hostDisk`` — TPU-native default. TPU VMs ship large local NVMe; instead
  of an Alluxio tier the engine renders a hostPath PV + PVC and a one-shot
  warm-up pod that ``gsutil rsync``-s each data source onto the host disk.
  Dataset locality comes from the gang scheduler placing the whole slice on
  the same hosts the warm-up ran on.
* ``fluid`` — parity plugin for clusters running Fluid: renders ``Dataset``
  + ``AlluxioRuntime`` CRs (``fluid/fluidcache.go:35-120``) and lets Fluid's
  own controllers produce the PVC.

Copied from ``kubedl_tpu/platform/cache.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import shlex
from typing import Optional

from ..core import meta as m
from ..core.apiserver import AlreadyExists, Conflict, NotFound
from ..core.manager import Reconciler, Request, Result
from .codesync import dest_from_source, gcs_rsync_command


class CacheError(Exception):
    """Permanent cache-config failure; the job engine fails the job on it."""

# status progression (reference cachebackend_types.go / cache_backend consts)
CACHE_CREATING = "CacheCreating"
PVC_CREATING = "PVCCreating"
PVC_CREATED = "PVCCreated"
CACHE_FAILED = "CacheFailed"

ENV_CACHE_NAME = "KUBEDL_CACHE_NAME"
CACHE_VOLUME_NAME = "cachevolume"
API_VERSION = "cache.kubedl.io/v1alpha1"
KIND = "CacheBackend"

DEFAULT_HOST_CACHE_ROOT = "/mnt/stateful_partition/kubedl-cache"
DEFAULT_WARMUP_IMAGE = "google/cloud-sdk:slim"


def get_cache_name(job: dict) -> str:
    return f"{m.name(job)}-cache"


# ---------------------------------------------------------------------------
# engine plugins
# ---------------------------------------------------------------------------

class CacheEngine:
    name = ""

    def __init__(self, api):
        self.api = api

    def create_cache_job(self, cache_backend: dict) -> None:
        raise NotImplementedError

    def _create_owned(self, obj: dict, owner: dict) -> None:
        m.set_controller_ref(obj, owner)
        try:
            self.api.create(obj)
        except AlreadyExists:
            pass


class HostDiskEngine(CacheEngine):
    """hostPath PV/PVC + one-shot GCS warm-up pod on the TPU VM's local disk."""

    name = "hostDisk"

    def create_cache_job(self, cache_backend: dict) -> None:
        name, ns = m.name(cache_backend), m.namespace(cache_backend)
        opts = m.get_in(cache_backend, "spec", "cacheEngine", "hostDisk",
                        default={}) or {}
        root = opts.get("path") or DEFAULT_HOST_CACHE_ROOT
        host_path = f"{root.rstrip('/')}/{ns}/{name}"
        capacity = opts.get("capacity") or "100Gi"
        if self.api.try_get("PersistentVolume", ns, name) is None:
            pv = m.new_obj("v1", "PersistentVolume", name, ns)
            pv["spec"] = {
                "capacity": {"storage": capacity},
                "accessModes": ["ReadOnlyMany"],
                "hostPath": {"path": host_path},
                "persistentVolumeReclaimPolicy": "Delete",
                "storageClassName": "kubedl-host-cache",
            }
            self._create_owned(pv, cache_backend)
        if self.api.try_get("PersistentVolumeClaim", ns, name) is None:
            pvc = m.new_obj("v1", "PersistentVolumeClaim", name, ns)
            pvc["spec"] = {
                "accessModes": ["ReadOnlyMany"],
                "resources": {"requests": {"storage": capacity}},
                "storageClassName": "kubedl-host-cache",
                "volumeName": name,
            }
            self._create_owned(pvc, cache_backend)
        if self.api.try_get("Pod", ns, f"{name}-warmup") is None:
            sources = m.get_in(cache_backend, "spec", "dataset", "dataSources",
                               default=[]) or []
            cmds = []
            for src in sources:
                sub = src.get("subDirName") or dest_from_source(
                    src.get("location", ""), fallback="data")
                dst = f"/cache/{sub}"
                loc = src.get("location", "")
                # locations/dir names are user-controlled spec fields that
                # land in a /bin/sh -c string on a hostPath-mounted pod:
                # quote them
                if loc.startswith("gs://"):
                    cmds.append(gcs_rsync_command(loc, dst))
                else:
                    # non-GCS source: web/nfs fetch left to a custom image
                    cmds.append(f"mkdir -p {shlex.quote(dst)} "
                                f"&& echo skip {shlex.quote(loc)}")
            pod = m.new_obj("v1", "Pod", f"{name}-warmup", ns)
            pod["spec"] = {
                "restartPolicy": "OnFailure",
                "containers": [{
                    "name": "warmup",
                    "image": opts.get("warmupImage") or DEFAULT_WARMUP_IMAGE,
                    "command": ["/bin/sh", "-c", " && ".join(cmds) or "true"],
                    "volumeMounts": [{"name": "cache", "mountPath": "/cache"}],
                }],
                "volumes": [{"name": "cache",
                             "hostPath": {"path": host_path,
                                          "type": "DirectoryOrCreate"}}],
            }
            self._create_owned(pod, cache_backend)


class FluidEngine(CacheEngine):
    """Fluid parity: Dataset + AlluxioRuntime CRs named after the cache
    (``fluidcache.go:35-120``); Fluid's controllers then bind the PVC."""

    name = "fluid"

    def create_cache_job(self, cache_backend: dict) -> None:
        name, ns = m.name(cache_backend), m.namespace(cache_backend)
        if self.api.try_get("Dataset", ns, name) is None:
            mounts = []
            for src in m.get_in(cache_backend, "spec", "dataset", "dataSources",
                                default=[]) or []:
                mounts.append({"mountPoint": src.get("location", ""),
                               "name": src.get("subDirName", "")})
            ds = m.new_obj("data.fluid.io/v1alpha1", "Dataset", name, ns)
            ds["spec"] = {"mounts": mounts}
            self._create_owned(ds, cache_backend)
        fluid_opts = m.get_in(cache_backend, "spec", "cacheEngine", "fluid",
                              default={}) or {}
        runtime_opts = fluid_opts.get("alluxioRuntime")
        if runtime_opts and self.api.try_get("AlluxioRuntime", ns, name) is None:
            levels = [{"mediumtype": lv.get("mediumType", "MEM"),
                       "path": lv.get("cachePath", "/dev/shm"),
                       "quota": lv.get("quota", "1Gi")}
                      for lv in runtime_opts.get("tieredStorage", []) or []]
            rt = m.new_obj("data.fluid.io/v1alpha1", "AlluxioRuntime", name, ns)
            rt["spec"] = {"replicas": runtime_opts.get("replicas", 1),
                          "tieredstore": {"levels": levels}}
            self._create_owned(rt, cache_backend)


ENGINES = {e.name: e for e in (HostDiskEngine, FluidEngine)}


def select_engine(cache_backend: dict) -> Optional[str]:
    engine_spec = m.get_in(cache_backend, "spec", "cacheEngine", default={}) or {}
    for key in engine_spec:
        if key in ENGINES:
            return key
    return None


# ---------------------------------------------------------------------------
# CacheBackend controller
# ---------------------------------------------------------------------------

class CacheBackendReconciler(Reconciler):
    """Drives CacheBackend status to PVCCreated (reference
    ``cachebackend_controller.go:57-133``)."""

    kind = KIND
    owns = ("PersistentVolumeClaim", "Pod")

    def __init__(self, api, recorder=None):
        self.api = api
        self.recorder = recorder

    def reconcile(self, req: Request) -> Optional[Result]:
        cb = self.api.try_get(KIND, req.namespace, req.name)
        if cb is None or m.is_deleting(cb):
            return None
        status = cb.setdefault("status", {})
        if status.get("cacheStatus") == PVC_CREATED:
            return None
        if self.api.try_get("PersistentVolumeClaim", req.namespace,
                            req.name) is not None and self._warmup_done(cb):
            return self._set_status(cb, PVC_CREATED)
        engine_name = select_engine(cb)
        if engine_name is None:
            return self._set_status(cb, CACHE_FAILED)
        ENGINES[engine_name](self.api).create_cache_job(cb)
        if status.get("cacheStatus") != PVC_CREATING:
            return self._set_status(cb, PVC_CREATING, requeue=2.0)
        return Result(requeue_after=2.0)

    def _warmup_done(self, cb: dict) -> bool:
        """hostDisk creates its PVC immediately but data lands via the
        warm-up pod — the cache is ready only once that pod Succeeded, or
        the engine has no warm-up concept (fluid: PVC binding = ready)."""
        warm = self.api.try_get("Pod", m.namespace(cb),
                                f"{m.name(cb)}-warmup")
        if warm is None:
            return True
        return m.get_in(warm, "status", "phase", default="") == "Succeeded"

    def _set_status(self, cb: dict, s: str,
                    requeue: float = 0.0) -> Optional[Result]:
        cb["status"]["cacheStatus"] = s
        try:
            self.api.update_status(cb)
        except (Conflict, NotFound):
            return Result(requeue=True)
        return Result(requeue_after=requeue) if requeue else None


# ---------------------------------------------------------------------------
# job engine integration
# ---------------------------------------------------------------------------

def reconcile_job_cache(api, job: dict, cache_spec: dict, raw_specs: dict,
                        job_status) -> Optional[float]:
    """Create the job's CacheBackend and, once its PVC exists, mount it into
    every replica (reference ``job_controller.go:202-315``). Returns a
    requeue delay while the cache is still warming, else None."""
    name, ns = get_cache_name(job), m.namespace(job)
    cb = api.try_get(KIND, ns, name)
    if cb is None:
        cb = m.new_obj(API_VERSION, KIND, name, ns, spec=dict(cache_spec))
        m.set_controller_ref(cb, job)
        try:
            cb = api.create(cb)
        except AlreadyExists:
            cb = api.get(KIND, ns, name)
        cb["status"] = {"jobName": m.name(job), "cacheStatus": CACHE_CREATING}
        try:
            api.update_status(cb)
        except (Conflict, NotFound):
            pass
    job_status.cache_backend_name = name
    # gate on the controller's readiness verdict, not bare PVC existence:
    # hostDisk binds its PVC before the warm-up rsync finished
    if m.get_in(cb, "status", "cacheStatus", default="") != PVC_CREATED:
        cb = api.get(KIND, ns, name)
        cache_status = m.get_in(cb, "status", "cacheStatus", default="")
        if cache_status == CACHE_FAILED:
            raise CacheError(
                f"cache backend {name} failed: no usable cacheEngine in "
                f"{sorted(m.get_in(cb, 'spec', 'cacheEngine', default={}) or {})}")
        if cache_status != PVC_CREATED:
            return 2.0  # cache warming; hold off pod creation
    mount_path = cache_spec.get("mountPath") or "/dataset"
    for spec in raw_specs.values():
        pod_spec = m.get_in(spec, "template", "spec")
        if not pod_spec or not pod_spec.get("containers"):
            continue
        vols = pod_spec.setdefault("volumes", [])
        if not any(v.get("name") == CACHE_VOLUME_NAME for v in vols):
            vols.append({"name": CACHE_VOLUME_NAME,
                         "persistentVolumeClaim": {"claimName": name}})
        for ctr in pod_spec["containers"]:
            envs = ctr.setdefault("env", [])
            if not any(e.get("name") == ENV_CACHE_NAME for e in envs):
                envs.append({"name": ENV_CACHE_NAME, "value": name})
            mounts = ctr.setdefault("volumeMounts", [])
            if not any(x.get("name") == CACHE_VOLUME_NAME for x in mounts):
                mounts.append({"name": CACHE_VOLUME_NAME,
                               "mountPath": mount_path})
    return None


