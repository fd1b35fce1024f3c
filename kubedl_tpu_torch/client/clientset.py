"""Clientset: typed per-kind resource clients.

Mirrors the reference's generated clientset
(``client/clientset/versioned/typed/training/v1alpha1``): one client per
kind with Create/Get/List/Update/UpdateStatus/Patch/Delete/Watch, grouped
by API group the way ``versioned.Interface`` groups them
(``TrainingV1alpha1()``, etc.).

Copied from ``kubedl_tpu/client/clientset.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Optional

from ..core import meta as m
from ..core.apiserver import APIServer


@dataclass(frozen=True)
class ResourceInfo:
    kind: str
    api_version: str
    plural: str
    namespaced: bool = True


#: every kind the operator serves (the 13 CRDs of config/crd/bases plus the
#: core-group objects the engine manages on the in-memory control plane)
KIND_TABLE = {
    # training.kubedl.io (reference client/ covers exactly this group)
    "TFJob": ResourceInfo("TFJob", "training.kubedl.io/v1alpha1", "tfjobs"),
    "PyTorchJob": ResourceInfo("PyTorchJob", "training.kubedl.io/v1alpha1", "pytorchjobs"),
    "JAXJob": ResourceInfo("JAXJob", "training.kubedl.io/v1alpha1", "jaxjobs"),
    "MPIJob": ResourceInfo("MPIJob", "training.kubedl.io/v1alpha1", "mpijobs"),
    "XGBoostJob": ResourceInfo("XGBoostJob", "training.kubedl.io/v1alpha1", "xgboostjobs"),
    "XDLJob": ResourceInfo("XDLJob", "training.kubedl.io/v1alpha1", "xdljobs"),
    "MarsJob": ResourceInfo("MarsJob", "training.kubedl.io/v1alpha1", "marsjobs"),
    "ElasticDLJob": ResourceInfo("ElasticDLJob", "training.kubedl.io/v1alpha1", "elasticdljobs"),
    "RLJob": ResourceInfo("RLJob", "training.kubedl.io/v1alpha1", "rljobs"),
    # platform groups
    "Model": ResourceInfo("Model", "model.kubedl.io/v1alpha1", "models"),
    "ModelVersion": ResourceInfo("ModelVersion", "model.kubedl.io/v1alpha1", "modelversions"),
    "Inference": ResourceInfo("Inference", "serving.kubedl.io/v1alpha1", "inferences"),
    "Notebook": ResourceInfo("Notebook", "notebook.kubedl.io/v1alpha1", "notebooks"),
    "CacheBackend": ResourceInfo("CacheBackend", "cache.kubedl.io/v1alpha1", "cachebackends"),
    "Cron": ResourceInfo("Cron", "apps.kubedl.io/v1alpha1", "crons"),
    # core/scheduling substrate
    "Pod": ResourceInfo("Pod", "v1", "pods"),
    "Service": ResourceInfo("Service", "v1", "services"),
    "Event": ResourceInfo("Event", "v1", "events"),
    "ConfigMap": ResourceInfo("ConfigMap", "v1", "configmaps"),
    "PersistentVolumeClaim": ResourceInfo("PersistentVolumeClaim", "v1", "persistentvolumeclaims"),
    "Deployment": ResourceInfo("Deployment", "apps/v1", "deployments"),
    "Ingress": ResourceInfo("Ingress", "networking.k8s.io/v1", "ingresses"),
    "PodGroup": ResourceInfo("PodGroup", "scheduling.sigs.k8s.io/v1alpha1", "podgroups"),
    # slice-scheduler tenancy quota (docs/scheduling.md)
    "Queue": ResourceInfo("Queue", "scheduling.kubedl.io/v1alpha1", "queues",
                          namespaced=False),
    # fleet telemetry: persisted per-(profile, pool) throughput estimates
    # (docs/telemetry.md)
    "ThroughputProfile": ResourceInfo(
        "ThroughputProfile", "telemetry.kubedl.io/v1alpha1",
        "throughputprofiles", namespaced=False),
    # SLO engine: declared objectives over fleet signals (docs/slo.md)
    "SLO": ResourceInfo("SLO", "slo.kubedl.io/v1alpha1", "slos",
                        namespaced=False),
}

TRAINING_KINDS = tuple(k for k, v in KIND_TABLE.items()
                       if v.api_version.startswith("training.kubedl.io"))


def plural_to_kind(plural: str) -> Optional[str]:
    for kind, info in KIND_TABLE.items():
        if info.plural == plural:
            return kind
    return None


class ResourceClient:
    """Typed client for one kind (the generated ``tfJobs`` interface shape:
    Create/Update/UpdateStatus/Delete/Get/List/Watch/Patch)."""

    def __init__(self, api: APIServer, info: ResourceInfo,
                 namespace: Optional[str] = None):
        self.api = api
        self.info = info
        self.namespace = namespace

    def _ns(self, namespace: Optional[str]) -> str:
        return namespace or self.namespace or "default"

    def create(self, obj: dict, namespace: Optional[str] = None) -> dict:
        obj = copy.deepcopy(obj)  # never mutate the caller's manifest
        obj.setdefault("apiVersion", self.info.api_version)
        obj.setdefault("kind", self.info.kind)
        target_ns = self._ns(namespace)
        obj_ns = m.meta(obj).get("namespace")
        if obj_ns and (namespace or self.namespace) and obj_ns != target_ns:
            # client-go rejects a request-namespace/object-namespace mismatch
            raise ValueError(
                f"object namespace {obj_ns!r} conflicts with request "
                f"namespace {target_ns!r}")
        m.meta(obj).setdefault("namespace", target_ns)
        return self.api.create(obj)

    def get(self, name: str, namespace: Optional[str] = None) -> dict:
        return self.api.get(self.info.kind, self._ns(namespace), name)

    def try_get(self, name: str, namespace: Optional[str] = None) -> Optional[dict]:
        return self.api.try_get(self.info.kind, self._ns(namespace), name)

    def list(self, namespace: Optional[str] = None,
             selector: Optional[dict] = None,
             all_namespaces: bool = False) -> list:
        ns = None if all_namespaces else self._ns(namespace)
        return self.api.list(self.info.kind, ns, selector)

    def update(self, obj: dict) -> dict:
        return self.api.update(obj)

    def update_status(self, obj: dict) -> dict:
        return self.api.update_status(obj)

    def patch(self, name: str, patch: dict,
              namespace: Optional[str] = None) -> dict:
        return self.api.patch_merge(self.info.kind, self._ns(namespace),
                                    name, patch)

    def delete(self, name: str, namespace: Optional[str] = None) -> None:
        self.api.delete(self.info.kind, self._ns(namespace), name)

    def watch(self, fn: Callable[[str, dict], None]) -> Callable[[], None]:
        """Subscribe to this kind's events only; returns unsubscribe fn."""
        kind = self.info.kind

        def filtered(event_type: str, obj: dict):
            if m.kind(obj) == kind:
                fn(event_type, obj)
        return self.api.watch(filtered)


class _Group:
    """One API group's typed accessors (``TrainingV1alpha1Interface``)."""

    def __init__(self, api: APIServer, kinds: list[str]):
        self._api = api
        self._kinds = kinds
        for kind in kinds:
            info = KIND_TABLE[kind]
            setattr(self, info.plural, ResourceClient(api, info))

    def __iter__(self):
        return iter(self._kinds)


class Clientset:
    """The ``versioned.Interface`` analog: one handle exposing every group.

    >>> cs = Clientset(api)
    >>> cs.training.tfjobs.create({...})
    >>> cs.kind("PyTorchJob").list(all_namespaces=True)
    """

    def __init__(self, api: APIServer):
        self.api = api
        by_group: dict[str, list[str]] = {}
        for kind, info in KIND_TABLE.items():
            group = info.api_version.split("/")[0]
            alias = {
                "training.kubedl.io": "training",
                "model.kubedl.io": "model",
                "serving.kubedl.io": "serving",
                "notebook.kubedl.io": "notebook",
                "cache.kubedl.io": "cache",
                "apps.kubedl.io": "apps",
                "v1": "core",
                "apps": "k8s_apps",
                "networking.k8s.io": "networking",
                "scheduling.sigs.k8s.io": "scheduling",
                "slo.kubedl.io": "slo",
            }.get(group, group.replace(".", "_"))
            by_group.setdefault(alias, []).append(kind)
        for alias, kinds in by_group.items():
            setattr(self, alias, _Group(api, kinds))

    def kind(self, kind: str, namespace: Optional[str] = None) -> ResourceClient:
        """Dynamic accessor by kind name (the ``dynamic.Interface`` analog)."""
        if kind not in KIND_TABLE:
            raise KeyError(f"unknown kind {kind!r}; known: {sorted(KIND_TABLE)}")
        return ResourceClient(self.api, KIND_TABLE[kind], namespace)
