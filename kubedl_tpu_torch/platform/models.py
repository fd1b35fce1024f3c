"""Model registry: Model / ModelVersion CRDs + image build.

The capability mirror of reference ``controllers/model`` +
``apis/model/v1alpha1``: every successful training job can emit a
``ModelVersion``; the controller bakes the exported artifacts into an OCI
image (reference: a **Kaniko** pod, ``modelversion_controller.go:374-457``)
and records it in ``status.image``, so serving simply runs that image.

TPU-native redesign: artifacts on TPU VMs live on **GCS** (that is where
Orbax checkpoints go), so a ``gcs`` storage flavor is first-class here: the
build pod fuse-mounts the bucket at ``/workspace/build`` — no PV/PVC
staging hop. Local host-disk and NFS (Filestore) flavors keep the
reference's PV → PVC → build-pod pipeline
(``modelversion_controller.go:245-330``).

Copied from ``kubedl_tpu/platform/models.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import copy
from typing import Optional

from ..core import meta as m
from ..core.apiserver import APIServer, AlreadyExists, Conflict, NotFound
from ..core.manager import Reconciler, Request, Result

# env key the training container reads to know where to export the model
# (reference apis/model/v1alpha1/modelversion_types.go:24-25)
MODEL_PATH_ENV = "KUBEDL_MODEL_PATH"
# where artifacts land inside the built image (modelversion_types.go:27-28)
DEFAULT_MODEL_PATH_IN_IMAGE = "/kubedl-model"

IMAGE_BUILDING = "ImageBuilding"
IMAGE_BUILD_FAILED = "ImageBuildFailed"
IMAGE_BUILD_SUCCEEDED = "ImageBuildSucceeded"

MODEL_API_VERSION = "model.kubedl.io/v1alpha1"
DEFAULT_IMAGE_BUILDER = "gcr.io/kaniko-project/executor:latest"


# ---------------------------------------------------------------------------
# Storage providers (reference controllers/model/storage/storage_provider.go)
# ---------------------------------------------------------------------------

class StorageProvider:
    """Where model artifacts live while being trained and built."""

    def create_persistent_volume(self, storage: dict, pv_name: str) -> Optional[dict]:
        """PV staging the artifacts for the build pod; None = not needed."""
        return None

    def add_model_volume(self, pod_template: dict, storage: dict) -> None:
        """Mount the artifact location into every container of a pod."""
        raise NotImplementedError

    def mount_path(self, storage: dict) -> str:
        raise NotImplementedError

    def build_volume(self, storage: dict, mv: dict) -> dict:
        """Volume the build pod mounts at ``/workspace/build`` so the shared
        dockerfile's ``COPY build/`` sees the artifacts. Local/NFS flavors
        stage through the PVC; GCS fuse-mounts the bucket directly."""
        return {"name": "build-source",
                "persistentVolumeClaim": {"claimName": pvc_name_for(mv)}}

    def needs_pvc(self) -> bool:
        return True


def _mount_all_containers(pod_template: dict, volume: dict, mount_path: str) -> None:
    spec = pod_template.setdefault("spec", {})
    vols = spec.setdefault("volumes", [])
    if not any(v.get("name") == volume["name"] for v in vols):
        vols.append(volume)
    for container in spec.get("containers", []) or []:
        mounts = container.setdefault("volumeMounts", [])
        if not any(vm.get("name") == volume["name"] for vm in mounts):
            mounts.append({"name": volume["name"], "mountPath": mount_path})


class LocalStorageProvider(StorageProvider):
    """TPU-VM host disk (reference local_storage_provider.go): hostPath
    volume pinned to one node via PV node affinity."""

    def create_persistent_volume(self, storage, pv_name):
        ls = storage["localStorage"]
        return {
            "apiVersion": "v1", "kind": "PersistentVolume",
            "metadata": {"name": pv_name},
            "spec": {
                "accessModes": ["ReadWriteMany"],
                "persistentVolumeReclaimPolicy": "Retain",
                "capacity": {"storage": "500Mi"},
                "storageClassName": "",
                "local": {"path": ls["path"]},
                "nodeAffinity": {"required": {"nodeSelectorTerms": [{
                    "matchExpressions": [{
                        "key": "kubernetes.io/hostname",
                        "operator": "In",
                        "values": [ls.get("nodeName", "")],
                    }]}]}},
            },
        }

    def add_model_volume(self, pod_template, storage):
        ls = storage["localStorage"]
        _mount_all_containers(
            pod_template,
            {"name": "modelvolume", "hostPath": {"path": ls["path"]}},
            self.mount_path(storage))

    def mount_path(self, storage):
        return storage["localStorage"].get("mountPath") or DEFAULT_MODEL_PATH_IN_IMAGE


class NFSProvider(StorageProvider):
    """NFS / GCP Filestore (reference nfs_provider.go)."""

    def create_persistent_volume(self, storage, pv_name):
        nfs = storage["nfs"]
        return {
            "apiVersion": "v1", "kind": "PersistentVolume",
            "metadata": {"name": pv_name},
            "spec": {
                "accessModes": ["ReadWriteMany"],
                "persistentVolumeReclaimPolicy": "Retain",
                "capacity": {"storage": "30Gi"},
                "storageClassName": "",
                "nfs": {"server": nfs.get("server", ""),
                        "path": nfs.get("path", "/")},
            },
        }

    def add_model_volume(self, pod_template, storage):
        nfs = storage["nfs"]
        _mount_all_containers(
            pod_template,
            {"name": "modelvolume",
             "nfs": {"server": nfs.get("server", ""), "path": nfs.get("path", "/")}},
            self.mount_path(storage))

    def mount_path(self, storage):
        return storage["nfs"].get("mountPath") or DEFAULT_MODEL_PATH_IN_IMAGE


class GCSProvider(StorageProvider):
    """TPU-native primary flavor: artifacts on GCS (where Orbax checkpoints
    land), mounted through the GKE gcsfuse CSI driver for both training and
    the build pod — no PV/PVC staging copy."""

    @staticmethod
    def _fuse_volume(name: str, gcs: dict) -> dict:
        """gcsfuse CSI volume scoped to gcs.path via only-dir, so training,
        build, and serving all see the same directory."""
        attrs = {"bucketName": gcs.get("bucket", "")}
        path = (gcs.get("path") or "").strip("/")
        opts = "implicit-dirs"
        if path:
            opts += f",only-dir={path}"
        attrs["mountOptions"] = opts
        return {"name": name,
                "csi": {"driver": "gcsfuse.csi.storage.gke.io",
                        "volumeAttributes": attrs}}

    def add_model_volume(self, pod_template, storage):
        gcs = storage["gcs"]
        md = pod_template.setdefault("metadata", {})
        ann = md.setdefault("annotations", {})
        ann.setdefault("gke-gcsfuse/volumes", "true")
        _mount_all_containers(pod_template,
                              self._fuse_volume("modelvolume", gcs),
                              self.mount_path(storage))

    def mount_path(self, storage):
        return storage["gcs"].get("mountPath") or DEFAULT_MODEL_PATH_IN_IMAGE

    def build_volume(self, storage, mv):
        return self._fuse_volume("build-source", storage["gcs"])

    def needs_pvc(self) -> bool:
        return False


_PROVIDERS = {
    "localStorage": LocalStorageProvider(),
    "nfs": NFSProvider(),
    "gcs": GCSProvider(),
}


def provider_for(storage: Optional[dict]) -> Optional[StorageProvider]:
    """Pick by which storage flavor is set (storage_provider.go:27-39)."""
    for key, provider in _PROVIDERS.items():
        if storage and storage.get(key) is not None:
            return provider
    return None


def add_model_path_env(replicas_raw: dict, mv_spec: dict) -> None:
    """Inject ``KUBEDL_MODEL_PATH`` + the artifact volume into every replica
    template of a job carrying ``spec.modelVersion`` (reference
    ``pkg/job_controller/job.go:471-498``). Idempotent."""
    provider = provider_for(mv_spec.get("storage"))
    if provider is None:
        return
    path = provider.mount_path(mv_spec["storage"])
    for spec in replicas_raw.values():
        template = spec.setdefault("template", {})
        for container in m.get_in(template, "spec", "containers", default=[]) or []:
            env = container.setdefault("env", [])
            if not any(e.get("name") == MODEL_PATH_ENV for e in env):
                env.append({"name": MODEL_PATH_ENV, "value": path})
        provider.add_model_volume(template, mv_spec["storage"])


# ---------------------------------------------------------------------------
# ModelVersion controller
# ---------------------------------------------------------------------------

def pv_name_for(mv: dict) -> str:
    return f"mv-pv-{m.name(mv)}"


def pvc_name_for(mv: dict) -> str:
    return f"mv-pvc-{m.name(mv)}"


def build_pod_name_for(mv: dict) -> str:
    return f"image-build-{m.name(mv)}"


class ModelVersionReconciler(Reconciler):
    """ModelVersion → image-build pod → status.image
    (reference ``controllers/model/modelversion_controller.go:67-225``)."""

    kind = "ModelVersion"
    owns = ("Pod",)

    def __init__(self, api: APIServer, recorder=None,
                 image_builder: str = DEFAULT_IMAGE_BUILDER):
        self.api = api
        self.recorder = recorder
        self.image_builder = image_builder

    def reconcile(self, req: Request) -> Optional[Result]:
        mv = self.api.try_get(self.kind, req.namespace, req.name)
        if mv is None or m.is_deleting(mv):
            return None
        phase = m.get_in(mv, "status", "imageBuildPhase")
        if phase in (IMAGE_BUILD_SUCCEEDED, IMAGE_BUILD_FAILED):
            return None

        spec = mv.get("spec", {})
        storage = spec.get("storage")
        provider = provider_for(storage)
        if provider is None:
            # permanent config error: fail before creating any side objects
            self._set_status(mv, IMAGE_BUILD_FAILED,
                             message="modelVersion has no recognized storage "
                                     "(gcs/localStorage/nfs)")
            return None

        model = self._ensure_model(mv)
        self._own_by_model(mv, model)

        tag = spec.get("imageTag") or m.uid(mv)[:5]
        image = f"{spec.get('imageRepo', '')}:{tag}"

        pod = self.api.try_get("Pod", req.namespace, build_pod_name_for(mv))
        if pod is None:
            self._ensure_dockerfile_configmap(req.namespace)
            if provider.needs_pvc():
                self._ensure_pv_and_pvc(mv, storage, provider)
            pod = self._create_build_pod(mv, image,
                                         provider.build_volume(storage, mv))
            self._set_status(mv, IMAGE_BUILDING,
                             message=f"building image {image}")
            return None

        pod_phase = m.get_in(pod, "status", "phase")
        if pod_phase == "Succeeded":
            # Model.status.latestVersion follows via the ModelReconciler,
            # which this status MODIFIED event reaches through the Model
            # owner ref added in _own_by_model
            self._set_status(mv, IMAGE_BUILD_SUCCEEDED, image=image,
                             finished=True)
        elif pod_phase == "Failed":
            msg = m.get_in(pod, "status", "message",
                           default="image build pod failed")
            self._set_status(mv, IMAGE_BUILD_FAILED, message=msg,
                             finished=True)
        else:
            self._set_status(mv, IMAGE_BUILDING,
                             message=f"building image {image}")
        return None

    # -- pieces -----------------------------------------------------------

    def _ensure_model(self, mv: dict) -> dict:
        """Create the parent Model on first version (utils.go analog).
        When the version omits modelName, the Model is named after the
        version and the name is written back so the ModelReconciler's
        version filter matches it later."""
        model_name = m.get_in(mv, "spec", "modelName", default="")
        if not model_name:
            model_name = m.name(mv)
            mv.setdefault("spec", {})["modelName"] = model_name
            try:
                updated = self.api.update(mv)
                mv.clear()
                mv.update(updated)
            except (Conflict, NotFound):
                pass
        model = self.api.try_get("Model", m.namespace(mv), model_name)
        if model is None:
            model = m.new_obj(MODEL_API_VERSION, "Model", model_name,
                              m.namespace(mv), spec={})
            try:
                model = self.api.create(model)
            except AlreadyExists:
                model = self.api.get("Model", m.namespace(mv), model_name)
        return model

    def _own_by_model(self, mv: dict, model: dict) -> None:
        """Model owns its versions so deleting a Model GCs them
        (modelversion_controller.go:351-377). A job-created version keeps
        the job as controller owner; the Model is appended as an extra
        owner, exactly like the reference."""
        refs = m.owner_references(mv)
        if any(r.get("uid") == m.uid(model) for r in refs):
            return
        if m.get_controller_ref(mv):
            refs.append(m.owner_ref(model, controller=False))
        else:
            m.set_controller_ref(mv, model)
        try:
            self.api.update(mv)
        except (Conflict, NotFound):
            pass

    def _ensure_dockerfile_configmap(self, namespace: str) -> None:
        if self.api.try_get("ConfigMap", namespace, "dockerfile") is not None:
            return
        cm = m.new_obj("v1", "ConfigMap", "dockerfile", namespace)
        cm["data"] = {
            "dockerfile": ("FROM busybox\n"
                           f"COPY build/ {DEFAULT_MODEL_PATH_IN_IMAGE}\n"),
        }
        try:
            self.api.create(cm)
        except AlreadyExists:
            pass

    def _ensure_pv_and_pvc(self, mv: dict, storage: dict,
                           provider: StorageProvider) -> None:
        ns = m.namespace(mv)
        pv_name, pvc_name = pv_name_for(mv), pvc_name_for(mv)
        if self.api.try_get("PersistentVolume", "default", pv_name) is None:
            pv = provider.create_persistent_volume(storage, pv_name)
            if pv is not None:
                pv.setdefault("metadata", {}).setdefault("namespace", "default")
                try:
                    self.api.create(pv)
                except AlreadyExists:
                    pass
        if self.api.try_get("PersistentVolumeClaim", ns, pvc_name) is None:
            pvc = m.new_obj("v1", "PersistentVolumeClaim", pvc_name, ns)
            pvc["spec"] = {
                "accessModes": ["ReadWriteMany"],
                "storageClassName": "",
                "volumeName": pv_name,
                "resources": {"requests": {"storage": "500Mi"}},
            }
            m.set_controller_ref(pvc, mv)
            try:
                self.api.create(pvc)
            except AlreadyExists:
                pass

    def _create_build_pod(self, mv: dict, image: str,
                          build_volume: dict) -> dict:
        """The Kaniko-analog builder pod (modelversion_controller.go:374-457).
        The artifact source is always mounted at ``/workspace/build`` so the
        shared dockerfile's ``COPY build/`` works for every flavor."""
        ns = m.namespace(mv)
        pod = m.new_obj("v1", "Pod", build_pod_name_for(mv), ns)
        container = {
            "name": "image-build",
            "image": self.image_builder,
            "args": ["--dockerfile=/workspace/dockerfile",
                     "--context=dir:///workspace/",
                     f"--destination={image}"],
            "volumeMounts": [
                {"name": "kaniko-secret", "mountPath": "/kaniko/.docker"},
                {"name": "dockerfile", "mountPath": "/workspace/"},
                {"name": "build-source", "mountPath": "/workspace/build"},
            ],
        }
        volumes = [
            {"name": "kaniko-secret",
             "secret": {"secretName": "regcred",
                        "items": [{"key": ".dockerconfigjson",
                                   "path": "config.json"}]}},
            {"name": "dockerfile",
             "configMap": {"name": "dockerfile"}},
            build_volume,
        ]
        if build_volume.get("csi", {}).get("driver", "").startswith("gcsfuse"):
            m.annotations(pod)["gke-gcsfuse/volumes"] = "true"
        pod["spec"] = {"restartPolicy": "Never",
                       "containers": [container], "volumes": volumes}
        m.set_controller_ref(pod, mv)
        try:
            return self.api.create(pod)
        except AlreadyExists:
            return self.api.get("Pod", ns, m.name(pod))

    def _set_status(self, mv: dict, phase: str, image: str = "",
                    message: str = "", finished: bool = False) -> None:
        status = dict(mv.get("status", {}) or {})
        new = {"imageBuildPhase": phase}
        if image:
            new["image"] = image
        if message:
            new["message"] = message
        if finished and not status.get("finishTime"):
            new["finishTime"] = m.rfc3339(self.api.now())
        if all(status.get(k) == v for k, v in new.items()):
            return
        if self.recorder is not None and status.get("imageBuildPhase") != phase:
            event_type = ("Warning" if phase == IMAGE_BUILD_FAILED
                          else "Normal")
            self.recorder.event(mv, event_type, phase,
                                message or f"image build {phase}")
        status.update(new)
        mv["status"] = status
        try:
            self.api.update_status(mv)
        except (Conflict, NotFound):
            pass


class ModelReconciler(Reconciler):
    """Keeps ``Model.status.latestVersion`` honest when versions come and go
    (the reference folds this into the ModelVersion controller; a dedicated
    reconciler also heals after out-of-band version deletion)."""

    kind = "Model"
    owns = ("ModelVersion",)

    def __init__(self, api: APIServer):
        self.api = api

    def reconcile(self, req: Request) -> Optional[Result]:
        model = self.api.try_get(self.kind, req.namespace, req.name)
        if model is None or m.is_deleting(model):
            return None
        versions = [
            v for v in self.api.list("ModelVersion", req.namespace)
            if (m.get_in(v, "spec", "modelName") == req.name
                or m.is_controlled_by(v, model))
            and m.get_in(v, "status", "imageBuildPhase") == IMAGE_BUILD_SUCCEEDED
        ]
        if not versions:
            latest = None
        else:
            newest = max(versions,
                         key=lambda v: (m.get_in(v, "status", "finishTime",
                                                 default="") or "",
                                        m.name(v)))
            latest = {"modelVersion": m.name(newest),
                      "imageName": m.get_in(newest, "status", "image",
                                            default="")}
        if m.get_in(model, "status", "latestVersion") == latest:
            return None
        status = model.setdefault("status", {})
        if latest is None:
            status.pop("latestVersion", None)
        else:
            status["latestVersion"] = latest
        try:
            self.api.update_status(model)
        except (Conflict, NotFound):
            pass
        return None


def build_model_version_spec(job: dict, mv_spec: dict, pods=()) -> dict:
    """Normalize a job's ``spec.modelVersion`` into a ModelVersion spec.

    For localStorage, the node that actually holds the artifacts is the one
    the master/chief ran on — resolved from the job's pods like the
    reference's ``GetNodeForModelOutput`` (``job.go:525-529``) — so the PV's
    node affinity pins the build pod to the right host."""
    spec = copy.deepcopy(mv_spec)
    spec.setdefault("createdBy", m.name(job))
    spec.setdefault("modelName", m.name(job))
    ls = m.get_in(spec, "storage", "localStorage")
    if ls is not None and not ls.get("nodeName"):
        node = node_for_model_output(pods)
        if node:
            ls["nodeName"] = node
    return spec


def node_for_model_output(pods) -> str:
    """The node of the master/chief pod, else worker-0's, else any index-0
    replica's — the rank that conventionally exports the model (reference
    ``GetNodeForModelOutput``)."""
    from ..api import common as c
    worker0, any0 = "", ""
    for pod in pods:
        lbls = m.get_labels(pod)
        node = m.get_in(pod, "spec", "nodeName", default="")
        if not node or lbls.get(c.LABEL_REPLICA_INDEX) != "0":
            continue
        rtype = lbls.get(c.LABEL_REPLICA_TYPE, "").lower()
        if rtype in ("master", "chief"):
            return node
        if rtype == "worker" and not worker0:
            worker0 = node
        if not any0:
            any0 = node
    return worker0 or any0
