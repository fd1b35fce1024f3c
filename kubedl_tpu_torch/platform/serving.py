"""Inference serving: the Inference CRD and its controller.

Capability mirror of reference ``controllers/serving`` +
``apis/serving/v1alpha1``: an Inference declares a backend framework and N
*predictors*, each pinned to a ModelVersion; every predictor becomes a
Deployment + Service, and with more than one predictor the controller
renders weighted canary routes (reference: an Istio VirtualService,
``inference_controller.go:216-259``).

TPU-native redesign:

* a ``JAXServing`` framework joins TFServing/Triton — it runs a JAX/PJRT
  server (``python -m kubedl_tpu_torch.serving``) and gets ``PJRT_DEVICE=TPU``;
* an Inference may carry ``spec.tpuPolicy`` with a **single-host** slice
  (e.g. v5e-4): predictor replicas are independent one-host servers, so the
  controller renders chip resources + topology nodeSelectors per replica —
  scaling out serving means more independent slices, not a bigger gang;
* model loading prefers the GCS artifact path (gcsfuse volume straight from
  the bucket) and falls back to the reference's baked-image init-container
  loader for local/NFS-built images.

Copied from ``kubedl_tpu/platform/serving.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from ..api import common as c
from ..core import meta as m
from ..core.apiserver import AlreadyExists, APIServer, Conflict, NotFound
from ..core.manager import Reconciler, Request, Result
from ..tpu import placement as pl
from .models import (DEFAULT_MODEL_PATH_IN_IMAGE, IMAGE_BUILD_SUCCEEDED,
                     MODEL_PATH_ENV)

FRAMEWORK_TF_SERVING = "TFServing"
FRAMEWORK_TRITON = "Triton"
FRAMEWORK_JAX = "JAXServing"

SERVING_API_VERSION = "serving.kubedl.io/v1alpha1"

#: Morphling-style chosen config (serving/autoconfig.py
#: ``MultiConfigResult.to_dict()["best"]`` JSON: batch/quantize/
#: speculativeK/kvBlock/poolBlocks); rendered into every predictor
#: container's env
ANNOTATION_AUTOCONFIG = "serving.kubedl.io/autoconfig"

_ISTIO_GATEWAY = "kubedl-serving-gateway"


def predictor_name(inf: dict, predictor: dict) -> str:
    """``{inference}-{predictor}`` (reference utils.go:25-27)."""
    return f"{m.name(inf)}-{predictor.get('name', '')}"


def predictor_host(inf: dict, predictor: dict) -> str:
    return f"{predictor_name(inf, predictor)}.{m.namespace(inf)}.svc"


def predictor_labels(inf: dict, predictor: dict) -> dict:
    return {c.LABEL_INFERENCE_NAME: m.name(inf),
            c.LABEL_PREDICTOR_NAME: predictor.get("name", "")}


# ---------------------------------------------------------------------------
# Framework setters (reference controllers/serving/framework/)
# ---------------------------------------------------------------------------

def _set_tf_serving(template: dict, mv: Optional[dict], model_path: str) -> None:
    """TFServing: MODEL_BASE_PATH/MODEL_NAME env (tfserving.go:42-55). The
    stock entrypoint loads ${MODEL_BASE_PATH}/${MODEL_NAME}, which equals
    model_path because the default path's last segment is modelName."""
    base = model_path.rsplit("/", 1)[0] if "/" in model_path else model_path
    for ct in m.get_in(template, "spec", "containers", default=[]) or []:
        pl.upsert_env(ct, "MODEL_BASE_PATH", base)
        if mv is not None:
            pl.upsert_env(ct, "MODEL_NAME",
                          m.get_in(mv, "spec", "modelName", default=""))


def _set_triton(template: dict, mv: Optional[dict], model_path: str) -> None:
    """Triton loads a model *repository* directory."""
    repo = model_path.rsplit("/", 1)[0] if "/" in model_path else model_path
    for ct in m.get_in(template, "spec", "containers", default=[]) or []:
        args = ct.setdefault("args", [])
        if not any(a.startswith("--model-repository") for a in args):
            args.append(f"--model-repository={repo}")


def _set_jax_serving(template: dict, mv: Optional[dict], model_path: str) -> None:
    """TPU-native predictor: ``python -m kubedl_tpu_torch.serving`` reading the
    model artifacts from $KUBEDL_MODEL_PATH and the Morphling-chosen
    config from the KUBEDL_SERVING_* env (serving/__main__.py)."""
    for ct in m.get_in(template, "spec", "containers", default=[]) or []:
        pl.upsert_env(ct, "PJRT_DEVICE", "TPU")
        if mv is not None:
            pl.upsert_env(ct, "KUBEDL_MODEL_NAME",
                          m.get_in(mv, "spec", "modelName", default=""))
        if model_path:
            pl.upsert_env(ct, MODEL_PATH_ENV, model_path)
        # the Services render _DEFAULT_PORTS[JAXServing]; the entrypoint
        # must bind the same port or every predict gets conn-refused
        pl.upsert_env(ct, "KUBEDL_SERVING_PORT",
                      _DEFAULT_PORTS[FRAMEWORK_JAX])
        if not ct.get("command") and not ct.get("args"):
            ct["command"] = ["python", "-m", "kubedl_tpu_torch.serving"]


FRAMEWORK_SETTERS = {
    FRAMEWORK_TF_SERVING: _set_tf_serving,
    FRAMEWORK_TRITON: _set_triton,
    FRAMEWORK_JAX: _set_jax_serving,
}

_DEFAULT_PORTS = {
    FRAMEWORK_TF_SERVING: 8080,
    FRAMEWORK_TRITON: 8000,
    FRAMEWORK_JAX: 8000,
}


def compute_traffic_ratios(predictors: list) -> dict:
    """Normalize trafficWeight over predictors to percentages summing to 100
    (reference inference_controller.go:339+). Unweighted specs split evenly;
    remainders go to the first predictors."""
    if not predictors:
        return {}
    weights = [max(0, int(p.get("trafficWeight") or 0)) for p in predictors]
    total = sum(weights)
    if total == 0:
        weights = [1] * len(predictors)
        total = len(predictors)
    pct = [w * 100 // total for w in weights]
    for i in range(100 - sum(pct)):
        pct[i % len(pct)] += 1
    return {p.get("name", ""): pc for p, pc in zip(predictors, pct)}


class InferenceReconciler(Reconciler):
    """Inference → per-predictor Deployment+Service (+ weighted routes)
    (reference ``inference_controller.go:93-145``)."""

    kind = "Inference"
    owns = ("Deployment", "Service", "VirtualService",
            "HorizontalPodAutoscaler")

    def __init__(self, api: APIServer, recorder=None):
        self.api = api
        self.recorder = recorder

    def reconcile(self, req: Request) -> Optional[Result]:
        inf = self.api.try_get(self.kind, req.namespace, req.name)
        if inf is None or m.is_deleting(inf):
            return None

        predictors = m.get_in(inf, "spec", "predictors", default=[]) or []
        status = {"inferenceEndpoint": f"{m.name(inf)}.{req.namespace}.svc",
                  "predictorStatuses": []}

        self._sync_entry_service(inf, predictors)

        requeue = False
        ready = []  # predictors with a live Deployment behind them
        for predictor in predictors:
            try:
                ps = self._sync_predictor(inf, predictor)
            except ValueError as e:
                # permanent spec error (e.g. multi-host tpuPolicy): surface
                # it in status instead of retry-looping forever
                status["failureMessage"] = str(e)
                if self.recorder is not None:
                    self.recorder.event(inf, "Warning", "InvalidInference",
                                        str(e))
                inf["status"] = status
                try:
                    self.api.update_status(inf)
                except (Conflict, NotFound):
                    pass
                return None
            if ps is None:
                requeue = True
                continue
            ready.append((predictor, ps))
            status["predictorStatuses"].append(ps)

        # traffic only ever routes to deployed predictors — a canary still
        # waiting on its image build must not receive (and blackhole) weight
        if len(ready) > 1:
            ratios = compute_traffic_ratios([p for p, _ in ready])
            for predictor, ps in ready:
                ps["trafficPercent"] = ratios.get(predictor.get("name", ""), 0)
            self._sync_traffic_split(inf, [p for p, _ in ready], ratios)
        else:
            # single live predictor: weighted routes would only blackhole
            try:
                self.api.delete("VirtualService", req.namespace, req.name)
            except NotFound:
                pass

        self._prune_removed_predictors(inf, predictors)

        if inf.get("status") != status:
            inf["status"] = status
            try:
                self.api.update_status(inf)
            except (Conflict, NotFound):
                return Result(requeue=True)
        return Result(requeue_after=2.0) if requeue else None

    # ------------------------------------------------------------------

    def _sync_entry_service(self, inf: dict, predictors: list) -> None:
        """Stable user-facing entry Service selecting all predictors of the
        inference (reference inference_controller.go:280-338)."""
        if self.api.try_get("Service", m.namespace(inf), m.name(inf)):
            return
        port = _DEFAULT_PORTS.get(m.get_in(inf, "spec", "framework",
                                           default=""), 8080)
        svc = m.new_obj("v1", "Service", m.name(inf), m.namespace(inf))
        svc["spec"] = {
            "selector": {c.LABEL_INFERENCE_NAME: m.name(inf)},
            "ports": [{"name": "serving", "port": port,
                       "targetPort": port}],
        }
        m.set_controller_ref(svc, inf)
        try:
            self.api.create(svc)
        except AlreadyExists:
            pass

    def _sync_predictor(self, inf: dict, predictor: dict) -> Optional[dict]:
        """Returns the predictor status, or None while gated on the model
        image build (reference inference_controller.go:150-205)."""
        ns = m.namespace(inf)
        mv = None
        if predictor.get("modelVersion"):
            mv = self.api.try_get("ModelVersion", ns, predictor["modelVersion"])
            if mv is None or m.get_in(mv, "status", "imageBuildPhase") \
                    != IMAGE_BUILD_SUCCEEDED:
                return None  # not built yet -> requeue

        name = predictor_name(inf, predictor)
        desired = self._render_deploy_spec(inf, predictor, mv)
        deploy = self.api.try_get("Deployment", ns, name)
        if deploy is None:
            deploy = self._create_predictor_deploy(inf, predictor, desired)
        else:
            if predictor.get("autoScale"):
                # the HPA owns the replica count: adopting the live value
                # keeps this diff from stomping every scale decision
                desired["replicas"] = m.get_in(
                    deploy, "spec", "replicas",
                    default=desired["replicas"])
            if deploy["spec"] != desired:
                # propagate every spec change (template, model version,
                # replicas), not just the replica count
                deploy["spec"] = desired
                try:
                    deploy = self.api.update(deploy)
                except (Conflict, NotFound):
                    pass
        self._ensure_predictor_service(inf, predictor)
        self._sync_autoscaler(inf, predictor)
        return {
            "name": predictor.get("name", ""),
            "replicas": int(m.get_in(deploy, "status", "replicas", default=0)),
            "readyReplicas": int(m.get_in(deploy, "status", "readyReplicas",
                                          default=0)),
            "endpoint": predictor_host(inf, predictor),
        }

    def _render_deploy_spec(self, inf: dict, predictor: dict,
                            mv: Optional[dict]) -> dict:
        import copy as _copy
        template = _copy.deepcopy(predictor.get("template", {}) or {})
        model_path = predictor.get("modelPath") or ""

        if mv is not None:
            if not model_path:
                # last segment must be the model name: TFServing resolves
                # ${MODEL_BASE_PATH}/${MODEL_NAME}
                model_name = (m.get_in(mv, "spec", "modelName", default="")
                              or m.name(mv))
                model_path = f"{DEFAULT_MODEL_PATH_IN_IMAGE}/{model_name}"
            storage = m.get_in(mv, "spec", "storage", default={}) or {}
            if storage.get("gcs"):
                # serve straight off the bucket: no image pull of artifacts
                from .models import provider_for
                gcs_storage = {"gcs": {**storage["gcs"],
                                       "mountPath": model_path}}
                provider_for(gcs_storage).add_model_volume(template, gcs_storage)
            else:
                self._add_model_loader(template, mv, model_path)
            for ct in m.get_in(template, "spec", "containers",
                               default=[]) or []:
                pl.upsert_env(ct, MODEL_PATH_ENV, model_path)

        setter = FRAMEWORK_SETTERS.get(
            m.get_in(inf, "spec", "framework", default=""))
        if setter is not None:
            setter(template, mv, model_path)

        self._apply_autoconfig(inf, template)
        self._apply_tpu_placement(inf, template)

        lbls = predictor_labels(inf, predictor)
        tmeta = template.setdefault("metadata", {})
        tmeta["labels"] = {**(tmeta.get("labels") or {}), **lbls}
        return {
            "replicas": int(predictor.get("replicas") or 1),
            "selector": {"matchLabels": dict(lbls)},
            "template": template,
            "strategy": {"type": "RollingUpdate"},
        }

    def _sync_autoscaler(self, inf: dict, predictor: dict) -> None:
        """``autoScale`` on a predictor renders a real autoscaling/v2
        HPA targeting the predictor Deployment. The reference merely
        stores an ObjectReference to an externally managed autoscaler
        (``apis/serving/v1alpha1/inference_types.go:114-118``); here the
        operator owns the child end to end — removing ``autoScale``
        deletes the HPA, and the Deployment diff adopts the live replica
        count so the two controllers never fight."""
        ns = m.namespace(inf)
        name = predictor_name(inf, predictor)
        spec = predictor.get("autoScale")
        existing = self.api.try_get("HorizontalPodAutoscaler", ns, name)
        if not spec:
            if existing is not None:
                try:
                    self.api.delete("HorizontalPodAutoscaler", ns, name)
                except NotFound:
                    pass
            return
        min_r = int(spec.get("minReplicas") or 1)
        max_r = int(spec.get("maxReplicas") or 0)
        if max_r < max(min_r, 1):
            if self.recorder is not None:
                self.recorder.event(
                    inf, "Warning", "InvalidAutoScale",
                    f"predictor {predictor.get('name', '')}: maxReplicas "
                    f"{max_r} < minReplicas {min_r}; autoscaler removed")
            if existing is not None:
                # a stale HPA would keep scaling with the OLD bounds —
                # worse than no autoscaler while the spec is invalid
                try:
                    self.api.delete("HorizontalPodAutoscaler", ns, name)
                except NotFound:
                    pass
            return
        desired = {
            "scaleTargetRef": {"apiVersion": "apps/v1",
                               "kind": "Deployment", "name": name},
            "minReplicas": min_r,
            "maxReplicas": max_r,
            "metrics": spec.get("metrics") or [{
                "type": "Resource",
                "resource": {"name": "cpu", "target": {
                    "type": "Utilization",
                    "averageUtilization": int(
                        spec.get("targetCPUUtilization") or 80)}}}],
        }
        if existing is None:
            hpa = m.new_obj("autoscaling/v2", "HorizontalPodAutoscaler",
                            name, ns)
            m.labels(hpa).update(predictor_labels(inf, predictor))
            hpa["spec"] = desired
            m.set_controller_ref(hpa, inf)
            try:
                self.api.create(hpa)
            except AlreadyExists:
                pass
        elif existing["spec"] != desired:
            existing["spec"] = desired
            try:
                self.api.update(existing)
            except (Conflict, NotFound):
                pass

    def _create_predictor_deploy(self, inf: dict, predictor: dict,
                                 spec: dict) -> dict:
        deploy = m.new_obj("apps/v1", "Deployment",
                           predictor_name(inf, predictor), m.namespace(inf))
        m.labels(deploy).update(predictor_labels(inf, predictor))
        deploy["spec"] = spec
        m.set_controller_ref(deploy, inf)
        try:
            deploy = self.api.create(deploy)
            if self.recorder is not None:
                self.recorder.event(
                    inf, "Normal", "PredictorDeploymentCreated",
                    f"Deployment {m.name(deploy)} for predictor created, "
                    f"replicas: {deploy['spec']['replicas']}")
        except AlreadyExists:
            deploy = self.api.get("Deployment", m.namespace(inf),
                                  predictor_name(inf, predictor))
        return deploy

    def _apply_autoconfig(self, inf: dict, template: dict) -> None:
        """Render the autoconfig annotation's chosen serving config into
        predictor env (the write-back half of the Morphling loop; the
        search half is ``serving/autoconfig.autoconfigure_multi``, run
        offline or by a prober job against a staging predictor). The env
        keys mirror ``serving.autoconfig.Candidate.to_env`` — kept
        literal here so the operator process never imports the compute
        stack (jax) just to copy three strings."""
        import json as _json
        raw = m.annotations(inf).get(ANNOTATION_AUTOCONFIG, "")
        if not raw:
            return
        try:
            chosen = _json.loads(raw)
            if not isinstance(chosen, dict):
                raise ValueError("not a JSON object")
            spec_k = int(chosen.get("speculativeK", 0) or 0)
            draft = str(chosen.get("draftPath") or "")
            if spec_k > 0 and not draft:
                # a speculative candidate is only servable with a draft
                # model; without one the entrypoint would CrashLoop —
                # degrade to the non-speculative config and say so
                if self.recorder is not None:
                    self.recorder.event(
                        inf, "Warning", "AutoconfigNoDraft",
                        "speculativeK set without draftPath; serving "
                        "without speculative decoding")
                spec_k = 0
            env = {
                "KUBEDL_SERVING_LANES":
                    str(int(chosen.get("batch", 1) or 1)),
                "KUBEDL_SERVING_QUANTIZE": str(chosen.get("quantize") or ""),
                "KUBEDL_SERVING_SPEC_K": str(spec_k),
                # paged-KV geometry (0 = engine defaults): dropping
                # these would silently lose the pool overcommit the
                # candidate was chosen for (and its HBM-budget fit)
                "KUBEDL_SERVING_KV_BLOCK":
                    str(int(chosen.get("kvBlock", 0) or 0)),
                "KUBEDL_SERVING_POOL_BLOCKS":
                    str(int(chosen.get("poolBlocks", 0) or 0)),
            }
            if spec_k > 0:
                env["KUBEDL_SERVING_DRAFT_PATH"] = draft
        except (ValueError, TypeError):
            # bad values (e.g. {"batch": "fast"}) must degrade to a
            # warning event, not a reconcile retry-loop
            if self.recorder is not None:
                self.recorder.event(inf, "Warning", "BadAutoconfig",
                                    "unparseable autoconfig annotation")
            return
        for ct in m.get_in(template, "spec", "containers",
                           default=[]) or []:
            for k, v in env.items():
                pl.upsert_env(ct, k, v)

    def _add_model_loader(self, template: dict, mv: dict,
                          model_path: str) -> None:
        """Init container copying artifacts out of the baked model image
        into a shared emptyDir (reference model.go:27-34, predictor.go:54-85)."""
        spec = template.setdefault("spec", {})
        vols = spec.setdefault("volumes", [])
        if not any(v.get("name") == "kubedl-model-loader" for v in vols):
            vols.append({"name": "kubedl-model-loader", "emptyDir": {}})
        inits = spec.setdefault("initContainers", [])
        if not any(i.get("name") == "kubedl-model-loader" for i in inits):
            inits.append({
                "name": "kubedl-model-loader",
                "image": m.get_in(mv, "status", "image", default=""),
                "command": ["/bin/sh", "-c",
                            f"cp -r {DEFAULT_MODEL_PATH_IN_IMAGE}/* "
                            f"/mnt/kubedl-model/"],
                "volumeMounts": [{"name": "kubedl-model-loader",
                                  "mountPath": "/mnt/kubedl-model/"}],
            })
        for ct in spec.get("containers", []) or []:
            mounts = ct.setdefault("volumeMounts", [])
            if not any(vm.get("name") == "kubedl-model-loader"
                       for vm in mounts):
                mounts.append({"name": "kubedl-model-loader",
                               "mountPath": model_path})

    def _apply_tpu_placement(self, inf: dict, template: dict) -> None:
        """Single-host TPU serving slices: chips + topology nodeSelector per
        replica. Multi-host slices are a training shape; serving scales by
        adding replicas (more independent slices), so reject them loudly."""
        policy = m.get_in(inf, "spec", "tpuPolicy")
        if not policy:
            return
        from ..controllers.interface import TPUPolicy
        spec = TPUPolicy.from_spec(policy).resolve()
        if spec.num_hosts != 1:
            raise ValueError(
                f"inference tpuPolicy must be a single-host slice, got "
                f"{spec.accelerator_type} ({spec.num_hosts} hosts); scale "
                f"serving with predictor replicas instead")
        pod_spec = template.setdefault("spec", {})
        sel = pod_spec.setdefault("nodeSelector", {})
        sel.setdefault(pl.NODE_SELECTOR_ACCELERATOR, spec.gke_accelerator)
        sel.setdefault(pl.NODE_SELECTOR_TOPOLOGY, spec.topology_str)
        for ct in pod_spec.get("containers", []) or []:
            res = ct.setdefault("resources", {})
            for kk in ("limits", "requests"):
                res.setdefault(kk, {})
                res[kk][c.RESOURCE_TPU] = str(spec.chips_per_host)
            pl.upsert_env(ct, "PJRT_DEVICE", "TPU")

    def _ensure_predictor_service(self, inf: dict, predictor: dict) -> None:
        ns = m.namespace(inf)
        name = predictor_name(inf, predictor)
        if self.api.try_get("Service", ns, name):
            return
        port = _DEFAULT_PORTS.get(m.get_in(inf, "spec", "framework",
                                           default=""), 8080)
        svc = m.new_obj("v1", "Service", name, ns)
        svc["spec"] = {
            "selector": predictor_labels(inf, predictor),
            "ports": [{"name": "serving", "port": port, "targetPort": port}],
        }
        m.set_controller_ref(svc, inf)
        try:
            self.api.create(svc)
        except AlreadyExists:
            pass

    def _sync_traffic_split(self, inf: dict, predictors: list,
                            ratios: dict) -> None:
        """Weighted canary routes (reference inference_controller.go:216-259
        renders an Istio VirtualService; same shape here)."""
        vs_spec = {
            "hosts": [f"{m.name(inf)}.*"],
            "gateways": [_ISTIO_GATEWAY],
            "http": [{
                "name": p.get("name", ""),
                "route": [{
                    "destination": {"host": predictor_host(inf, p)},
                    "weight": ratios.get(p.get("name", ""), 0),
                }],
            } for p in predictors],
        }
        existing = self.api.try_get("VirtualService", m.namespace(inf),
                                    m.name(inf))
        if existing is None:
            vs = m.new_obj("networking.istio.io/v1beta1", "VirtualService",
                           m.name(inf), m.namespace(inf), spec=vs_spec)
            m.set_controller_ref(vs, inf)
            try:
                self.api.create(vs)
            except AlreadyExists:
                pass
        elif existing.get("spec") != vs_spec:
            existing["spec"] = vs_spec
            try:
                self.api.update(existing)
            except (Conflict, NotFound):
                pass

    def _prune_removed_predictors(self, inf: dict, predictors: list) -> None:
        """Drop Deployments/Services/HPAs for predictors removed from
        the spec."""
        ns = m.namespace(inf)
        want = {predictor_name(inf, p) for p in predictors} | {m.name(inf)}
        for kind in ("Deployment", "Service", "HorizontalPodAutoscaler"):
            for obj in self.api.list(kind, ns):
                if not m.is_controlled_by(obj, inf):
                    continue
                if m.name(obj) not in want:
                    try:
                        self.api.delete(kind, ns, m.name(obj))
                    except NotFound:
                        pass
