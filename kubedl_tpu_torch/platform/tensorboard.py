"""TensorBoard sidecar-jobs.

Behavioral analog of ``pkg/tensorboard/tensorboard.go:55-386``: a job
annotated with ``kubedl.io/tensorboard-config`` (JSON: logDir,
ttlSecondsAfterJobFinished, image, ingressSpec{host,pathPrefix,annotations},
updateTimestamp) gets one TensorBoard pod + headless service + optional
ingress, owned by the job. After the job finishes, the trio lives on for the
configured TTL (profile triage window), then the annotation is stripped and
everything is garbage-collected on the next pass.

TPU twist: the default command serves both scalars and **XProf profiles** —
JAX's ``jax.profiler.start_trace(logdir)`` writes traces under
``<logdir>/plugins/profile``, which stock TensorBoard picks up from the same
``--logdir``, so one config covers loss curves and TPU traces.

Copied from ``kubedl_tpu/platform/tensorboard.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import copy
import json
from typing import Optional

from ..api import common as c
from ..core import meta as m
from ..core.apiserver import AlreadyExists, Conflict, NotFound
from ..tpu import placement as pl
from ..utils import status as st

TB_REPLICA_TYPE = "tensorboard"
TB_PORT = 6006
DEFAULT_TB_IMAGE = "tensorflow/tensorflow:2.9.1"


def get_config(job: dict) -> Optional[dict]:
    cfg = m.annotations(job).get(c.ANNOTATION_TENSORBOARD_CONFIG)
    if cfg is None:
        return None
    try:
        return json.loads(cfg)
    except json.JSONDecodeError:
        return None


def reconcile_tensorboard(api, job: dict, job_status, master_spec: dict,
                          recorder=None, dns_domain: str = "",
                          had_config: bool = True) -> Optional[float]:
    """Sync (or TTL-reap) the job's TensorBoard trio. Returns a
    requeue-after in seconds while waiting out the TTL, else None.
    ``master_spec`` is the replica template the TB pod is derived from
    (node tolerations/volumes follow the master, reference syncPod).
    ``had_config=False`` skips the reap lookups for jobs that never carried
    the annotation (the common case — saves 3 GETs/job/pass)."""
    cfg_raw = m.annotations(job).get(c.ANNOTATION_TENSORBOARD_CONFIG)
    if cfg_raw is None:
        if had_config:
            _delete_all(api, job)
        return None
    opts = get_config(job)
    if opts is None:
        return None  # unparseable config: leave user artifacts alone

    # TTL after job finish (tensorboard.go:99-135): config updates after
    # completion restart the clock so users can re-open a finished job's TB
    if st.is_finished(job_status):
        finished = m.parse_rfc3339(job_status.completion_time)
        updated = m.parse_rfc3339(opts.get("updateTimestamp"))
        if finished is None:
            return None
        base = max(finished, updated or 0.0)
        delete_at = base + float(opts.get("ttlSecondsAfterJobFinished") or 0)
        now = api.now()
        if now >= delete_at:
            fresh = api.try_get(m.kind(job), m.namespace(job), m.name(job))
            if fresh is not None:
                m.annotations(fresh).pop(c.ANNOTATION_TENSORBOARD_CONFIG, None)
                try:
                    api.update(fresh)
                except (Conflict, NotFound):
                    pass
            _delete_all(api, job)
            return None
        _try_sync(api, job, opts, cfg_raw, master_spec, recorder)
        return delete_at - now

    _try_sync(api, job, opts, cfg_raw, master_spec, recorder)
    return None


def _try_sync(api, job, opts, cfg_raw, master_spec, recorder) -> None:
    """An ownership conflict on the TB pod must not wedge the whole job
    reconcile — record it and move on."""
    try:
        _sync(api, job, opts, cfg_raw, master_spec)
    except ValueError as e:
        if recorder is not None:
            recorder.event(job, "Warning", "TensorBoardConflict", str(e))


def tb_resource_name(job_name: str) -> str:
    """Public naming seam: the pod/service/ingress name this subsystem
    gives a job's TensorBoard (the console's status/reapply routes resolve
    the same name)."""
    return pl.replica_name(job_name, TB_REPLICA_TYPE, 0)


def _name(job: dict) -> str:
    return tb_resource_name(m.name(job))


def _labels(job: dict) -> dict:
    return {
        c.LABEL_REPLICA_TYPE: TB_REPLICA_TYPE,
        c.LABEL_REPLICA_INDEX: "0",
        c.LABEL_REPLICA_NAME: _name(job),
        c.LABEL_JOB_NAME: m.name(job),
    }


def _sync(api, job: dict, opts: dict, cfg_raw: str, master_spec: dict) -> None:
    _sync_pod(api, job, opts, cfg_raw, master_spec)
    _sync_service(api, job)
    _sync_ingress(api, job, opts)


def _sync_pod(api, job: dict, opts: dict, cfg_raw: str, master_spec: dict) -> None:
    name = _name(job)
    existing = api.try_get("Pod", m.namespace(job), name)
    if existing is not None:
        ref = m.get_controller_ref(existing)
        if not ref or ref.get("uid") != m.uid(job):
            raise ValueError(f"TensorBoard pod {name} is owned by someone else")
        # config change (ignoring updateTimestamp) -> recreate
        old = None
        try:
            old = json.loads(m.annotations(existing).get(
                c.ANNOTATION_TENSORBOARD_CONFIG, "null"))
        except json.JSONDecodeError:
            pass
        a, b = dict(opts), dict(old or {})
        a.pop("updateTimestamp", None)
        b.pop("updateTimestamp", None)
        if a == b:
            return
        try:
            api.delete("Pod", m.namespace(job), name)
        except NotFound:
            pass

    template = copy.deepcopy(m.get_in(master_spec, "template") or {})
    pod_spec = template.get("spec") or {"containers": [{"name": "tensorboard"}]}
    pod_spec["restartPolicy"] = "Always"
    # the viewer must not inherit trainer-side machinery: injected init
    # containers (code-sync) carry the trainer's TPU resource requests and
    # would pin a TPU host (or pend forever) for a UI pod
    pod_spec.pop("initContainers", None)
    path_prefix = _path_prefix(job, opts)
    containers = pod_spec.get("containers") or [{"name": "tensorboard"}]
    tb = containers[0]
    tb["name"] = "tensorboard"
    tb["command"] = [
        "/bin/sh", "-c",
        f"python -m tensorboard.main --logdir {opts.get('logDir', '/logs')} "
        f"--path_prefix {path_prefix} --host 0.0.0.0 --port {TB_PORT}",
    ]
    if opts.get("image"):
        tb["image"] = opts["image"]
    elif not tb.get("image"):
        tb["image"] = DEFAULT_TB_IMAGE
    # TB is a viewer: drop trainer resources so it never requests TPU chips
    # (the reference strips GPU visibility the same way)
    tb.pop("resources", None)
    pod_spec["containers"] = [tb]
    pod_spec.pop("nodeSelector", None)
    tb["ports"] = [{"name": "tensorboard", "containerPort": TB_PORT}]

    pod = {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {
            "name": name, "namespace": m.namespace(job),
            "labels": {**(template.get("metadata", {}).get("labels") or {}),
                       **_labels(job)},
            "annotations": {c.ANNOTATION_TENSORBOARD_CONFIG: cfg_raw},
        },
        "spec": pod_spec,
    }
    m.set_controller_ref(pod, job)
    try:
        api.create(pod)
    except AlreadyExists:
        pass


def _sync_service(api, job: dict) -> None:
    name = _name(job)
    if api.try_get("Service", m.namespace(job), name) is not None:
        return
    svc = m.new_obj("v1", "Service", name, m.namespace(job), labels=_labels(job))
    svc["spec"] = {
        "clusterIP": "None",
        "selector": _labels(job),
        "ports": [{"name": "tensorboard", "port": TB_PORT,
                   "targetPort": TB_PORT}],
    }
    m.set_controller_ref(svc, job)
    try:
        api.create(svc)
    except AlreadyExists:
        pass


def _path_prefix(job: dict, opts: dict) -> str:
    prefix = (opts.get("ingressSpec") or {}).get("pathPrefix") or ""
    parts = [p for p in prefix.split("/") if p]
    parts += [m.namespace(job), m.name(job)]
    return "/" + "/".join(parts)


def _sync_ingress(api, job: dict, opts: dict) -> None:
    ing_spec = opts.get("ingressSpec")
    if not ing_spec:
        return
    name = _name(job)
    if api.try_get("Ingress", m.namespace(job), name) is not None:
        return
    path = _path_prefix(job, opts)
    rule: dict = {"http": {"paths": [{
        "path": path, "pathType": "Prefix",
        "backend": {"service": {"name": name,
                                "port": {"number": TB_PORT}}},
    }]}}
    if ing_spec.get("host"):
        rule["host"] = ing_spec["host"]
    ing = m.new_obj("networking.k8s.io/v1", "Ingress", name, m.namespace(job),
                    labels=_labels(job),
                    annotations=dict(ing_spec.get("annotations") or {}))
    ing["spec"] = {"rules": [rule]}
    m.set_controller_ref(ing, job)
    try:
        api.create(ing)
    except AlreadyExists:
        pass


def _delete_all(api, job: dict) -> None:
    name = _name(job)
    for kind in ("Pod", "Service", "Ingress"):
        obj = api.try_get(kind, m.namespace(job), name)
        if obj is None:
            continue
        ref = m.get_controller_ref(obj)
        if ref and ref.get("uid") == m.uid(job):
            try:
                api.delete(kind, m.namespace(job), name)
            except NotFound:
                pass
