"""Notebook controller: Notebook CRD → pod + service + ingress.

Behavioral analog of ``controllers/notebook/notebook_controller.go:71-340``:
the CR carries a pod template; the controller runs it as ``nb-{name}`` with
the Jupyter port defaulted, fronts it with a service and an ingress at
``/notebooks/{ns}/{name}``, mirrors the pod phase into the Notebook
condition (Created/Running/Terminated), and publishes the reachable URL —
with the auth token passed through from the template env so the link works
first click.

TPU twist: a notebook template that requests ``google.com/tpu`` gets the
PJRT single-host env (one-process JAX on the notebook's own slice) so
``jax.devices()`` works out of the box.

Copied from ``kubedl_tpu/platform/notebook.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from ..api import common as c
from ..core import meta as m
from ..core.apiserver import AlreadyExists, Conflict, NotFound
from ..core.manager import Reconciler, Request, Result
from ..tpu import placement as pl

KIND = "Notebook"
API_VERSION = "notebook.kubedl.io/v1alpha1"
CONTAINER_NAME = "notebook"
PORT_NAME = "notebook"
DEFAULT_PORT = 8888

COND_CREATED = "Created"
COND_RUNNING = "Running"
COND_TERMINATED = "Terminated"


def nb_name(notebook_name: str) -> str:
    return "nb-" + notebook_name


def ingress_path(notebook: dict) -> str:
    return f"/notebooks/{m.namespace(notebook)}/{m.name(notebook)}"


class NotebookReconciler(Reconciler):
    kind = KIND
    owns = ("Pod", "Service", "Ingress")

    def __init__(self, api, recorder=None):
        self.api = api
        self.recorder = recorder

    def reconcile(self, req: Request) -> Optional[Result]:
        nb = self.api.try_get(KIND, req.namespace, req.name)
        if nb is None or m.is_deleting(nb):
            return None
        pod = self._sync_pod(nb)
        self._sync_service(nb)
        self._sync_ingress(nb)
        return self._update_status(nb, pod)

    # -- children ---------------------------------------------------------

    def _sync_pod(self, nb: dict) -> dict:
        name, ns = nb_name(m.name(nb)), m.namespace(nb)
        pod = self.api.try_get("Pod", ns, name)
        if pod is not None:
            return pod
        import copy
        template = copy.deepcopy(m.get_in(nb, "spec", "template") or {})
        pod_spec = template.get("spec") or {}
        containers = pod_spec.setdefault("containers", [])
        if not containers:
            containers.append({"name": CONTAINER_NAME,
                               "image": "jupyter/base-notebook:latest"})
        ctr = _main_container(pod_spec)
        ports = ctr.setdefault("ports", [])
        if not any(p.get("name") == PORT_NAME for p in ports):
            ports.append({"name": PORT_NAME, "containerPort": DEFAULT_PORT})
        # jupyter must serve under the ingress path or every redirect 404s
        pl.upsert_env(ctr, "NOTEBOOK_ARGS",
                      f"--NotebookApp.base_url={ingress_path(nb)}")
        # TPU twist: a template requesting chips gets single-host PJRT env
        # so jax.devices() in the notebook finds its slice out of the box
        res = ctr.get("resources") or {}
        if any("google.com/tpu" in (res.get(k) or {})
               for k in ("limits", "requests")):
            pl.upsert_env(ctr, pl.ENV_TPU_WORKER_ID, 0)
            pl.upsert_env(ctr, pl.ENV_TPU_WORKER_HOSTNAMES, "localhost")
        pod = {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {
                "name": name, "namespace": ns,
                "labels": {**(template.get("metadata", {}).get("labels") or {}),
                           c.LABEL_JOB_NAME: m.name(nb),
                           c.LABEL_REPLICA_TYPE: "notebook"},
            },
            "spec": pod_spec,
        }
        m.set_controller_ref(pod, nb)
        try:
            self.api.create(pod)
        except AlreadyExists:
            pass
        return self.api.get("Pod", ns, name)

    def _sync_service(self, nb: dict) -> None:
        name, ns = nb_name(m.name(nb)), m.namespace(nb)
        if self.api.try_get("Service", ns, name) is not None:
            return
        sel = {c.LABEL_JOB_NAME: m.name(nb), c.LABEL_REPLICA_TYPE: "notebook"}
        svc = m.new_obj("v1", "Service", name, ns, labels=sel)
        svc["spec"] = {
            "selector": sel,
            "ports": [{"name": PORT_NAME, "port": DEFAULT_PORT,
                       "targetPort": PORT_NAME}],
        }
        m.set_controller_ref(svc, nb)
        try:
            self.api.create(svc)
        except AlreadyExists:
            pass

    def _sync_ingress(self, nb: dict) -> None:
        name, ns = nb_name(m.name(nb)), m.namespace(nb)
        if self.api.try_get("Ingress", ns, name) is not None:
            return
        ing = m.new_obj("networking.k8s.io/v1", "Ingress", name, ns)
        ing["spec"] = {"rules": [{"http": {"paths": [{
            "path": ingress_path(nb), "pathType": "Prefix",
            "backend": {"service": {"name": name,
                                    "port": {"number": DEFAULT_PORT}}},
        }]}}]}
        m.set_controller_ref(ing, nb)
        try:
            self.api.create(ing)
        except AlreadyExists:
            pass

    # -- status -----------------------------------------------------------

    def _update_status(self, nb: dict, pod: dict) -> Optional[Result]:
        phase = m.get_in(pod, "status", "phase", default="Pending")
        cond, msg, requeue = COND_CREATED, f"created notebook pod {m.name(pod)}", True
        if phase == "Running":
            cond, msg, requeue = (COND_RUNNING,
                                  f"notebook pod {m.name(pod)} is running", False)
        elif phase in ("Failed", "Succeeded"):
            cond, msg, requeue = (COND_TERMINATED,
                                  f"notebook pod {m.name(pod)} terminated: {phase}",
                                  False)
        status = nb.setdefault("status", {})
        # recompute the url while Running on every pass, not only on the
        # condition transition: the ingress LB host typically lands *after*
        # the pod went Running, and the published link must pick it up
        url = self._url(nb, pod) if cond == COND_RUNNING else status.get("url")
        if status.get("condition") != cond or status.get("url") != url:
            status["condition"] = cond
            status["message"] = msg
            status["lastTransitionTime"] = m.rfc3339(self.api.now())
            if url:
                status["url"] = url
            try:
                self.api.update_status(nb)
            except (Conflict, NotFound):
                return Result(requeue=True)
        return Result(requeue_after=2.0) if requeue else None

    def _url(self, nb: dict, pod: dict) -> str:
        ing = self.api.try_get("Ingress", m.namespace(nb), nb_name(m.name(nb)))
        host = ""
        if ing is not None:
            lbs = m.get_in(ing, "status", "loadBalancer", "ingress",
                           default=[]) or []
            if lbs:
                host = lbs[0].get("hostname") or lbs[0].get("ip") or ""
            if not host:
                host = m.get_in(ing, "spec", "rules", default=[{}])[0].get("host", "")
        url = f"http://{host}{ingress_path(nb)}" if host else ingress_path(nb)
        # auth token passthrough: surface the template's token in the URL so
        # the published link opens without a login prompt
        ctr = _main_container(pod.get("spec", {}))
        token = pl.get_env(ctr, "JUPYTER_TOKEN") if ctr else None
        if token:
            url += f"?token={token}"
        return url


def _main_container(pod_spec: dict) -> Optional[dict]:
    containers = pod_spec.get("containers") or []
    for ctr in containers:
        if ctr.get("name") == CONTAINER_NAME:
            return ctr
    return containers[0] if containers else None
