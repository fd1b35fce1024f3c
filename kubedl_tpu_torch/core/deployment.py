"""Minimal Deployment substrate controller.

The reference leans on Kubernetes itself to turn Deployments into pods
(serving predictors, notebooks). When kubedl-tpu runs self-hosted on its
in-memory control plane there is no kube-controller-manager underneath, so
this reconciler provides the slice of Deployment semantics the platform
controllers rely on: scale pods ``{deploy}-{i}`` to ``spec.replicas``,
label them from the template, and roll ``status.{replicas,readyReplicas,
availableReplicas}`` up from pod phases. On a real cluster this controller
is simply not registered.

Copied from ``kubedl_tpu/core/deployment.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import copy
from typing import Optional

from . import meta as m
from .apiserver import AlreadyExists, APIServer, Conflict, NotFound
from .manager import Reconciler, Request, Result


class DeploymentReconciler(Reconciler):
    kind = "Deployment"
    owns = ("Pod",)

    def __init__(self, api: APIServer):
        self.api = api

    def reconcile(self, req: Request) -> Optional[Result]:
        deploy = self.api.try_get(self.kind, req.namespace, req.name)
        if deploy is None or m.is_deleting(deploy):
            return None
        want = int(m.get_in(deploy, "spec", "replicas", default=1) or 0)
        template = m.get_in(deploy, "spec", "template", default={}) or {}

        pods = [p for p in self.api.list("Pod", req.namespace)
                if m.is_controlled_by(p, deploy)]
        by_name = {m.name(p): p for p in pods}

        for i in range(want):
            name = f"{req.name}-{i}"
            if name in by_name:
                continue
            pod = m.new_obj("v1", "Pod", name, req.namespace)
            pod["metadata"]["labels"] = dict(
                m.get_in(template, "metadata", "labels", default={}) or {})
            pod["spec"] = copy.deepcopy(template.get("spec", {}) or {})
            if m.get_in(template, "metadata", "annotations"):
                pod["metadata"]["annotations"] = dict(
                    template["metadata"]["annotations"])
            m.set_controller_ref(pod, deploy)
            try:
                self.api.create(pod)
            except AlreadyExists:
                pass

        # scale down from the highest ordinal
        extras = sorted((n for n in by_name
                         if _ordinal(n, req.name) >= want), reverse=True)
        for name in extras:
            try:
                self.api.delete("Pod", req.namespace, name)
            except NotFound:
                pass

        live = [p for p in pods if _ordinal(m.name(p), req.name) < want]
        ready = sum(1 for p in live
                    if m.get_in(p, "status", "phase") == "Running")
        status = {"replicas": len(live), "readyReplicas": ready,
                  "availableReplicas": ready}
        if deploy.get("status") != status:
            deploy["status"] = status
            try:
                self.api.update_status(deploy)
            except (Conflict, NotFound):
                return Result(requeue=True)
        return None


def _ordinal(pod_name: str, deploy_name: str) -> int:
    suffix = pod_name[len(deploy_name) + 1:]
    return int(suffix) if suffix.isdigit() else 1 << 30
