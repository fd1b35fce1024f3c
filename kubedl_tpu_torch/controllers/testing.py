"""Synthetic TestJob workload for exercising the generic engine.

Port of the reference's fake-workload strategy (``pkg/test_job/v1/types.go:
29-51``, ``test_job_controller.go:17-50``): a minimal controller that lets
the engine be tested end-to-end without any real framework.

Copied from ``kubedl_tpu/controllers/testing.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from ..core import meta as m
from ..tpu import placement as pl
from .interface import WorkloadController


class TestJobController(WorkloadController):
    kind = "TestJob"
    api_version = "test.kubedl.io/v1alpha1"
    default_container_name = "test-container"
    default_port_name = "test-port"
    default_port = 2222
    replica_specs_field_name = "testReplicaSpecs"

    def get_reconcile_orders(self):
        return ["AIMaster", "Master", "Worker"]


def new_test_job(name: str, namespace: str = "default", *, workers: int = 2,
                 masters: int = 0, restart_policy: str = "Never",
                 tpu_policy: dict | None = None, run_policy: dict | None = None,
                 annotations: dict | None = None) -> dict:
    spec: dict = {"testReplicaSpecs": {}}
    template = {
        "spec": {
            "containers": [{
                "name": "test-container",
                "image": "test-image:latest",
                "ports": [{"name": "test-port", "containerPort": 2222}],
            }],
        },
    }
    if masters:
        spec["testReplicaSpecs"]["Master"] = {
            "replicas": masters, "restartPolicy": restart_policy,
            "template": template,
        }
    spec["testReplicaSpecs"]["Worker"] = {
        "replicas": workers, "restartPolicy": restart_policy,
        "template": template,
    }
    if tpu_policy:
        spec["tpuPolicy"] = tpu_policy
    if run_policy:
        spec.update(run_policy)
    job = m.new_obj("test.kubedl.io/v1alpha1", "TestJob", name, namespace,
                    annotations=annotations, spec=spec)
    return job


# -- kubelet simulation helpers ---------------------------------------------
#
# These act as the node agent, which has its own apiserver connection — so
# they bypass a ChaosAPIServer wrapper (``.inner``) when handed one: chaos
# aimed at the operator must not crash the simulated kubelet.

def _raw(api):
    return getattr(api, "inner", api)


def set_pod_phase(api, pod, phase: str, exit_code: int | None = None,
                  reason: str = "", container: str = "test-container") -> None:
    api = _raw(api)
    pod = api.get("Pod", m.namespace(pod), m.name(pod))
    status = pod.setdefault("status", {})
    status["phase"] = phase
    if reason:
        status["reason"] = reason
    if exit_code is not None:
        status["containerStatuses"] = [{
            "name": container,
            "state": {"terminated": {"exitCode": exit_code}},
        }]
    elif phase == "Running":
        status["containerStatuses"] = [{"name": container, "state": {"running": {}}}]
        pod.setdefault("spec", {})["nodeName"] = pod["metadata"]["name"] + "-node"
    api.update_status(pod)


def run_all_pods(api, namespace: str = "default",
                 container: str = "test-container") -> None:
    for pod in _raw(api).list("Pod", namespace):
        set_pod_phase(api, pod, "Running", container=container)


def set_pod_disrupted(api, pod, *, delete: bool = False,
                      exit_code: int = 143) -> None:
    """Mark one pod preempted (DisruptionTarget + Failed(143)), optionally
    deleting it like the real eviction flow — the stimulus every
    slice-atomic failover test starts from."""
    from .chaos import preempt_pod
    preempt_pod(_raw(api), m.namespace(pod), m.name(pod), delete=delete,
                exit_code=exit_code)
