"""The two operators side by side: the JAX package's and the port's
``build_operator``, each on its own in-memory store with a simulated
clock and a counter for uids, take the same manifests (the nine training
kinds, an ``Inference``, a ``Notebook`` and a ``Cron``) and the same
script of pod phases, and their stores hold the same objects, key by
key, after every step: the uids and timestamps too, and the predictor's
command but for the package it names (each operator starts its own
``serving``)."""

import copy
import importlib
import itertools
import json

import pytest

from kubedl_tpu_torch.core.clock import SimClock as _PortClock

#: (kind, replica specs field, {replica type: (count, container name)})
TRAINING = (
    ("TFJob", "tfReplicaSpecs", {"PS": (1, "tensorflow"),
                                 "Worker": (2, "tensorflow")}),
    ("PyTorchJob", "pytorchReplicaSpecs", {"Master": (1, "pytorch"),
                                           "Worker": (2, "pytorch")}),
    ("JAXJob", "jaxReplicaSpecs", {"Worker": (2, "jax")}),
    ("MPIJob", "mpiReplicaSpecs", {"Launcher": (1, "mpi"),
                                   "Worker": (2, "mpi")}),
    ("XGBoostJob", "xgbReplicaSpecs", {"Master": (1, "xgboost"),
                                       "Worker": (1, "xgboost")}),
    ("XDLJob", "xdlReplicaSpecs", {"Scheduler": (1, "xdl"),
                                   "Worker": (1, "xdl")}),
    ("MarsJob", "marsReplicaSpecs", {"Scheduler": (1, "mars"),
                                     "Worker": (1, "mars"),
                                     "WebService": (1, "mars")}),
    ("ElasticDLJob", "elasticdlReplicaSpecs", {"Master": (1, "elasticdl")}),
    ("RLJob", "rlReplicaSpecs", {"Learner": (2, "learner")}),
)


def _container(name):
    return {"name": name, "image": "img:v1",
            "ports": [{"name": f"{name}-port", "containerPort": 2222}]}


def manifests() -> list:
    out = []
    for kind, field, replicas in TRAINING:
        out.append({
            "apiVersion": "training.kubedl.io/v1alpha1", "kind": kind,
            "metadata": {"name": kind.lower(), "namespace": "default"},
            "spec": {field: {rt: {"replicas": n, "template": {"spec": {
                "containers": [_container(cname)]}}}
                for rt, (n, cname) in replicas.items()}}})
    out.append({
        "apiVersion": "serving.kubedl.io/v1alpha1", "kind": "Inference",
        "metadata": {"name": "inf", "namespace": "default"},
        "spec": {"framework": "JAXServing", "predictors": [{
            "name": "main", "replicas": 2, "modelPath": "/models/m",
            "template": {"spec": {"containers": [{
                "name": "predictor", "image": "img:v1",
                "env": [{"name": "KUBEDL_SERVING_LANES",
                         "value": "4"}]}]}}}]}})
    out.append({
        "apiVersion": "notebook.kubedl.io/v1alpha1", "kind": "Notebook",
        "metadata": {"name": "nb", "namespace": "default"},
        "spec": {"template": {"spec": {"containers": [{
            "name": "notebook", "image": "jupyter:latest"}]}}}})
    out.append({
        "apiVersion": "apps.kubedl.io/v1alpha1", "kind": "Cron",
        "metadata": {"name": "cron", "namespace": "default"},
        "spec": {"schedule": "*/5 * * * *", "template": {"workload": {
            "apiVersion": "training.kubedl.io/v1alpha1",
            "kind": "XGBoostJob",
            "spec": {"xgbReplicaSpecs": {"Master": {
                "replicas": 1, "template": {"spec": {"containers": [
                    _container("xgboost")]}}}}}}}}})
    return out


class Day:
    """One operator on its own store, from the package ``pkg``."""

    def __init__(self, pkg: str):
        def mod(name):
            return importlib.import_module(f"{pkg}.{name}")
        clock_mod = mod("core.clock")
        self.clock = clock_mod.SimClock()
        uids = itertools.count()
        self.api = mod("core.apiserver").APIServer(
            clock=self.clock, uid_factory=lambda: f"uid-{next(uids)}")
        reg = mod("controllers.registry")
        # gates of their own: the process-wide default set is what other
        # tests in this process may have changed
        self.op = reg.build_operator(self.api, reg.OperatorConfig(
            feature_gates=mod("core.features").FeatureGates()))
        self.testing = mod("controllers.testing")

    def settle(self):
        self.op.run_until_idle(include_delayed=True, max_iterations=500)

    def pods(self) -> list:
        return sorted(self.api.list("Pod"),
                      key=lambda p: p["metadata"]["name"])

    def set_phase(self, name: str, phase: str, exit_code=None):
        pod = self.api.get("Pod", "default", name)
        self.testing.set_pod_phase(self.api, pod, phase,
                                   exit_code=exit_code)

    def dump(self) -> str:
        out = {}
        for kind in KINDS:
            objs = self.api.list(kind)
            if objs:
                out[kind] = sorted(objs, key=lambda o: (
                    o["metadata"].get("namespace", ""),
                    o["metadata"]["name"]))
        return json.dumps(out, sort_keys=True, default=str)


#: every kind the two operators write for these manifests
KINDS = ("TFJob", "PyTorchJob", "JAXJob", "MPIJob", "XGBoostJob", "XDLJob",
         "MarsJob", "ElasticDLJob", "RLJob", "Inference", "Notebook", "Cron",
         "Pod", "Service", "ConfigMap", "Deployment", "PodGroup", "Event",
         "Ingress", "VirtualService", "HorizontalPodAutoscaler", "Role",
         "RoleBinding", "ServiceAccount", "PersistentVolumeClaim")


@pytest.fixture(scope="module")
def days():
    """The two days, with each package's event-name counter (a module
    global) started at 0 for them and given back after."""
    events = [importlib.import_module(f"{pkg}.core.events")
              for pkg in ("kubedl_tpu", "kubedl_tpu_torch")]
    saved = [mod._seq for mod in events]
    for mod in events:
        mod._seq = itertools.count()
    yield Day("kubedl_tpu"), Day("kubedl_tpu_torch")
    for mod, seq in zip(events, saved):
        mod._seq = seq


def _both(days, fn):
    for day in days:
        fn(day)
        day.settle()
    jax_day, port_day = days
    # the one difference: the predictor's command names each package
    want = jax_day.dump()
    assert ('"kubedl_tpu.serving"' in want) == bool(
        jax_day.api.list("Deployment"))
    assert port_day.dump() == want.replace('"kubedl_tpu.serving"',
                                           '"kubedl_tpu_torch.serving"')


def test_the_two_operators_keep_equal_stores_through_a_pod_phase_script(
        days):
    jax_day, port_day = days
    assert isinstance(port_day.clock, _PortClock)
    assert type(jax_day.clock).__module__.startswith("kubedl_tpu.")

    def submit(day):
        for obj in manifests():
            day.api.create(copy.deepcopy(obj))
    _both(days, submit)
    names = [p["metadata"]["name"] for p in jax_day.pods()]
    assert len(names) >= 20
    assert {"inf-main-0", "inf-main-1"} <= set(names)

    def running(day):
        for name in names:
            day.set_phase(name, "Running")
    _both(days, running)
    _both(days, lambda day: day.clock.advance(301.0))
    # the Cron's first workload, and its pods
    assert any(o["metadata"]["name"].startswith("cron-")
               for o in jax_day.api.list("XGBoostJob"))
    names = [p["metadata"]["name"] for p in jax_day.pods()]

    def finish(day):
        for name in names:
            if name.startswith(("inf-", "nb-")):
                continue
            day.set_phase(name, "Succeeded", exit_code=0)
    _both(days, finish)

    def fail_and_delete(day):
        day.set_phase("inf-main-1", "Failed", exit_code=1)
        day.api.delete("Inference", "default", "inf")
        day.api.delete("TFJob", "default", "tfjob")
    _both(days, fail_and_delete)
    assert jax_day.api.try_get("Deployment", "default", "inf-main") is None
