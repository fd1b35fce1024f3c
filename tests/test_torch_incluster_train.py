"""The port as an in-cluster job of its own operator, on the CPU.

The port's operator (``kubedl_tpu_torch.controllers.registry``, a copy of
the JAX operator since slice 20) reconciles an elastic PyTorchJob (one
Master, two Workers) on the port's in-memory store, which
``tests/fakekube.FakeKube`` serves over HTTP. Each pod's container runs as a kubelet would run it: the
port's restart agent wrapping ``python -m kubedl_tpu_torch.train``'s
``main`` (through a small entry script that hands ``main`` the CPU and an API
client over the fake's URL), with the env the operator rendered (the
PyTorchJob contract, ``WORLD_SIZE`` resolved from the pod's annotation,
the job's identity) and its downward-API annotations file. Only the
master's host and port are rewritten, to 127.0.0.1 and a free port.

Then the test scales the Workers to 1, as
``tests/test_elastic_inplace.py::test_scale_in_deletes_only_excess``
does, but acknowledges nothing itself: the leaving pod holds the
preempt-protector finalizer, so the operator requests a checkpoint;
the port's rank 0 sees it and tells the others, every rank saves, and
rank 0 acknowledges. The operator releases the victim, whose process the
test ends; the survivors' annotations files are rewritten as kubelet
would, their restart agents end the trainers, and the trainers restart
at a world of 2, resuming from the elastic checkpoint bit for bit.
"""

import dataclasses
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import time

import pytest
import torch

from fakekube import FakeKube
from kubedl_tpu_torch.api import common as c
from kubedl_tpu_torch.controllers.registry import (OperatorConfig,
                                                   build_operator)
from kubedl_tpu_torch.core import meta as m
from kubedl_tpu_torch.parallel.launch import free_port
from kubedl_tpu_torch.train import __main__ as tmain
from kubedl_tpu_torch.train import checkpoint as ck

ROOT = str(pathlib.Path(__file__).resolve().parents[1])
PODS = ("ej-master-0", "ej-worker-0", "ej-worker-1")
#: how long any one wait of the scenario may take
WAIT_S = 90.0

#: the container's command: ``main`` on the CPU with an API client over
#: the fake's URL (argv: config, URL or "", steps file, dump file or "").
#: A rank other than 0 gets a client of a port nothing listens on: only
#: rank 0 may talk to the API server. The dump file receives the state
#: the elastic agent saved (world 3) or the state restored (world 2).
ENTRY = r'''
import json, os, sys
import torch
torch.set_num_threads(1)
from kubedl_tpu_torch.core.kubeclient import ClusterConfig, KubeAPIServer
from kubedl_tpu_torch.parallel.sharding import local_of
from kubedl_tpu_torch.train import __main__ as tmain
from kubedl_tpu_torch.train import checkpoint as ck
from kubedl_tpu_torch.train.trainer import tree_leaves

config, url, steps_path, dump = sys.argv[1:5]
rank = int(os.environ["RANK"])


def write_dump(state, cursor):
    if not dump or rank:
        return
    leaves = dict(tree_leaves(ck._state_dict(state, copy_to_host=True)))
    torch.save({"tensors": {k: local_of(v) for k, v in leaves.items()},
                "step": int(state.step), "count": int(state.opt_state.count),
                "cursor": cursor}, dump + ".tmp")
    os.replace(dump + ".tmp", dump)


poll, restore_or = ck.ElasticCheckpointAgent.poll, \
    ck.CheckpointManager.restore_or


def dumping_poll(self, state):
    took = poll(self, state)
    if took:
        write_dump(state, self.data_state_fn())
    return took


def dumping_restore_or(self, state, init_fn):
    got = restore_or(self, state, init_fn)
    if self.latest_step() is not None:
        write_dump(got, self.latest_data_state())
    return got


ck.ElasticCheckpointAgent.poll = dumping_poll
ck.CheckpointManager.restore_or = dumping_restore_or


def on_step(step, loss):
    with open(steps_path, "a") as f:
        f.write(json.dumps([step, loss]) + "\n")


api = None
if url:
    api = KubeAPIServer(ClusterConfig(
        server=url if rank == 0 else "http://127.0.0.1:1"))
sys.exit(tmain.main(["--config", config], device="cpu", on_step=on_step,
                    api=api))
'''

#: names a launcher may set, cleared from the environment a pod inherits
LAUNCH_ENV = ("KUBEDL_COORDINATOR_ADDRESS", "KUBEDL_NUM_PROCESSES",
              "KUBEDL_PROCESS_ID", "TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
              "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "KUBEDL_JOB_KIND", "KUBEDL_JOB_NAMESPACE",
              "KUBEDL_JOB_NAME", "KUBERNETES_SERVICE_HOST",
              "KUBERNETES_SERVICE_PORT", "KUBEDL_PODINFO_ANNOTATIONS")


def elastic_job(workers=2):
    def template():
        return {"spec": {"containers": [{
            "name": "pytorch", "image": "img",
            "ports": [{"name": "pytorchjob-port", "containerPort": 23456}]}]}}
    return {"apiVersion": "training.kubedl.io/v1alpha1", "kind": "PyTorchJob",
            "metadata": {"name": "ej", "namespace": "default",
                         "annotations": {c.ANNOTATION_ENABLE_ELASTIC: "true"}},
            "spec": {"pytorchReplicaSpecs": {
                "Master": {"replicas": 1, "restartPolicy": "Never",
                           "template": template()},
                "Worker": {"replicas": workers, "restartPolicy": "Never",
                           "template": template()}}}}


def train_config(tmp_path, name, directory, steps=100_000):
    """Llama tiny in float32, the global batch of 6 over ``dp`` = the
    world, an elastic-only checkpoint directory (no periodic saves)."""
    cfg = {"model": "llama.tiny",
           "model_overrides": {"dtype": "float32", "vocab_size": 256,
                               "n_layers": 1, "d_model": 64, "d_ff": 128},
           "batch": 6, "seq": 16, "steps": steps, "log_every": 0,
           "mesh": {"dp": -1, "fsdp": 1},
           "data": {"kind": "synthetic", "seed": 3},
           "optimizer": {"learning_rate": 1e-2, "warmup_steps": 1},
           "checkpoint": {"directory": str(directory),
                          "save_interval_steps": 0}}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def resolved_env(pod) -> dict:
    """The container's env as kubelet resolves it (``fieldRef`` to an
    annotation read from the pod)."""
    out = {}
    for e in pod["spec"]["containers"][0].get("env", []):
        if "value" in e:
            out[e["name"]] = str(e["value"])
        else:
            path = e["valueFrom"]["fieldRef"]["fieldPath"]
            key = re.fullmatch(r"metadata\.annotations\['(.+)'\]",
                               path).group(1)
            out[e["name"]] = m.annotations(pod)[key]
    return out


def write_podinfo(pod, path) -> None:
    """The downward-API rendering of the pod's annotations."""
    path.write_text("".join(
        f'{k}="{json.dumps(v)[1:-1]}"\n'
        for k, v in sorted(m.annotations(pod).items())))


def wait_for(pred, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def steps_of(path) -> list:
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines()
            if line.endswith("]")]


class Pods:
    """The containers of the job's pods, as kubelet runs them."""

    def __init__(self, tmp_path, api, url, port):
        self.tmp = tmp_path
        self.api = api
        self.url = url
        self.port = port
        self.procs = {}
        self.entry = tmp_path / "entry.py"
        self.entry.write_text(ENTRY)

    def env(self, name) -> dict:
        pod = self.api.get("Pod", "default", name)
        env = resolved_env(pod)
        podinfo = self.tmp / f"{name}.podinfo"
        if not podinfo.exists():
            write_podinfo(pod, podinfo)
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(self.port),
                   KUBEDL_PODINFO_ANNOTATIONS=str(podinfo),
                   KUBERNETES_SERVICE_HOST="127.0.0.1")
        return env

    def start(self, name, config, tag, agent=True, url=None, dump=""):
        """The pod's container: under the restart agent, or (``agent``
        False) a plain job on the pod's rendezvous env and no API
        server."""
        base = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
        env = {**base, **self.env(name), "PYTHONPATH": ROOT,
               "KUBEDL_RESTART_POLL_S": "0.05",
               "KUBEDL_RESTART_GRACE_S": "10"}
        if not agent:
            for key in ("KUBEDL_JOB_KIND", "KUBEDL_JOB_NAMESPACE",
                        "KUBEDL_JOB_NAME", "KUBERNETES_SERVICE_HOST"):
                env.pop(key)
        steps = self.tmp / f"{name}.{tag}.steps"
        cmd = [sys.executable, str(self.entry), config,
               self.url if url is None else url, str(steps), dump]
        if agent:
            cmd = [sys.executable, "-m",
                   "kubedl_tpu_torch.runtime.restart_agent", "--", *cmd]
        self.procs[name] = subprocess.Popen(
            cmd, env=env, cwd=str(self.tmp), stdout=subprocess.DEVNULL,
            stderr=open(self.tmp / f"{name}.{tag}.err", "w"))
        return steps

    def stop(self, name, sig=signal.SIGTERM) -> int:
        proc = self.procs.pop(name)
        if proc.poll() is None:
            proc.send_signal(sig)
        return proc.wait(timeout=WAIT_S)

    def wait(self, name) -> int:
        return self.procs.pop(name).wait(timeout=WAIT_S)

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=WAIT_S)
        self.procs.clear()

    def errors(self) -> str:
        return "\n".join(f"--- {p.name}\n{p.read_text()[-3000:]}"
                         for p in sorted(self.tmp.glob("*.err")))


@pytest.fixture
def api():
    """The port's in-memory store on a simulated clock (the conftest's
    ``api`` is the JAX package's)."""
    from kubedl_tpu_torch.core.apiserver import APIServer
    from kubedl_tpu_torch.core.clock import SimClock
    return APIServer(clock=SimClock())


def run_to_running(api, op):
    op.run_until_idle(max_iterations=100)
    for pod in api.list("Pod"):
        pod["status"] = {"phase": "Running"}
        api.update_status(pod)
    op.run_until_idle(max_iterations=100)


def test_an_elastic_pytorchjob_scales_in_through_the_ports_agents(
        api, tmp_path):
    op = build_operator(api, OperatorConfig(
        workloads=["PyTorchJob"], gang_scheduler_name="coscheduler"))
    fake = FakeKube(api)
    pods = Pods(tmp_path, api, fake.url, free_port())
    directory = tmp_path / "ckpt"
    config = train_config(tmp_path, "job", directory)
    try:
        api.create(elastic_job(workers=2))
        run_to_running(api, op)
        before = {m.name(p): m.uid(p) for p in api.list("Pod")}
        assert set(before) == set(PODS)
        for name in PODS:
            env = pods.env(name)
            assert (env["RANK"], env["WORLD_SIZE"]) == (
                str(PODS.index(name)), "3")
        steps = {name: pods.start(name, config, "w3",
                                  dump=str(tmp_path / "saved.pt"))
                 for name in PODS}
        wait_for(lambda: all(len(steps_of(s)) >= 2 for s in steps.values()),
                 "three ranks training")

        # scale in: 2 Workers -> 1; no hand-written acknowledgement
        job = api.get("PyTorchJob", "default", "ej")
        job["spec"]["pytorchReplicaSpecs"]["Worker"]["replicas"] = 1
        api.update(job)
        op.run_until_idle(max_iterations=50)
        gen = m.generation(api.get("PyTorchJob", "default", "ej"))
        assert m.annotations(api.get("PyTorchJob", "default", "ej"))[
            c.ANNOTATION_CKPT_REQUESTED_VERSION] == str(gen)
        victim = api.get("Pod", "default", "ej-worker-1")
        assert m.is_deleting(victim) and \
            c.FINALIZER_PREEMPT_PROTECTOR in m.finalizers(victim)

        def acked():
            ann = m.annotations(api.get("PyTorchJob", "default", "ej"))
            return ann.get(c.ANNOTATION_CKPT_COMPLETED_VERSION) == str(gen)
        try:
            wait_for(acked, "the port's acknowledgement")
        except AssertionError:
            raise AssertionError(pods.errors()) from None
        ann = m.annotations(api.get("PyTorchJob", "default", "ej"))
        assert ann[c.ANNOTATION_CKPT_REQUESTED_VERSION] == \
            ann[c.ANNOTATION_CKPT_COMPLETED_VERSION] == str(gen) != "0"
        saved_steps = [int(n) for n in os.listdir(directory) if n.isdigit()]
        assert len(saved_steps) == 1, os.listdir(directory)
        copy = tmp_path / "ckpt_copy"
        shutil.copytree(directory, copy)

        # the operator releases the victim; kubelet then stops it
        op.run_until_idle(max_iterations=100)
        assert api.try_get("Pod", "default", "ej-worker-1") is None
        for name in PODS[:2]:
            pod = api.get("Pod", "default", name)
            assert m.uid(pod) == before[name]
            assert m.annotations(pod)["world-size"] == "2"
            assert m.annotations(pod)[
                c.ANNOTATION_RESTART_REQUESTED_GENERATION] == str(gen)

        # kubelet refreshes the survivors' annotations files: their
        # agents end the trainers for an in-place restart
        wait_for((tmp_path / "saved.pt").exists, "rank 0's record of the save")
        for name in PODS[:2]:
            write_podinfo(api.get("Pod", "default", name),
                          tmp_path / f"{name}.podinfo")
        codes = [pods.wait(name) for name in PODS[:2]]
        assert codes == [64 + signal.SIGTERM] * 2, pods.errors()
        pods.stop("ej-worker-1")

        # the containers restart in place at a world of 2
        pods.port = free_port()
        steps = {name: pods.start(name, config, "w2",
                                  dump=str(tmp_path / "restored.pt"))
                 for name in PODS[:2]}
        for name in PODS[:2]:
            assert pods.env(name)["WORLD_SIZE"] == "2"
        try:
            wait_for(lambda: all(len(steps_of(s)) >= 1
                                 for s in steps.values()),
                     "the restarted ranks' first step")
        except AssertionError:
            raise AssertionError(pods.errors()) from None
        restarted = [steps_of(s)[0] for s in steps.values()]
        for name in PODS[:2]:
            pods.stop(name)
        for name in PODS[:2]:
            pod = api.get("Pod", "default", name)
            pod["status"]["containerStatuses"] = [
                {"name": "pytorch", "restartCount": 1}]
            api.update_status(pod)
        op.run_until_idle(max_iterations=100)
        for name in PODS[:2]:
            pod = api.get("Pod", "default", name)
            assert m.uid(pod) == before[name]
            assert m.labels(pod)[c.LABEL_GENERATION] == str(gen)

        # what world 3 saved, bit for bit, is what world 2 restored
        saved = torch.load(tmp_path / "saved.pt")
        restored = torch.load(tmp_path / "restored.pt")
        assert saved["step"] == restored["step"] == saved_steps[0]
        assert saved["count"] == restored["count"] == saved["step"]
        assert saved["cursor"] == restored["cursor"]
        assert saved["cursor"]["consumed_batches"] == saved["step"]
        assert set(saved["tensors"]) == set(restored["tensors"])
        assert any(k.startswith("opt_state/mu") for k in saved["tensors"])
        for k, v in saved["tensors"].items():
            assert v.dtype == restored["tensors"][k].dtype, k
            assert torch.equal(v, restored["tensors"][k]), k
        assert [s for s, _ in restarted] == [saved["step"] + 1] * 2

        # a world-2 job restored from the same directory takes the same
        # next step
        pods.port = free_port()
        fresh = train_config(tmp_path, "fresh", copy, steps=1)
        steps = {name: pods.start(name, fresh, "fresh", agent=False, url="")
                 for name in PODS[:2]}
        assert [pods.wait(name) for name in PODS[:2]] == [0, 0], \
            pods.errors()
        assert [steps_of(s)[0] for s in steps.values()] == restarted
    finally:
        pods.close()
        fake.close()


def test_main_builds_the_in_cluster_agent_without_an_api(tmp_path,
                                                         monkeypatch):
    """With the operator's identity and ``KUBERNETES_SERVICE_HOST`` and no
    ``api``, ``main`` builds the agent over ``ClusterConfig.in_cluster()``
    (its fields checked; its polls recorded, not sent)."""
    from kubedl_tpu_torch.core.kubeclient import ClusterConfig
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    env = {"KUBEDL_JOB_KIND": "PyTorchJob", "KUBEDL_JOB_NAMESPACE": "team",
           "KUBEDL_JOB_NAME": "ej", "KUBERNETES_SERVICE_HOST": "127.0.0.1",
           "KUBERNETES_SERVICE_PORT": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    polled = []

    def poll(self, state):
        polled.append((self, state.step))
        return False

    monkeypatch.setattr(ck.ElasticCheckpointAgent, "poll", poll)
    config = train_config(tmp_path, "one", tmp_path / "ck", steps=2)
    assert tmain.main(["--config", config], device="cpu") == 0
    assert [s for _, s in polled] == [1, 2]
    agent = polled[0][0]
    assert (agent.kind, agent.namespace, agent.name) == (
        "PyTorchJob", "team", "ej")
    assert dataclasses.asdict(agent.api.config) == dataclasses.asdict(
        ClusterConfig.in_cluster())
    assert agent.api.config.server == "https://127.0.0.1:1"
    assert agent.data_state_fn()["consumed_batches"] == 2

    # the agent is built only with every piece present
    manager = object()
    assert tmain._maybe_elastic_agent(manager, env) is not None
    assert tmain._maybe_elastic_agent(None, env) is None
    for key in ("KUBEDL_JOB_KIND", "KUBEDL_JOB_NAMESPACE", "KUBEDL_JOB_NAME",
                "KUBERNETES_SERVICE_HOST"):
        assert tmain._maybe_elastic_agent(
            manager, {k: v for k, v in env.items() if k != key}) is None
    api = object()
    assert tmain._maybe_elastic_agent(manager, env, api).api is api


def test_a_full_torch_contract_trains(tmp_path, monkeypatch):
    """The former refusal of a launch without the KubeDL contract: a
    one-process PyTorchJob contract opens a gloo group and trains over
    it. A partial one trains as one process without a group, unless it
    claims a second process."""
    import torch.distributed as dist
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    for k, v in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
                 "RANK": "0", "WORLD_SIZE": "1"}.items():
        monkeypatch.setenv(k, v)
    seen = []

    def on_step(step, loss):
        seen.append((step, dist.get_world_size()))

    cfg = json.loads(pathlib.Path(
        train_config(tmp_path, "torchrun", tmp_path / "ck", 2)).read_text())
    del cfg["checkpoint"]
    path = tmp_path / "torchrun.json"
    path.write_text(json.dumps(cfg))
    assert tmain.main(["--config", str(path)], device="cpu",
                      on_step=on_step) == 0
    assert seen == [(1, 1), (2, 1)]
    assert not dist.is_initialized()
    # without its rank, a contract of one process is none: one process,
    # no group; one of two processes is refused, naming the rank
    monkeypatch.delenv("RANK")
    seen.clear()
    assert tmain.main(["--config", str(path)], device="cpu",
                      on_step=lambda step, loss: seen.append(
                          (step, dist.is_initialized()))) == 0
    assert seen == [(1, False), (2, False)]
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK missing"):
        tmain.main(["--config", str(path)], device="cpu")
