"""The port's rendezvous reader on the env the JAX operator renders: a
PyTorchJob of one Master and two Workers, elastic and not, with and
without a TPU policy, each pod's ``WORLD_SIZE`` ``fieldRef`` resolved from
its ``world-size`` annotation as kubelet would. Every pod reads as ranks
0..2 of a world of 3; where the JAX reader finds a contract (the KubeDL
one, under a TPU policy) the port's ``RendezvousInfo`` equals it, since
the KubeDL contract wins over the PyTorchJob one. Then torchrun's env and
each partial contract."""

import dataclasses
import re

import pytest

from kubedl_tpu.api import common as c
from kubedl_tpu.controllers.registry import OperatorConfig, build_operator
from kubedl_tpu.core import meta as m
from kubedl_tpu.runtime import bootstrap as jboot
from kubedl_tpu_torch.runtime import bootstrap as tboot

PODS = ("ej-master-0", "ej-worker-0", "ej-worker-1")


def fields(info):
    """A ``RendezvousInfo`` of either package as a dict (the two classes
    are twins, not one class)."""
    return dataclasses.asdict(info)


def pytorchjob(elastic: bool, tpu: bool) -> dict:
    def template():
        return {"spec": {"containers": [{
            "name": "pytorch", "image": "img",
            "ports": [{"name": "pytorchjob-port", "containerPort": 23456}]}]}}
    job = {"apiVersion": "training.kubedl.io/v1alpha1", "kind": "PyTorchJob",
           "metadata": {"name": "ej", "namespace": "default",
                        "annotations": {}},
           "spec": {"pytorchReplicaSpecs": {
               "Master": {"replicas": 1, "restartPolicy": "Never",
                          "template": template()},
               "Worker": {"replicas": 2, "restartPolicy": "Never",
                          "template": template()}}}}
    if elastic:
        job["metadata"]["annotations"][c.ANNOTATION_ENABLE_ELASTIC] = "true"
    if tpu:
        job["spec"]["tpuPolicy"] = {"acceleratorType": "v5p-24"}
    return job


def resolved_env(pod: dict) -> dict:
    """The container's env as the process sees it: each ``fieldRef`` to an
    annotation resolved from the pod, as kubelet does."""
    out = {}
    for e in pod["spec"]["containers"][0].get("env", []):
        if "value" in e:
            out[e["name"]] = str(e["value"])
            continue
        path = e["valueFrom"]["fieldRef"]["fieldPath"]
        key = re.fullmatch(r"metadata\.annotations\['(.+)'\]", path).group(1)
        out[e["name"]] = m.annotations(pod)[key]
    return out


@pytest.mark.parametrize("tpu", [False, True], ids=["gpu", "tpu_policy"])
@pytest.mark.parametrize("elastic", [False, True],
                         ids=["static", "elastic"])
def test_operator_rendered_pods_read_as_ranks_of_one_world(api, elastic,
                                                           tpu):
    op = build_operator(api, OperatorConfig(
        workloads=["PyTorchJob"], gang_scheduler_name="coscheduler"))
    api.create(pytorchjob(elastic, tpu))
    op.run_until_idle(max_iterations=100)
    pods = {m.name(p): p for p in api.list("Pod")}
    assert set(pods) == set(PODS)
    for rank, name in enumerate(PODS):
        env = resolved_env(pods[name])
        if elastic:
            rendered = {e["name"]: e for e in
                        pods[name]["spec"]["containers"][0]["env"]}
            assert "valueFrom" in rendered["WORLD_SIZE"]
        got = tboot.rendezvous_from_env(env)
        assert (got.num_processes, got.process_id) == (3, rank), name
        want = jboot.rendezvous_from_env(env)
        if tpu:
            # both contracts in one pod: the KubeDL one wins, as in JAX
            assert fields(got) == fields(want)
            assert got.coordinator_address == env[
                "KUBEDL_COORDINATOR_ADDRESS"]
        else:
            assert want is None         # the JAX reader knows no other
            assert got == tboot.RendezvousInfo("ej-master-0:23456", 3, rank)


def test_the_kubedl_contract_wins_where_the_ranks_differ():
    """``KUBEDL_PROCESS_ID`` counts across replica types, a PyTorchJob's
    ``RANK`` within its own numbering: the KubeDL one is read."""
    env = {"KUBEDL_COORDINATOR_ADDRESS": "j-worker-0.default.svc:8476",
           "KUBEDL_NUM_PROCESSES": "4", "KUBEDL_PROCESS_ID": "3",
           "MASTER_ADDR": "j-master-0", "MASTER_PORT": "23456", "RANK": "1",
           "WORLD_SIZE": "2"}
    got = tboot.rendezvous_from_env(env)
    assert fields(got) == fields(jboot.rendezvous_from_env(env))
    assert got == tboot.RendezvousInfo("j-worker-0.default.svc:8476", 4, 3)
    # TPU worker hostnames win over the torch contract too
    env = {"TPU_WORKER_HOSTNAMES": "h0,h1", "TPU_WORKER_ID": "1",
           "MASTER_ADDR": "m", "MASTER_PORT": "1", "RANK": "0",
           "WORLD_SIZE": "1"}
    assert fields(tboot.rendezvous_from_env(env)) == fields(
        jboot.rendezvous_from_env(env))
    assert tboot.rendezvous_from_env(env) == tboot.RendezvousInfo(
        "h0:8476", 2, 1)


def test_torchrun_env():
    """torchrun sets the four names in every child, and ``LOCAL_RANK``."""
    for rank in range(4):
        env = {"MASTER_ADDR": "10.0.0.5", "MASTER_PORT": "29500",
               "RANK": str(rank), "WORLD_SIZE": "4",
               "LOCAL_RANK": str(rank % 2), "LOCAL_WORLD_SIZE": "2",
               "GROUP_RANK": str(rank // 2)}
        assert tboot.rendezvous_from_env(env) == tboot.RendezvousInfo(
            "10.0.0.5:29500", 4, rank)
    # a one-process contract opens a group too
    assert tboot.rendezvous_from_env({
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "RANK": "0",
        "WORLD_SIZE": "1"}) == tboot.RendezvousInfo("127.0.0.1:1", 1, 0)
    assert tboot.rendezvous_from_env({}) is None
    assert tboot.rendezvous_from_env({"LOCAL_RANK": "0"}) is None


FULL = {"MASTER_ADDR": "j-master-0", "MASTER_PORT": "23456", "RANK": "1",
        "WORLD_SIZE": "3"}


@pytest.mark.parametrize("drop", [("RANK",), ("MASTER_ADDR",),
                                  ("MASTER_PORT",), ("WORLD_SIZE",),
                                  ("RANK", "MASTER_ADDR"),
                                  ("MASTER_ADDR", "MASTER_PORT", "RANK")])
def test_a_partial_torch_contract_names_what_is_missing(drop):
    env = {k: v for k, v in FULL.items() if k not in drop}
    with pytest.raises(ValueError) as info:
        tboot.rendezvous_from_env(env)
    missing = re.search(r"set but (.*) missing", str(info.value)).group(1)
    assert missing.split(", ") == [k for k in FULL if k in drop]


@pytest.mark.parametrize("env", [
    {"MASTER_ADDR": "j-master-0"}, {"MASTER_PORT": "23456"},
    {"MASTER_ADDR": "j-master-0", "MASTER_PORT": "23456"},
    {"WORLD_SIZE": "1"}, {"RANK": "0"}, {"RANK": "0", "WORLD_SIZE": "1"},
    {"MASTER_ADDR": "j-master-0", "RANK": "0", "WORLD_SIZE": "1"}])
def test_a_partial_torch_contract_of_one_process_is_no_contract(env):
    """A stray ``MASTER_ADDR``/``MASTER_PORT``, or ``WORLD_SIZE=1``
    alone, claims no other process: the job trains as one, which is what
    the JAX reader, ignoring these names, gives too."""
    assert tboot.rendezvous_from_env(env) is None
    assert jboot.rendezvous_from_env(env) is None


@pytest.mark.parametrize("rank,world", [("3", "3"), ("-1", "3"),
                                        ("0", "0")])
def test_a_rank_outside_the_world_is_refused(rank, world):
    with pytest.raises(ValueError, match="is outside"):
        tboot.rendezvous_from_env({**FULL, "RANK": rank,
                                   "WORLD_SIZE": world})


def test_the_kubedl_contract_keeps_its_own_rule():
    """A coordinator and a count without the process id raise as in JAX,
    whatever torch variables are set."""
    env = {"KUBEDL_COORDINATOR_ADDRESS": "c:1", "KUBEDL_NUM_PROCESSES": "2",
           **FULL}
    for reader in (tboot, jboot):
        with pytest.raises(ValueError, match="KUBEDL_PROCESS_ID is missing"):
            reader.rendezvous_from_env(env)
