"""The port's rendezvous (``kubedl_tpu_torch.runtime.bootstrap``) held
against the JAX package's: the same contract read by the same rules, and
a process group opened from it (2 gloo ranks, spawned once for the file
through ``parallel.launch.spawn``, which hands every rank the operator's
env)."""

import pytest

from kubedl_tpu_torch.parallel import launch
from kubedl_tpu_torch.runtime import bootstrap as tboot

#: operator envs: the full contract, a partial one, the GKE fallback, a
#: multislice worker, nothing
ENVS = {
    "full": {"KUBEDL_COORDINATOR_ADDRESS": "job-worker-0.job:8476",
             "KUBEDL_NUM_PROCESSES": "4", "KUBEDL_PROCESS_ID": "2"},
    "one_process": {"KUBEDL_COORDINATOR_ADDRESS": "127.0.0.1:1234",
                    "KUBEDL_NUM_PROCESSES": "1", "KUBEDL_PROCESS_ID": "0"},
    "partial": {"KUBEDL_COORDINATOR_ADDRESS": "job-worker-0.job:8476",
                "KUBEDL_NUM_PROCESSES": "4"},
    "tpu_fallback": {"TPU_WORKER_HOSTNAMES": "h0, h1,h2,",
                     "TPU_WORKER_ID": "1"},
    "tpu_fallback_no_id": {"TPU_WORKER_HOSTNAMES": "h0,h1"},
    "megascale": {"KUBEDL_COORDINATOR_ADDRESS": "c:1",
                  "KUBEDL_NUM_PROCESSES": "8", "KUBEDL_PROCESS_ID": "5",
                  "MEGASCALE_COORDINATOR_ADDRESS": "m:2",
                  "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1"},
    "megascale_empty": {"TPU_WORKER_HOSTNAMES": "h0", "TPU_WORKER_ID": "0",
                        "MEGASCALE_NUM_SLICES": "", "MEGASCALE_SLICE_ID": ""},
    "only_num_processes": {"KUBEDL_NUM_PROCESSES": "4"},
    "none": {},
}


def _read(fn, env):
    try:
        return ("ok", fn(env))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("name", sorted(ENVS))
def test_rendezvous_from_env_matches_jax(name):
    from kubedl_tpu.runtime import bootstrap as jboot
    want = _read(jboot.rendezvous_from_env, ENVS[name])
    got = _read(tboot.rendezvous_from_env, ENVS[name])
    if want[0] == "ok" and want[1] is not None:
        assert got[0] == "ok" and got[1] is not None
        fields = ("coordinator_address", "num_processes", "process_id",
                  "slice_id", "num_slices")
        assert {f: getattr(got[1], f) for f in fields} == \
            {f: getattr(want[1], f) for f in fields}
        assert got[1].is_distributed == want[1].is_distributed
    else:
        assert got == want


def test_the_env_names_are_the_operator_contract():
    from kubedl_tpu.tpu import placement as jpl
    for name in ("ENV_TPU_WORKER_ID", "ENV_TPU_WORKER_HOSTNAMES",
                 "ENV_COORDINATOR_ADDRESS", "ENV_NUM_PROCESSES",
                 "ENV_PROCESS_ID", "ENV_MEGASCALE_COORDINATOR",
                 "ENV_MEGASCALE_NUM_SLICES", "ENV_MEGASCALE_SLICE_ID",
                 "DEFAULT_COORDINATOR_PORT"):
        assert getattr(tboot, name) == getattr(jpl, name), name


def test_no_contract_stays_single_process(monkeypatch):
    import torch.distributed as dist
    for key in ("KUBEDL_COORDINATOR_ADDRESS", "KUBEDL_NUM_PROCESSES",
                "KUBEDL_PROCESS_ID", "TPU_WORKER_HOSTNAMES",
                "TPU_WORKER_ID"):
        monkeypatch.delenv(key, raising=False)
    info = tboot.initialize_distributed(device="cpu")
    assert (info.num_processes, info.process_id) == (1, 0)
    assert not dist.is_initialized()


def _rank_report():
    """One rank of the spawned group: open it from the env, twice (the
    second call is a no-op), and report what the group says."""
    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.runtime import bootstrap

    info = bootstrap.initialize_distributed(device="cpu")
    again = bootstrap.initialize_distributed(device="cpu")
    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    mesh = tmesh.build_mesh(device="cpu")
    out = {"info": (info.num_processes, info.process_id),
           "again": again == info, "rank": dist.get_rank(),
           "world": dist.get_world_size(),
           "backend": dist.get_backend(), "sum": float(x[0]),
           "mesh": dict(mesh.shape), "fsdp_index": mesh.index("fsdp"),
           "data": (mesh.data_index, mesh.data_size)}
    dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def two_ranks():
    return launch.spawn(_rank_report, 2, timeout=120)


def test_two_gloo_ranks_initialize_from_the_contract(two_ranks):
    for r, rep in enumerate(two_ranks):
        assert rep["info"] == (2, r) and rep["again"]
        assert (rep["rank"], rep["world"], rep["backend"]) == (r, 2, "gloo")
        assert rep["sum"] == 3.0


def test_the_default_mesh_puts_every_rank_on_fsdp(two_ranks):
    for r, rep in enumerate(two_ranks):
        assert rep["mesh"] == {"dp": 1, "fsdp": 2, "ep": 1, "pp": 1,
                               "cp": 1, "tp": 1}
        assert rep["fsdp_index"] == r and rep["data"] == (r, 2)


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        launch.spawn(_divide_by_zero, 1, timeout=60)


def _divide_by_zero():
    return 1 / 0
