"""Pod-spec rendering for TPU slices.

This is where "TPU-native" lands in the operator (the analog of — and the
replacement for — the reference's GPU-era pod mutation in
``pkg/job_controller/pod.go:365-448``): every worker pod of a slice gets

* ``google.com/tpu: <chips_per_host>`` resource requests/limits,
* ``cloud.google.com/gke-tpu-accelerator`` + ``gke-tpu-topology``
  nodeSelectors so GKE lands the whole gang on one slice,
* the PJRT rendezvous env: ``TPU_WORKER_ID`` / ``TPU_WORKER_HOSTNAMES``
  (the TPU equivalent of PyTorch's MASTER_ADDR/RANK wiring in
  ``controllers/pytorch/pytorchjob_controller.go:254-300``),
* JAX coordinator env for ``jax.distributed.initialize``, and
* for multislice jobs, the MEGASCALE DCN coordinator env.

Worker IDs are assigned in physical topology order (replica index == host
index in the slice), which is what keeps XLA's ICI collectives legal after
restarts — the "stable worker IDs" hard part from SURVEY.md §7.

Copied from ``kubedl_tpu/tpu/placement.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from .topology import SliceSpec

from ..api.common import RESOURCE_TPU

NODE_SELECTOR_ACCELERATOR = "cloud.google.com/gke-tpu-accelerator"
NODE_SELECTOR_TOPOLOGY = "cloud.google.com/gke-tpu-topology"

# PJRT / libtpu contract (GKE multi-host TPU docs)
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_TPU_ACCELERATOR_TYPE = "TPU_ACCELERATOR_TYPE"

# jax.distributed contract consumed by kubedl_tpu_torch.runtime.bootstrap
ENV_COORDINATOR_ADDRESS = "KUBEDL_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "KUBEDL_NUM_PROCESSES"
ENV_PROCESS_ID = "KUBEDL_PROCESS_ID"

# multislice (DCN) contract consumed by libtpu/megascale
ENV_MEGASCALE_COORDINATOR = "MEGASCALE_COORDINATOR_ADDRESS"
ENV_MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"

DEFAULT_COORDINATOR_PORT = 8476


def upsert_env(container: dict, name: str, value=None, value_from: Optional[dict] = None):
    env = container.setdefault("env", [])
    for e in env:
        if e.get("name") == name:
            if value_from is not None:
                e.pop("value", None)
                e["valueFrom"] = value_from
            else:
                e.pop("valueFrom", None)
                e["value"] = str(value)
            return
    item = {"name": name}
    if value_from is not None:
        item["valueFrom"] = value_from
    else:
        item["value"] = str(value)
    env.append(item)


def get_env(container: dict, name: str):
    for e in container.get("env", []) or []:
        if e.get("name") == name:
            return e.get("value")
    return None


def find_container(pod_spec: dict, name: Optional[str] = None) -> Optional[dict]:
    """The framework's main container by name, else the first container."""
    containers = pod_spec.get("containers", []) or []
    if name:
        for ct in containers:
            if ct.get("name") == name:
                return ct
    return containers[0] if containers else None


def replica_name(job_name: str, replica_type: str, index: int) -> str:
    """Pod/service name for one replica: ``{job}-{rt}-{index}`` (the
    reference's GenGeneralName convention). ``index`` is global across
    slices for multislice jobs, so names are always unique."""
    return f"{job_name}-{replica_type.lower()}-{index}"


def service_dns(job_name: str, replica_type: str, index: int, namespace: str,
                domain: str = "") -> str:
    """The reference's endpoint convention (``controllers/tensorflow/
    tensorflow.go:124-145``): one headless service per replica, DNS name
    ``{job}-{rt}-{i}.{ns}.svc[.domain]``."""
    base = f"{replica_name(job_name, replica_type, index)}.{namespace}.svc"
    return f"{base}.{domain}" if domain else base


def render_tpu_worker(pod: dict, *, slice_spec: SliceSpec, job_name: str,
                      namespace: str, replica_type: str, worker_id: int,
                      num_slices: int = 1,
                      container_name: Optional[str] = None,
                      coordinator_port: int = DEFAULT_COORDINATOR_PORT,
                      dns_domain: str = "",
                      worker_hostnames: Optional[list] = None,
                      coordinator_address: Optional[str] = None) -> dict:
    """Mutate a worker pod dict into a TPU slice member. Returns the pod.

    ``worker_id`` is the replica's **global** index across all slices
    (0 .. num_hosts*num_slices-1); the slice id and in-slice host id are
    derived from it, so replica index order == physical topology order.

    ``worker_hostnames`` overrides the default same-replica-type DNS list
    (global order) — jobs that spread TPU processes over several replica
    types (Master+Worker) pass the cross-type list; ``coordinator_address``
    likewise overrides the global process-0 address.
    """
    spec = pod.setdefault("spec", {})
    n = slice_spec.num_hosts
    slice_id, host_id = divmod(worker_id, n)
    if not 0 <= slice_id < num_slices:
        raise ValueError(
            f"worker_id {worker_id} out of range for {num_slices} slice(s) of {n} host(s)")

    # -- placement: land on the right slice hardware
    sel = spec.setdefault("nodeSelector", {})
    sel.setdefault(NODE_SELECTOR_ACCELERATOR, slice_spec.gke_accelerator)
    sel.setdefault(NODE_SELECTOR_TOPOLOGY, slice_spec.topology_str)
    tolerations = spec.setdefault("tolerations", [])
    if not any(t.get("key") == RESOURCE_TPU for t in tolerations):
        tolerations.append({"key": RESOURCE_TPU, "operator": "Exists",
                            "effect": "NoSchedule"})

    ct = find_container(spec, container_name)
    if ct is None:
        raise ValueError(f"pod for {job_name}/{replica_type}[{worker_id}] has no containers")

    # -- chips: one worker pod sees a full host's chips
    res = ct.setdefault("resources", {})
    for kk in ("limits", "requests"):
        res.setdefault(kk, {})
        res[kk][RESOURCE_TPU] = str(slice_spec.chips_per_host)

    # -- rendezvous env (PJRT + jax.distributed). TPU_WORKER_HOSTNAMES is
    # per-slice (ICI rendezvous) and TPU_WORKER_ID is the in-slice host id;
    # the jax.distributed / MEGASCALE coordinator is global — always global
    # worker 0 (DCN rendezvous).
    if worker_hostnames is not None:
        slice_hosts = worker_hostnames[slice_id * n:(slice_id + 1) * n]
    else:
        slice_hosts = [
            service_dns(job_name, replica_type, slice_id * n + i, namespace, dns_domain)
            for i in range(n)]
    hostnames = ",".join(slice_hosts)
    coordinator = coordinator_address or (
        f"{service_dns(job_name, replica_type, 0, namespace, dns_domain)}"
        f":{coordinator_port}")
    upsert_env(ct, ENV_TPU_WORKER_ID, host_id)
    upsert_env(ct, ENV_TPU_WORKER_HOSTNAMES, hostnames)
    upsert_env(ct, ENV_TPU_ACCELERATOR_TYPE, slice_spec.accelerator_type)
    upsert_env(ct, ENV_COORDINATOR_ADDRESS, coordinator)
    upsert_env(ct, ENV_NUM_PROCESSES, n * num_slices)
    upsert_env(ct, ENV_PROCESS_ID, worker_id)

    # -- multislice: DCN coordination rides the pod network
    if num_slices > 1:
        upsert_env(ct, ENV_MEGASCALE_COORDINATOR, coordinator)
        upsert_env(ct, ENV_MEGASCALE_NUM_SLICES, num_slices)
        upsert_env(ct, ENV_MEGASCALE_SLICE_ID, slice_id)

    # -- expose the coordinator port
    ports = ct.setdefault("ports", [])
    if not any(p.get("containerPort") == coordinator_port for p in ports):
        ports.append({"name": "coordinator", "containerPort": coordinator_port})
    return pod
