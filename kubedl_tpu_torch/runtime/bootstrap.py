"""In-container rendezvous bootstrap: the counterpart of
``kubedl_tpu/runtime/bootstrap.py``.

The consumer of the operator's injected env: a training container calls
:func:`initialize_distributed` to open a ``torch.distributed`` process
group from ``KUBEDL_COORDINATOR_ADDRESS`` / ``KUBEDL_NUM_PROCESSES`` /
``KUBEDL_PROCESS_ID`` (with GKE-native ``TPU_WORKER_ID`` /
``TPU_WORKER_HOSTNAMES`` as fallback). :func:`rendezvous_from_env` reads
the contract with the JAX package's rules, word for word; the env names
are the port's own copy of ``kubedl_tpu/tpu/placement.py``'s.

The group is NCCL on the card (``device_id`` = ``cuda:$LOCAL_RANK``, 0
when unset) and gloo on the CPU, over a ``tcp://`` init method on the
coordinator address.

One deliberate difference: the JAX function does nothing at one process,
because a JAX mesh needs no process group. A torch ``DeviceMesh`` does,
so here a group opens whenever the contract is present, a one-process
contract included. With no contract the job stays single-process with no
group, as before.

``pin_platform`` has no counterpart: it re-pins JAX's live platform
config, and torch has no such global (the device is an argument).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger("kubedl_tpu_torch.bootstrap")

# PJRT / libtpu contract (GKE multi-host TPU docs)
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"

# the operator's rendezvous contract
ENV_COORDINATOR_ADDRESS = "KUBEDL_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "KUBEDL_NUM_PROCESSES"
ENV_PROCESS_ID = "KUBEDL_PROCESS_ID"

# multislice (DCN) contract
ENV_MEGASCALE_COORDINATOR = "MEGASCALE_COORDINATOR_ADDRESS"
ENV_MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"

DEFAULT_COORDINATOR_PORT = 8476

#: which card of the host this process drives (one process per card)
ENV_LOCAL_RANK = "LOCAL_RANK"


@dataclass(frozen=True)
class RendezvousInfo:
    coordinator_address: str
    num_processes: int
    process_id: int
    slice_id: int = 0
    num_slices: int = 1

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def rendezvous_from_env(
        env: Optional[dict] = None) -> Optional[RendezvousInfo]:
    """Parse the operator contract from the environment; None when absent."""
    env = env if env is not None else dict(os.environ)
    coord = env.get(ENV_COORDINATOR_ADDRESS, "")
    nproc = env.get(ENV_NUM_PROCESSES, "")
    pid = env.get(ENV_PROCESS_ID, "")
    if coord and nproc and pid == "":
        # a partial contract would rendezvous every worker as process 0 and
        # hang far from the root cause: fail here instead
        raise ValueError(
            f"{ENV_COORDINATOR_ADDRESS} and {ENV_NUM_PROCESSES} are set "
            f"but {ENV_PROCESS_ID} is missing")
    if not (coord and nproc):
        # GKE-native fallback: derive from TPU_WORKER_* (single slice)
        hostnames = env.get(ENV_TPU_WORKER_HOSTNAMES, "")
        worker_id = env.get(ENV_TPU_WORKER_ID, "")
        if not hostnames or worker_id == "":
            return None
        hosts = [h.strip() for h in hostnames.split(",") if h.strip()]
        coord = f"{hosts[0]}:{DEFAULT_COORDINATOR_PORT}"
        nproc, pid = str(len(hosts)), worker_id
    num_slices = int(env.get(ENV_MEGASCALE_NUM_SLICES, 1) or 1)
    slice_id = int(env.get(ENV_MEGASCALE_SLICE_ID, 0) or 0)
    return RendezvousInfo(
        coordinator_address=coord,
        num_processes=int(nproc),
        process_id=int(pid or 0),
        slice_id=slice_id,
        num_slices=num_slices)


def initialize_distributed(info: Optional[RendezvousInfo] = None,
                           device=None) -> RendezvousInfo:
    """Idempotent ``torch.distributed.init_process_group`` from the
    operator env: NCCL when ``device`` is a card (the default), gloo when
    it is the CPU. Returns the rendezvous info used (a 1-process info,
    and no group, when the env carries no contract)."""
    if info is None:
        info = rendezvous_from_env()
    if info is None:
        log.info("no rendezvous env found; running single-process")
        return RendezvousInfo("localhost:0", 1, 0)
    import torch
    import torch.distributed as dist

    from .._device import resolve_device
    if dist.is_initialized():
        log.info("torch.distributed already initialized")
        return info
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get(ENV_LOCAL_RANK, "0") or 0)
        torch.cuda.set_device(local)
        kw = {"backend": "nccl", "device_id": torch.device("cuda", local)}
    else:
        kw = {"backend": "gloo"}
    dist.init_process_group(
        init_method=f"tcp://{info.coordinator_address}",
        world_size=info.num_processes, rank=info.process_id, **kw)
    log.info("torch.distributed initialized (%s): process %d/%d via %s",
             kw["backend"], info.process_id, info.num_processes,
             info.coordinator_address)
    return info
