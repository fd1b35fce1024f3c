"""Device-mesh layout: the counterpart of ``kubedl_tpu/parallel/mesh.py``.

The axes carry the same parallelism taxonomy, outermost to innermost:
``dp`` (data), ``fsdp`` (data with sharded params and optimizer state),
``ep`` (experts), ``pp`` (pipeline stages), ``cp`` (context / sequence)
and ``tp`` (tensor), resolved by the same :meth:`MeshConfig.resolve`.

In torch every card is its own process, so a mesh of more than one card
needs a process group first (``runtime.bootstrap.initialize_distributed``).
With a group open, :func:`build_mesh` lays the group's ranks out over a
``torch.distributed.device_mesh.DeviceMesh`` in the JAX axis order (rank
``r`` sits where device ``r`` sits in the JAX mesh's reshape). Without
one it returns the one-device mesh of earlier slices, and any axis above
1 is a layout this one process cannot hold.

Every axis trains (``train/trainer.py``): ``dp``, ``fsdp``, ``tp``,
``cp`` (ring and Ulysses attention, ``parallel/ring.py`` and
``parallel/ulysses.py``), ``ep`` (MoE experts, ``models/moe.py``) and
``pp`` (pipeline stages, ``parallel/pipeline.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from .._device import resolve_device

AXES = ("dp", "fsdp", "ep", "pp", "cp", "tp")


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = -1   # -1: absorb remaining devices
    ep: int = 1
    pp: int = 1
    cp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> tuple:
        sizes = tuple(getattr(self, a) for a in AXES)
        if any(d < 1 and d != -1 for d in sizes):
            raise ValueError(
                f"mesh axis sizes must be >= 1 (or -1 to absorb): "
                f"{dict(zip(AXES, sizes))}")
        known = [d for d in sizes if d != -1]
        rest = n_devices // math.prod(known) if known else n_devices
        dims = tuple(rest if d == -1 else d for d in sizes)
        if math.prod(dims) != n_devices:
            raise ValueError(
                f"mesh {dict(zip(AXES, dims))} needs {math.prod(dims)} "
                f"devices, have {n_devices}")
        return dims


@dataclass(frozen=True)
class Mesh:
    """A resolved layout: this process's device, the size of every axis
    and, under a process group, the ``DeviceMesh`` over the group's
    ranks (None for the one-device mesh)."""
    device: torch.device
    shape: dict
    device_mesh: object = None

    @property
    def sharded(self) -> bool:
        """Whether any axis spans more than one rank (collectives run)."""
        return any(n > 1 for n in self.shape.values())

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 on one device)."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of ``axis`` through this rank."""
        return self.device_mesh.get_group(axis)

    @property
    def data_size(self) -> int:
        """Ranks the global batch is split over (``dp`` x ``fsdp``)."""
        return self.size("dp") * self.size("fsdp")

    @property
    def data_index(self) -> int:
        """Which slice of the global batch this rank holds (``dp``
        major, as JAX's ``(dp, fsdp)`` split orders its shards)."""
        return self.index("dp") * self.size("fsdp") + self.index("fsdp")


def build_mesh(config: Optional[MeshConfig] = None, device=None) -> Mesh:
    """The named mesh on ``device`` (the card unless the caller names the
    CPU). Under an open process group its axes cover the group's ranks,
    with ``MeshConfig``'s default (-1) putting every rank on ``fsdp``;
    without one it is the one-device mesh."""
    config = config or MeshConfig()
    dev = resolve_device(device)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        dims = config.resolve(dist.get_world_size())
        dm = init_device_mesh(dev.type, dims, mesh_dim_names=AXES)
        return Mesh(device=dev, shape=dict(zip(AXES, dims)), device_mesh=dm)
    dims = config.resolve(1)
    return Mesh(device=dev, shape=dict(zip(AXES, dims)))


def data_axes() -> tuple:
    """Mesh axes the global batch is sharded over."""
    return ("dp", "fsdp")


def batch_spec() -> tuple:
    """``[batch, seq]`` tokens: batch over ``(dp, fsdp)``, seq over
    ``cp`` (the ``PartitionSpec`` of the JAX package, as a tuple)."""
    return (("dp", "fsdp"), "cp")


def host_local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape["dp"] * mesh.shape["fsdp"]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"dp*fsdp={n}")
    return global_batch // n
