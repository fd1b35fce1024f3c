"""Device-mesh layout: the counterpart of ``kubedl_tpu/parallel/mesh.py``.

The axes carry the same parallelism taxonomy, outermost to innermost:
``dp`` (data), ``fsdp`` (data with sharded params and optimizer state),
``ep`` (experts), ``pp`` (pipeline stages), ``cp`` (context / sequence)
and ``tp`` (tensor). This slice trains on one card, so
:func:`build_mesh` takes only a layout that resolves to one device; a
layout across cards raises until ROADMAP A5 (context, tensor and
pipeline parallelism over ``torch.distributed``) lands.
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
    """A resolved layout: the device and the size of every axis."""
    device: torch.device
    shape: dict


def build_mesh(config: Optional[MeshConfig] = None, device=None) -> Mesh:
    """The one-device mesh on ``device`` (the card unless the caller
    names the CPU). Any axis above 1 raises: sharded training is ROADMAP
    A5."""
    config = config or MeshConfig()
    sizes = {a: getattr(config, a) for a in AXES}
    if any(d > 1 for d in sizes.values()):
        raise NotImplementedError(
            f"mesh {sizes} spans more than one device: multi-device "
            "training (dp/fsdp/ep/pp/cp/tp over torch.distributed) is "
            "ROADMAP A5, not ported yet")
    dims = config.resolve(1)
    return Mesh(device=resolve_device(device), shape=dict(zip(AXES, dims)))
