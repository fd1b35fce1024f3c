"""MNIST-class MLP: the counterpart of ``kubedl_tpu/models/mlp.py``
(BASELINE config 1, the CPU smoke-test model).

Parameters are ``{"layers": [{"w": [in, out], "b": [out]}, ...]}``, the
JAX package's tree; ReLU between layers, float32 logits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from .llama import _DTYPES


@dataclass
class MLPConfig:
    in_dim: int = 784
    hidden: tuple = (512, 256)
    n_classes: int = 10
    #: a torch dtype, or its name (``"float32"``)
    dtype: object = torch.float32

    def __post_init__(self):
        self.dtype = _DTYPES.get(self.dtype, self.dtype)

    @property
    def dims(self) -> tuple:
        return (self.in_dim,) + tuple(self.hidden) + (self.n_classes,)


def param_shapes(config: MLPConfig) -> dict:
    d = config.dims
    return {"layers": [{"w": (i, o), "b": (o,)}
                       for i, o in zip(d[:-1], d[1:])]}


def param_specs(config: MLPConfig) -> dict:
    """Replicated weights (the JAX package's specs)."""
    from ..parallel.sharding import spec
    n = len(config.hidden) + 1
    return {"layers": [{"w": spec(None, None), "b": spec(None)}] * n}


def init_params(config: MLPConfig, generator: torch.Generator,
                device=None) -> dict:
    """normal / sqrt(fan_in) weights and zero biases, the JAX package's
    scaling; draws come from ``generator`` on its own device."""
    dev = resolve_device(device)
    layers = []
    for lp in param_shapes(config)["layers"]:
        w = torch.randn(lp["w"], generator=generator,
                        device=generator.device) / math.sqrt(lp["w"][0])
        layers.append({"w": w.to(dev, config.dtype),
                       "b": torch.zeros(lp["b"], dtype=config.dtype,
                                        device=dev)})
    return {"layers": layers}


def params_from_numpy(config: MLPConfig, tree: dict, device=None) -> dict:
    """The JAX package's tree (numpy leaves) -> the port's, shapes
    checked."""
    dev = resolve_device(device)
    want = param_shapes(config)["layers"]
    if len(tree["layers"]) != len(want):
        raise ValueError(f"{len(tree['layers'])} layers, the config wants "
                         f"{len(want)}")
    out = []
    for i, (lp, shapes) in enumerate(zip(tree["layers"], want)):
        leaf = {}
        for k, shape in shapes.items():
            arr = np.array(lp[k], np.float32)
            if arr.shape != shape:
                raise ValueError(f"layers/{i}/{k}: shape {arr.shape}, the "
                                 f"config wants {shape}")
            leaf[k] = torch.from_numpy(arr).to(dev, config.dtype)
        out.append(leaf)
    return {"layers": out}


def forward(config: MLPConfig, params: dict, x):
    """x [b, in_dim] -> logits [b, n_classes] float32."""
    h = x.to(config.dtype)
    layers = params["layers"]
    for lp in layers[:-1]:
        h = torch.relu(h @ lp["w"] + lp["b"])
    out = h @ layers[-1]["w"] + layers[-1]["b"]
    return out.float()


def loss_fn(config: MLPConfig, params: dict, x, labels):
    logits = forward(config, params, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return (logz - gold).mean()


def accuracy(config: MLPConfig, params: dict, x, labels):
    return (forward(config, params, x).argmax(-1) == labels).float().mean()
