"""LoRA: low-rank adapter fine-tuning for the llama family.

Counterpart of ``kubedl_tpu/ops/lora.py``. Fine-tunes train two small
matrices per weight (W + (x·A)·B·s, rank r) instead of the full model:

* :class:`LoraTensor` holds the frozen base and the trainable (A, B)
  factors; the shared ``quant.mm`` dispatch computes ``x·W + (x·A)·B·s``,
  with no merged copy of the weight in memory during training;
* the trainable tree holds only the adapters: :func:`merge_params`
  grafts them onto a frozen base inside the loss, so the optimizer state
  is adapter-sized and the base is never handed to the optimizer (its
  tensors do not require gradients);
* :func:`merge_to_dense` folds adapters into plain weights for serving
  (and for int8/int4 quantization) with no inference overhead.

:func:`adapter_specs` shards the adapters as the JAX package does: A
like its weight's input dim, B like its output dim.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar, Optional

import torch

from .quant import _Stacked

#: llama-family weight keys that take adapters by default (the attention
#: projections, the standard LoRA placement)
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


@dataclass(frozen=True)
class LoraTensor(_Stacked):
    """Frozen base [in, out] + trainable A [in, r], B [r, out]. ``scale``
    (alpha / rank) is metadata: slicing a layer slices only the tensors."""
    base: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    scale: float
    _arrays: ClassVar[tuple] = ("base", "a", "b")

    @property
    def shape(self):
        return tuple(self.base.shape)


def mm_lora(x, w: LoraTensor):
    """x·W + (x·A)·B·scale — called from ``quant.mm``'s dispatch. The
    scale is rounded to the output dtype first, as the JAX package's
    ``jnp.asarray(scale, y.dtype)``."""
    y = x @ w.base
    low = (x @ w.a.to(x.dtype)) @ w.b.to(x.dtype)
    return y + low * torch.full((), w.scale, dtype=y.dtype, device=y.device)


def init_adapters(params: dict, rank: int = 8, targets=DEFAULT_TARGETS,
                  generator: Optional[torch.Generator] = None) -> dict:
    """The trainable adapter tree for a llama-family param tree:
    ``{name: {"a": [L, in, r], "b": [L, r, out]}}`` per target, float32,
    on the weights' device. A is gaussian/√in (drawn from ``generator``,
    default seeded 0), B is zeros: the adapted model starts exactly equal
    to the base."""
    generator = generator or torch.Generator().manual_seed(0)
    layers = params["layers"]
    if not isinstance(layers, dict):
        raise ValueError("LoRA adapters require stacked layers")
    adapters = {}
    for name in sorted(targets):
        if name not in layers:
            raise ValueError(f"target {name!r} not in layer params")
        w = layers[name]                      # [L, in, out]
        n_layers, d_in, d_out = w.shape
        a = torch.randn((n_layers, d_in, rank), generator=generator,
                        device=generator.device, dtype=torch.float32)
        adapters[name] = {
            "a": (a * (1.0 / math.sqrt(d_in))).to(w.device),
            "b": torch.zeros((n_layers, rank, d_out), dtype=torch.float32,
                             device=w.device),
        }
    return adapters


def adapter_specs(base_specs: dict, adapters: dict) -> dict:
    """Specs for the adapter tree: A shards like the weight's input dim,
    B like its output dim (rank replicates)."""
    layer_specs = base_specs["layers"]
    out = {}
    for name in adapters:
        lead, in_ax, out_ax = (layer_specs[name][0], layer_specs[name][-2],
                               layer_specs[name][-1])
        out[name] = {"a": (lead, in_ax, None), "b": (lead, None, out_ax)}
    return out


def merge_params(base_params: dict, adapters: dict,
                 alpha: float = 16.0) -> dict:
    """Graft adapters onto a frozen base: target weights become LoraTensor
    leaves (rank read from A), everything else passes through by
    reference. Call inside the loss with the trainable ``adapters`` and
    ``base_params`` closed over."""
    layers = dict(base_params["layers"])
    for name, ab in adapters.items():
        rank = ab["a"].shape[-1]
        layers[name] = LoraTensor(base=base_params["layers"][name],
                                  a=ab["a"], b=ab["b"], scale=alpha / rank)
    return {**base_params, "layers": layers}


@torch.no_grad()
def merge_to_dense(base_params: dict, adapters: dict,
                   alpha: float = 16.0) -> dict:
    """Fold adapters into plain dense weights (W + A·B·s, summed in
    float32, cast to W's dtype) for serving."""
    layers = dict(base_params["layers"])
    for name, ab in adapters.items():
        w = base_params["layers"][name]
        rank = ab["a"].shape[-1]
        delta = torch.einsum("lir,lro->lio", ab["a"].float(),
                             ab["b"].float()) * (alpha / rank)
        layers[name] = (w.float() + delta).to(w.dtype)
    return {**base_params, "layers": layers}
