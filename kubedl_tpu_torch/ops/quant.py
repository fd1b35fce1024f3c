"""The matmul dispatch for the llama-family weights.

Counterpart of ``kubedl_tpu/ops/quant.py``. This slice serves dense
weights only; the int8 ``QTensor`` and packed int4 ``Q4Tensor`` (and the
LoRA ``LoraTensor``) arrive with ROADMAP queue A's quantization/LoRA
item and raise until then.
"""

from __future__ import annotations

import torch


def mm(x, w):
    """x @ w for a dense ``[in, out]`` weight tensor."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"{type(w).__name__} weights are not ported yet: quantized "
            "(QTensor/Q4Tensor) and LoRA weights arrive with ROADMAP queue "
            "A's quantization/LoRA/MoE item")
    return x @ w
