"""Weight-only quantization for serving: int8 and packed int4.

Counterpart of ``kubedl_tpu/ops/quant.py``, with the same schemes, layouts
and arithmetic order, so both packages quantize the same weights to the
same bits:

* **int8** — symmetric per-output-channel: ``y = (x @ q.to(x.dtype)) *
  scale`` (scale [out], float32);
* **int4** — two signed nibbles packed per int8 byte along the
  contraction axis (low nibble = even input row), with group-wise float32
  scales (``group`` input rows share one scale per output channel).

On the card the dequantize runs as plain PyTorch ops ahead of a cuBLAS
matmul, where the JAX package leaves XLA to fuse it into the dot; the
quantized leaves stay quantized in device memory and every op is a
device op, so a captured decode graph replays them with no host sync.

Quantization is serving-only: the trainer never sees quantized leaves.
The wrapped leaves (:class:`QTensor`, :class:`Q4Tensor`, and
``ops.lora.LoraTensor``) index and unbind field by field along their
stacked layer axis, so the model's per-layer loop slices them as it
slices a tensor; metadata (``group``, LoRA's ``scale``) rides along.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import ClassVar

import torch


class _Stacked:
    """Field-wise indexing of a wrapped weight stacked on leading axes:
    ``w[i]`` and ``w.unbind(0)`` slice every tensor field and keep the
    metadata fields; ``w.to(device)`` moves the tensor fields."""

    #: the tensor fields (the rest are metadata)
    _arrays: ClassVar[tuple] = ()

    def _map(self, fn):
        return dataclasses.replace(
            self, **{f: fn(getattr(self, f)) for f in self._arrays})

    def __getitem__(self, i):
        return self._map(lambda t: t[i])

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("wrapped weights unbind along their layer axis")
        parts = {f: getattr(self, f).unbind(0) for f in self._arrays}
        n = len(parts[self._arrays[0]])
        return [dataclasses.replace(self,
                                    **{f: p[i] for f, p in parts.items()})
                for i in range(n)]

    def to(self, device):
        return self._map(lambda t: t.to(device))

    @property
    def device(self) -> torch.device:
        return getattr(self, self._arrays[0]).device

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(getattr(self, f)) for f in self._arrays)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass(frozen=True)
class QTensor(_Stacked):
    """int8 weights + per-output-channel float32 scale (shape [out])."""
    q: torch.Tensor
    scale: torch.Tensor
    _arrays: ClassVar[tuple] = ("q", "scale")

    @property
    def shape(self):
        return tuple(self.q.shape)


@dataclass(frozen=True)
class Q4Tensor(_Stacked):
    """Packed int4 weights: ``packed[..., in/2, out]`` int8 holds two
    signed nibbles of consecutive input rows (low nibble = even row);
    ``scale[..., in/group, out]`` float32; ``group`` is metadata."""
    packed: torch.Tensor
    scale: torch.Tensor
    group: int
    _arrays: ClassVar[tuple] = ("packed", "scale")

    @property
    def shape(self):
        *lead, in2, out = self.packed.shape
        return (*lead, in2 * 2, out)


def _per_layer(w, fn, device=None):
    """``fn`` over each [in, out] matrix of ``w`` [..., in, out] (one at a
    time on ``device``, default ``w``'s), stacked back: the float32
    intermediates of a whole stack never exist at once, and every matrix
    quantizes independently, so the bits are those of one call."""
    w = torch.as_tensor(w)
    dev = w.device if device is None else torch.device(device)
    if w.ndim == 2:
        return fn(w.to(dev))
    lead = w.shape[:-2]
    flat = w.reshape(-1, *w.shape[-2:])
    outs = None
    for i in range(flat.shape[0]):
        got = fn(flat[i].to(dev))
        if outs is None:
            outs = tuple(torch.empty((flat.shape[0], *g.shape), dtype=g.dtype,
                                     device=g.device) for g in got)
        for o, g in zip(outs, got):
            o[i].copy_(g)
    return tuple(o.reshape(*lead, *o.shape[1:]) for o in outs)


def _int8(w):
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)            # [1, out]
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale[0]


def quantize_int8(w, device=None) -> QTensor:
    """[in, out] (or [..., in, out]) float weights -> symmetric int8 with
    per-output-channel scales over the contraction (in) axis, on
    ``device`` (default: where ``w`` lies)."""
    q, scale = _per_layer(w, _int8, device)
    return QTensor(q=q, scale=scale)


def quantize_int4(w, group: int = 64, device=None) -> Q4Tensor:
    """[in, out] (or [..., in, out]) float weights -> packed signed int4
    with group-wise scales over the contraction axis. ``in`` must be even;
    a non-divisible ``group`` falls back to one group per tensor."""
    n_in = torch.as_tensor(w).shape[-2]
    if n_in % 2:
        raise ValueError(f"int4 packing needs an even in-dim, got {n_in}")
    if n_in % group:
        group = n_in

    def one(m):
        wf = m.float()
        out = wf.shape[-1]
        wg = wf.reshape(n_in // group, group, out)
        amax = wg.abs().amax(dim=-2, keepdim=True)
        scale = torch.clamp_min(amax, 1e-8) / 7.0
        q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8)
        q = q.reshape(n_in // 2, 2, out)
        lo, hi = q[:, 0, :], q[:, 1, :]
        packed = ((hi << 4) | (lo & 0x0F)).to(torch.int8)
        return packed, scale[:, 0, :]

    packed, scale = _per_layer(w, one, device)
    return Q4Tensor(packed=packed, scale=scale, group=group)


def _unpack_int4(w: Q4Tensor, dtype):
    """Q4Tensor -> dense [..., in, out] in ``dtype``: sign-extending shifts
    on int8, the group rescale in float32, then the cast."""
    lo = (w.packed << 4) >> 4          # sign-extend the low nibble
    hi = w.packed >> 4                 # arithmetic shift
    *lead, in2, out = w.packed.shape
    n_in = in2 * 2
    q = torch.stack([lo, hi], dim=-2).reshape(*lead, n_in, out)
    qg = q.reshape(*lead, n_in // w.group, w.group, out).float()
    dense = qg * w.scale[..., :, None, :].float()
    return dense.reshape(*lead, n_in, out).to(dtype)


def to_dense(w, dtype=torch.bfloat16):
    """QTensor/Q4Tensor -> dense float weights (dense tensors pass
    through)."""
    if isinstance(w, QTensor):
        return (w.q.float() * w.scale[..., None, :].float()).to(dtype)
    if isinstance(w, Q4Tensor):
        return _unpack_int4(w, dtype)
    return w


def mm(x, w):
    """x @ w — the one matmul dispatch for the llama-family weights: dense
    tensors, QTensor (int8 dequantize-on-the-fly), Q4Tensor (unpacked
    operand) or LoraTensor (frozen base + trainable low-rank delta)."""
    if isinstance(w, QTensor):
        y = x @ w.q.to(x.dtype)
        return y * w.scale.to(y.dtype)
    if isinstance(w, Q4Tensor):
        # group scales vary along the contraction axis, so the rescale
        # cannot move to the epilogue: the operand is unpacked first
        return x @ _unpack_int4(w, x.dtype)
    from .lora import LoraTensor, mm_lora
    if isinstance(w, LoraTensor):
        return mm_lora(x, w)
    return x @ w


#: param-dict keys that hold large matmul weights worth quantizing; the
#: embedding stays float (it is gathered, not multiplied), norms are tiny
QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")

_MODES = {"int8": quantize_int8, "int4": quantize_int4}


def quantize_params(params: dict, mode: str = "int8", device=None) -> dict:
    """Quantize a llama/gemma-family param tree's matmul weights (returns
    a new tree; other leaves pass through). ``mode``: "int8" (per-channel)
    or "int4" (packed, group scales). With ``device`` every leaf lands
    there, the quantized ones one matrix at a time, so a tree held on the
    host reaches the card already quantized."""
    if mode not in _MODES:
        raise ValueError(f"unknown quantize mode {mode!r} "
                         f"(one of {sorted(_MODES)})")
    quantize = _MODES[mode]

    def walk(node):
        if isinstance(node, dict):
            return {k: (quantize(v, device=device)
                        if k in QUANTIZABLE and _is_weight(v) else walk(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node if device is None else node.to(device)

    def _is_weight(v):
        return torch.is_tensor(v) and v.ndim >= 2

    return walk(params)


def tree_nbytes(params) -> int:
    """Total parameter bytes (quantization-aware): the device memory the
    weights occupy."""
    if isinstance(params, dict):
        return sum(tree_nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_nbytes(v) for v in params)
    if isinstance(params, _Stacked):
        return params.nbytes
    return _nbytes(params)
