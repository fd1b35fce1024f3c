"""ResNet-v1.5 family: the counterpart of ``kubedl_tpu/models/resnet.py``
(BASELINE config 2, the vision bench model).

The JAX package's choices, kept:

* NHWC activations end to end: ``images`` arrive ``[b, h, w, 3]`` and
  run as ``channels_last`` tensors (the same bytes, NCHW indexing);
  conv weights are held ``[out, in, kh, kw]`` in ``channels_last``
  memory (the JAX tree's ``[kh, kw, in, out]`` crosses through
  :func:`params_from_numpy`);
* ``padding="SAME"`` as XLA pads it: ``total = max((out-1)*s + k - in,
  0)`` with the odd pixel at the END (the 7x7/2 stem on 224 pads (2, 3),
  3x3/2 convs and the 3x3/2 max-pool on even sizes pad (0, 1)), where
  ``conv2d(padding=k//2)`` would pad symmetrically and shift every
  window; the pool pads with -inf;
* batch-statistics normalization in float32 with the biased variance and
  no running statistics;
* the stride-2 downsample on the 3x3 conv (v1.5).

The parameter tree holds lists (``stages`` is a list of lists of
blocks); ``train.trainer.tree_leaves`` walks them in index order, as JAX
flattens them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from .llama import _DTYPES

#: per-depth block counts; stage widths are width * (1, 2, 4, 8)
_DEPTHS = {
    18: (2, 2, 2, 2),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


@dataclass
class ResNetConfig:
    depth: int = 50
    n_classes: int = 1000
    width: int = 64          # first-stage width; later stages double it
    #: a torch dtype, or its name (``"bfloat16"``)
    dtype: object = torch.bfloat16

    def __post_init__(self):
        self.dtype = _DTYPES.get(self.dtype, self.dtype)

    @property
    def bottleneck(self) -> bool:
        return self.depth >= 50

    @property
    def stages(self) -> tuple:
        return tuple((self.width * (2 ** i), blocks)
                     for i, blocks in enumerate(_DEPTHS[self.depth]))


def resnet50() -> ResNetConfig:
    return ResNetConfig(depth=50)


def resnet18() -> ResNetConfig:
    return ResNetConfig(depth=18)


def tiny() -> ResNetConfig:
    """CI config: 18-layer at 1/8 width."""
    return ResNetConfig(depth=18, width=8, n_classes=10)


# -- params ------------------------------------------------------------------

def _block_stride(stage_index: int, block_index: int) -> int:
    return 2 if (block_index == 0 and stage_index > 0) else 1


def _bn_shapes(c: int) -> dict:
    return {"scale": (c,), "bias": (c,)}


def param_shapes(config: ResNetConfig) -> dict:
    """The parameter tree with each leaf's shape: conv weights
    ``[out, in, kh, kw]``, the head ``[in, out]``."""
    c = config
    w = c.width
    tree = {"stem": {"conv": (w, 3, 7, 7), "bn": _bn_shapes(w)},
            "stages": []}
    c_in = w
    for si, (width, blocks) in enumerate(c.stages):
        stage = []
        for b in range(blocks):
            stride = _block_stride(si, b)
            c_out = width * (4 if c.bottleneck else 1)
            if c.bottleneck:
                block = {"conv1": (width, c_in, 1, 1),
                         "conv2": (width, width, 3, 3),
                         "conv3": (c_out, width, 1, 1),
                         "bn1": _bn_shapes(width), "bn2": _bn_shapes(width),
                         "bn3": _bn_shapes(c_out)}
            else:
                block = {"conv1": (width, c_in, 3, 3),
                         "conv2": (c_out, width, 3, 3),
                         "bn1": _bn_shapes(width), "bn2": _bn_shapes(c_out)}
            if stride != 1 or c_in != c_out:
                block["proj"] = (c_out, c_in, 1, 1)
                block["proj_bn"] = _bn_shapes(c_out)
            stage.append(block)
            c_in = c_out
        tree["stages"].append(stage)
    tree["head"] = {"w": (c_in, c.n_classes), "b": (c.n_classes,)}
    return tree


def _map(tree, fn, path=""):
    """``fn(path, leaf)`` over a tree of dicts, lists and leaves."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{path}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, f"{path}{i}/") for i, v in enumerate(tree)]
    return fn(path[:-1], tree)


def param_specs(config: ResNetConfig) -> dict:
    """Replicated weights (data-parallel vision training), congruent with
    the parameter tree: the JAX package's specs."""
    from ..parallel.sharding import spec
    return _map(param_shapes(config), lambda _, s: spec())


def num_params(config: ResNetConfig) -> int:
    total = []
    _map(param_shapes(config), lambda _, s: total.append(math.prod(s)))
    return sum(total)


def _place(t: torch.Tensor, dev, dtype) -> torch.Tensor:
    t = t.to(dev, dtype)
    return t.contiguous(memory_format=torch.channels_last) \
        if t.ndim == 4 else t


def init_params(config: ResNetConfig, generator: torch.Generator,
                device=None) -> dict:
    """He-normal convs (sqrt(2 / fan_in)), a normal / sqrt(fan_in) head,
    zero head bias, identity norms: the JAX package's scaling; draws come
    from ``generator`` on its own device."""
    c = config
    dev = resolve_device(device)

    def leaf(path, shape):
        name = path.split("/")[-1]
        if len(shape) == 4:
            draw = torch.randn(shape, generator=generator,
                               device=generator.device)
            return _place(draw * math.sqrt(2.0 / math.prod(shape[1:])), dev,
                          c.dtype)
        if path == "head/w":
            draw = torch.randn(shape, generator=generator,
                               device=generator.device)
            return (draw / math.sqrt(shape[0])).to(dev, c.dtype)
        if path == "head/b":
            return torch.zeros(shape, dtype=c.dtype, device=dev)
        fill = 1.0 if name == "scale" else 0.0
        return torch.full(shape, fill, dtype=torch.float32, device=dev)

    return _map(param_shapes(c), leaf)


def params_from_numpy(config: ResNetConfig, tree: dict, device=None) -> dict:
    """The JAX package's tree (numpy leaves, HWIO convs) -> the port's
    (OIHW convs in ``channels_last`` memory, norms float32), shapes
    checked against the config."""
    dev = resolve_device(device)

    def pick(path):
        node = tree
        for k in path.split("/"):
            node = node[int(k)] if isinstance(node, (list, tuple)) \
                else node[k]
        return np.asarray(node, np.float32)

    def leaf(path, shape):
        arr = np.array(pick(path))
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        if arr.shape != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape}, the config wants "
                             f"{tuple(shape)}")
        bn = path.split("/")[-1] in ("scale", "bias")
        return _place(torch.from_numpy(np.ascontiguousarray(arr)), dev,
                      torch.float32 if bn else config.dtype)

    return _map(param_shapes(config), leaf)


# -- forward -----------------------------------------------------------------

def _same(size: int, k: int, s: int) -> tuple:
    """XLA's ``SAME`` padding of one spatial dim: (before, after), the odd
    pixel after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    (t, b) = _same(x.shape[2], w.shape[2], stride)
    (left, right) = _same(x.shape[3], w.shape[3], stride)
    if t == b and left == right:
        return F.conv2d(x, w, stride=stride, padding=(t, left))
    return F.conv2d(F.pad(x, (left, right, t, b)), w, stride=stride)


def _max_pool(x):
    """3x3/2 max-pool with ``SAME`` padding by -inf."""
    (t, b), (left, right) = _same(x.shape[2], 3, 2), _same(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (left, right, t, b), value=-math.inf), 3, 2)


def _bn(x, p, eps: float = 1e-5):
    """Batch-statistics norm over (N, H, W), float32 math, biased
    variance."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + eps) * p["scale"][:, None, None]
           + p["bias"][:, None, None])
    return out.to(x.dtype)


def _block(x, block, stride: int, bottleneck: bool):
    shortcut = x
    if "proj" in block:
        shortcut = _bn(_conv(x, block["proj"], stride), block["proj_bn"])
    if bottleneck:
        h = torch.relu(_bn(_conv(x, block["conv1"]), block["bn1"]))
        h = torch.relu(_bn(_conv(h, block["conv2"], stride), block["bn2"]))
        h = _bn(_conv(h, block["conv3"]), block["bn3"])
    else:
        h = torch.relu(_bn(_conv(x, block["conv1"], stride), block["bn1"]))
        h = _bn(_conv(h, block["conv2"]), block["bn2"])
    return torch.relu(h + shortcut)


def forward(config: ResNetConfig, params: dict, images):
    """images [b, h, w, 3] -> logits [b, n_classes] float32."""
    c = config
    # NHWC bytes, NCHW indexing: a channels_last view, no copy
    x = images.to(c.dtype).permute(0, 3, 1, 2)
    x = torch.relu(_bn(_conv(x, params["stem"]["conv"], 2),
                       params["stem"]["bn"]))
    x = _max_pool(x)
    for si, stage in enumerate(params["stages"]):
        for bi, block in enumerate(stage):
            x = _block(x, block, _block_stride(si, bi), c.bottleneck)
    x = x.mean(dim=(2, 3))  # global average pool
    logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits.float()


def loss_fn(config: ResNetConfig, params: dict, images, labels):
    logits = forward(config, params, images)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return (logz - gold).mean()


def accuracy(config: ResNetConfig, params: dict, images, labels):
    return (forward(config, params, images).argmax(-1)
            == labels).float().mean()
