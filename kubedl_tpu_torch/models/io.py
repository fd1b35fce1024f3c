"""Model artifact I/O: the same on-disk format as ``kubedl_tpu/models/io.py``.

An artifact directory holds

* ``config.json`` — ``{"family": ..., "config": {fields, dtype by name},
  "params_sha256": ...}``;
* ``params.npz`` — the parameter tree flattened to ``/``-joined keys
  (``embed``, ``layers/wq`` ...), bfloat16 stored as float32.

So an artifact the JAX package wrote serves unchanged from the port, and
the port's ``save_model`` writes one the JAX package loads. Only the
llama family is ported so far.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Tuple

import numpy as np
import torch

from .._device import resolve_device
from . import llama

#: leaves kept in float32 (norm scales, projection biases); everything
#: else loads at the config dtype
_F32_LEAVES = {"attn_norm", "mlp_norm", "final_norm",
               "post_attn_norm", "post_ffw_norm", "bq", "bk", "bv"}


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def save_model(config: llama.LlamaConfig, params: dict, path: str) -> None:
    """Write config.json + params.npz under ``path`` (files land under
    their final names only when fully written)."""
    os.makedirs(path, exist_ok=True)
    doc = {"family": "llama", "config": config.to_dict()}
    flat = {}
    for name, leaf in params.items():
        items = leaf.items() if name == "layers" else [(None, leaf)]
        for sub, t in items:
            key = name if sub is None else f"layers/{sub}"
            t = t.detach().cpu()
            # bfloat16 has no portable npz dtype: store as float32
            if t.dtype == torch.bfloat16:
                t = t.float()
            flat[key] = t.numpy()
    tmp = os.path.join(path, ".params.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    doc["params_sha256"] = _sha256(tmp)
    os.replace(tmp, os.path.join(path, "params.npz"))
    tmp = os.path.join(path, ".config.json.tmp")
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(path, "config.json"))


def params_from_numpy(config: llama.LlamaConfig, tree: dict,
                      device=None) -> dict:
    """The JAX package's parameter tree (numpy leaves, stacked
    ``layers/*`` or a per-layer ``layers/<i>/*`` list, ``[in, out]``
    weights, bfloat16 widened to float32) -> the port's parameter dict on
    ``device``: float32 for norms and biases, the config dtype for the
    rest. Keys and shapes are checked against the config."""
    dev = resolve_device(device)
    shapes = llama.param_shapes(config)

    def leaf(name, arr, shape):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"param {name}: shape {arr.shape}, the config "
                             f"wants {tuple(shape)}")
        dt = torch.float32 if name.split("/")[-1] in _F32_LEAVES \
            else config.dtype
        return torch.from_numpy(np.array(arr, np.float32)).to(
            device=dev, dtype=dt)

    layers = tree["layers"]
    if isinstance(layers, (list, tuple)) or all(
            k.isdigit() for k in layers):
        # scan_layers=False artifacts hold one subtree per layer: stack
        seq = (layers if isinstance(layers, (list, tuple))
               else [layers[str(i)] for i in range(len(layers))])
        layers = {k: np.stack([np.asarray(lp[k]) for lp in seq])
                  for k in seq[0]}
    want = set(shapes["layers"])
    if set(layers) != want:
        raise ValueError(f"layer params {sorted(layers)} do not match the "
                         f"config's {sorted(want)}")
    out = {"layers": {
        k: leaf(f"layers/{k}", layers[k], (config.n_layers,) + shape)
        for k, (shape, _) in shapes["layers"].items()}}
    top = {k for k in tree if k != "layers"}
    if top != set(shapes) - {"layers"}:
        raise ValueError(f"params {sorted(top)} do not match the config's "
                         f"{sorted(set(shapes) - {'layers'})}")
    for k in top:
        out[k] = leaf(k, tree[k], shapes[k][0])
    return out


def load_model(path: str, device=None) -> Tuple[llama.LlamaConfig, dict]:
    """(config, params on ``device``) from a ``save_model`` directory —
    the JAX package's or the port's. A ``params_sha256`` mismatch means a
    corrupt or partial copy and raises."""
    with open(os.path.join(path, "config.json")) as f:
        doc = json.load(f)
    family = doc.get("family", "llama")
    if family != "llama":
        raise NotImplementedError(
            f"model family {family!r} is not ported yet: only llama "
            "serves from the port (MoE is ROADMAP queue A's "
            "quantization/LoRA/MoE item)")
    fields = {f.name for f in dataclasses.fields(llama.LlamaConfig)}
    raw = {k: v for k, v in doc["config"].items() if k in fields}
    raw["dtype"] = raw.get("dtype", "bfloat16")
    config = llama.LlamaConfig(**raw)
    dev = resolve_device(device)

    npz = os.path.join(path, "params.npz")
    want_sha = doc.get("params_sha256")
    if want_sha and _sha256(npz) != want_sha:
        raise ValueError(
            f"params.npz checksum mismatch in {path}: the artifact is "
            "corrupt or was partially copied")

    tree: dict = {}
    with np.load(npz) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return config, params_from_numpy(config, tree, device=dev)
