"""Model artifact I/O: the same on-disk format as ``kubedl_tpu/models/io.py``.

An artifact directory holds

* ``config.json`` — ``{"family": ..., "config": {fields, dtype by name},
  "params_sha256": ...}``;
* ``params.npz`` — the parameter tree flattened to ``/``-joined keys
  (``embed``, ``layers/wq`` ...), bfloat16 stored as float32.

So an artifact the JAX package wrote serves unchanged from the port, and
the port's ``save_model`` writes one the JAX package loads. Both of the
JAX package's families load: ``llama`` (Llama, Mistral, Qwen2 and
Gemma, whose tied embeddings leave no ``lm_head`` leaf) and ``moe``
(Mixtral; stacked experts, a float32 router).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from typing import Tuple

import numpy as np
import torch

from .._device import resolve_device
from . import llama, moe

#: the family modules by their ``config.json`` name; each names its
#: config class (``CONFIG``)
FAMILIES = {"llama": llama, "moe": moe}

#: leaves kept in float32 (norm scales, projection biases, the MoE
#: router); everything else loads at the config dtype
_F32_LEAVES = {"attn_norm", "mlp_norm", "final_norm",
               "post_attn_norm", "post_ffw_norm", "bq", "bk", "bv",
               "w_router"}


def family_name(config) -> str:
    """The family whose config class is the nearest class of ``config``
    (``MoEConfig`` subclasses ``LlamaConfig``)."""
    names = {fam.CONFIG: name for name, fam in FAMILIES.items()}
    for cls in type(config).__mro__:
        if cls in names:
            return names[cls]
    raise TypeError(f"no model family for {type(config).__name__}")


def family_of(config):
    """The family module of a config: every family exposes the same
    ``init_params`` / ``forward`` / ``forward_step`` / ``loss_fn`` ...
    contract."""
    return FAMILIES[family_name(config)]


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
    doc = {"family": family_name(config), "config": config.to_dict()}
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
                      device=None, select=None) -> dict:
    """The JAX package's parameter tree (numpy leaves, stacked
    ``layers/*`` or a per-layer ``layers/<i>/*`` list, ``[in, out]``
    weights, bfloat16 widened to float32) -> the port's parameter dict on
    ``device``: float32 for norms and biases, the config dtype for the
    rest. Keys and shapes are checked against the config. ``select(name,
    host_tensor)`` (optional) returns the part of each leaf to keep, a
    view of the host tensor (a tensor-parallel rank's shard): only that
    part is converted and reaches ``device``."""
    dev = resolve_device(device)
    shapes = family_of(config).param_shapes(config)

    def leaf(name, arr, shape):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"param {name}: shape {arr.shape}, the config "
                             f"wants {tuple(shape)}")
        dt = torch.float32 if name.split("/")[-1] in _F32_LEAVES \
            else config.dtype
        host = torch.from_numpy(np.asarray(arr, np.float32))
        if select is not None:
            host = select(name, host)
        out = host.to(device=dev, dtype=dt).contiguous()
        # a leaf that needed no conversion would alias its host array
        # (for a mapped artifact, the file's pages): own the bytes
        return out.clone() if out.data_ptr() == host.data_ptr() else out

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


def _doc(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def read_config(path: str) -> llama.LlamaConfig:
    """The config of a ``save_model`` directory, of its family's class,
    without its weights."""
    doc = _doc(path)
    family = doc.get("family", "llama")
    if family not in FAMILIES:
        raise ValueError(f"unknown model family {family!r} in {path}; one "
                         f"of {sorted(FAMILIES)}")
    cls = FAMILIES[family].CONFIG
    fields = {f.name for f in dataclasses.fields(cls)}
    raw = {k: v for k, v in doc["config"].items() if k in fields}
    raw["dtype"] = raw.get("dtype", "bfloat16")
    return cls(**raw)


def _npz_arrays(path: str) -> dict:
    """``{key: array}`` of an ``np.savez`` file. Each stored member is a
    view of one private mapping of the file: no read pass into a copy and
    no per-member CRC pass (the file's sha256 is the artifact's check).
    A compressed member is read the ordinary way."""
    import struct
    import zipfile
    from io import BytesIO

    fmt = np.lib.format
    mapped = np.memmap(path, dtype=np.uint8, mode="c")
    out = {}
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            key = info.filename.removesuffix(".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as f:
                    out[key] = fmt.read_array(f)
                continue
            # the member's data follows its local header (30 bytes, the
            # name, the extra field)
            off = info.header_offset
            name_len, extra_len = struct.unpack(
                "<HH", bytes(mapped[off + 26:off + 30]))
            start = off + 30 + name_len + extra_len
            head = BytesIO(bytes(mapped[start:start + min(info.file_size,
                                                          1 << 16)]))
            version = fmt.read_magic(head)
            shape, fortran, dtype = (fmt.read_array_header_1_0(head)
                                     if version == (1, 0) else
                                     fmt.read_array_header_2_0(head))
            data = start + head.tell()
            arr = np.frombuffer(mapped, dtype=dtype,
                                count=int(np.prod(shape, dtype=np.int64)),
                                offset=data)
            if data % dtype.itemsize:
                arr = arr.copy()                 # keep every view aligned
            out[key] = arr.reshape(shape, order="F" if fortran else "C")
    return out


def load_model(path: str, device=None,
               select=None) -> Tuple[llama.LlamaConfig, dict]:
    """(config, params on ``device``) from a ``save_model`` directory —
    the JAX package's or the port's. The arrays are mapped from the file
    and copied to ``device`` leaf by leaf while a thread hashes the file:
    a ``params_sha256`` mismatch means a corrupt or partial copy and
    raises before anything is returned. ``select`` keeps part of each
    leaf (see :func:`params_from_numpy`)."""
    config = read_config(path)
    dev = resolve_device(device)

    npz = os.path.join(path, "params.npz")
    want_sha = _doc(path).get("params_sha256")
    got_sha: dict = {}
    hasher = threading.Thread(target=lambda: got_sha.setdefault(
        "sha", _sha256(npz)), name="artifact-sha256", daemon=True)
    if want_sha:
        hasher.start()

    def check(cause=None):
        if want_sha:
            hasher.join()
            if got_sha.get("sha") != want_sha:
                raise ValueError(
                    f"params.npz checksum mismatch in {path}: the artifact "
                    "is corrupt or was partially copied") from cause

    try:
        tree: dict = {}
        for key, arr in _npz_arrays(npz).items():
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
        params = params_from_numpy(config, tree, device=dev, select=select)
    except Exception as e:
        check(e)              # a torn file reports as one
        raise
    check()
    return config, params
