"""The model's weights, made on the device from the seed.

Every leaf of the port's parameter dict (layers stacked on a leading axis)
is drawn in one call, in the type it is served in, from a generator of its
own whose seed is worked out from ``--seed`` and the leaf's name. So the
reference can make any one leaf again, alone and in the same values, after
the program's state is gone; nothing is written to disk.

Matrices are normal / sqrt(fan-in) (fan-in is the contracted dimension;
the embedding table is scaled by the hidden size), the norm scales are
1 + 0.05 normal and the q/k/v biases 0.05 normal, so every leaf is in play
and none is the identity. Leaves the port keeps in float32 (norms, biases,
the router) are made in float32.
"""

from __future__ import annotations

import hashlib
import math

import torch

NORMS = ("attn_norm", "mlp_norm", "final_norm")
BIASES = ("bq", "bk", "bv")


def leaf_specs(cfg: dict) -> dict:
    """``{path: (shape, float32?, fan_in or None)}`` of every leaf, paths
    as ``layers/wq`` or ``embed``; from the configuration file's keys."""
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // nh
    f = cfg["intermediate_size"]
    layer = {"attn_norm": ((d,), True, None),
             "wq": ((d, nh * hd), False, d),
             "wk": ((d, nkv * hd), False, d),
             "wv": ((d, nkv * hd), False, d),
             "wo": ((nh * hd, d), False, nh * hd),
             "mlp_norm": ((d,), True, None)}
    if cfg.get("qkv_bias"):
        layer.update(bq=((nh * hd,), True, None), bk=((nkv * hd,), True, None),
                     bv=((nkv * hd,), True, None))
    if cfg["family"] not in ("llama", "moe"):
        raise ValueError(f"unknown model family {cfg['family']!r}")
    if cfg["family"] == "moe":
        E = cfg["num_local_experts"]
        layer.update(w_router=((d, E), True, d),
                     w_gate=((E, d, f), False, d), w_up=((E, d, f), False, d),
                     w_down=((E, f, d), False, f))
    else:
        layer.update(w_gate=((d, f), False, d), w_up=((d, f), False, d),
                     w_down=((f, d), False, f))
    out = {f"layers/{k}": ((L,) + s, f32, fan) for k, (s, f32, fan)
           in layer.items()}
    out["embed"] = ((V, d), False, d)
    out["final_norm"] = ((d,), True, None)
    if not cfg["tie_word_embeddings"]:
        out["lm_head"] = ((d, V), False, d)
    return out


def leaf_seed(seed: int, path: str) -> int:
    """A 63-bit generator seed for one leaf of one run's weights."""
    h = hashlib.sha256(f"portbench-weights:{int(seed)}:{path}".encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


@torch.no_grad()
def make_leaf(cfg: dict, seed: int, path: str, device,
              dtype=None) -> torch.Tensor:
    """One leaf, drawn in one call on ``device`` (the same values every
    time for one seed, path and device)."""
    shape, f32, fan_in = leaf_specs(cfg)[path]
    served = getattr(torch, cfg["torch_dtype"])
    dt = dtype or (torch.float32 if f32 else served)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    t = torch.randn(shape, generator=gen, device=device, dtype=dt)
    name = path.rsplit("/", 1)[-1]
    if name in NORMS:
        t.mul_(0.05).add_(1.0)
    elif name in BIASES:
        t.mul_(0.05)
    else:
        t.mul_(1.0 / math.sqrt(fan_in))
    return t


def make_params(cfg: dict, seed: int, device) -> dict:
    """The port's parameter dict: ``{"layers": {name: [L, ...]}, "embed",
    "final_norm", "lm_head"}``."""
    params: dict = {"layers": {}}
    for path in leaf_specs(cfg):
        t = make_leaf(cfg, seed, path, device)
        if path.startswith("layers/"):
            params["layers"][path.split("/", 1)[1]] = t
        else:
            params[path] = t
    return params
