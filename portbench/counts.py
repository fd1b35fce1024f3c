"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes that a kernel, a training step or a decode tick needs.

Frozen copies, with their sources:

* :data:`HBM_BYTES_PER_S`, :data:`PEAK_FLOPS_PER_S`, :data:`OPS_PER_PAIR`
  and :func:`flash_bound` are ``chip_smoke.py``'s constants and
  ``_flash_bound`` (bytes of every input and output moved once at the HBM
  rate against the products of the (row, key) pairs the mask keeps at the
  peak rate), taking the kept pairs as a number;
* :func:`train_flops` is ``bench.py``'s ``model_flops_per_token``
  (6 N + 12 L hd nh s/2 a token), with N the parameters the step
  multiplies by and the attention term counted over the pairs the
  segment masks keep.

Counts depend on the configuration file's keys only.
"""

from __future__ import annotations

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet), dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
#: operations per kept (row, key) pair and head dimension: K1 QK^T and PV
#: (2 + 2), K2 four products less the forward's two plus dS (6), K3 (8)
OPS_PER_PAIR = {"flash_forward": 4, "flash_dq": 6, "flash_dkv": 8}


def dims(cfg: dict) -> dict:
    d, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "L": cfg["num_hidden_layers"], "nh": nh,
            "nkv": cfg["num_key_value_heads"], "hd": d // nh,
            "f": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "E": cfg.get("num_local_experts", 0),
            "k": cfg.get("num_experts_per_tok", 0),
            "item": 2 if cfg["torch_dtype"] in ("bfloat16", "float16") else 4}


def flash_bound(name: str, b: int, sq: int, sk: int, nh: int, nkv: int,
                hd: int, pairs: int, dtype: str = "bfloat16") -> float:
    """Seconds: the least time one launch of K1 (``flash_forward``), K2
    (``flash_dq``) or K3 (``flash_dkv``) can take over ``pairs`` kept
    (row, key) pairs summed over the batch (per head)."""
    item = 2 if dtype == "bfloat16" else 4
    q_side, kv_side, rows = b * sq * nh * hd, b * sk * nkv * hd, b * nh * sq
    moved = {"flash_forward": item * (2 * q_side + 2 * kv_side) + 4 * rows,
             "flash_dq": item * (3 * q_side + 2 * kv_side) + 8 * rows,
             "flash_dkv": item * (2 * q_side + 4 * kv_side) + 8 * rows}[name]
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = OPS_PER_PAIR[name] * hd * pairs * nh / PEAK_FLOPS_PER_S[dtype]
    return max(t_bytes, t_ops)


def kept_pairs(segment_ids: np.ndarray) -> int:
    """(row, key) pairs a causal mask within segments keeps, summed over
    the rows of a ``[b, s]`` batch: a segment of n tokens keeps n(n+1)/2;
    pads (segment -1) keep none."""
    total = 0
    for row in np.asarray(segment_ids):
        ids, counts = np.unique(row[row >= 0], return_counts=True)
        total += int((counts * (counts + 1) // 2).sum())
    return total


def matmul_params(cfg: dict, active: bool = True) -> int:
    """Parameters a token is multiplied by: every layer's projections (the
    router too, and ``num_experts_per_tok`` experts where ``active``, else
    all of them) and the head; not the embedding lookup, the norms or the
    biases."""
    m = dims(cfg)
    d, hd, f = m["d"], m["hd"], m["f"]
    attn = d * hd * (m["nh"] + 2 * m["nkv"]) + m["nh"] * hd * d
    if m["E"]:
        mlp = 3 * d * f * (m["k"] if active else m["E"]) + d * m["E"]
    else:
        mlp = 3 * d * f
    return m["L"] * (attn + mlp) + d * m["V"]


def train_flops(cfg: dict, tokens: int, pairs: int) -> float:
    """Model FLOPs of one training step (forward and backward, recompute
    not counted): 6 N a token over ``tokens`` positions plus 12 L hd nh
    over the ``pairs`` kept (row, key) pairs."""
    m = dims(cfg)
    return (6.0 * matmul_params(cfg) * tokens
            + 12.0 * m["L"] * m["hd"] * m["nh"] * pairs)


def forward_flops(cfg: dict, tokens: int, context: int) -> float:
    """Model FLOPs of a forward over ``tokens`` positions that attend to
    ``context`` keys in all: 2 N a token plus 4 L hd nh a (row, key)
    pair."""
    m = dims(cfg)
    return (2.0 * matmul_params(cfg) * tokens
            + 4.0 * m["L"] * m["hd"] * m["nh"] * context)


def weight_bytes(cfg: dict, lanes: int, experts_hit: int | None = None) -> int:
    """Bytes of weights one decode tick of ``lanes`` live lanes has to
    read: every leaf once, but of the embedding only the lanes' rows and
    of the experts only ``experts_hit`` a layer (all when None). Norms,
    biases and the router are read in float32."""
    m = dims(cfg)
    d, hd, f, item = m["d"], m["hd"], m["f"], m["item"]
    attn = d * hd * (m["nh"] + 2 * m["nkv"]) + m["nh"] * hd * d
    small = 4 * (2 * d + (hd * (m["nh"] + 2 * m["nkv"])
                          if cfg.get("qkv_bias") else 0))
    if m["E"]:
        e = m["E"] if experts_hit is None else experts_hit
        mlp = 3 * d * f * e
        small += 4 * d * m["E"]
    else:
        mlp = 3 * d * f
    per_layer = item * (attn + mlp) + small
    return (m["L"] * per_layer + item * d * m["V"] + item * lanes * d
            + 4 * d)


def kv_bytes_per_token(cfg: dict) -> int:
    """K and V of one position over every layer, in the served type."""
    m = dims(cfg)
    return 2 * m["L"] * m["nkv"] * m["hd"] * m["item"]


def experts_hit(cfg: dict, lanes: int) -> int | None:
    """Experts a layer's tick of ``lanes`` tokens can route to at most:
    min(E, lanes * top-k); None for a dense model."""
    m = dims(cfg)
    return min(m["E"], lanes * m["k"]) if m["E"] else None


def decode_tick_work(cfg: dict, contexts) -> tuple:
    """(bytes, FLOPs) one decode tick needs, for live lanes whose context
    lengths (positions attended, the new one included) are ``contexts``:
    the weights (:func:`weight_bytes`, the experts these lanes can reach),
    each lane's live K/V read once and its new K/V written; the forward of
    one token a lane."""
    contexts = [int(c) for c in contexts]
    n = len(contexts)
    moved = (weight_bytes(cfg, n, experts_hit(cfg, n))
             + kv_bytes_per_token(cfg) * sum(contexts))
    return moved, forward_flops(cfg, n, sum(contexts))
