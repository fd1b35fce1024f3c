"""The plain reference: Qwen2 / Mixtral decoders in float32 PyTorch.

Written from the published architectures (pre-norm RMSNorm, rotate-half
RoPE, grouped-query attention with q/k/v biases where the configuration
has them, SwiGLU, and for Mixtral a softmax router over 8 experts whose
top 2 are weighted by their renormalized probabilities, with no token
dropped). No kernel, cache or batching: a forward over whole sequences.

It imports nothing of the port, and takes nothing the program made. The
weights come from ``weights.make_leaf`` (the harness's inputs, made again
from the seed, one leaf at a time) and are widened to float32 one layer
at a time, so that Mixtral's 16 layers never sit in float32 at once.

``precision="fp8"`` is the control: every product whose weight the
configuration serves in bfloat16 takes both operands rounded to
float8 e4m3 with one scale per tensor (its largest magnitude at 448),
accumulated in float32, the step below bfloat16 that would tempt a later
change.
"""

from __future__ import annotations

import math

import torch

F8_MAX = 448.0


def set_exact() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, back in
    float32. The gradient passes straight through the rounding, so a
    product's backward takes the rounded operands and a float32 gradient,
    as float8 training does."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32)
    return x + (q * scale - x).detach()


def mm(a, w, precision: str = "f32"):
    if precision == "fp8":
        return fp8(a) @ fp8(w)
    return a @ w


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta: float):
    """x [b, s, h, hd]; positions [b, s] (or [s]); rotate-half RoPE."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = positions.to(torch.float32)[..., None] * inv
    if ang.ndim == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, segment_ids=None, block: int = 512):
    """Causal grouped-query attention, q [b, s, nh, hd], k/v [b, s, nkv,
    hd]; keys restricted to the row's segment where ``segment_ids`` [b, s]
    is given. Rows go in blocks of ``block``, so the scores of one block
    are alive at a time."""
    b, s, nh, hd = q.shape
    rep = nh // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)      # [b, nh, s, hd]
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    qh = q.transpose(1, 2) / math.sqrt(hd)
    cols = torch.arange(s, device=q.device)
    outs = []
    for r0 in range(0, s, block):
        r1 = min(s, r0 + block)
        scores = qh[:, :, r0:r1] @ k[:, :, :r1].transpose(-1, -2)
        keep = cols[None, :r1] <= torch.arange(r0, r1,
                                               device=q.device)[:, None]
        keep = keep[None, None]
        if segment_ids is not None:
            keep = keep & (segment_ids[:, None, r0:r1, None]
                           == segment_ids[:, None, None, :r1])
        scores = scores.masked_fill(~keep, float("-inf"))
        outs.append(torch.softmax(scores, dim=-1) @ v[:, :, :r1])
    return torch.cat(outs, dim=2).transpose(1, 2)            # [b, s, nh, hd]


def mlp(cfg: dict, h, lw: dict, precision: str, margins=None):
    """The feed-forward sublayer. ``margins`` (a list) takes, for Mixtral,
    every token's router margin: the k-th largest probability less the
    (k+1)-th, the distance to a change of the chosen experts."""
    if cfg["family"] not in ("llama", "moe"):
        raise ValueError(f"unknown model family {cfg['family']!r}")
    if cfg["family"] == "llama":
        g = torch.nn.functional.silu(mm(h, lw["w_gate"], precision))
        return mm(g * mm(h, lw["w_up"], precision), lw["w_down"], precision)
    # Mixtral: softmax over the experts, the top k renormalized
    probs = torch.softmax(h @ lw["w_router"], dim=-1)
    k = cfg["num_experts_per_tok"]
    if margins is not None:
        ranked = torch.topk(probs, k + 1, dim=-1).values
        margins.append((ranked[..., k - 1] - ranked[..., k]).reshape(-1))
    top, idx = torch.topk(probs, k, dim=-1)
    top = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    flat_h, flat_out = h.reshape(-1, h.shape[-1]), out.view(-1, h.shape[-1])
    flat_idx = idx.reshape(-1, idx.shape[-1])
    flat_top = top.reshape(-1, top.shape[-1])
    for e in range(cfg["num_local_experts"]):
        rows, slot = torch.nonzero(flat_idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = flat_h[rows]
        y = mm(torch.nn.functional.silu(mm(x, lw["w_gate"][e], precision))
               * mm(x, lw["w_up"][e], precision), lw["w_down"][e], precision)
        flat_out.index_add_(0, rows, y * flat_top[rows, slot][:, None])
    return out


def layer(cfg: dict, x, lw: dict, positions, segment_ids=None,
          precision: str = "f32", margins=None):
    """One decoder layer on x [b, s, d] (float32)."""
    b, s, d = x.shape
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // nh
    eps = cfg["rms_norm_eps"]
    h = rms_norm(x, lw["attn_norm"], eps)
    q, k, v = (mm(h, lw[w], precision) for w in ("wq", "wk", "wv"))
    if cfg.get("qkv_bias"):
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q = rope(q.reshape(b, s, nh, hd), positions, cfg["rope_theta"])
    k = rope(k.reshape(b, s, nkv, hd), positions, cfg["rope_theta"])
    v = v.reshape(b, s, nkv, hd)
    a = attention(q, k, v, segment_ids).reshape(b, s, nh * hd)
    x = x + mm(a, lw["wo"], precision)
    return x + mlp(cfg, rms_norm(x, lw["mlp_norm"], eps), lw, precision,
                   margins)


class Leaves:
    """The run's weights, made again from the seed: :meth:`get` a whole
    leaf in float32, :meth:`layer` one layer's leaves in float32 (each
    stacked leaf made once in the served type and kept until
    :meth:`close`)."""

    def __init__(self, cfg: dict, seed: int, device, make_leaf):
        self.cfg, self.seed, self.device = cfg, seed, device
        self._make = make_leaf
        self._stacks: dict = {}

    def _stack(self, path):
        if path not in self._stacks:
            self._stacks[path] = self._make(self.cfg, self.seed, path,
                                            self.device)
        return self._stacks[path]

    def get(self, path):
        return self._make(self.cfg, self.seed, path, self.device).float()

    def layer(self, i: int) -> dict:
        from ..weights import leaf_specs
        return {p.split("/", 1)[1]: self._stack(p)[i].float()
                for p in leaf_specs(self.cfg) if p.startswith("layers/")}

    def close(self) -> None:
        self._stacks.clear()


def final_hidden(cfg: dict, leaves: Leaves, seqs: list,
                 precision: str = "f32", margins=None) -> list:
    """Final normed hidden states [len, d] (float32) of every token list
    in ``seqs``, the layers taken one at a time over all sequences.
    ``margins`` (a list), for Mixtral, takes each sequence's least router
    margin over the layers at every position."""
    dev = leaves.device
    embed = leaves.get("embed")
    xs = [embed[torch.as_tensor(s, device=dev)][None] for s in seqs]
    del embed
    least = [None] * len(seqs)
    for i in range(cfg["num_hidden_layers"]):
        lw = leaves.layer(i)
        out = []
        for j, x in enumerate(xs):
            got = [] if margins is not None else None
            out.append(layer(cfg, x, lw, torch.arange(x.shape[1], device=dev),
                             precision=precision, margins=got))
            if got:
                least[j] = got[0] if least[j] is None else \
                    torch.minimum(least[j], got[0])
        xs = out
        del lw
    if margins is not None:
        margins.extend(least)
    fn = leaves.get("final_norm")
    return [rms_norm(x[0], fn, cfg["rms_norm_eps"]) for x in xs]


def head(cfg: dict, leaves: Leaves):
    if cfg["tie_word_embeddings"]:
        return leaves.get("embed").T
    return leaves.get("lm_head")
