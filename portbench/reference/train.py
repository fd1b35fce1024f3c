"""The plain training reference: the loss, its gradients and AdamW in
float32, for the first steps of a training cell.

The loss is next-token cross-entropy averaged over the unmasked targets
of packed rows (attention within segments, RoPE positions per document).
The optimizer is the chain the configuration's trainer states, written
from its description: the gradient clipped to a global norm, Adam
(``beta1``, ``beta2``, ``eps``) with bias correction, decoupled weight
decay on every leaf added to the update, and a learning rate that rises
linearly from 0 over ``warmup_steps`` and then follows a cosine to a
tenth of its peak at ``decay_steps``, read before the step is counted.

Each layer runs under ``torch.utils.checkpoint`` and the loss over blocks
of rows, so that only the float32 state and one layer's activations are
alive at a time.

``precision="fp8"`` is the control: float8 products (``model.mm``), and
the leaves the configuration keeps in bfloat16 stored in float8 e4m3 (one
scale a tensor), as the program stores them in bfloat16 with no float32
copy.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .model import Leaves, fp8, layer, mm, rms_norm


def lr_at(opt: dict, count: int) -> float:
    peak, warm, decay = opt["lr"], opt["warmup_steps"], opt["decay_steps"]
    if count < warm:
        return peak * min(max(count, 0), warm) / warm
    t = min(count - warm, decay - warm)
    cos = 0.5 * (1.0 + math.cos(math.pi * t / (decay - warm)))
    return peak * (0.9 * cos + 0.1)


def loss(cfg: dict, params: dict, batch: dict, precision: str = "f32",
         chunk: int = 1024):
    """Mean next-token loss of one packed batch (tensors on the device)."""
    tokens, seg, pos = batch["tokens"], batch["segment_ids"], \
        batch["positions"]
    x = params["embed"][tokens]
    stacks = {k.split("/", 1)[1]: v for k, v in params.items()
              if k.startswith("layers/")}

    def run_layer(x, i):
        return layer(cfg, x, {k: v[i] for k, v in stacks.items()}, pos,
                     seg, precision)

    for i in range(cfg["num_hidden_layers"]):
        x = checkpoint(run_layer, x, i, use_reentrant=False)
    x = rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])
    w = params["embed"].T if cfg["tie_word_embeddings"] else \
        params["lm_head"]
    flat = x.reshape(-1, x.shape[-1])
    tgt = batch["targets"].reshape(-1)
    keep = batch["mask"].reshape(-1).float()

    def nll(h, t, m):
        logits = mm(h, w, precision)
        picked = logits.gather(-1, t[:, None])[:, 0]
        return ((torch.logsumexp(logits, -1) - picked) * m).sum()

    total = sum(checkpoint(nll, flat[i:i + chunk], tgt[i:i + chunk],
                           keep[i:i + chunk], use_reentrant=False)
                for i in range(0, flat.shape[0], chunk))
    return total / keep.sum()


def run(cfg: dict, seed: int, batches: list, opt: dict, make_leaf,
        device, precision: str = "f32") -> dict:
    """The first ``len(batches)`` steps from the seed's weights: each
    step's loss, every leaf's gradient norm as the optimizer takes it at
    step 1 (after the clip), the norm of every leaf's change over all the
    steps, and every leaf's unclipped gradient norm at step 1."""
    from ..weights import leaf_specs
    leaves = Leaves(cfg, seed, device, make_leaf)
    paths = sorted(leaf_specs(cfg))
    # the control stores the leaves the configuration keeps in bfloat16 in
    # float8, as it computes: rounded at the start and after every update
    low = {p for p, (_, f32, _) in leaf_specs(cfg).items()
           if precision == "fp8" and not f32}
    params = {p: (fp8(leaves.get(p)) if p in low else leaves.get(p))
              .detach().requires_grad_(True) for p in paths}
    m = {p: torch.zeros_like(v) for p, v in params.items()}
    v2 = {p: torch.zeros_like(v) for p, v in params.items()}
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    out = {"loss": [], "grad_norm": {}, "raw_grad_norm": {}, "change": {}}
    for step, batch in enumerate(batches, start=1):
        b = {k: torch.as_tensor(t, device=device) for k, t in batch.items()}
        value = loss(cfg, params, b, precision)
        grads = torch.autograd.grad(value, [params[p] for p in paths])
        out["loss"].append(float(value.detach()))
        with torch.no_grad():
            g_norm = math.sqrt(sum(float(g.double().pow(2).sum())
                                   for g in grads))
            scale = 1.0 if g_norm < opt["grad_clip"] else \
                opt["grad_clip"] / g_norm
            lr = lr_at(opt, step - 1)
            for p, g in zip(paths, grads):
                if step == 1:
                    out["raw_grad_norm"][p] = float(g.double().norm())
                g = g * scale
                m[p].mul_(b1).add_(g, alpha=1 - b1)
                v2[p].mul_(b2).addcmul_(g, g, value=1 - b2)
                if step == 1:
                    out["grad_norm"][p] = float(
                        (m[p] / (1 - b1)).double().norm())
                u = (m[p] / (1 - b1 ** step)) / (
                    (v2[p] / (1 - b2 ** step)).sqrt() + eps)
                u.add_(params[p], alpha=opt["weight_decay"])
                params[p].sub_(lr * u)
                if p in low:
                    params[p].copy_(fp8(params[p]))
        del grads
    with torch.no_grad():
        for p in paths:
            out["change"][p] = float(
                (params[p] - leaves.get(p)).double().norm())
    return out
