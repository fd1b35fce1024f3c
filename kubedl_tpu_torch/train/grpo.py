"""GRPO, group-relative policy optimization (RL from verifiable rewards):
the counterpart of ``kubedl_tpu/train/grpo.py``.

The critic-free PPO variant used for reasoning post-training (Shao et
al. 2024, DeepSeekMath): sample a GROUP of completions per prompt, score
them with a programmatic reward, normalize rewards within each group into
advantages (no value network), and update with a token-level clipped
importance-ratio objective plus a KL penalty to a frozen reference.

* per-token log-probabilities come from the final hidden states and the
  chunked LM-head scan (``ops.loss.chunked_token_logps``): the
  ``[b, s, vocab]`` logits never materialize;
* rollouts come from the port's serving engines, whose sampled-token
  logprobs ARE the behavior-policy term: the continuous engine's
  ``submit``/``step``/``reseed`` (each request forced to plain
  temperature-1 sampling) or the static engine's
  ``generate(..., return_logprobs=True)`` (which must already sample
  plainly: a greedy or filtered engine is refused);
* the update is a plain ``Trainer`` loss function: the same step as
  pre-training, DPO and LoRA.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.loss import chunked_token_logps
from ..parallel.collectives import loss_share
from .scoring import hidden_and_head, render_rows


@dataclass(frozen=True)
class GRPOConfig:
    #: completions sampled per prompt (the "group")
    group_size: int = 8
    #: PPO clip width for the token importance ratio
    clip_eps: float = 0.2
    #: weight of the k3 KL penalty to the frozen reference
    kl_coef: float = 0.04
    #: divide group-centered rewards by the group std (classic GRPO);
    #: False = center only (the "Dr. GRPO" debiasing)
    normalize_std: bool = True

    def __post_init__(self):
        if self.group_size < 2:
            raise ValueError("group_size must be >= 2 (advantages are "
                             "relative within a group)")
        if self.clip_eps <= 0:
            raise ValueError("clip_eps must be > 0")
        if self.kl_coef < 0:
            raise ValueError("kl_coef must be >= 0")


def group_advantages(rewards, cfg: GRPOConfig = GRPOConfig()):
    """[n_groups, group_size] rewards -> same-shape float32 advantages.

    Center within each group; optionally scale by the group's (population)
    std. A group whose rewards are all equal gets exactly zero advantage
    (epsilon guard, no NaN)."""
    r = torch.as_tensor(np.asarray(rewards, np.float32))
    if r.ndim != 2:
        raise ValueError(f"rewards must be [n_groups, group_size], got "
                         f"shape {tuple(r.shape)}")
    centered = r - r.mean(dim=1, keepdim=True)
    if cfg.normalize_std:
        centered = centered / (r.std(dim=1, correction=0, keepdim=True)
                               + 1e-6)
    return centered


def token_logps(config, params, tokens, targets, mesh=None,
                chunk: int = 512, with_aux: bool = False):
    """Per-token log P(targets | tokens): [b, s] float32 (any family).
    ``with_aux=True`` also returns the MoE router aux loss (0 dense)."""
    x, head, aux = hidden_and_head(config, params, tokens, mesh)
    lp = chunked_token_logps(x, head, targets, chunk=chunk,
                             logit_softcap=config.logit_softcap)
    return (lp, aux) if with_aux else lp


def grpo_loss(logps, old_logps, ref_logps, advantages, mask,
              cfg: GRPOConfig = GRPOConfig(), mesh=None):
    """Token-level clipped surrogate + KL penalty.

    Args: logps/old_logps/ref_logps [b, s] (policy, behavior, frozen
    reference); advantages [b] (one per completion); mask [b, s] over
    completion tokens. Returns (loss, metrics). Under a sharded ``mesh``
    the rows are this rank's and the loss is its share of the global mean
    (the metrics stay this rank's)."""
    adv = advantages[:, None].float()
    mask = mask.float()
    denom = torch.clamp_min(mask.sum(), 1.0)

    ratio = torch.exp(logps - old_logps.detach())
    clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
    pg = -torch.minimum(ratio * adv, clipped * adv)

    # k3 estimator: non-negative, unbiased in expectation
    ref_delta = ref_logps.detach() - logps
    kl = torch.exp(ref_delta) - ref_delta - 1.0

    loss = loss_share(((pg + cfg.kl_coef * kl) * mask).sum(), mask.sum(),
                      mesh)
    metrics = {
        "kl": (kl * mask).sum() / denom,
        "clip_frac": (((ratio - 1.0).abs() > cfg.clip_eps) * mask).sum()
        / denom,
        "ratio_mean": (ratio * mask).sum() / denom,
        "reward_advantage_mean": advantages.float().mean(),
    }
    return loss, metrics


def make_grpo_loss_fn(config, grpo: GRPOConfig = GRPOConfig(),
                      mesh=None, chunk: int = 512):
    """Build ``loss_fn(params, batch) -> scalar`` for ``train.Trainer``.

    Batch keys: ``tokens``/``targets``/``mask`` [b, s], ``advantages``
    [b], ``old_logps``/``ref_logps`` [b, s] (behavior and reference logps
    are data: precomputed, never differentiated)."""

    def loss_fn(params, batch):
        lp, aux = token_logps(config, params, batch["tokens"],
                              batch["targets"], mesh=mesh, chunk=chunk,
                              with_aux=True)
        loss, _ = grpo_loss(lp, batch["old_logps"], batch["ref_logps"],
                            batch["advantages"], batch["mask"], grpo,
                            mesh=mesh)
        # MoE: keep the router balanced through RL too (matches DPO)
        aux_w = getattr(config, "aux_loss_weight", 0.0)
        return loss + aux_w * aux

    return loss_fn


def _generate_submit(engine, groups, max_new_tokens: int, seed: int):
    """Rollouts through the continuous path: any object with the submit
    surface (``submit(prompt, max_new, logprobs=, temperature=, top_k=,
    top_p=)``, a ``ContinuousBatchingEngine``). Per-request overrides
    force plain temperature-1 sampling so the engine's full-softmax
    logprobs ARE the behavior policy, whatever its own GenerateConfig
    says. ``reseed`` (when exposed) pins the sampling stream so a fixed
    (seed, policy) reproduces the exact token streams."""
    reseed = getattr(engine, "reseed", None)
    if reseed is not None:
        reseed(seed)
    reqs = [engine.submit(list(p), max_new_tokens, logprobs=True,
                          temperature=1.0, top_k=0, top_p=1.0)
            for p in groups]
    step = getattr(engine, "step", None)
    if step is not None:
        while step():
            pass
    return [(r.result(), list(r.logprobs)) for r in reqs]


def rollout_batch(engine, prompts, reward_fn, max_new_tokens: int,
                  cfg: GRPOConfig = GRPOConfig(), seed: int = 0,
                  pad_id: int = 0):
    """Sample a group of completions per prompt and assemble the GRPO
    update batch.

    ``engine`` holds the CURRENT policy weights; its sampled-token
    logprobs become ``old_logps``. Two generation surfaces: the submit
    surface (``submit``/``step``, the continuous engine; preferred) and
    the static ``InferenceEngine.generate``. ``reward_fn(prompt_ids,
    completion_ids) -> float`` is the verifiable reward. Returns the batch
    dict (numpy, 128-aligned) WITHOUT ``ref_logps``: score it with
    :func:`token_logps` under the frozen reference, then pass it to the
    trainer."""
    groups = [list(p) for p in prompts for _ in range(cfg.group_size)]
    if hasattr(engine, "submit"):
        outs = _generate_submit(engine, groups, max_new_tokens, seed)
    else:
        gen = getattr(engine, "gen", None)
        if gen is not None:
            # the engine reports FULL-softmax logprobs; they equal the
            # behavior policy only under plain temperature-1 sampling
            # (greedy would also make every group identical: all
            # advantages 0)
            if gen.temperature != 1.0 or gen.top_k or gen.top_p != 1.0:
                raise ValueError(
                    "GRPO rollouts need plain sampling (temperature=1, "
                    f"no top_k/top_p) so reported logprobs ARE the "
                    f"behavior policy; engine has temperature="
                    f"{gen.temperature}, top_k={gen.top_k}, "
                    f"top_p={gen.top_p}")
        outs = engine.generate(groups, max_new_tokens, seed=seed,
                               return_logprobs=True)
    return assemble_batch(groups, outs, len(prompts), reward_fn,
                          cfg=cfg, pad_id=pad_id)


def assemble_batch(groups, outs, n_prompts: int, reward_fn,
                   cfg: GRPOConfig = GRPOConfig(), pad_id: int = 0):
    """Completed rollouts -> the GRPO update batch (the assembly half of
    :func:`rollout_batch`). ``groups`` is the flat prompt list
    (``n_prompts * cfg.group_size`` rows, group-major); ``outs`` is one
    ``(generated_ids, logprobs)`` pair per row."""
    rewards = np.asarray(
        [reward_fn(groups[i], ids) for i, (ids, _) in enumerate(outs)],
        np.float32).reshape(n_prompts, cfg.group_size)
    adv = group_advantages(rewards, cfg).numpy()

    rows = [p + list(ids) for p, (ids, _) in zip(groups, outs)]
    batch = render_rows(rows, [len(p) for p in groups], pad_id)
    old = np.zeros_like(batch["mask"])
    for i, (p, (ids, lps)) in enumerate(zip(groups, outs)):
        pl = len(p)
        old[i, pl - 1:pl - 1 + len(ids)] = np.asarray(lps, np.float32)
    batch.update(old_logps=old, advantages=adv.reshape(-1),
                 rewards=rewards)
    return batch


__all__ = ["GRPOConfig", "group_advantages", "token_logps", "grpo_loss",
           "make_grpo_loss_fn", "rollout_batch", "assemble_batch"]
