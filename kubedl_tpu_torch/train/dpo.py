"""Direct Preference Optimization (DPO): the counterpart of
``kubedl_tpu/train/dpo.py``.

Preference fine-tuning for every model family of the port (Llama,
Gemma/-2, Mistral, Qwen2, MoE): given (prompt, chosen, rejected) pairs,
push the policy's implied reward ``beta * (logp_policy - logp_ref)`` to
rank chosen above rejected (Rafailov et al. 2023).

* per-sequence log-probabilities come from the final hidden states and
  the chunked LM-head scan (``ops.loss.chunked_token_nll``): the
  ``[b, s, vocab]`` logits never materialize;
* chosen and rejected rows ride ONE forward pass, concatenated on the
  batch axis (``[2b, s]``);
* the frozen reference is optional at step time: pass
  ``ref_chosen_logps``/``ref_rejected_logps`` in the batch (precomputed
  once, halving the step's work) or let the step compute them without
  autograd from a second parameter tree;
* under ``cp`` (each rank a slice of every row's sequence) the
  sequences' sums are added over ``cp`` with their gradient
  (``collectives.cp_sum``), so the loss and its gradients are the
  global ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..models.llama import _rank_mask
from ..ops.loss import chunked_token_nll
from ..parallel.collectives import cp_sum
from .scoring import hidden_and_head, render_rows


@dataclass(frozen=True)
class DPOConfig:
    #: inverse-temperature of the implied reward
    beta: float = 0.1
    #: conservative-DPO label smoothing: probability the preference
    #: label is flipped (0 = trust labels fully)
    label_smoothing: float = 0.0
    #: "sigmoid" (DPO) or "ipo" (IPO's squared hinge)
    loss_type: str = "sigmoid"

    def __post_init__(self):
        if self.loss_type not in ("sigmoid", "ipo"):
            raise ValueError(f"unknown DPO loss_type {self.loss_type!r}")
        if not 0.0 <= self.label_smoothing < 0.5:
            raise ValueError(
                f"label_smoothing must be in [0, 0.5), got "
                f"{self.label_smoothing}")
        if self.loss_type == "ipo" and self.label_smoothing:
            raise ValueError(
                "IPO has no label-smoothing term; it would be silently "
                "ignored — use loss_type='sigmoid' for cDPO")


def sequence_logprobs(config, params, tokens, targets, mask=None,
                      mesh=None, chunk: int = 512, with_aux: bool = False):
    """Summed log P(targets | tokens) per row: [b, s] -> [b] float32.
    ``mask`` selects the completion positions. ``with_aux=True`` also
    returns the MoE load-balancing aux loss (0 for dense families). Under
    ``cp`` each rank holds a slice of every row: its partial sums are
    added over ``cp`` (with their gradient), so every rank holds the
    rows' whole sums."""
    x, head, aux = hidden_and_head(config, params, tokens, mesh)
    lp = -chunked_token_nll(x, head, targets,
                            mask=_rank_mask(mask, targets, mesh), chunk=chunk,
                            logit_softcap=config.logit_softcap)
    lp = cp_sum(lp, mesh)
    return (lp, aux) if with_aux else lp


def dpo_loss(policy_chosen, policy_rejected, ref_chosen, ref_rejected,
             cfg: DPOConfig = DPOConfig(), mesh=None):
    """Scalar loss + metrics from per-sequence logps (all [b] float32).
    Returns ``(loss, metrics)``: the implied rewards, their margin, and
    ranking accuracy. Under a sharded ``mesh`` the pairs are this rank's
    and the loss is its share of the global mean (the metrics stay this
    rank's)."""
    chosen_reward = cfg.beta * (policy_chosen - ref_chosen)
    rejected_reward = cfg.beta * (policy_rejected - ref_rejected)
    logits = chosen_reward - rejected_reward
    if cfg.loss_type == "ipo":
        # IPO regresses the raw log-ratio margin (logits / beta) to
        # 1/(2 beta); no label smoothing term
        per = (logits / cfg.beta - 1.0 / (2.0 * cfg.beta)) ** 2
    else:
        ls = cfg.label_smoothing
        per = (-(1.0 - ls) * F.logsigmoid(logits)
               - ls * F.logsigmoid(-logits))
    from ..parallel.collectives import loss_share
    loss = loss_share(per.sum(), torch.tensor(float(per.numel()),
                                              device=per.device), mesh)
    metrics = {
        "reward_chosen": chosen_reward.mean(),
        "reward_rejected": rejected_reward.mean(),
        "reward_margin": logits.mean(),
        "accuracy": (logits > 0).float().mean(),
    }
    return loss, metrics


def _pair_logprobs(config, params, batch, mesh=None, chunk: int = 512,
                   with_aux: bool = False):
    """One concatenated forward over chosen+rejected rows -> ([b], [b])."""
    tokens = torch.cat([batch["chosen_tokens"], batch["rejected_tokens"]])
    targets = torch.cat([batch["chosen_targets"],
                         batch["rejected_targets"]])
    mask = None
    if "chosen_mask" in batch:
        mask = torch.cat([batch["chosen_mask"], batch["rejected_mask"]])
    lp, aux = sequence_logprobs(config, params, tokens, targets, mask=mask,
                                mesh=mesh, chunk=chunk, with_aux=True)
    b = batch["chosen_tokens"].shape[0]
    if with_aux:
        return lp[:b], lp[b:], aux
    return lp[:b], lp[b:]


def make_dpo_loss_fn(config, dpo: DPOConfig = DPOConfig(), ref_params=None,
                     mesh=None, chunk: int = 512):
    """``loss_fn(params, batch) -> scalar`` for ``train.Trainer``.

    Batch keys: ``{chosen,rejected}_{tokens,targets}`` (+ optional
    ``_mask``), and either ``ref_{chosen,rejected}_logps`` (precomputed:
    preferred) or nothing, in which case ``ref_params`` must be given and
    the frozen reference runs inside the step without autograd."""

    def loss_fn(params, batch):
        pol_c, pol_r, aux = _pair_logprobs(config, params, batch, mesh,
                                           chunk, with_aux=True)
        if "ref_chosen_logps" in batch:
            ref_c = batch["ref_chosen_logps"].float()
            ref_r = batch["ref_rejected_logps"].float()
        elif ref_params is not None:
            with torch.no_grad():
                ref_c, ref_r = _pair_logprobs(config, ref_params, batch,
                                              mesh, chunk)
        else:
            raise ValueError(
                "DPO needs ref_{chosen,rejected}_logps in the batch or "
                "ref_params at build time")
        loss, _ = dpo_loss(pol_c, pol_r, ref_c, ref_r, dpo, mesh=mesh)
        # MoE: keep the router balanced through preference tuning too
        aux_w = getattr(config, "aux_loss_weight", 0.0)
        return loss + aux_w * aux

    return loss_fn


def reference_logps_fn(config, ref_params, mesh=None, chunk: int = 512):
    """``batch -> (ref_chosen_logps, ref_rejected_logps)`` without
    autograd, for the precompute-once data-prep pass."""

    @torch.no_grad()
    def ref(batch):
        return _pair_logprobs(config, ref_params, batch, mesh, chunk)

    return ref


def preference_batch(prompt_and_chosen, prompt_and_rejected,
                     prompt_lens, pad_id: int = 0):
    """Assemble a DPO batch (numpy) from already-tokenized rows.

    Args:
      prompt_and_chosen / prompt_and_rejected: list of int lists, each
        the full prompt+completion token sequence.
      prompt_lens: per-pair prompt length (masked out of the loss).

    Both sides render through the shared ``render_rows`` layout (right
    pad to one 128-aligned length, shifted targets, completion-only
    mask)."""
    n = len(prompt_and_chosen)
    if not (n == len(prompt_and_rejected) == len(prompt_lens)):
        raise ValueError("pair lists must have equal length")
    longest = max(len(r) for r in prompt_and_chosen + prompt_and_rejected)
    s = -(-longest // 128) * 128
    c = render_rows(prompt_and_chosen, prompt_lens, pad_id, pad_to=s)
    r = render_rows(prompt_and_rejected, prompt_lens, pad_id, pad_to=s)
    return {"chosen_tokens": c["tokens"], "chosen_targets": c["targets"],
            "chosen_mask": c["mask"], "rejected_tokens": r["tokens"],
            "rejected_targets": r["targets"], "rejected_mask": r["mask"]}
