"""Evaluation harness, perplexity and log-likelihood scoring: the
counterpart of ``kubedl_tpu/train/evaluate.py``.

* :func:`perplexity`: mean next-token NLL (and its exp) over a batch
  stream. Runs the training loss path (chunked LM-head scan, family
  dispatch incl. MoE), so eval numbers are comparable to training loss.
* :func:`loglikelihood_ranks`: per-option summed log P(continuation |
  prompt) for multiple-choice scoring (the lm-eval-harness
  "loglikelihood" contract): each (prompt, option) pair renders with
  continuation-only masking, scored by the chunked per-row scan, argmax
  per question. Options pad to a shared 128-aligned length, as in the
  JAX package.

Scoring runs without autograd; on the card every layer's attention is
the flash forward kernel. Under a sharded mesh the params are
``ShardedTensor`` views, a corpus batch holds each rank's rows and the
totals are summed over the data axes; every rank scores every
multiple-choice question. Under ``cp`` each rank holds a slice of every
row's sequence: the per-row sums are added over ``cp`` before anything
else reads them.
"""

from __future__ import annotations

import itertools
import math
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..models.llama import _cp_columns, _rank_mask
from ..ops.loss import chunked_token_nll
from ..parallel.collectives import cp_sum, is_sharded
from .scoring import hidden_and_head, render_rows
from .trainer import tree_leaves


def make_row_nll_fn(config, mesh=None, chunk: int = 512):
    """``(params, batch) -> per-row summed NLL [b]`` (float32) over
    ``{tokens, targets[, mask]}``: the one step both evaluators share."""

    from ..parallel.sharding import local_of

    @torch.no_grad()
    def rows(params, batch):
        batch = {k: local_of(v) for k, v in batch.items()}
        x, head, _ = hidden_and_head(config, params, batch["tokens"], mesh)
        nll = chunked_token_nll(
            x, head, batch["targets"],
            mask=_rank_mask(batch.get("mask"), batch["targets"], mesh),
            chunk=chunk, logit_softcap=config.logit_softcap)
        # under cp: the rank's slice of each row, added over cp
        return cp_sum(nll, mesh)

    return rows


def perplexity(config, params, batches: Iterable[dict], mesh=None,
               chunk: int = 512, max_batches: Optional[int] = None):
    """Corpus perplexity over ``batches`` of ``{tokens, targets[, mask]}``
    device tensors. Returns ``{nll, perplexity, tokens}`` (the token
    count covers unmasked targets only)."""
    row_nll = make_row_nll_fn(config, mesh, chunk)
    total = 0.0
    count = 0.0
    if max_batches is not None:
        # islice, not a loop-break: a break would pull (and copy) one
        # extra batch just to discard it
        batches = itertools.islice(batches, max_batches)
    for batch in batches:
        t, n = batch_totals(row_nll, params, batch, mesh)
        total += t
        count += n
    if count == 0:
        raise ValueError("no target tokens evaluated")
    nll = total / count
    return {"nll": nll, "perplexity": math.exp(min(nll, 80.0)),
            "tokens": int(count)}


def batch_totals(row_nll, params, batch, mesh=None) -> tuple:
    """(summed NLL, target count) of one batch as floats: over the
    global batch under a sharded mesh. ``row_nll``'s rows are whole
    (summed over ``cp`` already), so the total adds the data axes only;
    the count adds this rank's positions over ``cp`` and the data
    axes."""
    from ..parallel.collectives import data_sum
    from ..parallel.sharding import local_of
    local = {k: local_of(v) for k, v in batch.items()}
    total = row_nll(params, local).sum()
    mask = _rank_mask(local.get("mask"), local["targets"], mesh)
    count = (mask.float().sum() if mask is not None
             else torch.tensor(float(local["targets"].numel()),
                               device=total.device))
    return (float(data_sum(total, mesh, axes=("fsdp", "dp"))),
            float(data_sum(count.to(total.device), mesh)))


def _render_options(prompt, options, pad_to: int, pad_id: int, device):
    """Each option row renders through the shared completion layout."""
    rows = [list(prompt) + list(opt) for opt in options]
    b = render_rows(rows, [len(prompt)] * len(options), pad_id,
                    pad_to=pad_to)
    return {"tokens": torch.from_numpy(b["tokens"]).long().to(device),
            "targets": torch.from_numpy(b["targets"]).long().to(device),
            "mask": torch.from_numpy(b["mask"]).to(device)}


def loglikelihood_ranks(config, params, questions: Sequence[dict],
                        mesh=None, chunk: int = 512, pad_id: int = 0,
                        length_normalize: bool = False):
    """Score multiple-choice questions by continuation log-likelihood.

    ``questions``: each ``{"prompt": [ids], "options": [[ids], ...]}``
    (prompt and every option non-empty). Returns per question
    ``{"logps": [...], "choice": argmax}``; ``length_normalize`` divides
    each option's logp by its token count (lm-eval-harness "acc_norm")."""
    if not questions:
        return []
    for q in questions:
        if len(q["prompt"]) < 1:
            raise ValueError("prompt must include at least one token")
        if any(len(o) < 1 for o in q["options"]):
            raise ValueError("options must be non-empty")
    longest = max(len(q["prompt"]) + len(o)
                  for q in questions for o in q["options"])
    pad_to = -(-longest // 128) * 128
    cp = mesh.size("cp") if is_sharded(mesh) else 1
    if pad_to % cp:
        raise ValueError(
            f"options pad to {pad_to} tokens (128-aligned), which cp={cp} "
            "does not split into equal slices of the sequence")
    row_nll = make_row_nll_fn(config, mesh, chunk)
    dev = tree_leaves(params)[0][1].device

    out = []
    for q in questions:
        batch = _render_options(q["prompt"], q["options"], pad_to, pad_id,
                                dev)
        if cp > 1:
            # this rank's slice of the sequence, as shard_batch lays out
            # the corpus's ids (the mask stays whole)
            for k in ("tokens", "targets"):
                batch[k] = _cp_columns(batch[k], mesh)
        logps = -row_nll(params, batch).cpu().numpy().astype(np.float32)
        if length_normalize:
            logps = logps / np.array([len(o) for o in q["options"]],
                                     np.float32)
        out.append({"logps": [float(v) for v in logps],
                    "choice": int(np.argmax(logps))})
    return out
