"""Shared scoring primitives for sequence-level objectives: the port's
own copy of ``kubedl_tpu/train/scoring.py``.

Every post-training objective (DPO pairs, eval options) needs the same
two pieces; they live here so eval-only users don't depend on the DPO
module:

* :func:`hidden_and_head`: family-dispatched forward to final hidden
  states + densified LM head (+ MoE router aux loss), the front half of
  every chunked logprob scan;
* :func:`render_rows`: the one prompt/completion batch layout
  (right-padded 128-aligned tokens, left-shifted targets,
  completion-only mask), the pl-1 mask arithmetic validated once for all
  callers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def hidden_and_head(config, params, tokens, mesh=None):
    """Final hidden states, densified LM head, and the MoE router aux
    loss (0 for dense families; ``MoEConfig`` subclasses ``LlamaConfig``,
    so the family is found from the config's class)."""
    from ..models import io, llama
    from ..ops.quant import to_dense
    family = io.family_of(config)
    if io.family_name(config) == "moe":
        x, aux = family.forward_hidden(config, params, tokens, mesh=mesh)
    else:
        x, aux = family.forward_hidden(config, params, tokens,
                                       mesh=mesh), 0.0
    head = to_dense(llama._lm_head(config, params), config.dtype)
    return x, head, aux


def render_rows(rows, prompt_lens, pad_id: int = 0,
                pad_to: Optional[int] = None):
    """Render tokenized prompt+completion rows into the one batch layout
    every sequence-level objective shares: right-padded ``tokens``
    (128-aligned), left-shifted ``targets``, and a ``mask`` covering
    completion targets only (target index ``pl-1`` predicts the first
    completion token). Numpy arrays.

    The pl-1 arithmetic silently zeroes the mask when a prompt is empty
    (wraps to -1) or a completion is empty: both rejected here, once,
    for all callers."""
    n = len(rows)
    if len(prompt_lens) != n:
        raise ValueError("rows and prompt_lens must have equal length")
    if any(pl < 1 for pl in prompt_lens):
        raise ValueError("prompt_lens must be >= 1 (include BOS)")
    if any(pl >= len(r) for pl, r in zip(prompt_lens, rows)):
        raise ValueError("every row needs completion tokens past its "
                         "prompt_len")
    longest = max(len(r) for r in rows)
    s = pad_to or -(-longest // 128) * 128
    if longest > s:
        raise ValueError(f"pad_to={s} shorter than longest row {longest}")
    toks = np.full((n, s), pad_id, np.int32)
    tgts = np.full((n, s), pad_id, np.int32)
    mask = np.zeros((n, s), np.float32)
    for i, (row, pl) in enumerate(zip(rows, prompt_lens)):
        row = np.asarray(row, np.int32)
        toks[i, :len(row)] = row
        tgts[i, :len(row) - 1] = row[1:]
        mask[i, pl - 1:len(row) - 1] = 1.0
    return {"tokens": toks, "targets": tgts, "mask": mask}

