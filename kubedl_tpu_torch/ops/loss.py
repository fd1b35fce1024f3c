"""Memory-efficient cross-entropy over large vocabularies.

Counterpart of ``kubedl_tpu/ops/loss.py``. The naive loss materializes
float32 logits ``[b, s, vocab]``: at Llama-3 width (b=4, s=2048, V=128256)
that is 4.2 GB live in the forward and again saved for the backward.
Here the sequence runs in chunks: each chunk projects one ``[b, c, d]``
slice through the LM head (a plain ``torch.matmul``), reduces it to its
NLL and drops the chunk logits. ``torch.utils.checkpoint`` on the chunk
makes the backward recompute them instead of saving them, so the peak
logits memory is ``b * chunk * V`` floats, never ``b * s * V``.

The JAX package pads the sequence to a multiple of ``chunk`` with zero
rows, targets 0 and mask 0; padded positions add exactly 0 to every sum,
so here the last chunk is simply shorter.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_nll(x_chunk, w, targets_chunk, logit_softcap: float):
    """[b, c, d] x [d, V] -> per-token NLL [b, c]; float32 softmax."""
    logits = (x_chunk @ w).float()
    if logit_softcap and logit_softcap > 0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets_chunk[..., None].long())[..., 0]
    return logz - gold


def _masked_row_sum(x_chunk, w, targets_chunk, mask_chunk,
                    logit_softcap: float):
    return torch.sum(_chunk_nll(x_chunk, w, targets_chunk, logit_softcap)
                     * mask_chunk, dim=-1)


def _chunks(s: int, chunk: int):
    chunk = max(1, min(chunk, s))
    return [(c0, min(c0 + chunk, s)) for c0 in range(0, s, chunk)]


def chunked_token_nll(x, w, targets, mask=None, chunk: int = 512,
                      logit_softcap: float = 0.0):
    """Per-ROW summed NLL [b] (float32) over unmasked targets, scanning
    the sequence in chunks; each chunk's logits are recomputed in the
    backward. ``x`` [b, s, d] hidden states, ``w`` [d, V] LM head,
    ``targets`` [b, s] ids, ``mask`` optional [b, s] {0, 1}."""
    b, s, _ = x.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    mask = mask.float()
    total = torch.zeros((b,), dtype=torch.float32, device=x.device)
    for c0, c1 in _chunks(s, chunk):
        total = total + checkpoint(
            _masked_row_sum, x[:, c0:c1], w, targets[:, c0:c1],
            mask[:, c0:c1], logit_softcap, use_reentrant=False)
    return total


def chunked_token_logps(x, w, targets, chunk: int = 512,
                        logit_softcap: float = 0.0):
    """Per-TOKEN log P(target) [b, s] (float32) via the same chunked scan:
    [b, s] floats are cheap; only the [b, s, V] logits must never
    materialize."""
    s = x.shape[1]
    parts = [-checkpoint(_chunk_nll, x[:, c0:c1], w, targets[:, c0:c1],
                         logit_softcap, use_reentrant=False)
             for c0, c1 in _chunks(s, chunk)]
    return torch.cat(parts, dim=1)


def chunked_softmax_xent(x, w, targets, mask=None, chunk: int = 512,
                         logit_softcap: float = 0.0):
    """Mean NLL over unmasked targets (scalar float32), the same as the
    unchunked computation (same float32 softmax); see
    :func:`chunked_token_nll` for the chunked scan itself."""
    rows = chunked_token_nll(x, w, targets, mask=mask, chunk=chunk,
                             logit_softcap=logit_softcap)
    denom = (mask.float().sum() if mask is not None
             else torch.tensor(float(x.shape[0] * x.shape[1]),
                               device=x.device))
    return rows.sum() / torch.clamp_min(denom, 1.0)
