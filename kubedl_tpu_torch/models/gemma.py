"""Gemma model family: the counterpart of ``kubedl_tpu/models/gemma.py``.

Gemma reuses the transformer core of :mod:`kubedl_tpu_torch.models.llama`
with the family knobs that distinguish it from Llama:

* GeGLU MLP (tanh-approximated gelu gate) instead of SwiGLU,
* RMSNorm scaling by ``(1 + weight)`` with zero-initialized weights,
* embeddings multiplied by ``sqrt(d_model)``,
* LM head tied to the embedding table (no ``lm_head`` param),
* Gemma-2 additionally softcaps final logits at 30, sandwich-norms both
  sublayers, softcaps attention logits, scales queries by its own
  ``query_pre_attn_scalar``, and slides a 4096-token window on even
  layers only (``window_pattern="alternate"``). Those attention knobs
  take the chunked attention path in both packages (no kernel); on a
  ``cp``-sharded sequence they need ``cp_impl="ulysses"``, and the ring
  refuses them, as in the JAX package.

``forward`` / ``forward_step`` / ``loss_fn`` / ``init_params`` /
``init_cache`` work unchanged on these configs; this module only pins the
shapes.
"""

from __future__ import annotations

from dataclasses import replace

from .llama import LlamaConfig
from .llama import (forward, forward_hidden, forward_step,  # noqa: F401 — re-exported family API
                    forward_step_paged, init_block_pool, init_cache,
                    init_params, loss_fn)

_GEMMA_KNOBS = dict(
    act="gelu",
    norm_weight_offset=1.0,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
)


def gemma_2b() -> LlamaConfig:
    """Gemma-1 2B: MQA (1 KV head), head_dim 256, 18 layers."""
    return LlamaConfig(vocab_size=256128, d_model=2048, n_layers=18,
                       n_heads=8, n_kv_heads=1, d_ff=16384, head_dim=256,
                       max_seq_len=8192, **_GEMMA_KNOBS)


def gemma_7b() -> LlamaConfig:
    return LlamaConfig(vocab_size=256128, d_model=3072, n_layers=28,
                       n_heads=16, n_kv_heads=16, d_ff=24576, head_dim=256,
                       max_seq_len=8192, **_GEMMA_KNOBS)


def gemma2_2b() -> LlamaConfig:
    """Gemma-2 2B: sandwich norms, attention-score softcap 50,
    query_pre_attn_scalar 256, final-logit softcap 30, and the alternating
    window pattern (even layers slide at 4096, odd are global)."""
    return LlamaConfig(vocab_size=256128, d_model=2304, n_layers=26,
                       n_heads=8, n_kv_heads=4, d_ff=9216, head_dim=256,
                       max_seq_len=8192, logit_softcap=30.0,
                       sliding_window=4096, window_pattern="alternate",
                       sandwich_norms=True, attn_logit_softcap=50.0,
                       query_scale=256.0, **_GEMMA_KNOBS)


def tiny(vocab: int = 512, seq: int = 256) -> LlamaConfig:
    """CI config with the Gemma-1 knobs and a final-logit softcap."""
    return LlamaConfig(vocab_size=vocab, d_model=128, n_layers=2, n_heads=4,
                       n_kv_heads=1, d_ff=256, head_dim=32, max_seq_len=seq,
                       logit_softcap=30.0, **_GEMMA_KNOBS)


def from_llama(config: LlamaConfig) -> LlamaConfig:
    """Apply the Gemma family knobs to an arbitrary shape (tests)."""
    return replace(config, **_GEMMA_KNOBS)
