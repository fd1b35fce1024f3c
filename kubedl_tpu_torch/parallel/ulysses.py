"""Ulysses sequence parallelism: all-to-all between heads and sequence.
The counterpart of ``kubedl_tpu/parallel/ulysses.py``.

The second context-parallel scheme beside ring attention
(``parallel/ring.py``): one tiled all-to-all over ``cp``
(``collectives.all_to_all``) regroups the sequence-sharded activations so
every rank holds the WHOLE sequence for ``1/cp`` of its heads, runs the
ordinary local attention (``ops.attention.multi_head_attention``: the
flash kernels K1-K3 on the card), and a second all-to-all restores the
sequence sharding. So packed segment ids, sliding windows and the Gemma-2
knobs all compose, where the ring refuses some of them; the price is the
whole sequence's activations on each rank.

Select per model with ``LlamaConfig.cp_impl = "ring" | "ulysses"``.
GQA/MQA K/V are expanded to the query head count before the split, so the
head chunks pair with their groups; ``cp`` must divide the rank's query
heads.
"""

from __future__ import annotations

from ..ops import attention as _attn
from ..ops.attention import repeat_kv as _repeat_kv
from .collectives import all_gather, all_to_all


def ulysses_attention_p(q, k, v, mesh, segment_ids=None, window_on=None,
                        axis_name: str = "cp", causal: bool = True,
                        window: int = 0, knobs=None):
    """Per-shard body. q/k/v: [b, s_local, h_local, hd] with K/V already
    expanded to the query head count. Returns [b, s_local, h_local, hd]."""
    # seq-sharded -> head-sharded: every rank sees the whole sequence
    q, k, v = (all_to_all(x, mesh, split_dim=2, concat_dim=1,
                          axis=axis_name) for x in (q, k, v))
    if segment_ids is not None:
        segment_ids = all_gather(segment_ids, mesh, 1, axis=axis_name)
    attn = _attn.multi_head_attention(
        q, k, v, causal=causal, segment_ids=segment_ids, window=window,
        window_on=window_on, **(knobs or {}))
    # head-sharded -> seq-sharded
    return all_to_all(attn, mesh, split_dim=1, concat_dim=2, axis=axis_name)


def ulysses_attention(mesh, q, k, v, segment_ids=None, window_on=None,
                      causal: bool = True, axis_name: str = "cp",
                      window: int = 0, **knobs):
    """The entry point the model calls, with the JAX signature; every rank
    calls it on its own sequence shard of its own heads (under ``tp`` the
    caller has cut them, ``models.llama.attention_block``)."""
    cp = mesh.size(axis_name)
    h_local = q.shape[2]
    if h_local % cp:
        raise ValueError(
            f"ulysses needs the tp-local query head count ({h_local}) "
            f"divisible by cp ({cp})")
    if k.shape[2] != h_local:
        # expand K/V to full query heads so each head chunk carries its
        # own keys (chunked GQA grouping would otherwise pair head chunks
        # with the wrong kv chunks)
        k = _repeat_kv(k, h_local)
        v = _repeat_kv(v, h_local)
    return ulysses_attention_p(q, k, v, mesh, segment_ids=segment_ids,
                               window_on=window_on, axis_name=axis_name,
                               causal=causal, window=window, knobs=knobs)


__all__ = ["ulysses_attention", "ulysses_attention_p"]
