"""Llama-family decoder in PyTorch: the counterpart of
``kubedl_tpu/models/llama.py``.

Parameters are a plain dict with the JAX package's keys and layouts:
``embed [vocab, d]``, ``final_norm [d]``, ``lm_head [d, vocab]`` and
``layers/<name>`` stacked on a leading ``[n_layers]`` axis, matmul
weights stored ``[in, out]`` (``x @ w``). Weights live in the config
dtype; norm scales and projection biases stay float32; norms, softmax
and RoPE run in float32. So a JAX artifact loads unchanged
(``models/io.py``) and the two packages compute on the same tensors.

Attention goes through ``ops.attention.multi_head_attention``: the
hand-written flash kernels on the card (forward, and dQ/dK/dV when
autograd records), the chunked path on the CPU; the decode tick's
attention through ``ops.decode.paged_decode`` (its kernel reads the K/V
cache in place). Training adds
:func:`loss_fn`/:func:`lm_loss` (the chunked LM-head loss of
``ops/loss.py``) and per-layer recomputation (``config.remat``).

Under a sharded ``mesh`` (``parallel/mesh.py``) the params are
``parallel.sharding.ShardedTensor`` views: each block gathers the weights
it uses (``materialize``; ``fsdp`` gathers one layer at a time) and
computes on its rows of the batch. Under ``tp`` attention runs the
kernels on the rank's own heads (``wq``/``wk``/``wv`` column-parallel,
``wo`` row-parallel, its partial outputs summed over ``tp``), and the MLP
on its own ``d_ff`` columns the same way. When ``tp`` does not divide
``n_kv_heads`` (Gemma's one KV head) the K/V weights are gathered whole,
so every rank holds the KV heads its query heads read, as the JAX
serving path replicates its cache. When ``tp`` does not divide
``n_heads`` (Qwen2-7B's 28 at ``tp=8``) the storage stays JAX's equal
column chunks, which split a head; the attention leaves are then
gathered whole and each rank computes whole heads, one more on each of
the first ``n_heads % tp`` ranks (:func:`head_split`,
:func:`_attn_views`). The embedding and the LM head are
gathered whole over ``tp`` for the lookup and the loss, their storage
and gradients staying sharded (a vocab-parallel loss would skip that
gather: ROADMAP B11).

Under ``cp`` each rank holds a slice of the sequence, and attention takes
one of the JAX block's three branches: Ulysses (``cp_impl="ulysses"``,
``parallel/ulysses.py``), the ring (``parallel/ring.py``) when there are
no segment ids, or, with segment ids on the ring setting, the rank's
query rows against K, V and the segment ids all-gathered over ``cp`` (K1
at offsets ``(my * s_local, 0)``; with Gemma-2's knobs the chunked path
at the same offsets), which GSPMD does for the JAX block.
RoPE positions are global (``my * s_local + arange``), and the loss
takes the rank's columns of a ``[b, s]`` mask that ``shard_batch``
leaves whole.

Tensor-parallel serving (``serving.engine.shard_for_serving``) hands the
model plain tensors, each rank's own shard (whole query heads), with the
serving ``mesh`` (``fsdp``-sharded leaves come as views, as in training):
the cache-aware steps (:func:`forward_step`, :func:`attention_step`)
run the rank's heads against its KV heads (the cache from
:func:`init_cache` / :func:`init_block_pool` holds ``n_kv_heads // tp``
of them, or all where ``tp`` does not divide them), the embedding lookup
and the LM head stay on the rank's vocab shard (``vocab_lookup``, then
each rank's logits all-gathered: ``vocab_gather``), and ``forward_hidden``
runs the flash kernel on the rank's heads.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.attention import (chunked_attention, flash_attention,
                             multi_head_attention)
from ..ops.decode import paged_decode
from ..ops.loss import chunked_token_nll
from ..ops.quant import mm as _mm
from ..ops.quant import to_dense
from ..parallel.collectives import (all_gather, is_sharded, loss_share,
                                    tp_sum, vocab_gather, vocab_lookup)
from ..parallel.sharding import ShardedTensor, materialize, spec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_name(dtype) -> str:
    """The portable name of a torch dtype (``bfloat16``, ``float32`` ...):
    how ``config.json`` stores it."""
    for name, dt in _DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"unsupported model dtype {dtype!r}")


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    head_dim: Optional[int] = None
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    #: a torch dtype, or its name (``"bfloat16"``); held as the torch dtype
    dtype: object = torch.bfloat16
    # training-side fields, kept so a JAX artifact's config round-trips
    remat: bool = True
    scan_layers: bool = True
    loss_chunk: int = 0
    # -- family knobs (Gemma reuses this transformer core) ----------------
    #: MLP activation: "silu" (Llama SwiGLU) or "gelu" (Gemma GeGLU)
    act: str = "silu"
    #: RMSNorm scales by (offset + weight): Llama 0, Gemma 1
    norm_weight_offset: float = 0.0
    #: Gemma multiplies embeddings by sqrt(d_model)
    embed_scale: bool = False
    #: Gemma ties the LM head to the embedding table (no lm_head param)
    tie_embeddings: bool = False
    #: Gemma-2 final-logit softcap: cap * tanh(logits / cap); 0 = off
    logit_softcap: float = 0.0
    #: >0: sliding-window (local) attention over the last N keys
    sliding_window: int = 0
    #: Qwen2-style additive biases on the q/k/v projections
    qkv_bias: bool = False
    # -- Gemma-2 knobs ----------------------------------------------------
    sandwich_norms: bool = False
    attn_logit_softcap: float = 0.0
    query_scale: float = 0.0
    #: "uniform" or "alternate" (even layers slide, odd are global)
    window_pattern: str = "uniform"
    #: context-parallel scheme when the mesh has cp > 1: "ring" (K/V
    #: blocks rotate, O(s/cp) activations) or "ulysses" (all-to-all
    #: heads <-> sequence; composes with segments, windows, Gemma-2 knobs)
    cp_impl: str = "ring"

    def __post_init__(self):
        if isinstance(self.dtype, str):
            if self.dtype not in _DTYPES:
                raise ValueError(f"unsupported model dtype {self.dtype!r}")
            object.__setattr__(self, "dtype", _DTYPES[self.dtype])
        dtype_name(self.dtype)
        if self.sliding_window < 0:
            raise ValueError(
                f"sliding_window must be >= 0, got {self.sliding_window}")
        if self.window_pattern not in ("uniform", "alternate"):
            raise ValueError(
                f"unknown window_pattern {self.window_pattern!r}")
        if self.window_pattern == "alternate" and not self.sliding_window:
            raise ValueError(
                "window_pattern='alternate' needs sliding_window > 0")
        if self.cp_impl not in ("ring", "ulysses"):
            raise ValueError(f"unknown cp_impl {self.cp_impl!r}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def num_params(self) -> int:
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.qkv_bias:
            attn += hd * (self.n_heads + 2 * self.n_kv_heads)
        mlp = 3 * d * self.d_ff
        per_layer = attn + mlp + (4 if self.sandwich_norms else 2) * d
        head = (1 if self.tie_embeddings else 2) * self.vocab_size * d
        return self.n_layers * per_layer + head + d

    def to_dict(self) -> dict:
        """JSON-ready fields, dtype by name (``config.json``'s form)."""
        out = dataclasses.asdict(self)
        out["dtype"] = dtype_name(self.dtype)
        return out


# -- canonical configs -------------------------------------------------------

#: the family's config class (``models.io`` finds a config's family by it)
CONFIG = LlamaConfig
#: ``/v1/embeddings`` pads a batch to its longest input: padding sits after
#: the real tokens and attention is causal, so it changes nothing
EMBED_BUCKET = None


def llama3_8b() -> LlamaConfig:
    return LlamaConfig(vocab_size=128256, d_model=4096, n_layers=32,
                       n_heads=32, n_kv_heads=8, d_ff=14336)


def llama2_7b() -> LlamaConfig:
    return LlamaConfig(vocab_size=32000, d_model=4096, n_layers=32,
                       n_heads=32, n_kv_heads=32, d_ff=11008,
                       rope_theta=10000.0)


def mistral_7b() -> LlamaConfig:
    """Mistral-7B-v0.1: Llama core + GQA + 4096-token sliding window."""
    return LlamaConfig(vocab_size=32000, d_model=4096, n_layers=32,
                       n_heads=32, n_kv_heads=8, d_ff=14336,
                       rope_theta=10000.0, max_seq_len=32768,
                       sliding_window=4096)


def qwen2_7b() -> LlamaConfig:
    """Qwen2-7B: GQA with q/k/v projection biases and a 1e6 rope base."""
    return LlamaConfig(vocab_size=152064, d_model=3584, n_layers=28,
                       n_heads=28, n_kv_heads=4, d_ff=18944,
                       rope_theta=1e6, max_seq_len=32768, qkv_bias=True)


def tiny(vocab: int = 512, seq: int = 256) -> LlamaConfig:
    """CI config."""
    return LlamaConfig(vocab_size=vocab, d_model=128, n_layers=2, n_heads=4,
                       n_kv_heads=2, d_ff=256, max_seq_len=seq,
                       rope_theta=10000.0)


# -- params ------------------------------------------------------------------

def param_shapes(config: LlamaConfig) -> dict:
    """``{key: (shape, float32?)}`` of the parameter dict; ``layers/*``
    shapes are per layer (stacked on a leading ``n_layers`` axis)."""
    c = config
    d, hd, nh, nkv = c.d_model, c.hd, c.n_heads, c.n_kv_heads
    layer = {
        "attn_norm": ((d,), True),
        "wq": ((d, nh * hd), False),
        "wk": ((d, nkv * hd), False),
        "wv": ((d, nkv * hd), False),
        "wo": ((nh * hd, d), False),
        "mlp_norm": ((d,), True),
        "w_gate": ((d, c.d_ff), False),
        "w_up": ((d, c.d_ff), False),
        "w_down": ((c.d_ff, d), False),
    }
    if c.qkv_bias:
        layer.update(bq=((nh * hd,), True), bk=((nkv * hd,), True),
                     bv=((nkv * hd,), True))
    if c.sandwich_norms:
        layer.update(post_attn_norm=((d,), True), post_ffw_norm=((d,), True))
    top = {"embed": ((c.vocab_size, d), False), "final_norm": ((d,), True)}
    if not c.tie_embeddings:
        top["lm_head"] = ((d, c.vocab_size), False)
    return {"layers": layer, **top}


def param_specs(config: LlamaConfig) -> dict:
    """Logical shardings per param (the leading layer axis is unsharded):
    the JAX package's specs for the same config. The port stacks every
    layer leaf on a leading ``[n_layers]`` axis whatever ``scan_layers``
    says (``models/io.py`` stacks a per-layer artifact), so its specs
    keep the ``"layers"`` entry where the JAX package, at
    ``scan_layers=False``, lists one unstacked dict per layer."""
    def ls(*axes) -> tuple:
        return spec("layers", *axes)

    layer = {
        "attn_norm": ls("norm"),
        "wq": ls("embed", "heads"),
        **({"bq": ls("heads"), "bk": ls("kv_heads"), "bv": ls("kv_heads")}
           if config.qkv_bias else {}),
        **({"post_attn_norm": ls("norm"), "post_ffw_norm": ls("norm")}
           if config.sandwich_norms else {}),
        "wk": ls("embed", "kv_heads"),
        "wv": ls("embed", "kv_heads"),
        "wo": ls("heads", "embed"),
        "mlp_norm": ls("norm"),
        "w_gate": ls("embed", "mlp"),
        "w_up": ls("embed", "mlp"),
        "w_down": ls("mlp", "embed"),
    }
    specs = {
        "embed": spec("vocab", "embed"),
        "layers": layer,
        "final_norm": spec("norm"),
    }
    if not config.tie_embeddings:
        specs["lm_head"] = spec("embed", "vocab")
    return specs


def init_params(config: LlamaConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters with the JAX package's keys, shapes and fan-in
    scaling (normal / sqrt(fan_in), norms at identity, biases zero). The
    draws come from ``generator`` on its own device, one layer at a time
    (a full-size model never holds a float32 copy of a whole stack), and
    land on ``device``. The two frameworks' RNGs differ, so parity tests
    load JAX-made weights instead (``models/io.py``)."""
    c = config
    dev = resolve_device(device)
    norm_init = 1.0 - c.norm_weight_offset
    shapes = param_shapes(c)

    def leaf(shape, f32, lead=()):
        dt = torch.float32 if f32 else c.dtype
        return torch.empty(lead + shape, dtype=dt, device=dev)

    def fill(out, shape, f32, name):
        if not f32:
            # fan-in is the input dim of an [in, out] weight; the embedding
            # table [vocab, d] is scaled by d, as in the JAX package
            fan_in = shape[1] if name == "embed" else shape[0]
            draw = torch.randn(shape, generator=generator,
                               device=generator.device)
            out.copy_(draw * (1.0 / math.sqrt(fan_in)))
        elif name in ("bq", "bk", "bv"):
            out.zero_()
        else:
            out.fill_(norm_init)

    layers = {}
    for name, (shape, f32) in shapes["layers"].items():
        layers[name] = leaf(shape, f32, (c.n_layers,))
    for i in range(c.n_layers):
        for name, (shape, f32) in shapes["layers"].items():
            fill(layers[name][i], shape, f32, name)
    params = {"layers": layers}
    for name, spec in shapes.items():
        if name != "layers":
            params[name] = leaf(*spec)
            fill(params[name], *spec, name)
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``layers`` dict (views). Wrapped
    leaves (``QTensor``, ``Q4Tensor``, ``LoraTensor``) slice field by
    field and keep their metadata, so every matmul site takes them."""
    return {k: v[i] for k, v in params["layers"].items()}


# -- ops ---------------------------------------------------------------------

def rms_norm(x, weight, eps: float, offset: float = 0.0):
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * (offset + weight)).to(x.dtype)


def window_flags(config: LlamaConfig):
    """Per-layer bools of which layers apply the sliding window, or None
    when the pattern is uniform. Gemma-2 rule: EVEN layers slide."""
    if config.window_pattern != "alternate":
        return None
    return [i % 2 == 0 for i in range(config.n_layers)]


def _attn_knobs(config: LlamaConfig) -> dict:
    """Gemma-2 attention extras forwarded into the attention ops."""
    out = {}
    if config.query_scale:
        out["scale"] = config.query_scale ** -0.5
    if config.attn_logit_softcap:
        out["logit_softcap"] = config.attn_logit_softcap
    return out


def _qkv(config: LlamaConfig, h, lp, w_name: str, b_name: str):
    """One q/k/v projection, with the family's optional additive bias
    (Qwen2). The bias lives in float32 next to the norms; cast at use."""
    y = _mm(h, lp[w_name])
    if config.qkv_bias:
        y = y + lp[b_name].to(y.dtype)
    return y


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


_ACTS = {"silu": torch.nn.functional.silu, "gelu": _gelu_tanh}


def _act(config: LlamaConfig):
    try:
        return _ACTS[config.act]
    except KeyError:
        raise ValueError(
            f"unknown act {config.act!r}; one of {sorted(_ACTS)}") from None


def _lm_head(config: LlamaConfig, params: dict):
    """[d, vocab] projection; Gemma ties it to the embedding table. May be
    a ``QTensor``/``Q4Tensor`` under quantized serving (consumers go
    through ``quant.mm`` / ``quant.to_dense``). A sharded head is
    gathered whole."""
    if config.tie_embeddings:
        return materialize(params["embed"], gather_tp=True).T.to(
            config.dtype)
    w = materialize(params["lm_head"], gather_tp=True)
    return w.to(config.dtype) if torch.is_tensor(w) else w


def _vocab_parallel(params: dict, mesh) -> bool:
    """Whether the embedding table is this rank's vocab shard (serving
    under ``tp``: a plain tensor; sharded training passes
    ``ShardedTensor`` views, gathered whole)."""
    return _tp(mesh) > 1 and torch.is_tensor(params["embed"])


def _logits(config: LlamaConfig, params: dict, x, mesh=None):
    """Final hidden states -> float32 logits over the whole vocabulary
    (softcapped). Under serving ``tp`` each rank projects onto its vocab
    shard and the shards are all-gathered."""
    logits = _mm(x, _lm_head(config, params)).float()
    if _vocab_parallel(params, mesh):
        logits = vocab_gather(logits, mesh)
    return _softcap(config, logits)


def _softcap(config: LlamaConfig, logits):
    cap = config.logit_softcap
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def _embed(config: LlamaConfig, params: dict, tokens, mesh=None):
    if _vocab_parallel(params, mesh):
        x = vocab_lookup(params["embed"], tokens, mesh).to(config.dtype)
    else:
        x = materialize(params["embed"], gather_tp=True)[tokens].to(
            config.dtype)
    if config.embed_scale:
        # a fill, not a host-to-device copy: legal inside a CUDA graph
        x = x * torch.full((), math.sqrt(config.d_model), dtype=config.dtype,
                           device=x.device)
    return x


def rope_frequencies(config: LlamaConfig, positions):
    """[seq] (or [b, seq]) int positions -> (cos, sin) of shape
    [seq, hd/2] (or [b, seq, hd/2]), float32."""
    hd = config.hd
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv_freq = 1.0 / (config.rope_theta ** exps)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: [b, s, h, hd]; cos/sin: [s, hd/2] shared across the batch or
    [b, s, hd/2] per row. Float32 rotation of the split halves."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    if cos.ndim == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def _check_mesh(mesh) -> None:
    """A mesh the model can run: a ``parallel.mesh.Mesh`` whose axes
    above 1 have a process group behind them (``build_mesh`` under an open
    group)."""
    if mesh is None:
        return
    shape = getattr(mesh, "shape", None)
    if not isinstance(shape, dict):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if mesh.sharded and getattr(mesh, "device_mesh", None) is None:
        raise ValueError(f"mesh {shape} spans more than one rank but has no "
                         "process group: build it with parallel.mesh."
                         "build_mesh under an open group")


def _cp(mesh) -> int:
    return mesh.size("cp") if is_sharded(mesh) else 1


def _cp_columns(x, mesh):
    """This ``cp`` rank's columns of a ``[b, S]`` leaf held whole over
    ``cp`` (``train/data.shard_batch`` shards only integer ``[b, s]``
    leaves on it, as JAX's does)."""
    s = x.shape[1] // _cp(mesh)
    i = mesh.index("cp")
    return x[:, i * s:(i + 1) * s]


def _rank_mask(mask, targets, mesh):
    """``mask`` over this rank's target positions: under ``cp`` a ``[b,
    S]`` mask held whole over the sequence is cut to the columns of the
    rank's ``targets``; otherwise ``mask`` itself."""
    if mask is not None and mask.shape[1] != targets.shape[1]:
        return _cp_columns(mask, mesh)
    return mask


def _tp(mesh) -> int:
    return mesh.size("tp") if is_sharded(mesh) else 1


def _views(lp: dict, names: tuple, gather_tp=()) -> dict:
    """The weights of ``names`` in ``lp`` as the block computes with them
    (``parallel.sharding.materialize``); ``gather_tp`` names those taken
    whole over ``tp``."""
    return {k: materialize(lp[k], k in gather_tp) for k in names if k in lp}


def _kv_replicated(config: LlamaConfig, mesh) -> bool:
    """Whether ``tp`` cannot split the KV heads, so K/V run whole."""
    tp = _tp(mesh)
    return tp > 1 and config.n_kv_heads % tp != 0


def head_split(n_heads: int, tp: int, rank: int) -> tuple:
    """``(first, count)`` of the whole query heads ``tp`` rank ``rank``
    computes: ``n_heads // tp`` each, and one more on each of the first
    ``n_heads % tp`` ranks (Qwen2-7B's 28 heads at ``tp=8``: 4, 4, 4, 4,
    3, 3, 3, 3)."""
    base, extra = divmod(n_heads, tp)
    return rank * base + min(rank, extra), base + (rank < extra)


def _rank_heads(config: LlamaConfig, mesh) -> tuple:
    """:func:`head_split` of this ``tp`` rank (the mesh's ``tp`` size and
    index; the whole model on one rank)."""
    tp = mesh.size("tp") if mesh is not None else 1
    return head_split(config.n_heads, tp, mesh.index("tp") if tp > 1 else 0)


def _local_kv(config: LlamaConfig, k, v, mesh):
    """Of whole K/V [b, s, n_kv_heads, hd], the KV heads the rank's query
    heads (:func:`_rank_heads`) read: a slice when they are a run of whole
    GQA groups, else one KV head per query head."""
    group = config.n_heads // config.n_kv_heads
    first, nq = _rank_heads(config, mesh)
    idx = [(first + i) // group for i in range(nq)]
    lo, n = idx[0], idx[-1] + 1 - idx[0]
    if nq % n == 0 and idx == [lo + i // (nq // n) for i in range(nq)]:
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    # built on the device, so a captured decode tick takes it too
    sel = torch.div(torch.arange(first, first + nq, device=k.device),
                    group, rounding_mode="floor")
    return k.index_select(2, sel), v.index_select(2, sel)


def kv_heads_local(config: LlamaConfig, mesh) -> int:
    """The KV heads a rank's cache holds: its ``n_kv_heads // tp`` when
    ``tp`` divides them, else all of them (every rank writes the same
    K/V; the JAX serving path replicates its cache there)."""
    tp = _tp(mesh)
    return config.n_kv_heads // tp if config.n_kv_heads % tp == 0 \
        else config.n_kv_heads


_ATTN_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
                "post_attn_norm")
_KV_LEAVES = ("wk", "wv", "bk", "bv")
_MLP_LEAVES = ("mlp_norm", "w_gate", "w_up", "w_down", "post_ffw_norm")
#: the leaves split by query head, and the dim of their ``[in, out]``
#: product (or bias) that holds the heads
_HEAD_DIMS = {"wq": -1, "bq": -1, "wo": -2}


def _cut_heads(w, dim: int, cols: slice):
    """``w`` cut to ``cols`` along ``dim`` (-1 the output, -2 the input);
    a LoRA weight cuts its base and its factor on that side."""
    if torch.is_tensor(w):
        return w[..., cols] if dim == -1 else w[..., cols, :]
    side = "b" if dim == -1 else "a"
    return dataclasses.replace(w, base=_cut_heads(w.base, dim, cols),
                               **{side: _cut_heads(getattr(w, side), dim,
                                                   cols)})


def _stored_sharded(w) -> bool:
    """Whether ``w`` is a placed leaf (a :class:`ShardedTensor`, or a
    wrapped weight holding them) rather than serving's own cut."""
    return isinstance(w, ShardedTensor) or any(
        isinstance(getattr(w, f), ShardedTensor)
        for f in getattr(w, "_arrays", ()))


def _attn_views(config: LlamaConfig, lp: dict, mesh) -> dict:
    """The attention weights as the rank computes with them: its query
    heads (:func:`_rank_heads`) of ``wq``/``bq``/``wo``, and its KV heads,
    or all of them where ``tp`` does not divide ``n_kv_heads``. A placed
    leaf holds JAX's equal ``tp`` chunks of the columns; where ``tp`` does
    not divide the query heads those chunks split a head, so it is
    gathered whole over ``tp`` and cut to the rank's heads (the gather's
    backward reduce-scatters the gradient back to the chunks). Serving's
    plain leaves are the rank's heads already
    (``serving.engine.serving_cut``)."""
    tp = _tp(mesh)
    kv_whole = _kv_replicated(config, mesh)
    if tp == 1 or config.n_heads % tp == 0:
        return _views(lp, _ATTN_LEAVES, _KV_LEAVES if kv_whole else ())
    first, n = _rank_heads(config, mesh)
    cols = slice(first * config.hd, (first + n) * config.hd)
    out = {}
    for k in _ATTN_LEAVES:
        if k not in lp:
            continue
        w = materialize(lp[k], gather_tp=True)
        if k in _HEAD_DIMS and _stored_sharded(lp[k]):
            w = _cut_heads(w, _HEAD_DIMS[k], cols)
        out[k] = w
    return out


def _cp_attention(config: LlamaConfig, q, k, v, segment_ids, mesh,
                  window_on):
    """Attention on a ``cp``-sharded sequence: the three branches of the
    JAX block (module docstring). q/k/v are the rank's sequence shard of
    its heads."""
    c = config
    knobs = _attn_knobs(c)
    gemma2 = bool(knobs) or window_on is not None
    if c.cp_impl == "ulysses":
        from ..parallel.ulysses import ulysses_attention
        return ulysses_attention(mesh, q, k, v, segment_ids=segment_ids,
                                 window_on=window_on, causal=True,
                                 window=c.sliding_window, **knobs)
    if segment_ids is None:
        if gemma2:
            raise ValueError(
                "Gemma-2 attention knobs (query scale / attn softcap / "
                "alternate window pattern) are not supported with a "
                "ring-sharded sequence; set cp_impl='ulysses'")
        from ..parallel.ring import ring_attention
        return ring_attention(mesh, q, k, v, causal=True,
                              window=c.sliding_window)
    # packed rows on the ring setting: this rank's query rows against the
    # whole sequence's K/V and segments (all-gathered over cp; the
    # backward reduce-scatters dK/dV back to the shards), as GSPMD runs
    # the JAX block's plain branch
    s = q.shape[1]
    k_all, v_all = all_gather(k, mesh, 1), all_gather(v, mesh, 1)
    kv_seg = all_gather(segment_ids, mesh, 1)
    offsets = (mesh.index("cp") * s, 0)
    if gemma2:
        # the knobs' route in both packages: the chunked path
        return chunked_attention(q, k_all, v_all, causal=True,
                                 segment_ids=segment_ids,
                                 kv_segment_ids=kv_seg, offsets=offsets,
                                 window=c.sliding_window,
                                 window_on=window_on, **knobs)
    return flash_attention(q, k_all, v_all, causal=True,
                           segment_ids=segment_ids, kv_segment_ids=kv_seg,
                           offsets=offsets, window=c.sliding_window)


def _check_ulysses_heads(config: LlamaConfig, mesh) -> None:
    """Under Ulysses every ``tp`` rank's query heads must split over
    ``cp``; where ``tp`` does not divide the heads the ranks hold two
    counts, so both are checked on every rank (a refusal on some ranks
    would leave the others waiting in a collective)."""
    tp, cp = _tp(mesh), _cp(mesh)
    counts = {head_split(config.n_heads, tp, r)[1] for r in range(tp)}
    bad = sorted(n for n in counts if n % cp)
    if bad:
        raise ValueError(
            f"ulysses needs the tp-local query head count ({bad[0]}) "
            f"divisible by cp ({cp})")


def attention_block(config: LlamaConfig, x, lp, cos, sin, segment_ids,
                    mesh=None, window_on=None):
    """Pre-norm attention sublayer with residual. ``window_on`` toggles
    the sliding window per layer (Gemma-2's alternate pattern). Under
    ``tp`` the rank computes its own heads and the output projection's
    partial sums are added over ``tp``; under ``cp`` attention runs on the
    rank's slice of the sequence (:func:`_cp_attention`)."""
    c = config
    _check_mesh(mesh)
    if c.window_pattern == "alternate" and window_on is None:
        raise ValueError(
            "window_pattern='alternate' requires a per-layer window_on "
            "flag (thread window_flags(config) through the layer loop)")
    lp = _attn_views(c, lp, mesh)
    b, s, _ = x.shape
    hd = c.hd

    h = rms_norm(x, lp["attn_norm"], c.rms_eps, c.norm_weight_offset)
    q = _qkv(c, h, lp, "wq", "bq").reshape(b, s, -1, hd)
    k = _qkv(c, h, lp, "wk", "bk").reshape(b, s, -1, hd)
    v = _qkv(c, h, lp, "wv", "bv").reshape(b, s, -1, hd)
    if _kv_replicated(c, mesh):
        k, v = _local_kv(c, k, v, mesh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if _cp(mesh) > 1:
        if c.cp_impl == "ulysses":
            _check_ulysses_heads(c, mesh)
        attn = _cp_attention(c, q, k, v, segment_ids, mesh, window_on)
    else:
        attn = multi_head_attention(q, k, v, causal=True,
                                    segment_ids=segment_ids,
                                    window=c.sliding_window,
                                    window_on=window_on, **_attn_knobs(c))
    delta = tp_sum(_mm(attn.reshape(b, s, -1), lp["wo"]), mesh)
    if c.sandwich_norms:
        delta = rms_norm(delta, lp["post_attn_norm"], c.rms_eps,
                         c.norm_weight_offset)
    return x + delta


def _mlp(config: LlamaConfig, x, lp, mesh=None):
    """Gated MLP (SwiGLU for Llama, GeGLU for Gemma) with residual;
    Gemma-2 wraps it in sandwich norms. Under ``tp`` the rank computes
    its own ``d_ff`` columns and the down projection's partial sums are
    added over ``tp``."""
    c = config
    lp = _views(lp, _MLP_LEAVES)
    h = rms_norm(x, lp["mlp_norm"], c.rms_eps, c.norm_weight_offset)
    gated = _act(c)(_mm(h, lp["w_gate"]).float()).to(h.dtype)
    y = tp_sum(_mm(gated * _mm(h, lp["w_up"]), lp["w_down"]), mesh)
    if c.sandwich_norms:
        y = rms_norm(y, lp["post_ffw_norm"], c.rms_eps, c.norm_weight_offset)
    return x + y


def _layer_forward(config: LlamaConfig, x, lp, cos, sin, segment_ids,
                   mesh=None, window_on=None):
    x = attention_block(config, x, lp, cos, sin, segment_ids, mesh,
                        window_on)
    return _mlp(config, x, lp, mesh)


def forward_hidden(config: LlamaConfig, params: dict, tokens,
                   positions=None, segment_ids=None, mesh=None,
                   apply_layers=None):
    """tokens [b, s] int -> final hidden states [b, s, d] (pre-LM-head).

    ``apply_layers(x, cos, sin) -> x`` (optional) replaces the layer
    stack while keeping the prologue (embed/embed_scale/rope) and the
    final norm shared.

    When autograd records (training), the stacked ``layers`` params are
    unbound once, so the backward stacks each weight's gradient once
    instead of adding a full-stack zero tensor per layer, and with
    ``config.remat`` each layer runs under ``torch.utils.checkpoint``:
    only its input is kept, and the backward recomputes the layer (the
    flash forward kernel included) before differentiating it. The JAX
    package keeps the matmul outputs (``checkpoint_dots_with_no_batch_dims``)
    and recomputes the rest; this recomputes the whole layer, trading
    matmul time for the simplest correct policy."""
    c = config
    _check_mesh(mesh)
    s = tokens.shape[1]
    if positions is None:
        # under cp the rank's tokens sit at global positions
        first = mesh.index("cp") * s if _cp(mesh) > 1 else 0
        positions = torch.arange(first, first + s, device=tokens.device)
    cos, sin = rope_frequencies(c, positions)
    x = _embed(c, params, tokens, mesh)
    if apply_layers is not None:
        x = apply_layers(x, cos, sin)
    else:
        flags = window_flags(c)
        training = torch.is_grad_enabled()
        if training:
            stacked = {k: v.unbind(0) for k, v in params["layers"].items()}
        for i in range(c.n_layers):
            lp = ({k: v[i] for k, v in stacked.items()} if training
                  else layer_params(params, i))
            window_on = None if flags is None else flags[i]
            if training and c.remat:
                x = checkpoint(
                    _layer_forward, c, x, lp, cos, sin, segment_ids, mesh,
                    window_on, use_reentrant=False)
            else:
                x = _layer_forward(c, x, lp, cos, sin, segment_ids,
                                   mesh=mesh, window_on=window_on)
    return rms_norm(x, materialize(params["final_norm"]), c.rms_eps,
                    c.norm_weight_offset)


def forward(config: LlamaConfig, params: dict, tokens, positions=None,
            segment_ids=None, mesh=None):
    """tokens [b, s] int -> logits [b, s, vocab] float32."""
    x = forward_hidden(config, params, tokens, positions, segment_ids, mesh)
    return _logits(config, params, x, mesh)


# -- KV-cache inference path -------------------------------------------------

def init_cache(config: LlamaConfig, batch: int, max_len: int, dtype=None,
               device=None, mesh=None) -> dict:
    """Stacked KV cache [n_layers, b, max_len, n_kv_heads, hd]; under a
    serving ``mesh``, the rank's KV heads (:func:`kv_heads_local`)."""
    c = config
    shape = (c.n_layers, batch, max_len, kv_heads_local(c, mesh), c.hd)
    dev = resolve_device(device)
    dt = dtype or c.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def init_block_pool(config: LlamaConfig, num_blocks: int, block: int,
                    dtype=None, device=None, mesh=None) -> dict:
    """Paged KV pool [n_layers, num_blocks, block, n_kv_heads, hd]: one
    shared arena of fixed-size token blocks instead of a dense per-lane
    slab. Block 0 is the garbage sink by convention: free, dead and
    parked rows point their table entries at it, so their writes never
    land in a live block. Under a serving ``mesh`` the KV-head axis is the
    rank's (:func:`kv_heads_local`); the block axis is every rank's."""
    c = config
    shape = (c.n_layers, num_blocks, block, kv_heads_local(c, mesh), c.hd)
    dev = resolve_device(device)
    dt = dtype or c.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def attention_step(config: LlamaConfig, x, lp, kc, vc, cos, sin, start_pos,
                   valid=None, window_on=None, tables=None, mesh=None):
    """Cache-aware attention sublayer (with residual): write this chunk's
    K/V at ``start_pos`` and attend against the cache with a position
    mask. ``start_pos`` is an int (whole batch at one position) or a [b]
    tensor (every row at its own position). ``valid`` [b, max_len] masks
    cache slots that hold padding. Returns (x, kc, vc).

    The JAX package donates the cache so XLA updates it in place; here
    ``kc``/``vc`` are written in place (``index_copy_``/``index_put_``)
    and returned for the same signature.

    With one shared position the JAX step scores all ``max_len`` slots
    and masks the ones past the chunk; here it reads only the live prefix
    ``[0, start_pos + s)``. The slots dropped are causally masked for every
    query, so the result is the same for every query that sees a key —
    and the same shapes run whatever the cache capacity, so the engine and
    ``greedy_rollout`` compute the same numbers.

    With ``tables`` [b, blocks_per_row] (int64), ``kc``/``vc`` are one
    layer of an :func:`init_block_pool` arena [num_blocks, block, nkv, hd]
    and row ``i``'s logical slot ``p`` lives at ``(tables[i, p // block],
    p % block)``. The chunk's K/V is written there first, then the rows'
    blocks are gathered into a dense [b, L, nkv, hd] view for the read
    (``L`` = blocks_per_row * block with per-row positions, the live
    prefix's blocks with one shared position). The JAX body gathers the
    view, writes into it and scatters the whole view back; a gathered
    view here is a copy, so writing the pool first is what keeps the
    writes, at a chunk's bytes instead of a second pass over the view.

    The decode tick (per-row positions, ``s == 1``, no ``valid``), paged
    or dense, gathers no view: after the write it reads each row's live
    K/V in place through :func:`_tick_attention` (``ops.decode``'s
    kernel on the card). Prefill, verify and training keep the path
    above.

    Under a serving ``mesh`` the weights are the rank's shards: it
    projects its own query heads and its KV heads (all of them where
    ``tp`` does not divide ``n_kv_heads``, then reads those its query
    heads belong to), writes its cache, and the output projection's
    partial sums are added over ``tp``."""
    c = config
    b, s, _ = x.shape
    hd = c.hd
    nkv = kc.shape[-2]
    dev = x.device
    row_pos = torch.is_tensor(start_pos) and start_pos.ndim == 1
    pool_k, pool_v = kc, vc
    lp = _attn_views(c, lp, mesh)

    h = rms_norm(x, lp["attn_norm"], c.rms_eps, c.norm_weight_offset)
    q = apply_rope(_qkv(c, h, lp, "wq", "bq").reshape(b, s, -1, hd),
                   cos, sin)
    nh = q.shape[2]
    k = apply_rope(_qkv(c, h, lp, "wk", "bk").reshape(b, s, nkv, hd),
                   cos, sin)
    v = _qkv(c, h, lp, "wv", "bv").reshape(b, s, nkv, hd)
    steps = torch.arange(s, device=dev)
    if tables is not None:
        blk = kc.shape[1]
        if row_pos:
            cols = start_pos.to(dev)[:, None] + steps[None, :]  # [b, s]
            n_blocks = tables.shape[1]
        else:
            start = int(start_pos)
            cols = (start + steps)[None, :].expand(b, s)
            n_blocks = -(-(start + s) // blk)
        phys = torch.gather(tables, 1, torch.div(cols, blk,
                                                 rounding_mode="floor"))
        kc.index_put_((phys, cols % blk), k.to(kc.dtype))
        vc.index_put_((phys, cols % blk), v.to(vc.dtype))
        q_pos = cols if row_pos else cols[:1]
        live = n_blocks * blk if row_pos else start + s
    elif row_pos:
        rows = torch.arange(b, device=dev)[:, None]
        cols = start_pos.to(dev)[:, None] + steps[None, :]
        kc.index_put_((rows, cols), k.to(kc.dtype))
        vc.index_put_((rows, cols), v.to(vc.dtype))
        q_pos = cols                                            # [b, s]
        live = kc.shape[1]
    else:
        start = int(start_pos)
        idx = start + steps
        kc.index_copy_(1, idx, k.to(kc.dtype))
        vc.index_copy_(1, idx, v.to(vc.dtype))
        q_pos = idx[None, :]                                    # [1, s]
        live = start + s
    if row_pos and s == 1 and valid is None:
        attn = _tick_attention(c, q, kc, vc, tables, start_pos, window_on,
                               mesh).to(x.dtype)
        return _attn_residual(c, x, lp, attn, mesh), pool_k, pool_v
    if tables is not None:
        view = tables[:, :n_blocks]
        kc = kc[view].reshape(b, n_blocks * blk, nkv, hd)
        vc = vc[view].reshape(b, n_blocks * blk, nkv, hd)
    max_len = kc.shape[1]

    ka, va = kc[:, :live], vc[:, :live]
    k_pos = torch.arange(live, device=dev)
    valid_a = None if valid is None else valid[:, :live]
    if c.sliding_window and c.sliding_window + s < max_len \
            and window_on is None:
        # windowed configs never need keys older than (q_pos - window]:
        # attend against a fixed-size span of the cache around the window
        span = min(max_len, c.sliding_window + s)
        last = q_pos[:, -1]                                     # [b or 1]
        st = torch.clamp(last + 1 - span, 0, max_len - span)
        if q_pos.shape[0] == 1:
            st0 = int(st[0])
            ka, va = kc[:, st0:st0 + span], vc[:, st0:st0 + span]
            k_pos = st0 + torch.arange(span, device=dev)
            if valid is not None:
                valid_a = valid[:, st0:st0 + span]
        else:
            gather = st[:, None] + torch.arange(span, device=dev)[None, :]
            rows = torch.arange(b, device=dev)[:, None]
            ka, va = kc[rows, gather], vc[rows, gather]
            k_pos = gather
            if valid is not None:
                valid_a = valid[rows, gather]

    if _kv_replicated(c, mesh):
        ka, va = _local_kv(c, ka, va, mesh)
        nkv = ka.shape[2]
    # GQA-grouped attention straight against the cache, no repeat_kv;
    # products and sums in float32 as the JAX step's
    # preferred_element_type=float32
    g = nh // nkv
    qg = q.reshape(b, s, nkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), ka.float())
    scale = (c.query_scale ** -0.5 if c.query_scale
             else 1.0 / math.sqrt(hd))
    scores = scores * scale
    if c.attn_logit_softcap:
        cap = c.attn_logit_softcap
        scores = cap * torch.tanh(scores / cap)
    k_pos = k_pos[None, None, :] if k_pos.ndim == 1 else k_pos[:, None, :]
    mask = k_pos <= q_pos[:, :, None]                     # [b?, q, K]
    if c.sliding_window and (window_on is None or bool(window_on)):
        mask = mask & (k_pos > q_pos[:, :, None] - c.sliding_window)
    if valid_a is not None:
        mask = mask & valid_a[:, None, :]
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bhgqk,bkhd->bqhgd", probs, va.float())
    attn = attn.reshape(b, s, nh, hd).to(x.dtype)
    return _attn_residual(c, x, lp, attn, mesh), pool_k, pool_v


def _attn_residual(config: LlamaConfig, x, lp, attn, mesh):
    """x + the output projection of ``attn`` [b, s, nh, hd] (its partial
    sums added over ``tp``), through the sandwich norm where the family
    has one."""
    b, s = attn.shape[:2]
    delta = tp_sum(_mm(attn.reshape(b, s, -1), lp["wo"]), mesh)
    if config.sandwich_norms:
        delta = rms_norm(delta, lp["post_attn_norm"], config.rms_eps,
                         config.norm_weight_offset)
    return x + delta


def _tick_attention(config: LlamaConfig, q, kc, vc, tables, pos, window_on,
                    mesh):
    """The decode tick's attention (one position a lane, per-row
    positions, no slot mask) through ``ops.decode.paged_decode``: the
    hand-written kernel on the card, its plain version on the CPU, reading
    each lane's live K/V in place. ``kc``/``vc`` are the layer's pool with
    ``tables``, or its dense slab [b, max_len, nkv, hd] without: one block
    of ``max_len`` slots a lane, so parity mode's two layouts compute the
    same numbers. Returns [b, 1, nh, hd] in q's dtype."""
    c = config
    b, _, nh, hd = q.shape
    if tables is None:
        tables = torch.arange(b, device=q.device)[:, None]
    if _kv_replicated(c, mesh):
        # the rank's query heads over every KV head (``_local_kv``'s map)
        q_first, group = _rank_heads(c, mesh)[0], c.n_heads // c.n_kv_heads
    else:
        q_first, group = 0, nh // kc.shape[-2]
    windowed = c.sliding_window and (window_on is None or bool(window_on))
    attn = paged_decode(
        q[:, 0], kc, vc, tables, pos,
        scale=c.query_scale ** -0.5 if c.query_scale else 1.0 / math.sqrt(hd),
        softcap=c.attn_logit_softcap or 0.0,
        window=c.sliding_window if windowed else 0, q_first=q_first,
        group=group)
    return attn[:, None]


def _layer_step(config: LlamaConfig, x, lp, kc, vc, cos, sin, start_pos,
                valid=None, window_on=None, tables=None, mesh=None):
    """Cache-aware layer: attention step + gated MLP."""
    x, kc, vc = attention_step(config, x, lp, kc, vc, cos, sin, start_pos,
                               valid, window_on, tables=tables, mesh=mesh)
    return _mlp(config, x, lp, mesh), kc, vc


def forward_step(config: LlamaConfig, params: dict, tokens, cache: dict,
                 start_pos, valid=None, layer_body=None, last_pos=None,
                 all_logits: bool = False, mesh=None):
    """Prefill (s = prompt len) or decode (s = 1) step against the KV
    cache. tokens [b, s] + cache + start_pos -> (last-token logits
    [b, vocab] float32, the cache, updated in place). ``valid`` [b,
    max_len] marks live cache slots for ragged prompt batches.
    ``start_pos`` may be a [b] tensor for per-row positions. ``last_pos``
    projects the logits at that chunk index instead of the last one;
    ``all_logits`` returns the whole chunk's logits [b, s, vocab].

    ``layer_body`` is the pluggable per-layer step, with the signature of
    ``_layer_step``; it must write the layer's cache slices in place.
    ``mesh`` is the serving mesh of tensor-parallel serving (see the
    module docstring)."""
    c = config
    s = tokens.shape[1]
    steps = torch.arange(s, device=tokens.device)
    if torch.is_tensor(start_pos) and start_pos.ndim == 1:
        positions = start_pos.to(tokens.device)[:, None] + steps
    else:
        positions = int(start_pos) + steps
    cos, sin = rope_frequencies(c, positions)
    x = _embed(c, params, tokens, mesh)
    body = layer_body or _layer_step
    flags = window_flags(c)
    for i in range(c.n_layers):
        x, _, _ = body(c, x, layer_params(params, i), cache["k"][i],
                       cache["v"][i], cos, sin, start_pos, valid,
                       *(() if flags is None else (flags[i],)), mesh=mesh)

    if all_logits:
        x = rms_norm(x, params["final_norm"], c.rms_eps,
                     c.norm_weight_offset)
        return _logits(c, params, x, mesh), cache
    if last_pos is not None:
        x = x[:, int(last_pos):int(last_pos) + 1]
    else:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], c.rms_eps, c.norm_weight_offset)
    return _logits(c, params, x, mesh)[:, 0], cache


def paged_layer_body(tables, inner_body=None):
    """A per-layer decode body with ``_layer_step``'s signature whose KV
    reads and writes go through a block pool. ``tables`` [b,
    blocks_per_row] int64 maps each row's logical block to a physical
    pool block. Rows sharing blocks (copy-on-write prefixes) never write
    inside a shared block — the host scheduler guarantees it — and
    duplicate sink entries only ever receive causally invisible data.

    ``inner_body`` (default ``_layer_step``) is the per-layer body to
    wrap, another family's (MoE's) included: it takes ``_layer_step``'s
    arguments and the ``tables=`` keyword, which it hands to
    :func:`attention_step`."""
    inner = inner_body or _layer_step

    def body(c, x, lp, kp, vp, cos, sin, start_pos, valid=None, *rest,
             mesh=None):
        return inner(c, x, lp, kp, vp, cos, sin, start_pos, valid, *rest,
                     tables=tables, mesh=mesh)

    return body


def forward_step_paged(config: LlamaConfig, params: dict, tokens,
                       pool: dict, tables, start_pos, valid=None,
                       inner_body=None, last_pos=None,
                       all_logits: bool = False, mesh=None):
    """:func:`forward_step` against a paged KV pool: same contract, but
    the cache operand is an :func:`init_block_pool` arena plus per-row
    block ``tables`` [b, blocks_per_row]. The dense view exists one layer
    at a time, so persistent memory is the pool, sized to live tokens
    rather than ``rows * max_len``. With per-row positions every shape is
    fixed by (b, blocks_per_row), so growing, sharing or freeing blocks
    changes only the tables' values — a captured CUDA graph of the step
    stays valid. ``valid`` masks against the view length. ``inner_body``
    is the per-layer body :func:`paged_layer_body` wraps."""
    return forward_step(config, params, tokens, pool, start_pos, valid,
                        layer_body=paged_layer_body(tables, inner_body),
                        last_pos=last_pos, all_logits=all_logits, mesh=mesh)


# -- training loss -----------------------------------------------------------

def lm_loss(config: LlamaConfig, x, params: dict, targets, mask=None,
            mesh=None):
    """Next-token cross-entropy from final hidden states, mean over
    unmasked targets (float32 scalar). With ``config.loss_chunk > 0`` the
    LM-head product and softmax run in sequence chunks
    (``ops.loss.chunked_token_nll``), so the [b, s, vocab] logits are
    never materialized. Under a sharded ``mesh`` it is this rank's share
    of the global mean (``parallel.collectives.loss_share``); under ``cp``
    a ``mask`` held whole over the sequence is cut to the rank's columns."""
    mask = _rank_mask(mask, targets, mesh)
    head = to_dense(_lm_head(config, params), config.dtype)
    if config.loss_chunk > 0:
        total = chunked_token_nll(x, head, targets, mask=mask,
                                  chunk=config.loss_chunk,
                                  logit_softcap=config.logit_softcap).sum()
    else:
        logits = _softcap(config, (x @ head).float())
        nll = torch.logsumexp(logits, dim=-1) - torch.gather(
            logits, -1, targets[..., None].long())[..., 0]
        total = (nll if mask is None else nll * mask.float()).sum()
    count = (mask.float().sum() if mask is not None else torch.tensor(
        float(targets.numel()), device=x.device))
    return loss_share(total, count, mesh)


def loss_fn(config: LlamaConfig, params: dict, tokens, targets, mask=None,
            mesh=None, segment_ids=None, positions=None):
    """Next-token cross-entropy, mean over unmasked targets.
    ``segment_ids``/``positions`` [b, s] carry packed documents
    (``train.data.pack_documents``): attention stays within segments and
    RoPE positions restart per document."""
    x = forward_hidden(config, params, tokens, positions=positions,
                       segment_ids=segment_ids, mesh=mesh)
    return lm_loss(config, x, params, targets, mask=mask, mesh=mesh)
