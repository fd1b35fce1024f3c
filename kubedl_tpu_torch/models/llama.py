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
autograd records), the chunked path on the CPU. Training adds
:func:`loss_fn`/:func:`lm_loss` (the chunked LM-head loss of
``ops/loss.py``) and per-layer recomputation (``config.remat``).
Context parallelism (ring, ulysses) and tensor parallelism arrive with
the parallel slice; a ``mesh`` argument raises until then.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.attention import multi_head_attention
from ..ops.loss import chunked_softmax_xent
from ..ops.quant import mm as _mm

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
    #: context-parallel scheme, used once the parallel slice lands
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
    """Layer ``i``'s slice of the stacked ``layers`` dict (views)."""
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
    """[d, vocab] projection; Gemma ties it to the embedding table."""
    if config.tie_embeddings:
        return params["embed"].T.to(config.dtype)
    return params["lm_head"].to(config.dtype)


def _softcap(config: LlamaConfig, logits):
    cap = config.logit_softcap
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def _embed(config: LlamaConfig, params: dict, tokens):
    x = params["embed"][tokens].to(config.dtype)
    if config.embed_scale:
        x = x * torch.tensor(math.sqrt(config.d_model), dtype=config.dtype,
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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh-parallel execution (ring/ulysses context parallelism, "
            "tensor parallelism) is not ported yet: ROADMAP queue A, "
            "context and pipeline parallelism")


def attention_block(config: LlamaConfig, x, lp, cos, sin, segment_ids,
                    mesh=None, window_on=None):
    """Pre-norm attention sublayer with residual (the non-context-parallel
    branch of the JAX block). ``window_on`` toggles the sliding window per
    layer (Gemma-2's alternate pattern)."""
    c = config
    _no_mesh(mesh)
    if c.window_pattern == "alternate" and window_on is None:
        raise ValueError(
            "window_pattern='alternate' requires a per-layer window_on "
            "flag (thread window_flags(config) through the layer loop)")
    b, s, _ = x.shape
    nh, nkv, hd = c.n_heads, c.n_kv_heads, c.hd

    h = rms_norm(x, lp["attn_norm"], c.rms_eps, c.norm_weight_offset)
    q = _qkv(c, h, lp, "wq", "bq").reshape(b, s, nh, hd)
    k = _qkv(c, h, lp, "wk", "bk").reshape(b, s, nkv, hd)
    v = _qkv(c, h, lp, "wv", "bv").reshape(b, s, nkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = multi_head_attention(q, k, v, causal=True,
                                segment_ids=segment_ids,
                                window=c.sliding_window,
                                window_on=window_on, **_attn_knobs(c))
    delta = _mm(attn.reshape(b, s, nh * hd), lp["wo"])
    if c.sandwich_norms:
        delta = rms_norm(delta, lp["post_attn_norm"], c.rms_eps,
                         c.norm_weight_offset)
    return x + delta


def _mlp(config: LlamaConfig, x, lp):
    """Gated MLP (SwiGLU for Llama, GeGLU for Gemma) with residual;
    Gemma-2 wraps it in sandwich norms."""
    c = config
    h = rms_norm(x, lp["mlp_norm"], c.rms_eps, c.norm_weight_offset)
    gated = _act(c)(_mm(h, lp["w_gate"]).float()).to(h.dtype)
    y = _mm(gated * _mm(h, lp["w_up"]), lp["w_down"])
    if c.sandwich_norms:
        y = rms_norm(y, lp["post_ffw_norm"], c.rms_eps, c.norm_weight_offset)
    return x + y


def _layer_forward(config: LlamaConfig, x, lp, cos, sin, segment_ids,
                   mesh=None, window_on=None):
    x = attention_block(config, x, lp, cos, sin, segment_ids, mesh,
                        window_on)
    return _mlp(config, x, lp)


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
    _no_mesh(mesh)
    s = tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    cos, sin = rope_frequencies(c, positions)
    x = _embed(c, params, tokens)
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
                    _layer_forward, c, x, lp, cos, sin, segment_ids, None,
                    window_on, use_reentrant=False)
            else:
                x = _layer_forward(c, x, lp, cos, sin, segment_ids,
                                   window_on=window_on)
    return rms_norm(x, params["final_norm"], c.rms_eps, c.norm_weight_offset)


def forward(config: LlamaConfig, params: dict, tokens, positions=None,
            segment_ids=None, mesh=None):
    """tokens [b, s] int -> logits [b, s, vocab] float32."""
    x = forward_hidden(config, params, tokens, positions, segment_ids, mesh)
    logits = _mm(x, _lm_head(config, params)).float()
    return _softcap(config, logits)


# -- KV-cache inference path -------------------------------------------------

def init_cache(config: LlamaConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Stacked KV cache [n_layers, b, max_len, n_kv_heads, hd]."""
    c = config
    shape = (c.n_layers, batch, max_len, c.n_kv_heads, c.hd)
    dev = resolve_device(device)
    dt = dtype or c.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def attention_step(config: LlamaConfig, x, lp, kc, vc, cos, sin, start_pos,
                   valid=None, window_on=None):
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
    ``greedy_rollout`` compute the same numbers."""
    c = config
    b, s, _ = x.shape
    nh, nkv, hd = c.n_heads, c.n_kv_heads, c.hd
    max_len = kc.shape[1]
    dev = x.device
    row_pos = torch.is_tensor(start_pos) and start_pos.ndim == 1

    h = rms_norm(x, lp["attn_norm"], c.rms_eps, c.norm_weight_offset)
    q = apply_rope(_qkv(c, h, lp, "wq", "bq").reshape(b, s, nh, hd),
                   cos, sin)
    k = apply_rope(_qkv(c, h, lp, "wk", "bk").reshape(b, s, nkv, hd),
                   cos, sin)
    v = _qkv(c, h, lp, "wv", "bv").reshape(b, s, nkv, hd)
    steps = torch.arange(s, device=dev)
    if row_pos:
        rows = torch.arange(b, device=dev)[:, None]
        cols = start_pos.to(dev)[:, None] + steps[None, :]
        kc.index_put_((rows, cols), k.to(kc.dtype))
        vc.index_put_((rows, cols), v.to(vc.dtype))
        q_pos = cols                                            # [b, s]
        live = max_len
    else:
        start = int(start_pos)
        idx = start + steps
        kc.index_copy_(1, idx, k.to(kc.dtype))
        vc.index_copy_(1, idx, v.to(vc.dtype))
        q_pos = idx[None, :]                                    # [1, s]
        live = start + s

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
    delta = _mm(attn.reshape(b, s, nh * hd), lp["wo"])
    if c.sandwich_norms:
        delta = rms_norm(delta, lp["post_attn_norm"], c.rms_eps,
                         c.norm_weight_offset)
    return x + delta, kc, vc


def _layer_step(config: LlamaConfig, x, lp, kc, vc, cos, sin, start_pos,
                valid=None, window_on=None):
    """Cache-aware layer: attention step + gated MLP."""
    x, kc, vc = attention_step(config, x, lp, kc, vc, cos, sin, start_pos,
                               valid, window_on)
    return _mlp(config, x, lp), kc, vc


def forward_step(config: LlamaConfig, params: dict, tokens, cache: dict,
                 start_pos, valid=None, layer_body=None, last_pos=None,
                 all_logits: bool = False):
    """Prefill (s = prompt len) or decode (s = 1) step against the KV
    cache. tokens [b, s] + cache + start_pos -> (last-token logits
    [b, vocab] float32, the cache, updated in place). ``valid`` [b,
    max_len] marks live cache slots for ragged prompt batches.
    ``start_pos`` may be a [b] tensor for per-row positions. ``last_pos``
    projects the logits at that chunk index instead of the last one;
    ``all_logits`` returns the whole chunk's logits [b, s, vocab].

    ``layer_body`` is the pluggable per-layer step, with the signature of
    ``_layer_step``; it must write the layer's cache slices in place."""
    c = config
    s = tokens.shape[1]
    steps = torch.arange(s, device=tokens.device)
    if torch.is_tensor(start_pos) and start_pos.ndim == 1:
        positions = start_pos.to(tokens.device)[:, None] + steps
    else:
        positions = int(start_pos) + steps
    cos, sin = rope_frequencies(c, positions)
    x = _embed(c, params, tokens)
    body = layer_body or _layer_step
    flags = window_flags(c)
    for i in range(c.n_layers):
        x, _, _ = body(c, x, layer_params(params, i), cache["k"][i],
                       cache["v"][i], cos, sin, start_pos, valid,
                       *(() if flags is None else (flags[i],)))

    if all_logits:
        x = rms_norm(x, params["final_norm"], c.rms_eps,
                     c.norm_weight_offset)
        logits = _mm(x, _lm_head(c, params)).float()
        return _softcap(c, logits), cache
    if last_pos is not None:
        x = x[:, int(last_pos):int(last_pos) + 1]
    else:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], c.rms_eps, c.norm_weight_offset)
    logits = _mm(x, _lm_head(c, params)).float()
    return _softcap(c, logits)[:, 0], cache


# -- training loss -----------------------------------------------------------

def lm_loss(config: LlamaConfig, x, params: dict, targets, mask=None):
    """Next-token cross-entropy from final hidden states, mean over
    unmasked targets (float32 scalar). With ``config.loss_chunk > 0`` the
    LM-head product and softmax run in sequence chunks
    (``ops.loss.chunked_softmax_xent``), so the [b, s, vocab] logits are
    never materialized."""
    head = _lm_head(config, params)
    if config.loss_chunk > 0:
        return chunked_softmax_xent(x, head, targets, mask=mask,
                                    chunk=config.loss_chunk,
                                    logit_softcap=config.logit_softcap)
    logits = _softcap(config, (x @ head).float())
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def loss_fn(config: LlamaConfig, params: dict, tokens, targets, mask=None,
            mesh=None, segment_ids=None, positions=None):
    """Next-token cross-entropy, mean over unmasked targets.
    ``segment_ids``/``positions`` [b, s] carry packed documents
    (``train.data.pack_documents``): attention stays within segments and
    RoPE positions restart per document."""
    x = forward_hidden(config, params, tokens, positions=positions,
                       segment_ids=segment_ids, mesh=mesh)
    return lm_loss(config, x, params, targets, mask=mask)
