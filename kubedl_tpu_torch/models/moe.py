"""Mixture-of-Experts decoder in PyTorch: the counterpart of
``kubedl_tpu/models/moe.py``.

Mixtral-style sparse MoE on the llama core (:mod:`.llama`): every layer
keeps the dense attention sublayer and replaces the gated MLP with a
top-k router over ``n_experts`` expert MLPs, dispatched GShard/Switch
style:

* expert weights are stacked ``[E, d, f]`` (``[L, E, d, f]`` in the
  parameter dict) in the config dtype; the router ``w_router [d, E]``
  stays float32, as do the router's softmax and top-k;
* tokens reach the experts through a capacity-bounded one-hot dispatch
  and four einsums, with the JAX package's capacity rule
  (``ceil(capacity_factor * s * top_k / E)`` slots per expert and batch
  row), choice-major slot order and drops, so both packages route the
  same tokens to the same slots;
* ``loss_fn`` adds the Switch load-balancing loss, weighted by
  ``aux_loss_weight``.

The expert einsums are plain matrix products in both packages (no
Pallas kernel); attention goes through the llama core and so through the
flash kernels on the card. Under a sharded ``mesh`` the layers follow
the llama core's rules (``fsdp`` gathers per layer; under ``tp`` each
rank runs its own ``d_ff`` columns of every expert and the expert
outputs are summed over ``tp`` before the combine), and the aux loss is
this rank's share of the global batch's (its statistics summed over the
data axes). Tensor-parallel serving runs the decode steps the same way
on each rank's shard of every expert (``mesh=`` of :func:`forward_step`),
the float32 router replicated, so every rank routes alike.

Under ``ep`` each rank holds ``E / ep`` experts of every stack (their
storage and gradients stay on the rank) and the same tokens as the other
``ep`` ranks, as JAX's batch is not sharded on ``ep``: every rank routes
alike, runs the expert products on its own experts' slice of the
dispatch and combine, and ``ep_sum`` adds the partial outputs. Under
``cp`` routing stays global: the router probabilities are all-gathered
over ``cp``, so capacities and queue positions count the whole sequence
as JAX's do, and each rank keeps its own rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from . import llama
from .llama import LlamaConfig, _check_mesh, rms_norm
from ..ops.quant import to_dense
from ..parallel.collectives import (all_gather, data_sum, ep_sum,
                                    is_sharded, loss_share, tp_sum)
from ..parallel.sharding import spec


@dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    #: expert slot budget = ceil(capacity_factor * tokens * top_k / E)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    @property
    def num_params(self) -> int:
        d, hd = self.d_model, self.hd
        attn = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * hd * d)
        moe = 3 * self.n_experts * d * self.d_ff + d * self.n_experts
        per_layer = attn + moe + 2 * d
        head = (1 if self.tie_embeddings else 2) * self.vocab_size * d
        return self.n_layers * per_layer + head + d

    @property
    def active_params(self) -> int:
        """Params touched per token (top-k of E experts): the number that
        sets per-token FLOPs for MFU accounting."""
        d = self.d_model
        dense = LlamaConfig.num_params.fget(self)
        dense_mlp = self.n_layers * 3 * d * self.d_ff
        return (dense - dense_mlp
                + self.n_layers * (3 * self.top_k * d * self.d_ff
                                   + d * self.n_experts))


#: the family's config class (``models.io`` finds a config's family by it)
CONFIG = MoEConfig
#: ``/v1/embeddings`` pads a batch to a multiple of this length (capped at
#: ``max_seq_len``), as the JAX server does: expert capacity is counted on
#: the padded length and the forward gets no token mask, so pads compete
#: for expert slots and the vectors depend on the padding
EMBED_BUCKET = 128


def mixtral_8x7b() -> MoEConfig:
    return MoEConfig(vocab_size=32000, d_model=4096, n_layers=32,
                     n_heads=32, n_kv_heads=8, d_ff=14336,
                     rope_theta=1e6, n_experts=8, top_k=2)


def tiny(vocab: int = 512, seq: int = 256) -> MoEConfig:
    """CI config."""
    return MoEConfig(vocab_size=vocab, d_model=128, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=256, max_seq_len=seq,
                     rope_theta=10000.0, n_experts=4, top_k=2)


# -- params ------------------------------------------------------------------

def param_shapes(config: MoEConfig) -> dict:
    """``{key: (shape, float32?)}`` of the parameter dict, as
    ``llama.param_shapes``; ``layers/*`` shapes are per layer."""
    c = config
    d, hd, nh, nkv, E = c.d_model, c.hd, c.n_heads, c.n_kv_heads, c.n_experts
    layer = {
        "attn_norm": ((d,), True),
        "wq": ((d, nh * hd), False),
        "wk": ((d, nkv * hd), False),
        "wv": ((d, nkv * hd), False),
        "wo": ((nh * hd, d), False),
        "mlp_norm": ((d,), True),
        "w_router": ((d, E), True),
        "w_gate": ((E, d, c.d_ff), False),
        "w_up": ((E, d, c.d_ff), False),
        "w_down": ((E, c.d_ff, d), False),
    }
    top = {"embed": ((c.vocab_size, d), False), "final_norm": ((d,), True)}
    if not c.tie_embeddings:
        top["lm_head"] = ((d, c.vocab_size), False)
    return {"layers": layer, **top}


def param_specs(config: MoEConfig) -> dict:
    """The JAX package's logical specs (stacked layers, as
    ``llama.param_specs`` says)."""
    def ls(*axes) -> tuple:
        return spec("layers", *axes)

    layer = {
        "attn_norm": ls("norm"),
        "wq": ls("embed", "heads"),
        "wk": ls("embed", "kv_heads"),
        "wv": ls("embed", "kv_heads"),
        "wo": ls("heads", "embed"),
        "mlp_norm": ls("norm"),
        "w_router": ls("embed", None),
        "w_gate": ls("experts", "embed", "mlp"),
        "w_up": ls("experts", "embed", "mlp"),
        "w_down": ls("experts", "mlp", "embed"),
    }
    specs = {
        "embed": spec("vocab", "embed"),
        "layers": layer,
        "final_norm": spec("norm"),
    }
    if not config.tie_embeddings:
        specs["lm_head"] = spec("embed", "vocab")
    return specs


def _fill(config: MoEConfig, out, name: str, generator) -> None:
    """One leaf drawn as the JAX package draws it: weights normal /
    sqrt(fan_in) (the contraction dim; ``d`` for the embedding table),
    the float32 router likewise, norms at identity."""
    shape = tuple(out.shape)
    if name in ("attn_norm", "mlp_norm", "final_norm"):
        out.fill_(1.0 - config.norm_weight_offset)
        return
    fan_in = shape[1] if name == "embed" else shape[-2]
    draw = torch.randn(shape, generator=generator, device=generator.device)
    out.copy_(draw * (1.0 / math.sqrt(fan_in)))


def init_layer(config: MoEConfig, generator: torch.Generator,
               device=None) -> dict:
    """One layer's random parameters (unstacked), on ``device``."""
    dev = resolve_device(device)
    out = {}
    for name, (shape, f32) in param_shapes(config)["layers"].items():
        out[name] = torch.empty(shape, device=dev,
                                dtype=torch.float32 if f32 else config.dtype)
        _fill(config, out[name], name, generator)
    return out


def init_params(config: MoEConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters with the JAX package's keys, shapes and scaling,
    in the style of ``llama.init_params``: drawn from ``generator`` one
    leaf of one layer at a time, landing on ``device``."""
    c = config
    dev = resolve_device(device)
    shapes = param_shapes(c)
    layers = {name: torch.empty((c.n_layers,) + shape, device=dev,
                                dtype=torch.float32 if f32 else c.dtype)
              for name, (shape, f32) in shapes["layers"].items()}
    for i in range(c.n_layers):
        for name, leaf in layers.items():
            _fill(c, leaf[i], name, generator)
    params = {"layers": layers}
    for name, spec in shapes.items():
        if name != "layers":
            shape, f32 = spec
            params[name] = torch.empty(
                shape, device=dev, dtype=torch.float32 if f32 else c.dtype)
            _fill(c, params[name], name, generator)
    return params


# -- routing -----------------------------------------------------------------

def _top_k(probs, k: int) -> tuple:
    """(values, indices) of the ``k`` largest along the last axis, the
    lower index first on a tie, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no tie order). ``k`` argmaxes, each taking
    the first maximal index."""
    rest = probs.detach()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(rest, dim=-1, keepdim=True)
        vals.append(probs.gather(-1, i))
        idxs.append(i)
        # probabilities are >= 0: -1 ranks a taken expert below every other
        rest = rest.scatter(-1, i, -1.0)
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def route(config: MoEConfig, probs, capacity: int, token_mask=None,
          mesh=None):
    """Top-k routing with per-expert capacity.

    probs: [b, s, E] float32 router softmax. Returns (dispatch, combine,
    aux): dispatch/combine are [b, s, E, C] — dispatch the 0/1
    token→(expert, slot) assignment, combine the normalized top-k gate on
    the same slots. Slots fill in choice-major order (every first choice
    outranks any second choice); tokens past an expert's capacity drop
    (their residual passes through). ``token_mask`` [b, s] keeps padding
    out of the queues and out of the aux statistics. aux is the Switch
    load-balancing loss (E * Σ_e frac_e · prob_e); under a sharded
    ``mesh``, this rank's share of the global batch's: the top-1 counts
    and the token count summed over the token axes (data and ``cp``), its
    own probabilities over the global count, over the sizes of ``tp`` and
    ``ep``. Under ``cp`` the queues run over the whole sequence (the
    probabilities all-gathered, no gradient through the choice) and the
    rank keeps its rows; ``capacity`` is then the whole sequence's.

    Every op is a device op with shapes fixed by (b, s, E, C), so the
    decode tick's CUDA graph captures it."""
    c = config
    b, s, E = probs.shape
    k = c.top_k
    dev = probs.device
    cp = mesh.size("cp") if is_sharded(mesh) else 1
    if cp > 1:
        # route the whole sequence: every rank ranks the same queues
        full = all_gather(probs.detach(), mesh, 1)
        full_mask = (None if token_mask is None
                     else all_gather(token_mask, mesh, 1))
        _, idx_full = _top_k(full, k)
        oh_full, pos_full = _queues(idx_full, E, full_mask)
        rows = slice(mesh.index("cp") * s, (mesh.index("cp") + 1) * s)
        idx, oh, pos = idx_full[:, rows], oh_full[:, rows], pos_full[:, rows]
        gate = probs.gather(-1, idx)
    else:
        gate, idx = _top_k(probs, k)                          # [b, s, k]
        oh, pos = _queues(idx, E, token_mask)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    keep = (pos < capacity).float() * oh
    # a position past the capacity matches no slot: the token drops (the
    # JAX one_hot's zero row; torch's one_hot would raise on it)
    slot = (pos.long()[..., None]
            == torch.arange(capacity, device=dev)).float()   # [b,s,k,E,C]
    slot = slot * keep[..., None]
    dispatch = slot.sum(2)                                   # [b, s, E, C]
    combine = (gate[..., None, None] * slot).sum(2)

    # Switch aux loss from the top-1 assignment (masked tokens excluded)
    top1 = oh[:, :, 0, :]                                    # [b, s, E]
    m = (torch.ones((b, s, 1), device=dev) if token_mask is None
         else token_mask.float()[..., None])
    # the routed fraction is global; this rank's probabilities are its
    # share of the global mean
    frac = (data_sum((top1 * m).sum(dim=(0, 1)), mesh)
            / torch.clamp_min(data_sum(m.sum(), mesh), 1.0))
    aux = loss_share(E * torch.sum(frac * (probs * m).sum(dim=(0, 1))),
                     m.sum(), mesh)
    return dispatch, combine, aux


def _queues(idx, E: int, token_mask=None):
    """(one-hot choices [b, s, k, E], each choice's position in its
    expert's queue), choice-major: every first choice outranks any second
    choice."""
    b, s, k = idx.shape
    oh = (idx[..., None] == torch.arange(E, device=idx.device)).float()
    if token_mask is not None:
        oh = oh * token_mask.float()[:, :, None, None]      # [b, s, k, E]
    ohk = oh.transpose(1, 2).reshape(b, k * s, E)            # [b, k*s, E]
    pos = torch.cumsum(ohk, dim=1) - ohk
    return oh, pos.reshape(b, k, s, E).transpose(1, 2)       # [b, s, k, E]


def capacity_of(config: MoEConfig, s: int) -> int:
    """Expert slots per batch row for a chunk of ``s`` tokens."""
    return max(1, int(math.ceil(
        config.capacity_factor * s * config.top_k / config.n_experts)))


def _moe_block(config: MoEConfig, x, lp, mesh=None, token_mask=None):
    """Sparse-MLP sublayer with residual. Returns (x, aux_loss). Under
    ``tp`` the rank runs its own ``d_ff`` columns of every expert; the
    expert outputs are summed over ``tp`` before the combine. Under
    ``ep`` it runs its own experts and the combined outputs are summed
    over ``ep``; under ``cp`` it routes the whole sequence (``route``)."""
    c = config
    _check_mesh(mesh)
    lp = llama._views(lp, ("mlp_norm", "w_router", "w_gate", "w_up",
                           "w_down"))
    sharded = is_sharded(mesh)
    s = x.shape[1] * (mesh.size("cp") if sharded else 1)
    h = rms_norm(x, lp["mlp_norm"], c.rms_eps, c.norm_weight_offset)

    logits = h.float() @ lp["w_router"]                      # [b, s, E]
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = route(c, probs, capacity_of(c, s), token_mask,
                                   mesh=mesh)
    ep = mesh.size("ep") if sharded else 1
    if ep > 1:
        # this rank's experts' slots; its stacks hold those experts
        n = c.n_experts // ep
        mine = slice(mesh.index("ep") * n, (mesh.index("ep") + 1) * n)
        dispatch, combine = dispatch[:, :, mine], combine[:, :, mine]

    # [b, s, E, C] x [b, s, d] -> [E, b, C, d]
    xe = torch.einsum("bsec,bsd->ebcd", dispatch.to(c.dtype), h)
    # int8/int4 serving: expert stacks may arrive quantized; densified
    # per use, as in the JAX block
    w_gate = to_dense(lp["w_gate"], xe.dtype)
    w_up = to_dense(lp["w_up"], xe.dtype)
    w_down = to_dense(lp["w_down"], xe.dtype)
    gated = llama._act(c)(
        torch.einsum("ebcd,edf->ebcf", xe, w_gate).float()).to(xe.dtype)
    up = torch.einsum("ebcd,edf->ebcf", xe, w_up)
    ye = tp_sum(torch.einsum("ebcf,efd->ebcd", gated * up, w_down), mesh)
    out = ep_sum(torch.einsum("bsec,ebcd->bsd", combine.to(c.dtype), ye),
                 mesh)
    return x + out, aux


def _layer_forward(config: MoEConfig, x, lp, cos, sin, segment_ids,
                   mesh=None, window_on=None):
    x = llama.attention_block(config, x, lp, cos, sin, segment_ids, mesh,
                              window_on)
    return _moe_block(config, x, lp, mesh=mesh)


# -- model -------------------------------------------------------------------

def forward_hidden(config: MoEConfig, params: dict, tokens,
                   positions=None, segment_ids=None, mesh=None):
    """tokens [b, s] int -> (hidden [b, s, d], aux_loss scalar). The layer
    loop is ``llama.forward_hidden``'s: under autograd the stacked layers
    are unbound once, and with ``config.remat`` each layer runs under
    ``torch.utils.checkpoint``."""
    c = config
    _check_mesh(mesh)
    aux = []

    def layers(x, cos, sin):
        flags = llama.window_flags(c)
        training = torch.is_grad_enabled()
        if training:
            stacked = {k: v.unbind(0) for k, v in params["layers"].items()}
        for i in range(c.n_layers):
            lp = ({k: v[i] for k, v in stacked.items()} if training
                  else llama.layer_params(params, i))
            window_on = None if flags is None else flags[i]
            if training and c.remat:
                x, a = checkpoint(_layer_forward, c, x, lp, cos, sin,
                                  segment_ids, mesh, window_on,
                                  use_reentrant=False)
            else:
                x, a = _layer_forward(c, x, lp, cos, sin, segment_ids,
                                      mesh=mesh, window_on=window_on)
            aux.append(a)
        return x

    x = llama.forward_hidden(c, params, tokens, positions, segment_ids,
                             mesh=mesh, apply_layers=layers)
    return x, torch.stack(aux).sum()


def forward(config: MoEConfig, params: dict, tokens, positions=None,
            segment_ids=None, mesh=None):
    """tokens [b, s] -> logits [b, s, vocab] float32 (aux loss dropped —
    ``loss_fn`` keeps it for training)."""
    x, _ = forward_hidden(config, params, tokens, positions, segment_ids,
                          mesh)
    return llama._logits(config, params, x, mesh)


# -- KV-cache inference path -------------------------------------------------

init_cache = llama.init_cache  # the cache layout is attention-only
init_block_pool = llama.init_block_pool  # the paged pool's likewise


def _decode_layer_body(c, x, lp, kc, vc, cos, sin, start_pos, valid=None,
                       window_on=None, tables=None, mesh=None):
    """Per-layer decode body plugged into llama's decode driver (the
    signature of ``llama._layer_step``): the cache-aware attention, then
    the sparse-MLP block. The chunk's token mask is cut from ``valid`` so
    padding never takes expert capacity ahead of real tokens."""
    x, kc, vc = llama.attention_step(c, x, lp, kc, vc, cos, sin, start_pos,
                                     valid, window_on, tables=tables,
                                     mesh=mesh)
    token_mask = None
    if valid is not None:
        s = x.shape[1]
        if torch.is_tensor(start_pos) and start_pos.ndim == 1:
            cols = (start_pos.to(valid.device)[:, None]
                    + torch.arange(s, device=valid.device))
            token_mask = torch.gather(valid, 1, cols)
        else:
            # the JAX dynamic_slice clamps the start so the slice fits
            start = min(max(int(start_pos), 0), valid.shape[1] - s)
            token_mask = valid[:, start:start + s]
    x, _ = _moe_block(c, x, lp, mesh=mesh, token_mask=token_mask)
    return x, kc, vc


def forward_step(config: MoEConfig, params: dict, tokens, cache: dict,
                 start_pos, valid=None, last_pos=None,
                 all_logits: bool = False, mesh=None):
    """Prefill/decode step against the KV cache: llama's one decode
    driver with the MoE layer body plugged in, so the engines drive
    either family through the same contract. At decode (s=1) capacity is
    one slot per expert, and a token's top-k experts are distinct, so
    nothing drops."""
    return llama.forward_step(config, params, tokens, cache, start_pos,
                              valid, layer_body=_decode_layer_body,
                              last_pos=last_pos, all_logits=all_logits,
                              mesh=mesh)


def forward_step_paged(config: MoEConfig, params: dict, tokens,
                       pool: dict, tables, start_pos, valid=None,
                       last_pos=None, all_logits: bool = False, mesh=None):
    """Paged-pool step: llama's paged driver with the sparse layer body
    plugged in (same seam as :func:`forward_step`)."""
    return llama.forward_step_paged(
        config, params, tokens, pool, tables, start_pos, valid,
        inner_body=_decode_layer_body, last_pos=last_pos,
        all_logits=all_logits, mesh=mesh)


# -- training loss -----------------------------------------------------------

def loss_fn(config: MoEConfig, params: dict, tokens, targets, mask=None,
            mesh=None, segment_ids=None, positions=None):
    """Next-token cross-entropy (``llama.lm_loss``) plus the weighted
    load-balancing aux."""
    x, aux = forward_hidden(config, params, tokens, positions=positions,
                            segment_ids=segment_ids, mesh=mesh)
    return (llama.lm_loss(config, x, params, targets, mask=mask, mesh=mesh)
            + config.aux_loss_weight * aux)
