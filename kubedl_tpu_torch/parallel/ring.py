"""Ring attention: context parallelism over the ``cp`` mesh axis. The
counterpart of ``kubedl_tpu/parallel/ring.py``.

With the sequence sharded on ``cp``, each rank holds one sequence shard of
Q, K and V. K/V blocks rotate around the ring (``collectives.ring_shift``,
``dist.batch_isend_irecv`` on the device) while Q stays put, and the
per-block partial attention merges with the online-softmax update, so the
full sequence is never materialized on one rank. Two routes:

* ``flash``: every ring step runs the flash kernels (``ops.attention``:
  K1 forward, K2 dQ and K3 dK/dV) with the block's GLOBAL causal offsets
  ``(my * sq, src * sk)``. The forward merges the normalized partials by
  logsumexp (with the JAX package's ``1e-37`` floor); the backward runs K2
  and K3 per block with the global lse and O, so each block's p are the
  true global probabilities: dQ accumulates locally in float32 and the
  dK/dV accumulators ride the ring home with their blocks. One
  ``torch.autograd.Function`` holds both rings.
* ``dense``: the float32 online-softmax ring in plain PyTorch,
  differentiated by autograd through the ring shifts; it also takes a
  sliding window over global positions.

``impl="auto"`` takes ``flash`` on CUDA tensors whenever there is no
window (the kernels take every head dim: ``sm90`` at 64/128/256, ``simt``
for the rest) and ``dense`` on the CPU, as the JAX package takes its
einsum path off the TPU.

Blocks wholly above the causal diagonal still run, as in the JAX ring:
their rows see no key, and their merge weight is exactly 0 once a row's
own block (step 0) has set its lse.

The rings are written once, over the list of shards one process holds
and a shift (:class:`Ring`): a rank on the group holds its own shard and
shifts with ``ring_shift``; one process can hold every rank's shard and
rotate the list (:func:`ring_schedule`), running the same loops in ring
order. The tests hold that against the JAX ring, and ``chip_smoke.py``
against the unsharded kernels on one card.
"""

from __future__ import annotations

import math

import torch

from ..ops import attention as _attn
from .collectives import ring_shift

_NEG_INF = -1e30


def _ring_flash_eligible(q, k) -> bool:
    """The flash route: CUDA tensors with GQA-divisible heads (the kernels
    take any head dim and mask ragged tails themselves)."""
    return q.is_cuda and q.shape[2] % k.shape[2] == 0


def _resolve(impl: str, q, k, window: int) -> str:
    if impl == "auto":
        return "flash" if window == 0 and _ring_flash_eligible(q, k) \
            else "dense"
    if impl not in ("flash", "dense"):
        raise ValueError(f"unknown ring impl {impl!r}")
    if impl == "flash" and window:
        raise ValueError("ring flash does not support sliding windows; use "
                         "impl='dense'")
    return impl


# ---------------------------------------------------------------------------
# per-block steps
# ---------------------------------------------------------------------------

def flash_state(q):
    """The running (o float32 [b, sq, nh, hd], lse [b*nh, sq]) before the
    first block: zeros and -1e30, as the JAX scan's carry."""
    b, sq, h, _ = q.shape
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full((b * h, sq), _NEG_INF, dtype=torch.float32,
                       device=q.device))


def flash_block_forward(q, k_blk, v_blk, causal: bool, offsets, state):
    """One forward ring step: K1 on q against one K/V block at global
    ``offsets`` (q_off, k_off), its normalized output merged into the
    running ``state`` by logsumexp. Returns the new state."""
    o_run, lse_run = state
    b, sq, h, _ = q.shape
    o_i, lse_i = _attn.flash_forward(q, k_blk, v_blk, causal,
                                     offsets=offsets)
    m = torch.maximum(lse_run, lse_i)
    a = torch.exp(lse_run - m)
    bw = torch.exp(lse_i - m)
    denom = torch.clamp_min(a + bw, 1e-37)
    w_run = (a / denom).reshape(b, h, sq).transpose(1, 2)[..., None]
    w_i = (bw / denom).reshape(b, h, sq).transpose(1, 2)[..., None]
    return o_run * w_run + o_i.float() * w_i, m + torch.log(denom)


def flash_block_backward(q, k_blk, v_blk, do, lse, delta, causal: bool,
                         offsets):
    """One backward ring step: K2 and K3 on one K/V block at global
    ``offsets`` with the GLOBAL lse and Δ (= rowsum(dO ∘ O) of the merged
    output, the same for every block, so computed once). Returns (dq, dk,
    dv) of this block's share."""
    dq = _attn.flash_dq(q, k_blk, v_blk, do, lse, delta, causal,
                        offsets=offsets)
    dk, dv = _attn.flash_dkv(q, k_blk, v_blk, do, lse, delta, causal,
                             offsets=offsets)
    return dq, dk, dv


def dense_state(q):
    """The dense ring's running (o, m, l) before the first block."""
    b, sq, h, _ = q.shape
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device), m,
            torch.zeros_like(m))


def dense_block(q, k_blk, v_blk, causal: bool, offsets, window: int, state):
    """One step of the dense ring: float32 scores of q against one K/V
    block, masked by GLOBAL positions (causal, and keys in ``(q_pos -
    window, q_pos]`` with a window), merged into ``state`` (o, m, l) by
    the online-softmax update. Differentiable by autograd."""
    o, m_run, l_run = state
    b, sq, h, hd = q.shape
    sk = k_blk.shape[1]
    qf = q.float() * (1.0 / math.sqrt(hd))
    kf = _attn.repeat_kv(k_blk, h).float()
    vf = _attn.repeat_kv(v_blk, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    mask = None
    if causal:
        q_pos = offsets[0] + torch.arange(sq, device=q.device)
        k_pos = offsets[1] + torch.arange(sk, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        if window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, _NEG_INF)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    # exp(s - m) is 1, not 0, for a row whose keys are all masked so far
    # (m == -1e30): zero masked scores explicitly
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    alpha = torch.exp(m_run - m_new)
    l_new = l_run * alpha + p.sum(dim=-1)
    o = (o * alpha.transpose(1, 2)[..., None]
         + torch.einsum("bhqk,bkhd->bqhd", p, vf))
    return o, m_new, l_new


def dense_output(q, state):
    o, _, l = state
    l = torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return (o / l).to(q.dtype)


# ---------------------------------------------------------------------------
# the ring, over the shards one process holds
# ---------------------------------------------------------------------------

class Ring:
    """Where a ring runs: ``ranks``, the ring positions whose shards this
    process holds, in the order of its lists; ``cp``, the ring's size;
    and ``shift(xs)``, which hands every held shard on to the next
    position and returns what the previous one held. On a group a
    process holds its own position and shifts with ``ring_shift``
    (:func:`group_ring`); one process can hold all of them and rotate its
    list (:func:`local_ring`). Every loop below runs the same steps
    either way."""

    def __init__(self, cp: int, ranks: list, shift):
        self.cp, self.ranks, self.shift = cp, ranks, shift


def group_ring(mesh, axis: str = "cp") -> Ring:
    """This rank's place on ``mesh``'s ``axis`` ring."""
    return Ring(mesh.size(axis), [mesh.index(axis)],
                lambda xs: [ring_shift(xs[0], mesh, axis)])


def local_ring(cp: int) -> Ring:
    """All ``cp`` positions in one process: position ``r`` receives what
    ``r - 1`` held."""
    return Ring(cp, list(range(cp)), lambda xs: xs[-1:] + xs[:-1])


def _shift_pairs(ring: Ring, xs: list, ys: list) -> tuple:
    """Each held (x, y) pair, of one shape and dtype, handed on as one
    tensor."""
    moved = ring.shift([torch.stack([x, y]) for x, y in zip(xs, ys)])
    return [m[0] for m in moved], [m[1] for m in moved]


def _offsets(ring: Ring, my: int, i: int, sq: int, sk: int) -> tuple:
    """Position ``my``'s step ``i`` meets the block of ``my - i``."""
    return my * sq, (my - i) % ring.cp * sk


def flash_ring_forward(ring: Ring, qs, ks, vs, causal: bool) -> tuple:
    """The forward ring: (outputs in q's dtype, global lse) of every held
    position."""
    sq, sk = qs[0].shape[1], ks[0].shape[1]
    states = [flash_state(q) for q in qs]
    for i in range(ring.cp):
        states = [flash_block_forward(q, k, v, causal,
                                      _offsets(ring, my, i, sq, sk), st)
                  for my, q, k, v, st in zip(ring.ranks, qs, ks, vs,
                                             states)]
        if i + 1 < ring.cp:
            ks, vs = _shift_pairs(ring, ks, vs)
    return ([o.to(q.dtype) for (o, _), q in zip(states, qs)],
            [lse for _, lse in states])


def flash_ring_backward(ring: Ring, qs, ks, vs, outs, lses, dos,
                        causal: bool) -> tuple:
    """The backward ring: (dq, dk, dv) of every held position. Step ``i``
    adds to the dK/dV accumulator of the block it meets; the accumulators
    ride the ring with their blocks, and the last shift brings them
    home."""
    sq, sk = qs[0].shape[1], ks[0].shape[1]
    deltas = [_attn.flash_delta(o, do) for o, do in zip(outs, dos)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
          for k in ks]
    dv = [torch.zeros_like(x) for x in dk]
    for i in range(ring.cp):
        for j, my in enumerate(ring.ranks):
            dq_i, dk_i, dv_i = flash_block_backward(
                qs[j], ks[j], vs[j], dos[j], lses[j], deltas[j], causal,
                _offsets(ring, my, i, sq, sk))
            dq[j] += dq_i.float()
            dk[j] += dk_i.float()
            dv[j] += dv_i.float()
        dk, dv = _shift_pairs(ring, dk, dv)
        if i + 1 < ring.cp:
            ks, vs = _shift_pairs(ring, ks, vs)
    return ([g.to(q.dtype) for g, q in zip(dq, qs)],
            [g.to(k.dtype) for g, k in zip(dk, ks)],
            [g.to(v.dtype) for g, v in zip(dv, vs)])


class _RingFlash(torch.autograd.Function):
    """The JAX ``_ring_flash`` custom_vjp: the forward ring saves q, k, v,
    the merged O and the global lse of every held position; the backward
    ring differentiates."""

    @staticmethod
    def forward(ctx, ring, causal, *shards):
        n = len(ring.ranks)
        qs, ks, vs = shards[:n], shards[n:2 * n], shards[2 * n:]
        outs, lses = flash_ring_forward(ring, qs, ks, vs, causal)
        ctx.save_for_backward(*shards, *outs, *lses)
        ctx.ring, ctx.causal = ring, causal
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        _attn.chunked_backward_opted_in("the flash ring runs K2 and K3 per "
                                        "block at global offsets")
        n = len(ctx.ring.ranks)
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        dq, dk, dv = flash_ring_backward(
            ctx.ring, qs, ks, vs, outs, lses, [g.contiguous() for g in dos],
            ctx.causal)
        return (None, None, *dq, *dk, *dv)


def _dense_ring(ring: Ring, qs, ks, vs, causal, window) -> list:
    sq, sk = qs[0].shape[1], ks[0].shape[1]
    states = [dense_state(q) for q in qs]
    for i in range(ring.cp):
        states = [dense_block(q, k, v, causal,
                              _offsets(ring, my, i, sq, sk), window, st)
                  for my, q, k, v, st in zip(ring.ranks, qs, ks, vs,
                                             states)]
        if i + 1 < ring.cp:
            ks, vs = _shift_pairs(ring, ks, vs)
    return [dense_output(q, st) for q, st in zip(qs, states)]


def _ring_run(ring: Ring, qs, ks, vs, causal, impl, window) -> list:
    _attn._check_window(window, causal)
    impl = _resolve(impl, qs[0], ks[0], window)
    if impl == "dense":
        return _dense_ring(ring, qs, ks, vs, causal, window)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (*qs, *ks, *vs)):
        return list(_RingFlash.apply(ring, causal, *qs, *ks, *vs))
    return flash_ring_forward(ring, qs, ks, vs, causal)[0]


def ring_attention_p(q, k, v, mesh, axis_name: str = "cp",
                     causal: bool = True, impl: str = "auto",
                     window: int = 0):
    """Per-shard ring attention over ``mesh``'s ``axis_name`` group. q
    [b, sq, h, hd]; k/v [b, sk, nkv, hd]: this rank's sequence shards
    (its heads under ``tp``). Returns [b, sq, h, hd] in q's dtype.
    ``impl``: ``flash``, ``dense`` or ``auto`` (module docstring);
    ``window > 0`` is a sliding window over global positions, dense only."""
    return _ring_run(group_ring(mesh, axis_name), [q], [k], [v], causal,
                     impl, window)[0]


def ring_attention(mesh, q, k, v, causal: bool = True, axis_name: str = "cp",
                   impl: str = "auto", window: int = 0):
    """The entry point the model calls, with the JAX signature. Every rank
    calls it on its own shards (the JAX entry's ``shard_map`` layout:
    batch on ``(dp, fsdp)``, sequence on ``cp``, heads on ``tp``), so it
    is :func:`ring_attention_p`; under ``tp`` the caller has already cut
    each rank's query heads and the KV heads they read
    (``models.llama.attention_block``)."""
    return ring_attention_p(q, k, v, mesh, axis_name=axis_name,
                            causal=causal, impl=impl, window=window)


def ring_schedule(qs, ks, vs, causal: bool = True, impl: str = "flash",
                  window: int = 0) -> list:
    """Every ``cp`` rank's ring run in one process (:func:`local_ring`):
    ``qs``/``ks``/``vs`` are the ranks' shards in rank order, and the
    result is each rank's output, through the loops the ranks run.
    Differentiable: the flash route through one autograd Function holding
    both rings, the dense route by autograd."""
    return _ring_run(local_ring(len(qs)), list(qs), list(ks), list(vs),
                     causal, impl, window)


__all__ = ["Ring", "group_ring", "local_ring", "ring_attention",
           "ring_attention_p", "ring_schedule", "flash_ring_forward",
           "flash_ring_backward", "flash_block_forward",
           "flash_block_backward", "dense_block"]
