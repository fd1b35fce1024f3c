"""Attention: the hand-written Hopper flash kernels + the plain PyTorch paths.

Counterpart of ``kubedl_tpu/ops/attention.py``, same layouts (q
``[b, s, nh, hd]``, k/v ``[b, s, nkv, hd]``, GQA by blocked grouping):

* ``kernel`` — :func:`flash_attention`, a ``torch.autograd.Function``
  whose forward is :func:`flash_forward` (the TPU ``_flash_kernel``) and
  whose backward is :func:`flash_backward`: the dQ kernel (the TPU
  ``_flash_dq_kernel``) and the dK/dV kernel (the TPU
  ``_flash_dkv_kernel``). Each runs on one of two routes, picked per
  kernel (:func:`flash_fwd_route`, :func:`flash_dq_route`,
  :func:`flash_dkv_route`): ``sm90``, the tensor-core sources
  ``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_bwd_sm90.cu``, for bf16/f16
  at head dims 64, 128 and 256; ``simt``, ``csrc/flash_fwd.cu`` and
  ``csrc/flash_bwd.cu``, for the rest. CUDA tensors only.
* ``plain`` — the same Function on CPU tensors, where every wrapper runs
  its kernel's plain version: the CI path for the kernels' arithmetic
  (the counterpart of ``impl="pallas_interpret"``).
* ``chunked`` — the same online-softmax algorithm as a loop over K/V
  blocks in plain PyTorch, differentiated by autograd; runs anywhere.
* ``reference`` — naive full-matrix attention for numerics tests.

:func:`flash_forward_plain`, :func:`flash_dq_plain` and
:func:`flash_dkv_plain` repeat the kernels' block arithmetic in PyTorch;
the wrappers take them for CPU tensors, and ``chip_smoke.py`` holds each
kernel against its plain version on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional

import torch

_NEG_INF = -1e30

#: k columns per tile in the kernel; the plain version walks the same tiles
_BLOCK_K = 64


def repeat_kv(k, q_heads: int):
    """[b, s, nkv, hd] -> [b, s, q_heads, hd] by repeating each kv head
    (blocked GQA grouping); the one shared GQA-expansion helper."""
    nkv = k.shape[2]
    if nkv == q_heads:
        return k
    return torch.repeat_interleave(k, q_heads // nkv, dim=2)


def _check_window(window: int, causal: bool) -> None:
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window > 0 and not causal:
        raise ValueError(
            "sliding window requires causal attention (a non-causal "
            "local window is not implemented; this would otherwise "
            "silently return dense attention)")


def _window_active(window: int, window_on) -> bool:
    """``window_on`` (a per-layer bool; Gemma-2 alternates local/global
    layers) gates the window term; None means always on."""
    return window > 0 and (window_on is None or bool(window_on))


def _build_mask(sq, sk, causal, segment_ids, window: int = 0,
                window_on=None, device=None):
    """[b or 1, 1, sq, sk] boolean keep-mask, or None."""
    if segment_ids is not None:
        device = segment_ids.device
    mask = None
    if causal:
        rows = torch.arange(sq, device=device)[:, None]
        cols = torch.arange(sk, device=device)[None, :]
        keep = cols <= rows
        if _window_active(window, window_on):
            keep = keep & (cols > rows - window)
        mask = keep[None, None]
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else mask & seg
    return mask


def reference_attention(q, k, v, causal=True, segment_ids=None,
                        window: int = 0, scale=None,
                        logit_softcap: float = 0.0, window_on=None):
    """Naive [b, s, h, hd] attention; float32 softmax. ``scale``
    overrides the 1/sqrt(hd) score scale (Gemma-2's
    query_pre_attn_scalar); ``logit_softcap`` applies
    cap*tanh(scores/cap) before masking."""
    _check_window(window, causal)
    nh, hd = q.shape[2], q.shape[3]
    k = repeat_kv(k, nh)
    v = repeat_kv(v, nh)
    scale = (1.0 / math.sqrt(hd)) if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    mask = _build_mask(q.shape[1], k.shape[1], causal, segment_ids, window,
                       window_on, device=q.device)
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def chunked_attention(q, k, v, causal=True, segment_ids=None,
                      block_k: int = 512, window: int = 0, scale=None,
                      logit_softcap: float = 0.0, window_on=None,
                      offsets=None, kv_segment_ids=None):
    """Online-softmax attention over K/V blocks of ``block_k``: O(sq *
    block_k) score memory. ``scale``/``logit_softcap``/``window_on`` as in
    :func:`reference_attention` (softcap is monotonic, so the online max
    merge is unaffected). ``offsets`` (q_off, k_off) place the query rows
    and the keys at global positions, and ``kv_segment_ids`` [b, sk] are
    the keys' segments where they differ from the rows' ``segment_ids``
    [b, sq], as in :func:`flash_forward_plain` (one ``cp`` rank's rows
    against the whole sequence's keys)."""
    _check_window(window, causal)
    b, sq, nh, hd = q.shape
    sk = k.shape[1]
    k = repeat_kv(k, nh)
    v = repeat_kv(v, nh)
    block_k = min(block_k, sk)
    scale = (1.0 / math.sqrt(hd)) if scale is None else scale
    qh = q.transpose(1, 2).float() * scale                  # [b, h, sq, hd]
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    q_off, k_off = _offsets(offsets)
    rows = torch.arange(q_off, q_off + sq, device=q.device)[:, None]
    kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
    windowed = _window_active(window, window_on)

    acc = torch.zeros_like(qh)
    row_max = torch.full(qh.shape[:-1], _NEG_INF, device=q.device)
    row_sum = torch.zeros(qh.shape[:-1], device=q.device)
    for k0 in range(0, sk, block_k):
        kj = kh[:, :, k0:k0 + block_k]
        vj = vh[:, :, k0:k0 + block_k]
        scores = qh @ kj.transpose(-1, -2)                  # [b, h, sq, n]
        if logit_softcap:
            scores = logit_softcap * torch.tanh(scores / logit_softcap)
        cols = torch.arange(k0 + k_off, k0 + k_off + kj.shape[2],
                            device=q.device)[None, :]
        keep = None
        if causal:
            keep = cols <= rows
            if windowed:
                keep = keep & (cols > rows - window)
            keep = keep[None, None]
        if segment_ids is not None:
            seg = (segment_ids[:, :, None]
                   == kv_seg[:, None, k0:k0 + kj.shape[2]])[:, None]
            keep = seg if keep is None else keep & seg
        if keep is not None:
            scores = torch.where(keep, scores, _NEG_INF)
        new_max = torch.maximum(row_max, scores.amax(dim=-1))
        alpha = torch.exp(row_max - new_max)
        p = torch.exp(scores - new_max[..., None])
        acc = acc * alpha[..., None] + p @ vj
        row_sum = row_sum * alpha + p.sum(dim=-1)
        row_max = new_max
    out = acc / torch.clamp_min(row_sum[..., None], 1e-37)
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# flash forward: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def _offsets(offsets):
    if offsets is None:
        return 0, 0
    return int(offsets[0]), int(offsets[1])


def _tile_keep(rows, k0: int, n: int, causal, segment_ids, k_off: int,
               window: int, kv_segment_ids=None):
    """[b or 1, 1, sq, n] keep-mask of the K/V tile at columns [k0, k0+n)
    for global ``rows`` [sq, 1], or None: the ONE mask the plain versions
    of the forward and both backward kernels share. The keys' segments
    are ``kv_segment_ids`` [b, sk] when given, else ``segment_ids``."""
    keep = None
    if causal:
        cols = torch.arange(k0, k0 + n, device=rows.device)[None, :] + k_off
        keep = cols <= rows
        if window > 0:
            keep = keep & (cols > rows - window)
        keep = keep[None, None]
    if segment_ids is not None:
        kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
        seg = (segment_ids[:, :, None]
               == kv_seg[:, None, k0:k0 + n])[:, None]
        keep = seg if keep is None else keep & seg
    return keep


def flash_forward_plain(q, k, v, causal, segment_ids=None, offsets=None,
                        window=0, kv_segment_ids=None):
    """The kernel's arithmetic in plain PyTorch. q [b, sq, nh, hd]; k/v
    [b, sk, nkv, hd]; segment_ids [b, s] (sq == sk), or the query rows'
    [b, sq] with ``kv_segment_ids`` the keys' [b, sk]; offsets (q_off,
    k_off) global positions for the causal mask. Returns (out [b, sq, nh,
    hd] in q's dtype, lse [b*nh, sq] float32).

    Online softmax over 64-column K/V tiles with the kernel's -1e30 fill
    for masked scores. The kernel also skips tiles past the causal
    diagonal and before the window; that changes no result here, because
    a skipped tile is masked for every row of its block, and a row that
    sees no key at all (possible only with offsets) occurs only when
    nothing is skipped."""
    b, sq, nh, hd = q.shape
    sk = k.shape[1]
    q_off, k_off = _offsets(offsets)
    scale = 1.0 / math.sqrt(hd)
    qh = q.transpose(1, 2).float() * scale                  # [b, h, sq, hd]
    kh = repeat_kv(k, nh).transpose(1, 2).float()
    vh = repeat_kv(v, nh).transpose(1, 2).float()
    rows = torch.arange(sq, device=q.device)[:, None] + q_off

    acc = torch.zeros_like(qh)
    row_max = torch.full(qh.shape[:-1], _NEG_INF, device=q.device)
    row_sum = torch.zeros(qh.shape[:-1], device=q.device)
    for k0 in range(0, sk, _BLOCK_K):
        kj = kh[:, :, k0:k0 + _BLOCK_K]
        vj = vh[:, :, k0:k0 + _BLOCK_K]
        scores = qh @ kj.transpose(-1, -2)
        keep = _tile_keep(rows, k0, kj.shape[2], causal, segment_ids, k_off,
                          window, kv_segment_ids)
        if keep is not None:
            scores = torch.where(keep, scores, _NEG_INF)
        new_max = torch.maximum(row_max, scores.amax(dim=-1))
        alpha = torch.exp(row_max - new_max)
        p = torch.exp(scores - new_max[..., None])
        acc = acc * alpha[..., None] + p @ vj
        row_sum = row_sum * alpha + p.sum(dim=-1)
        row_max = new_max
    safe = torch.clamp_min(row_sum, 1e-37)
    out = (acc / safe[..., None]).transpose(1, 2).to(q.dtype)
    lse = (row_max + torch.log(safe)).reshape(b * nh, sq)
    return out, lse


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_qkv(name: str, q, k, v, window: int) -> None:
    """What every kernel wrapper refuses: the kernels' common contract."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name} wants q [b, sq, nh, hd] and k/v "
                         "[b, sk, nkv, hd]")
    b, _, nh, hd = q.shape
    nkv = k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not 1 <= hd <= 256:
        raise ValueError(f"head dim {hd} is outside the kernel's 1..256")
    if nkv < 1 or nh % nkv:
        raise ValueError(f"{nh} query heads do not group onto {nkv} kv heads")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes float32/bfloat16/float16 q/k/v of "
                         f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on the same device")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _unit_stride(*ts):
    """The kernels take any strides but the last, which must be 1."""
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ts)


def _segments(segment_ids, b: int, sq: int, sk: int, device,
              kv_segment_ids=None):
    """(the keys' segments [b, sk], the query rows' [b, sq]) as the
    kernels read them, or (None, None)."""
    if segment_ids is None:
        if kv_segment_ids is not None:
            raise ValueError("kv_segment_ids come with segment_ids")
        return None, None
    if kv_segment_ids is None:
        if sq != sk or tuple(segment_ids.shape) != (b, sq):
            raise ValueError("segment_ids must be [b, s] with sq == sk")
        kv_segment_ids = segment_ids
    elif (tuple(segment_ids.shape) != (b, sq)
          or tuple(kv_segment_ids.shape) != (b, sk)):
        raise ValueError("segment_ids must be [b, sq] and kv_segment_ids "
                         "[b, sk]")
    return tuple(x.to(device=device, dtype=torch.int32).contiguous()
                 for x in (kv_segment_ids, segment_ids))


def _strides(*ts):
    return [x for t in ts for x in t.stride()[:3]]


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.kubedl_cuda_error_string(err).decode()})")


def _route(dtype, hd: int, head_dims) -> str:
    """``"sm90"`` (wgmma tensor-core products, TMA loads) for bf16 and f16
    at the kernel's ``head_dims``; ``"simt"`` (f32 CUDA-core products) for
    float32 and every other head dim."""
    if dtype in (torch.bfloat16, torch.float16) and hd in head_dims:
        return "sm90"
    return "simt"


def flash_fwd_route(dtype, hd: int) -> str:
    """Which source a forward (K1) launch takes: ``"sm90"``
    (``csrc/flash_fwd_sm90.cu``) for bf16/f16 at head dims 64, 128 and 256
    (Llama's and Gemma's), else ``"simt"`` (``csrc/flash_fwd.cu``)."""
    return _route(dtype, hd, (64, 128, 256))


#: route -> (forward kernel source under csrc/, its C entry point)
_FWD_SOURCES = {"sm90": ("flash_fwd_sm90", "kubedl_flash_fwd90"),
                "simt": ("flash_fwd", "kubedl_flash_fwd")}


@functools.cache
def _fwd_lib(route: str) -> ctypes.CDLL:
    """The route's forward source, built at first use, with its C
    signature (both routes take the same arguments)."""
    from ._build import library
    name, entry = _FWD_SOURCES[route]
    lib = library(name)
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn = getattr(lib, entry)
    fn.argtypes = [ptr] * 7 + [i32] * 7 + [i64] * 9 + [i32] * 5 + [
        ctypes.c_float, ptr]
    fn.restype = i32
    lib.kubedl_cuda_error_string.argtypes = [i32]
    lib.kubedl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_forward(q, k, v, causal, segment_ids=None, offsets=None,
                  window=0, kv_segment_ids=None):
    """FlashAttention-2 forward, same contract as
    :func:`flash_forward_plain`. On CUDA tensors it launches the forward
    kernel of :func:`flash_fwd_route`'s source (counted in
    ``flash_forward.launches`` and ``flash_forward.launches_by_route``);
    on CPU tensors it runs the plain version. Anything the kernel does not
    take raises."""
    if not q.is_cuda:
        return flash_forward_plain(q, k, v, causal, segment_ids=segment_ids,
                                   offsets=offsets, window=window,
                                   kv_segment_ids=kv_segment_ids)
    _check_qkv("flash_forward", q, k, v, window)
    b, sq, nh, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    q, k, v = _unit_stride(q, k, v)
    seg, seg_q = _segments(segment_ids, b, sq, sk, q.device, kv_segment_ids)
    q_off, k_off = _offsets(offsets)
    out = torch.empty((b, sq, nh, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * nh, sq), dtype=torch.float32, device=q.device)
    if sq == 0 or b * nh == 0:
        return out, lse
    if sk == 0:
        raise ValueError("flash_forward needs at least one key")
    route = flash_fwd_route(q.dtype, hd)
    if route == "sm90":
        _check_tma("flash_forward", q, k, v)
    lib = _fwd_lib(route)
    err = getattr(lib, _FWD_SOURCES[route][1])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), 0 if seg is None else seg.data_ptr(),
        0 if seg_q is None else seg_q.data_ptr(),
        _DTYPE_CODES[q.dtype], b, sq, sk, nh, nkv, hd, *_strides(q, k, v),
        int(bool(causal)), int(window), int(offsets is not None), q_off,
        k_off, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "flash_forward")
    flash_forward.launches += 1
    flash_forward.launches_by_route[route] += 1
    return out, lse


#: kernel launches since the counts were last set to 0, in all and by
#: :func:`flash_fwd_route` (chip_smoke.py reads them to show the serving
#: and training paths went through the kernel)
flash_forward.launches = 0
flash_forward.launches_by_route = {"sm90": 0, "simt": 0}


# ---------------------------------------------------------------------------
# flash backward: plain versions and kernel wrappers
# ---------------------------------------------------------------------------

def flash_delta(o, do):
    """Δ = rowsum(dO ∘ O) in float32 as [b*nh, sq]: the backward kernels'
    per-row term, a PyTorch op outside them (the JAX package computes it
    outside Pallas too)."""
    b, sq, nh, _ = o.shape
    d = (do.float() * o.float()).sum(-1)                     # [b, sq, nh]
    return d.transpose(1, 2).reshape(b * nh, sq).contiguous()


def _bwd_tiles(q, k, v, do, lse, delta, causal, segment_ids, offsets,
               window, kv_segment_ids=None):
    """The backward kernels' per-tile arithmetic in float32, q-head space:
    for each 64-column K/V tile yields ``(k0, kj, p, ds)`` with p = exp(s
    - lse) over scores s = (q·k)·scale masked to -1e30, and ds = p ∘
    (dO·vᵀ - Δ), each [b, nh, sq, n]."""
    b, sq, nh, hd = q.shape
    sk = k.shape[1]
    q_off, k_off = _offsets(offsets)
    scale = 1.0 / math.sqrt(hd)
    qh = q.transpose(1, 2).float()                          # [b, h, sq, hd]
    oh = do.transpose(1, 2).float()
    kh = repeat_kv(k, nh).transpose(1, 2).float()
    vh = repeat_kv(v, nh).transpose(1, 2).float()
    lse = lse.reshape(b, nh, sq, 1)
    delta = delta.reshape(b, nh, sq, 1)
    rows = torch.arange(sq, device=q.device)[:, None] + q_off
    for k0 in range(0, sk, _BLOCK_K):
        kj = kh[:, :, k0:k0 + _BLOCK_K]
        vj = vh[:, :, k0:k0 + _BLOCK_K]
        scores = (qh @ kj.transpose(-1, -2)) * scale
        keep = _tile_keep(rows, k0, kj.shape[2], causal, segment_ids, k_off,
                          window, kv_segment_ids)
        if keep is not None:
            scores = torch.where(keep, scores, _NEG_INF)
        p = torch.exp(scores - lse)
        ds = p * (oh @ vj.transpose(-1, -2) - delta)
        yield k0, kj, p, ds


def flash_dq_plain(q, k, v, do, lse, delta, causal, segment_ids=None,
                   offsets=None, window=0, kv_segment_ids=None):
    """The dQ kernel's arithmetic in plain PyTorch: dq = scale · Σ ds·K
    over the K/V tiles, in q's dtype [b, sq, nh, hd]. ``lse`` is the
    forward's [b*nh, sq]; ``delta`` is :func:`flash_delta`. Skipped tiles
    need no skipping here: their p is exactly 0."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.zeros(q.transpose(1, 2).shape, dtype=torch.float32,
                     device=q.device)
    for _, kj, _, ds in _bwd_tiles(q, k, v, do, lse, delta, causal,
                                   segment_ids, offsets, window,
                                   kv_segment_ids):
        dq += ds @ kj
    return (dq * scale).transpose(1, 2).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal, segment_ids=None,
                    offsets=None, window=0, kv_segment_ids=None):
    """The dK/dV kernel's arithmetic in plain PyTorch: dv = Σ pᵀ·dO and dk
    = scale · Σ dsᵀ·Q over every query row of the GQA group's heads,
    returned in kv-head space [b, sk, nkv, hd] in k's and v's dtypes."""
    b, sq, nh, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    reps = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.transpose(1, 2).float().reshape(b, nkv, reps, sq, hd)
    og = do.transpose(1, 2).float().reshape(b, nkv, reps, sq, hd)
    dk = torch.zeros((b, nkv, sk, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0, kj, p, ds in _bwd_tiles(q, k, v, do, lse, delta, causal,
                                    segment_ids, offsets, window,
                                    kv_segment_ids):
        n = kj.shape[2]
        dv[:, :, k0:k0 + n] = torch.einsum(
            "bgrqk,bgrqd->bgkd", p.reshape(b, nkv, reps, sq, n), og)
        dk[:, :, k0:k0 + n] = torch.einsum(
            "bgrqk,bgrqd->bgkd", ds.reshape(b, nkv, reps, sq, n), qg)
    return ((dk * scale).transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def flash_backward_plain(q, k, v, o, lse, do, causal, segment_ids=None,
                         offsets=None, window=0, kv_segment_ids=None):
    """Both backward kernels' arithmetic in plain PyTorch: (dq [b, sq, nh,
    hd], dk, dv [b, sk, nkv, hd]) from the forward's ``o`` and ``lse`` and
    the incoming gradient ``do``, the arguments of the JAX package's
    ``_flash_backward``."""
    delta = flash_delta(o, do)
    kw = dict(segment_ids=segment_ids, offsets=offsets, window=window,
              kv_segment_ids=kv_segment_ids)
    dq = flash_dq_plain(q, k, v, do, lse, delta, causal, **kw)
    dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, causal, **kw)
    return dq, dk, dv


def flash_dq_route(dtype, hd: int) -> str:
    """Which source a dQ (K2) launch takes: ``"sm90"``
    (``csrc/flash_bwd_sm90.cu``) for bf16/f16 at head dims 64, 128 and
    256 (at 256 its own kernel: 64-row q tiles, the two warpgroups
    splitting dQ's columns), else ``"simt"`` (``csrc/flash_bwd.cu``)."""
    return _route(dtype, hd, (64, 128, 256))


def flash_dkv_route(dtype, hd: int) -> str:
    """Which source a dK/dV (K3) launch takes: ``"sm90"``
    (``csrc/flash_bwd_sm90.cu``) for bf16/f16 at head dims 64, 128 and
    256, else ``"simt"`` (``csrc/flash_bwd.cu``)."""
    return _route(dtype, hd, (64, 128, 256))


#: k rows per block of the sm90 dK/dV kernel at head dim 256
_DKV256_BLOCK_K = 64


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dkv_splits(b: int, nkv: int, sk: int, reps: int, hd: int,
               sms: int) -> int:
    """How many blocks of the ``sm90`` dK/dV kernel share one GQA group of
    ``reps`` query heads: at head dim 256 the fewest (a power of two
    dividing ``reps``) that give every one of the card's ``sms`` SMs a
    block, from one block per (b·nkv, 64-row k tile); 1 elsewhere. Each
    split past the first costs a float32 dK/dV of the whole tensor in
    workspace and a reduction pass. The splits are added in a fixed order,
    so at one count two calls give the same bits."""
    if hd != 256:
        return 1
    blocks = b * nkv * -(-sk // _DKV256_BLOCK_K)
    splits = 1
    while blocks * splits < sms and reps % (2 * splits) == 0:
        splits *= 2
    return splits


#: route -> (kernel source under csrc/, prefix of its C entry points)
_BWD_SOURCES = {"sm90": ("flash_bwd_sm90", "kubedl_flash_bwd90_"),
                "simt": ("flash_bwd", "kubedl_flash_bwd_")}


@functools.cache
def _bwd_lib(route: str) -> ctypes.CDLL:
    """The route's backward source, built at first use, with its C
    signatures (both routes take the same arguments)."""
    from ._build import library
    name, prefix = _BWD_SOURCES[route]
    lib = library(name)
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    shapes = [i32] * 7 + [i64] * 12 + [i32] * 5 + [ctypes.c_float]
    for fn, n_ptr in (("dq", 9), ("dkv", 10)):
        # the sm90 dK/dV entry also takes a workspace and the split count
        split = int(route == "sm90" and fn == "dkv")
        f = getattr(lib, prefix + fn)
        f.argtypes = [ptr] * (n_ptr + split) + shapes + [i32] * split + [ptr]
        f.restype = i32
    lib.kubedl_cuda_error_string.argtypes = [i32]
    lib.kubedl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_tma(name: str, *ts) -> None:
    """The tensor-core route loads q, k, v (and the backward's dO) with
    TMA, which takes only 16-byte aligned bases and strides."""
    for t in ts:
        if t.data_ptr() % 16 or any(x * t.element_size() % 16
                                    for x in t.stride()[:-1]):
            raise ValueError(
                f"{name}: the sm90 route loads with TMA, which needs "
                f"16-byte aligned bases and strides; got a {t.dtype} "
                f"tensor at offset {t.data_ptr() % 16} with strides "
                f"{tuple(t.stride())}")


def _bwd_kernel(name: str, q, k, v, do, lse, delta, seg, outs, causal,
                offsets, window, fn) -> None:
    """Launch ``fn`` ("dq" or "dkv") on its own route, raise on a failed
    launch, and count it. The ``sm90`` dK/dV launch takes a workspace for
    :func:`dkv_splits` > 1 and the split count."""
    route_of = flash_dq_route if fn == "dq" else flash_dkv_route
    route = route_of(q.dtype, q.shape[-1])
    tail = ()
    if route == "sm90":
        _check_tma(name, q, k, v, do)
        if fn == "dkv":
            b, sk, nkv, hd = k.shape
            splits = dkv_splits(b, nkv, sk, q.shape[2] // nkv, hd,
                                _sm_count(q.device.index))
            ws = None if splits == 1 else torch.empty(
                (splits, 2, b, sk, nkv, hd), dtype=torch.float32,
                device=q.device)
            outs, tail = (*outs, ws), (splits,)
    lib = _bwd_lib(route)
    err = _bwd_launch(getattr(lib, _BWD_SOURCES[route][1] + fn), q, k, v,
                      do, lse, delta, seg, outs, causal, offsets, window,
                      *tail)
    _raise_on(lib, err, name)
    wrapper = flash_dq if fn == "dq" else flash_dkv
    wrapper.launches += 1
    wrapper.launches_by_route[route] += 1


def _bwd_args(name, q, k, v, do, lse, delta, segment_ids, window,
              kv_segment_ids=None):
    """Checked, unit-stride kernel operands of a backward launch; ``seg``
    is the pair of :func:`_segments`."""
    _check_qkv(name, q, k, v, window)
    b, sq, nh, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{name}: dO {tuple(do.shape)} {do.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    for t, what in ((lse, "lse"), (delta, "delta")):
        if tuple(t.shape) != (b * nh, sq) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name}: {what} must be float32 [b*nh, sq] = "
                             f"[{b * nh}, {sq}] on q's device, got "
                             f"{t.dtype} {tuple(t.shape)}")
    q, k, v, do = _unit_stride(q, k, v, do)
    seg = _segments(segment_ids, b, sq, k.shape[1], q.device,
                    kv_segment_ids)
    return q, k, v, do, lse.contiguous(), delta.contiguous(), seg


def _bwd_launch(fn, q, k, v, do, lse, delta, seg, outs, causal, offsets,
                window, *tail):
    b, sq, nh, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    q_off, k_off = _offsets(offsets)
    return fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        *[0 if t is None else t.data_ptr() for t in seg],
        *[0 if t is None else t.data_ptr() for t in outs],
        _DTYPE_CODES[q.dtype], b, sq, sk, nh, nkv, hd, *_strides(q, k, v, do),
        int(bool(causal)), int(window), int(offsets is not None), q_off,
        k_off, 1.0 / math.sqrt(hd), *tail,
        torch.cuda.current_stream(q.device).cuda_stream)


def flash_dq(q, k, v, do, lse, delta, causal, segment_ids=None,
             offsets=None, window=0, kv_segment_ids=None):
    """dQ kernel, same contract as :func:`flash_dq_plain`. On CUDA tensors
    it launches the dQ kernel of :func:`flash_dq_route`'s source (counted
    in ``flash_dq.launches`` and ``flash_dq.launches_by_route``); on CPU
    tensors it runs the plain version."""
    if not q.is_cuda:
        return flash_dq_plain(q, k, v, do, lse, delta, causal,
                              segment_ids=segment_ids, offsets=offsets,
                              window=window, kv_segment_ids=kv_segment_ids)
    q, k, v, do, lse, delta, seg = _bwd_args(
        "flash_dq", q, k, v, do, lse, delta, segment_ids, window,
        kv_segment_ids)
    b, sq, nh, hd = q.shape
    dq = torch.empty((b, sq, nh, hd), dtype=q.dtype, device=q.device)
    if sq == 0 or b * nh == 0:
        return dq
    if k.shape[1] == 0:
        raise ValueError("flash_dq needs at least one key")
    _bwd_kernel("flash_dq", q, k, v, do, lse, delta, seg, (dq,), causal,
                offsets, window, "dq")
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal, segment_ids=None,
              offsets=None, window=0, kv_segment_ids=None):
    """dK/dV kernel, same contract as :func:`flash_dkv_plain`. On CUDA
    tensors it launches the dK/dV kernel of :func:`flash_dkv_route`'s
    source (counted in ``flash_dkv.launches`` and
    ``flash_dkv.launches_by_route``; a split launch and its reduction pass
    count once); on CPU tensors it runs the plain version."""
    if not q.is_cuda:
        return flash_dkv_plain(q, k, v, do, lse, delta, causal,
                               segment_ids=segment_ids, offsets=offsets,
                               window=window, kv_segment_ids=kv_segment_ids)
    q, k, v, do, lse, delta, seg = _bwd_args(
        "flash_dkv", q, k, v, do, lse, delta, segment_ids, window,
        kv_segment_ids)
    b, sq = q.shape[:2]
    sk, nkv, hd = k.shape[1:]
    dk = torch.empty((b, sk, nkv, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if sk == 0 or b * nkv == 0:
        return dk, dv
    if sq == 0:              # no query row: no gradient reaches any key
        return dk.zero_(), dv.zero_()
    _bwd_kernel("flash_dkv", q, k, v, do, lse, delta, seg, (dk, dv), causal,
                offsets, window, "dkv")
    return dk, dv


#: kernel launches since the counts were last set to 0, in all and by
#: :func:`flash_dq_route` and :func:`flash_dkv_route`
flash_dq.launches = 0
flash_dkv.launches = 0
flash_dq.launches_by_route = {"sm90": 0, "simt": 0}
flash_dkv.launches_by_route = {"sm90": 0, "simt": 0}


def flash_backward(q, k, v, o, lse, do, causal, segment_ids=None,
                   offsets=None, window=0, kv_segment_ids=None):
    """Flash-2 backward, same contract as :func:`flash_backward_plain`:
    Δ in PyTorch, then :func:`flash_dq` and :func:`flash_dkv` (the two
    kernels on CUDA tensors, their plain versions on CPU tensors)."""
    delta = flash_delta(o, do)
    kw = dict(segment_ids=segment_ids, offsets=offsets, window=window,
              kv_segment_ids=kv_segment_ids)
    dq = flash_dq(q, k, v, do, lse, delta, causal, **kw)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, causal, **kw)
    return dq, dk, dv


def chunked_backward_opted_in(why: Optional[str] = None) -> bool:
    """Whether ``KUBEDL_FLASH_BWD=chunked`` is set (read at each
    backward). With ``why``, a backward that cannot take the opt-in (it
    says why) raises instead of ignoring it."""
    on = os.environ.get("KUBEDL_FLASH_BWD", "kernel") == "chunked"
    if on and why:
        raise ValueError(f"KUBEDL_FLASH_BWD=chunked is set, but {why}: "
                         "this backward runs the kernels only; unset it")
    return on


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX package's ``_flash_attention``
    custom_vjp: forward :func:`flash_forward`, which saves q, k, v, o and
    lse; backward :func:`flash_backward`. ``KUBEDL_FLASH_BWD=chunked``
    (read at each backward) recomputes through the differentiable
    :func:`chunked_attention` instead; it is an explicit opt-in, never
    taken on a failure, and refused (a ``ValueError``) with global
    ``offsets`` or ``kv_segment_ids``, which the chunked path cannot
    take."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, window, offsets=None,
                kv_segment_ids=None):
        out, lse = flash_forward(q, k, v, causal, segment_ids=segment_ids,
                                 window=window, offsets=offsets,
                                 kv_segment_ids=kv_segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids, kv_segment_ids)
        ctx.causal, ctx.window, ctx.offsets = causal, window, offsets
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, segment_ids, kv_segment_ids = ctx.saved_tensors
        split = ctx.offsets is not None or kv_segment_ids is not None
        if chunked_backward_opted_in(
                "the chunked path cannot take global offsets or "
                "kv_segment_ids (one cp rank's rows against the whole "
                "sequence's keys)" if split else None):
            with torch.enable_grad():
                qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
                out = chunked_attention(qd, kd, vd, causal=ctx.causal,
                                        segment_ids=segment_ids,
                                        window=ctx.window)
                dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), g)
            return dq, dk, dv, None, None, None, None, None
        dq, dk, dv = flash_backward(q, k, v, o, lse, g, ctx.causal,
                                    segment_ids=segment_ids,
                                    window=ctx.window, offsets=ctx.offsets,
                                    kv_segment_ids=kv_segment_ids)
        return (dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None,
                None)


def flash_attention(q, k, v, causal: bool = True, segment_ids=None,
                    window: int = 0, offsets=None, kv_segment_ids=None):
    """Flash attention out [b, sq, nh, hd]. When autograd records (a
    grad-requiring q, k or v) it runs the :class:`_FlashAttention`
    Function, so the backward kernels produce dq/dk/dv; otherwise (the
    serving path) just :func:`flash_forward`. ``offsets`` and
    ``kv_segment_ids`` as in :func:`flash_forward_plain` (the query rows
    of one ``cp`` rank against the whole sequence's keys)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, segment_ids, causal, window,
                                     offsets, kv_segment_ids)
    out, _ = flash_forward(q, k, v, causal, segment_ids=segment_ids,
                           window=window, offsets=offsets,
                           kv_segment_ids=kv_segment_ids)
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def multi_head_attention(q, k, v, causal: bool = True, segment_ids=None,
                         impl: Optional[str] = None, window: int = 0,
                         scale=None, logit_softcap: float = 0.0,
                         window_on=None):
    """q [b, s, nh, hd]; k/v [b, s, nkv, hd] (GQA) -> [b, s, nh, hd].
    ``window > 0``: sliding-window (local) attention, causal only.
    ``scale``/``logit_softcap``/``window_on`` (Gemma-2's query scale,
    attention softcap, per-layer window toggle) route through the chunked
    path: the kernels do not implement them.

    ``impl=None`` picks ``kernel`` for CUDA tensors and ``chunked`` for
    CPU tensors. ``kernel`` (CUDA) and ``plain`` (CPU, the kernels' plain
    versions) both run :func:`flash_attention`, forward and backward. The
    kernels mask ragged tails themselves, so unlike the TPU path no
    128-alignment is required."""
    _check_window(window, causal)
    gemma2_knobs = (scale is not None or bool(logit_softcap)
                    or window_on is not None)
    if impl is None:
        impl = "kernel" if (q.is_cuda and not gemma2_knobs) else "chunked"
    if impl in ("kernel", "plain"):
        if gemma2_knobs:
            raise ValueError("scale/logit_softcap/window_on are not "
                             f"implemented in the kernels; impl={impl!r} "
                             "cannot take them, use impl='chunked'")
        if impl == "kernel" and not q.is_cuda:
            raise ValueError("impl='kernel' needs CUDA tensors; the CPU "
                             "runs impl='plain' or 'chunked'")
        if impl == "plain" and q.is_cuda:
            raise ValueError("impl='plain' runs the kernels' plain versions "
                             "on CPU tensors; the card runs impl='kernel'")
        return flash_attention(q, k, v, causal, segment_ids=segment_ids,
                               window=window)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal,
                                 segment_ids=segment_ids, window=window,
                                 scale=scale, logit_softcap=logit_softcap,
                                 window_on=window_on)
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal,
                                   segment_ids=segment_ids,
                                   window=window, scale=scale,
                                   logit_softcap=logit_softcap,
                                   window_on=window_on)
    raise ValueError(f"unknown attention impl {impl!r}")
