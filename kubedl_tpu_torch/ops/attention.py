"""Attention: the hand-written Hopper flash kernel + the plain PyTorch paths.

Counterpart of ``kubedl_tpu/ops/attention.py``, same layouts (q
``[b, s, nh, hd]``, k/v ``[b, s, nkv, hd]``, GQA by blocked grouping):

* ``kernel`` — :func:`flash_forward`, the FlashAttention-2 forward written
  in CUDA C++ for ``sm_90a`` (``csrc/flash_fwd.cu``), replacing the TPU
  Pallas ``_flash_kernel``. Forward only in this slice: the dQ/dK/dV
  kernels arrive with the training slice.
* ``chunked`` — the same online-softmax algorithm as a loop over K/V
  blocks in plain PyTorch; runs anywhere (what the CPU tests exercise).
* ``reference`` — naive full-matrix attention for numerics tests.

:func:`flash_forward_plain` repeats the kernel's block arithmetic in
PyTorch; the wrapper takes it for CPU tensors, and ``chip_smoke.py``
holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
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
                      logit_softcap: float = 0.0, window_on=None):
    """Online-softmax attention over K/V blocks of ``block_k``: O(sq *
    block_k) score memory. ``scale``/``logit_softcap``/``window_on`` as in
    :func:`reference_attention` (softcap is monotonic, so the online max
    merge is unaffected)."""
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
    rows = torch.arange(sq, device=q.device)[:, None]
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
        cols = torch.arange(k0, k0 + kj.shape[2], device=q.device)[None, :]
        keep = None
        if causal:
            keep = cols <= rows
            if windowed:
                keep = keep & (cols > rows - window)
            keep = keep[None, None]
        if segment_ids is not None:
            seg = (segment_ids[:, :, None]
                   == segment_ids[:, None, k0:k0 + kj.shape[2]])[:, None]
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


def flash_forward_plain(q, k, v, causal, segment_ids=None, offsets=None,
                        window=0):
    """The kernel's arithmetic in plain PyTorch. q [b, sq, nh, hd]; k/v
    [b, sk, nkv, hd]; segment_ids [b, s] (sq == sk); offsets (q_off,
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
        keep = None
        if causal:
            cols = (torch.arange(k0, k0 + kj.shape[2], device=q.device)[None, :]
                    + k_off)
            keep = cols <= rows
            if window > 0:
                keep = keep & (cols > rows - window)
            keep = keep[None, None]
        if segment_ids is not None:
            seg = (segment_ids[:, :, None]
                   == segment_ids[:, None, k0:k0 + kj.shape[2]])[:, None]
            keep = seg if keep is None else keep & seg
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


@functools.cache
def _lib() -> ctypes.CDLL:
    """``csrc/flash_fwd.cu``, built at first use, with its C signature."""
    from ._build import library
    lib = library("flash_fwd")
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.kubedl_flash_fwd.argtypes = (
        [ptr] * 6 + [i32] * 7 + [i64] * 9 + [i32] * 5 + [ctypes.c_float, ptr])
    lib.kubedl_flash_fwd.restype = i32
    lib.kubedl_cuda_error_string.argtypes = [i32]
    lib.kubedl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_forward(q, k, v, causal, segment_ids=None, offsets=None,
                  window=0):
    """FlashAttention-2 forward, same contract as
    :func:`flash_forward_plain`. On CUDA tensors it launches
    ``csrc/flash_fwd.cu`` (and counts the launch in
    ``flash_forward.launches``); on CPU tensors it runs the plain
    version. Anything the kernel does not take raises."""
    if not q.is_cuda:
        return flash_forward_plain(q, k, v, causal, segment_ids=segment_ids,
                                   offsets=offsets, window=window)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_forward wants q [b, sq, nh, hd] and k/v "
                         "[b, sk, nkv, hd]")
    b, sq, nh, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not 1 <= hd <= 256:
        raise ValueError(f"head dim {hd} is outside the kernel's 1..256")
    if nkv < 1 or nh % nkv:
        raise ValueError(f"{nh} query heads do not group onto {nkv} kv heads")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_forward takes float32/bfloat16/float16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on the same device")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    seg = None
    if segment_ids is not None:
        if sq != sk or tuple(segment_ids.shape) != (b, sq):
            raise ValueError("segment_ids must be [b, s] with sq == sk")
        seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    q_off, k_off = _offsets(offsets)
    out = torch.empty((b, sq, nh, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * nh, sq), dtype=torch.float32, device=q.device)
    if sq == 0 or b * nh == 0:
        return out, lse
    if sk == 0:
        raise ValueError("flash_forward needs at least one key")
    lib = _lib()
    err = lib.kubedl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), 0 if seg is None else seg.data_ptr(),
        _DTYPE_CODES[q.dtype], b, sq, sk, nh, nkv, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), int(window), int(offsets is not None), q_off,
        k_off, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_forward launch failed: CUDA error {err} "
                           f"({lib.kubedl_cuda_error_string(err).decode()})")
    flash_forward.launches += 1
    return out, lse


#: kernel launches since the count was last set to 0 (chip_smoke.py reads
#: it to show the serving path went through the kernel)
flash_forward.launches = 0


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
    path: the kernel does not implement them.

    ``impl=None`` picks the kernel for CUDA tensors and ``chunked`` for
    CPU tensors. The kernel masks ragged tails itself, so unlike the TPU
    path no 128-alignment is required."""
    _check_window(window, causal)
    gemma2_knobs = (scale is not None or bool(logit_softcap)
                    or window_on is not None)
    if impl is None:
        impl = "kernel" if (q.is_cuda and not gemma2_knobs) else "chunked"
    if impl == "kernel":
        if gemma2_knobs:
            raise ValueError("scale/logit_softcap/window_on are not "
                             "implemented in the kernel; use "
                             "impl='chunked'")
        if not q.is_cuda:
            raise ValueError("impl='kernel' needs CUDA tensors; the CPU "
                             "runs impl='chunked'")
        out, _ = flash_forward(q, k, v, causal, segment_ids=segment_ids,
                               window=window)
        return out
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
