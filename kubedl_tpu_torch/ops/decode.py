"""Paged decode attention: the decode tick's attention as one hand-written
Hopper kernel, and its plain PyTorch version.

One query position a lane attends to that lane's keys ``0..pos[i]`` in a
block pool ``[num_blocks, block, nkv, hd]``, read through the lane's block
table (``models.llama.attention_step``'s paged tick; the dense slab is the
same pool with one block of ``max_len`` slots a lane). The arithmetic is
the JAX step's einsum: products and sums in float32 from the stored
values, the scale, then the optional softcap, on the float32 scores, the
causal and sliding-window mask, a float32 softmax, p·v with the float32
probabilities, one cast to the activation dtype.

:func:`paged_decode` launches ``csrc/paged_decode_sm90.cu`` on CUDA
tensors and runs :func:`paged_decode_plain` on CPU tensors. The plain
version is that einsum over a gathered view of every lane's whole table;
the kernel reads each lane's live blocks in place, splits them into runs
of keys (:func:`decode_splits`), takes a softmax within each run and
merges the runs by log-sum-exp. ``chip_smoke.py`` holds the kernel
against the plain version on the card. Nothing falls back: a CUDA call
the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .attention import _DTYPE_CODES, _raise_on, _sm_count

#: bytes of one K (or V) tile in the kernel's shared memory
TILE_BYTES = 8192
#: CTAs a split rule aims to give each SM when every lane is full
CTAS_PER_SM = 16
#: the most splits a lane's table takes (the merge kernel's limit)
MAX_SPLITS = 256


def _padded_hd(hd: int) -> int:
    """The kernel's head-dim instance: 64, 128 or 256 (zero-padded)."""
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def tile_keys(hd: int, itemsize: int) -> int:
    """Keys in one of the kernel's tiles: 8 KiB of K rows."""
    return TILE_BYTES // (_padded_hd(hd) * itemsize)


def head_map(nh: int, q_first: int, group: int) -> tuple:
    """The KV heads the ``nh`` local query heads read, head ``h`` reading
    ``(q_first + h) // group``: ``(kv_first, kv_count, most)``, the first
    and the number of KV heads read and the most query heads one of them
    serves."""
    kv = [(q_first + h) // group for h in range(nh)]
    return kv[0], kv[-1] + 1 - kv[0], max(map(kv.count, set(kv)))


def decode_splits(b: int, ctas: int, slots: int, tile: int,
                  sms: int) -> tuple:
    """``(splits, keys a split)`` of a table of ``slots`` keys a lane, from
    the shapes alone: whole tiles of ``tile`` keys a split, and enough
    splits that ``b`` lanes of ``ctas`` CTAs each give every one of the
    card's ``sms`` SMs :data:`CTAS_PER_SM` CTAs when the lanes are full.
    A short lane leaves its later splits empty; their CTAs exit at once.
    At most :data:`MAX_SPLITS`."""
    tiles = -(-slots // tile)
    want = min(MAX_SPLITS, -(-CTAS_PER_SM * sms // max(1, b * ctas)))
    per = -(-tiles // max(1, min(tiles, want)))
    return -(-tiles // per), per * tile


def _layout(q, k_pool, tables, q_first: int, group) -> dict:
    """The shapes as both versions read them; raises on what neither
    takes."""
    if q.ndim != 3 or k_pool.ndim != 4 or tables.ndim != 2:
        raise ValueError("paged_decode wants q [b, nh, hd], pools [blocks, "
                         "block, nkv, hd] and tables [b, n]")
    b, nh, hd = q.shape
    _, block, nkv, khd = k_pool.shape
    if khd != hd or tables.shape[0] != b:
        raise ValueError(f"q {tuple(q.shape)}, pool {tuple(k_pool.shape)} "
                         f"and tables {tuple(tables.shape)} do not match")
    group = group or nh // nkv
    if group < 1 or q_first < 0:
        raise ValueError(f"bad head map: q_first {q_first}, group {group}")
    kv_first, kv_count, most = head_map(nh, q_first, group)
    if kv_first + kv_count > nkv:
        raise ValueError(f"query heads {q_first}..{q_first + nh - 1} over "
                         f"groups of {group} read KV heads past the pool's "
                         f"{nkv}")
    per_cta = 4 if most <= 4 else 8             # query heads a CTA holds
    return dict(b=b, nh=nh, hd=hd, nkv=nkv, block=block, group=group,
                kv_first=kv_first, kv_count=kv_count, per_cta=per_cta,
                chunks=-(-most // per_cta))     # CTAs a KV head takes


def paged_decode_plain(q, k_pool, v_pool, tables, pos, scale: float,
                       softcap: float = 0.0, window: int = 0,
                       q_first: int = 0, group=None):
    """The tick's attention as the einsum path computes it: every lane's
    whole table gathered into a dense view, cast to float32, scored over
    every slot, masked, softmaxed, and p·v in float32. q [b, nh, hd]; k/v
    pools [num_blocks, block, nkv, hd]; tables [b, n] int (lane ``i``'s key
    ``p`` at ``(tables[i, p // block], p % block)``); pos [b] int. Local
    query head ``h`` reads KV head ``(q_first + h) // group`` (``group``
    defaults to ``nh // nkv``). Returns [b, nh, hd] in q's dtype; a lane
    with no key (a negative position) gets zeros."""
    lay = _layout(q, k_pool, tables, q_first, group)
    b, nh, hd, nkv = lay["b"], lay["nh"], lay["hd"], lay["nkv"]
    n = tables.shape[1] * lay["block"]
    kc = k_pool[tables.long()].reshape(b, n, nkv, hd)
    vc = v_pool[tables.long()].reshape(b, n, nkv, hd)
    if q_first or lay["group"] * nkv != nh:
        # each query head's own KV head (``_local_kv``'s map)
        sel = torch.div(torch.arange(q_first, q_first + nh, device=q.device),
                        lay["group"], rounding_mode="floor")
        kc, vc = kc.index_select(2, sel), vc.index_select(2, sel)
    heads = kc.shape[2]
    qg = q.float().reshape(b, heads, nh // heads, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kc.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    keys = torch.arange(n, device=q.device)[None, :]
    at = pos.to(device=q.device, dtype=torch.int64)[:, None]
    keep = keys <= at
    if window:
        keep = keep & (keys > at - window)
    p = torch.softmax(s.masked_fill(~keep[:, None, None], float("-inf")), -1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.nan_to_num(0.0), vc.float())
    return out.reshape(b, nh, hd).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """``csrc/paged_decode_sm90.cu``, built at first use, with its C
    signature."""
    from ._build import library
    lib = library("paged_decode_sm90")
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.kubedl_paged_decode.argtypes = (
        [ptr] * 8 + [i32] * 8 + [i64] * 3 + [i32] * 9
        + [ctypes.c_float] * 2 + [ptr])
    lib.kubedl_paged_decode.restype = i32
    lib.kubedl_cuda_error_string.argtypes = [i32]
    lib.kubedl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def paged_decode(q, k_pool, v_pool, tables, pos, scale: float,
                 softcap: float = 0.0, window: int = 0, q_first: int = 0,
                 group=None):
    """Paged decode attention, same contract as
    :func:`paged_decode_plain`. On CUDA tensors it launches the kernel
    (the attention kernel, then the split merge) on the current stream,
    with no host synchronisation, so a CUDA graph captures it; on CPU
    tensors it runs the plain version."""
    if not q.is_cuda:
        paged_decode.launches_by_route["plain"] += 1
        return paged_decode_plain(q, k_pool, v_pool, tables, pos, scale,
                                  softcap, window, q_first, group)
    lay = _layout(q, k_pool, tables, q_first, group)
    for t in (k_pool, v_pool, tables, pos):
        if t.device != q.device:
            raise ValueError("paged_decode: q, the pools, tables and pos "
                             "must be on one device")
    if v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"K pool {tuple(k_pool.shape)} {k_pool.dtype} and "
                         f"V pool {tuple(v_pool.shape)} {v_pool.dtype} differ")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_decode reads contiguous pools")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged_decode takes float32/bfloat16/float16, got "
                         f"q {q.dtype}, pool {k_pool.dtype}")
    if lay["hd"] > 256 or lay["hd"] * k_pool.element_size() % 16:
        raise ValueError(f"head dim {lay['hd']} of {k_pool.dtype}: the "
                         "kernel takes rows of 16-byte multiples up to 256")
    if tables.dtype != torch.int64 or pos.dtype != torch.int64:
        raise ValueError("paged_decode reads int64 tables and positions")
    if q.stride(-1) != 1:
        q = q.contiguous()
    tables = tables if tables.stride(-1) == 1 else tables.contiguous()
    pos = pos.contiguous()
    b, nh, hd = lay["b"], lay["nh"], lay["hd"]
    splits, keys = decode_splits(
        b, lay["kv_count"] * lay["chunks"], tables.shape[1] * lay["block"],
        tile_keys(hd, k_pool.element_size()), _sm_count(q.device.index))
    out = torch.empty((b, nh, hd), dtype=q.dtype, device=q.device)
    part_o = torch.empty((b, nh, splits, hd), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((b, nh, splits, 2), dtype=torch.float32,
                          device=q.device)
    lib = _lib()
    err = lib.kubedl_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), part_o.data_ptr(),
        part_ml.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_pool.dtype], b, nh, hd, lay["nkv"], lay["block"],
        tables.shape[1], q.stride(0), q.stride(1), tables.stride(0),
        q_first, lay["group"], lay["kv_first"], lay["kv_count"],
        lay["chunks"], lay["per_cta"], splits, keys, int(window),
        float(scale), float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "paged_decode")
    if torch.cuda.is_current_stream_capturing():
        paged_decode.captured += 1
    else:
        count_replays(1)
    return out


def count_replays(calls: int) -> None:
    """Count ``calls`` kernel calls that ran on the card: a graph's owner
    counts the calls it captured at each replay."""
    paged_decode.launches += calls
    paged_decode.launches_by_route["sm90"] += calls


#: calls since the counts were last set to 0: kernel calls that ran on the
#: card (``launches``; a captured graph's at each replay), and calls by
#: route (``"sm90"`` the kernel, ``"plain"`` the CPU's plain version).
#: ``captured`` counts the calls recorded into CUDA graphs, which launch
#: nothing until replayed.
paged_decode.launches = 0
paged_decode.launches_by_route = {"sm90": 0, "plain": 0}
paged_decode.captured = 0
