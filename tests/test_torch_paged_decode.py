"""The decode tick's paged attention (``ops.decode``) on the CPU.

``paged_decode`` runs its plain version on CPU tensors: the einsum path's
arithmetic over a gathered view of every lane's whole table. It is held
here against a plain reading of the contract, lane by lane and head by
head in float64 over the live keys only (``_per_lane``), at ragged
positions (0 and the last slot included), with prefix blocks shared
between lanes and sink entries past the live blocks, GQA groups of 7, 4
and 1, head dims 64, 128 and 256, the softcap, a sliding window, Gemma-2's
query scale and the head maps of Qwen2-7B's ranks at tp=8. The kernel
itself runs on the card (``chip_smoke.py``).
"""

import dataclasses
import math

import pytest
import torch

from kubedl_tpu_torch.models import gemma, llama
from kubedl_tpu_torch.ops import decode

#: float32 against float64
ATOL = 2e-5


def _per_lane(q, k_pool, v_pool, tables, pos, scale, softcap=0.0,
              window=0, q_first=0, group=None):
    """The contract read literally: for each lane and query head, the keys
    ``0..pos`` (inside the window) looked up one by one through the
    lane's table, scored, softmaxed and summed in float64."""
    b, nh, hd = q.shape
    blk, nkv = k_pool.shape[1], k_pool.shape[2]
    group = group or nh // nkv
    out = torch.zeros(b, nh, hd, dtype=torch.float64)
    for i in range(b):
        p = int(pos[i])
        keys = [j for j in range(p + 1) if not window or j > p - window]
        rows = [(int(tables[i, j // blk]), j % blk) for j in keys]
        for h in range(nh):
            kv = (q_first + h) // group
            k = torch.stack([k_pool[r, c, kv] for r, c in rows]).double()
            v = torch.stack([v_pool[r, c, kv] for r, c in rows]).double()
            s = k @ q[i, h].double() * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            out[i, h] = torch.softmax(s, 0) @ v
    return out


def _lanes(gen, b, n_blocks, blk, pool_blocks):
    """Block tables of ``b`` lanes: lane 1 shares lane 0's first two blocks
    (a registered prefix), every lane's entries past its live blocks point
    at the sink block 0; positions 0 and the last slot included."""
    slots = n_blocks * blk
    pos = torch.randint(0, slots, (b,), generator=gen)
    pos[0], pos[1] = slots - 1, 0
    if b > 2:
        pos[2] = blk + 3
    perm = torch.randperm(pool_blocks - 1, generator=gen) + 1
    tables = perm[:b * n_blocks].reshape(b, n_blocks).clone()
    tables[1, :2] = tables[0, :2]
    live = pos // blk + 1
    tables[torch.arange(n_blocks)[None, :] >= live[:, None]] = 0
    return tables, pos


CASES = {
    # name: (lanes, nh, nkv, hd, block, blocks a lane, extra wrapper args)
    "gqa7_hd128": (6, 7, 1, 128, 16, 9, {}),
    "gqa4_hd128": (5, 8, 2, 128, 8, 13, {}),
    "mha_hd64": (4, 3, 3, 64, 16, 5, {}),
    "gqa4_hd256_softcap": (4, 4, 1, 256, 16, 6,
                           {"softcap": 50.0, "scale": 256 ** -0.5}),
    "window": (5, 8, 2, 32, 8, 12, {"window": 20}),
    "query_scale_window_softcap": (4, 8, 4, 256, 8, 8,
                                   {"window": 13, "softcap": 30.0,
                                    "scale": 224 ** -0.5}),
    # Qwen2-7B at tp=8: rank 0's 4 query heads over KV head 0 (a run of
    # one group), rank 1's heads 4..7 over KV heads 0, 0, 0, 1
    "tp8_rank0": (4, 4, 4, 32, 16, 5, {"q_first": 0, "group": 7}),
    "tp8_rank1": (4, 4, 4, 32, 16, 5, {"q_first": 4, "group": 7}),
    "tp8_rank5": (4, 3, 4, 32, 16, 5, {"q_first": 16, "group": 7}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_holds_the_einsum_tick(name):
    """The plain version (the einsum tick's arithmetic) against the
    per-lane reading."""
    b, nh, nkv, hd, blk, n_blocks, kw = CASES[name]
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    pool_blocks = b * n_blocks + 3
    k_pool = torch.randn(pool_blocks, blk, nkv, hd, generator=gen)
    v_pool = torch.randn(pool_blocks, blk, nkv, hd, generator=gen)
    q = torch.randn(b, nh, hd, generator=gen)
    tables, pos = _lanes(gen, b, n_blocks, blk, pool_blocks)
    kw = {"scale": 1.0 / math.sqrt(hd), **kw}
    got = decode.paged_decode(q, k_pool, v_pool, tables, pos, **kw)
    want = _per_lane(q, k_pool, v_pool, tables, pos, **kw)
    assert got.dtype == q.dtype and got.shape == (b, nh, hd)
    torch.testing.assert_close(got.double(), want, atol=ATOL, rtol=ATOL)


def test_plain_reads_bf16_pools_in_float32():
    """bf16 pools and activations: products from the stored values in
    float32, one rounding at the end."""
    gen = torch.Generator().manual_seed(3)
    b, nh, nkv, hd, blk, n_blocks = 4, 8, 2, 128, 16, 6
    pool_blocks = b * n_blocks + 1
    k_pool = torch.randn(pool_blocks, blk, nkv, hd, generator=gen)
    v_pool = torch.randn(pool_blocks, blk, nkv, hd, generator=gen)
    q = torch.randn(b, nh, hd, generator=gen)
    tables, pos = _lanes(gen, b, n_blocks, blk, pool_blocks)
    bf = [t.bfloat16() for t in (q, k_pool, v_pool)]
    got = decode.paged_decode(*bf, tables, pos, scale=hd ** -0.5)
    want = _per_lane(*bf, tables, pos, scale=hd ** -0.5)
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the exact result
    torch.testing.assert_close(got.double(), want, atol=1e-6, rtol=2 ** -8)


def test_splits_come_from_the_shapes():
    """The split rule: whole tiles, more splits for fewer lanes, the
    chat and batch cells' shapes as the kernel splits them on 132 SMs."""
    tile = decode.tile_keys(128, 2)
    assert tile == 32
    # Qwen2-7B chat: 32 lanes x 4 KV heads over 2,048 slots
    assert decode.decode_splits(32, 4, 2048, tile, 132) == (16, 128)
    # Mixtral batch: 32 lanes x 8 KV heads
    assert decode.decode_splits(32, 8, 2048, tile, 132) == (8, 256)
    assert decode.decode_splits(1, 1, 16384, tile, 132) == (256, 64)
    assert decode.decode_splits(4, 2, 40, 16, 132) == (3, 16)
    # (kv_first, kv_count, most): Gemma-2B's 8 query heads over one KV
    # head, Qwen2-7B's tp=8 rank 1 (heads 4..7 over KV heads 0, 0, 0, 1)
    assert decode.head_map(8, 0, 8) == (0, 1, 8)
    assert decode.head_map(4, 4, 7) == (0, 2, 3)
    # a CTA holds at most 8 query heads: 16 over one KV head take two
    q, pool = torch.zeros(1, 16, 64), torch.zeros(2, 16, 1, 64)
    lay = decode._layout(q, pool, torch.zeros(1, 1, dtype=torch.long), 0,
                         None)
    assert (lay["per_cta"], lay["chunks"]) == (8, 2)


def _tiny(family, **over):
    cfg = dataclasses.replace(family.tiny(vocab=64, seq=64),
                              dtype="float32", **over)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    return cfg, params


def _tick_inputs(cfg, lanes=3, blk=8, n_blocks=8):
    gen = torch.Generator().manual_seed(5)
    pool = llama.init_block_pool(cfg, lanes * n_blocks + 1, blk,
                                 device="cpu")
    for t in pool.values():
        t.normal_(generator=gen)
    tables = (torch.arange(lanes * n_blocks) + 1).reshape(lanes, n_blocks)
    pos = torch.tensor([n_blocks * blk - 1, 0, 21])[:lanes]
    cur = torch.randint(1, cfg.vocab_size, (lanes, 1), generator=gen)
    return pool, tables, pos, cur


def test_tick_routes_through_the_wrapper_and_prefill_and_verify_do_not():
    cfg, params = _tiny(llama)
    pool, tables, pos, cur = _tick_inputs(cfg)
    counts = decode.paged_decode.launches_by_route
    before = counts["plain"]
    llama.forward_step_paged(cfg, params, cur, pool, tables, pos)
    assert counts["plain"] - before == cfg.n_layers
    before = counts["plain"]
    # a prefill chunk (one shared position) and a verify chunk (k + 1
    # positions a row) keep the gathered view
    llama.forward_step_paged(cfg, params, cur[:1].repeat(1, 5), pool,
                             tables[:1], 3)
    llama.forward_step_paged(cfg, params, cur.repeat(1, 3), pool, tables,
                             pos.clamp(max=40), all_logits=True)
    # and so does a tick with a slot mask
    valid = torch.ones(3, tables.shape[1] * 8, dtype=torch.bool)
    llama.forward_step_paged(cfg, params, cur, pool, tables, pos,
                             valid=valid)
    assert counts["plain"] == before


@pytest.mark.parametrize("family", ["llama", "gemma2"])
def test_tick_equals_the_gathered_view_path(family):
    """The routed tick against the same tick through the gathered view
    (an all-true slot mask keeps ``attention_step`` on that path): Gemma-2
    brings the softcap, the query scale and alternating windows (its even
    layers slide, ``window_on`` true and false)."""
    if family == "llama":
        cfg, params = _tiny(llama)
    else:
        cfg, params = _tiny(gemma, attn_logit_softcap=50.0,
                            query_scale=24.0, sliding_window=12,
                            window_pattern="alternate")
    pool, tables, pos, cur = _tick_inputs(cfg)
    ref_pool = {k: v.clone() for k, v in pool.items()}
    got, _ = llama.forward_step_paged(cfg, params, cur, pool, tables, pos)
    valid = torch.ones(3, tables.shape[1] * 8, dtype=torch.bool)
    want, _ = llama.forward_step_paged(cfg, params, cur, ref_pool, tables,
                                       pos, valid=valid)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for k in pool:             # the later layers' writes follow the inputs
        torch.testing.assert_close(pool[k], ref_pool[k], atol=1e-4,
                                   rtol=1e-4)
