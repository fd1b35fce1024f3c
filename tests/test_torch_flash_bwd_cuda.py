"""The port's flash-attention backward kernels on the card, against their
plain PyTorch versions, and the gradient of a llama attention block
through them. Both routes are held: the tensor-core kernels
(``flash_bwd_sm90.cu``, bf16/f16 at head dims 64 and 128) and the general
ones (``flash_bwd.cu``). A CUDA kernel has no CPU mode, so without a card these
tests skip. On the card (no JAX there, hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_flash_bwd_cuda.py
"""

import dataclasses

import pytest
import torch

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

#: the kernel and the plain version compute in float32 and round once at
#: the end, summing in other orders: half-precision outputs agree to a
#: few ulps at the scale of the largest value (ulp ratio 2**-7 for bf16,
#: 2**-10 for f16); f32 to 1e-5 of that scale (sums of up to reps * s
#: terms)
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
ULPS = 4
F32_TOL = 1e-5
#: causal gradients are large at the first rows and keys and small in the
#: bulk, where the bound above sits near a typical value; the norm-wise
#: relative error cannot hide there. Rounding once, the two sides differ
#: by at most one rounding (half an ulp ratio) where they differ: the
#: bound is twice that, and 1e-5 for f32's reordered sums
NORM_REL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
            torch.float32: 1e-5}


def _tol(ref: torch.Tensor) -> float:
    top = max(float(ref.detach().float().abs().max()), 1.0)
    if ref.dtype == torch.float32:
        return F32_TOL * top
    return ULPS * ULP[ref.dtype] * top


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CASES = {
    "causal_gqa": dict(),
    "non_causal": dict(causal=False),
    "mha": dict(nkv=8),
    "reps4": dict(nh=8, nkv=2),
    "ragged": dict(sq=77, sk=77),
    "sq_gt_sk": dict(sq=160, sk=96),
    "sq_lt_sk": dict(sq=70, sk=150),
    "window": dict(window=40),
    "segments": dict(segments=True),
    "offsets": dict(offsets=(64, 0)),
    "offsets_masked_rows": dict(offsets=(0, 64)),
    "float32": dict(dtype=torch.float32),
    "float16": dict(dtype=torch.float16),
    "hd_64": dict(hd=64),
    "hd_256": dict(hd=256),
    "hd_80_padded": dict(hd=80),
    "strided_do": dict(strided_do=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_kernels_match_plain(card, case):
    kw = {"b": 2, "sq": 130, "sk": 130, "nh": 8, "nkv": 4, "hd": 128,
          "dtype": torch.bfloat16, "causal": True, **CASES[case]}
    g = torch.Generator(device=card).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=card).to(kw["dtype"])

    b, sq, sk, nh, nkv, hd = (kw[n] for n in ("b", "sq", "sk", "nh", "nkv",
                                               "hd"))
    q, k, v = randn(b, sq, nh, hd), randn(b, sk, nkv, hd), randn(b, sk, nkv,
                                                                  hd)
    do = randn(b, sq, nh, hd)
    if kw.get("strided_do"):
        # dO as the backward of a reshape hands it over: not contiguous
        do = randn(b, nh, sq, hd).transpose(1, 2)
        assert not do.is_contiguous()
    seg = None
    if kw.get("segments"):
        seg = (torch.arange(sq, device=card) >= sq // 2).int()
        seg = seg[None].repeat(b, 1)
    opts = dict(segment_ids=seg, offsets=kw.get("offsets"),
                window=kw.get("window", 0))
    o, lse = attn.flash_forward(q, k, v, kw["causal"], **opts)
    before = (attn.flash_dq.launches, attn.flash_dkv.launches)
    got = attn.flash_backward(q, k, v, o, lse, do, kw["causal"], **opts)
    torch.cuda.synchronize()
    assert (attn.flash_dq.launches, attn.flash_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = attn.flash_backward_plain(q, k, v, o, lse, do, kw["causal"],
                                     **opts)
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        assert t.dtype == w.dtype and t.shape == w.shape, name
        assert bool(torch.isfinite(t.float()).all()), name
        torch.testing.assert_close(t.float(), w.float(), atol=_tol(w),
                                   rtol=0, msg=f"{case}: {name}")
        rel = (t.float() - w.float()).norm() / w.float().norm()
        assert rel <= NORM_REL[w.dtype], f"{case}: {name} norm-wise {rel}"


#: tensor-core-route cases at the tile edges (K2: 128 q rows x 64 keys,
#: K3: 128 keys x 64 q rows), on Llama-3-8B's GQA ratio of 4
SM90_CASES = {
    "ragged_130": dict(sq=130, sk=130),
    "ragged_300": dict(sq=300, sk=300),
    "sq_gt_sk": dict(sq=300, sk=190),
    "offsets_q": dict(sq=320, sk=320, offsets=(256, 0)),
    "offsets_k": dict(sq=320, sk=320, offsets=(0, 256)),
    "window_128": dict(sq=384, sk=384, window=128),
    "segments": dict(sq=300, sk=300, segments=True),
    "hd_64": dict(hd=64, sq=300, sk=300),
    "float16": dict(dtype=torch.float16, sq=300, sk=300),
    "train_b1": dict(b=1, sq=2048, sk=2048, nh=32, nkv=8),
}


@pytest.mark.parametrize("case", sorted(SM90_CASES))
def test_tensor_core_route_at_tile_edges(card, case):
    kw = {"b": 2, "nh": 8, "nkv": 2, "hd": 128, "dtype": torch.bfloat16,
          **SM90_CASES[case]}
    b, sq, sk, nh, nkv, hd = (kw[n] for n in ("b", "sq", "sk", "nh", "nkv",
                                               "hd"))
    assert attn.flash_bwd_route(kw["dtype"], hd) == "sm90"
    g = torch.Generator(device=card).manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=card).to(kw["dtype"])

    q, k, v = randn(b, sq, nh, hd), randn(b, sk, nkv, hd), randn(b, sk, nkv,
                                                                  hd)
    do = randn(b, sq, nh, hd)
    seg = None
    if kw.get("segments"):
        pos = torch.arange(sq, device=card)
        seg = torch.stack([(pos >= 97 + 13 * i).int() + (pos >= 201 - i).int()
                           for i in range(b)])
    opts = dict(segment_ids=seg, offsets=kw.get("offsets"),
                window=kw.get("window", 0))
    o, lse = attn.flash_forward(q, k, v, True, **opts)
    before = (dict(attn.flash_dq.launches_by_route),
              dict(attn.flash_dkv.launches_by_route))
    got = attn.flash_backward(q, k, v, o, lse, do, True, **opts)
    torch.cuda.synchronize()
    assert attn.flash_dq.launches_by_route["sm90"] == before[0]["sm90"] + 1
    assert attn.flash_dkv.launches_by_route["sm90"] == before[1]["sm90"] + 1
    want = attn.flash_backward_plain(q, k, v, o, lse, do, True, **opts)
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        assert t.dtype == w.dtype and t.shape == w.shape, name
        assert bool(torch.isfinite(t.float()).all()), name
        torch.testing.assert_close(t.float(), w.float(), atol=_tol(w),
                                   rtol=0, msg=f"{case}: {name}")
        rel = (t.float() - w.float()).norm() / w.float().norm()
        assert rel <= NORM_REL[w.dtype], f"{case}: {name} norm-wise {rel}"


def test_tensor_core_route_refuses_what_tma_cannot_load(card):
    """TMA takes 16-byte aligned bases and strides: a q that starts one
    element into its storage is refused by name, not read wrongly."""
    q = torch.randn(1, 64, 2, 64, device=card).bfloat16()
    o, lse = attn.flash_forward(q, q, q, True)
    delta = attn.flash_delta(o, q)
    shifted = torch.randn(1 * 64 * 2 * 64 + 1, device=card).bfloat16()[1:]
    shifted = shifted.view(1, 64, 2, 64)
    with pytest.raises(ValueError, match="TMA"):
        attn.flash_dq(shifted, q, q, q, lse, delta, True)


def _block_grads(cfg, x, lp, cos, sin, impl):
    """x and every weight of one attention block with ``impl``'s
    attention: (output, {name: grad})."""
    real = llama.multi_head_attention
    leaves = {"x": x.clone().requires_grad_(),
              **{k: w.clone().requires_grad_() for k, w in lp.items()}}
    llama.multi_head_attention = (
        lambda *a, **kw: attn.multi_head_attention(*a, impl=impl, **kw))
    try:
        out = llama.attention_block(cfg, leaves["x"],
                                    {k: leaves[k] for k in lp}, cos, sin,
                                    None)
    finally:
        llama.multi_head_attention = real
    cot = torch.randn(out.shape, generator=torch.Generator(
        device=x.device).manual_seed(3), device=x.device).to(out.dtype)
    grads = torch.autograd.grad(out, list(leaves.values()), cot,
                                allow_unused=True)
    return out, dict(zip(leaves, grads))


def test_attention_block_gradients_reach_the_projections(card):
    """The repaired cut gradient: on the card the flash kernel's output
    is part of the autograd graph, so wq/wk/wv get gradients, equal to
    those through the differentiable chunked path."""
    cfg = dataclasses.replace(llama.tiny(vocab=256, seq=256), d_model=256,
                              n_heads=2, n_kv_heads=1, dtype="float32")
    params = llama.init_params(cfg, torch.Generator(device=card)
                               .manual_seed(0), device=card)
    lp = {k: v.detach() for k, v in llama.layer_params(params, 0).items()}
    x = torch.randn(2, 96, cfg.d_model, device=card,
                    generator=torch.Generator(device=card).manual_seed(2))
    cos, sin = llama.rope_frequencies(cfg, torch.arange(96, device=card))
    before = (attn.flash_forward.launches, attn.flash_dq.launches,
              attn.flash_dkv.launches)
    out, got = _block_grads(cfg, x, lp, cos, sin, "kernel")
    assert (attn.flash_forward.launches, attn.flash_dq.launches,
            attn.flash_dkv.launches) == tuple(n + 1 for n in before)
    ref_out, want = _block_grads(cfg, x, lp, cos, sin, "chunked")
    torch.testing.assert_close(out, ref_out, atol=_tol(ref_out), rtol=0)
    for name in ("wq", "wk", "wv", "wo", "attn_norm", "x"):
        assert got[name] is not None, name
        torch.testing.assert_close(got[name], want[name],
                                   atol=_tol(want[name]), rtol=0, msg=name)


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.randn(1, 16, 2, 64, device=card)
    o, lse = attn.flash_forward(q, q, q, True)
    delta = attn.flash_delta(o, q)
    with pytest.raises(ValueError, match="lse"):
        attn.flash_dq(q, q, q, q, lse[:1], delta, True)
    with pytest.raises(ValueError, match="dO"):
        attn.flash_dkv(q, q, q, q.half(), lse, delta, True)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.randn(1, 8, 2, 300, device=card)
        attn.flash_dq(big, big, big, big, lse, delta, True)
