"""The port's flash-attention forward kernels on the card, against their
plain PyTorch version. Both routes are held: the tensor-core kernel
(``flash_fwd_sm90.cu``, bf16/f16 at head dims 64 and 128) and the general
one (``flash_fwd.cu``). A CUDA kernel has no CPU mode, so without a card
these tests skip. On the card (no JAX there, hence no conftest; ``-x``,
since a fault poisons the CUDA context for every later test):

    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py -x
"""

import pytest
import torch

from kubedl_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

#: bf16 out: one bf16 ulp at unit scale (the two sum in other orders
#: before rounding, and the sm90 route rounds P to bf16 before P.V); f16
#: likewise at f16's 8x finer ulp; f32 out to its last digits; lse is f32
#: on both sides
ATOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 2e-5}
LSE_ATOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CASES = {
    "causal_gqa": dict(),
    "non_causal": dict(causal=False),
    "ragged": dict(sq=77, sk=77),
    "sq_gt_sk": dict(sq=160, sk=96),
    "window": dict(window=40),
    "segments": dict(segments=True),
    "offsets_masked_rows": dict(offsets=(0, 64)),
    "float32": dict(dtype=torch.float32),
    "hd_64": dict(hd=64),
    "hd_256": dict(hd=256),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(card, case):
    kw = {"b": 2, "sq": 130, "sk": 130, "nh": 8, "nkv": 2, "hd": 128,
          "dtype": torch.bfloat16, "causal": True, **CASES[case]}
    g = torch.Generator(device=card).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=card).to(kw["dtype"])

    q = randn(kw["b"], kw["sq"], kw["nh"], kw["hd"])
    k = randn(kw["b"], kw["sk"], kw["nkv"], kw["hd"])
    v = randn(kw["b"], kw["sk"], kw["nkv"], kw["hd"])
    seg = None
    if kw.get("segments"):
        seg = (torch.arange(kw["sq"], device=card) >= kw["sq"] // 2).int()
        seg = seg[None].repeat(kw["b"], 1)
    opts = dict(segment_ids=seg, offsets=kw.get("offsets"),
                window=kw.get("window", 0))
    before = attn.flash_forward.launches
    out, lse = attn.flash_forward(q, k, v, kw["causal"], **opts)
    torch.cuda.synchronize()
    assert attn.flash_forward.launches == before + 1
    ref, ref_lse = attn.flash_forward_plain(q, k, v, kw["causal"], **opts)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=ATOL[kw["dtype"]], rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


def test_multi_head_attention_launches_the_kernel(card):
    q = torch.randn(1, 64, 4, 128, device=card, dtype=torch.bfloat16)
    k = torch.randn(1, 64, 2, 128, device=card, dtype=torch.bfloat16)
    before = attn.flash_forward.launches
    out = attn.multi_head_attention(q, k, k)
    assert attn.flash_forward.launches == before + 1
    # the Gemma-2 knobs still take the chunked path
    attn.multi_head_attention(q, k, k, logit_softcap=30.0)
    assert attn.flash_forward.launches == before + 1
    torch.testing.assert_close(
        out.float(), attn.chunked_attention(q, k, k).float(),
        atol=ATOL[torch.bfloat16], rtol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    q = torch.randn(1, 8, 2, 300, device=card)
    with pytest.raises(ValueError, match="head dim"):
        attn.flash_forward(q, q, q, True)
    q = torch.randn(1, 8, 2, 64, device=card, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32/bfloat16/float16"):
        attn.flash_forward(q, q, q, True)


#: tensor-core-route cases at the tile edges (128 q rows per block, 64 per
#: warpgroup, 128 keys per K/V tile), on Llama-3-8B's GQA ratio of 4
SM90_CASES = {
    **{f"s{n}": dict(sq=n, sk=n) for n in (1, 64, 127, 128, 129, 257)},
    "sq512_sk256": dict(sq=512, sk=256),
    "sq96_sk160": dict(sq=96, sk=160),
    "non_causal": dict(sq=300, sk=200, causal=False),
    "float16": dict(sq=300, sk=300, dtype=torch.float16),
    "hd_64": dict(sq=300, sk=300, hd=64),
    "window_40": dict(sq=384, sk=384, window=40),
    "window_128": dict(sq=384, sk=384, window=128),
    "segments": dict(sq=300, sk=300, segments=True),
    "offsets_q": dict(sq=320, sk=320, offsets=(256, 0)),
    "offsets_k": dict(sq=320, sk=320, offsets=(0, 64)),
    "mha": dict(sq=300, sk=300, nkv=8),
    "heads_transposed": dict(sq=300, sk=300, transposed=True),
}


@pytest.mark.parametrize("case", sorted(SM90_CASES))
def test_tensor_core_route_at_tile_edges(card, case):
    kw = {"b": 2, "nh": 8, "nkv": 2, "hd": 128, "dtype": torch.bfloat16,
          "causal": True, **SM90_CASES[case]}
    b, sq, sk, nh, nkv, hd = (kw[n] for n in ("b", "sq", "sk", "nh", "nkv",
                                               "hd"))
    assert attn.flash_fwd_route(kw["dtype"], hd) == "sm90"
    g = torch.Generator(device=card).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=card).to(kw["dtype"])

    if kw.get("transposed"):
        # heads before the sequence in memory, as a [b, h, s, d] tensor
        # viewed as [b, s, h, d]
        q = randn(b, nh, sq, hd).transpose(1, 2)
        k, v = (randn(b, nkv, sk, hd).transpose(1, 2) for _ in range(2))
        assert not q.is_contiguous()
    else:
        q, k, v = randn(b, sq, nh, hd), randn(b, sk, nkv, hd), randn(
            b, sk, nkv, hd)
    seg = None
    if kw.get("segments"):
        # boundaries off the 64- and 128-row tile edges, per row
        pos = torch.arange(sq, device=card)
        seg = torch.stack([(pos >= 97 + 13 * i).int() + (pos >= 201 - i).int()
                           for i in range(b)])
    opts = dict(segment_ids=seg, offsets=kw.get("offsets"),
                window=kw.get("window", 0))
    before = dict(attn.flash_forward.launches_by_route)
    out, lse = attn.flash_forward(q, k, v, kw["causal"], **opts)
    torch.cuda.synchronize()
    assert attn.flash_forward.launches_by_route == {
        "sm90": before["sm90"] + 1, "simt": before["simt"]}
    ref, ref_lse = attn.flash_forward_plain(q, k, v, kw["causal"], **opts)
    assert out.dtype == q.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=ATOL[kw["dtype"]], rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


def test_tensor_core_route_refuses_what_tma_cannot_load(card):
    """TMA takes 16-byte aligned bases and strides: a q that starts one
    element into its storage is refused by name, not read wrongly."""
    k = torch.randn(1, 64, 2, 64, device=card).bfloat16()
    shifted = torch.randn(1 * 64 * 2 * 64 + 1, device=card).bfloat16()[1:]
    shifted = shifted.view(1, 64, 2, 64)
    before = dict(attn.flash_forward.launches_by_route)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attn.flash_forward(shifted, k, k, True)
    assert attn.flash_forward.launches_by_route == before
