"""The port's flash-attention kernel on the card, against its plain
PyTorch version. A CUDA kernel has no CPU mode, so without a card these
tests skip. On the card (no JAX there, hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py
"""

import pytest
import torch

from kubedl_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

#: bf16 out: one bf16 ulp at unit scale (the two sum in other orders
#: before rounding); f32 out to its last digits; lse is f32 on both sides
ATOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
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
