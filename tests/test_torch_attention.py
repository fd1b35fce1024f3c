"""The PyTorch port's attention held against the JAX package on the CPU.

The same numpy inputs (``numpy.random.default_rng``) go through both.
The flash kernel itself runs only on the card; here its plain version,
``flash_forward_plain``, is held against the TPU kernel run in Pallas
interpret mode, and the kernel wrapper must pick the plain version for
CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubedl_tpu.ops import attention as jattn
from kubedl_tpu_torch.ops import attention as tattn

#: f32 on both sides, same algorithm; sums taken in another order
ATOL = 1e-5


def _qkv(seed, b=1, sq=256, sk=None, nh=2, nkv=None, hd=128):
    rng = np.random.default_rng(seed)
    sk = sq if sk is None else sk
    nkv = nh if nkv is None else nkv
    q = rng.standard_normal((b, sq, nh, hd), np.float32)
    k = rng.standard_normal((b, sk, nkv, hd), np.float32)
    v = rng.standard_normal((b, sk, nkv, hd), np.float32)
    return q, k, v


def _segments(b, s):
    seg = np.zeros((b, s), np.int32)
    seg[:, s // 3:] = 1
    seg[:, (2 * s) // 3:] = 2
    return seg


FLASH_CASES = {
    "causal": dict(causal=True),
    "non_causal": dict(causal=False),
    "gqa": dict(causal=True, nh=4, nkv=2),
    "window": dict(causal=True, window=96),
    "segments": dict(causal=True, segments=True),
    "segments_non_causal": dict(causal=False, segments=True),
    "offsets": dict(causal=True, offsets=(128, 0)),
    "offsets_masked_rows": dict(causal=True, offsets=(0, 128)),
    "sq_gt_sk": dict(causal=True, sq=256, sk=128),
    # Gemma's head dim 256: Gemma-2B's MQA (4 query heads on 1 kv head),
    # Gemma-7B's MHA, and rows that see no key at that width
    "hd256_mqa": dict(causal=True, nh=4, nkv=1, hd=256),
    "hd256_mha": dict(causal=True, nh=2, nkv=2, hd=256),
    "hd256_offsets_masked_rows": dict(causal=True, nh=4, nkv=1, hd=256,
                                      offsets=(0, 128)),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_forward_plain_matches_pallas_interpret(case):
    kw = dict(FLASH_CASES[case])
    causal = kw.pop("causal")
    window = kw.pop("window", 0)
    offsets = kw.pop("offsets", None)
    segments = kw.pop("segments", False)
    q, k, v = _qkv(3, **kw)
    seg = _segments(q.shape[0], q.shape[1]) if segments else None
    j_out, j_lse = jattn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        segment_ids=None if seg is None else jnp.asarray(seg),
        offsets=offsets, window=window, interpret=True)
    t_out, t_lse = tattn.flash_forward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, segment_ids=None if seg is None else torch.from_numpy(seg),
        offsets=offsets, window=window)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=ATOL)


def test_flash_forward_on_cpu_runs_the_plain_version():
    q, k, v = _qkv(4, sq=100, nh=4, nkv=2, hd=64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = tattn.flash_forward.launches
    out, lse = tattn.flash_forward(tq, tk, tv, True)
    ref, ref_lse = tattn.flash_forward_plain(tq, tk, tv, True)
    assert tattn.flash_forward.launches == before   # nothing launched
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_flash_forward_plain_ragged_matches_reference():
    """The kernel takes any sq/sk (the TPU path needed multiples of 128):
    its plain version on a ragged 100-token sequence matches naive
    attention."""
    q, k, v = _qkv(5, sq=100, nh=4, nkv=2, hd=64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, _ = tattn.flash_forward_plain(tq, tk, tv, True)
    ref = tattn.reference_attention(tq, tk, tv, causal=True)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


ATTN_CASES = {
    "causal": dict(causal=True),
    "non_causal": dict(causal=False),
    "gqa": dict(causal=True, nh=4, nkv=2),
    "window": dict(causal=True, window=48),
    "segments": dict(causal=True, segments=True),
    "ragged_block": dict(causal=True, sq=200, block_k=64),
    "gemma2_knobs": dict(causal=True, scale=0.05, logit_softcap=20.0),
    "window_off": dict(causal=True, window=48, window_on=False),
}


@pytest.mark.parametrize("fn", ["chunked_attention", "reference_attention"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_plain_attention_matches_jax(fn, case):
    kw = dict(ATTN_CASES[case])
    opts = {n: kw.pop(n) for n in ("causal", "window", "scale",
                                   "logit_softcap", "window_on")
            if n in kw}
    if fn == "chunked_attention" and "block_k" in kw:
        opts["block_k"] = kw.pop("block_k")
    kw.pop("block_k", None)
    segments = kw.pop("segments", False)
    q, k, v = _qkv(6, hd=32, **{"sq": 128, **kw})
    seg = _segments(q.shape[0], q.shape[1]) if segments else None
    j = getattr(jattn, fn)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=None if seg is None else jnp.asarray(seg), **opts)
    t = getattr(tattn, fn)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        segment_ids=None if seg is None else torch.from_numpy(seg), **opts)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_multi_head_attention_dispatch_on_cpu():
    q, k, v = _qkv(7, sq=64, nh=4, nkv=2, hd=32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    # impl=None on a CPU tensor is the chunked path
    torch.testing.assert_close(
        tattn.multi_head_attention(tq, tk, tv),
        tattn.chunked_attention(tq, tk, tv), atol=0, rtol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.multi_head_attention(tq, tk, tv, impl="kernel")
    with pytest.raises(ValueError, match="not implemented in the kernel"):
        tattn.multi_head_attention(tq, tk, tv, impl="kernel",
                                   logit_softcap=30.0)
    with pytest.raises(ValueError, match="causal"):
        tattn.multi_head_attention(tq, tk, tv, causal=False, window=8)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.multi_head_attention(tq, tk, tv, impl="pallas")


def test_bf16_chunked_matches_jax():
    """bf16 inputs: both upcast to f32 inside and round the output to
    bf16, so they agree to one bf16 ulp at unit scale (2**-8)."""
    q, k, v = _qkv(8, sq=128, nh=4, nkv=2, hd=64)
    j = jattn.chunked_attention(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (q, k, v)))
    t = tattn.chunked_attention(*(torch.from_numpy(x).bfloat16()
                                  for x in (q, k, v)))
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), atol=2 ** -8)
