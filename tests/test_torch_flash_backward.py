"""The port's flash-attention backward held against the JAX package on the
CPU.

The dQ and dK/dV kernels (``csrc/flash_bwd.cu``) run only on the card.
Here their plain versions are held against the TPU kernels run in Pallas
interpret mode (``_flash_backward(..., interpret=True)``) on the same
numpy inputs, with o, lse and dO made on the JAX side; ragged shapes,
which the TPU path does not take, are held against autograd through
naive attention; and the autograd Function (``impl="plain"``) against the
JAX custom_vjp (``impl="pallas_interpret"``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.ops import attention as jattn
from kubedl_tpu_torch.ops import attention as tattn

#: float32 on both sides, the same arithmetic; sums taken in another order
ATOL = 1e-5


def _f32_tol(ref: np.ndarray) -> float:
    """ATOL at unit scale. dK/dV sum up to reps * sq terms and the fully
    masked rows of the offsets case reach |dq| ~ 20, where float32 sums
    taken in another order differ by ~1e-6 of the value: so ATOL scales
    with the largest value once that passes 1."""
    return ATOL * max(1.0, float(np.abs(ref).max()))


#: bf16 outputs: both compute in float32 and round once at the end, so
#: they agree to a few bf16 ulps at the scale of the largest value (an
#: ulp of x is 2**(floor(log2 |x|) - 7))
BF16_ULPS = 4


def _bf16_tol(ref: np.ndarray) -> float:
    top = float(np.abs(ref).max())
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


def _inputs(seed, b=1, sq=256, sk=None, nh=2, nkv=None, hd=128):
    rng = np.random.default_rng(seed)
    sk = sq if sk is None else sk
    nkv = nh if nkv is None else nkv
    q = rng.standard_normal((b, sq, nh, hd), np.float32)
    k = rng.standard_normal((b, sk, nkv, hd), np.float32)
    v = rng.standard_normal((b, sk, nkv, hd), np.float32)
    g = rng.standard_normal((b, sq, nh, hd), np.float32)
    return q, k, v, g


def _segments(b, s):
    seg = np.zeros((b, s), np.int32)
    seg[:, s // 3:] = 1
    seg[:, (2 * s) // 3:] = 2
    return seg


CASES = {
    "causal": dict(causal=True),
    "non_causal": dict(causal=False),
    "gqa_reps2": dict(causal=True, nh=4, nkv=2),
    "gqa_reps4": dict(causal=True, nh=8, nkv=2),
    "mha": dict(causal=True, nh=4, nkv=4),
    "window": dict(causal=True, nh=4, nkv=2, window=96),
    "segments": dict(causal=True, segments=True),
    "offsets": dict(causal=True, offsets=(128, 0)),
    "offsets_masked_rows": dict(causal=True, offsets=(0, 128)),
    "bf16": dict(causal=True, nh=4, nkv=2, dtype="bfloat16"),
    "bf16_window": dict(causal=True, window=64, dtype="bfloat16"),
    # Gemma's head dim 256: Gemma-2B's MQA (4 query heads on 1 kv head),
    # Gemma-7B's MHA, rows that see no key at that width, and the window
    # and segment masks every backward kernel takes there
    "hd256_mqa": dict(causal=True, nh=4, nkv=1, hd=256),
    "hd256_mha": dict(causal=True, nh=2, nkv=2, hd=256),
    "hd256_offsets_masked_rows": dict(causal=True, nh=4, nkv=1, hd=256,
                                      offsets=(0, 128)),
    "hd256_mqa_bf16": dict(causal=True, nh=4, nkv=1, hd=256,
                           dtype="bfloat16"),
    "hd256_window": dict(causal=True, nh=4, nkv=1, hd=256, window=96),
    "hd256_segments": dict(causal=True, nh=2, nkv=1, hd=256,
                           segments=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_backward_plain_matches_pallas_interpret(case):
    kw = dict(CASES[case])
    causal = kw.pop("causal")
    window = kw.pop("window", 0)
    offsets = kw.pop("offsets", None)
    segments = kw.pop("segments", False)
    dtype = kw.pop("dtype", "float32")
    q, k, v, g = _inputs(11, **kw)
    seg = _segments(q.shape[0], q.shape[1]) if segments else None
    jq, jk, jv, jg = (jnp.asarray(x, dtype) for x in (q, k, v, g))
    jseg = None if seg is None else jnp.asarray(seg)
    opts = dict(offsets=offsets, window=window)
    jo, jlse = jattn._flash_forward(jq, jk, jv, causal, segment_ids=jseg,
                                    interpret=True, **opts)
    jgrads = jattn._flash_backward(jq, jk, jv, jo, jlse, jg, causal,
                                   segment_ids=jseg, interpret=True, **opts)

    def to_torch(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            getattr(torch, dtype))

    tgrads = tattn.flash_backward_plain(
        *(to_torch(x) for x in (jq, jk, jv, jo)), to_torch(jlse),
        to_torch(jg), causal,
        segment_ids=None if seg is None else torch.from_numpy(seg), **opts)
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert t.dtype == getattr(torch, dtype), name
        ref = np.asarray(j.astype(jnp.float32))
        tol = _f32_tol(ref) if dtype == "float32" else _bf16_tol(ref)
        np.testing.assert_allclose(t.float().numpy(), ref, atol=tol, rtol=0,
                                   err_msg=f"{case}: {name}")


RAGGED = {
    "ragged_causal": dict(sq=100, nh=4, nkv=2, hd=64),
    "ragged_window": dict(sq=77, nh=4, nkv=1, hd=32, window=20),
    "sq_gt_sk": dict(sq=90, sk=60, nh=4, nkv=2, hd=48),
    "sq_lt_sk": dict(sq=50, sk=130, nh=2, nkv=2, hd=16),
    "segments_non_causal": dict(sq=70, nh=2, hd=8, causal=False,
                                segments=True),
}


@pytest.mark.parametrize("case", sorted(RAGGED))
def test_flash_backward_plain_ragged_matches_autograd(case):
    """Any sq/sk (the TPU path needs multiples of 128): the plain backward
    equals autograd through naive float32 attention."""
    kw = dict(RAGGED[case])
    causal = kw.pop("causal", True)
    window = kw.pop("window", 0)
    segments = kw.pop("segments", False)
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(12, b=2, **kw))
    seg = (torch.from_numpy(_segments(2, q.shape[1])) if segments else None)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tattn.reference_attention(*leaves, causal=causal, window=window,
                                    segment_ids=seg)
    want = torch.autograd.grad(ref, leaves, g)
    out, lse = tattn.flash_forward_plain(q, k, v, causal, segment_ids=seg,
                                         window=window)
    got = tattn.flash_backward_plain(q, k, v, out, lse, g, causal,
                                     segment_ids=seg, window=window)
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(t, w, atol=ATOL, rtol=0, msg=name)


FN_CASES = {
    "causal_gqa": dict(nh=4, nkv=2),
    "window": dict(nh=4, nkv=2, window=64),
    "segments": dict(segments=True),
    "non_causal": dict(causal=False),
    "hd256_mqa": dict(nh=4, nkv=1, hd=256),
    "hd256_mha": dict(hd=256),
}


@pytest.mark.parametrize("case", sorted(FN_CASES))
def test_autograd_function_matches_jax_custom_vjp(case):
    """``impl="plain"`` (the Function with the plain versions) against
    ``impl="pallas_interpret"`` (the JAX custom_vjp, TPU kernels in
    interpret mode): output and all three gradients, dk/dv in kv-head
    space."""
    kw = dict(FN_CASES[case])
    causal = kw.pop("causal", True)
    window = kw.pop("window", 0)
    segments = kw.pop("segments", False)
    q, k, v, g = _inputs(13, **{"sq": 128, "hd": 128, **kw})
    seg = _segments(1, 128) if segments else None

    def jfn(q_, k_, v_):
        return jattn.multi_head_attention(
            q_, k_, v_, causal=causal, window=window,
            segment_ids=None if seg is None else jnp.asarray(seg),
            impl="pallas_interpret")

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.multi_head_attention(
        *leaves, causal=causal, window=window,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        impl="plain")
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    for name, t, j in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   err_msg=name)


def test_flash_bwd_chunked_env_routes_through_chunked(monkeypatch):
    """``KUBEDL_FLASH_BWD=chunked`` is the explicit opt-in to recompute the
    backward through ``chunked_attention``; the gradients agree."""
    q, k, v, g = (torch.from_numpy(x)
                  for x in _inputs(14, sq=96, nh=4, nkv=2, hd=32))
    calls = []
    real = tattn.chunked_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def grads():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = tattn.multi_head_attention(*leaves, impl="plain")
        return torch.autograd.grad(out, leaves, g)

    want = grads()
    monkeypatch.setattr(tattn, "chunked_attention", counting)
    assert not calls
    monkeypatch.setenv("KUBEDL_FLASH_BWD", "chunked")
    got = grads()
    assert len(calls) == 1
    for t, w in zip(got, want):
        torch.testing.assert_close(t, w, atol=ATOL, rtol=0)


def test_backward_wrappers_on_cpu_run_the_plain_versions():
    q, k, v, g = (torch.from_numpy(x)
                  for x in _inputs(15, sq=64, nh=4, nkv=2, hd=32))
    out, lse = tattn.flash_forward(q, k, v, True)
    before = (tattn.flash_dq.launches, tattn.flash_dkv.launches)
    got = tattn.flash_backward(q, k, v, out, lse, g, True)
    assert (tattn.flash_dq.launches, tattn.flash_dkv.launches) == before
    want = tattn.flash_backward_plain(q, k, v, out, lse, g, True)
    for t, w in zip(got, want):
        assert torch.equal(t, w)


def test_plain_impl_refuses_what_it_does_not_take():
    q, k, v, _ = (torch.from_numpy(x)
                  for x in _inputs(16, sq=16, nh=2, hd=8))
    with pytest.raises(ValueError, match="not implemented in the kernels"):
        tattn.multi_head_attention(q, k, v, impl="plain", scale=0.1)
    # without autograd recording the Function is not entered
    with torch.no_grad():
        out = tattn.multi_head_attention(q, k, v, impl="plain")
    torch.testing.assert_close(out, tattn.flash_forward_plain(q, k, v,
                                                              True)[0])
