"""The port's chunked LM-head losses held against ``kubedl_tpu.ops.loss``
on the CPU: values and the gradients of the hidden states and the head,
with a mask, a softcap, and a sequence that is not a multiple of the
chunk."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.ops import loss as jloss
from kubedl_tpu_torch.ops import loss as tloss

#: float32 on both sides, the same softmax; matmuls and sums taken in
#: another order (values of a few units, gradients of ~1e-2)
ATOL = 2e-5

CASES = {
    "plain": dict(),
    "mask": dict(mask=True),
    "softcap": dict(softcap=5.0),
    "ragged_chunk": dict(s=27, chunk=8, mask=True),
    "ragged_chunk_softcap": dict(s=27, chunk=8, softcap=3.0),
    "one_chunk": dict(chunk=64),
}


def _inputs(seed, b=3, s=24, d=16, vocab=50, mask=False, **_):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d), np.float32)
    w = (rng.standard_normal((d, vocab), np.float32) / 4).astype(np.float32)
    targets = rng.integers(0, vocab, (b, s), dtype=np.int32)
    m = (rng.random((b, s)) > 0.3).astype(np.float32) if mask else None
    cot = rng.standard_normal((b, s), np.float32)
    return x, w, targets, m, cot


def _kw(case):
    c = CASES[case]
    return dict(chunk=c.get("chunk", 8), logit_softcap=c.get("softcap", 0.0))


def _torch_leaves(x, w):
    return (torch.from_numpy(x).requires_grad_(),
            torch.from_numpy(w).requires_grad_())


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_softmax_xent_matches_jax(case):
    x, w, t, m, _ = _inputs(1, **CASES[case])
    kw = _kw(case)
    jm = None if m is None else jnp.asarray(m)
    jval, jgrads = jax.value_and_grad(
        lambda x_, w_: jloss.chunked_softmax_xent(
            x_, w_, jnp.asarray(t), mask=jm, **kw), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _torch_leaves(x, w)
    tval = tloss.chunked_softmax_xent(
        tx, tw, torch.from_numpy(t),
        mask=None if m is None else torch.from_numpy(m), **kw)
    tgrads = torch.autograd.grad(tval, (tx, tw))
    assert tval.dtype == torch.float32 and tval.ndim == 0
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-6,
                               atol=ATOL)
    for g, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_token_nll_matches_jax(case):
    x, w, t, m, cot = _inputs(2, **CASES[case])
    kw = _kw(case)
    jm = None if m is None else jnp.asarray(m)
    rows_cot = cot[:, 0]
    jval, vjp = jax.vjp(
        lambda x_, w_: jloss.chunked_token_nll(
            x_, w_, jnp.asarray(t), mask=jm, **kw),
        jnp.asarray(x), jnp.asarray(w))
    jgrads = vjp(jnp.asarray(rows_cot))
    tx, tw = _torch_leaves(x, w)
    tval = tloss.chunked_token_nll(
        tx, tw, torch.from_numpy(t),
        mask=None if m is None else torch.from_numpy(m), **kw)
    tgrads = torch.autograd.grad(tval, (tx, tw), torch.from_numpy(rows_cot))
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval),
                               rtol=1e-6, atol=ATOL * 10)
    for g, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_token_logps_matches_jax(case):
    x, w, t, _, cot = _inputs(3, **CASES[case])
    kw = _kw(case)
    jval, vjp = jax.vjp(
        lambda x_, w_: jloss.chunked_token_logps(x_, w_, jnp.asarray(t),
                                                 **kw),
        jnp.asarray(x), jnp.asarray(w))
    jgrads = vjp(jnp.asarray(cot))
    tx, tw = _torch_leaves(x, w)
    tval = tloss.chunked_token_logps(tx, tw, torch.from_numpy(t), **kw)
    tgrads = torch.autograd.grad(tval, (tx, tw), torch.from_numpy(cot))
    assert tuple(tval.shape) == t.shape
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval),
                               atol=ATOL)
    for g, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=ATOL)


def test_chunk_logits_are_recomputed_not_saved():
    """Only the chunk's inputs are saved for the backward: no [b, c, V]
    float32 tensor stays alive between the forward and the backward."""
    x, w, t, _, _ = _inputs(4, s=32, vocab=4096)
    tx, tw = _torch_leaves(x, w)
    big = []

    def pack(tensor):
        if tensor.ndim == 3 and tensor.shape[-1] == 4096:
            big.append(tuple(tensor.shape))
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t_: t_):
        loss = tloss.chunked_softmax_xent(tx, tw, torch.from_numpy(t),
                                          chunk=8)
    assert big == []
    loss.backward()
    assert tx.grad is not None and tw.grad is not None
