"""The port's ring attention held against the JAX package's on the CPU.

No process is spawned: ``parallel.ring.ring_schedule`` runs every ``cp``
rank's ring in one process, in ring order, through the same per-block
code the ranks run, and the JAX ``ring_attention`` runs on ``cp`` devices
of the fake CPU mesh (``tests/conftest.py``). The same numpy q, k, v and
output cotangent go through both; the forward and the q/k/v gradients
(the JAX vjp against the port's autograd) are held within 1e-5 of the
largest value in float32.

Routes: ``flash`` runs the port's plain versions of K1-K3 with global
offsets against the TPU kernels in Pallas interpret mode (JAX's
``impl="flash"`` off the TPU; its blocks are 128 rows, so each shard is
128 long); ``dense`` runs the float32 online-softmax rings, with and
without a sliding window over global positions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.parallel import mesh as jmesh
from kubedl_tpu.parallel import ring as jring
from kubedl_tpu_torch.ops import attention as tattn
from kubedl_tpu_torch.parallel import ring as tring

REL = 1e-5

#: name -> (cp, causal, nh, nkv, impl, window, shard length)
CASES = {
    **{f"flash-cp{cp}-{'causal' if causal else 'full'}-{kind}":
       (cp, causal, 4, nkv, "flash", 0, 128)
       for cp in (2, 4) for causal in (True, False)
       for kind, nkv in (("gqa", 2), ("mqa", 1))},
    **{f"dense-cp{cp}-{name}": (cp, causal, 4, nkv, "dense", window, 32)
       for cp in (2, 4)
       for name, causal, nkv, window in (("causal-gqa", True, 2, 0),
                                         ("full-mqa", False, 1, 0),
                                         ("window24-gqa", True, 2, 24),
                                         ("window40-mqa", True, 1, 40))},
}


def _inputs(cp, nh, nkv, shard, hd=16, b=2, seed=0):
    rng = np.random.default_rng(seed)
    s = cp * shard
    q = rng.standard_normal((b, s, nh, hd), np.float32)
    k = rng.standard_normal((b, s, nkv, hd), np.float32)
    v = rng.standard_normal((b, s, nkv, hd), np.float32)
    g = rng.standard_normal((b, s, nh, hd), np.float32)
    return q, k, v, g


def _jax(cp, causal, impl, window, q, k, v, g):
    mesh = jmesh.build_mesh(jmesh.MeshConfig(dp=1, fsdp=1, cp=cp),
                            devices=jax.devices()[:cp])

    def fn(q_, k_, v_):
        return jring.ring_attention(mesh, q_, k_, v_, causal, impl=impl,
                                    window=window)
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(g)))]


def _shards(x, cp, grad=True):
    return [t.clone().requires_grad_(grad)
            for t in torch.from_numpy(x).chunk(cp, dim=1)]


def _port(cp, causal, impl, window, q, k, v, g):
    qs, ks, vs = (_shards(x, cp) for x in (q, k, v))
    outs = tring.ring_schedule(qs, ks, vs, causal=causal, impl=impl,
                               window=window)
    grads = torch.autograd.grad(outs, qs + ks + vs,
                                grad_outputs=_shards(g, cp, False))
    cat = [torch.cat(outs, 1)] + [torch.cat(grads[i * cp:(i + 1) * cp], 1)
                                  for i in range(3)]
    return [t.detach().numpy() for t in cat]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=REL * float(np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_the_jax_ring(name):
    cp, causal, nh, nkv, impl, window, shard = CASES[name]
    inputs = _inputs(cp, nh, nkv, shard)
    want = _jax(cp, causal, impl, window, *inputs)
    got = _port(cp, causal, impl, window, *inputs)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        _close(a, b, what)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_ring_matches_unsharded_attention(impl):
    """The sharded ring against the port's own unsharded attention (the
    plain flash Function; autograd through naive attention)."""
    q, k, v, g = _inputs(4, 4, 2, 32, seed=3)
    got = _port(4, True, impl, 0, q, k, v, g)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.multi_head_attention(qt, kt, vt, causal=True, impl="plain")
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    for what, a, b in zip(("out", "dq", "dk", "dv"), got,
                          [out.detach().numpy()] + [x.numpy() for x in grads]):
        _close(a, b, what)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_blocks_above_the_diagonal_weigh_nothing(impl):
    """Causal rank 0's ring meets blocks 1..3 wholly above its diagonal:
    they run, as in the JAX ring, and change nothing. Its output and dQ
    are bit for bit the same whatever those blocks hold, and no gradient
    of its rows reaches them."""
    cp = 4
    q, k, v, g = _inputs(cp, 4, 2, 32, seed=5)
    k2, v2 = k.copy(), v.copy()
    k2[:, 32:] *= -3.0
    v2[:, 32:] += 7.0

    def rank0(k_, v_):
        qs, ks, vs = (_shards(x, cp) for x in (q, k_, v_))
        outs = tring.ring_schedule(qs, ks, vs, causal=True, impl=impl)
        dos = [torch.from_numpy(g[:, :32]).clone()] + \
            [torch.zeros_like(o) for o in outs[1:]]
        grads = torch.autograd.grad(outs, [qs[0]] + ks + vs,
                                    grad_outputs=dos)
        return outs[0].detach(), grads
    out_a, grads_a = rank0(k, v)
    out_b, grads_b = rank0(k2, v2)
    torch.testing.assert_close(out_a, out_b, rtol=0, atol=0)
    torch.testing.assert_close(grads_a[0], grads_b[0], rtol=0, atol=0)
    for blk in (1, 2, 3):            # dK and dV of the blocks above
        for g_ in (grads_a[1 + blk], grads_a[1 + cp + blk]):
            assert float(g_.abs().max()) == 0.0


def test_flash_refuses_a_window_and_auto_picks_dense_on_the_cpu():
    q, k, v, _ = _inputs(2, 4, 2, 16)
    qs, ks, vs = (_shards(x, 2) for x in (q, k, v))
    with pytest.raises(ValueError, match="ring flash does not support"):
        tring.ring_schedule(qs, ks, vs, impl="flash", window=8)
    assert tring._resolve("auto", qs[0], ks[0], 0) == "dense"
    auto = tring.ring_schedule(qs, ks, vs, impl="auto")
    dense = tring.ring_schedule(qs, ks, vs, impl="dense")
    for a, b in zip(auto, dense):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_the_chunked_backward_opt_in_is_refused_where_it_cannot_apply(
        monkeypatch):
    """``KUBEDL_FLASH_BWD=chunked`` recomputes a whole sequence's
    attention. The flash ring's backward (K2/K3 per block at global
    offsets) and a rank's rows against the whole sequence's keys
    (``offsets``, ``kv_segment_ids``) cannot take it: each raises naming
    the opt-in instead of running the kernels' backward unannounced.
    Without offsets the opt-in still recomputes (the result is chunked's
    gradient)."""
    monkeypatch.setenv("KUBEDL_FLASH_BWD", "chunked")
    q, k, v, g = _inputs(2, 4, 2, 16, seed=3)
    qs, ks, vs = (_shards(x, 2) for x in (q, k, v))
    outs = tring.ring_schedule(qs, ks, vs, impl="flash")
    with pytest.raises(ValueError, match="KUBEDL_FLASH_BWD=chunked"):
        torch.autograd.grad(outs, qs + ks + vs,
                            [torch.from_numpy(x).clone()
                             for x in np.split(g, 2, axis=1)])
    qt, kt, vt = (torch.from_numpy(x).clone().requires_grad_()
                  for x in (q, k, v))
    rows = qt[:, 16:]
    seg = torch.zeros(q.shape[:2], dtype=torch.int32)
    for kw in ({"offsets": (16, 0)},
               {"offsets": (16, 0), "kv_segment_ids": seg,
                "segment_ids": seg[:, 16:]}):
        out = tattn.flash_attention(rows, kt, vt, causal=True, **kw)
        with pytest.raises(ValueError, match="KUBEDL_FLASH_BWD=chunked"):
            torch.autograd.grad(out, (qt, kt, vt),
                                torch.from_numpy(g[:, 16:]).clone())
    out = tattn.flash_attention(qt, kt, vt, causal=True)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    qc, kc, vc = (t.detach().clone().requires_grad_() for t in (qt, kt, vt))
    want = torch.autograd.grad(
        tattn.chunked_attention(qc, kc, vc, causal=True), (qc, kc, vc),
        torch.from_numpy(g))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
