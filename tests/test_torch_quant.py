"""Weight-only int8/int4 quantization in the port, held against the JAX
package on the CPU.

Quantized trees never cross between the packages: both quantize the same
numpy weights, and the results must be bit-identical (``q``, ``packed``,
``scale``, ``group``, the group fallback). The engines then serve the
same JAX-made artifact quantized on each side: greedy tokens identical,
log-probabilities within 1e-4, in the continuous engine (paged and dense),
the static engine, and speculative lanes over a quantized draft."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.ops import quant as jquant
from kubedl_tpu.serving import batching as jbatching
from kubedl_tpu.serving import engine as jengine
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.ops import quant as tquant
from kubedl_tpu_torch.serving import batching as tbatching
from kubedl_tpu_torch.serving import engine as tengine

#: float32 on both sides; the two frameworks sum in other orders
LOGPROB_ATOL = 1e-4
#: the shapes quantized: one matrix, a layer stack, two leading axes
SHAPES = {"matrix": (64, 16), "stacked": (3, 64, 32),
          "two_lead_axes": (2, 2, 128, 8)}
#: int4 groups: the default, a finer one, and one that does not divide the
#: in-dim (falls back to one group per tensor)
GROUPS = (64, 32, 48)


def _weights(shape, seed=0):
    """Gaussian weights with adversarial output channels: all zeros, an
    amax below 1e-8, values on the int8 grid (±127 included), values on
    the int4 grid (±7 included), and a channel of half-way points."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    n_in = shape[-2]
    w[..., 0] = 0.0
    w[..., 1] = 1e-9 * rng.normal(size=shape[:-1])
    w[..., 2] = rng.integers(-127, 128, shape[:-1]) * 0.01
    w[..., 2, 2] = 1.27
    w[..., 3] = rng.integers(-7, 8, shape[:-1]) * 0.25
    w[..., 3, 3] = -1.75
    w[..., 4] = (np.arange(n_in) % 15 - 7 + 0.5) / 7.5
    return w


def _same(a, b, what):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype, what
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_quantize_int8_is_bit_identical(shape):
    w = _weights(SHAPES[shape])
    want = jquant.quantize_int8(jnp.asarray(w))
    got = tquant.quantize_int8(torch.from_numpy(w))
    _same(want.q, got.q, "q")
    _same(want.scale, got.scale, "scale")
    assert got.shape == want.shape and got.nbytes == want.nbytes


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_quantize_int4_is_bit_identical(shape, group):
    w = _weights(SHAPES[shape], seed=1)
    want = jquant.quantize_int4(jnp.asarray(w), group=group)
    got = tquant.quantize_int4(torch.from_numpy(w), group=group)
    assert got.group == want.group
    if SHAPES[shape][-2] % group:
        assert got.group == SHAPES[shape][-2]          # the fallback
    _same(want.packed, got.packed, "packed")
    _same(want.scale, got.scale, "scale")
    assert got.shape == want.shape and got.nbytes == want.nbytes


def test_int4_nibbles_wrap_and_sign_extend_as_jax():
    """Every packed byte the two nibbles can make: the unpack's shifts on
    int8 (the low nibble's sign extension, the high nibble's arithmetic
    shift) give JAX's values."""
    lo, hi = np.meshgrid(np.arange(-7, 8), np.arange(-7, 8))
    grid = np.stack([lo.ravel(), hi.ravel()], axis=1).reshape(-1, 1)
    w = np.repeat(grid.astype(np.float32), 3, axis=1)     # [450, 3]
    w[0, :] = 7.0                                          # amax = 7
    want = jquant.quantize_int4(jnp.asarray(w), group=450)
    got = tquant.quantize_int4(torch.from_numpy(w), group=450)
    _same(want.packed, got.packed, "packed")
    np.testing.assert_array_equal(
        tquant.to_dense(got, torch.float32).numpy(), w)
    _same(jquant._unpack_int4(want, jnp.float32),
          tquant._unpack_int4(got, torch.float32), "unpacked")


def test_int4_odd_in_dim_raises():
    with pytest.raises(ValueError, match="even in-dim"):
        tquant.quantize_int4(torch.zeros(7, 4))


#: to_dense and mm against JAX: float32 to 1e-6 relative; bf16 within 4
#: ulps (2**-7 relative each) of the result's scale
TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "bfloat16": dict(rtol=4 * 2.0 ** -7, atol=4 * 2.0 ** -7)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_to_dense_and_mm_match_jax(mode, dtype):
    w = _weights((128, 48), seed=2)
    x = np.random.default_rng(3).normal(size=(5, 128)).astype(np.float32)
    jq = getattr(jquant, f"quantize_{mode}")(jnp.asarray(w))
    tq = getattr(tquant, f"quantize_{mode}")(torch.from_numpy(w))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    np.testing.assert_allclose(
        tquant.to_dense(tq, tdt).float().numpy(),
        np.asarray(jquant.to_dense(jq, jdt), np.float32), **TOL[dtype])
    want = np.asarray(jquant.mm(jnp.asarray(x, jdt), jq), np.float32)
    got = tquant.mm(torch.from_numpy(x).to(tdt), tq).float().numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=TOL[dtype]["rtol"],
                               atol=TOL[dtype]["atol"] * scale)
    # a dense weight passes through both dispatches unchanged
    np.testing.assert_allclose(
        tquant.mm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jquant.mm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5,
        atol=1e-5)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A JAX-made float32 target (``llama.tiny``) and a 1-layer draft,
    loaded by the port."""
    root = tmp_path_factory.mktemp("quant")
    cfg = dataclasses.replace(jllama.tiny(vocab=128), dtype=jnp.float32)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    dcfg = dataclasses.replace(jllama.tiny(vocab=128), d_model=64,
                               n_layers=1, n_heads=2, n_kv_heads=2,
                               d_ff=128, dtype=jnp.float32)
    dparams = jllama.init_params(dcfg, jax.random.PRNGKey(1))
    jio.save_model(cfg, params, str(root / "target"))
    jio.save_model(dcfg, dparams, str(root / "draft"))
    return ((cfg, params, dcfg, dparams),
            tio.load_model(str(root / "target"), device="cpu")
            + tio.load_model(str(root / "draft"), device="cpu"))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_and_tree_nbytes_match_jax(models, mode):
    (cfg, params, _, _), (tcfg, tparams, _, _) = models
    want = jquant.quantize_params(params, mode=mode)
    got = tquant.quantize_params(tparams, mode=mode)
    assert tquant.tree_nbytes(got) == jquant.tree_nbytes(want)
    assert tquant.tree_nbytes(tparams) == jquant.tree_nbytes(params)
    wrapper = tquant.QTensor if mode == "int8" else tquant.Q4Tensor
    for name in tquant.QUANTIZABLE:
        if name in got["layers"]:
            leaf, jleaf = got["layers"][name], want["layers"][name]
        elif name in got:
            leaf, jleaf = got[name], want[name]
        else:
            continue
        assert isinstance(leaf, wrapper), name
        for field in wrapper._arrays:
            _same(getattr(jleaf, field), getattr(leaf, field),
                  f"{name}.{field}")
    # norms and the embedding pass through untouched
    assert got["embed"] is tparams["embed"]
    assert got["layers"]["attn_norm"] is tparams["layers"]["attn_norm"]
    with pytest.raises(ValueError, match="unknown quantize mode"):
        tquant.quantize_params(tparams, mode="fp8")


def test_wrapped_leaves_slice_field_by_field(models):
    """``layer_params`` slices a QTensor/Q4Tensor per layer (metadata
    kept) and the layer's logits equal those of the densified weights."""
    _, (tcfg, tparams, _, _) = models
    q4 = tquant.quantize_params(tparams, mode="int4", device="cpu")
    lp = tllama.layer_params(q4, 1)
    whole = q4["layers"]["w_up"]
    assert lp["w_up"].group == whole.group
    assert torch.equal(lp["w_up"].packed, whole.packed[1])
    assert [t.packed.data_ptr() for t in whole.unbind(0)] == \
        [whole.packed[i].data_ptr() for i in range(tcfg.n_layers)]
    dense = {**q4, "layers": {k: tquant.to_dense(v, torch.float32)
                              for k, v in q4["layers"].items()},
             "lm_head": tquant.to_dense(q4["lm_head"], torch.float32)}
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, 128, (2, 9)))
    with torch.no_grad():
        torch.testing.assert_close(tllama.forward(tcfg, q4, toks),
                                   tllama.forward(tcfg, dense, toks),
                                   rtol=2e-4, atol=2e-4)


def _requests(seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 127, int(rng.integers(1, 20))).tolist(),
             int(rng.integers(3, 10))) for _ in range(n)]


def _drain(engine, reqs):
    rs = [engine.submit(p, n, logprobs=True) for p, n in reqs]
    engine.run([])
    return [r.result() for r in rs], [r.logprobs for r in rs]


def _hold(got, want):
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=LOGPROB_ATOL)


@pytest.mark.parametrize("kv_mode", ["paged", "dense"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_continuous_engine_quantized_matches_jax(models, mode, kv_mode):
    """More requests than lanes on quantized weights: the JAX engine's
    tokens and log-probabilities; the engine's weights stay quantized."""
    (cfg, params, _, _), (tcfg, tparams, _, _) = models
    reqs = _requests()
    kw = dict(lanes=3, max_len=64, kv_mode=kv_mode, kv_block=8,
              quantize=mode)
    want = _drain(jbatching.ContinuousBatchingEngine(cfg, params, **kw),
                  reqs)
    eng = tbatching.ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                             **kw)
    wrapper = tquant.QTensor if mode == "int8" else tquant.Q4Tensor
    assert all(isinstance(eng.params["layers"][k], wrapper)
               for k in ("wq", "wo", "w_down"))
    assert isinstance(eng.params["lm_head"], wrapper)
    _hold(_drain(eng, reqs), want)
    assert eng.tick_launches["eager"] > 0


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_static_engine_quantized_matches_jax(models, mode):
    (cfg, params, _, _), (tcfg, tparams, _, _) = models
    prompts = [p for p, _ in _requests(seed=1, n=3)]
    want = jengine.InferenceEngine(
        cfg, params, jengine.GenerateConfig(max_len=64),
        quantize=mode).generate(prompts, 6, return_logprobs=True)
    eng = tengine.InferenceEngine(tcfg, tparams,
                                  tengine.GenerateConfig(max_len=64),
                                  quantize=mode, device="cpu")
    got = eng.generate(prompts, 6, return_logprobs=True)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, atol=LOGPROB_ATOL)
    with pytest.raises(ValueError, match="unknown quantize mode"):
        tengine.InferenceEngine(tcfg, tparams, quantize="fp8", device="cpu")


def test_spec_lanes_over_a_quantized_draft_match_jax(models):
    """An int4 draft proposes for an int8 target: JAX's tokens,
    log-probabilities and acceptance counts."""
    (cfg, params, dcfg, dparams), (tcfg, tparams, tdcfg, tdparams) = models
    reqs = _requests(seed=2, n=5)
    kw = dict(lanes=2, max_len=96, kv_mode="paged", kv_block=8, spec_k=3,
              quantize="int8", quantize_draft="int4")
    jeng = jbatching.ContinuousBatchingEngine(
        cfg, params, draft_config=dcfg, draft_params=dparams, **kw)
    want = _drain(jeng, reqs)
    eng = tbatching.ContinuousBatchingEngine(
        tcfg, tparams, draft_config=tdcfg, draft_params=tdparams,
        device="cpu", **kw)
    assert isinstance(eng.dparams["layers"]["wq"], tquant.Q4Tensor)
    _hold(_drain(eng, reqs), want)
    assert (eng.stats.proposed, eng.stats.accepted) == \
        (jeng.stats.proposed, jeng.stats.accepted)


def test_maybe_quantize_moves_and_refuses(models):
    _, (tcfg, tparams, _, _) = models
    assert tengine.maybe_quantize(tparams, None) is tparams
    moved = tengine.maybe_quantize(tparams, "", device="cpu")
    assert moved["embed"] is tparams["embed"]
    with pytest.raises(ValueError, match="unknown quantize mode"):
        tengine.maybe_quantize(tparams, "int3")
