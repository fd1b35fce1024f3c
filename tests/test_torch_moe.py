"""The MoE family in the port, held against the JAX package on the CPU:
the presets and parameter counts, the capacity router (its traps: the
out-of-range one-hot, top-k tie order, choice-major slots, pads under a
token mask), the sparse block with dense and int8/int4 expert stacks,
the artifact round trip, forward logits and the one-token decode against
the one-pass forward. Weights are JAX-made and cross as numpy; quantized
trees never cross (both packages quantize the same weights). Training
is held in ``test_torch_moe_train.py``, the KV steps and the serving
paths in ``test_torch_moe_serving.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import moe as jmoe
from kubedl_tpu.ops import quant as jquant
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.models import moe as tmoe
from kubedl_tpu_torch.ops import quant as tquant

VOCAB = 128
#: routing is 0/1 bookkeeping plus one float32 normalization of the gates:
#: dispatch is bit-equal, combine and aux within 1e-6
ROUTE_ATOL = 1e-6
#: float32 activations through two layers; the packages sum in other orders
LOGITS_ATOL = 1e-4


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(JAX config, JAX params, port config, port params) of a float32
    ``moe.tiny``, carried across by the artifact format."""
    jcfg = dataclasses.replace(jmoe.tiny(vocab=VOCAB, seq=128),
                               dtype=jnp.float32)
    params = jmoe.init_params(jcfg, jax.random.PRNGKey(3))
    path = str(tmp_path_factory.mktemp("moe"))
    jio.save_model(jcfg, params, path)
    tcfg, tparams = tio.load_model(path, device="cpu")
    return jcfg, params, tcfg, tparams


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("preset", ["mixtral_8x7b", "tiny"])
def test_presets_and_param_counts_match_jax(preset):
    jcfg, tcfg = getattr(jmoe, preset)(), getattr(tmoe, preset)()
    want = dataclasses.asdict(jcfg)
    want["dtype"] = jnp.dtype(want["dtype"]).name
    assert tcfg.to_dict() == want
    assert tcfg.num_params == jcfg.num_params
    assert tcfg.active_params == jcfg.active_params
    shapes = tmoe.param_shapes(tcfg)
    jtree = jax.eval_shape(lambda k: jmoe.init_params(jcfg, k),
                           jax.random.PRNGKey(0))
    for k, (shape, f32) in shapes["layers"].items():
        leaf = jtree["layers"][k]
        assert leaf.shape == (jcfg.n_layers,) + shape, k
        assert (leaf.dtype == jnp.float32) == f32, k


def test_init_params_draws_a_random_float32_router():
    """``w_router`` is float32 and drawn normal / sqrt(d), not filled like
    the float32 norm scales; expert stacks scale by their contraction
    dim."""
    cfg = dataclasses.replace(tmoe.tiny(vocab=VOCAB), dtype="bfloat16")
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    lay = params["layers"]
    assert lay["w_router"].dtype == torch.float32
    assert lay["w_gate"].dtype == torch.bfloat16
    assert lay["w_gate"].shape == (2, 4, 128, 256)
    d, f = cfg.d_model, cfg.d_ff
    assert abs(float(lay["w_router"].std()) * d ** 0.5 - 1) < 0.1
    assert abs(float(lay["w_down"].float().std()) * f ** 0.5 - 1) < 0.05
    assert abs(float(lay["w_gate"].float().std()) * d ** 0.5 - 1) < 0.05
    assert torch.equal(lay["mlp_norm"], torch.ones_like(lay["mlp_norm"]))
    again = tmoe.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert torch.equal(again["layers"]["w_router"], lay["w_router"])


def _probs(case):
    """(probs [b, s, E], capacity, token_mask or None) of one routing
    case, top_k 2 over E=4."""
    rng = np.random.default_rng(11)
    if case == "random":
        logits = rng.normal(size=(2, 24, 4))
        return _softmax(logits), 12, None
    if case == "pad_prefix_mask":
        # left padding longer than the capacity: the pads must not take
        # the real tokens' slots (test_padding_does_not_consume_expert_
        # capacity in the JAX package's tests)
        logits = rng.normal(size=(2, 16, 4))
        mask = np.ones((2, 16), bool)
        mask[0, :10] = False
        mask[1, :3] = False
        return _softmax(logits), 4, mask
    if case == "overflow":
        # every token prefers expert 0, then 1: the queues run far past
        # the capacity, so positions >= capacity must drop (a zero row)
        logits = np.tile([4.0, 3.0, 0.0, -1.0], (2, 20, 1))
        logits += 0.01 * rng.normal(size=logits.shape)
        return _softmax(logits), 5, None
    if case == "uniform_ties":
        # an all-zero hidden state gives router logits of 0: every expert
        # ties, and top-k must take the lower indices first
        logits = np.zeros((2, 12, 4))
        logits[1, ::3] = [0.5, 0.5, 0.5, 0.0]
        return _softmax(logits), 6, None
    if case == "decode":
        logits = rng.normal(size=(4, 1, 4))
        return _softmax(logits), 1, None
    raise ValueError(case)


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "pad_prefix_mask", "overflow",
                                  "uniform_ties", "decode"])
def test_route_matches_jax(case):
    probs, capacity, mask = _probs(case)
    jcfg, tcfg = jmoe.tiny(), tmoe.tiny()
    jd, jc, ja = jmoe.route(jcfg, jnp.asarray(probs), capacity,
                            None if mask is None else jnp.asarray(mask))
    td, tc, ta = tmoe.route(tcfg, torch.from_numpy(probs), capacity,
                            None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=ROUTE_ATOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=ROUTE_ATOL)
    if case == "overflow":
        # the queues overflowed: some token kept fewer than top_k slots
        assert (td.sum((2, 3)) < tcfg.top_k).any()
    if case == "pad_prefix_mask":
        assert float(td[torch.from_numpy(~mask)].sum()) == 0.0
        # every real token of row 0 (6 of them, 12 choices over 4
        # experts x 4 slots) found its slots despite the 10 pads
        assert torch.equal(td[0, 10:].sum((1, 2)),
                           torch.full((6,), 2.0))


def test_top_k_takes_the_lower_index_on_a_tie():
    probs = torch.tensor([[[0.25, 0.25, 0.25, 0.25],
                           [0.1, 0.3, 0.3, 0.3],
                           [0.4, 0.1, 0.4, 0.1]]])
    vals, idx = tmoe._top_k(probs, 2)
    assert idx.tolist() == [[[0, 1], [1, 2], [0, 2]]]
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
    assert idx.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_moe_block_matches_jax(model, quantize):
    """One sparse block on layer 0's weights (expert stacks dense, int8 or
    int4; the quantized stacks bit-identical to the JAX package's), with
    and without a token mask."""
    jcfg, params, tcfg, tparams = model
    if quantize:
        params = jquant.quantize_params(params, mode=quantize)
        tparams = tquant.quantize_params(tparams, mode=quantize)
        wrapper = tquant.QTensor if quantize == "int8" else tquant.Q4Tensor
        for name in ("w_gate", "w_up", "w_down"):
            leaf, jleaf = tparams["layers"][name], params["layers"][name]
            assert isinstance(leaf, wrapper) and leaf.shape == jleaf.shape
            for field in wrapper._arrays:
                np.testing.assert_array_equal(
                    getattr(leaf, field).numpy(),
                    np.asarray(getattr(jleaf, field)), err_msg=name)
    x = np.random.default_rng(4).normal(size=(2, 20, 128)).astype(np.float32)
    mask = np.ones((2, 20), bool)
    mask[1, :7] = False
    for m in (None, mask):
        jy, jaux = jmoe._moe_block(jcfg, jnp.asarray(x),
                                   jax.tree.map(lambda a: a[0],
                                                params["layers"]),
                                   token_mask=None if m is None
                                   else jnp.asarray(m))
        ty, taux = tmoe._moe_block(tcfg, torch.from_numpy(x),
                                   tllama.layer_params(tparams, 0),
                                   token_mask=None if m is None
                                   else torch.from_numpy(m))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_expert_stacks_slice_per_layer(model, mode):
    """``layer_params`` slices a quantized ``[L, E, d, f]`` stack to an
    ``[E, d, f]`` leaf whose ``to_dense`` equals the stack's own slice."""
    _, _, tcfg, tparams = model
    q = tquant.quantize_params(tparams, mode=mode)
    whole = tquant.to_dense(q["layers"]["w_down"], torch.float32)
    for i in range(tcfg.n_layers):
        leaf = tllama.layer_params(q, i)["w_down"]
        assert leaf.shape == (tcfg.n_experts, tcfg.d_ff, tcfg.d_model)
        assert torch.equal(tquant.to_dense(leaf, torch.float32), whole[i])
    parts = q["layers"]["w_gate"].unbind(0)
    assert len(parts) == tcfg.n_layers
    assert parts[1].shape == (tcfg.n_experts, tcfg.d_model, tcfg.d_ff)


def test_artifacts_cross_both_ways(model, tmp_path):
    """A JAX-made MoE artifact loads in the port as an ``MoEConfig``; the
    port's ``save_model`` writes ``"family": "moe"``, which the JAX
    package loads back bit for bit."""
    jcfg, params, tcfg, tparams = model
    assert isinstance(tcfg, tmoe.MoEConfig)
    assert tparams["layers"]["w_router"].dtype == torch.float32
    tio.save_model(tcfg, tparams, str(tmp_path))
    cfg2, params2 = jio.load_model(str(tmp_path))
    assert cfg2 == jcfg
    flat = {"/".join(str(k.key) for k in kp): v for kp, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    flat2 = {"/".join(str(k.key) for k in kp): v for kp, v in
             jax.tree_util.tree_flatten_with_path(params2)[0]}
    assert flat.keys() == flat2.keys()
    for k in flat:
        np.testing.assert_array_equal(np.asarray(flat2[k]),
                                      np.asarray(flat[k]), err_msg=k)


def test_family_table_names_each_config_by_its_nearest_class(model,
                                                          tmp_path):
    """``io.family_name`` takes the family whose config class is nearest
    in the config's classes (``MoEConfig`` subclasses ``LlamaConfig``; a
    Gemma config is a ``LlamaConfig``); ``read_config`` gives a JAX-made
    MoE artifact's config without its weights; each family states its
    own ``/v1/embeddings`` padding bucket."""
    from kubedl_tpu_torch.models import gemma as tgemma
    jcfg, params, tcfg, _ = model
    assert tio.family_name(tmoe.tiny()) == "moe"
    assert tio.family_name(tllama.tiny()) == "llama"
    assert tio.family_name(tgemma.tiny()) == "llama"
    assert tio.family_of(tcfg) is tmoe
    with pytest.raises(TypeError, match="no model family"):
        tio.family_name(object())
    jio.save_model(jcfg, params, str(tmp_path))
    assert tio.read_config(str(tmp_path)) == tcfg
    assert (tllama.EMBED_BUCKET, tmoe.EMBED_BUCKET) == (None, 128)


def test_forward_logits_match_jax(model):
    jcfg, params, tcfg, tparams = model
    toks = _tokens(1, (2, 40))
    want = jmoe.forward(jcfg, params, jnp.asarray(toks))
    with torch.no_grad():
        got = tmoe.forward(tcfg, tparams, torch.from_numpy(toks).long())
        x, aux = tmoe.forward_hidden(tcfg, tparams,
                                     torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL)
    _, jaux = jmoe.forward_hidden(jcfg, params, jnp.asarray(toks))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # expert parallelism (a mesh with ep > 1) trains across processes
    # (test_torch_cp_ep_train.py); a mesh that claims ep=2 with no
    # process group behind it is refused
    from kubedl_tpu_torch.parallel import mesh as tmesh
    ep_mesh = tmesh.Mesh(device=torch.device("cpu"),
                         shape={a: 2 if a == "ep" else 1 for a in tmesh.AXES})
    with pytest.raises(ValueError, match="has no process group"):
        tmoe.forward(tcfg, tparams, torch.from_numpy(toks).long(),
                     mesh=ep_mesh)


def test_decode_equals_the_full_forward_when_dropless(model):
    """At capacity_factor n_experts / top_k capacity equals the chunk
    length, nothing drops at any chunk length, and a prefill plus
    one-token decode steps give the one-pass forward's logits (the JAX
    package's test_moe decode check)."""
    _, _, tcfg, tparams = model
    cfg = dataclasses.replace(tcfg, capacity_factor=tcfg.n_experts
                              / tcfg.top_k)
    assert tmoe.capacity_of(cfg, 17) == 17
    toks = torch.from_numpy(_tokens(6, (2, 24))).long()
    with torch.no_grad():
        full = tmoe.forward(cfg, tparams, toks)
        cache = tmoe.init_cache(cfg, 2, 32, device="cpu")
        logits, cache = tmoe.forward_step(cfg, tparams, toks[:, :16], cache,
                                          0)
        np.testing.assert_allclose(logits.numpy(), full[:, 15].numpy(),
                                   atol=LOGITS_ATOL)
        for p in range(16, 24):
            logits, cache = tmoe.forward_step(cfg, tparams,
                                              toks[:, p:p + 1], cache, p)
            np.testing.assert_allclose(logits.numpy(), full[:, p].numpy(),
                                       atol=LOGITS_ATOL)
