"""The PyTorch port's Llama held against the JAX package on the CPU.

JAX makes the weights (the two RNGs cannot agree); ``save_model`` writes
them as an artifact and the port's ``load_model`` reads it back — the
weight carry-across a JAX artifact directory takes to serve from the
port. Tokens come from ``numpy.random.default_rng``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.models import llama as tllama

#: f32: the same algorithm with sums in another order
F32_ATOL = 1e-4
#: bf16: both sides round every matmul output and the attention output to
#: bf16 (8 bits of mantissa), at places that differ between XLA and
#: PyTorch. The outputs here stay below 4 in magnitude, where a bf16 ulp
#: is 2**-6; allow 4 ulps (2 are seen on this config)
BF16_ATOL = 4 * 2 ** -6


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def artifact(request, tmp_path_factory):
    dtype = getattr(jnp, request.param)
    cfg = dataclasses.replace(jllama.tiny(vocab=256, seq=64), dtype=dtype)
    params = jllama.init_params(cfg, jax.random.PRNGKey(11))
    path = str(tmp_path_factory.mktemp(f"llama_{request.param}"))
    jio.save_model(cfg, params, path)
    tcfg, tparams = tio.load_model(path, device="cpu")
    return request.param, cfg, params, tcfg, tparams, path


def _tokens(seed, b=2, s=24, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (b, s),
                                                dtype=np.int32)


def _close(got, want, dtype):
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol)


def _np(t):
    return t.float().numpy()


def test_load_model_carries_the_jax_weights(artifact):
    dtype, cfg, params, tcfg, tparams, _ = artifact
    assert tcfg.to_dict() == {**dataclasses.asdict(cfg), "dtype": dtype}
    np.testing.assert_array_equal(_np(tparams["layers"]["wq"]),
                                  np.asarray(params["layers"]["wq"],
                                             np.float32))
    assert tparams["layers"]["attn_norm"].dtype == torch.float32
    assert tparams["embed"].dtype == getattr(torch, dtype)


def test_save_model_round_trips_into_jax(artifact, tmp_path):
    _, cfg, params, tcfg, tparams, _ = artifact
    tio.save_model(tcfg, tparams, str(tmp_path))
    cfg2, params2 = jio.load_model(str(tmp_path))
    assert cfg2 == cfg
    for k in ("embed", "lm_head", "final_norm"):
        np.testing.assert_array_equal(np.asarray(params2[k], np.float32),
                                      np.asarray(params[k], np.float32))


def test_forward_and_forward_hidden_match_jax(artifact):
    dtype, cfg, params, tcfg, tparams, _ = artifact
    toks = _tokens(1)
    with torch.inference_mode():
        t_hidden = tllama.forward_hidden(tcfg, tparams, torch.from_numpy(toks))
        t_logits = tllama.forward(tcfg, tparams, torch.from_numpy(toks))
    j_hidden = jllama.forward_hidden(cfg, params, jnp.asarray(toks))
    j_logits = jllama.forward(cfg, params, jnp.asarray(toks))
    _close(_np(t_hidden), j_hidden, dtype)
    _close(t_logits.numpy(), j_logits, dtype)


def test_forward_step_prefill_decode_and_cache_match_jax(artifact):
    dtype, cfg, params, tcfg, tparams, _ = artifact
    toks = _tokens(2, s=20)
    max_len = 32
    jcache = jllama.init_cache(cfg, 2, max_len)
    tcache = tllama.init_cache(tcfg, 2, max_len, device="cpu")
    j_logits, jcache = jllama.forward_step(cfg, params, jnp.asarray(toks),
                                           jcache, jnp.int32(0))
    with torch.inference_mode():
        t_logits, tcache = tllama.forward_step(
            tcfg, tparams, torch.from_numpy(toks).long(), tcache, 0)
    _close(t_logits.numpy(), j_logits, dtype)
    pos = toks.shape[1]
    for step in range(4):
        nxt = np.asarray(jnp.argmax(j_logits, axis=-1), np.int32)[:, None]
        j_logits, jcache = jllama.forward_step(
            cfg, params, jnp.asarray(nxt), jcache, jnp.int32(pos + step))
        with torch.inference_mode():
            t_logits, tcache = tllama.forward_step(
                tcfg, tparams, torch.tensor(nxt).long(), tcache,
                pos + step)
        _close(t_logits.numpy(), j_logits, dtype)
    for key in ("k", "v"):
        _close(_np(tcache[key]), jcache[key], dtype)


def test_per_layer_artifact_loads_stacked(tmp_path):
    """A JAX model saved with ``scan_layers=False`` holds one subtree per
    layer (``layers/<i>/wq``); the port stacks them on load."""
    cfg = dataclasses.replace(jllama.tiny(vocab=256, seq=64),
                              dtype=jnp.float32, scan_layers=False)
    params = jllama.init_params(cfg, jax.random.PRNGKey(14))
    jio.save_model(cfg, params, str(tmp_path))
    tcfg, tparams = tio.load_model(str(tmp_path), device="cpu")
    assert tparams["layers"]["wq"].shape[0] == cfg.n_layers
    toks = _tokens(9, s=12)
    with torch.inference_mode():
        t_logits = tllama.forward(tcfg, tparams, torch.from_numpy(toks))
    j_logits = jllama.forward(cfg, params, jnp.asarray(toks))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=F32_ATOL)


def test_forward_step_per_row_positions_and_valid_match_jax():
    """[b] start positions (continuous batching's form) and a validity
    mask over the cache, f32."""
    cfg = dataclasses.replace(jllama.tiny(vocab=256, seq=64),
                              dtype=jnp.float32)
    params = jllama.init_params(cfg, jax.random.PRNGKey(12))
    tcfg = tllama.LlamaConfig(**{**dataclasses.asdict(cfg),
                                 "dtype": "float32"})
    tree = jax.tree.map(np.asarray, params)
    tparams = tio.params_from_numpy(tcfg, tree, device="cpu")
    max_len = 16
    rng = np.random.default_rng(3)
    jcache = jllama.init_cache(cfg, 2, max_len)
    jcache = {k: jnp.asarray(rng.standard_normal(v.shape, np.float32))
              for k, v in jcache.items()}
    tcache = {k: torch.tensor(np.asarray(v)) for k, v in jcache.items()}
    start = np.asarray([3, 7], np.int32)
    valid = np.arange(max_len)[None, :] >= np.asarray([1, 0])[:, None]
    toks = _tokens(4, s=2)
    j_logits, jcache = jllama.forward_step(
        cfg, params, jnp.asarray(toks), jcache, jnp.asarray(start),
        jnp.asarray(valid))
    with torch.inference_mode():
        t_logits, tcache = tllama.forward_step(
            tcfg, tparams, torch.from_numpy(toks).long(), tcache,
            torch.from_numpy(start).long(), torch.from_numpy(valid))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=F32_ATOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=F32_ATOL)


@pytest.mark.parametrize("knobs", [
    dict(sliding_window=8, qkv_bias=True),
    dict(act="gelu", norm_weight_offset=1.0, embed_scale=True,
         tie_embeddings=True, logit_softcap=30.0, sliding_window=8,
         sandwich_norms=True, attn_logit_softcap=50.0, query_scale=24.0,
         window_pattern="alternate"),
], ids=["mistral_qwen_knobs", "gemma2_knobs"])
def test_family_knobs_match_jax(knobs):
    """The window (and its windowed decode slice), Qwen2 biases and the
    Gemma/Gemma-2 knobs, f32: forward logits and a prefill + decode."""
    cfg = dataclasses.replace(jllama.tiny(vocab=256, seq=64),
                              dtype=jnp.float32, **knobs)
    params = jllama.init_params(cfg, jax.random.PRNGKey(13))
    if cfg.qkv_bias:
        rng = np.random.default_rng(5)
        params["layers"] = {
            **params["layers"],
            **{b: jnp.asarray(rng.standard_normal(
                params["layers"][b].shape, np.float32) * 0.1)
               for b in ("bq", "bk", "bv")}}
    tcfg = tllama.LlamaConfig(**{**dataclasses.asdict(cfg),
                                 "dtype": "float32"})
    tparams = tio.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    toks = _tokens(6, s=16)
    with torch.inference_mode():
        t_logits = tllama.forward(tcfg, tparams, torch.from_numpy(toks))
    j_logits = jllama.forward(cfg, params, jnp.asarray(toks))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=F32_ATOL)
    max_len = 32       # > window + s: the decode reads a windowed slice
    jcache = jllama.init_cache(cfg, 2, max_len)
    tcache = tllama.init_cache(tcfg, 2, max_len, device="cpu")
    j_logits, jcache = jllama.forward_step(cfg, params, jnp.asarray(toks),
                                           jcache, jnp.int32(0))
    nxt = np.asarray(jnp.argmax(j_logits, axis=-1), np.int32)[:, None]
    j_logits, _ = jllama.forward_step(cfg, params, jnp.asarray(nxt), jcache,
                                      jnp.int32(16))
    with torch.inference_mode():
        _, tcache = tllama.forward_step(tcfg, tparams,
                                        torch.from_numpy(toks).long(),
                                        tcache, 0)
        t_logits, _ = tllama.forward_step(tcfg, tparams,
                                          torch.tensor(nxt).long(),
                                          tcache, 16)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=F32_ATOL)


def test_init_params_keys_shapes_and_scale():
    cfg = tllama.LlamaConfig(vocab_size=300, d_model=64, n_layers=3,
                             n_heads=4, n_kv_heads=2, d_ff=96,
                             qkv_bias=True)
    jcfg = jllama.LlamaConfig(vocab_size=300, d_model=64, n_layers=3,
                              n_heads=4, n_kv_heads=2, d_ff=96,
                              qkv_bias=True)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    jshapes = {k: tuple(v.shape) for k, v in jp["layers"].items()}
    assert {k: tuple(v.shape) for k, v in tp["layers"].items()} == jshapes
    assert {k: tuple(v.shape) for k, v in tp.items() if k != "layers"} == \
        {k: tuple(v.shape) for k, v in jp.items() if k != "layers"}
    # fan-in scaling: std ~ 1/sqrt(fan_in) (embed scales by d, not vocab)
    for key, fan_in in (("embed", 64), ("lm_head", 64)):
        std = tp[key].float().std().item()
        assert abs(std * np.sqrt(fan_in) - 1) < 0.1, (key, std)
    assert abs(tp["layers"]["w_down"].float().std().item()
               * np.sqrt(96) - 1) < 0.1
    assert torch.all(tp["layers"]["attn_norm"] == 1)
    assert torch.all(tp["layers"]["bq"] == 0)
