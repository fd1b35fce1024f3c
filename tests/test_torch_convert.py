"""HF checkpoint conversion in the port, held against the JAX package's
``models/convert.py`` on the CPU: ``config_from_hf`` field for field and
refusal for refusal, ``from_hf`` bit for bit on synthetic state dicts in
each family's key layout, ``to_hf`` and the HF directory both ways
(sharded with an index, the ``.bin`` fallback), the CLI whose artifact
the JAX package loads, and logits against transformers' own forward.

Nothing is downloaded: state dicts are drawn with numpy from a seed in
the published key layouts."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubedl_tpu.models import convert as jconvert
from kubedl_tpu.models import io as jio
from kubedl_tpu_torch.models import convert as tconvert
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.models import moe as tmoe
from kubedl_tpu_torch.models import safetensors_io as sio
from kubedl_tpu_torch.train.trainer import tree_leaves

_BASE = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64,
             rope_theta=10000.0, rms_norm_eps=1e-6)

#: one HF config.json per family layout the converter covers
HF_CONFIGS = {
    "llama": dict(_BASE, model_type="llama", tie_word_embeddings=False),
    "mistral": dict(_BASE, model_type="mistral", sliding_window=16),
    "qwen2": dict(_BASE, model_type="qwen2", use_sliding_window=False,
                  sliding_window=32, max_window_layers=2),
    "gemma": dict(_BASE, model_type="gemma", num_key_value_heads=1,
                  head_dim=16),
    "gemma2": dict(_BASE, model_type="gemma2", head_dim=16,
                   sliding_window=8, query_pre_attn_scalar=32,
                   attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0),
}


def _fields(cfg) -> dict:
    """A config's fields, the dtype by name (both packages' configs)."""
    out = dataclasses.asdict(cfg)
    out["dtype"] = (tllama.dtype_name(cfg.dtype) if isinstance(
        cfg.dtype, torch.dtype) else np.dtype(cfg.dtype).name)
    return out


@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_config_from_hf_matches_jax_field_for_field(family):
    hf = HF_CONFIGS[family]
    assert _fields(tconvert.config_from_hf(hf)) == _fields(
        jconvert.config_from_hf(hf))


def test_config_from_hf_reads_attribute_objects_too():
    hf = type("HFConfig", (), dict(HF_CONFIGS["gemma2"]))()
    assert _fields(tconvert.config_from_hf(hf)) == _fields(
        jconvert.config_from_hf(hf))


@pytest.mark.parametrize("hf", [
    dict(_BASE, model_type="gemma3"),
    dict(HF_CONFIGS["gemma2"], layer_types=["full_attention"] * 2),
    dict(_BASE, model_type="qwen2", sliding_window=16, max_window_layers=1,
         num_hidden_layers=4),
    dict(HF_CONFIGS["gemma2"], query_pre_attn_scalar=None),
], ids=["gemma3", "gemma2_layer_types", "mixed_window_layers",
        "null_query_scale"])
def test_config_from_hf_refuses_as_jax_does(hf):
    with pytest.raises(ValueError) as want:
        jconvert.config_from_hf(hf)
    with pytest.raises(ValueError) as got:
        tconvert.config_from_hf(hf)
    assert str(got.value) == str(want.value)


def hf_state_dict(hf: dict, seed: int = 0, dtype=np.float32) -> dict:
    """A HF ``*ForCausalLM`` state dict in ``hf``'s published key layout,
    drawn with numpy (norms around 1, biases included where the family
    has them, the derived rotary buffer Llama checkpoints carry)."""
    cfg = jconvert.config_from_hf(hf)
    rng = np.random.default_rng(seed)
    d, hd, ff = cfg.d_model, cfg.head_dim or cfg.d_model // cfg.n_heads, \
        cfg.d_ff

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(dtype)

    def norm(n):
        return (1.0 + 0.1 * rng.standard_normal(n)).astype(dtype)

    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, d),
          "model.norm.weight": norm(d)}
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = w(cfg.vocab_size, d)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": norm(d),
            p + "post_attention_layernorm.weight": norm(d),
            p + "self_attn.q_proj.weight": w(cfg.n_heads * hd, d),
            p + "self_attn.k_proj.weight": w(cfg.n_kv_heads * hd, d),
            p + "self_attn.v_proj.weight": w(cfg.n_kv_heads * hd, d),
            p + "self_attn.o_proj.weight": w(d, cfg.n_heads * hd),
            p + "mlp.gate_proj.weight": w(ff, d),
            p + "mlp.up_proj.weight": w(ff, d),
            p + "mlp.down_proj.weight": w(d, ff),
            p + "self_attn.rotary_emb.inv_freq": norm(hd // 2)})
        if cfg.qkv_bias:
            sd[p + "self_attn.q_proj.bias"] = norm(cfg.n_heads * hd)
            sd[p + "self_attn.k_proj.bias"] = norm(cfg.n_kv_heads * hd)
            sd[p + "self_attn.v_proj.bias"] = norm(cfg.n_kv_heads * hd)
        if cfg.sandwich_norms:
            sd[p + "pre_feedforward_layernorm.weight"] = norm(d)
            sd[p + "post_feedforward_layernorm.weight"] = norm(d)
    return sd


def _jax_leaves(params) -> dict:
    """``path -> numpy`` of a JAX parameter tree, in the port's paths."""
    out = {k: np.asarray(v) for k, v in params.items() if k != "layers"}
    out.update({f"layers/{k}": np.asarray(v)
                for k, v in params["layers"].items()})
    return out


def _same_bits(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        assert got.dtype == torch.float32, got.dtype
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_from_hf_gives_the_same_bits_as_jax(family, dtype):
    hf = HF_CONFIGS[family]
    sd = hf_state_dict(hf, seed=len(family))
    jcfg = dataclasses.replace(jconvert.config_from_hf(hf),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tconvert.config_from_hf(hf), dtype=dtype)
    want = _jax_leaves(jconvert.from_hf(jcfg, sd))
    # torch tensors in, as a torch state dict hands them over
    got = dict(tree_leaves(tconvert.from_hf(
        tcfg, {k: torch.from_numpy(v) for k, v in sd.items()},
        device="cpu")))
    assert set(got) == set(want)
    for k in want:
        _same_bits(got[k], want[k])


def test_from_hf_refuses_unconverted_layer_weights():
    hf = HF_CONFIGS["llama"]
    sd = hf_state_dict(hf)
    sd["model.layers.0.self_attn.q_norm.weight"] = np.ones(16, np.float32)
    cfg = tconvert.config_from_hf(hf)
    with pytest.raises(ValueError, match="unconverted layer weights"):
        jconvert.from_hf(jconvert.config_from_hf(hf), sd)
    with pytest.raises(ValueError, match="unconverted layer weights"):
        tconvert.from_hf(cfg, sd, device="cpu")
    sd = hf_state_dict(hf)
    sd["model.layers.1.mlp.up_proj.weight"] = np.ones((64, 64), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tconvert.from_hf(cfg, sd, device="cpu")


@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_to_hf_is_jax_s_and_inverts_from_hf(family):
    hf = HF_CONFIGS[family]
    sd = hf_state_dict(hf, seed=7)
    tcfg = dataclasses.replace(tconvert.config_from_hf(hf), dtype="float32")
    jcfg = dataclasses.replace(jconvert.config_from_hf(hf),
                               dtype=jnp.float32)
    params = tconvert.from_hf(tcfg, sd, device="cpu")
    got = tconvert.to_hf(tcfg, params)
    want = jconvert.to_hf(jcfg, jconvert.from_hf(jcfg, sd))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    again = tconvert.from_hf(tcfg, got, device="cpu")
    for (k, a), (_, b) in zip(tree_leaves(params), tree_leaves(again)):
        assert torch.equal(a, b), k
    assert tconvert.config_to_hf(tcfg) == jconvert.config_to_hf(jcfg)
    assert _fields(tconvert.config_from_hf(tconvert.config_to_hf(tcfg))) \
        == _fields(dataclasses.replace(tcfg, dtype="bfloat16"))


def _write_hf_dir(path, hf: dict, sd: dict, shards: int = 1,
                  decoy: bool = False):
    """A HF model directory: config.json and the weights in ``shards``
    safetensors files, with ``model.safetensors.index.json`` when there
    is more than one."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf))
    keys = sorted(sd)
    if shards == 1:
        sio.save_file(sd, str(path / "model.safetensors"))
    else:
        weight_map = {}
        for i in range(shards):
            name = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
            part = keys[i::shards]
            sio.save_file({k: sd[k] for k in part}, str(path / name))
            weight_map.update({k: name for k in part})
        (path / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {}, "weight_map": weight_map}))
    if decoy:
        # a raw-layout file official repos ship beside the HF shards
        sio.save_file({"tok_embeddings.weight": np.zeros((2, 2),
                                                         np.float32)},
                      str(path / "consolidated.safetensors"))


@pytest.mark.parametrize("shards,decoy", [(1, True), (2, False), (3, True)])
def test_load_hf_checkpoint_matches_jax(tmp_path, shards, decoy):
    hf = HF_CONFIGS["gemma2"] if shards == 3 else HF_CONFIGS["qwen2"]
    bf16 = torch.from_numpy  # shards hold bf16 tensors, as published
    sd = {k: bf16(v).bfloat16() for k, v in hf_state_dict(hf, 2).items()}
    _write_hf_dir(tmp_path / "hf", hf, sd, shards=shards, decoy=decoy)
    jcfg, jparams = jconvert.load_hf_checkpoint(str(tmp_path / "hf"))
    tcfg, tparams = tconvert.load_hf_checkpoint(str(tmp_path / "hf"),
                                                device="cpu")
    assert _fields(tcfg) == _fields(jcfg)
    want = _jax_leaves(jparams)
    for k, t in tree_leaves(tparams):
        _same_bits(t, want[k])


def test_load_hf_checkpoint_reads_pytorch_bin(tmp_path):
    hf = HF_CONFIGS["llama"]
    sd = {k: torch.from_numpy(v) for k, v in hf_state_dict(hf, 3).items()}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    cfg, got = tconvert.load_hf_checkpoint(str(tmp_path), device="cpu")
    want = tconvert.from_hf(cfg, sd, device="cpu")
    for (k, a), (_, b) in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b), k


def test_save_hf_checkpoint_loads_in_the_package_as_jax_s(tmp_path):
    safetensors = pytest.importorskip("safetensors.numpy")
    hf = HF_CONFIGS["gemma"]
    sd = hf_state_dict(hf, 4)
    tcfg = tconvert.config_from_hf(hf)
    jcfg = jconvert.config_from_hf(hf)
    tconvert.save_hf_checkpoint(tcfg, tconvert.from_hf(tcfg, sd,
                                                       device="cpu"),
                                str(tmp_path / "t"))
    jconvert.save_hf_checkpoint(jcfg, jconvert.from_hf(jcfg, sd),
                                str(tmp_path / "j"))
    got = safetensors.load_file(str(tmp_path / "t" / "model.safetensors"))
    want = safetensors.load_file(str(tmp_path / "j" / "model.safetensors"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads((tmp_path / "t" / "config.json").read_text()) == \
        json.loads((tmp_path / "j" / "config.json").read_text())


def test_moe_configs_have_no_hf_mapping():
    cfg = tmoe.tiny()
    with pytest.raises(ValueError, match="no HF mapping"):
        tconvert.config_to_hf(cfg)
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with pytest.raises(ValueError, match="no HF mapping"):
        tconvert.to_hf(cfg, params)


def test_cli_both_ways_and_the_jax_package_loads_the_artifact(tmp_path,
                                                              capsys):
    hf = HF_CONFIGS["gemma"]
    sd = {k: torch.from_numpy(v).bfloat16()
          for k, v in hf_state_dict(hf, 5).items()}
    src = tmp_path / "hf"
    _write_hf_dir(src, hf, sd, shards=2)
    (src / "tokenizer.json").write_text("{}")
    (src / "tokenizer_config.json").write_text("{}")
    art = tmp_path / "artifact"
    assert tconvert.main([str(src), str(art), "--device", "cpu"]) == 0
    assert "tokenizer assets: tokenizer.json, tokenizer_config.json" in \
        capsys.readouterr().out
    assert (art / "tokenizer.json").exists()
    jcfg, jparams = jio.load_model(str(art))
    wcfg, wparams = jconvert.load_hf_checkpoint(str(src))
    assert _fields(jcfg) == _fields(wcfg)
    want = _jax_leaves(wparams)
    for k, v in _jax_leaves(jparams).items():
        np.testing.assert_array_equal(np.asarray(v, np.float32),
                                      np.asarray(want[k], np.float32),
                                      err_msg=k)
    bare = tmp_path / "bare"
    assert tconvert.main([str(src), str(bare), "--no-tokenizer",
                          "--device", "cpu"]) == 0
    assert not (bare / "tokenizer.json").exists()

    out = tmp_path / "hf_out"
    assert tconvert.main(["--reverse", str(art), str(out),
                          "--device", "cpu"]) == 0
    back = sio.load_file(str(out / "model.safetensors"))
    assert set(back) == set(sd) - {k for k in sd if "inv_freq" in k}
    for k, v in back.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, sd[k].float()), k
    tcfg, _ = tio.load_model(str(art), device="cpu")
    assert json.loads((out / "config.json").read_text()) == \
        tconvert.config_to_hf(tcfg)


# -- against transformers' own forward ------------------------------------------

#: the JAX package's tolerances (tests/test_convert.py)
HF_MODELS = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(num_key_value_heads=2),
              2e-4),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(num_key_value_heads=2),
              2e-4),
    "gemma": ("GemmaConfig", "GemmaForCausalLM",
              dict(num_key_value_heads=1, head_dim=16), 2e-4),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM",
               dict(num_key_value_heads=2, head_dim=16, sliding_window=4,
                    query_pre_attn_scalar=32, attn_logit_softcapping=50.0,
                    final_logit_softcapping=30.0, num_hidden_layers=4),
               5e-4),
}


@pytest.mark.parametrize("family", sorted(HF_MODELS))
def test_logits_match_transformers(family):
    transformers = pytest.importorskip("transformers")
    cfg_cls, model_cls, extra, atol = HF_MODELS[family]
    kw = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=64, rope_theta=10000.0,
              attn_implementation="eager")
    kw.update(extra)
    hf_cfg = getattr(transformers, cfg_cls)(**kw)
    torch.manual_seed(len(family))
    model = getattr(transformers, model_cls)(hf_cfg).float().eval()
    tokens = [[3, 17, 42, 9, 1, 77, 5, 23, 11, 60, 2, 8]]
    with torch.no_grad():
        want = model(torch.tensor(tokens)).logits.numpy()
    cfg = dataclasses.replace(tconvert.config_from_hf(hf_cfg),
                              dtype="float32")
    params = tconvert.from_hf(cfg, model.state_dict(), device="cpu")
    with torch.no_grad():
        got = tllama.forward(cfg, params, torch.tensor(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-3)


# -- the artifact loader ------------------------------------------------------------

def _artifact(tmp_path, dtype="float32"):
    cfg = dataclasses.replace(tllama.tiny(vocab=64), dtype=dtype)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(1),
                                device="cpu")
    path = tmp_path / "art"
    tio.save_model(cfg, params, str(path))
    return cfg, params, path


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_a_damaged_artifact_reports_its_checksum(tmp_path, damage):
    _, _, path = _artifact(tmp_path)
    npz = path / "params.npz"
    raw = bytearray(npz.read_bytes())
    if damage == "flip":
        raw[len(raw) // 2] ^= 0xFF
    else:
        raw = raw[: len(raw) // 2]
    npz.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum mismatch"):
        tio.load_model(str(path), device="cpu")


def test_loaded_leaves_own_their_bytes(tmp_path):
    """The loader maps the file: float32 leaves on the CPU must still be
    copies, or overwriting the artifact would change the model."""
    cfg, params, path = _artifact(tmp_path)
    _, got = tio.load_model(str(path), device="cpu")
    tio.save_model(cfg, {k: (v if k != "layers" else
                             {n: t + 1 for n, t in v.items()})
                         for k, v in params.items()}, str(path))
    for (k, a), (_, b) in zip(tree_leaves(got), tree_leaves(params)):
        assert torch.equal(a, b), k
        a.add_(1)                        # and they are writable


def test_a_compressed_npz_without_a_checksum_loads(tmp_path):
    cfg, params, path = _artifact(tmp_path, dtype="bfloat16")
    with np.load(path / "params.npz") as z:
        flat = {k: z[k] for k in z.files}
    np.savez_compressed(path / "params.npz", **flat)
    doc = json.loads((path / "config.json").read_text())
    del doc["params_sha256"]
    (path / "config.json").write_text(json.dumps(doc))
    _, got = tio.load_model(str(path), device="cpu")
    for (k, a), (_, b) in zip(tree_leaves(got), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
