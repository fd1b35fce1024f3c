"""HuggingFace checkpoint conversion for the llama-family models: the
counterpart of ``kubedl_tpu/models/convert.py``.

A HF ``*ForCausalLM`` state dict (Llama / Mistral / Qwen2 / Gemma /
Gemma-2) maps into the port's parameter dict and config, and back.
Conversion is renaming and transposition: both sides use the half-split
("rotate_half") RoPE convention, so no head permutation is needed
(``tests/test_torch_convert.py`` holds the logits against transformers'
own forward). HF linear weights are ``[out, in]``; the port's are
``[in, out]``, stacked over layers, with float32 norms and biases.

The safetensors files are read and written by the port's own
``safetensors_io`` (no ``safetensors`` or ``transformers`` package is
needed); ``pytorch_model*.bin`` checkpoints load through ``torch.load``.
An MoE config has no HF mapping and raises, as in the JAX package.

    python -m kubedl_tpu_torch.models.convert HF_DIR OUT_DIR
    python -m kubedl_tpu_torch.models.convert --reverse ARTIFACT HF_DIR

run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .._device import resolve_device
from . import io, llama
from .llama import LlamaConfig
from .safetensors_io import load_file, save_file


def _host(t) -> torch.Tensor:
    """A host tensor in the SOURCE dtype (torch tensors, and numpy arrays
    including ``ml_dtypes`` bfloat16): upcasting a whole checkpoint on the
    host would double its peak memory for nothing."""
    if torch.is_tensor(t):
        return t.detach().to("cpu")
    arr = np.asarray(t)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def config_from_hf(hf) -> LlamaConfig:
    """LlamaConfig from a HF config object (or plain dict). Handles the
    per-family knobs: Qwen2 qkv biases, Mistral sliding window, Gemma
    norm-offset/GeGLU/tied-embeddings/embed-scale, Gemma-2's sandwich
    norms, softcaps, query scale and alternating window."""
    get = (hf.get if isinstance(hf, dict)
           else lambda k, d=None: getattr(hf, k, d))
    model_type = str(get("model_type", "llama") or "llama").lower()
    if model_type not in ("llama", "mistral", "qwen2", "gemma", "gemma2"):
        # gemma3 adds q/k norms this converter would silently drop:
        # refuse rather than produce a wrong model (from_hf also checks
        # for leftover layer weights)
        raise ValueError(
            f"unsupported HF model_type {model_type!r} "
            "(supported: llama, mistral, qwen2, gemma, gemma2)")
    gemma = model_type in ("gemma", "gemma2")
    gemma2 = model_type == "gemma2"
    if gemma2:
        # gemma2's window rule (even layers slide) must match the
        # family's "alternate" pattern when layer_types is explicit
        lt = get("layer_types")
        if lt is not None:
            want = ["sliding_attention" if i % 2 == 0 else "full_attention"
                    for i in range(int(get("num_hidden_layers")))]
            if list(lt) != want:
                raise ValueError(
                    "gemma2 layer_types deviates from the alternating "
                    "even-sliding pattern; this core cannot express it")
    return LlamaConfig(
        vocab_size=int(get("vocab_size")),
        d_model=int(get("hidden_size")),
        n_layers=int(get("num_hidden_layers")),
        n_heads=int(get("num_attention_heads")),
        n_kv_heads=int(get("num_key_value_heads",
                           get("num_attention_heads"))),
        d_ff=int(get("intermediate_size")),
        head_dim=(int(get("head_dim")) if get("head_dim") else None),
        rope_theta=float(get("rope_theta", 10000.0) or 10000.0),
        rms_eps=float(get("rms_norm_eps", 1e-5) or 1e-5),
        max_seq_len=int(get("max_position_embeddings", 8192) or 8192),
        # HF gates the window on use_sliding_window (default on when a
        # window is set; Qwen2 ships configs with the flag off). gemma2
        # always windows its even layers.
        sliding_window=(int(get("sliding_window") or 0) if gemma2
                        else _window_from_hf(get)),
        window_pattern="alternate" if gemma2 else "uniform",
        sandwich_norms=gemma2,
        attn_logit_softcap=(_gemma2_knob(get, "attn_logit_softcapping",
                                         50.0, null_ok=True)
                            if gemma2 else 0.0),
        query_scale=(_gemma2_knob(get, "query_pre_attn_scalar",
                                  256.0, null_ok=False)
                     if gemma2 else 0.0),
        qkv_bias=bool(get("attention_bias", False)
                      or model_type == "qwen2"),
        act="gelu" if gemma else "silu",
        norm_weight_offset=1.0 if gemma else 0.0,
        embed_scale=gemma,
        tie_embeddings=bool(get("tie_word_embeddings", gemma)),
        logit_softcap=float(get("final_logit_softcapping") or 0.0),
    )


_MISSING = object()


def _gemma2_knob(get, name: str, default: float, null_ok: bool) -> float:
    """Gemma-2 scoring knob with transformers' exact semantics: an ABSENT
    key takes the Gemma2Config class default (never 1/sqrt(head_dim),
    which diverges e.g. on gemma2-27b where query_pre_attn_scalar=144 !=
    head_dim=128); an explicit ``null`` means "disabled" where HF's
    modeling code gates on ``is not None`` (attention softcapping) and is
    refused where HF itself would choke on it (query_pre_attn_scalar)."""
    v = get(name, _MISSING)
    if v is _MISSING:
        return default
    if v is None:
        if null_ok:
            return 0.0
        raise ValueError(
            f"gemma2 HF config has {name!r}: null, which transformers "
            "itself cannot score with; refusing to guess")
    return float(v)


def _window_from_hf(get) -> int:
    """HF sliding-window semantics -> the family's uniform window knob.
    HF applies the window to layers ``i >= max_window_layers``. This core
    is uniform, so only the two uniform shapes convert: mwl == 0 (every
    layer slides: keep the window) and mwl >= n_layers (no layer slides:
    window off); a mixed config is refused rather than mis-converted."""
    if not get("use_sliding_window", True):
        return 0
    window = int(get("sliding_window") or 0)
    if window:
        mwl = get("max_window_layers")
        n_layers = int(get("num_hidden_layers"))
        if mwl is not None:
            mwl = int(mwl)
            if mwl >= n_layers:
                return 0       # HF runs every layer with full attention
            if mwl > 0:
                raise ValueError(
                    f"max_window_layers={mwl} applies the sliding window "
                    "to a layer subset; this core's window is uniform — "
                    "refusing rather than converting a divergent model")
    return window


#: leaves kept float32 (norm scales, projection biases)
_F32 = {"attn_norm", "mlp_norm", "post_attn_norm", "post_ffw_norm",
        "bq", "bk", "bv"}


def from_hf(config: LlamaConfig, state_dict: dict, dtype=None,
            device=None) -> dict:
    """HF ``model.*`` state dict (torch tensors or numpy arrays) -> the
    port's parameter dict on ``device``: layer params stacked on a
    leading axis, linear weights ``[in, out]`` in ``dtype`` (default the
    config's), norms and biases float32. Each key is stacked on the host
    in its source dtype and copied to the device once; the cast and the
    transposition run there, so the host never holds a converted copy."""
    dev = resolve_device(device)
    dtype = llama._DTYPES.get(dtype, dtype) or config.dtype
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    consumed = set()

    def take(key):
        consumed.add(key)
        return _host(sd[key])

    layers = []
    for i in range(config.n_layers):
        p = f"layers.{i}."
        lp = {
            "attn_norm": take(p + "input_layernorm.weight"),
            "wq": take(p + "self_attn.q_proj.weight"),
            "wk": take(p + "self_attn.k_proj.weight"),
            "wv": take(p + "self_attn.v_proj.weight"),
            "wo": take(p + "self_attn.o_proj.weight"),
            "mlp_norm": take(p + "post_attention_layernorm.weight"),
            "w_gate": take(p + "mlp.gate_proj.weight"),
            "w_up": take(p + "mlp.up_proj.weight"),
            "w_down": take(p + "mlp.down_proj.weight"),
        }
        if config.qkv_bias:
            lp["bq"] = take(p + "self_attn.q_proj.bias")
            lp["bk"] = take(p + "self_attn.k_proj.bias")
            lp["bv"] = take(p + "self_attn.v_proj.bias")
        if config.sandwich_norms:
            # gemma2: post_attention_layernorm is the sandwich norm after
            # attention (llama's is the pre-MLP norm); the MLP's pair are
            # pre/post_feedforward_layernorm
            lp["post_attn_norm"] = lp.pop("mlp_norm")
            lp["mlp_norm"] = take(p + "pre_feedforward_layernorm.weight")
            lp["post_ffw_norm"] = take(
                p + "post_feedforward_layernorm.weight")
        layers.append(lp)

    # every layer-scoped weight must have been consumed: an unknown key
    # means a family variant whose extra weights would be silently
    # dropped (gemma3 q/k norms, ...)
    leftovers = sorted(
        k for k in sd
        if k.startswith("layers.") and k not in consumed
        and not k.endswith((".rotary_emb.inv_freq",)))   # buffer, derived
    if leftovers:
        raise ValueError(
            f"unconverted layer weights {leftovers[:4]}... — this HF "
            "variant carries weights the converter does not map")

    shapes = llama.param_shapes(config)

    def place(name, host, shape, f32: bool, lead=()):
        # HF holds linear weights [out, in] where the port holds [in, out]
        transpose = not f32 and name != "embed"
        hf_shape = tuple(lead) + (tuple(reversed(shape)) if transpose
                                  else tuple(shape))
        if tuple(host.shape) != hf_shape:
            raise ValueError(f"HF weight for {name} has shape "
                             f"{tuple(host.shape)}, the config wants "
                             f"{hf_shape} (HF layout)")
        t = host.to(dev).to(torch.float32 if f32 else dtype)
        return t.mT.contiguous() if transpose else t

    stacked = {}
    for k in list(layers[0]):
        shape, f32 = shapes["layers"][k]
        parts = [lp.pop(k) for lp in layers]   # the stack is the only copy
        for i, part in enumerate(parts):
            if part.shape != parts[0].shape:
                raise ValueError(f"HF weight for layers/{k} has shape "
                                 f"{tuple(part.shape)} in layer {i}, "
                                 f"{tuple(parts[0].shape)} in layer 0")
        stacked[k] = place(f"layers/{k}", torch.stack(parts), shape, f32,
                           lead=(config.n_layers,))
        del parts
    params = {"embed": place("embed", take("embed_tokens.weight"),
                             *shapes["embed"]),
              "layers": stacked,
              "final_norm": place("final_norm", take("norm.weight"),
                                  *shapes["final_norm"])}
    if not config.tie_embeddings:
        # lm_head lives OUTSIDE the HF "model." prefix
        params["lm_head"] = place("lm_head",
                                  _host(state_dict["lm_head.weight"]),
                                  *shapes["lm_head"])
    return params


def _shard_files(path: str) -> list:
    """The safetensors shards of a HF directory: the index's when there
    is one, else the ``model*.safetensors`` files (official repos may
    also ship a ``consolidated.safetensors`` in the raw, non-HF key
    layout, which would trip the unconsumed-weights check)."""
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            return sorted(set(json.load(f)["weight_map"].values()))
    files = sorted(f for f in os.listdir(path)
                   if f.endswith(".safetensors")
                   and not f.startswith("consolidated"))
    if any(f.startswith("model") for f in files):
        files = [f for f in files if f.startswith("model")]
    return files


def load_hf_checkpoint(path: str, device=None):
    """(config, params on ``device``) from a HF model directory
    (config.json + safetensors shards, or ``pytorch_model*.bin``)."""
    with open(os.path.join(path, "config.json")) as f:
        config = config_from_hf(json.load(f))
    dev = resolve_device(device)
    state = {}
    files = _shard_files(path)
    if files:
        for fn in files:
            state.update(load_file(os.path.join(path, fn)))
    else:
        for fn in sorted(f for f in os.listdir(path)
                         if f.startswith("pytorch_model")
                         and f.endswith(".bin")):
            state.update(torch.load(os.path.join(path, fn),
                                    map_location="cpu", weights_only=True))
    return config, from_hf(config, state, device=dev)


# -- reverse direction: the port -> HuggingFace -------------------------------

_HF_ARCH = {"llama": "LlamaForCausalLM", "mistral": "MistralForCausalLM",
            "qwen2": "Qwen2ForCausalLM", "gemma": "GemmaForCausalLM",
            "gemma2": "Gemma2ForCausalLM"}


def _no_moe(config) -> None:
    if io.family_name(config) == "moe":
        raise ValueError("MoE configs have no HF mapping: HF export "
                         "covers the llama family only")


def config_to_hf(config: LlamaConfig) -> dict:
    """HF config.json dict for a LlamaConfig: the inverse of
    :func:`config_from_hf`. The family is derived from the knobs:
    sandwich norms -> gemma2, GeGLU -> gemma, qkv biases -> qwen2,
    sliding window -> mistral, else llama."""
    _no_moe(config)
    c = config
    if c.sandwich_norms:
        model_type = "gemma2"
    elif c.act == "gelu":
        model_type = "gemma"
    elif c.qkv_bias:
        model_type = "qwen2"
    elif c.sliding_window:
        model_type = "mistral"
    else:
        model_type = "llama"
    out = {
        "model_type": model_type,
        "architectures": [_HF_ARCH[model_type]],
        "vocab_size": c.vocab_size,
        "hidden_size": c.d_model,
        "intermediate_size": c.d_ff,
        "num_hidden_layers": c.n_layers,
        "num_attention_heads": c.n_heads,
        "num_key_value_heads": c.n_kv_heads,
        "rope_theta": c.rope_theta,
        "rms_norm_eps": c.rms_eps,
        "max_position_embeddings": c.max_seq_len,
        "tie_word_embeddings": bool(c.tie_embeddings),
        "torch_dtype": "float32",
    }
    if c.head_dim:
        out["head_dim"] = c.head_dim
    if model_type in ("mistral", "qwen2") and c.sliding_window:
        out["sliding_window"] = c.sliding_window
        out["use_sliding_window"] = True
    if model_type in ("gemma", "gemma2"):
        out["hidden_activation"] = "gelu_pytorch_tanh"
    if model_type == "gemma2":
        out["sliding_window"] = c.sliding_window
        out["attn_logit_softcapping"] = c.attn_logit_softcap or None
        out["final_logit_softcapping"] = c.logit_softcap or None
        out["query_pre_attn_scalar"] = c.query_scale or 256.0
    return out


def to_hf(config: LlamaConfig, params: dict) -> dict:
    """The port's parameter dict -> a HF ``*ForCausalLM`` state dict of
    contiguous float32 host tensors in the ``[out, in]`` layout: the exact
    inverse of :func:`from_hf`. Each stacked weight is widened and
    transposed where it lives, then copied to the host once."""
    _no_moe(config)
    c = config

    def host(t, transpose=False):
        t = t.detach().float()
        return (t.mT.contiguous() if transpose else t).cpu()

    layers = {k: host(v, transpose=k not in _F32)
              for k, v in params["layers"].items()}
    sd = {"model.embed_tokens.weight": host(params["embed"]),
          "model.norm.weight": host(params["final_norm"])}
    if not c.tie_embeddings:
        sd["lm_head.weight"] = host(params["lm_head"], transpose=True)
    names = {"wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
             "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
             "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight",
             "w_down": "mlp.down_proj.weight",
             "attn_norm": "input_layernorm.weight",
             "bq": "self_attn.q_proj.bias", "bk": "self_attn.k_proj.bias",
             "bv": "self_attn.v_proj.bias"}
    if c.sandwich_norms:
        # inverse of from_hf's gemma2 remap
        names.update(post_attn_norm="post_attention_layernorm.weight",
                     mlp_norm="pre_feedforward_layernorm.weight",
                     post_ffw_norm="post_feedforward_layernorm.weight")
    else:
        names["mlp_norm"] = "post_attention_layernorm.weight"
    for i in range(c.n_layers):
        for k, v in layers.items():
            sd[f"model.layers.{i}.{names[k]}"] = v[i]
    return sd


def save_hf_checkpoint(config: LlamaConfig, params: dict,
                       path: str) -> None:
    """Write a loadable HF model directory: config.json +
    model.safetensors (+ tokenizer assets if the caller copies them)."""
    sd = to_hf(config, params)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_hf(config), f, indent=1)
    save_file(sd, os.path.join(path, "model.safetensors"))


def main(argv=None) -> int:
    """``python -m kubedl_tpu_torch.models.convert HF_DIR OUT_DIR``: one
    command from a HuggingFace checkpoint to a self-contained serving
    artifact (``models.io`` layout, which the JAX package loads too)
    plus the checkpoint's tokenizer assets. ``--reverse`` goes the other
    way: an artifact becomes a loadable HF directory (config.json +
    model.safetensors). The weights pass through ``--device``, the card
    unless ``cpu`` is named."""
    import argparse

    from ..tokenizer import copy_tokenizer_assets

    p = argparse.ArgumentParser(prog="python -m kubedl_tpu_torch.models.convert")
    p.add_argument("src", help="HuggingFace model directory (or, with "
                   "--reverse, an artifact directory)")
    p.add_argument("dst", help="output directory")
    p.add_argument("--no-tokenizer", action="store_true",
                   help="skip copying tokenizer assets")
    p.add_argument("--reverse", action="store_true",
                   help="export an artifact to HF format")
    p.add_argument("--device", default=None,
                   help="device the weights pass through (default: the "
                   "card; 'cpu' to convert without one)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    if args.reverse:
        config, params = io.load_model(args.src, device=dev)
        t1 = time.perf_counter()
        save_hf_checkpoint(config, params, args.dst)
        kind = f"HF {config_to_hf(config)['model_type']} format"
    else:
        config, params = load_hf_checkpoint(args.src, device=dev)
        t1 = time.perf_counter()
        io.save_model(config, params, args.dst)
        kind = f"{config.num_params / 1e6:.1f}M params"
    t2 = time.perf_counter()
    copied = ([] if args.no_tokenizer
              else copy_tokenizer_assets(args.src, args.dst))
    print(f"{'exported' if args.reverse else 'converted'} {args.src} -> "
          f"{args.dst} ({kind}; load {t1 - t0:.2f} s, write "
          f"{t2 - t1:.2f} s"
          + (f"; tokenizer assets: {', '.join(copied)}" if copied
             else "; no tokenizer assets found") + ")")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
