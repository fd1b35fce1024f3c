"""Import hygiene of the PyTorch port: it imports no JAX and nothing of
the JAX package, and its entry points refuse to run on the CPU unless
asked to."""

import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "kubedl_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PKG.rglob("*.py"))
#: an import of the JAX package (``kubedl_tpu`` not followed by ``_torch``)
_JAX_PKG_IMPORT = re.compile(r"\b(?:import|from)\s+kubedl_tpu(?!_torch)\b")


def test_the_training_slice_modules_are_checked():
    """The hygiene checks below walk the package: the training slice's
    modules are among what they import and scan."""
    assert {"kubedl_tpu_torch.ops.loss", "kubedl_tpu_torch.parallel.mesh",
            "kubedl_tpu_torch.train", "kubedl_tpu_torch.train.data",
            "kubedl_tpu_torch.train.trainer",
            "kubedl_tpu_torch.train.__main__"} <= set(MODULES)


def test_the_continuous_serving_slice_modules_are_checked():
    """...and so are the continuous-batching engine and the predictor
    entry point."""
    assert {"kubedl_tpu_torch.serving.batching",
            "kubedl_tpu_torch.serving.__main__",
            "kubedl_tpu_torch.serving.speculative"} <= set(MODULES)


def test_the_gemma_quantization_and_lora_slice_modules_are_checked():
    """...and so are the Gemma family, weight quantization, LoRA and the
    adapter catalog (the port's own copy of the framework-free module)."""
    assert {"kubedl_tpu_torch.models.gemma", "kubedl_tpu_torch.ops.quant",
            "kubedl_tpu_torch.ops.lora",
            "kubedl_tpu_torch.serving.adapters"} <= set(MODULES)


def test_the_moe_slice_modules_are_checked():
    """...and so is the MoE family."""
    assert "kubedl_tpu_torch.models.moe" in set(MODULES)


def test_the_checkpoint_conversion_and_training_modes_slice_is_checked():
    """...and so are HF conversion with the port's own safetensors I/O,
    the MLP and ResNet families, checkpoints, evaluation, DPO and the
    scoring helpers (the port's own copy of the framework-free module)."""
    assert {"kubedl_tpu_torch.models.safetensors_io",
            "kubedl_tpu_torch.models.convert", "kubedl_tpu_torch.models.mlp",
            "kubedl_tpu_torch.models.resnet",
            "kubedl_tpu_torch.train.checkpoint",
            "kubedl_tpu_torch.train.evaluate", "kubedl_tpu_torch.train.dpo",
            "kubedl_tpu_torch.train.scoring"} <= set(MODULES)


def test_the_rendezvous_and_sharding_slice_modules_are_checked():
    """...and so are the rendezvous, the sharding rules, the training
    collectives and the local launcher."""
    assert {"kubedl_tpu_torch.runtime",
            "kubedl_tpu_torch.runtime.bootstrap",
            "kubedl_tpu_torch.parallel.sharding",
            "kubedl_tpu_torch.parallel.collectives",
            "kubedl_tpu_torch.parallel.launch"} <= set(MODULES)


def test_the_tensor_parallel_serving_modules_are_checked():
    """...and so is the step channel of tensor-parallel serving, with its
    follower process's entry point (port-only, no JAX twin)."""
    assert {"kubedl_tpu_torch.serving.tp",
            "kubedl_tpu_torch.serving.engine",
            "kubedl_tpu_torch.parallel.launch"} <= set(MODULES)


def test_the_context_and_expert_parallel_modules_are_checked():
    """...and so are ring and Ulysses attention, the context-parallel
    twins of the JAX package's modules."""
    assert {"kubedl_tpu_torch.parallel.ring",
            "kubedl_tpu_torch.parallel.ulysses"} <= set(MODULES)


def test_the_pipeline_and_rl_modules_are_checked():
    """...and so are pipeline parallelism, GRPO and the RL learner."""
    assert {"kubedl_tpu_torch.parallel.pipeline",
            "kubedl_tpu_torch.train.grpo", "kubedl_tpu_torch.rl",
            "kubedl_tpu_torch.rl.learner"} <= set(MODULES)


#: JAX modules -> their twins, whose public functions and classes (and the
#: classes' public methods) the twin has too
TWINS = {f"kubedl_tpu/{path}.py": f"kubedl_tpu_torch.{path.replace('/', '.')}"
         for path in ("parallel/pipeline", "train/grpo", "rl/learner",
                      "train/__main__", "train/trainer")}


@pytest.mark.parametrize("source", sorted(TWINS))
def test_the_twins_have_the_jax_modules_public_names(source):
    """Read from the JAX sources without importing them: since slice 14
    none is missing (``build_pp_pretrain``, ``run_grpo``,
    ``resolve_reward`` and ``Trainer.remesh`` were)."""
    import ast
    import importlib
    mod = importlib.import_module(TWINS[source])
    missing = []
    for node in ast.parse((ROOT / source).read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                or node.name.startswith("_"):
            continue
        if not hasattr(mod, node.name):
            missing.append(node.name)
        elif isinstance(node, ast.ClassDef):
            missing += [f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and not m.name.startswith("_")
                        and not hasattr(getattr(mod, node.name), m.name)]
    assert not missing, missing


def test_every_module_imports_with_jax_blocked():
    code = ("import sys\nsys.modules['jax'] = None\n"
            "import importlib\n"
            f"for name in {MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not any(m == 'kubedl_tpu' or m.startswith('kubedl_tpu.')"
            " for m in sys.modules)\n"
            "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_import_of_the_jax_package(path):
    text = (ROOT / path).read_text()
    assert not _JAX_PKG_IMPORT.search(text), path
    assert not re.search(r"^\s*(?:import|from)\s+jax\b", text, re.M), path


def test_entry_points_refuse_the_cpu_without_a_card(monkeypatch, tmp_path):
    from kubedl_tpu_torch import resolve_device
    from kubedl_tpu_torch.models import convert, io, llama, mlp, resnet
    from kubedl_tpu_torch.serving import __main__ as serve_main
    from kubedl_tpu_torch.serving import batching, engine
    from kubedl_tpu_torch.train import Trainer
    from kubedl_tpu_torch.train import __main__ as train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=1,
                            n_heads=2, n_kv_heads=1, d_ff=64,
                            dtype="float32")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    io.save_model(cfg, params, str(tmp_path))
    train_cfg = tmp_path / "train.json"
    train_cfg.write_text('{"model": "llama.tiny", "steps": 1}')
    calls = {
        "resolve_device": lambda: resolve_device(),
        "resolve_device(cuda)": lambda: resolve_device("cuda"),
        "init_params": lambda: llama.init_params(
            cfg, torch.Generator().manual_seed(0)),
        "init_cache": lambda: llama.init_cache(cfg, 1, 8),
        "load_model": lambda: io.load_model(str(tmp_path)),
        "params_from_numpy": lambda: io.params_from_numpy(cfg, {}),
        "InferenceEngine": lambda: engine.InferenceEngine(cfg, params),
        "init_block_pool": lambda: llama.init_block_pool(cfg, 4, 8),
        "ContinuousBatchingEngine": lambda: batching.ContinuousBatchingEngine(
            cfg, params, lanes=1, max_len=16),
        "serving.build_engine": lambda: serve_main.build_engine(
            str(tmp_path), 1, "", 0, max_len=16),
        "Trainer.init_state": lambda: Trainer(lambda p, b: 0).init_state(
            params),
        "train.__main__.main": lambda: train_main.main(
            ["--config", str(train_cfg)]),
        "convert.main": lambda: convert.main(
            ["--reverse", str(tmp_path), str(tmp_path / "hf")]),
        "load_hf_checkpoint": lambda: convert.load_hf_checkpoint(
            str(tmp_path / "hf_in")),
        "resnet.init_params": lambda: resnet.init_params(
            resnet.tiny(), torch.Generator().manual_seed(0)),
        "mlp.init_params": lambda: mlp.init_params(
            mlp.MLPConfig(), torch.Generator().manual_seed(0)),
    }
    (tmp_path / "hf_in").mkdir()
    (tmp_path / "hf_in" / "config.json").write_text(
        json.dumps(convert.config_to_hf(cfg)))
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    monkeypatch.setenv("KUBEDL_MODEL_PATH", str(tmp_path))
    monkeypatch.delenv("KUBEDL_TOKENIZER", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main.main(["--batch-input", str(train_cfg),
                         "--batch-output", str(tmp_path / "out.jsonl")])
    # asked for explicitly, the CPU runs
    eng = engine.InferenceEngine(cfg, params, device="cpu")
    assert len(eng.generate([[1, 2, 3]], 2)[0]) == 2


def test_moe_entry_points_refuse_the_cpu_without_a_card(monkeypatch,
                                                        tmp_path):
    from kubedl_tpu_torch.models import io, moe
    from kubedl_tpu_torch.serving import batching
    from kubedl_tpu_torch.train import __main__ as train_main

    cfg = moe.MoEConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                        n_kv_heads=1, d_ff=64, n_experts=4, dtype="float32")
    params = moe.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    io.save_model(cfg, params, str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train_cfg = tmp_path / "train.json"
    train_cfg.write_text('{"model": "moe.tiny", "steps": 1}')
    calls = {
        "init_params": lambda: moe.init_params(
            cfg, torch.Generator().manual_seed(0)),
        "init_layer": lambda: moe.init_layer(
            cfg, torch.Generator().manual_seed(0)),
        "init_cache": lambda: moe.init_cache(cfg, 1, 8),
        "init_block_pool": lambda: moe.init_block_pool(cfg, 4, 8),
        "load_model": lambda: io.load_model(str(tmp_path)),
        "ContinuousBatchingEngine": lambda: batching.ContinuousBatchingEngine(
            cfg, params, lanes=1, max_len=16),
        "train.__main__.main": lambda: train_main.main(
            ["--config", str(train_cfg)]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    got, _ = io.load_model(str(tmp_path), device="cpu")
    assert got == cfg
