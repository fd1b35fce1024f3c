"""``python -m kubedl_tpu_torch.train``'s slice-10 modes on the CPU, held
against ``python -m kubedl_tpu.train`` on the same JAX-made artifact:
``mode: evaluate`` (perplexity over a byte-tokenized corpus, and
multiple-choice choices), ``mode: dpo`` (the first loss ln 2, the
exported weights), ``eval.every``, ``checkpoint`` with a resume that
ends bit for bit where an uninterrupted run ends, ``export_hf_path``
(LoRA folded first), and the refusals left: ``grpo`` (ROADMAP A7) and
the in-cluster elastic agent (A8)."""

import dataclasses
import json
import logging
import math
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.train.__main__ import main as jmain
from kubedl_tpu_torch.models import convert as tconvert
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.models import safetensors_io as sio
from kubedl_tpu_torch.train import __main__ as tmain
from kubedl_tpu_torch.train.trainer import tree_leaves

#: a byte-tokenizer-sized llama, one layer
#: (batches of 8 rows where the JAX entry point runs: its default mesh
#: spreads them over the 8 CPU devices the test session makes)
SHAPE = dict(vocab_size=288, d_model=64, n_layers=1, n_heads=4,
             n_kv_heads=2, d_ff=128, max_seq_len=256)
OPT = {"learning_rate": 1e-2, "warmup_steps": 1, "decay_steps": 10}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A JAX-made float32 llama artifact both entry points fine-tune."""
    cfg = dataclasses.replace(jllama.tiny(), dtype=jnp.float32, **SHAPE)
    path = str(tmp_path_factory.mktemp("train_main") / "art")
    jio.save_model(cfg, jllama.init_params(cfg, jax.random.PRNGKey(1)),
                   path)
    return path


def _config(tmp_path, name, **cfg) -> list:
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({"log_every": 1, "optimizer": OPT, **cfg}))
    return ["--config", str(path)]


def _both(tmp_path, name, **cfg) -> tuple:
    """Run the JAX entry point and the port's on the same config, each
    with its own ``results_path`` when the config asks for one."""
    out = {}
    for side, main in (("jax", jmain), ("torch", None)):
        over = dict(cfg)
        if "results_path" in over:
            over["results_path"] = str(tmp_path / f"{name}_{side}.json")
        if "export_path" in over:
            over["export_path"] = str(tmp_path / f"{name}_{side}")
        args = _config(tmp_path, f"{name}_{side}", **over)
        rc = main(args) if main else tmain.main(args, device="cpu")
        assert rc == 0
        out[side] = over
    return out["jax"], out["torch"]


def test_evaluate_perplexity_matches_the_jax_entry_point(artifact,
                                                         tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(
        f"document {i}: the quick brown fox jumps over {i * 7} lazy dogs"
        for i in range(24)))
    j, t = _both(tmp_path, "ppl", model={"model_path": artifact},
                 mode="evaluate", batch=8, seq=64, steps=3,
                 data={"kind": "text", "path": str(corpus),
                       "tokenizer": "byte"}, results_path="x")
    want = json.loads(open(j["results_path"]).read())
    got = json.loads(open(t["results_path"]).read())
    assert got["kind"] == want["kind"] == "perplexity"
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=1e-5)


def test_evaluate_choices_match_the_jax_entry_point(artifact, tmp_path):
    rows = [{"prompt": f"question {i}?",
             "options": ["yes", "no", f"maybe {i}"], "answer": i % 3}
            for i in range(5)]
    rows.append({"prompt": [1, 40, 41], "options": [[50], [60, 61]],
                 "answer": 1})
    path = tmp_path / "eval.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    j, t = _both(tmp_path, "mc", model={"model_path": artifact},
                 mode="evaluate",
                 data={"kind": "eval_jsonl", "path": str(path),
                       "tokenizer": "byte"}, results_path="x")
    want = json.loads(open(j["results_path"]).read())
    got = json.loads(open(t["results_path"]).read())
    assert got == want
    assert got["kind"] == "loglikelihood" and got["questions"] == 6


def _pairs(tmp_path, n=8):
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(n):
        prompt = [1] + rng.integers(3, 200, 3).tolist()
        rows.append({"chosen": prompt + rng.integers(3, 200, 4).tolist(),
                     "rejected": prompt + rng.integers(3, 200, 2).tolist(),
                     "prompt_len": 4})
    path = tmp_path / "pairs.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return str(path)


def _leaves(path, jax_side=False):
    cfg, params = (jio.load_model(path) if jax_side
                   else tio.load_model(path, device="cpu"))
    if jax_side:
        out = {k: np.asarray(v) for k, v in params.items() if k != "layers"}
        out.update({f"layers/{k}": np.asarray(v)
                    for k, v in params["layers"].items()})
        return out
    return {k: v.numpy() for k, v in tree_leaves(params)}


def test_dpo_matches_the_jax_entry_point(artifact, tmp_path):
    pairs = _pairs(tmp_path)
    losses = []
    cfg = dict(model={"model_path": artifact}, mode="dpo", batch=8,
               steps=3, data={"kind": "dpo_jsonl", "path": pairs},
               dpo={"beta": 0.2}, export_path="x",
               optimizer={"learning_rate": 1e-3, "warmup_steps": 1,
                          "decay_steps": 10})
    j, _ = _both(tmp_path, "dpo_ref", **cfg)
    assert tmain.main(_config(tmp_path, "dpo", **dict(
        cfg, export_path=str(tmp_path / "dpo_port"))), device="cpu",
        on_step=lambda s, loss: losses.append(loss)) == 0
    # the policy starts as the reference: ln 2 exactly, then it moves
    assert abs(losses[0] - math.log(2)) < 1e-6
    assert losses[-1] < losses[0]
    want = _leaves(j["export_path"], jax_side=True)
    got = _leaves(str(tmp_path / "dpo_port"))
    # two updates at lr 1e-3 (the first step's warmup lr is 0). Adam's
    # 1/(sqrt(nu) + 1e-8) turns a float32 difference of a near-zero
    # gradient into up to lr of parameter per step; at 1e-2 one element
    # of 8192 lands 1.06e-4 apart (the JAX side's gradients are reduced
    # over its 8-device mesh), at 1e-3 every one sits under 1e-4
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def _eval_lines(text):
    return [float(m) for m in re.findall(r"eval val_nll ([0-9.]+)", text)]


def test_eval_every_matches_the_jax_entry_point(artifact, tmp_path, capsys):
    cfg = dict(model={"model_path": artifact}, batch=8, seq=32, steps=4,
               eval={"every": 2, "data": {"kind": "synthetic", "seed": 9},
                     "max_batches": 2})
    assert jmain(_config(tmp_path, "ev_jax", **cfg)) == 0
    want = _eval_lines(capsys.readouterr().out)
    assert tmain.main(_config(tmp_path, "ev_torch", **cfg),
                      device="cpu") == 0
    got = _eval_lines(capsys.readouterr().out)
    assert len(got) == len(want) == 2     # steps 2 and 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    with pytest.raises(ValueError, match="eval.data"):
        tmain.main(_config(tmp_path, "ev_bad", **dict(cfg, eval={
            "every": 2})), device="cpu")


def test_checkpoint_resume_ends_bit_identical(artifact, tmp_path, caplog):
    base = dict(model={"model_path": artifact}, batch=2, seq=32)
    ck = {"directory": str(tmp_path / "ck"), "save_interval_steps": 2}
    seen = []

    def step(s, loss):
        seen.append((s, loss))

    assert tmain.main(_config(tmp_path, "a", **base, steps=2,
                              checkpoint=ck), device="cpu",
                      on_step=step) == 0
    caplog.clear()
    caplog.set_level(logging.INFO)
    assert tmain.main(_config(tmp_path, "b", **base, steps=2, checkpoint=ck,
                              export_path=str(tmp_path / "resumed")),
                      device="cpu", on_step=step) == 0
    assert "resumed from checkpoint step 2" in caplog.text
    assert "resuming stream at batch 2" in caplog.text
    whole = []
    assert tmain.main(_config(tmp_path, "c", **base, steps=4,
                              export_path=str(tmp_path / "whole")),
                      device="cpu", on_step=lambda s, l: whole.append(
                          (s, l))) == 0
    assert seen == whole
    got, want = _leaves(str(tmp_path / "resumed")), \
        _leaves(str(tmp_path / "whole"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(int(p.name) for p in (tmp_path / "ck").iterdir()) \
        == [2, 4]


@pytest.mark.parametrize("lora", [None, {"rank": 4}])
def test_export_hf_path_writes_the_trained_weights(artifact, tmp_path,
                                                   lora):
    over = {"lora": lora} if lora else {}
    assert tmain.main(_config(
        tmp_path, "hf", model={"model_path": artifact}, batch=2, seq=32,
        steps=2, export_path=str(tmp_path / "art"),
        export_hf_path=str(tmp_path / "hf"), **over), device="cpu") == 0
    cfg, _ = tconvert.load_hf_checkpoint(str(tmp_path / "hf"),
                                         device="cpu")
    assert cfg.vocab_size == SHAPE["vocab_size"]
    # the HF file holds float32: read it at that width
    params = tconvert.from_hf(
        dataclasses.replace(cfg, dtype="float32"),
        sio.load_file(str(tmp_path / "hf" / "model.safetensors")),
        device="cpu")
    want = _leaves(str(tmp_path / "art"))
    got = {k: v.float().numpy() for k, v in tree_leaves(params)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the folded adapters moved the attention weights off the artifact's
    base = _leaves(artifact)
    assert not np.array_equal(want["layers/wq"], base["layers/wq"])


def test_what_is_still_refused(artifact, tmp_path, monkeypatch):
    # GRPO runs (test_torch_grpo.py); without prompts it refuses as the
    # JAX entrypoint does
    with pytest.raises(ValueError,
                       match="mode=grpo needs data.kind='prompts_jsonl'"):
        tmain.main(_config(tmp_path, "grpo", mode="grpo"), device="cpu")
    with pytest.raises(ValueError, match="lora applies"):
        tmain.main(_config(tmp_path, "lora_dpo", mode="dpo",
                           lora={"rank": 4}), device="cpu")
    for key, value in (("KUBEDL_JOB_KIND", "PyTorchJob"),
                       ("KUBEDL_JOB_NAMESPACE", "default"),
                       ("KUBEDL_JOB_NAME", "j"),
                       ("KUBERNETES_SERVICE_HOST", "10.0.0.1")):
        monkeypatch.setenv(key, value)
    cfg = dict(model={"model_path": artifact}, batch=2, seq=32, steps=1)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tmain.main(_config(tmp_path, "agent", **cfg, checkpoint={
            "directory": str(tmp_path / "ck")}), device="cpu")
    # without a checkpoint section there is no agent to run
    assert tmain.main(_config(tmp_path, "no_agent", **cfg),
                      device="cpu") == 0
