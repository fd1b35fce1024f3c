"""Checkpoints of a sharded train state across world sizes, and the train
entrypoint across processes.

A 4-rank gloo group (``fsdp=2, tp=2``) trains Llama tiny through
``Trainer.fit`` with a checkpoint every step (``max_to_keep`` 2, async
writes), then a 2-rank group (``fsdp=2``) and one process with no group
restore the last step: every leaf (params and both Adam moments) equals
the saved one bit for bit, and a further step trains. The 2-rank group
also runs ``python -m kubedl_tpu_torch.train``'s ``main(device="cpu")``
in every mode (``pretrain`` with a checkpoint and an export, ``sft``,
``lora`` under ``tp=2``, ``evaluate`` for perplexity and for choices,
``dpo``), ``"mesh": {"fsdp": 2}`` unless named: its losses and results
are the one-process run's, and only rank 0 writes. Each group is
spawned once (``parallel.launch.spawn``) and returns numpy.
"""

import json
import os

import numpy as np
import pytest
import torch

from kubedl_tpu_torch.parallel import launch

STEPS = 4
BATCH, SEQ, VOCAB = 8, 32, 256
OPT = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=10)


def _cfg():
    import dataclasses

    from kubedl_tpu_torch.models import llama
    return dataclasses.replace(llama.tiny(vocab=VOCAB, seq=64),
                               dtype="float32")


def _params(seed: int):
    from kubedl_tpu_torch.models import llama
    return llama.init_params(_cfg(), torch.Generator().manual_seed(seed),
                             device="cpu")


def _trainer(mesh):
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.train import trainer as ttrainer
    cfg = _cfg()

    def loss_fn(p, b):
        return llama.loss_fn(cfg, p, b["tokens"], b["targets"], mesh=mesh)
    place = ({"param_specs": llama.param_specs(cfg), "mesh": mesh}
             if mesh is not None else {"device": "cpu"})
    return ttrainer.Trainer(loss_fn, ttrainer.TrainConfig(**OPT), **place)


def _batches(mesh, skip=0):
    from kubedl_tpu_torch.train import data as tdata
    raw = tdata.synthetic_lm_batches(BATCH, SEQ, VOCAB, seed=3, skip=skip)
    return tdata.prefetch_to_device(raw, "cpu", mesh=mesh)


def _whole(state) -> dict:
    """Every leaf of a train state, gathered whole, as numpy."""
    from kubedl_tpu_torch.parallel.sharding import full_tensor
    from kubedl_tpu_torch.train.trainer import tree_leaves
    def copy(t):       # a copy: the optimizer updates the state in place
        return full_tensor(t).detach().numpy().copy()
    out = {f"params/{k}": copy(v) for k, v in tree_leaves(state.params)}
    for name in ("mu", "nu"):
        out.update({f"{name}/{k}": copy(v)
                    for k, v in getattr(state.opt_state, name).items()})
    out["step"] = np.int64(state.step)
    out["count"] = np.int64(state.opt_state.count)
    return out


def _restore_and_step(directory, mesh):
    """Restore the latest step into a state initialized from other
    weights, then take one more step: (restored leaves, the restore
    through ``abstract_state``'s target, the next loss)."""
    from kubedl_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                   CheckpointManager)
    trainer = _trainer(mesh)
    mgr = CheckpointManager(CheckpointConfig(directory))
    state = mgr.restore(trainer.init_state(_params(seed=99)))
    other = mgr.restore(trainer.abstract_state(state))
    got, again = _whole(state), _whole(other)
    state, loss = trainer.step(state, next(_batches(mesh, skip=STEPS)))
    return got, again, float(loss), mgr.latest_data_state()


def save_ranks(directory):
    """4 ranks: train ``STEPS`` steps, saving every step."""
    import torch.distributed as dist

    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.runtime import bootstrap
    from kubedl_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                   CheckpointManager)
    bootstrap.initialize_distributed(device="cpu")
    mesh = tmesh.build_mesh(tmesh.MeshConfig(fsdp=2, tp=2), device="cpu")
    trainer = _trainer(mesh)
    mgr = CheckpointManager(CheckpointConfig(
        directory, save_interval_steps=1, max_to_keep=2, async_save=True))
    batches = _batches(mesh)
    state = trainer.fit(trainer.init_state(_params(seed=0)), batches,
                        STEPS, log_every=0, checkpoint_manager=mgr,
                        data_state_fn=lambda: {"consumed": STEPS})
    out = {"state": _whole(state), "steps": mgr.all_steps(),
           "latest": mgr.latest_step(), "rank": dist.get_rank()}
    dist.destroy_process_group()
    return out


def restore_ranks(directory, configs):
    """2 ranks: restore the 4-rank checkpoint, step; then the train
    entrypoint on each of ``configs`` (``{name: path}``)."""
    import torch.distributed as dist

    from kubedl_tpu_torch.models import io
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.runtime import bootstrap
    from kubedl_tpu_torch.train import __main__ as tmain
    bootstrap.initialize_distributed(device="cpu")
    mesh = tmesh.build_mesh(tmesh.MeshConfig(fsdp=2), device="cpu")
    got, again, loss, cursor = _restore_and_step(directory, mesh)
    writes = []
    save_model = io.save_model
    io.save_model = lambda *a, **k: (writes.append(a[2]),
                                     save_model(*a, **k))
    runs = {name: _main_run(tmain, path) for name, path in configs.items()}
    io.save_model = save_model
    out = {"restored": got, "again": again, "loss": loss, "cursor": cursor,
           "runs": runs, "writes": writes,
           "still_open": dist.is_initialized()}
    dist.destroy_process_group()
    return out


def _main_run(tmain, path) -> dict:
    losses = []
    rc = tmain.main(["--config", path], device="cpu",
                    on_step=lambda s, v: losses.append(v))
    return {"rc": rc, "losses": losses}


def _main_configs(tmp, tag, mesh) -> dict:
    """``{mode name: config path}`` of the entrypoint runs; ``mesh``
    None for the one-process run. Every mode on a byte-tokenizer-sized
    Llama tiny in float32."""
    sft = tmp / "sft.jsonl"
    sft.write_text("\n".join(json.dumps(
        {"prompt": f"question {i}?", "response": f"answer {i}."})
        for i in range(8)))
    evals = tmp / "eval.jsonl"
    evals.write_text("\n".join(json.dumps(
        {"prompt": f"question {i}?", "options": ["yes", "no", f"maybe {i}"],
         "answer": i % 3}) for i in range(5)))
    rng = np.random.default_rng(0)
    pairs = tmp / "pairs.jsonl"
    pairs.write_text("\n".join(json.dumps(
        {"chosen": [1, 5, 6, 7] + rng.integers(3, 200, 4).tolist(),
         "rejected": [1, 5, 6, 7] + rng.integers(3, 200, 2).tolist(),
         "prompt_len": 4}) for _ in range(8)))
    byte = {"tokenizer": "byte"}
    modes = {
        "pretrain": {"data": {"kind": "synthetic", "seed": 1},
                     "checkpoint": {"directory": str(tmp / f"{tag}_ck"),
                                    "save_interval_steps": 2},
                     "export_path": str(tmp / f"{tag}_export")},
        "sft": {"mode": "sft",
                "data": {"kind": "sft_jsonl", "path": str(sft), **byte}},
        "lora_tp": {"data": {"kind": "synthetic", "seed": 2},
                    "lora": {"rank": 4}, "mesh": {"tp": 2}},
        # synthetic: every rank draws the same global batch (a text or
        # token corpus gives each data rank its own stride of documents,
        # as each JAX host takes its own)
        "perplexity": {"mode": "evaluate", "steps": 2,
                       "data": {"kind": "synthetic", "seed": 4}},
        "choices": {"mode": "evaluate",
                    "data": {"kind": "eval_jsonl", "path": str(evals),
                             **byte}},
        "dpo": {"mode": "dpo",
                "data": {"kind": "dpo_jsonl", "path": str(pairs)}},
    }
    out = {}
    for name, over in modes.items():
        cfg = {"model": "llama.tiny",
               "model_overrides": {"dtype": "float32", "vocab_size": 288},
               "batch": BATCH, "seq": SEQ, "steps": 3, "log_every": 1,
               "optimizer": {"learning_rate": 1e-2, "warmup_steps": 1},
               **over}
        if cfg.get("mode") == "evaluate":
            cfg["results_path"] = str(tmp / f"{tag}_{name}.json")
        if mesh is None:
            cfg.pop("mesh", None)
        else:
            cfg.setdefault("mesh", mesh)
        path = tmp / f"{tag}_{name}.json"
        path.write_text(json.dumps(cfg))
        out[name] = str(path)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_ck")
    directory = str(tmp / "ck")
    saved = launch.spawn(save_ranks, 4, directory, timeout=180)
    restored = launch.spawn(restore_ranks, 2, directory,
                            _main_configs(tmp, "ranks", {"fsdp": 2}),
                            timeout=180)
    single = _restore_and_step(directory, None)
    from kubedl_tpu_torch.train import __main__ as tmain
    one = {name: _main_run(tmain, path)
           for name, path in _main_configs(tmp, "one", None).items()}
    return tmp, saved, restored, single, one


def test_every_rank_agrees_on_the_kept_steps(runs):
    _, saved, _, _, _ = runs
    for rank in saved:
        assert rank["steps"] == [STEPS - 1, STEPS]
        assert rank["latest"] == STEPS
    assert sorted(os.listdir(runs[0] / "ck")) == [str(STEPS - 1),
                                                    str(STEPS)]


def test_only_rank_zero_writes_the_data_cursor(runs):
    tmp = runs[0]
    step_dir = tmp / "ck" / str(STEPS)
    assert json.loads((step_dir / "data.json").read_text()) == \
        {"consumed": STEPS}
    assert sorted(os.listdir(step_dir)) == ["data.json", "state"]


@pytest.mark.parametrize("where", ["two_ranks", "two_ranks_abstract",
                                   "one_process", "one_process_abstract"])
def test_a_four_rank_checkpoint_restores_bit_for_bit(runs, where):
    _, saved, restored, single, _ = runs
    want = saved[0]["state"]
    got = {"two_ranks": restored[0]["restored"],
           "two_ranks_abstract": restored[0]["again"],
           "one_process": single[0],
           "one_process_abstract": single[1]}[where]
    assert set(got) == set(want)
    assert int(got["step"]) == STEPS and int(got["count"]) == STEPS
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_the_restored_state_trains(runs):
    _, _, restored, single, _ = runs
    for loss in [r["loss"] for r in restored] + [single[2]]:
        assert np.isfinite(loss)
    assert restored[0]["loss"] == restored[1]["loss"]
    np.testing.assert_allclose(restored[0]["loss"], single[2], rtol=1e-5)
    assert restored[0]["cursor"] == single[3] == {"consumed": STEPS}


@pytest.mark.parametrize("mode", ["pretrain", "sft", "lora_tp", "dpo"])
def test_the_entrypoint_across_two_ranks_gives_the_one_process_losses(
        runs, mode):
    _, _, restored, _, one = runs
    want = one[mode]
    assert want["rc"] == 0 and len(want["losses"]) == 3
    for rank in restored:
        assert rank["runs"][mode]["rc"] == 0 and rank["still_open"]
        np.testing.assert_allclose(rank["runs"][mode]["losses"],
                                   want["losses"], rtol=1e-5)


@pytest.mark.parametrize("mode", ["perplexity", "choices"])
def test_evaluate_across_two_ranks_gives_the_one_process_results(runs,
                                                                 mode):
    tmp, _, restored, _, one = runs
    assert restored[0]["runs"][mode]["rc"] == one[mode]["rc"] == 0
    got = json.loads((tmp / f"ranks_{mode}.json").read_text())
    want = json.loads((tmp / f"one_{mode}.json").read_text())
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
        else:
            assert got[k] == v, k


def test_only_rank_zero_writes_the_export(runs):
    tmp, _, restored, _, _ = runs
    assert restored[0]["writes"] == [str(tmp / "ranks_export")]
    assert restored[1]["writes"] == []
    from kubedl_tpu_torch.models import io
    cfg, params = io.load_model(str(tmp / "ranks_export"), device="cpu")
    _, want = io.load_model(str(tmp / "one_export"), device="cpu")
    from kubedl_tpu_torch.train.trainer import tree_leaves
    shapes = {k: tuple(v.shape) for k, v in tree_leaves(params)}
    assert shapes == {k: tuple(v.shape) for k, v in tree_leaves(want)}
    assert sorted(os.listdir(tmp / "ranks_ck")) == ["2", "3"]


def test_world_size_one_through_the_sharded_path_is_bit_for_bit(
        tmp_path, monkeypatch):
    """The train entrypoint under a rendezvous contract for one process
    opens a one-rank group, trains on DTensor state through the sharded
    trainer and closes the group: its losses and export equal the
    unsharded run's bit for bit (every collective is skipped at world
    size 1). On one CPU thread: with several, the CPU's embedding
    backward adds a token's rows in varying order, and two unsharded
    runs differ too. The card runs this at Gemma-2B's size
    (``chip_smoke.py`` ``[dist]``)."""
    import torch.distributed as dist

    from kubedl_tpu_torch.models import io
    from kubedl_tpu_torch.train import __main__ as tmain
    from kubedl_tpu_torch.train.trainer import tree_leaves

    def run(name, mesh=None):
        cfg = {"model": "gemma.tiny",
               "model_overrides": {"dtype": "float32", "vocab_size": VOCAB},
               "batch": BATCH, "seq": SEQ, "steps": 3, "log_every": 1,
               "data": {"kind": "synthetic", "seed": 1},
               "optimizer": {"learning_rate": 1e-2, "warmup_steps": 1},
               "export_path": str(tmp_path / f"{name}_export")}
        if mesh:
            cfg["mesh"] = mesh
        path = tmp_path / f"{name}_gemma.json"
        path.write_text(json.dumps(cfg))
        losses = []
        assert tmain.main(["--config", str(path)], device="cpu",
                          on_step=lambda s, v: losses.append(v)) == 0
        return losses, dict(tree_leaves(io.load_model(
            cfg["export_path"], device="cpu")[1]))

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want, want_params = run("unsharded")
        monkeypatch.setenv("KUBEDL_COORDINATOR_ADDRESS",
                           f"127.0.0.1:{launch.free_port()}")
        monkeypatch.setenv("KUBEDL_NUM_PROCESSES", "1")
        monkeypatch.setenv("KUBEDL_PROCESS_ID", "0")
        got, got_params = run("world_one", {"fsdp": -1})
    finally:
        monkeypatch.undo()
        torch.set_num_threads(threads)
    assert not dist.is_initialized()
    assert got == want
    for k, v in want_params.items():
        assert torch.equal(got_params[k], v), k
