"""The port's training path held against the JAX package on the CPU: the
optimizer against the optax chain, ``Trainer.step`` against the JAX
``Trainer`` on a one-device mesh, the data streams, the gradients of
``loss_fn`` through the flash Function's plain versions, and the
``python -m kubedl_tpu_torch.train`` entrypoint end to end.

JAX makes the weights (the two RNGs cannot agree); they cross over as
numpy through ``models.io.params_from_numpy``. Batches come from numpy.
"""

import dataclasses
import functools
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.parallel import mesh as jmesh
from kubedl_tpu.train import data as jdata
from kubedl_tpu.train import trainer as jtrainer
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.parallel import mesh as tmesh
from kubedl_tpu_torch.train import __main__ as tmain
from kubedl_tpu_torch.train import data as tdata
from kubedl_tpu_torch.train import trainer as ttrainer
from kubedl_tpu_torch.trace import Tracer

OPT = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=6,
           weight_decay=0.1, grad_clip=1.0)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _torch_tree(tree, dtype):
    return {k: _torch_tree(v, dtype) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, np.float32), dtype=dtype)
            for k, v in tree.items()}


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# -- optimizer -----------------------------------------------------------------

def test_schedule_matches_optax():
    cfg = ttrainer.TrainConfig(**OPT)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps, decay_steps=cfg.decay_steps,
        end_value=cfg.learning_rate * 0.1)
    got = ttrainer.make_optimizer(cfg).schedule
    for step in range(9):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=0, err_msg=f"step {step}")
    assert got(0) == 0.0          # step 1 applies lr 0


#: float32: the same chain op for op, with XLA free to fuse and reorder
#: the elementwise arithmetic: float32 rounding of values of ~1 (1e-6).
#: bf16: params, gradients and the second moment are bf16, rounded at the
#: same places as the jitted chain (equal bit for bit on this CPU); one
#: bf16 ulp at the params' scale (|p| < 2, ulp 2**-7) is left for a
#: backend that fuses differently
OPT_ATOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_matches_the_optax_chain(dtype):
    """Five updates of the same params with the same grads: the port's
    chain against ``kubedl_tpu.train.trainer.make_optimizer``'s, jitted as
    the JAX Trainer runs it. The grads are scaled so the global-norm clip
    engages on some steps only."""
    rng = np.random.default_rng(0)
    shapes = {"embed": (16, 8), "final_norm": (8,), "lm_head": (8, 16),
              "layers": {"wq": (2, 8, 8), "attn_norm": (2, 8)}}

    def draw(tree, scale=1.0):
        return {k: draw(v, scale) if isinstance(v, dict)
                else (rng.standard_normal(v) * scale).astype(np.float32)
                for k, v in tree.items()}

    p0 = draw(shapes)
    cfg = ttrainer.TrainConfig(**OPT)
    jopt = jtrainer.make_optimizer(jtrainer.TrainConfig(**OPT))
    jdt = getattr(jnp, dtype)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p0)
    jstate = jopt.init(jp)
    jupdate = jax.jit(jopt.update)
    topt = ttrainer.make_optimizer(cfg)
    tp = _torch_tree(p0, getattr(torch, dtype))
    tstate = topt.init(tp)
    for step in range(5):
        g = draw(shapes, scale=0.5 if step % 2 else 0.05)
        jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), g)
        updates, jstate = jupdate(jg, jstate, jp)
        jp = jax.tree.map(lambda new, old: new.astype(old.dtype),
                          optax.apply_updates(jp, updates), jp)
        tg = {k: torch.tensor(np.asarray(_leaf(jg, k), np.float32),
                              dtype=getattr(torch, dtype))
              for k, _ in ttrainer.tree_leaves(tp)}
        tstate = topt.apply(tp, tg, tstate)
        assert tstate.count == step + 1
        for k, t in ttrainer.tree_leaves(tp):
            assert t.dtype == getattr(torch, dtype), k
            np.testing.assert_allclose(
                t.float().numpy(), np.asarray(_leaf(jp, k), np.float32),
                atol=OPT_ATOL[dtype], rtol=0, err_msg=f"step {step} {k}")
    adam = jstate[1]
    for k, _ in ttrainer.tree_leaves(tp):
        assert tstate.mu[k].dtype == torch.float32
        assert tstate.nu[k].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(tstate.mu[k].numpy(),
                                   np.asarray(_leaf(adam.mu, k)),
                                   rtol=1e-5, atol=1e-7)


# -- Trainer.step against the JAX Trainer ----------------------------------------

def _jax_run(cfg, params, batches, opt):
    mesh = jmesh.build_mesh(devices=jax.devices()[:1])
    trainer = jtrainer.Trainer(
        lambda p, b: jllama.loss_fn(cfg, p, b["tokens"], b["targets"]),
        jllama.param_specs(cfg), mesh, jtrainer.TrainConfig(**opt))
    state = trainer.init_state(jax.tree.map(jnp.asarray, params))
    losses = []
    for b in batches:
        state, loss = trainer.step(state, {k: jnp.asarray(v)
                                           for k, v in b.items()})
        losses.append(float(loss))
    return losses, _np_tree(state.params)


def _torch_run(tcfg, params, batches, opt):
    trainer = ttrainer.Trainer(
        lambda p, b: tllama.loss_fn(tcfg, p, b["tokens"], b["targets"]),
        ttrainer.TrainConfig(**opt), device="cpu")
    state = trainer.init_state(tio.params_from_numpy(tcfg, params,
                                                     device="cpu"))
    losses = []
    for b in batches:
        state, loss = trainer.step(state, tdata.to_device(
            b, torch.device("cpu")))
        losses.append(float(loss))
    assert state.step == len(batches)
    return losses, state.params


#: Adam divides by sqrt(nu) + 1e-8, so a gradient element the two
#: frameworks compute ~1e-6 apart (float32 sums in another order) moves
#: its update by up to ~1e-6 / 1e-8 of itself where |g| ~ eps; with lr
#: 1e-2 and two steps at full lr that bounds the param gap by ~1e-4
PARAM_ATOL = 1e-4


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_step_matches_jax(accum):
    cfg = dataclasses.replace(jllama.tiny(vocab=256, seq=64),
                              dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.tiny(vocab=256, seq=64),
                               dtype="float32")
    params = _np_tree(jllama.init_params(cfg, jax.random.PRNGKey(3)))
    stream = jdata.synthetic_lm_batches(4, 32, 256, seed=5)
    batches = [next(stream) for _ in range(3)]
    opt = dict(OPT, warmup_steps=1, decay_steps=10, accum_steps=accum)
    jlosses, jparams = _jax_run(cfg, params, batches, opt)
    tlosses, tparams = _torch_run(tcfg, params, batches, opt)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    for k, t in ttrainer.tree_leaves(tparams):
        np.testing.assert_allclose(t.detach().numpy(), _leaf(jparams, k),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_loss_fn_grads_through_the_flash_function_match_jax(monkeypatch):
    """The model's loss and every gradient with attention through the
    flash Function (``impl="plain"``: the kernels' plain versions, the
    remat recompute included) against JAX through its custom_vjp in
    Pallas interpret mode; the chunked LM-head loss on both sides."""
    cfg = dataclasses.replace(jllama.tiny(vocab=256, seq=128),
                              dtype=jnp.float32, loss_chunk=48)
    tcfg = dataclasses.replace(tllama.tiny(vocab=256, seq=128),
                               dtype="float32", loss_chunk=48)
    params = _np_tree(jllama.init_params(cfg, jax.random.PRNGKey(4)))
    toks = np.random.default_rng(6).integers(0, 256, (2, 129),
                                             dtype=np.int32)
    tokens, targets = toks[:, :-1], toks[:, 1:]
    monkeypatch.setattr(jllama, "multi_head_attention", functools.partial(
        jllama.multi_head_attention, impl="pallas_interpret"))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jllama.loss_fn(cfg, p, jnp.asarray(tokens),
                                 jnp.asarray(targets)))(
        jax.tree.map(jnp.asarray, params))
    from kubedl_tpu_torch.ops import attention as tattn
    monkeypatch.setattr(tllama, "multi_head_attention", functools.partial(
        tattn.multi_head_attention, impl="plain"))
    tparams = tio.params_from_numpy(tcfg, params, device="cpu")
    leaves = ttrainer.tree_leaves(tparams)
    for _, t in leaves:
        t.requires_grad_(True)
    loss = tllama.loss_fn(tcfg, tparams, torch.from_numpy(tokens).long(),
                          torch.from_numpy(targets).long())
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    for (k, _), g in zip(leaves, grads):
        want = np.asarray(_leaf(jgrads, k))
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0, err_msg=k,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))


# -- data ----------------------------------------------------------------------

def _same_stream(a, b, n):
    for i in range(n):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y), i
        for k in x:
            assert x[k].dtype == y[k].dtype, (i, k)
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{i} {k}")


@pytest.mark.parametrize("skip", [0, 3])
def test_synthetic_stream_is_bit_identical(skip):
    _same_stream(tdata.synthetic_lm_batches(3, 17, 100, seed=2, skip=skip),
                 jdata.synthetic_lm_batches(3, 17, 100, seed=2, skip=skip),
                 4)


def test_pack_documents_is_bit_identical():
    rng = np.random.default_rng(7)
    docs = [rng.integers(3, 50, rng.integers(1, 40)).tolist()
            for _ in range(60)]
    # a list goes through the JAX package's C++ packer, a generator
    # through its Python loop: the port's loop equals both
    for jdocs in (docs, (d for d in docs)):
        _same_stream(tdata.pack_documents(docs, 24, 3, pad_id=0),
                     jdata.pack_documents(jdocs, 24, 3, pad_id=0), 5)


@pytest.mark.parametrize("skip", [0, 2, 7])
def test_sft_batches_are_bit_identical(skip):
    rng = np.random.default_rng(8)
    exs = [(rng.integers(3, 90, rng.integers(4, 30)).tolist(),
            int(rng.integers(1, 4))) for _ in range(11)]
    _same_stream(tdata.sft_batches(exs, 20, 4, seed=1, skip=skip),
                 jdata.sft_batches(exs, 20, 4, seed=1, skip=skip), 6)


@pytest.mark.parametrize("skip", [0, 5])
def test_token_file_dataset_is_bit_identical(tmp_path, skip):
    path = tmp_path / "toks.bin"
    np.random.default_rng(9).integers(0, 1000, 33 * 21,
                                      dtype=np.int32).tofile(path)
    kw = dict(seq_len=20, batch_size=4, seed=3)
    _same_stream(tdata.TokenFileDataset(str(path), **kw).batches(skip=skip),
                 jdata.TokenFileDataset(str(path), **kw).batches(skip=skip),
                 9)
    assert len(tdata.TokenFileDataset(str(path), **kw)) == 33
    with pytest.raises(ValueError, match="too small"):
        tdata.TokenFileDataset(str(path), seq_len=20, batch_size=40)


def test_cursor_helpers_match_jax():
    draws_t, draws_j = [], []
    assert tdata.skip_epochs(11, 4, lambda: draws_t.append(1)) == \
        jdata.skip_epochs(11, 4, lambda: draws_j.append(1)) == 3
    assert len(draws_t) == len(draws_j) == 2
    it = tdata.CountingIterator(
        tdata.skip_batches(iter([{"a": i} for i in range(6)]), 2),
        consumed=2)
    assert next(it) == {"a": 2} and it.consumed == 3


def test_prefetch_to_device_yields_every_batch_as_tensors():
    stream = tdata.synthetic_lm_batches(2, 5, 50, seed=0)
    want = [next(jdata.synthetic_lm_batches(2, 5, 50, seed=0))]
    got = tdata.prefetch_to_device(iter([next(stream)]), device="cpu",
                                   size=3)
    out = list(got)
    assert len(out) == 1
    assert out[0]["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(out[0]["tokens"].numpy(),
                                  want[0]["tokens"])


# -- mesh, entrypoint ----------------------------------------------------------------

@pytest.mark.parametrize("kw,n", [({}, 1), ({"dp": 2}, 4), ({"fsdp": 4}, 4),
                                  ({"tp": 2, "cp": 2}, 8)])
def test_mesh_resolve_matches_jax(kw, n):
    assert tmesh.MeshConfig(**kw).resolve(n) == \
        jmesh.MeshConfig(**kw).resolve(n)


def test_build_mesh_takes_one_device_only():
    """Without a process group the mesh is this one device: a layout of
    more devices is JAX's resolve error (ranks come from a process
    group, ``tests/test_torch_sharded_train.py``)."""
    mesh = tmesh.build_mesh(tmesh.MeshConfig(dp=1, fsdp=-1), device="cpu")
    assert mesh.device.type == "cpu" and set(mesh.shape.values()) == {1}
    assert mesh.device_mesh is None
    with pytest.raises(ValueError, match="devices, have 1"):
        tmesh.build_mesh(tmesh.MeshConfig(tp=2), device="cpu")


def _write_config(tmp_path, **over):
    cfg = {"model": "llama.tiny",
           "model_overrides": {"dtype": "float32", "vocab_size": 256},
           "batch": 4, "seq": 32, "steps": 4, "log_every": 2,
           "data": {"kind": "synthetic", "seed": 1},
           "optimizer": {"learning_rate": 1e-2, "warmup_steps": 1},
           **over}
    path = tmp_path / "train.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_main_pretrains_and_exports_for_the_jax_package(tmp_path, capsys):
    export = str(tmp_path / "export")
    losses = []
    rc = tmain.main(["--config", _write_config(tmp_path,
                                               export_path=export)],
                    device="cpu", on_step=lambda s, l: losses.append((s, l)))
    assert rc == 0
    assert [s for s, _ in losses] == [1, 2, 3, 4]
    assert all(np.isfinite(l) for _, l in losses)
    assert "step 4 loss" in capsys.readouterr().out
    jcfg, jparams = jio.load_model(export)
    tcfg, tparams = tio.load_model(export, device="cpu")
    assert tcfg.loss_chunk == 512 and jcfg.loss_chunk == 512
    toks = np.random.default_rng(10).integers(0, 256, (2, 16),
                                              dtype=np.int32)
    want = jllama.forward(jcfg, jparams, jnp.asarray(toks))
    with torch.no_grad():
        got = tllama.forward(tcfg, tparams, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_main_sft_masks_the_prompt(tmp_path):
    rows = tmp_path / "sft.jsonl"
    rows.write_text("\n".join(json.dumps(
        {"prompt": f"question {i}?", "response": f"answer {i}."})
        for i in range(6)))
    losses = []
    rc = tmain.main(["--config", _write_config(
        tmp_path, mode="sft", steps=3,
        model_overrides={"dtype": "float32", "vocab_size": 512},
        data={"kind": "sft_jsonl", "path": str(rows),
              "tokenizer": "byte"})], device="cpu",
        on_step=lambda s, l: losses.append(l))
    assert rc == 0 and len(losses) == 3 and all(map(np.isfinite, losses))


@pytest.mark.parametrize("over,error,match", [
    # checkpoints, eval, evaluate/dpo and HF export run since slice 10
    # (test_torch_train_main.py), GRPO since slice 14
    # (test_torch_grpo.py): without its prompts it refuses as the JAX
    # entrypoint does
    ({"mode": "grpo"}, ValueError,
     "mode=grpo needs data.kind='prompts_jsonl'"),
    # the MoE family trains (test_torch_moe_train.py), over ep too
    # (test_torch_cp_ep_train.py), and pipeline stages train since slice
    # 14 (test_torch_pp_train.py): one process holds no pp=2 mesh
    ({"model": "moe.mixtral_8x7b", "mesh": {"pp": 2}}, ValueError,
     "devices, have 1"),
    # dp/fsdp/tp/cp train across processes (test_torch_sharded_*.py,
    # test_torch_cp_ep_train.py), and evaluate/dpo run over cp too since
    # slice 17 (test_torch_cp_eval_dpo.py); the JAX entrypoint's own
    # refusals stand: adapters with a preference loss
    ({"mode": "dpo", "lora": {"rank": 4}}, ValueError,
     "lora applies to mode pretrain/sft"),
])
def test_main_refuses_what_is_not_ported(tmp_path, over, error, match):
    with pytest.raises(error, match=match):
        tmain.main(["--config", _write_config(tmp_path, **over)],
                   device="cpu")


def test_main_refuses_a_multi_process_rendezvous(tmp_path, monkeypatch):
    """Multi-process training runs over the operator's contract
    (``tests/test_torch_sharded_*.py``) or a PyTorchJob's
    (``tests/test_torch_incluster_train.py``). Refused with a
    ``ValueError`` naming what is missing: an incomplete contract, which
    would hang or have each process train alone on one card (a KubeDL
    contract without this worker's process id, the JAX package's rule;
    a torch contract without its rank and master; TPU worker hostnames
    with no worker id; a process count alone)."""
    names = ("KUBEDL_COORDINATOR_ADDRESS", "KUBEDL_NUM_PROCESSES",
             "KUBEDL_PROCESS_ID", "TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID",
             "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
    path = _write_config(tmp_path)
    for env, error, match in [
            ({"KUBEDL_COORDINATOR_ADDRESS": "127.0.0.1:1",
              "KUBEDL_NUM_PROCESSES": "4"}, ValueError,
             "KUBEDL_PROCESS_ID is missing"),
            ({"WORLD_SIZE": "2"}, ValueError,
             "MASTER_ADDR, MASTER_PORT, RANK missing"),
            ({"TPU_WORKER_HOSTNAMES": "h0,h1"}, ValueError,
             "TPU_WORKER_ID is missing"),
            ({"KUBEDL_NUM_PROCESSES": "4"}, ValueError,
             "without KUBEDL_COORDINATOR_ADDRESS")]:
        for name in names:
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        with pytest.raises(error, match=match):
            tmain.main(["--config", path], device="cpu")


def test_fit_records_train_step_spans(monkeypatch):
    trace_id, span_id = "ab" * 16, "cd" * 8
    monkeypatch.setenv("KUBEDL_TRACEPARENT", f"00-{trace_id}-{span_id}-01")
    monkeypatch.setenv("TPU_WORKER_ID", "3")
    tcfg = dataclasses.replace(tllama.tiny(vocab=64, seq=16),
                               dtype="float32", n_layers=1)
    params = tllama.init_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    trainer = ttrainer.Trainer(
        lambda p, b: tllama.loss_fn(tcfg, p, b["tokens"], b["targets"]),
        device="cpu")
    tracer = Tracer(enabled=True)
    state = trainer.fit(trainer.init_state(params),
                        tdata.prefetch_to_device(
                            tdata.synthetic_lm_batches(2, 8, 64),
                            device="cpu"),
                        num_steps=2, log_every=0, tracer=tracer)
    spans = tracer.spans(component="train")
    assert state.step == 2
    assert [s.name for s in spans] == ["train.step"] * 2
    assert [s.attributes["step"] for s in spans] == [1, 2]
    assert all(s.trace_id == trace_id and s.parent_id == span_id
               and s.attributes == {**s.attributes, "tokens": 16,
                                    "replica": "3"} for s in spans)


def test_fit_writes_the_profile_window(tmp_path):
    """The ``profile_dir`` window as one chrome trace, holding the step's
    ``train.loss_and_grads`` and ``train.optimizer`` ranges."""
    tcfg = dataclasses.replace(tllama.tiny(vocab=64, seq=16),
                               dtype="float32", n_layers=1)
    params = tllama.init_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    trainer = ttrainer.Trainer(
        lambda p, b: tllama.loss_fn(tcfg, p, b["tokens"], b["targets"]),
        ttrainer.TrainConfig(profile_dir=str(tmp_path / "prof"),
                             profile_start_step=1, profile_steps=1),
        device="cpu")
    trainer.fit(trainer.init_state(params),
                tdata.prefetch_to_device(
                    tdata.synthetic_lm_batches(2, 8, 64), device="cpu"),
                num_steps=3, log_every=0)
    assert [p.name for p in (tmp_path / "prof").iterdir()] == \
        ["train_step2.json"]
    trace = json.loads((tmp_path / "prof" / "train_step2.json").read_text())
    ranges = [e["name"] for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"]
    assert ranges == ["train.loss_and_grads", "train.optimizer"]


@pytest.mark.parametrize("kind", ["tokens", "text", "mixture"])
def test_main_pretrains_on_each_data_kind(tmp_path, kind):
    """Token files, packed text (segment ids and positions reach the
    model) and a weighted mixture of the two."""
    toks = tmp_path / "toks.bin"
    np.random.default_rng(11).integers(0, 256, 8 * 33,
                                       dtype=np.int32).tofile(toks)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(f"document {i} " * (1 + i % 5)
                                for i in range(40)))
    sources = {"tokens": {"kind": "tokens", "path": str(toks)},
               "text": {"kind": "text", "path": str(corpus),
                        "tokenizer": "byte"}}
    data = (sources[kind] if kind != "mixture" else
            {"kind": "mixture", "sources": [
                {**sources["tokens"], "weight": 1.0},
                {**sources["text"], "weight": 2.0}]})
    losses = []
    rc = tmain.main(["--config", _write_config(
        tmp_path, steps=3, data=data,
        model_overrides={"dtype": "float32", "vocab_size": 512})],
        device="cpu", on_step=lambda s, l: losses.append(l))
    assert rc == 0 and len(losses) == 3 and all(map(np.isfinite, losses))
