"""Pipeline-parallel training of the port across processes, held against
the JAX ``build_pp_pretrain`` ``Trainer`` on the same ``MeshConfig``
(``jax.devices()[:4]`` of the fake CPU mesh) and against the port's own
pipeline in one process.

One 4-rank gloo group is spawned once for the file
(``parallel.launch.spawn``); every case runs in it and returns numpy. The
weights are JAX-made float32 and cross over as numpy
(``models.io.params_from_numpy``). Meshes: Llama tiny (4 layers) at
``pp=4``, ``pp=2,fsdp=2`` and ``pp=2,dp=2``, the same with an SFT mask at
``pp=4``, and Gemma tiny at ``pp=2`` (its tied embedding is used on stage
0 for the lookup and on stage 1 for the head). The first step's loss and
every gathered gradient are held within 1e-5 relative, and 3 steps'
losses.

Also in the group: ``pipeline_grads_1f1b`` across the ranks against the
one-process schedule (bit for bit), the train entrypoint's ``main`` at
``"mesh": {"pp": 2}`` (a checkpoint resumed bit for bit against an
uninterrupted run, and the flat export, which the JAX package loads), and
the refusals, each with the JAX entrypoint's type and message.

The worker functions import nothing of JAX (the ranks import this
module); the JAX side runs in the test process only.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from kubedl_tpu_torch.parallel import launch

WORLD = 4
STEPS = 3
BATCH, SEQ, VOCAB, LAYERS = 8, 32, 256, 4
OPT = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=10,
           weight_decay=0.1, grad_clip=1.0)
#: name -> (family, mesh, SFT mask)
CASES = {
    "llama-pp4": ("llama", {"pp": 4}, False),
    "llama-pp2_fsdp2": ("llama", {"pp": 2, "fsdp": 2}, False),
    "llama-pp2_dp2": ("llama", {"pp": 2, "dp": 2}, False),
    "llama-pp4-sft": ("llama", {"pp": 4}, True),
    "gemma-pp2": ("gemma", {"pp": 2}, False),
}
#: the entrypoint's refusals under pp: name -> (config overrides, model
#: overrides); each is raised on every rank and by the JAX entrypoint
REFUSALS = {
    "mode": ({"mode": "dpo"}, {}),
    "lora": ({"lora": {"rank": 4}}, {}),
    "moe": ({"model": "moe.tiny"}, {}),
    "tp": ({"mesh": {"pp": 2, "tp": 2}}, {}),
    "text": ({"data": {"kind": "text", "path": "unread.jsonl",
                       "tokenizer": "byte"}}, {}),
    "num_micro": ({"pipeline": {"num_micro": 3}}, {}),
    "width": ({"pipeline": {"num_micro": 8}}, {}),
    "layers": ({"mesh": {"pp": 4}}, {"n_layers": 2}),
    "window": ({"model": "gemma.tiny"},
               {"sliding_window": 8, "window_pattern": "alternate"}),
}


def _tcfg(kind: str):
    from kubedl_tpu_torch.models import gemma, llama
    make = {"llama": llama.tiny, "gemma": gemma.tiny}[kind]
    return dataclasses.replace(make(vocab=VOCAB, seq=64), dtype="float32",
                               n_layers=LAYERS)


def _batches(sft: bool):
    from kubedl_tpu_torch.train.data import synthetic_lm_batches
    stream = synthetic_lm_batches(BATCH, SEQ, VOCAB, seed=5)
    out = [next(stream) for _ in range(STEPS)]
    if sft:
        rng = np.random.default_rng(6)
        for b in out:
            b["mask"] = (rng.random((BATCH, SEQ)) > 0.4).astype(np.float32)
    return out


def _np(t) -> np.ndarray:
    return t.detach().float().numpy().copy()


def run_case(kind, mesh_kw, sft, params_np):
    """One case on this rank's pp mesh: the first step's loss and whole
    gradients (the leaves outside the stages summed over pp, as the
    trainer sums them), then the losses of ``STEPS`` steps."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from kubedl_tpu_torch.models import io
    from kubedl_tpu_torch.parallel import collectives, sharding
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.train import __main__ as tmain
    from kubedl_tpu_torch.train import data as tdata
    from kubedl_tpu_torch.train import trainer as ttrainer

    cfg = _tcfg(kind)
    mesh = tmesh.build_mesh(tmesh.MeshConfig(**mesh_kw), device="cpu")
    loss_fn, to_pp, _, specs_of = tmain.build_pp_pretrain(
        cfg, mesh, max(2, mesh.size("pp")))
    params = to_pp(io.params_from_numpy(cfg, params_np, device="cpu"))
    trainer = ttrainer.Trainer(loss_fn, ttrainer.TrainConfig(**OPT),
                               param_specs=specs_of(params), mesh=mesh)
    state = trainer.init_state(params)
    batches = _batches(sft)

    placed = dict(ttrainer.tree_leaves(state.params))
    view = sharding.views(state.params, mesh, requires_grad=True)
    leaves = ttrainer.tree_leaves(view)
    share = loss_fn(view, {k: sharding.local_of(v) for k, v in
                           tdata.shard_batch(batches[0], mesh).items()})
    grads = torch.autograd.grad(share, [p.local for _, p in leaves],
                                materialize_grads=True)

    def whole(k, g):
        if not k.startswith("stages/"):
            dist.all_reduce(g, group=mesh.group("pp"))
        p = placed[k]
        return _np(DTensor.from_local(g, p.device_mesh, p.placements,
                                      run_check=False, shape=p.shape,
                                      stride=p.stride()).full_tensor())

    out = {"grad_loss": float(collectives.world_sum(share)),
           "grads": {k: whole(k, g) for (k, _), g in zip(leaves, grads)}}
    losses = []
    for b in batches:
        state, loss = trainer.step(state, tdata.shard_batch(b, mesh))
        losses.append(float(loss))
    out["losses"] = losses
    return out


def _mlp_1f1b(stages_or_mesh):
    """``pipeline_grads_1f1b`` on a tanh MLP of 8 layers, 8 microbatches:
    (loss, this process's stage gradients, head gradients)."""
    from kubedl_tpu_torch.parallel import pipeline as tpipe
    rng = np.random.default_rng(0)
    layers = {"w": torch.from_numpy(
        (rng.standard_normal((8, 8, 8)) * 0.3).astype(np.float32))}
    head = {"w": torch.from_numpy(
        rng.standard_normal((8, 8)).astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    stages = tpipe.stack_stages(layers, 4)
    where = tpipe.stages_of(stages_or_mesh)
    if len(where.ranks) == 1:
        stages = {k: v[where.ranks[0]:where.ranks[0] + 1]
                  for k, v in stages.items()}
    loss, sg, hg = tpipe.pipeline_grads_1f1b(
        where, tpipe.stage_scan(lambda h, lp: torch.tanh(h @ lp["w"])),
        stages, head, x, {}, 8,
        lambda hp, y, aux: ((y @ hp["w"]) ** 2).mean())
    return [_np(loss), _np(sg["w"]), _np(hg["w"])]


def _main_config(tmp, name, steps, **extra) -> str:
    cfg = {"model": "llama.tiny",
           "model_overrides": {"dtype": "float32", "vocab_size": VOCAB,
                               "n_layers": LAYERS},
           "batch": BATCH, "seq": SEQ, "steps": steps, "log_every": 1,
           "mesh": {"pp": 2},
           "data": {"kind": "synthetic", "seed": 1},
           "optimizer": {"learning_rate": 1e-2, "warmup_steps": 1},
           **extra}
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _refusal_config(tmp, name) -> str:
    over, model_over = REFUSALS[name]
    cfg = {"model": "llama.tiny", "batch": BATCH, "seq": SEQ, "steps": 1,
           "model_overrides": {"vocab_size": VOCAB, **model_over},
           "mesh": {"pp": 2}, **over}
    path = tmp / f"refuse_{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _main_losses(path) -> list:
    from kubedl_tpu_torch.train import __main__ as tmain
    losses = []
    assert tmain.main(["--config", path], device="cpu",
                      on_step=lambda s, v: losses.append(v)) == 0
    return losses


def _refused(path) -> tuple:
    from kubedl_tpu_torch.train import __main__ as tmain
    try:
        tmain.main(["--config", path], device="cpu")
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None, "not refused"


def rank_main(params_by_kind, main_paths, refusal_paths):
    """One rank: open the group, run every case, 1F1B across the ranks,
    the entrypoint runs and the refusals."""
    import torch.distributed as dist

    from kubedl_tpu_torch.parallel import collectives
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.runtime import bootstrap

    bootstrap.initialize_distributed(device="cpu")
    out = {"cases": {name: run_case(*CASES[name],
                                    params_by_kind[CASES[name][0]])
                     for name in CASES}}
    out["1f1b"] = _mlp_1f1b(tmesh.build_mesh(tmesh.MeshConfig(pp=4),
                                             device="cpu"))
    out["main"] = {name: _main_losses(p) for name, p in main_paths}
    out["refused"] = {name: _refused(p) for name, p in refusal_paths.items()}
    out["staged"] = collectives.pp_shift.host_staged
    if dist.get_rank() != 0:   # rank 0 carries the arrays back
        for res in out["cases"].values():
            res.pop("grads")
    dist.destroy_process_group()
    return out


# -- the test process: references and checks -------------------------------

def _jax_params(kind):
    import jax

    from kubedl_tpu.models import gemma as jgemma
    from kubedl_tpu.models import llama as jllama
    make = {"llama": jllama.tiny, "gemma": jgemma.tiny}[kind]
    cfg = dataclasses.replace(make(vocab=VOCAB, seq=64), dtype=np.float32,
                              n_layers=LAYERS)
    params = jax.jit(lambda k: jllama.init_params(cfg, k))(
        jax.random.PRNGKey(7))
    return cfg, jax.tree.map(lambda x: np.asarray(x, np.float32), params)


def _jax_case(kind, mesh_kw, sft, params_np):
    """The JAX entrypoint's ``build_pp_pretrain`` on the same MeshConfig
    over 4 devices: the first step's loss and gradients, and the
    ``Trainer``'s losses."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.parallel import mesh as jmesh
    from kubedl_tpu.parallel import sharding as jsharding
    from kubedl_tpu.train import __main__ as jmain
    from kubedl_tpu.train import data as jdata
    from kubedl_tpu.train import trainer as jtrainer
    cfg, _ = _jax_params(kind)
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**mesh_kw),
                            devices=jax.devices()[:WORLD])
    loss_fn, to_pp, _, specs_of = jmain.build_pp_pretrain(
        cfg, mesh, max(2, mesh.shape["pp"]))
    params = to_pp(jax.tree.map(jnp.asarray, params_np))
    specs = specs_of(params)

    def placed():
        return jax.tree.map(lambda x, s: jax.device_put(x, s), params,
                            jsharding.tree_shardings(mesh, specs))

    batches = [jdata.shard_batch(b, mesh) for b in _batches(sft)]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(placed(), batches[0])
    trainer = jtrainer.Trainer(loss_fn, specs, mesh,
                               jtrainer.TrainConfig(**OPT))
    state = trainer.init_state(placed())
    state = jtrainer.TrainState(
        step=jax.device_put(state.step, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec())),
        params=state.params, opt_state=state.opt_state)
    losses = []
    for b in batches:
        state, step_loss = trainer.step(state, b)
        losses.append(float(step_loss))
    flat = {}
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        flat["/".join(str(k.key) for k in path)] = np.asarray(g, np.float32)
    return {"grad_loss": float(loss), "grads": flat, "losses": losses}


def _jax_refusal(path):
    """The JAX entrypoint's refusal of the same config (its mesh laid over
    the 8 fake devices)."""
    from kubedl_tpu.train import __main__ as jmain
    try:
        jmain.main(["--config", path])
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None, "not refused"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, JAX results, JAX refusals, the entrypoint runs'
    directory). The JAX cases compile on a thread pool while the ranks
    run."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("pp")
    params = {kind: _jax_params(kind)[1] for kind in ("llama", "gemma")}
    main_paths = [
        ("whole", _main_config(tmp, "whole", 4,
                               export_path=str(tmp / "art_whole"),
                               eval={"every": 2, "max_batches": 1,
                                     "data": {"kind": "synthetic",
                                              "seed": 3}})),
        ("first", _main_config(tmp, "first", 2, checkpoint={
            "directory": str(tmp / "ck"), "save_interval_steps": 2})),
        ("resumed", _main_config(tmp, "resumed", 2, checkpoint={
            "directory": str(tmp / "ck"), "save_interval_steps": 2},
            export_path=str(tmp / "art_resumed"))),
    ]
    refusal_paths = {n: _refusal_config(tmp, n) for n in REFUSALS}
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = {name: pool.submit(_jax_case, *CASES[name],
                                     params[CASES[name][0]])
                   for name in CASES}
        refused = pool.submit(lambda: {n: _jax_refusal(p) for n, p in
                                       refusal_paths.items()})
        ranks = launch.spawn(rank_main, WORLD, params, main_paths,
                             refusal_paths, timeout=400)
        jax_ref = {name: f.result() for name, f in futures.items()}
        jax_refused = refused.result()
    return ranks, jax_ref, jax_refused, tmp


def _close_grads(got, want, rel):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=0, err_msg=k,
            atol=rel * max(float(np.abs(want[k]).max()), 1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_first_step_matches_the_jax_pipeline_trainer(runs, name):
    ranks, jax_ref = runs[:2]
    got, want = ranks[0]["cases"][name], jax_ref[name]
    np.testing.assert_allclose(got["grad_loss"], want["grad_loss"],
                               rtol=1e-5)
    _close_grads(got["grads"], want["grads"], 1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_over_three_steps_match(runs, name):
    ranks, jax_ref = runs[:2]
    for rank in ranks:        # every rank reports the same global loss
        assert rank["cases"][name]["losses"] == \
            ranks[0]["cases"][name]["losses"]
    np.testing.assert_allclose(ranks[0]["cases"][name]["losses"],
                               jax_ref[name]["losses"], rtol=1e-5)


def test_1f1b_across_ranks_is_the_one_process_schedule(runs):
    """Each rank's ``pipeline_grads_1f1b`` on its stage of a ``pp=4``
    group: the loss and head gradients (summed over pp) and its own
    stage's gradients are the one-process schedule's, bit for bit (the
    exchange moves the same tensors between the same slots); gloo takes
    CPU tensors as they are, so nothing went through the host."""
    from kubedl_tpu_torch.parallel import pipeline as tpipe
    loss, sg, hg = _mlp_1f1b(tpipe.local_stages(4))
    for r, rank in enumerate(runs[0]):
        got_loss, got_sg, got_hg = rank["1f1b"]
        np.testing.assert_array_equal(got_loss, loss)
        np.testing.assert_array_equal(got_sg, sg[r:r + 1])
        np.testing.assert_array_equal(got_hg, hg)
        assert rank["staged"] == 0


def test_main_resumes_a_pp_checkpoint_bit_for_bit_and_exports_flat(runs):
    """``main`` at ``"mesh": {"pp": 2}`` (fsdp absorbs the other 2 ranks):
    2 steps with a checkpoint at step 2, then a fresh job on the same
    directory trains steps 3-4; its losses and its export are an
    uninterrupted 4-step job's (which also evaluates every 2 steps on the
    flat forward over the gathered stages), bit for bit. The export is
    the flat ``[L, ...]`` layout the JAX package loads."""
    from kubedl_tpu.models import io as jio
    from kubedl_tpu_torch.models import io as tio
    ranks, tmp = runs[0], runs[3]
    for rank in ranks:
        whole = rank["main"]["whole"]
        assert rank["main"]["first"] == whole[:2]
        assert rank["main"]["resumed"] == whole[2:]
    cfg, got = tio.load_model(str(tmp / "art_resumed"), device="cpu")
    _, want = tio.load_model(str(tmp / "art_whole"), device="cpu")
    assert got["layers"]["wq"].shape[0] == LAYERS == cfg.n_layers
    from kubedl_tpu_torch.train.trainer import tree_leaves
    want = dict(tree_leaves(want))
    for k, v in tree_leaves(got):
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    jcfg, jparams = jio.load_model(str(tmp / "art_resumed"))
    assert jcfg.n_layers == LAYERS
    np.testing.assert_array_equal(np.asarray(jparams["layers"]["wq"]),
                                  want["layers/wq"].numpy())


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_are_the_jax_entrypoints(runs, name):
    """Every rank refuses as the JAX entrypoint does, with its type and
    message. The dp*fsdp width a microbatch must divide is the mesh's
    own (the JAX entrypoint lays its mesh over 8 devices, the ranks are
    4), so that one check is read off the JAX package's message with the
    ranks' width."""
    ranks, _, jax_refused = runs[:3]
    kind, msg = jax_refused[name]
    assert kind is not None, msg
    if name == "width":
        # pp=2 leaves fsdp 4 of 8 devices to the JAX mesh, 2 of 4 ranks
        msg = msg.replace("width 4", "width 2")
    for rank in ranks:
        assert rank["refused"][name] == (kind, msg)
