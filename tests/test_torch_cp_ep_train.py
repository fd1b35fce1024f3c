"""Context- and expert-parallel training of the port across processes,
held against the port on one process and against the JAX ``Trainer`` on
the same ``MeshConfig`` (``jax.devices()[:4]`` of the fake CPU mesh).

One 4-rank gloo group is spawned once for the file
(``parallel.launch.spawn``); every case runs in it and returns numpy.
The weights are JAX-made float32 and cross over as numpy
(``models.io.params_from_numpy``). Meshes: Llama tiny on the ring at
``cp=4``, ``cp=2,fsdp=2`` and ``cp=2,tp=2``; packed batches (segment
ids, restarting positions, a bool mask ``shard_batch`` leaves whole over
``cp``) at ``cp=2`` through Ulysses and through the ring setting (K/V and
segments all-gathered over ``cp``); Gemma tiny (one KV head) at ``cp=2``
through Ulysses, with and without Gemma-2's attention knobs, and with the
knobs on packed rows through the ring setting (the chunked path on the
rank's rows against the gathered K/V); MoE tiny (4 experts) at
``ep=2,fsdp=2``, ``ep=4`` and
``cp=2`` (routing over the whole sequence). The first step's loss and
every gathered gradient, and the losses of 3 steps, are held within 1e-5
relative in float32; one bf16 run within 4 bf16 ulps of one process.

Also in the group: the ring across ranks against the one-process
schedule (flash bit for bit), an ``ep=2`` checkpoint that the test
process restores at one process bit for bit, and the train entrypoint's
``main`` under ``cp`` (ring and Ulysses) and ``ep``, whose losses are the
one-process run's. The refusals need no group.

The worker functions import nothing of JAX (the ranks import this
module); the JAX side runs in the test process only.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from kubedl_tpu_torch.parallel import launch

WORLD = 4
STEPS = 3
BATCH, SEQ, VOCAB = 8, 32, 256
OPT = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=10,
           weight_decay=0.1, grad_clip=1.0)
#: Gemma-2's attention knobs on Gemma tiny: a query scale, an attention
#: softcap and a sliding window on the even layers (the ring refuses them
#: without segment ids; Ulysses runs them through the chunked path on the
#: full sequence, and the ring setting with segment ids on the rank's rows
#: against the gathered K/V)
GEMMA2_KNOBS = {"query_scale": 16.0, "attn_logit_softcap": 50.0,
                "sliding_window": 12, "window_pattern": "alternate"}
#: name -> (family, dtype, mesh, model overrides, packed batch)
CASES = {
    "llama-cp4": ("llama", "float32", {"cp": 4}, {}, False),
    "llama-cp2_fsdp2": ("llama", "float32", {"cp": 2, "fsdp": 2}, {}, False),
    "llama-cp2_tp2": ("llama", "float32", {"cp": 2, "tp": 2}, {}, False),
    "llama-cp2-ring-packed": ("llama", "float32", {"cp": 2}, {}, True),
    "llama-cp2-ulysses-packed": ("llama", "float32", {"cp": 2},
                                 {"cp_impl": "ulysses"}, True),
    "gemma-cp2-ulysses": ("gemma", "float32", {"cp": 2},
                          {"cp_impl": "ulysses"}, False),
    "gemma2-cp2-ulysses": ("gemma", "float32", {"cp": 2},
                           {"cp_impl": "ulysses", **GEMMA2_KNOBS}, False),
    "gemma2-cp2-ring-packed": ("gemma", "float32", {"cp": 2}, GEMMA2_KNOBS,
                               True),
    "moe-ep2_fsdp2": ("moe", "float32", {"ep": 2, "fsdp": 2}, {}, False),
    "moe-ep4": ("moe", "float32", {"ep": 4}, {}, False),
    "moe-cp2": ("moe", "float32", {"cp": 2}, {}, False),
    "llama-bf16-cp2_fsdp2": ("llama", "bfloat16", {"cp": 2, "fsdp": 2}, {},
                             False),
}
F32 = [n for n, c in CASES.items() if c[1] == "float32"]
BF16_ULPS = 4
#: train-entrypoint runs: name -> (model, mesh, model overrides)
MAIN_RUNS = {"ring": ("llama.tiny", {"cp": 2}, {}),
             "ulysses": ("llama.tiny", {"cp": 2}, {"cp_impl": "ulysses"}),
             "ep": ("moe.tiny", {"ep": 2}, {})}


def _tcfg(kind: str, dtype: str, over: dict):
    from kubedl_tpu_torch.models import gemma, llama, moe
    make = {"llama": llama.tiny, "gemma": gemma.tiny, "moe": moe.tiny}[kind]
    return dataclasses.replace(make(vocab=VOCAB, seq=64), dtype=dtype,
                               **over)


def _packed(seed: int) -> dict:
    """Two or three documents a row, with a padding tail: segment ids
    (-1 on the pads), positions restarting per document, and a bool mask
    over the targets that stay inside a document."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
    seg = np.zeros((BATCH, SEQ), np.int32)
    pos = np.zeros((BATCH, SEQ), np.int32)
    for r in range(BATCH):
        cuts = [0, 5 + r, 17 + r // 2, SEQ - (r % 3)]
        for i in range(3):
            seg[r, cuts[i]:cuts[i + 1]] = i
            pos[r, cuts[i]:cuts[i + 1]] = np.arange(cuts[i + 1] - cuts[i])
        seg[r, cuts[3]:] = -1
    mask = np.concatenate([seg[:, :-1] == seg[:, 1:],
                           np.zeros((BATCH, 1), bool)], 1) & (seg >= 0)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "segment_ids": seg, "positions": pos, "mask": mask}


def _batches(packed: bool):
    if packed:
        return [_packed(9 + i) for i in range(STEPS)]
    from kubedl_tpu_torch.train.data import synthetic_lm_batches
    stream = synthetic_lm_batches(BATCH, SEQ, VOCAB, seed=5)
    return [next(stream) for _ in range(STEPS)]


def _np(t) -> np.ndarray:
    """A float32 numpy copy (the optimizer updates tensors in place)."""
    return t.detach().float().numpy().copy()


def _loss_kwargs(b) -> dict:
    return {k: b[k] for k in ("mask", "segment_ids", "positions") if k in b}


def run_case(kind, dtype, mesh_kw, over, packed, params_np, sharded):
    """One case on this process: under the open group's mesh when
    ``sharded``, else on one device. Returns the first step's loss and
    gradients and the losses of ``STEPS`` steps, all whole."""
    from torch.distributed.tensor import DTensor

    from kubedl_tpu_torch.models import io
    from kubedl_tpu_torch.parallel import collectives, sharding
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.train import data as tdata
    from kubedl_tpu_torch.train import trainer as ttrainer

    cfg = _tcfg(kind, dtype, over)
    fam = io.family_of(cfg)
    mesh = (tmesh.build_mesh(tmesh.MeshConfig(**mesh_kw), device="cpu")
            if sharded else None)
    params = io.params_from_numpy(cfg, params_np, device="cpu")

    def loss_fn(p, b):
        return fam.loss_fn(cfg, p, b["tokens"], b["targets"], mesh=mesh,
                           **_loss_kwargs(b))

    place = ({"param_specs": fam.param_specs(cfg), "mesh": mesh}
             if sharded else {"device": "cpu"})
    trainer = ttrainer.Trainer(loss_fn, ttrainer.TrainConfig(**OPT), **place)
    state = trainer.init_state(params)

    def put(b):
        return (tdata.shard_batch(b, mesh) if sharded
                else tdata.to_device(b, torch.device("cpu")))
    batches = _batches(packed)

    placed = dict(ttrainer.tree_leaves(state.params))
    view = (sharding.views(state.params, mesh, requires_grad=True)
            if sharded else state.params)
    leaves = ttrainer.tree_leaves(view)
    share = loss_fn(view, {k: sharding.local_of(v)
                           for k, v in put(batches[0]).items()})
    grads = torch.autograd.grad(share, [getattr(p, "local", p)
                                        for _, p in leaves])

    def whole(k, g):
        p = placed[k]
        if isinstance(p, DTensor):
            g = DTensor.from_local(g, p.device_mesh, p.placements,
                                   run_check=False, shape=p.shape,
                                   stride=p.stride()).full_tensor()
        return _np(g)

    out = {"grad_loss": float(collectives.world_sum(share) if sharded
                              else share),
           "grads": {k: whole(k, g) for (k, _), g in zip(leaves, grads)}}
    losses = []
    for b in batches:
        state, loss = trainer.step(state, put(b))
        losses.append(float(loss))
    out["losses"] = losses
    return out


def _ring_inputs():
    rng = np.random.default_rng(11)
    return [rng.standard_normal((2, 4 * 16, h, 16), np.float32)
            for h in (4, 2, 2, 4)]          # q, k, v, dO


def ring_across_ranks():
    """Each rank's shard through ``ring_attention`` (flash and dense) on
    the ``cp=4`` ring: outputs and q/k/v gradients of its shard."""
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.parallel import ring as tring
    mesh = tmesh.build_mesh(tmesh.MeshConfig(cp=4), device="cpu")
    my = mesh.index("cp")
    out = {}
    for impl in ("flash", "dense"):
        q, k, v, g = (torch.from_numpy(x).chunk(4, 1)[my].clone()
                      for x in _ring_inputs())
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        o = tring.ring_attention(mesh, q, k, v, causal=True, impl=impl)
        grads = torch.autograd.grad(o, (q, k, v), g)
        out[impl] = [_np(o)] + [_np(x) for x in grads]
    return out


def _tokens_under_cp() -> int:
    """The trainer's token count of one batch placed on a ``cp=2`` mesh
    (each rank holds half of every row)."""
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.train import data as tdata
    from kubedl_tpu_torch.train import trainer as ttrainer
    mesh = tmesh.build_mesh(tmesh.MeshConfig(cp=2), device="cpu")
    return ttrainer._batch_tokens(tdata.shard_batch(_packed(0), mesh))


def ep_checkpoint(directory, params_np):
    """Train MoE tiny one step at ``ep=2,fsdp=2`` and save the state."""
    from kubedl_tpu_torch.models import moe
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.train import data as tdata
    from kubedl_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                   CheckpointManager)
    from kubedl_tpu_torch.train.trainer import tree_leaves
    mesh = tmesh.build_mesh(tmesh.MeshConfig(ep=2, fsdp=2), device="cpu")
    trainer = _moe_trainer(mesh)
    state = trainer.init_state(_moe_params(params_np))
    state, _ = trainer.step(state, tdata.shard_batch(_batches(False)[0],
                                                     mesh))
    mgr = CheckpointManager(CheckpointConfig(directory))
    mgr.save(state, force=True)
    mgr.wait_until_finished()
    specs = {k: str(v.placements) for k, v in tree_leaves(state.params)}
    return {"state": _whole(state), "placements": specs,
            "expert_local": tuple(state.params["layers"]["w_gate"]
                                  .to_local().shape),
            "n_experts": moe.tiny().n_experts}


def _moe_params(params_np):
    from kubedl_tpu_torch.models import io
    return io.params_from_numpy(_tcfg("moe", "float32", {}), params_np,
                                device="cpu")


def _moe_trainer(mesh):
    from kubedl_tpu_torch.models import moe
    from kubedl_tpu_torch.train import trainer as ttrainer
    cfg = _tcfg("moe", "float32", {})

    def loss_fn(p, b):
        return moe.loss_fn(cfg, p, b["tokens"], b["targets"], mesh=mesh)
    place = ({"param_specs": moe.param_specs(cfg), "mesh": mesh}
             if mesh is not None else {"device": "cpu"})
    return ttrainer.Trainer(loss_fn, ttrainer.TrainConfig(**OPT), **place)


def _whole(state) -> dict:
    from kubedl_tpu_torch.parallel.sharding import full_tensor
    from kubedl_tpu_torch.train.trainer import tree_leaves
    out = {f"params/{k}": full_tensor(v).detach().numpy().copy()
           for k, v in tree_leaves(state.params)}
    for name in ("mu", "nu"):
        out.update({f"{name}/{k}": full_tensor(v).detach().numpy().copy()
                    for k, v in getattr(state.opt_state, name).items()})
    out["step"] = np.int64(state.step)
    return out


def _main_config(tmp, name, sharded: bool) -> str:
    model, mesh, over = MAIN_RUNS[name]
    cfg = {"model": model,
           "model_overrides": {"dtype": "float32", "vocab_size": VOCAB,
                               **over},
           "batch": BATCH, "seq": SEQ, "steps": 3, "log_every": 1,
           "data": {"kind": "synthetic", "seed": 1},
           "optimizer": {"learning_rate": 1e-2, "warmup_steps": 1}}
    if sharded:
        cfg["mesh"] = mesh
    path = tmp / f"{name}_{'mesh' if sharded else 'one'}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _main_losses(path) -> list:
    from kubedl_tpu_torch.train import __main__ as tmain
    losses = []
    assert tmain.main(["--config", path], device="cpu",
                      on_step=lambda s, v: losses.append(v)) == 0
    return losses


def rank_main(params_by_kind, directory, main_paths):
    """One rank: open the group, run every case, the ring across ranks,
    the ``ep`` checkpoint and the entrypoint runs."""
    import torch.distributed as dist

    from kubedl_tpu_torch.parallel import collectives
    from kubedl_tpu_torch.runtime import bootstrap

    bootstrap.initialize_distributed(device="cpu")
    out = {"cases": {name: run_case(*CASES[name],
                                    params_by_kind[CASES[name][0]], True)
                     for name in CASES}}
    out["ring"] = ring_across_ranks()
    out["tokens"] = _tokens_under_cp()
    out["ckpt"] = ep_checkpoint(directory, params_by_kind["moe"])
    out["staged"] = collectives.ring_shift.host_staged
    out["main"] = {name: _main_losses(p) for name, p in main_paths.items()}
    if dist.get_rank() != 0:   # rank 0 carries the arrays back
        for res in out["cases"].values():
            res.pop("grads")
        out.pop("ckpt")
    dist.destroy_process_group()
    return out


# -- the test process: references and checks -------------------------------

def _jax_params(kind):
    import jax

    from kubedl_tpu.models import gemma as jgemma
    from kubedl_tpu.models import llama as jllama
    from kubedl_tpu.models import moe as jmoe
    make = {"llama": (jllama, jllama.tiny), "gemma": (jllama, jgemma.tiny),
            "moe": (jmoe, jmoe.tiny)}[kind]
    cfg = dataclasses.replace(make[1](vocab=VOCAB, seq=64),
                              dtype=np.float32)
    params = jax.jit(lambda k: make[0].init_params(cfg, k))(
        jax.random.PRNGKey(7))
    return make[0], cfg, jax.tree.map(lambda x: np.asarray(x, np.float32),
                                      params)


def _jax_case(kind, mesh_kw, over, packed, params_np):
    """The JAX package on the same MeshConfig over 4 devices: the first
    step's loss and gradients, and the ``Trainer``'s losses."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.parallel import mesh as jmesh
    from kubedl_tpu.parallel import sharding as jsharding
    from kubedl_tpu.train import data as jdata
    from kubedl_tpu.train import trainer as jtrainer
    mod, cfg, _ = _jax_params(kind)
    cfg = dataclasses.replace(cfg, **over)
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**mesh_kw),
                            devices=jax.devices()[:WORLD])
    specs = mod.param_specs(cfg)

    def placed():
        return jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s),
                            params_np, jsharding.tree_shardings(mesh, specs))

    def loss_fn(p, b):
        return mod.loss_fn(cfg, p, b["tokens"], b["targets"], mesh=mesh,
                           **_loss_kwargs(b))

    batches = [jdata.shard_batch(b, mesh) for b in _batches(packed)]
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, one-process results, JAX results, one-process
    entrypoint losses, the ``ep`` checkpoint's directory). The JAX cases compile on a
    thread pool while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("cp_ep")
    params = {kind: _jax_params(kind)[2] for kind in ("llama", "gemma",
                                                      "moe")}
    mesh_paths = {n: _main_config(tmp, n, True) for n in MAIN_RUNS}
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = {name: pool.submit(_jax_case, CASES[name][0],
                                     *CASES[name][2:],
                                     params[CASES[name][0]])
                   for name in F32}
        ranks = launch.spawn(rank_main, WORLD, params, str(tmp / "ckpt"),
                             mesh_paths, timeout=400)
        single = {name: run_case(*CASES[name], params[CASES[name][0]],
                                 False) for name in CASES}
        main_single = {n: _main_losses(_main_config(tmp, n, False))
                       for n in MAIN_RUNS}
        jax_ref = {name: f.result() for name, f in futures.items()}
    return ranks, single, jax_ref, main_single, tmp / "ckpt"


def _close_grads(got, want, rel):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=0, err_msg=k,
            atol=rel * max(float(np.abs(want[k]).max()), 1e-30))


@pytest.mark.parametrize("name", F32)
def test_first_step_matches_one_process(runs, name):
    ranks, single = runs[:2]
    got, want = ranks[0]["cases"][name], single[name]
    np.testing.assert_allclose(got["grad_loss"], want["grad_loss"],
                               rtol=1e-5)
    _close_grads(got["grads"], want["grads"], 1e-5)


@pytest.mark.parametrize("name", F32)
def test_first_step_matches_the_jax_sharded_trainer(runs, name):
    ranks, _, jax_ref = runs[:3]
    got, want = ranks[0]["cases"][name], jax_ref[name]
    np.testing.assert_allclose(got["grad_loss"], want["grad_loss"],
                               rtol=1e-5)
    _close_grads(got["grads"], want["grads"], 1e-5)


@pytest.mark.parametrize("name", F32)
def test_losses_over_three_steps_match(runs, name):
    ranks, single, jax_ref = runs[:3]
    for rank in ranks:        # every rank reports the same global loss
        assert rank["cases"][name]["losses"] == \
            ranks[0]["cases"][name]["losses"]
    got = ranks[0]["cases"][name]["losses"]
    np.testing.assert_allclose(got, single[name]["losses"], rtol=1e-5)
    np.testing.assert_allclose(got, jax_ref[name]["losses"], rtol=1e-5)


def _bf16_atol(ref) -> float:
    top = float(np.abs(ref).max())
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


def test_bf16_run_within_four_ulps_of_one_process(runs):
    name = "llama-bf16-cp2_fsdp2"
    ranks, single = runs[:2]
    got, want = ranks[0]["cases"][name], single[name]
    np.testing.assert_allclose(got["grad_loss"], want["grad_loss"],
                               atol=_bf16_atol(want["grad_loss"]))
    np.testing.assert_allclose(got["losses"], want["losses"],
                               atol=_bf16_atol(want["losses"]))
    for k in want["grads"]:
        np.testing.assert_allclose(got["grads"][k], want["grads"][k],
                                   atol=_bf16_atol(want["grads"][k]),
                                   rtol=0, err_msg=k)


def test_ring_across_ranks_is_the_one_process_schedule(runs):
    """The ranks' ring (P2P shifts over gloo) against ``ring_schedule``
    on the same shards: the flash ring bit for bit (the same block steps
    and accumulation order), the dense ring within 1e-6 (autograd adds a
    key block's gradient in another order)."""
    from kubedl_tpu_torch.parallel import ring as tring
    ranks = runs[0]
    q, k, v, g = _ring_inputs()
    for impl in ("flash", "dense"):
        qs, ks, vs = ([t.clone().requires_grad_()
                       for t in torch.from_numpy(x).chunk(4, 1)]
                      for x in (q, k, v))
        outs = tring.ring_schedule(qs, ks, vs, causal=True, impl=impl)
        grads = torch.autograd.grad(outs, qs + ks + vs,
                                    list(torch.from_numpy(g).chunk(4, 1)))
        for my, rank in enumerate(ranks):
            want = [outs[my]] + [grads[i * 4 + my] for i in range(3)]
            for what, a, b in zip(("out", "dq", "dk", "dv"),
                                  rank["ring"][impl], want):
                b = _np(b)
                if impl == "flash":
                    np.testing.assert_array_equal(a, b, err_msg=what)
                else:
                    np.testing.assert_allclose(
                        a, b, rtol=0, err_msg=what,
                        atol=1e-6 * float(np.abs(b).max()))
    # CPU tensors: gloo carries them as they are, nothing is staged
    assert all(r["staged"] == 0 for r in ranks)


def test_the_trainer_counts_every_token_under_cp(runs):
    """``Trainer.fit``'s token count (the step spans' tokens) covers the
    global batch, not a rank's half of each row."""
    assert [r["tokens"] for r in runs[0]] == [BATCH * SEQ] * WORLD


def test_ep_checkpoint_restores_at_one_process_bit_for_bit(runs):
    """The ``ep=2`` ranks hold 2 of the 4 experts of every stack (stored
    as DTensors sharded on ``ep``); one process restores the whole state
    bit for bit and keeps training."""
    from kubedl_tpu_torch.models import moe as tmoe
    from kubedl_tpu_torch.train import data as tdata
    from kubedl_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                   CheckpointManager)
    ranks, directory = runs[0], runs[4]
    saved = ranks[0]["ckpt"]
    assert saved["expert_local"][0] == saved["n_experts"] // 2
    # layers ep fsdp tp: Shard(1) on ep (dim 1, the experts of [L, E, d, f])
    assert "Shard(dim=1)" in saved["placements"]["layers/w_gate"].split(
        ",")[2]
    trainer = _moe_trainer(None)
    mgr = CheckpointManager(CheckpointConfig(str(directory)))
    # restored into a state of other weights
    state = mgr.restore(trainer.init_state(tmoe.init_params(
        _tcfg("moe", "float32", {}), torch.Generator().manual_seed(99),
        device="cpu")))
    got = _whole(state)
    assert set(got) == set(saved["state"])
    for k, v in saved["state"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    state, loss = trainer.step(state, tdata.to_device(
        _batches(False)[1], torch.device("cpu")))
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("name", sorted(MAIN_RUNS))
def test_main_trains_under_cp_and_ep(runs, name):
    """``python -m kubedl_tpu_torch.train``'s ``main`` takes ``cp`` (ring,
    and Ulysses by ``model_overrides.cp_impl``) and ``ep`` meshes: every
    rank's losses are the one-process job's."""
    ranks, main_single = runs[0], runs[3]
    for rank in ranks:
        np.testing.assert_allclose(rank["main"][name], main_single[name],
                                   rtol=1e-5)


# -- refusals (no group needed: each raises before any collective) ---------

def _stub_mesh(**sizes):
    shape = {a: sizes.get(a, 1) for a in ("dp", "fsdp", "ep", "pp", "cp",
                                          "tp")}
    return types.SimpleNamespace(shape=shape, sharded=True, device_mesh=None,
                                 size=lambda a: shape.get(a, 1),
                                 index=lambda a: 0)


def test_refusals_name_the_reason(tmp_path):
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.models import moe as tmoe
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.parallel.ulysses import ulysses_attention
    from kubedl_tpu_torch.serving import batching, engine
    from kubedl_tpu_torch.train import __main__ as tmain
    # pp trains since slice 14 (test_torch_pp_train.py): one process holds
    # no pp=2 mesh
    with pytest.raises(ValueError, match="devices, have 1"):
        tmesh.build_mesh(tmesh.MeshConfig(pp=2), device="cpu")
    # Ulysses: the rank's query heads must split over cp
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match=r"tp-local query head count \(2\) "
                                         r"divisible by cp \(4\)"):
        ulysses_attention(_stub_mesh(cp=4), q, q, q)
    # where tp does not divide the query heads the ranks hold two counts:
    # every rank checks both before any collective (3 heads at tp=2: 2
    # and 1, and 1 does not split over cp=2)
    stub = _stub_mesh(cp=2, tp=2)
    stub.device_mesh = object()
    with pytest.raises(ValueError, match=r"tp-local query head count \(1\) "
                                         r"divisible by cp \(2\)"):
        llama._check_ulysses_heads(
            dataclasses.replace(llama.tiny(), n_heads=3, n_kv_heads=1,
                                head_dim=32), stub)
    # the ring refuses the Gemma-2 attention knobs without segment ids,
    # naming Ulysses, in JAX's words (with segment ids it runs them: the
    # gemma2-cp2-ring-packed case)
    cfg = dataclasses.replace(llama.tiny(), query_scale=64.0,
                              attn_logit_softcap=50.0)
    with pytest.raises(ValueError, match="set cp_impl='ulysses'"):
        llama._cp_attention(cfg, q, q, q, None, _stub_mesh(cp=2), None)
    # the engines serve over cp and ep meshes since slice 17
    # (test_torch_serving_ep_cp.py); a mesh of more than one rank with no
    # process group behind it is still refused
    for axis in ("cp", "ep"):
        mesh = tmesh.Mesh(device=torch.device("cpu"),
                          shape={a: 2 if a == axis else 1
                                 for a in tmesh.AXES})
        for make in (lambda m: batching.ContinuousBatchingEngine(
                         tmoe.tiny(), {}, mesh=m, device="cpu"),
                     lambda m: engine.InferenceEngine(
                         llama.tiny(), {}, mesh=m, device="cpu")):
            with pytest.raises(ValueError, match="has no process group"):
                make(mesh)
    # evaluate and dpo run over cp since slice 17
    # (test_torch_cp_eval_dpo.py): one process holds no cp=2 mesh, and
    # the JAX entrypoint's refusal of cp inside pipeline stages stands
    for mode in ("evaluate", "dpo"):
        path = tmp_path / f"{mode}.json"
        path.write_text(json.dumps({"mode": mode, "mesh": {"cp": 2}}))
        with pytest.raises(ValueError, match="devices, have 1"):
            tmain.main(["--config", str(path)], device="cpu")
    with pytest.raises(ValueError, match="set cp=1 and tp=1"):
        tmain.pp_num_micro({}, llama.tiny(), _stub_mesh(pp=2, cp=2), 8)
