"""Sharded training of the port across processes, held against the port
on one process and against the JAX ``Trainer`` on the same
``MeshConfig`` (``jax.devices()[:4]`` of the fake CPU mesh).

One 4-rank gloo group is spawned once for the file
(``parallel.launch.spawn``, each rank on one CPU thread); every case runs
in it and returns numpy. The weights are JAX-made float32 and cross over
as numpy (``models.io.params_from_numpy``); the batches are the shared
synthetic stream. Meshes ``fsdp=4``, ``dp=2,fsdp=2`` and ``fsdp=2,tp=2``
train Llama tiny and Gemma tiny (one KV head, which ``tp=2`` cannot
split); MoE tiny trains under ``fsdp=4`` and ``fsdp=2,tp=2``, LoRA under
``fsdp=2,tp=2`` and one bf16 run under ``fsdp=2,tp=2``. A Qwen2-shaped
Llama tiny with 3 query heads over 1 KV head and q/k/v biases
(``qwen3h``) trains under ``fsdp=2,tp=2``, plain and with LoRA: ``tp``
does not divide its heads, so JAX's equal column chunks split one and
each rank computes whole heads (2 and 1).

Tolerances: float32 sums in another order (the shards, the ``tp`` partial
sums, the all-reduces) move the losses and gradients by ~1e-7 of their
scale, so both are held within 1e-5 relative (the gradients at the
largest value's scale), and so are Adam's moments after 2 steps (both
at the initial params). bf16 is held to 4 bf16 ulps at the largest
value's scale.

The worker functions import nothing of JAX (the ranks import this
module); the JAX side runs in the test process only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kubedl_tpu_torch.parallel import launch

WORLD = 4
STEPS = 3
BATCH, SEQ, VOCAB = 8, 32, 256
OPT = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=10,
           weight_decay=0.1, grad_clip=1.0)
MESHES = {"fsdp4": {"fsdp": 4}, "dp2_fsdp2": {"dp": 2, "fsdp": 2},
          "fsdp2_tp2": {"fsdp": 2, "tp": 2}}
#: name -> (family, dtype, mesh, lora)
CASES = {
    **{f"{kind}-{m}": (kind, "float32", MESHES[m], False)
       for kind in ("llama", "gemma") for m in MESHES},
    "llama-bf16-fsdp2_tp2": ("llama", "bfloat16", MESHES["fsdp2_tp2"],
                             False),
    "moe-fsdp4": ("moe", "float32", MESHES["fsdp4"], False),
    "moe-fsdp2_tp2": ("moe", "float32", MESHES["fsdp2_tp2"], False),
    "llama-lora-fsdp2_tp2": ("llama", "float32", MESHES["fsdp2_tp2"], True),
    "qwen3h-fsdp2_tp2": ("qwen3h", "float32", MESHES["fsdp2_tp2"], False),
    "qwen3h-lora-fsdp2_tp2": ("qwen3h", "float32", MESHES["fsdp2_tp2"],
                              True),
}
#: kind -> (family, overrides of its tiny config)
KINDS = {"llama": ("llama", {}), "gemma": ("gemma", {}), "moe": ("moe", {}),
         "qwen3h": ("llama", dict(n_heads=3, n_kv_heads=1, head_dim=32,
                                  qkv_bias=True))}
F32 = [n for n, c in CASES.items() if c[1] == "float32" and not c[3]]
LORA_ALPHA = 8.0
BF16_ULPS = 4


def _tcfg(kind: str, dtype: str):
    from kubedl_tpu_torch.models import gemma, llama, moe
    family, over = KINDS[kind]
    make = {"llama": llama.tiny, "gemma": gemma.tiny, "moe": moe.tiny}[family]
    return dataclasses.replace(make(vocab=VOCAB, seq=64), dtype=dtype,
                               **over)


def _batches():
    from kubedl_tpu_torch.train.data import synthetic_lm_batches
    stream = synthetic_lm_batches(BATCH, SEQ, VOCAB, seed=5)
    return [next(stream) for _ in range(STEPS)]


def _np(t) -> np.ndarray:
    """A float32 numpy copy (the optimizer updates tensors in place)."""
    return t.detach().float().numpy().copy()


def run_case(kind, dtype, mesh_kw, use_lora, params_np, sharded):
    """One case on this process: under the open group's mesh when
    ``sharded``, else on one device. Returns the first step's loss and
    gradients, the losses of ``STEPS`` steps and the final params (and,
    with LoRA, the base after training), all whole."""
    from torch.distributed.tensor import DTensor

    from kubedl_tpu_torch.models import io
    from kubedl_tpu_torch.ops import lora
    from kubedl_tpu_torch.parallel import collectives, sharding
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.train import data as tdata
    from kubedl_tpu_torch.train import trainer as ttrainer

    cfg = _tcfg(kind, dtype)
    fam = io.family_of(cfg)
    mesh = (tmesh.build_mesh(tmesh.MeshConfig(**mesh_kw), device="cpu")
            if sharded else None)
    params = io.params_from_numpy(cfg, params_np, device="cpu")

    def loss_fn(p, b):
        return fam.loss_fn(cfg, p, b["tokens"], b["targets"], mesh=mesh)

    place = ({"param_specs": fam.param_specs(cfg), "mesh": mesh}
             if sharded else {"device": "cpu"})
    base_placed = None
    if use_lora:
        adapters = lora.init_adapters(
            params, rank=4, generator=torch.Generator().manual_seed(1))
        base_placed = (sharding.shard_tree(params, mesh,
                                           place["param_specs"])
                       if sharded else params)
        base = sharding.views(base_placed, mesh) if sharded else params
        if sharded:
            place["param_specs"] = lora.adapter_specs(place["param_specs"],
                                                      adapters)
        model_loss = loss_fn

        def loss_fn(ad, b):  # noqa: F811 — the adapters are trained
            return model_loss(lora.merge_params(base, ad,
                                                alpha=LORA_ALPHA), b)
        params = adapters
    trainer = ttrainer.Trainer(loss_fn, ttrainer.TrainConfig(**OPT),
                               **place)
    state = trainer.init_state(params)
    if sharded:
        def put(b):
            return tdata.shard_batch(b, mesh)
    else:
        def put(b):
            return tdata.to_device(b, torch.device("cpu"))
    batches = _batches()

    # the first step's loss and gradient of every leaf, gathered whole
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
    for i, b in enumerate(batches):
        state, loss = trainer.step(state, put(b))
        losses.append(float(loss))
        if i == 1:      # see test_moments_after_two_steps_match
            opt = state.opt_state
            out["moments"] = {k: (_np(sharding.full_tensor(opt.mu[k])),
                                  _np(sharding.full_tensor(opt.nu[k])))
                              for k in opt.mu}
    out["losses"] = losses
    out["params"] = {k: _np(sharding.full_tensor(v))
                     for k, v in ttrainer.tree_leaves(state.params)}
    if use_lora:
        out["base"] = {k: _np(sharding.full_tensor(v))
                       for k, v in ttrainer.tree_leaves(base_placed)}
    return out


def rank_main(params_by_kind):
    """One rank: open the group from the env, run every case, and report
    how ``shard_batch`` placed one batch."""
    import torch.distributed as dist

    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.runtime import bootstrap
    from kubedl_tpu_torch.train import data as tdata

    bootstrap.initialize_distributed(device="cpu")
    out = {"cases": {name: run_case(*CASES[name][:4],
                                    params_by_kind[CASES[name][0]], True)
                     for name in CASES}}
    mesh = tmesh.build_mesh(tmesh.MeshConfig(dp=2, fsdp=2), device="cpu")
    placed = tdata.shard_batch({**_batches()[0],
                                "mask": np.ones((BATCH, SEQ), bool)}, mesh)
    out["batch"] = {k: (list(map(str, v.placements)), tuple(v.shape),
                        _np(v.to_local())) for k, v in placed.items()}
    out["data"] = (mesh.data_index, mesh.data_size)
    streamed = next(tdata.sharded_synthetic_stream(BATCH, SEQ, VOCAB, mesh,
                                                   seed=5))
    out["streamed"] = {k: _np(v.to_local()) for k, v in streamed.items()}
    if dist.get_rank() != 0:   # rank 0 carries the arrays back
        for res in out["cases"].values():
            for key in ("grads", "params", "moments", "base"):
                res.pop(key, None)
    dist.destroy_process_group()
    return out


# -- the test process: references and checks -------------------------------

def _jax_params(kind):
    import jax

    from kubedl_tpu.models import gemma as jgemma
    from kubedl_tpu.models import llama as jllama
    from kubedl_tpu.models import moe as jmoe
    family, over = KINDS[kind]
    make = {"llama": (jllama, jllama.tiny), "gemma": (jllama, jgemma.tiny),
            "moe": (jmoe, jmoe.tiny)}[family]
    cfg = dataclasses.replace(make[1](vocab=VOCAB, seq=64),
                              dtype=np.float32, **over)
    params = jax.jit(lambda k: make[0].init_params(cfg, k))(
        jax.random.PRNGKey(7))
    return make[0], cfg, jax.tree.map(lambda x: np.asarray(x, np.float32),
                                      params)


def _jax_case(kind, mesh_kw, params_np):
    """The JAX package on the same MeshConfig over 4 devices: the first
    step's loss and gradients, and the ``Trainer``'s losses."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.parallel import mesh as jmesh
    from kubedl_tpu.parallel import sharding as jsharding
    from kubedl_tpu.train import data as jdata
    from kubedl_tpu.train import trainer as jtrainer
    mod, cfg, _ = _jax_params(kind)
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**mesh_kw),
                            devices=jax.devices()[:WORLD])
    specs = mod.param_specs(cfg)

    def placed():
        return jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s),
                            params_np, jsharding.tree_shardings(mesh, specs))

    def loss_fn(p, b):
        return mod.loss_fn(cfg, p, b["tokens"], b["targets"], mesh=mesh)

    batches = [jdata.shard_batch(b, mesh) for b in _batches()]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(placed(), batches[0])
    trainer = jtrainer.Trainer(loss_fn, specs, mesh,
                               jtrainer.TrainConfig(**OPT))
    state = trainer.init_state(placed())
    # the counter placed as the step returns it, so the second step does
    # not compile the step again for a new input sharding
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
def runs():
    """(rank results, one-process results, JAX results). The JAX cases
    compile on a thread pool while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor
    params = {kind: _jax_params(kind)[2] for kind in KINDS}
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = {name: pool.submit(_jax_case, CASES[name][0],
                                     CASES[name][2],
                                     params[CASES[name][0]])
                   for name in F32}
        ranks = launch.spawn(rank_main, WORLD, params, timeout=240)
        single = {name: run_case(*CASES[name][:4], params[CASES[name][0]],
                                 False) for name in CASES}
        jax_ref = {name: f.result() for name, f in futures.items()}
    return ranks, single, jax_ref


def _close_grads(got, want, rel):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=0, err_msg=k,
            atol=rel * max(float(np.abs(want[k]).max()), 1e-30))


@pytest.mark.parametrize("name", F32)
def test_first_step_matches_one_process(runs, name):
    ranks, single, _ = runs
    got, want = ranks[0]["cases"][name], single[name]
    np.testing.assert_allclose(got["grad_loss"], want["grad_loss"],
                               rtol=1e-5)
    _close_grads(got["grads"], want["grads"], 1e-5)


@pytest.mark.parametrize("name", F32)
def test_first_step_matches_the_jax_sharded_trainer(runs, name):
    ranks, _, jax_ref = runs
    got, want = ranks[0]["cases"][name], jax_ref[name]
    np.testing.assert_allclose(got["grad_loss"], want["grad_loss"],
                               rtol=1e-5)
    _close_grads(got["grads"], want["grads"], 1e-5)


@pytest.mark.parametrize("name", F32)
def test_losses_over_three_steps_match(runs, name):
    ranks, single, jax_ref = runs
    for rank in ranks:        # every rank reports the same global loss
        assert rank["cases"][name]["losses"] == \
            ranks[0]["cases"][name]["losses"]
    got = ranks[0]["cases"][name]["losses"]
    np.testing.assert_allclose(got, single[name]["losses"], rtol=1e-5)
    np.testing.assert_allclose(got, jax_ref[name]["losses"], rtol=1e-5)


@pytest.mark.parametrize("name", F32)
def test_moments_after_two_steps_match(runs, name):
    """Adam's moments after the second step: the first step's learning
    rate is 0 (one warmup step), so both steps' gradients are taken at the
    initial params, and the moments, sums of them and their squares, keep
    the gradients' 1e-5. From the third step on the params themselves
    differ: where |g| is near Adam's eps, g / (|g| + eps) turns a 1e-7 gap
    into any size, so neither the params nor later moments are held
    elementwise; the losses above carry what they do."""
    ranks, single, _ = runs
    got, want = ranks[0]["cases"][name], single[name]
    for which in (0, 1):
        _close_grads({k: v[which] for k, v in got["moments"].items()},
                     {k: v[which] for k, v in want["moments"].items()},
                     1e-5)


def _bf16_atol(ref) -> float:
    top = float(np.abs(ref).max())
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


def test_bf16_run_within_four_ulps_of_one_process(runs):
    name = "llama-bf16-fsdp2_tp2"
    ranks, single, _ = runs
    got, want = ranks[0]["cases"][name], single[name]
    np.testing.assert_allclose(got["grad_loss"], want["grad_loss"],
                               atol=_bf16_atol(want["grad_loss"]))
    np.testing.assert_allclose(got["losses"], want["losses"],
                               atol=_bf16_atol(want["losses"]))
    for k in want["grads"]:
        np.testing.assert_allclose(got["grads"][k], want["grads"][k],
                                   atol=_bf16_atol(want["grads"][k]),
                                   rtol=0, err_msg=k)


def test_lora_keeps_the_base_bit_for_bit(runs):
    name = "llama-lora-fsdp2_tp2"
    ranks, single, _ = runs
    got = ranks[0]["cases"][name]
    for k, v in single[name]["base"].items():
        np.testing.assert_array_equal(got["base"][k], v, err_msg=k)
    assert set(got["params"]) == {f"{t}/{ab}" for t in ("wk", "wo", "wq",
                                                        "wv")
                                  for ab in ("a", "b")}


def test_lora_trains_as_on_one_process(runs):
    name = "llama-lora-fsdp2_tp2"
    ranks, single, _ = runs
    got, want = ranks[0]["cases"][name], single[name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _close_grads(got["grads"], want["grads"], 1e-5)
    for which in (0, 1):
        _close_grads({k: v[which] for k, v in got["moments"].items()},
                     {k: v[which] for k, v in want["moments"].items()},
                     1e-5)


def test_lora_with_uneven_heads_trains_as_on_one_process(runs):
    """LoRA on a model whose query heads ``tp`` does not divide: each
    rank cuts the gathered base and the adapter factor on the head side
    to its whole heads; the base stays bit for bit."""
    name = "qwen3h-lora-fsdp2_tp2"
    ranks, single, _ = runs
    got, want = ranks[0]["cases"][name], single[name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _close_grads(got["grads"], want["grads"], 1e-5)
    for k, v in want["base"].items():
        np.testing.assert_array_equal(got["base"][k], v, err_msg=k)


def test_shard_batch_keeps_each_rank_its_rows(runs):
    ranks, _, _ = runs
    full = _batches()[0]
    for r, rank in enumerate(ranks):
        index, size = rank["data"]
        # ranks lie dp-major over the (dp=2, fsdp=2) data axes
        assert (index, size) == (r, 4)
        rows = slice(r * BATCH // 4, (r + 1) * BATCH // 4)
        for k in ("tokens", "targets"):
            placements, shape, local = rank["batch"][k]
            assert shape == (BATCH, SEQ)
            # ((dp, fsdp), cp): cp (size 1) shards the sequence
            assert placements == ["S(0)", "S(0)", "R", "R", "S(1)", "R"]
            np.testing.assert_array_equal(local, full[k][rows])
        assert rank["batch"]["mask"][0] == ["S(0)", "S(0)"] + ["R"] * 4
        for k in ("tokens", "targets"):   # the synthetic stream, sharded
            np.testing.assert_array_equal(rank["streamed"][k],
                                          full[k][rows])
