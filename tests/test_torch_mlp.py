"""The MNIST-shaped MLP in the port, held against
``kubedl_tpu/models/mlp.py`` on the CPU in float32 on JAX-made weights:
forward, loss, accuracy and every gradient, optimizer steps against the
JAX ``Trainer``, and one batch memorized."""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import mlp as jmlp
from kubedl_tpu.parallel import mesh as jmesh
from kubedl_tpu.train import trainer as jtrainer
from kubedl_tpu_torch.models import mlp as tmlp
from kubedl_tpu_torch.train import trainer as ttrainer

RTOL, ATOL = 1e-4, 1e-5


def _weights(seed=0):
    cfg = jmlp.MLPConfig()
    return cfg, jax.tree.map(lambda x: np.asarray(x, np.float32),
                             jmlp.init_params(cfg, jax.random.PRNGKey(seed)))


def _batch(seed=0, b=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 784)).astype(np.float32),
            rng.integers(0, 10, (b,)).astype(np.int32))


def test_forward_loss_accuracy_and_every_gradient_match_jax():
    jcfg, weights = _weights()
    tcfg = tmlp.MLPConfig()
    x, y = _batch()
    jparams = jax.tree.map(jnp.asarray, weights)
    loss, grads = jax.value_and_grad(
        lambda p: jmlp.loss_fn(jcfg, p, x, y))(jparams)
    params = ttrainer.tree_map(lambda t: t.requires_grad_(True),
                               tmlp.params_from_numpy(tcfg, weights,
                                                      device="cpu"))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    np.testing.assert_allclose(
        tmlp.forward(tcfg, params, xt).detach().numpy(),
        np.asarray(jmlp.forward(jcfg, jparams, x)), rtol=RTOL, atol=ATOL)
    got = tmlp.loss_fn(tcfg, params, xt, yt)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=RTOL)
    assert float(tmlp.accuracy(tcfg, params, xt, yt)) == float(
        jmlp.accuracy(jcfg, jparams, x, y))
    leaves = ttrainer.tree_leaves(params)
    tgrads = torch.autograd.grad(got, [p for _, p in leaves])
    for (k, _), g in zip(leaves, tgrads):
        i, name = k.split("/")[1:]
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(grads["layers"][int(i)][name]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert sum(t.numel() for _, t in leaves) == sum(
        v.size for v in jax.tree.leaves(weights)) == 535_818


def test_trainer_steps_match_jax():
    jcfg, weights = _weights(1)
    tcfg = tmlp.MLPConfig()
    opt = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=10)
    mesh = jmesh.build_mesh(devices=jax.devices()[:1])
    jt = jtrainer.Trainer(lambda p, b: jmlp.loss_fn(jcfg, p, b["x"], b["y"]),
                          jmlp.param_specs(jcfg), mesh,
                          jtrainer.TrainConfig(**opt))
    jstate = jt.init_state(jax.tree.map(jnp.asarray, weights))
    tt = ttrainer.Trainer(lambda p, b: tmlp.loss_fn(tcfg, p, b["x"], b["y"]),
                          ttrainer.TrainConfig(**opt), device="cpu")
    tstate = tt.init_state(tmlp.params_from_numpy(tcfg, weights,
                                                  device="cpu"))
    for seed in (2, 3, 4):
        x, y = _batch(seed)
        jstate, jloss = jt.step(jstate, {"x": jnp.asarray(x),
                                         "y": jnp.asarray(y)})
        tstate, tloss = tt.step(tstate, {"x": torch.from_numpy(x),
                                         "y": torch.from_numpy(y).long()})
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    for i, lp in enumerate(tstate.params["layers"]):
        for k, t in lp.items():
            np.testing.assert_allclose(
                t.detach().numpy(), np.asarray(jstate.params["layers"][i][k]),
                rtol=0, atol=1e-4, err_msg=f"layers/{i}/{k}")


def test_memorizes_one_batch():
    cfg = dataclasses.replace(tmlp.MLPConfig(), hidden=(64,))
    params = tmlp.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    x, y = _batch(9, b=32)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    tt = ttrainer.Trainer(lambda p, b: tmlp.loss_fn(cfg, p, b["x"], b["y"]),
                          ttrainer.TrainConfig(learning_rate=1e-2,
                                               warmup_steps=1,
                                               decay_steps=100),
                          device="cpu")
    state = tt.init_state(params)
    for _ in range(30):
        state, loss = tt.step(state, batch)
    assert float(tmlp.accuracy(cfg, state.params, batch["x"],
                               batch["y"])) == 1.0
    assert float(loss) < 0.1
