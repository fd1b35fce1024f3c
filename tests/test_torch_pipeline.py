"""Pipeline parallelism of the port in one process, held against the JAX
package's schedules and against flat autograd.

``parallel.pipeline.local_stages(pp)`` runs every stage in one process
through the slots a rank runs on its group: the JAX functions run on
``jax.devices()[:pp]`` of the fake CPU mesh, on the same float32 numpy
inputs. Held: ``Schedule1F1B``'s tables exactly; ``pipeline_apply``
(GPipe) and ``pipeline_grads_1f1b`` (loss, stage and head gradients)
within 1e-5 of JAX's and of the flat stack differentiated by autograd;
``pp=1`` as the flat model; the bad shapes JAX refuses; the stash peaks
the schedules bound; and the Llama and Gemma pipelined losses of
``train.__main__.build_pp_pretrain`` against the flat ``loss_fn``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kubedl_tpu.parallel import pipeline as jpipe
from kubedl_tpu_torch.parallel import pipeline as tpipe

D, L = 16, 8
TOL = 1e-5


def _jmesh(pp: int):
    return Mesh(np.asarray(jax.devices()[:pp]), ("pp",))


def _layers(seed=0, n=L, d=D):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n, d, d)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((n, d)) * 0.1).astype(np.float32)}


def _x(rows=8, seed=1, d=D):
    return np.random.default_rng(seed).standard_normal(
        (rows, d)).astype(np.float32)


def _t_layer(x, lp):
    return torch.tanh(x @ lp["w"] + lp["b"])


def _j_layer(x, lp):
    return jnp.tanh(x @ lp["w"] + lp["b"])


def _t_tree(tree, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad)
            for k, v in tree.items()}


def _t_flat(layers, x):
    for i in range(layers["w"].shape[0]):
        x = _t_layer(x, {k: v[i] for k, v in layers.items()})
    return x


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("pp,num_micro", [(2, 2), (2, 5), (4, 4), (4, 8),
                                          (3, 7)])
def test_schedule_tables_are_the_jax_tables(pp, num_micro):
    got, want = tpipe.Schedule1F1B(pp, num_micro), \
        jpipe.Schedule1F1B(pp, num_micro)
    for name in ("fwd_mb", "bwd_mb", "arr_f", "arr_b"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert (got.slots, got.depth) == (want.slots, want.depth)
    assert [got.max_inflight(s) for s in range(pp)] == \
        [want.max_inflight(s) for s in range(pp)]


@pytest.mark.parametrize("pp,num_micro", [(4, 4), (2, 2), (4, 2)])
def test_gpipe_matches_jax_and_flat_autograd(pp, num_micro):
    layers, x = _layers(), _x()

    def j_loss(stages, xx):
        y = jpipe.pipeline_apply(_jmesh(pp), jpipe.stage_scan(_j_layer),
                                 stages, xx, num_micro)
        return (y ** 2).sum(), y
    (_, jy), (jg, jdx) = jax.value_and_grad(j_loss, argnums=(0, 1),
                                            has_aux=True)(
        jpipe.stack_stages(jax.tree.map(jnp.asarray, layers), pp),
        jnp.asarray(x))

    stages = _t_tree(jax.tree.map(np.asarray, jpipe.stack_stages(layers,
                                                                  pp)),
                     grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    stats = {}
    y = tpipe.pipeline_apply(tpipe.local_stages(pp),
                             tpipe.stage_scan(_t_layer), stages, tx,
                             num_micro, stats=stats)
    g = torch.autograd.grad((y ** 2).sum(), [stages["w"], stages["b"], tx])
    flat = _t_tree(layers, grad=True)
    fx = torch.from_numpy(x).requires_grad_(True)
    fy = _t_flat(flat, fx)
    fg = torch.autograd.grad((fy ** 2).sum(), [flat["w"], flat["b"], fx])

    _close(y.detach(), jy)
    _close(y.detach(), fy.detach())
    for got, want, flat_g in zip(g, (jg["w"], jg["b"], jdx), fg):
        _close(got.reshape(flat_g.shape), np.asarray(want).reshape(
            flat_g.shape))
        _close(got.reshape(flat_g.shape), flat_g)
    # GPipe stashes every microbatch on every stage until its backward
    assert stats["stash_peak"] == [num_micro] * pp


def _head(seed=3):
    return {"w": (np.random.default_rng(seed).standard_normal((D, D))
                  * 0.3).astype(np.float32)}


def _t_loss_mb(hp, y, aux):
    out = y @ hp["w"]
    if "tgt" in aux:
        out = out - aux["tgt"]
    return (out ** 2).mean()


def _j_loss_mb(hp, y, aux):
    out = y @ hp["w"]
    if "tgt" in aux:
        out = out - aux["tgt"]
    return jnp.mean(out ** 2)


@pytest.mark.parametrize("pp,num_micro,rows", [(4, 4, 8), (4, 8, 16),
                                               (2, 5, 10), (3, 7, 7),
                                               (1, 2, 8)])
def test_1f1b_matches_jax_and_flat_autograd(pp, num_micro, rows):
    n = 12 if pp == 3 else L
    layers, x, head = _layers(n=n), _x(rows), _head()
    tgt = _x(rows, seed=2)
    jl, jg, jh = jpipe.pipeline_grads_1f1b(
        _jmesh(pp), jpipe.stage_scan(_j_layer),
        jpipe.stack_stages(jax.tree.map(jnp.asarray, layers), pp),
        jax.tree.map(jnp.asarray, head), jnp.asarray(x),
        {"tgt": jnp.asarray(tgt)}, num_micro, _j_loss_mb)
    stats = {}
    tl, tg, th = tpipe.pipeline_grads_1f1b(
        tpipe.local_stages(pp), tpipe.stage_scan(_t_layer),
        tpipe.stack_stages(_t_tree(layers), pp), _t_tree(head),
        torch.from_numpy(x), {"tgt": torch.from_numpy(tgt)}, num_micro,
        _t_loss_mb, stats=stats)
    # the flat stack: the mean of the microbatches' mean losses
    flat, fh = _t_tree(layers, grad=True), _t_tree(head, grad=True)
    ys = _t_flat(flat, torch.from_numpy(x))
    fl = torch.stack([_t_loss_mb(fh, y, {"tgt": t}) for y, t in zip(
        ys.chunk(num_micro), torch.from_numpy(tgt).chunk(num_micro))]).mean()
    fg = torch.autograd.grad(fl, [flat["w"], flat["b"], fh["w"]])

    _close(tl, jl)
    _close(tl, fl.detach())
    for k, want_flat in zip(("w", "b"), fg[:2]):
        _close(tg[k].reshape(want_flat.shape),
               np.asarray(jg[k]).reshape(want_flat.shape))
        _close(tg[k].reshape(want_flat.shape), want_flat)
    _close(th["w"], jh["w"])
    _close(th["w"], fg[2])
    sched = tpipe.Schedule1F1B(pp, num_micro)
    # the measured stash peak is the schedule's in-flight bound
    assert stats["stash_peak"] == [sched.max_inflight(s)
                                   for s in range(pp)]
    assert stats["stash_peak"][0] == min(pp, num_micro)


def test_one_stage_is_the_flat_model():
    layers, x = _layers(), _x()
    stages = tpipe.stack_stages(_t_tree(layers), 1)
    got = tpipe.pipeline_apply(tpipe.local_stages(1),
                               tpipe.stage_scan(_t_layer), stages,
                               torch.from_numpy(x), num_micro=2)
    np.testing.assert_array_equal(
        got.numpy(), _t_flat(_t_tree(layers), torch.from_numpy(x)).numpy())
    # a mesh without a pp group holds one stage
    assert tpipe.stages_of(None).pp == 1


def test_bad_shapes_raise():
    layers = _t_tree(_layers(n=6, d=8))
    with pytest.raises(ValueError, match="6 layers not divisible by pp=4"):
        tpipe.stack_stages(layers, 4)
    with pytest.raises(ValueError, match="batch 5 not divisible by "
                                         "num_micro=2"):
        tpipe.pipeline_apply(tpipe.local_stages(2),
                             tpipe.stage_scan(_t_layer),
                             tpipe.stack_stages(layers, 2),
                             torch.zeros(5, 8), num_micro=2)
    with pytest.raises(ValueError, match="batch 5 not divisible"):
        tpipe.pipeline_grads_1f1b(
            tpipe.local_stages(2), tpipe.stage_scan(_t_layer),
            tpipe.stack_stages(layers, 2), {"w": torch.eye(8)},
            torch.zeros(5, 8), {}, 2, _t_loss_mb)


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_pipelined_lm_loss_is_the_flat_loss(family):
    """``build_pp_pretrain``'s loss on ``local_stages(4)``: the loss and
    every gradient (the tied Gemma embedding's two uses included) against
    the flat ``loss_fn`` on the same weights, with an SFT mask."""
    from kubedl_tpu_torch.models import gemma, llama
    from kubedl_tpu_torch.train import __main__ as tmain
    from kubedl_tpu_torch.train.trainer import tree_leaves
    make = {"llama": llama.tiny, "gemma": gemma.tiny}[family]
    cfg = dataclasses.replace(make(vocab=128, seq=64), dtype="float32",
                              n_layers=4)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    loss_fn, to_pp, from_pp, specs_of = tmain.build_pp_pretrain(
        cfg, None, 4, stages=tpipe.local_stages(4))
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, 128, (8, 17)))
    mask = torch.from_numpy((rng.random((8, 16)) > 0.3).astype(np.float32))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}

    def leaves(tree):
        out = [(k, t.detach().clone().requires_grad_(True))
               for k, t in tree_leaves(tree)]
        return out

    staged = leaves(to_pp(params))
    flat = leaves(params)

    def rebuild(pairs):
        tree = {}
        for k, t in pairs:
            node = tree
            *up, last = k.split("/")
            for p in up:
                node = node.setdefault(p, {})
            node[last] = t
        return tree

    got = loss_fn(rebuild(staged), batch)
    want = llama.loss_fn(cfg, rebuild(flat), batch["tokens"],
                         batch["targets"], mask=mask)
    g_pp = torch.autograd.grad(got, [t for _, t in staged])
    g_flat = torch.autograd.grad(want, [t for _, t in flat])
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    by_name = {k.replace("stages/", "layers/"): g
               for (k, _), g in zip(staged, g_pp)}
    for (k, _), g in zip(flat, g_flat):
        _close(by_name[k].reshape(g.shape), g)
    # the staged tree restacks to the flat layout and its specs shard
    # every stage leaf on pp
    back = from_pp(to_pp(params))
    assert all(torch.equal(back["layers"][k], params["layers"][k])
               for k in params["layers"])
    assert set(specs_of(to_pp(params))["stages"].values()) == {("pp",)}
