"""LoRA in the port, held against the JAX package on the CPU.

The two RNGs cannot agree, so JAX's ``init_adapters`` output crosses as
numpy: zero-init identity, the adapter gradients, adapter-only training
steps against the JAX ``Trainer`` (the base left bit for bit untouched,
the optimizer state adapter-sized), ``merge_to_dense``, a bad target, and
the training entry point's ``lora`` option, whose export folds the
adapters into dense weights that the JAX package loads."""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import gemma as jgemma
from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.ops import lora as jlora
from kubedl_tpu.parallel import mesh as jmesh
from kubedl_tpu.train import data as jdata
from kubedl_tpu.train import trainer as jtrainer
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.ops import lora as tlora
from kubedl_tpu_torch.ops import quant as tquant
from kubedl_tpu_torch.train import __main__ as tmain
from kubedl_tpu_torch.train import data as tdata
from kubedl_tpu_torch.train import trainer as ttrainer

OPT = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=20,
           weight_decay=0.1, grad_clip=1.0)
TARGETS = {"attention": jlora.DEFAULT_TARGETS,
           "attention_and_mlp": ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                 "w_down")}
FAMILIES = {"llama_tiny": jllama, "gemma_tiny": jgemma}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def base(request):
    """(JAX config, JAX params as numpy, port config, port params)."""
    jcfg = dataclasses.replace(FAMILIES[request.param].tiny(vocab=64),
                               dtype=jnp.float32)
    params = jax.tree.map(np.array,
                          jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = tllama.LlamaConfig(**{**dataclasses.asdict(jcfg),
                                 "dtype": "float32"})
    return jcfg, params, tcfg, tio.params_from_numpy(tcfg, params,
                                                     device="cpu")


def _adapters(params, targets=jlora.DEFAULT_TARGETS, rank=4, seed=2,
              live=True):
    """JAX's init_adapters output as numpy; ``live`` gives B values so
    the adapters change the model."""
    ad = jlora.init_adapters(jax.tree.map(jnp.asarray, params), rank=rank,
                             targets=targets, key=jax.random.PRNGKey(seed))
    ad = jax.tree.map(np.array, ad)
    if live:
        rng = np.random.default_rng(seed)
        for ab in ad.values():
            ab["b"] = (0.05 * rng.normal(size=ab["b"].shape)).astype(
                np.float32)
    return ad


def _torch_tree(tree, grad=False):
    return {k: _torch_tree(v, grad) if isinstance(v, dict)
            else torch.tensor(v).requires_grad_(grad)
            for k, v in tree.items()}


def _flat(tree):
    return {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


TOKENS = np.random.default_rng(5).integers(0, 64, (2, 33), dtype=np.int32)


def test_zero_init_is_identity(base):
    """Fresh adapters (B = 0), the port's own draw: the adapted model is
    exactly the base, as JAX's is."""
    jcfg, params, tcfg, tparams = base
    ad = tlora.init_adapters(tparams, rank=4,
                             generator=torch.Generator().manual_seed(1))
    assert sorted(ad) == sorted(jlora.DEFAULT_TARGETS)
    assert ad["wq"]["a"].shape == (tcfg.n_layers, tcfg.d_model, 4)
    assert ad["wq"]["a"].dtype == torch.float32 and not ad["wq"]["b"].any()
    toks = torch.from_numpy(TOKENS).long()
    with torch.no_grad():
        plain = tllama.forward(tcfg, tparams, toks)
        merged = tllama.forward(tcfg, tlora.merge_params(tparams, ad), toks)
    assert torch.equal(plain, merged)
    np.testing.assert_allclose(
        merged.numpy(), np.asarray(jllama.forward(
            jcfg, jlora.merge_params(params, _adapters(params, live=False)),
            jnp.asarray(TOKENS))), atol=1e-4)
    again = tlora.init_adapters(tparams, rank=4,
                                generator=torch.Generator().manual_seed(1))
    assert torch.equal(again["wk"]["a"], ad["wk"]["a"])


@pytest.mark.parametrize("targets", sorted(TARGETS))
def test_adapter_gradients_match_jax(base, targets):
    """The loss and the gradient of every adapter factor through the
    grafted base, against ``jax.grad`` of the JAX package's."""
    jcfg, params, tcfg, tparams = base
    ad = _adapters(params, TARGETS[targets])
    tokens, targets_ = TOKENS[:, :-1], TOKENS[:, 1:]

    def jloss(a):
        return jllama.loss_fn(jcfg, jlora.merge_params(params, a, alpha=8.0),
                              jnp.asarray(tokens), jnp.asarray(targets_))

    want_loss, want = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray,
                                                             ad))
    tad = _torch_tree(ad, grad=True)
    leaves = ttrainer.tree_leaves(tad)
    loss = tllama.loss_fn(tcfg, tlora.merge_params(tparams, tad, alpha=8.0),
                          torch.from_numpy(tokens).long(),
                          torch.from_numpy(targets_).long())
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    want = _flat(want)
    for (k, _), g in zip(leaves, grads):
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    assert all(not t.requires_grad for _, t in ttrainer.tree_leaves(tparams))


def test_adapter_only_training_matches_jax(base):
    """Five adapter-only steps on one repeated batch: the JAX losses and
    adapters, the loss falls, the base stays bit for bit, and the
    optimizer's moments are adapter-sized."""
    jcfg, params, tcfg, tparams = base
    ad = _adapters(params, live=False, seed=3)
    batch = next(jdata.synthetic_lm_batches(4, 32, 64, seed=4))
    mesh = jmesh.build_mesh(devices=jax.devices()[:1])
    jbase = jax.tree.map(jnp.asarray, params)
    jtr = jtrainer.Trainer(
        lambda a, b: jllama.loss_fn(jcfg, jlora.merge_params(jbase, a),
                                    b["tokens"], b["targets"]),
        jlora.adapter_specs(jllama.param_specs(jcfg), ad), mesh,
        jtrainer.TrainConfig(**OPT))
    jstate = jtr.init_state(jax.tree.map(jnp.asarray, ad))
    jlosses = []
    for _ in range(5):
        jstate, loss = jtr.step(jstate, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        jlosses.append(float(loss))
    before = {k: t.clone() for k, t in ttrainer.tree_leaves(tparams)}
    ttr = ttrainer.Trainer(
        lambda a, b: tllama.loss_fn(tcfg, tlora.merge_params(tparams, a),
                                    b["tokens"], b["targets"]),
        ttrainer.TrainConfig(**OPT), device="cpu")
    tstate = ttr.init_state(_torch_tree(ad))
    tlosses = []
    for _ in range(5):
        tstate, loss = ttr.step(tstate, tdata.to_device(
            batch, torch.device("cpu")))
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    want = _flat(jstate.params)
    for k, t in ttrainer.tree_leaves(tstate.params):
        np.testing.assert_allclose(t.detach().numpy(), want[k], atol=1e-4,
                                   rtol=0, err_msg=k)
    assert float(tstate.params["wq"]["b"].detach().abs().max()) > 0
    for k, t in ttrainer.tree_leaves(tparams):
        assert torch.equal(t, before[k]), k
    adapter_bytes = tquant.tree_nbytes(tstate.params)
    assert tquant.tree_nbytes(tstate.opt_state.mu) == adapter_bytes
    assert tquant.tree_nbytes(tstate.opt_state.nu) == adapter_bytes
    assert adapter_bytes < 0.2 * tquant.tree_nbytes(tparams)


def test_merge_to_dense_matches_jax_and_the_live_adapters(base):
    jcfg, params, tcfg, tparams = base
    ad = _adapters(params, TARGETS["attention_and_mlp"], seed=6)
    want = jlora.merge_to_dense(params, ad, alpha=8.0)
    got = tlora.merge_to_dense(tparams, _torch_tree(ad), alpha=8.0)
    for name in ad:
        np.testing.assert_allclose(got["layers"][name].numpy(),
                                   np.asarray(want["layers"][name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert got["layers"]["attn_norm"] is tparams["layers"]["attn_norm"]
    toks = torch.from_numpy(TOKENS).long()
    with torch.no_grad():
        live = tllama.forward(tcfg, tlora.merge_params(
            tparams, _torch_tree(ad), alpha=8.0), toks)
        dense = tllama.forward(tcfg, got, toks)
    torch.testing.assert_close(live, dense, rtol=2e-4, atol=2e-4)


def test_bad_target_raises(base):
    _, _, _, tparams = base
    with pytest.raises(ValueError, match="nope"):
        tlora.init_adapters(tparams, targets=("nope",))
    with pytest.raises(ValueError, match="stacked"):
        tlora.init_adapters({"layers": [tparams["layers"]]})


def test_main_lora_trains_adapters_and_exports_folded_weights(tmp_path,
                                                              caplog):
    """``"lora"`` on the training entry point: the log gives the trainable
    count, the loss falls on the repeated batch, the untargeted leaves of
    the export are the seeded base's bit for bit, the targeted ones moved,
    and the JAX package loads the export."""
    toks = tmp_path / "toks.bin"
    np.random.default_rng(8).integers(0, 256, 4 * 33,
                                      dtype=np.int32).tofile(toks)
    export = str(tmp_path / "export")
    cfg = {"model": "llama.tiny",
           "model_overrides": {"dtype": "float32", "vocab_size": 256},
           "batch": 4, "seq": 32, "steps": 4, "log_every": 0, "seed": 3,
           "data": {"kind": "tokens", "path": str(toks)},
           "optimizer": {"learning_rate": 1e-2, "warmup_steps": 1},
           "lora": {"rank": 4, "alpha": 8.0}, "export_path": export}
    path = tmp_path / "train.json"
    path.write_text(json.dumps(cfg))
    losses = []
    with caplog.at_level(logging.INFO, logger="kubedl.train"):
        assert tmain.main(["--config", str(path)], device="cpu",
                          on_step=lambda s, l: losses.append(l)) == 0
    tcfg, _ = tmain.resolve_model(cfg, device="cpu")
    n_trainable = sum(tcfg.n_layers * (tcfg.d_model + n) * 4 for n in (
        tcfg.n_heads * tcfg.hd, tcfg.n_kv_heads * tcfg.hd,
        tcfg.n_kv_heads * tcfg.hd, tcfg.d_model))
    assert (f"lora: rank=4 alpha=8.0 targets=wk,wo,wq,wv "
            f"({n_trainable / 1e6:.2f}M trainable)") in caplog.text
    assert losses[-1] < losses[0]
    seeded = tllama.init_params(tcfg, torch.Generator().manual_seed(3),
                                device="cpu")
    jcfg, jparams = jio.load_model(export)
    assert jcfg.n_layers == tcfg.n_layers
    for name, w in seeded["layers"].items():
        got = np.asarray(jparams["layers"][name])
        if name in jlora.DEFAULT_TARGETS:
            assert not np.array_equal(got, w.numpy()), name
            np.testing.assert_allclose(got, w.numpy(), atol=0.1)
        else:
            np.testing.assert_array_equal(got, w.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(jparams["embed"]),
                                  seeded["embed"].numpy())
