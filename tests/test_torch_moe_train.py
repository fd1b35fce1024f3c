"""The MoE family's training in the port, held against the JAX package
on the CPU on a JAX-made float32 ``moe.tiny``: the loss (the router's
load-balancing term included) and every gradient, ``w_router`` among
them; three ``Trainer`` steps; and ``python -m kubedl_tpu_torch.train``
on the ``moe`` presets (its export loads in the JAX package; ``lora``
trains the attention adapters of an MoE model as the JAX entry point
does; ``export_hf_path`` raises as it does there)."""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models import moe as jmoe
from kubedl_tpu.ops import lora as jlora
from kubedl_tpu.parallel import mesh as jmesh
from kubedl_tpu.train import __main__ as jtmain
from kubedl_tpu.train import data as jdata
from kubedl_tpu.train import trainer as jtrainer
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.models import moe as tmoe
from kubedl_tpu_torch.ops import lora as tlora
from kubedl_tpu_torch.train import __main__ as tmain
from kubedl_tpu_torch.train import data as tdata
from kubedl_tpu_torch.train import trainer as ttrainer

VOCAB = 128
OPT = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=10,
           weight_decay=0.1, grad_clip=1.0)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(JAX config, JAX params, port config, port params) of a float32
    ``moe.tiny``, carried across by the artifact format."""
    jcfg = dataclasses.replace(jmoe.tiny(vocab=VOCAB, seq=128),
                               dtype=jnp.float32)
    params = jmoe.init_params(jcfg, jax.random.PRNGKey(3))
    path = str(tmp_path_factory.mktemp("moe_train"))
    jio.save_model(jcfg, params, path)
    tcfg, tparams = tio.load_model(path, device="cpu")
    return jcfg, params, tcfg, tparams


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape,
                                                dtype=np.int32)


def _flat(tree):
    return {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_loss_and_every_gradient_match_jax(model, monkeypatch):
    """The loss (aux included) and every gradient, ``w_router`` among
    them, with the chunked LM-head loss on both sides. The JAX side runs
    its Pallas kernels in interpret mode, the port its flash Function's
    plain versions; with remat on the port recomputes each layer."""
    jcfg, params, tcfg, tparams = model
    jcfg = dataclasses.replace(jcfg, loss_chunk=48)
    tcfg = dataclasses.replace(tcfg, loss_chunk=48)
    toks = _tokens(2, (2, 129))
    tokens, targets = toks[:, :-1], toks[:, 1:]
    from kubedl_tpu_torch.ops import attention as tattn
    monkeypatch.setattr(jllama, "multi_head_attention", functools.partial(
        jllama.multi_head_attention, impl="pallas_interpret"))
    monkeypatch.setattr(tllama, "multi_head_attention", functools.partial(
        tattn.multi_head_attention, impl="plain"))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmoe.loss_fn(jcfg, p, jnp.asarray(tokens),
                               jnp.asarray(targets)))(params)
    leaves = ttrainer.tree_leaves(tparams)
    for _, t in leaves:
        t.requires_grad_(True)
    try:
        loss = tmoe.loss_fn(tcfg, tparams, torch.from_numpy(tokens).long(),
                            torch.from_numpy(targets).long())
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
    finally:
        for _, t in leaves:
            t.requires_grad_(False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    flat = _flat(jgrads)
    assert sorted(k for k, _ in leaves) == sorted(flat)
    for (k, _), g in zip(leaves, grads):
        want = np.asarray(flat[k])
        assert float(np.abs(want).max()) > 0, k
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0, err_msg=k,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_trainer_steps_match_jax(model):
    """Three optimizer steps: losses and every param against the JAX
    ``Trainer`` on a one-device mesh."""
    jcfg, params, tcfg, _ = model
    params = jax.tree.map(np.array, params)   # the JAX step donates its own
    stream = jdata.synthetic_lm_batches(4, 32, VOCAB, seed=5)
    batches = [next(stream) for _ in range(3)]
    mesh = jmesh.build_mesh(devices=jax.devices()[:1])
    jtr = jtrainer.Trainer(
        lambda p, b: jmoe.loss_fn(jcfg, p, b["tokens"], b["targets"]),
        jmoe.param_specs(jcfg), mesh, jtrainer.TrainConfig(**OPT))
    jstate = jtr.init_state(jax.tree.map(jnp.asarray, params))
    jlosses = []
    for b in batches:
        jstate, loss = jtr.step(jstate, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        jlosses.append(float(loss))
    ttr = ttrainer.Trainer(
        lambda p, b: tmoe.loss_fn(tcfg, p, b["tokens"], b["targets"]),
        ttrainer.TrainConfig(**OPT), device="cpu")
    tstate = ttr.init_state(tio.params_from_numpy(tcfg, params,
                                                  device="cpu"))
    tlosses = []
    for b in batches:
        tstate, loss = ttr.step(tstate, tdata.to_device(
            b, torch.device("cpu")))
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    flat = _flat(jstate.params)
    for k, t in ttrainer.tree_leaves(tstate.params):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(flat[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def _config(tmp_path, **over) -> str:
    cfg = {"model": "moe.tiny",
           "model_overrides": {"dtype": "float32", "vocab_size": VOCAB},
           "batch": 2, "seq": 32, "steps": 3, "log_every": 0, "seed": 2,
           "optimizer": {"learning_rate": 1e-2, "warmup_steps": 1}, **over}
    path = tmp_path / "train.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_main_trains_moe_tiny_and_exports_for_jax(tmp_path):
    """``python -m kubedl_tpu_torch.train`` on ``moe.tiny``: the loss is
    finite and falls on a repeated batch, the optimizer steps the router,
    and the export is an MoE artifact whose logits the JAX package
    reproduces."""
    toks = tmp_path / "toks.bin"
    _tokens(9, 2 * 33).tofile(toks)
    export = str(tmp_path / "export")
    losses = []
    assert tmain.main(["--config", _config(
        tmp_path, steps=4, export_path=export,
        data={"kind": "tokens", "path": str(toks)})], device="cpu",
        on_step=lambda s, l: losses.append(l)) == 0
    assert len(losses) == 4 and all(map(np.isfinite, losses))
    assert losses[-1] < losses[0]
    assert json.load(open(f"{export}/config.json"))["family"] == "moe"
    jcfg, jparams = jio.load_model(export)
    tcfg, tparams = tio.load_model(export, device="cpu")
    assert isinstance(jcfg, jmoe.MoEConfig) and jcfg.loss_chunk == 512
    seeded = tmoe.init_params(tcfg, torch.Generator().manual_seed(2),
                              device="cpu")
    assert not torch.equal(seeded["layers"]["w_router"],
                           tparams["layers"]["w_router"])
    x = _tokens(3, (1, 20))
    with torch.no_grad():
        got = tmoe.forward(tcfg, tparams, torch.from_numpy(x).long())
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jmoe.forward(jcfg, jparams, jnp.asarray(x))),
        atol=1e-4)


def test_main_lora_on_moe_matches_the_jax_entry_point(model, tmp_path):
    """``"lora"`` with an MoE model: the JAX entry point trains the
    attention adapters of the sparse stack, and so does the port — the
    adapter loss and gradients equal JAX's on the same adapters, and the
    entry point trains and exports folded weights."""
    jcfg, params, tcfg, tparams = model
    assert jtmain.resolve_model({"model": "moe.tiny"})[0].n_experts == 4
    rng = np.random.default_rng(4)
    ad = {n: {"a": rng.normal(size=(2, 128, w)).astype(np.float32) * 0.1,
              "b": rng.normal(size=(2, w, o)).astype(np.float32) * 0.1}
          for n, w, o in (("wq", 4, 128), ("wv", 4, 64))}
    toks = _tokens(5, (2, 33))
    tokens, targets = toks[:, :-1], toks[:, 1:]
    want_loss, want = jax.value_and_grad(lambda a: jmoe.loss_fn(
        jcfg, jlora.merge_params(params, a, alpha=8.0), jnp.asarray(tokens),
        jnp.asarray(targets)))(jax.tree.map(jnp.asarray, ad))
    tad = {n: {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in ab.items()} for n, ab in ad.items()}
    leaves = ttrainer.tree_leaves(tad)
    loss = tmoe.loss_fn(tcfg, tlora.merge_params(tparams, tad, alpha=8.0),
                        torch.from_numpy(tokens).long(),
                        torch.from_numpy(targets).long())
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    want = _flat(want)
    for (k, _), g in zip(leaves, grads):
        np.testing.assert_allclose(
            g.numpy(), want[k], rtol=0, err_msg=k,
            atol=1e-5 * max(1.0, float(np.abs(want[k]).max())))
    export = str(tmp_path / "export")
    losses = []
    assert tmain.main(["--config", _config(
        tmp_path, lora={"rank": 4}, export_path=export)], device="cpu",
        on_step=lambda s, l: losses.append(l)) == 0
    assert all(map(np.isfinite, losses))
    jcfg2, jparams2 = jio.load_model(export)
    assert isinstance(jcfg2, jmoe.MoEConfig)
    seeded = tmoe.init_params(tcfg, torch.Generator().manual_seed(2),
                              device="cpu")
    # the adapters fold into the attention projections only
    np.testing.assert_array_equal(np.asarray(jparams2["layers"]["w_gate"]),
                                  seeded["layers"]["w_gate"].numpy())
    assert not np.array_equal(np.asarray(jparams2["layers"]["wq"]),
                              seeded["layers"]["wq"].numpy())


@pytest.mark.parametrize("model_spec", ["preset", "artifact"])
def test_export_hf_path_with_moe_raises_as_in_jax(tmp_path, model_spec):
    """No HF format holds an MoE model: ``export_hf_path`` raises
    ``ValueError`` before any training, as the JAX entry point's up-front
    check does, for a preset and for an artifact."""
    model = "moe.tiny"
    if model_spec == "artifact":
        cfg = dataclasses.replace(tmoe.tiny(vocab=VOCAB), dtype="float32")
        tio.save_model(cfg, tmoe.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"),
            str(tmp_path / "art"))
        model = {"model_path": str(tmp_path / "art")}
    with pytest.raises(ValueError, match="MoE configs have no HF mapping"):
        tmain.main(["--config", _config(tmp_path, model=model,
                                        export_hf_path="/x")],
                   device="cpu")
    # ep trains across processes (test_torch_cp_ep_train.py); one
    # process holds no ep=2 mesh
    with pytest.raises(ValueError, match="devices, have 1"):
        tmain.main(["--config", _config(tmp_path, mesh={"ep": 2})],
                   device="cpu")
