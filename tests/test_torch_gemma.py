"""The Gemma family in the port, held against the JAX package on the CPU:
the presets, the artifact round trip (tied embeddings: no ``lm_head``
leaf), forward logits, the loss and every gradient, ``Trainer.step``,
the serving engines and the training entry point, on ``gemma.tiny`` and
on a tiny config with every Gemma-2 knob (sandwich norms, query scale,
attention softcap, the alternating window). Weights are JAX-made and
cross as numpy."""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import gemma as jgemma
from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.parallel import mesh as jmesh
from kubedl_tpu.serving import batching as jbatching
from kubedl_tpu.serving import engine as jengine
from kubedl_tpu.train import data as jdata
from kubedl_tpu.train import trainer as jtrainer
from kubedl_tpu_torch.models import gemma as tgemma
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.serving import batching as tbatching
from kubedl_tpu_torch.serving import engine as tengine
from kubedl_tpu_torch.train import __main__ as tmain
from kubedl_tpu_torch.train import data as tdata
from kubedl_tpu_torch.train import trainer as ttrainer

LOGPROB_ATOL = 1e-4
OPT = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=10,
           weight_decay=0.1, grad_clip=1.0)


def _gemma2_knobs(mod, vocab=256):
    """A tiny config with every Gemma-2 knob, in ``mod``'s package."""
    return dataclasses.replace(
        mod.tiny(vocab=vocab, seq=128), n_kv_heads=2, sliding_window=16,
        window_pattern="alternate", sandwich_norms=True,
        attn_logit_softcap=50.0, query_scale=32.0)


CONFIGS = {
    "gemma_tiny": lambda mod: mod.tiny(vocab=256, seq=128),
    "gemma2_knobs": _gemma2_knobs,
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request, tmp_path_factory):
    """(JAX config, JAX params, port config, port params, artifact path)
    of one float32 config."""
    jcfg = dataclasses.replace(CONFIGS[request.param](jgemma),
                               dtype=jnp.float32)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    path = str(tmp_path_factory.mktemp(request.param))
    jio.save_model(jcfg, params, path)
    tcfg, tparams = tio.load_model(path, device="cpu")
    return jcfg, params, tcfg, tparams, path


@pytest.mark.parametrize("preset", ["gemma_2b", "gemma_7b", "gemma2_2b",
                                    "tiny"])
def test_presets_match_jax(preset):
    want = dataclasses.asdict(getattr(jgemma, preset)())
    want["dtype"] = jnp.dtype(want["dtype"]).name
    assert getattr(tgemma, preset)().to_dict() == want
    base = dataclasses.replace(tllama.tiny(), dtype="float32")
    jbase = dataclasses.replace(jllama.tiny(), dtype=jnp.float32)
    got = tgemma.from_llama(base).to_dict()
    want = dataclasses.asdict(jgemma.from_llama(jbase))
    want["dtype"] = "float32"
    assert got == want


def test_artifact_round_trip_keeps_the_tied_head(model, tmp_path):
    """A JAX artifact loads with no ``lm_head`` leaf; the port's
    ``save_model`` writes one the JAX package loads back bit for bit."""
    jcfg, params, tcfg, tparams, _ = model
    assert tcfg.tie_embeddings and "lm_head" not in tparams
    assert tcfg.to_dict() == {**dataclasses.asdict(jcfg),
                              "dtype": "float32"}
    tio.save_model(tcfg, tparams, str(tmp_path))
    cfg2, params2 = jio.load_model(str(tmp_path))
    assert cfg2 == jcfg
    assert sorted(params2) == sorted(params)
    for a, b in zip(jax.tree_util.tree_leaves(params2),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_forward_logits_match_jax(model):
    jcfg, params, tcfg, tparams, _ = model
    toks = np.random.default_rng(1).integers(0, 256, (2, 40),
                                             dtype=np.int32)
    want = jllama.forward(jcfg, params, jnp.asarray(toks))
    with torch.no_grad():
        got = tllama.forward(tcfg, tparams, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_loss_and_gradients_match_jax(model, monkeypatch):
    """The loss and every gradient (chunked LM-head loss on both sides).
    Gemma-1's attention runs the flash Function's plain versions against
    the Pallas kernels in interpret mode; Gemma-2's knobs take the chunked
    path in both packages."""
    jcfg, params, tcfg, tparams, _ = model
    jcfg = dataclasses.replace(jcfg, loss_chunk=48)
    tcfg = dataclasses.replace(tcfg, loss_chunk=48)
    toks = np.random.default_rng(2).integers(0, 256, (2, 129),
                                             dtype=np.int32)
    tokens, targets = toks[:, :-1], toks[:, 1:]
    if not tcfg.query_scale:
        from kubedl_tpu_torch.ops import attention as tattn
        monkeypatch.setattr(jllama, "multi_head_attention", functools.partial(
            jllama.multi_head_attention, impl="pallas_interpret"))
        monkeypatch.setattr(tllama, "multi_head_attention", functools.partial(
            tattn.multi_head_attention, impl="plain"))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, jnp.asarray(tokens),
                                 jnp.asarray(targets)))(params)
    leaves = ttrainer.tree_leaves(tparams)
    for _, t in leaves:
        t.requires_grad_(True)
    try:
        loss = tllama.loss_fn(tcfg, tparams, torch.from_numpy(tokens).long(),
                              torch.from_numpy(targets).long())
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
    finally:
        for _, t in leaves:
            t.requires_grad_(False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    flat = {"/".join(str(k.key) for k in kp): v for kp, v in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for (k, _), g in zip(leaves, grads):
        want = np.asarray(flat[k])
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0, err_msg=k,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_trainer_steps_match_jax(model):
    """Three optimizer steps on a JAX-made Gemma: losses and every param
    against the JAX ``Trainer`` on a one-device mesh."""
    jcfg, params, tcfg, _, _ = model
    params = jax.tree.map(np.array, params)   # the JAX step donates its own
    stream = jdata.synthetic_lm_batches(4, 32, 256, seed=5)
    batches = [next(stream) for _ in range(3)]
    mesh = jmesh.build_mesh(devices=jax.devices()[:1])
    jtr = jtrainer.Trainer(
        lambda p, b: jllama.loss_fn(jcfg, p, b["tokens"], b["targets"]),
        jllama.param_specs(jcfg), mesh, jtrainer.TrainConfig(**OPT))
    jstate = jtr.init_state(jax.tree.map(jnp.asarray, params))
    jlosses = []
    for b in batches:
        jstate, loss = jtr.step(jstate, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        jlosses.append(float(loss))
    ttr = ttrainer.Trainer(
        lambda p, b: tllama.loss_fn(tcfg, p, b["tokens"], b["targets"]),
        ttrainer.TrainConfig(**OPT), device="cpu")
    tstate = ttr.init_state(tio.params_from_numpy(tcfg, params,
                                                  device="cpu"))
    tlosses = []
    for b in batches:
        tstate, loss = ttr.step(tstate, tdata.to_device(
            b, torch.device("cpu")))
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    flat = {"/".join(str(k.key) for k in kp): v for kp, v in
            jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    for k, t in ttrainer.tree_leaves(tstate.params):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(flat[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def _requests(seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 255, int(rng.integers(1, 30))).tolist(),
             int(rng.integers(3, 12))) for _ in range(n)]


def _drain(engine, reqs):
    rs = [engine.submit(p, n, logprobs=True) for p, n in reqs]
    engine.run([])
    return [r.result() for r in rs], [r.logprobs for r in rs]


@pytest.mark.parametrize("kv_mode", ["paged", "dense"])
def test_continuous_engine_matches_jax(model, kv_mode):
    """Greedy tokens and log-probabilities of the JAX engine; the
    alternating window holds per layer in the paged decode (prompts and
    generations run past the 16-token window)."""
    jcfg, params, tcfg, tparams, _ = model
    reqs = _requests()
    kw = dict(lanes=3, max_len=64, kv_mode=kv_mode, kv_block=8)
    want = _drain(jbatching.ContinuousBatchingEngine(jcfg, params, **kw),
                  reqs)
    got = _drain(tbatching.ContinuousBatchingEngine(tcfg, tparams,
                                                    device="cpu", **kw),
                 reqs)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=LOGPROB_ATOL)


def test_static_engine_matches_jax(model):
    jcfg, params, tcfg, tparams, _ = model
    prompts = [p for p, _ in _requests(seed=1, n=3)]
    want = jengine.InferenceEngine(
        jcfg, params, jengine.GenerateConfig(max_len=64)).generate(
        prompts, 8, return_logprobs=True)
    got = tengine.InferenceEngine(
        tcfg, tparams, tengine.GenerateConfig(max_len=64),
        device="cpu").generate(prompts, 8, return_logprobs=True)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, atol=LOGPROB_ATOL)


@pytest.mark.parametrize("preset", ["gemma.tiny", "gemma.gemma2_2b"])
def test_main_trains_gemma_presets_and_exports_for_jax(tmp_path, preset):
    """``python -m kubedl_tpu_torch.train`` on the Gemma presets (cut to a
    tiny width for the CPU): the loss is finite, and the export loads in
    the JAX package with the tied head and gives the port's logits."""
    over = {"dtype": "float32", "vocab_size": 256, "n_layers": 2}
    if preset == "gemma.gemma2_2b":
        over.update(d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
                    d_ff=128, sliding_window=8)
    export = str(tmp_path / "export")
    cfg = {"model": preset, "model_overrides": over, "batch": 2, "seq": 32,
           "steps": 2, "log_every": 0, "export_path": export,
           "optimizer": {"learning_rate": 1e-2, "warmup_steps": 1}}
    path = tmp_path / "train.json"
    path.write_text(json.dumps(cfg))
    losses = []
    assert tmain.main(["--config", str(path)], device="cpu",
                      on_step=lambda s, l: losses.append(l)) == 0
    assert len(losses) == 2 and all(map(np.isfinite, losses))
    jcfg, jparams = jio.load_model(export)
    tcfg, tparams = tio.load_model(export, device="cpu")
    assert jcfg.tie_embeddings and "lm_head" not in jparams
    toks = np.random.default_rng(3).integers(0, 256, (1, 20),
                                             dtype=np.int32)
    with torch.no_grad():
        got = tllama.forward(tcfg, tparams, torch.from_numpy(toks).long())
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jllama.forward(jcfg, jparams,
                                               jnp.asarray(toks))),
        atol=1e-4)
