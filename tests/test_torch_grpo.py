"""GRPO and the RL learner in the port.

Against ``kubedl_tpu/train/grpo.py`` on JAX-made float32 weights:
``GRPOConfig`` and its refusals, ``group_advantages`` (an all-equal group
is exactly 0), ``grpo_loss`` and its metrics with masking,
``token_logps`` for Llama, Gemma and MoE tiny, the loss function's
gradients, ``assemble_batch`` on fixed rollouts, and one ``Trainer`` step
on a fixed batch.

On the port alone: ``rollout_batch`` on both engines (the continuous
engine's submit surface and the static engine's ``generate``): shapes and
masks, ``old_logps`` equal to the policy's ``token_logps`` (the on-policy
identity), the same tokens again for a seed, a biased sampler refused; a
weight refresh that keeps the tensors a captured decode graph reads (on
the card, through a captured graph); ``resolve_reward`` in both forms;
``main`` in ``mode: grpo`` (a resumed job starts at the next round; text
prompts with a text reward); and ``FlywheelLearner``'s step, staleness,
publish (a fresh host restores the published params) and remesh.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import gemma as jgemma
from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models import moe as jmoe
from kubedl_tpu.parallel import mesh as jmesh
from kubedl_tpu.train import grpo as jgrpo
from kubedl_tpu.train import trainer as jtrainer
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.train import grpo as tgrpo
from kubedl_tpu_torch.train import trainer as ttrainer

VOCAB = 128
RTOL = 1e-5
OPT = dict(learning_rate=1e-2, warmup_steps=0, decay_steps=10,
           weight_decay=0.1, grad_clip=1.0)
#: Adam divides by sqrt(nu) + 1e-8, so a gradient element the two
#: frameworks compute ~1e-6 apart moves its update by up to ~1e-6 / 1e-8 of
#: itself where |g| ~ eps: a full-lr first step at lr 1e-3 keeps the param
#: gap under ~1e-4 (the bound test_torch_train.py holds the Trainer to at
#: lr 1e-2 after a warm-up step)
PARAM_ATOL = 1e-4
STEP_OPT = {**OPT, "learning_rate": 1e-3}
#: the on-policy identity in float32: the engines' sampled-token logprobs
#: (the KV-cache step's logits) against the training forward's
ON_POLICY_ATOL = 1e-4


def _make(kind):
    if kind == "moe":
        return jmoe, jmoe.tiny
    return jllama, (jgemma.tiny if kind == "gemma" else jllama.tiny)


@pytest.fixture(scope="module", params=["llama", "gemma", "moe"])
def model(request, tmp_path_factory):
    fam, make = _make(request.param)
    jcfg = dataclasses.replace(make(vocab=VOCAB, seq=256), dtype=jnp.float32)
    params = fam.init_params(jcfg, jax.random.PRNGKey(5))
    path = str(tmp_path_factory.mktemp(f"grpo_{request.param}"))
    jio.save_model(jcfg, params, path)
    tcfg, tparams = tio.load_model(path, device="cpu")
    return request.param, jcfg, params, tcfg, tparams, path


@pytest.fixture(scope="module")
def llama_model(tmp_path_factory):
    jcfg = dataclasses.replace(jllama.tiny(vocab=VOCAB, seq=256),
                               dtype=jnp.float32)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    path = str(tmp_path_factory.mktemp("grpo_llama"))
    jio.save_model(jcfg, params, path)
    return jcfg, params, path


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(group_size=1), dict(clip_eps=0.0),
                                 dict(kl_coef=-0.1)])
def test_grpo_config_refuses_as_jax_does(cfg):
    with pytest.raises(ValueError) as want:
        jgrpo.GRPOConfig(**cfg)
    with pytest.raises(ValueError) as got:
        tgrpo.GRPOConfig(**cfg)
    assert str(got.value) == str(want.value)
    assert dataclasses.asdict(tgrpo.GRPOConfig()) == \
        dataclasses.asdict(jgrpo.GRPOConfig())


@pytest.mark.parametrize("normalize_std", [True, False])
def test_group_advantages_match_jax(normalize_std):
    rewards = np.random.default_rng(0).random((3, 4)).astype(np.float32)
    rewards[1] = 0.75                     # an all-equal group
    jc = jgrpo.GRPOConfig(group_size=4, normalize_std=normalize_std)
    tc = tgrpo.GRPOConfig(group_size=4, normalize_std=normalize_std)
    want = np.asarray(jgrpo.group_advantages(rewards, jc))
    got = tgrpo.group_advantages(rewards, tc).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    assert (got[1] == 0).all() and (want[1] == 0).all()
    with pytest.raises(ValueError, match="rewards must be"):
        tgrpo.group_advantages(rewards.reshape(-1), tc)


def _loss_inputs(seed=1, b=4, s=8):
    rng = np.random.default_rng(seed)
    lp = -rng.random((b, s)).astype(np.float32) * 3
    old = lp + rng.standard_normal((b, s)).astype(np.float32) * 0.3
    ref = lp + rng.standard_normal((b, s)).astype(np.float32) * 0.2
    adv = rng.standard_normal(b).astype(np.float32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    mask[0] = 0.0                         # a row with no completion token
    return lp, old, ref, adv, mask


@pytest.mark.parametrize("cfg", [dict(), dict(clip_eps=0.05, kl_coef=0.5),
                                 dict(kl_coef=0.0)])
def test_grpo_loss_and_metrics_match_jax(cfg):
    args = _loss_inputs()
    want, wm = jgrpo.grpo_loss(*map(jnp.asarray, args),
                               jgrpo.GRPOConfig(**cfg))
    got, gm = tgrpo.grpo_loss(*map(torch.from_numpy, args),
                              tgrpo.GRPOConfig(**cfg))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    # a masked-out position changes nothing
    lp, old, ref, adv, mask = args
    lp2 = np.where(mask > 0, lp, lp - 5.0)
    moved, _ = tgrpo.grpo_loss(*map(torch.from_numpy,
                                    (lp2, old, ref, adv, mask)),
                               tgrpo.GRPOConfig(**cfg))
    assert float(moved) == float(got)


def _rows(seed=2, n=4):
    rng = np.random.default_rng(seed)
    rows, plens = [], []
    for _ in range(n):
        pl = int(rng.integers(2, 6))
        rows.append(rng.integers(1, VOCAB, pl + int(rng.integers(2, 9)))
                    .tolist())
        plens.append(pl)
    return rows, plens


def _grpo_batch(seed=3):
    """A fixed GRPO update batch (numpy): rendered rows, behavior and
    reference logps near the policy's, advantages."""
    from kubedl_tpu_torch.train.scoring import render_rows
    rows, plens = _rows(seed)
    b = render_rows(rows, plens)
    rng = np.random.default_rng(seed)
    shape = b["mask"].shape
    b["old_logps"] = (-rng.random(shape) * 5).astype(np.float32)
    b["ref_logps"] = (-rng.random(shape) * 5).astype(np.float32)
    b["advantages"] = rng.standard_normal(len(rows)).astype(np.float32)
    return b


def _t(b):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in b.items()}


def test_token_logps_match_jax(model):
    _, jcfg, jparams, tcfg, tparams, _ = model
    b = _grpo_batch()
    want, waux = jgrpo.token_logps(jcfg, jparams, jnp.asarray(b["tokens"]),
                                   jnp.asarray(b["targets"]), chunk=64,
                                   with_aux=True)
    with torch.no_grad():
        got, aux = tgrpo.token_logps(tcfg, tparams, _t(b)["tokens"],
                                     _t(b)["targets"], chunk=64,
                                     with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-4,
                               atol=1e-7)


def _flat(tree):
    return {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_grpo_loss_fn_gradients_match_jax(model):
    """The loss function (the MoE router's aux term included): the loss
    and every gradient."""
    _, jcfg, jparams, tcfg, tparams, _ = model
    b = _grpo_batch(4)
    gcfg = dict(group_size=2, kl_coef=0.1)
    jloss, jgrads = jax.value_and_grad(jgrpo.make_grpo_loss_fn(
        jcfg, jgrpo.GRPOConfig(**gcfg), chunk=64))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = ttrainer.tree_leaves(tparams)
    for _, t in leaves:
        t.requires_grad_(True)
    try:
        loss = tgrpo.make_grpo_loss_fn(tcfg, tgrpo.GRPOConfig(**gcfg),
                                       chunk=64)(tparams, _t(b))
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
    finally:
        for _, t in leaves:
            t.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=RTOL)
    flat = _flat(jgrads)
    assert sorted(k for k, _ in leaves) == sorted(flat)
    for (k, _), g in zip(leaves, grads):
        want = flat[k]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-4, err_msg=k,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _fixed_outs():
    rng = np.random.default_rng(7)
    prompts = [[1, 5, 9], [2, 4, 6, 8]]
    groups = [p for p in prompts for _ in range(2)]
    outs = []
    for _ in groups:
        n = int(rng.integers(1, 6))
        outs.append((rng.integers(1, VOCAB, n).tolist(),
                     (-rng.random(n)).astype(np.float32).tolist()))
    return prompts, groups, outs


def _reward(prompt, completion):
    return float(sum(t % 3 == 0 for t in completion)) / len(completion)


def test_assemble_batch_matches_jax():
    prompts, groups, outs = _fixed_outs()
    want = jgrpo.assemble_batch(groups, outs, len(prompts), _reward,
                                cfg=jgrpo.GRPOConfig(group_size=2))
    got = tgrpo.assemble_batch(groups, outs, len(prompts), _reward,
                               cfg=tgrpo.GRPOConfig(group_size=2))
    assert set(got) == set(want)
    for k in want:
        if k == "advantages":
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=RTOL, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)


def test_one_trainer_step_matches_jax(llama_model):
    """One ``Trainer`` step on a fixed batch: the loss and every updated
    parameter against the JAX ``Trainer``'s."""
    jcfg, jparams, path = llama_model
    tcfg, tparams = tio.load_model(path, device="cpu")
    b = _grpo_batch(5)
    gcfg = dict(group_size=2, kl_coef=0.1)
    mesh = jmesh.build_mesh(devices=jax.devices()[:1])
    jt = jtrainer.Trainer(jgrpo.make_grpo_loss_fn(
        jcfg, jgrpo.GRPOConfig(**gcfg), chunk=64), jllama.param_specs(jcfg),
        mesh, jtrainer.TrainConfig(**STEP_OPT))
    jstate = jt.init_state(jparams)       # before the step is built
    jstate, jloss = jt.step(jstate, {k: jnp.asarray(v)
                                     for k, v in b.items()})
    tt = ttrainer.Trainer(tgrpo.make_grpo_loss_fn(
        tcfg, tgrpo.GRPOConfig(**gcfg), chunk=64),
        ttrainer.TrainConfig(**STEP_OPT), device="cpu")
    tstate, tloss = tt.step(tt.init_state(tparams), _t(b))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    flat = _flat(jstate.params)
    for k, v in ttrainer.tree_leaves(tstate.params):
        np.testing.assert_allclose(v.detach().numpy(), flat[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


# -- the port alone: rollouts, refresh, the entrypoint, the learner ----------

def _engines(tcfg, tparams):
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine
    from kubedl_tpu_torch.serving.engine import (GenerateConfig,
                                                 InferenceEngine)
    return {"continuous": ContinuousBatchingEngine(
                tcfg, tparams, lanes=4, max_len=64, device="cpu"),
            "static": InferenceEngine(tcfg, tparams, GenerateConfig(
                max_len=64, temperature=1.0), device="cpu")}


PROMPTS = [[1, 7, 3], [4, 9, 2, 11, 5]]


def _on_policy_gap(tcfg, tparams, batch) -> float:
    with torch.no_grad():
        lp = tgrpo.token_logps(tcfg, tparams, _t(batch)["tokens"],
                               _t(batch)["targets"])
    m = batch["mask"] > 0
    return float(np.abs(lp.numpy()[m] - batch["old_logps"][m]).max())


@pytest.mark.parametrize("surface", ["continuous", "static"])
def test_rollouts_are_on_policy(llama_model, surface):
    _, _, path = llama_model
    tcfg, tparams = tio.load_model(path, device="cpu")
    engine = _engines(tcfg, tparams)[surface]
    cfg = tgrpo.GRPOConfig(group_size=3)
    batch = tgrpo.rollout_batch(engine, PROMPTS, _reward, 6, cfg=cfg,
                                seed=11)
    n = len(PROMPTS) * cfg.group_size
    assert batch["tokens"].shape == (n, 128)
    assert batch["rewards"].shape == (len(PROMPTS), cfg.group_size)
    assert batch["advantages"].shape == (n,)
    plens = [len(p) for p in PROMPTS for _ in range(cfg.group_size)]
    for i, pl in enumerate(plens):
        # the mask covers the 6 completion targets, from pl - 1
        assert batch["mask"][i].sum() == 6
        assert batch["mask"][i, pl - 1] == 1 and batch["mask"][i, pl - 2] == 0
        assert (batch["old_logps"][i][batch["mask"][i] == 0] == 0).all()
    assert _on_policy_gap(tcfg, tparams, batch) < ON_POLICY_ATOL
    again = tgrpo.rollout_batch(engine, PROMPTS, _reward, 6, cfg=cfg,
                                seed=11)
    np.testing.assert_array_equal(again["tokens"], batch["tokens"])
    other = tgrpo.rollout_batch(engine, PROMPTS, _reward, 6, cfg=cfg,
                                seed=12)
    assert not np.array_equal(other["tokens"], batch["tokens"])


def test_a_biased_sampler_is_refused(llama_model):
    from kubedl_tpu_torch.serving.engine import (GenerateConfig,
                                                 InferenceEngine)
    _, _, path = llama_model
    tcfg, tparams = tio.load_model(path, device="cpu")
    for gen in (GenerateConfig(max_len=64),
                GenerateConfig(max_len=64, temperature=1.0, top_k=5),
                GenerateConfig(max_len=64, temperature=1.0, top_p=0.9)):
        engine = InferenceEngine(tcfg, tparams, gen, device="cpu")
        with pytest.raises(ValueError, match="GRPO rollouts need plain "
                                             "sampling"):
            tgrpo.rollout_batch(engine, PROMPTS, _reward, 4,
                                cfg=tgrpo.GRPOConfig(group_size=2))


def _moved(tparams, scale=0.5):
    gen = torch.Generator().manual_seed(3)
    return ttrainer.tree_map(
        lambda t: t + scale * torch.randn(t.shape, generator=gen) * t.std(),
        tparams)


@pytest.mark.parametrize("surface", ["continuous", "static"])
def test_a_weight_refresh_keeps_the_served_tensors(llama_model, surface):
    """``load_weights`` copies a new policy into the tensors the engine
    already serves (a captured decode graph holds their addresses): the
    rollouts that follow are the new policy's, as a fresh engine on the
    new weights samples them."""
    _, _, path = llama_model
    tcfg, tparams = tio.load_model(path, device="cpu")
    engine = _engines(tcfg, tparams)[surface]
    cfg = tgrpo.GRPOConfig(group_size=2)
    before = tgrpo.rollout_batch(engine, PROMPTS, _reward, 5, cfg=cfg,
                                 seed=3)
    ptrs = {k: t.data_ptr() for k, t in
            ttrainer.tree_leaves(engine.params)}
    new = _moved(tparams)
    engine.load_weights(new)
    assert ptrs == {k: t.data_ptr() for k, t in
                    ttrainer.tree_leaves(engine.params)}
    after = tgrpo.rollout_batch(engine, PROMPTS, _reward, 5, cfg=cfg,
                                seed=3)
    fresh = tgrpo.rollout_batch(_engines(tcfg, new)[surface], PROMPTS,
                                _reward, 5, cfg=cfg, seed=3)
    np.testing.assert_array_equal(after["tokens"], fresh["tokens"])
    np.testing.assert_array_equal(after["old_logps"], fresh["old_logps"])
    assert not np.array_equal(after["old_logps"], before["old_logps"])
    assert _on_policy_gap(tcfg, new, after) < ON_POLICY_ATOL
    with pytest.raises(ValueError, match="cannot replace"):
        engine.load_weights({**new, "embed": new["embed"][:, :8]})


def test_the_continuous_engine_refreshes_only_when_idle(llama_model):
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine
    _, _, path = llama_model
    tcfg, tparams = tio.load_model(path, device="cpu")

    def make(params):
        # blocks of 2: the prefix below pins 2 full pool blocks
        return ContinuousBatchingEngine(tcfg, params, lanes=4, max_len=64,
                                        kv_block=2, device="cpu")

    engine = make(tparams)
    engine.register_prefix([1, 7, 3, 2])
    engine.submit([1, 2, 3], 4)
    with pytest.raises(RuntimeError, match="idle engine"):
        engine.load_weights(tparams)
    while engine.step():
        pass
    blocks = engine._prefixes[0].blocks
    new = _moved(tparams)
    engine.load_weights(new)
    # the registered prefix stays in its blocks, its K/V prefilled again
    # under the new weights: what a fresh registration fills
    fresh = make(new)
    fresh.register_prefix([1, 7, 3, 2])
    assert engine.prefix_count == 1 and len(blocks) == 2
    assert engine._prefixes[0].blocks == blocks
    for k in ("k", "v"):
        torch.testing.assert_close(
            engine._pool[k][:, list(blocks)],
            fresh._pool[k][:, list(fresh._prefixes[0].blocks)],
            rtol=0, atol=0)
    outs = []
    for eng in (engine, fresh):
        req = eng.submit([1, 7, 3, 2, 9, 4], 4, logprobs=True)
        while eng.step():
            pass
        outs.append((req.result(), req.logprobs))
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_a_weight_refresh_reaches_a_captured_decode_graph(llama_model):
    """On the card the decode tick is a CUDA graph captured at the first
    tick: after ``load_weights`` its replays decode the new policy (the
    same tokens and logprobs as the eager tick on the new weights)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode tick is a CUDA graph "
                    "only there")
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine
    _, _, path = llama_model
    tcfg, tparams = tio.load_model(path, device="cuda")
    engine = ContinuousBatchingEngine(tcfg, tparams, lanes=4, max_len=64,
                                      device="cuda")
    cfg = tgrpo.GRPOConfig(group_size=2)
    tgrpo.rollout_batch(engine, PROMPTS, _reward, 5, cfg=cfg, seed=3)
    assert engine.tick_launches["graph"] > 0
    new = _moved(tparams)
    engine.load_weights(new)
    after = tgrpo.rollout_batch(engine, PROMPTS, _reward, 5, cfg=cfg, seed=3)
    eager = ContinuousBatchingEngine(tcfg, new, lanes=4, max_len=64,
                                     device="cuda")
    eager._tick_p.route = "eager"
    fresh = tgrpo.rollout_batch(eager, PROMPTS, _reward, 5, cfg=cfg, seed=3)
    np.testing.assert_array_equal(after["tokens"], fresh["tokens"])
    np.testing.assert_allclose(after["old_logps"], fresh["old_logps"],
                               atol=1e-5)


def test_resolve_reward_takes_both_forms(tmp_path):
    from kubedl_tpu_torch.train import __main__ as tmain
    fn = tmain.resolve_reward("tests.test_torch_grpo:_reward")
    assert fn.__name__ == "_reward" and fn([1], [3, 4]) == 0.5
    path = tmp_path / "rw.py"
    path.write_text("def score(prompt, completion):\n"
                    "    return float(len(completion))\n")
    assert tmain.resolve_reward(f"{path}:score")([1], [2, 3]) == 2.0
    with pytest.raises(ValueError, match="reward must be"):
        tmain.resolve_reward("no_function_named")
    with pytest.raises(ValueError, match="no function 'nope'"):
        tmain.resolve_reward(f"{path}:nope")


def _grpo_config(tmp, name, path, rounds, **extra) -> str:
    cfg = {"model": {"model_path": path}, "mode": "grpo", "seed": 2,
           "data": {"kind": "prompts_jsonl", "path": str(tmp / "p.jsonl")},
           "reward": "tests.test_torch_grpo:_reward",
           "grpo": {"group_size": 4},
           "rollout": {"rounds": rounds, "steps_per_round": 1,
                       "max_new_tokens": 4, "max_len": 64,
                       "prompts_per_round": 2},
           "optimizer": {"learning_rate": 1e-2, "warmup_steps": 0},
           **extra}
    (tmp / "p.jsonl").write_text("".join(json.dumps({"prompt": p}) + "\n"
                                         for p in PROMPTS + [[3, 3, 8]]))
    out = tmp / f"{name}.json"
    out.write_text(json.dumps(cfg))
    return str(out)


def _main(path) -> list:
    from kubedl_tpu_torch.train import __main__ as tmain
    out = []
    assert tmain.main(["--config", path], device="cpu",
                      on_step=lambda s, l: out.append((s, l))) == 0
    return out


def test_main_grpo_resumes_at_the_next_round(llama_model, tmp_path):
    """A job of 2 rounds, and one of 1 round that a second job on the
    same checkpoint directory resumes: the resumed job starts at round 2
    (step 2, the second round's prompts and seed) and its losses are the
    uninterrupted job's."""
    _, _, path = llama_model
    whole = _main(_grpo_config(tmp_path, "whole", path, 2))
    ck = {"directory": str(tmp_path / "ck"), "save_interval_steps": 1}
    first = _main(_grpo_config(tmp_path, "first", path, 1, checkpoint=ck))
    resumed = _main(_grpo_config(tmp_path, "resumed", path, 2,
                                 checkpoint=ck))
    assert [s for s, _ in whole] == [1, 2]
    assert [s for s, _ in first] == [1]
    assert [s for s, _ in resumed] == [2]
    np.testing.assert_allclose([l for _, l in first + resumed],
                               [l for _, l in whole], rtol=1e-5)
    assert all(np.isfinite(l) for _, l in whole)


def text_reward(prompt, completion, tokenizer):
    """A text-level reward: the share of decoded bytes that are letters."""
    text = tokenizer.decode(completion)
    return sum(c.isalpha() for c in text) / max(len(text), 1)


def test_main_grpo_takes_text_prompts_and_a_text_reward(tmp_path):
    cfg = {"model": "llama.tiny",
           "model_overrides": {"dtype": "float32", "vocab_size": 512},
           "mode": "grpo",
           "data": {"kind": "prompts_jsonl", "path": str(tmp_path / "p"),
                    "tokenizer": "byte"},
           "reward": "tests.test_torch_grpo:text_reward",
           "grpo": {"group_size": 2},
           "rollout": {"rounds": 1, "steps_per_round": 1,
                       "max_new_tokens": 4, "max_len": 64},
           "optimizer": {"learning_rate": 1e-3, "warmup_steps": 0}}
    (tmp_path / "p").write_text(json.dumps({"prompt": "2+2="}) + "\n")
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    assert [s for s, _ in _main(str(path))] == [1]
    # the same reward without a tokenizer is refused before any rollout
    del cfg["data"]["tokenizer"]
    cfg["data"]["path"] = str(tmp_path / "ids")
    (tmp_path / "ids").write_text(json.dumps({"prompt": [1, 2]}) + "\n")
    path.write_text(json.dumps(cfg))
    from kubedl_tpu_torch.train import __main__ as tmain
    with pytest.raises(ValueError, match="declares a tokenizer parameter"):
        tmain.main(["--config", str(path)], device="cpu")
    cfg["data"]["path"] = str(tmp_path / "p")
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="text prompts need data.tokenizer"):
        tmain.main(["--config", str(path)], device="cpu")


class _Gauge:
    def __init__(self):
        self.calls = []

    def inc(self, **labels):
        self.calls.append(("inc", labels))

    def set(self, value, **labels):
        self.calls.append((value, labels))


def test_flywheel_learner_steps_publishes_and_remeshes(llama_model,
                                                       tmp_path):
    from kubedl_tpu_torch.models import llama as tllama
    from kubedl_tpu_torch.parallel.mesh import build_mesh
    from kubedl_tpu_torch.rl import FlywheelLearner
    from kubedl_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                   TieredCheckpointManager)
    _, _, path = llama_model
    tcfg, tparams = tio.load_model(path, device="cpu")
    initial = ttrainer.tree_map(torch.clone, tparams)
    engine = _engines(tcfg, ttrainer.tree_map(torch.clone, tparams))[
        "continuous"]
    trainer = ttrainer.Trainer(None, ttrainer.TrainConfig(**OPT),
                               param_specs=tllama.param_specs(tcfg),
                               mesh=build_mesh(device="cpu"))
    ck = TieredCheckpointManager(
        CheckpointConfig(str(tmp_path / "local")), str(tmp_path / "object"))
    metrics = types.SimpleNamespace(batches_consumed=_Gauge(),
                                    staleness=_Gauge())
    learner = FlywheelLearner(tcfg, trainer, tparams, checkpoint=ck,
                              metrics=metrics, job="j",
                              grpo=tgrpo.GRPOConfig(group_size=2))

    def rollout(version, seed):
        return types.SimpleNamespace(version=version, batch=tgrpo
                                     .rollout_batch(engine, PROMPTS,
                                                    _reward, 5,
                                                    cfg=learner.grpo,
                                                    seed=seed))

    first = rollout(0, 1)
    loss = learner.step(first)
    assert np.isfinite(loss) and learner.staleness_last == 0
    published = learner.publish()
    assert learner.version == 1
    for k, v in ttrainer.tree_leaves(learner.state.params):
        assert torch.equal(dict(ttrainer.tree_leaves(published))[k],
                           v.detach())
    # a fresh host restores exactly the published params from the object
    # tier (its local disk starts empty)
    other = TieredCheckpointManager(
        CheckpointConfig(str(tmp_path / "other")), str(tmp_path / "object"))
    fresh = ttrainer.Trainer(None, ttrainer.TrainConfig(**OPT),
                             device="cpu")
    restored = other.restore(fresh.init_state(_moved(tparams)))
    assert restored.step == 1
    for k, v in ttrainer.tree_leaves(restored.params):
        assert torch.equal(v.detach(), dict(ttrainer.tree_leaves(
            published))[k]), k
    # a batch of the previous version is one version stale
    learner.step(rollout(0, 2))
    assert (learner.staleness_last, learner.staleness_max) == (1, 1)
    assert metrics.staleness.calls[-1] == (1, {"job": "j"})
    assert len(metrics.batches_consumed.calls) == 2
    # the frozen reference never moved
    for k, v in ttrainer.tree_leaves(learner.ref_params):
        assert torch.equal(v, dict(ttrainer.tree_leaves(initial))[k])
    # remesh: a save, the new mesh, a restore; the state continues
    before = {k: v.detach().clone()
              for k, v in ttrainer.tree_leaves(learner.state.params)}
    learner.remesh(build_mesh(device="cpu"))
    assert learner.resizes == 1 and learner.state.step == 2
    for k, v in ttrainer.tree_leaves(learner.state.params):
        assert torch.equal(v.detach(), before[k]), k
    assert np.isfinite(learner.step(rollout(1, 3)))
    assert learner.state.step == 3
    ck.close()
    other.close()
    no_ck = FlywheelLearner(tcfg, ttrainer.Trainer(
        None, ttrainer.TrainConfig(**OPT), device="cpu"), initial)
    with pytest.raises(ValueError, match="remesh needs a checkpoint"):
        no_ck.remesh(build_mesh(device="cpu"))
