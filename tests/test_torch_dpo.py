"""DPO in the port, held against ``kubedl_tpu/train/dpo.py`` on the CPU
on JAX-made float32 weights: sequence log-probabilities, the loss and its
metrics for each loss type, the loss function's gradients for every
parameter, and the first loss at ln 2 when the policy is the reference."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models import moe as jmoe
from kubedl_tpu.train import dpo as jdpo
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.train import dpo as tdpo
from kubedl_tpu_torch.train import trainer as ttrainer

VOCAB = 128
RTOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module", params=["llama", "moe"])
def model(request, tmp_path_factory):
    fam = jmoe if request.param == "moe" else jllama
    jcfg = dataclasses.replace(fam.tiny(vocab=VOCAB, seq=256),
                               dtype=jnp.float32)
    params = fam.init_params(jcfg, jax.random.PRNGKey(5))
    path = str(tmp_path_factory.mktemp(f"dpo_{request.param}"))
    jio.save_model(jcfg, params, path)
    tcfg, tparams = tio.load_model(path, device="cpu")
    return jcfg, params, tcfg, tparams


def _pairs(seed=0, n=2):
    rng = np.random.default_rng(seed)
    chosen, rejected, lens = [], [], []
    for _ in range(n):
        pl = int(rng.integers(2, 6))
        prompt = rng.integers(1, VOCAB, pl).tolist()
        chosen.append(prompt + rng.integers(1, VOCAB,
                                            int(rng.integers(2, 9))).tolist())
        rejected.append(prompt + rng.integers(
            1, VOCAB, int(rng.integers(2, 9))).tolist())
        lens.append(pl)
    return chosen, rejected, lens


def _batch(seed=0):
    want = jdpo.preference_batch(*_pairs(seed))
    got = tdpo.preference_batch(*_pairs(seed))
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    jb = {k: jnp.asarray(v) for k, v in want.items()}
    tb = {k: (torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v)) for k, v in got.items()}
    return jb, tb


def test_sequence_logprobs_match_jax(model):
    jcfg, jparams, tcfg, tparams = model
    jb, tb = _batch(1)
    want, waux = jdpo.sequence_logprobs(
        jcfg, jparams, jb["chosen_tokens"], jb["chosen_targets"],
        mask=jb["chosen_mask"], chunk=64, with_aux=True)
    with torch.no_grad():
        got, aux = tdpo.sequence_logprobs(
            tcfg, tparams, tb["chosen_tokens"], tb["chosen_targets"],
            mask=tb["chosen_mask"], chunk=64, with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("cfg", [dict(), dict(beta=0.5),
                                 dict(label_smoothing=0.2),
                                 dict(loss_type="ipo", beta=0.3)])
def test_dpo_loss_and_metrics_match_jax(cfg):
    rng = np.random.default_rng(2)
    lps = [rng.standard_normal(6).astype(np.float32) * 5 for _ in range(4)]
    want, wm = jdpo.dpo_loss(*map(jnp.asarray, lps), jdpo.DPOConfig(**cfg))
    got, gm = tdpo.dpo_loss(*map(torch.from_numpy, lps),
                            tdpo.DPOConfig(**cfg))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("cfg", [dict(loss_type="kto"),
                                 dict(label_smoothing=0.5),
                                 dict(loss_type="ipo", label_smoothing=0.1)])
def test_dpo_config_refuses_as_jax_does(cfg):
    with pytest.raises(ValueError) as want:
        jdpo.DPOConfig(**cfg)
    with pytest.raises(ValueError) as got:
        tdpo.DPOConfig(**cfg)
    assert str(got.value) == str(want.value)


def _flat(tree):
    return {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_dpo_gradients_match_jax(model):
    """The loss function with precomputed reference log-probabilities
    (off the policy, so the loss is not ln 2): the loss and every
    gradient."""
    jcfg, jparams, tcfg, tparams = model
    jb, tb = _batch(3)
    rng = np.random.default_rng(4)
    for side in ("chosen", "rejected"):
        ref = rng.standard_normal(2).astype(np.float32) * 3 - 40
        jb[f"ref_{side}_logps"] = jnp.asarray(ref)
        tb[f"ref_{side}_logps"] = torch.from_numpy(ref)
    dcfg = dict(beta=0.2)
    jloss, jgrads = jax.value_and_grad(jdpo.make_dpo_loss_fn(
        jcfg, jdpo.DPOConfig(**dcfg), chunk=64))(jparams, jb)
    leaves = ttrainer.tree_leaves(tparams)
    for _, t in leaves:
        t.requires_grad_(True)
    try:
        loss = tdpo.make_dpo_loss_fn(tcfg, tdpo.DPOConfig(**dcfg),
                                     chunk=64)(tparams, tb)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
    finally:
        for _, t in leaves:
            t.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    flat = _flat(jgrads)
    assert sorted(k for k, _ in leaves) == sorted(flat)
    for (k, _), g in zip(leaves, grads):
        want = flat[k]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=GRAD_RTOL, err_msg=k,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_the_first_loss_is_ln2_when_the_policy_is_the_reference(model):
    jcfg, jparams, tcfg, tparams = model
    _, tb = _batch(5)
    ref_c, ref_r = tdpo.reference_logps_fn(tcfg, tparams, chunk=64)(tb)
    pre = tdpo.make_dpo_loss_fn(tcfg, chunk=64)(
        tparams, {**tb, "ref_chosen_logps": ref_c,
                  "ref_rejected_logps": ref_r})
    inline = tdpo.make_dpo_loss_fn(tcfg, ref_params=tparams, chunk=64)(
        tparams, tb)
    # the MoE loss adds the router's weighted aux term of the same forward
    with torch.no_grad():
        _, _, aux = tdpo._pair_logprobs(tcfg, tparams, tb, chunk=64,
                                        with_aux=True)
    want = math.log(2) + getattr(tcfg, "aux_loss_weight", 0.0) * float(aux)
    for loss in (pre, inline):
        assert abs(float(loss) - want) < 1e-6
    with pytest.raises(ValueError, match="ref_"):
        tdpo.make_dpo_loss_fn(tcfg)(tparams, tb)
