"""The evaluation harness in the port, held against
``kubedl_tpu/train/evaluate.py`` on the CPU on JAX-made float32 weights
of each family (Llama, Gemma, MoE: every one goes through
``scoring.hidden_and_head``): per-row NLL, corpus perplexity and
multiple-choice log-likelihood ranks."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubedl_tpu.models import gemma as jgemma
from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models import moe as jmoe
from kubedl_tpu.train import evaluate as jev
from kubedl_tpu.train import scoring as jscoring
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.train import evaluate as tev
from kubedl_tpu_torch.train import scoring as tscoring

import jax

VOCAB = 128
RTOL = 1e-5
FAMILIES = {"llama": jllama, "gemma": jgemma, "moe": jmoe}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def model(request, tmp_path_factory):
    """(JAX config, JAX params, port config, port params) of a float32
    ``tiny`` of each family, carried across by the artifact format."""
    fam = FAMILIES[request.param]
    jcfg = dataclasses.replace(fam.tiny(vocab=VOCAB, seq=128),
                               dtype=jnp.float32)
    init = jmoe.init_params if fam is jmoe else jllama.init_params
    params = init(jcfg, jax.random.PRNGKey(7))
    path = str(tmp_path_factory.mktemp(f"eval_{request.param}"))
    jio.save_model(jcfg, params, path)
    tcfg, tparams = tio.load_model(path, device="cpu")
    return jcfg, params, tcfg, tparams


def _batches(seed, n=3, b=2, s=40, masked=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, VOCAB, (b, s + 1), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if masked:
            batch["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
        out.append(batch)
    return out


def _torch(batch):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in batch.items()}


@pytest.mark.parametrize("masked", [True, False])
def test_row_nll_and_perplexity_match_jax(model, masked):
    jcfg, jparams, tcfg, tparams = model
    batches = _batches(3, masked=masked)
    jrow = jev.make_row_nll_fn(jcfg, chunk=16)
    trow = tev.make_row_nll_fn(tcfg, chunk=16)
    for b in batches:
        np.testing.assert_allclose(
            trow(tparams, _torch(b)).numpy(),
            np.asarray(jrow(jparams, {k: jnp.asarray(v)
                                      for k, v in b.items()})), rtol=RTOL)
    want = jev.perplexity(jcfg, jparams, iter(
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]),
        chunk=16, max_batches=2)
    got = tev.perplexity(tcfg, tparams, iter(map(_torch, batches)),
                         chunk=16, max_batches=2)
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=RTOL)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=RTOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_loglikelihood_ranks_match_jax(model, normalize):
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(11)
    questions = [{"prompt": rng.integers(1, VOCAB, int(pl)).tolist(),
                  "options": [rng.integers(1, VOCAB, int(n)).tolist()
                              for n in rng.integers(1, 6, n_opt)]}
                 for pl, n_opt in ((3, 4), (7, 2), (1, 3))]
    want = jev.loglikelihood_ranks(jcfg, jparams, questions,
                                   length_normalize=normalize)
    got = tev.loglikelihood_ranks(tcfg, tparams, questions,
                                  length_normalize=normalize)
    assert [g["choice"] for g in got] == [w["choice"] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["logps"], w["logps"], rtol=RTOL)


def test_the_refusals_match_jax(model):
    jcfg, jparams, tcfg, tparams = model
    for bad in ([{"prompt": [], "options": [[1]]}],
                [{"prompt": [1], "options": [[1], []]}]):
        with pytest.raises(ValueError) as want:
            jev.loglikelihood_ranks(jcfg, jparams, bad)
        with pytest.raises(ValueError) as got:
            tev.loglikelihood_ranks(tcfg, tparams, bad)
        assert str(got.value) == str(want.value)
    assert tev.loglikelihood_ranks(tcfg, tparams, []) == []
    with pytest.raises(ValueError, match="no target tokens"):
        tev.perplexity(tcfg, tparams, iter([]))


def test_render_rows_is_jax_s():
    rows = [[1, 5, 6, 7], [1, 2, 3]]
    want = jscoring.render_rows(rows, [2, 1], pad_id=9, pad_to=8)
    got = tscoring.render_rows(rows, [2, 1], pad_id=9, pad_to=8)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for args in (([[1, 2]], [0]), ([[1, 2]], [2]), ([[1, 2]], [1, 1])):
        with pytest.raises(ValueError) as w:
            jscoring.render_rows(*args)
        with pytest.raises(ValueError) as g:
            tscoring.render_rows(*args)
        assert str(g.value) == str(w.value)
