"""Speculative lanes of the port's continuous-batching engine, held
against the JAX package's on the CPU: a draft proposes k tokens per lane,
one [lanes, k+1] target pass verifies them, and greedy lanes emit the
target's own greedy tokens. The target and the draft are JAX-made
artifacts loaded by the port. Sampled lanes draw from other generators
than JAX's, so they are held only to themselves."""

import dataclasses

import pytest

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.serving import batching as jbatching
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.serving import batching as tbatching
from kubedl_tpu_torch.serving.engine import GenerateConfig

PROMPTS = [[5, 7, 11], [3], [9, 2, 4, 8], [1, 1, 2, 3, 5], [13, 21]]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("spec")
    tcfg = dataclasses.replace(jllama.tiny(vocab=128), dtype=jnp.float32)
    tparams = jllama.init_params(tcfg, jax.random.PRNGKey(0))
    dcfg = dataclasses.replace(jllama.tiny(vocab=128), d_model=64,
                               n_layers=1, n_heads=2, n_kv_heads=2,
                               d_ff=128, dtype=jnp.float32)
    dparams = jllama.init_params(dcfg, jax.random.PRNGKey(1))
    jio.save_model(tcfg, tparams, str(root / "target"))
    jio.save_model(dcfg, dparams, str(root / "draft"))
    return ((tcfg, tparams, dcfg, dparams),
            tio.load_model(str(root / "target"), device="cpu")
            + tio.load_model(str(root / "draft"), device="cpu"))


def _torch(models, draft=True, **kw):
    tcfg, tparams, dcfg, dparams = models[1]
    if draft:
        kw.setdefault("draft_config", dcfg)
        kw.setdefault("draft_params", dparams)
    return tbatching.ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                              **kw)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_spec_lanes_match_plain_greedy_and_jax(models, mode):
    """More requests than lanes: the speculative engine's tokens equal
    the plain engine's and the JAX speculative engine's, and its
    acceptance counts equal JAX's, lane by lane."""
    reqs = [(p, 12) for p in PROMPTS]
    tcfg, tparams, dcfg, dparams = models[0]
    jeng = jbatching.ContinuousBatchingEngine(
        tcfg, tparams, lanes=2, max_len=96, kv_mode=mode, kv_block=8,
        draft_config=dcfg, draft_params=dparams, spec_k=3)
    want = jeng.run(reqs)
    plain = _torch(models, draft=False, lanes=2, max_len=96,
                   kv_mode=mode, kv_block=8).run(reqs)
    eng = _torch(models, lanes=2, max_len=96, kv_mode=mode, kv_block=8,
                 spec_k=3)
    got = eng.run(reqs)
    assert got == plain == want
    assert eng.stats.proposed > 0
    assert (eng.stats.proposed, eng.stats.accepted) == \
        (jeng.stats.proposed, jeng.stats.accepted)
    assert [(s.proposed, s.accepted) for s in eng.lane_stats] == \
        [(s.proposed, s.accepted) for s in jeng.lane_stats]
    assert eng.tick_launches["graph"] == 0 < eng.tick_launches["eager"]


def test_self_draft_accepts_everything(models):
    tcfg, tparams, _, _ = models[1]
    reqs = [(p, 10) for p in PROMPTS[:3]]
    want = _torch(models, draft=False, lanes=2, max_len=96).run(reqs)
    eng = _torch(models, draft=False, lanes=2, max_len=96,
                 draft_config=tcfg, draft_params=tparams, spec_k=2)
    assert eng.run(reqs) == want
    assert eng.stats.proposed > 0
    assert eng.stats.accepted == eng.stats.proposed


def test_eos_mid_chunk_and_the_cache_cap(models):
    """eos inside a verify chunk truncates as the plain engine does, and
    near the cap the rounds shrink, then fall back to plain ticks that
    keep the draft cache in lockstep."""
    base = _torch(models, draft=False, lanes=1, max_len=96).run(
        [([5, 7, 11], 12)])[0]
    gen = GenerateConfig(max_len=96, eos_id=base[4])
    want = _torch(models, draft=False, lanes=1, max_len=96, gen=gen).run(
        [([5, 7, 11], 12)])
    assert _torch(models, lanes=2, max_len=96, gen=gen, spec_k=3).run(
        [([5, 7, 11], 12)]) == want
    want24 = _torch(models, draft=False, lanes=1, max_len=24).run(
        [([5, 7, 11], 20)])
    assert _torch(models, lanes=1, max_len=24, spec_k=4).run(
        [([5, 7, 11], 20)]) == want24


def test_sampled_spec_lanes_finish_and_repeat_for_a_seed(models):
    def run_once():
        eng = _torch(models, lanes=2, max_len=96, spec_k=2, seed=42)
        reqs = [eng.submit(p, 10, temperature=0.9, top_k=20)
                for p in PROMPTS[:4]]
        eng.run([])
        return [r.result() for r in reqs]

    a, b = run_once(), run_once()
    assert a == b
    assert all(len(t) == 10 for t in a)
    assert all(0 <= t < 128 for toks in a for t in toks)


def test_spec_logprobs_and_refusals(models):
    plain = _torch(models, draft=False, lanes=1, max_len=96)
    p_req = plain.submit([5, 7, 11], 8, logprobs=True)
    plain.run([])
    eng = _torch(models, lanes=2, max_len=96, spec_k=3)
    req = eng.submit([5, 7, 11], 8, logprobs=True)
    eng.run([])
    assert req.result() == p_req.result()
    assert len(req.logprobs) == 8
    for a, b in zip(req.logprobs, p_req.logprobs):
        assert abs(a - b) < 1e-4
    tcfg, _, dcfg, _ = models[1]
    with pytest.raises(ValueError, match="vocabulary"):
        _torch(models, lanes=2, max_len=64, spec_k=2,
               draft_config=dataclasses.replace(dcfg, vocab_size=64))
    with pytest.raises(ValueError, match="mutually exclusive"):
        _torch(models, lanes=2, max_len=64, spec_k=2, prefill_lanes=1)
