"""The continuous-batching engine serving the MoE family, held against
the JAX package's on the CPU on a JAX-made float32 ``moe.tiny``: paged
and dense KV, a registered prefix with preemption under a tiny pool
(parity asserted every step), prefill lanes, int8 expert stacks, and
speculative lanes with an MoE target and a llama draft. Greedy tokens
equal, log-probabilities within 1e-4, preemption, handoff and
acceptance counts equal."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models import moe as jmoe
from kubedl_tpu.serving import batching as jbatching
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.serving import batching as tbatching

VOCAB = 128
#: float32 on both sides; the two frameworks sum in other orders
LOGPROB_ATOL = 1e-4
PREFIX = list(range(1, 11))       # 10 tokens: 1 full block of 8 + a tail


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(JAX config, JAX params, port config, port params, artifact dir)
    of a float32 ``moe.tiny`` and a JAX-made 1-layer llama draft of the
    same vocabulary (artifact ``<dir>/draft``)."""
    root = tmp_path_factory.mktemp("moe_batching")
    jcfg = dataclasses.replace(jmoe.tiny(vocab=VOCAB, seq=128),
                               dtype=jnp.float32)
    params = jmoe.init_params(jcfg, jax.random.PRNGKey(5))
    jio.save_model(jcfg, params, str(root / "target"))
    dcfg = dataclasses.replace(jllama.tiny(vocab=VOCAB), d_model=64,
                               n_layers=1, n_heads=2, n_kv_heads=2,
                               d_ff=128, dtype=jnp.float32)
    jio.save_model(dcfg, jllama.init_params(dcfg, jax.random.PRNGKey(1)),
                   str(root / "draft"))
    tcfg, tparams = tio.load_model(str(root / "target"), device="cpu")
    return jcfg, params, tcfg, tparams, root


def _requests(seed=0, n=7, prefix_every=0, new=(2, 10)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(1, VOCAB - 1, int(rng.integers(1, 20))).tolist()
        if prefix_every and i % prefix_every == 0:
            prompt = PREFIX + prompt
        out.append((prompt, int(rng.integers(*new))))
    return out


def _drain(engine, reqs):
    rs = [engine.submit(p, n, logprobs=True) for p, n in reqs]
    engine.run([])
    return [r.result() for r in rs], [r.logprobs for r in rs]


def _check(got, want):
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=LOGPROB_ATOL)


#: the continuous engine's settings per case: the KV layouts, a
#: registered prefix with preemption under a tiny pool (parity asserted
#: every step), prefill lanes that hand off, and int8 weights
ENGINE_CASES = {
    "paged": dict(kv_mode="paged"),
    "dense": dict(kv_mode="dense"),
    "prefix_preempt": dict(kv_mode="parity", pool_blocks=12),
    "prefill_lanes": dict(kv_mode="paged", prefill_lanes=1),
    "int8": dict(kv_mode="paged", quantize="int8"),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_continuous_engine_matches_jax(model, case):
    jcfg, params, tcfg, tparams, _ = model
    kw = dict(lanes=3, max_len=64, kv_block=8, **ENGINE_CASES[case])
    reqs = _requests(seed=2, prefix_every=3 if case == "prefix_preempt"
                     else 0, new=(20, 34) if case == "prefix_preempt"
                     else (2, 10))
    jeng = jbatching.ContinuousBatchingEngine(jcfg, params, **kw)
    teng = tbatching.ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                              **kw)
    if case == "prefix_preempt":
        jeng.register_prefix(PREFIX)
        teng.register_prefix(PREFIX)
    _check(_drain(teng, reqs), _drain(jeng, reqs))
    assert teng.tick_launches["graph"] == 0 < teng.tick_launches["eager"]
    if case == "prefix_preempt":
        assert teng.preempted == jeng.preempted > 0
    if case == "prefill_lanes":
        assert teng.handoffs == jeng.handoffs > 0
    if case == "int8":
        from kubedl_tpu_torch.ops.quant import QTensor
        assert isinstance(teng.params["layers"]["w_up"], QTensor)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_speculative_lanes_with_an_moe_target_match_jax(model, mode):
    """A llama draft proposes, the MoE target verifies [lanes, k+1]
    chunks, its capacity counted on the chunk (so drops, and tokens, may
    differ from the plain engine's one-token ticks, never from JAX's):
    tokens and acceptance counts equal the JAX engine's."""
    jcfg, params, tcfg, tparams, root = model
    jd = jio.load_model(str(root / "draft"))
    td = tio.load_model(str(root / "draft"), device="cpu")
    reqs = [(p, 12) for p, _ in _requests(seed=3, n=5)]
    kw = dict(lanes=2, max_len=96, kv_mode=mode, kv_block=8)
    jeng = jbatching.ContinuousBatchingEngine(
        jcfg, params, draft_config=jd[0], draft_params=jd[1], spec_k=3,
        **kw)
    want = jeng.run(reqs)
    eng = tbatching.ContinuousBatchingEngine(
        tcfg, tparams, draft_config=td[0], draft_params=td[1], spec_k=3,
        device="cpu", **kw)
    assert eng.run(reqs) == want
    assert eng.stats.proposed > 0
    assert (eng.stats.proposed, eng.stats.accepted) == \
        (jeng.stats.proposed, jeng.stats.accepted)
