"""The port's standalone speculative engine and its serving adapter,
held against the JAX package's on the CPU: the cases of
``tests/test_speculative.py`` and ``tests/test_spec_sampling.py`` run on
both packages at their tiny float32 sizes (a 2-layer target and a
1-layer draft over a 128-token vocabulary). The weights are JAX-made and
cross over as artifacts (``models/io.py``).

Greedy tokens are held equal to JAX's and to the target's own greedy
decode. The sampled path draws on the host with
``np.random.default_rng(seed)`` over ``filtered_probs`` and
``spec_accept`` in both packages, so for the seed below its tokens equal
JAX's too (float32 logits agree to ~1e-6, and no draw of that run lies
that close to a cumulative boundary).
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.serving import speculative as jspec
from kubedl_tpu.serving.engine import GenerateConfig as JGen
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.serving import speculative as tspec
from kubedl_tpu_torch.serving.engine import GenerateConfig, InferenceEngine

PROMPTS = ([5, 7, 11], [3], [2, 4, 6, 8, 10, 12])
#: the sampled run's seed and filter (``test_spec_sampling.py``'s)
SEED = 7
SAMPLED = dict(max_len=128, temperature=1.0, top_p=0.9)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """((JAX target, params, draft, params), (the port's four)), and a
    vocab-320 target for the byte tokenizer of the HTTP cases."""
    root = tmp_path_factory.mktemp("speculative")
    tcfg = dataclasses.replace(jllama.tiny(vocab=128), dtype=jnp.float32)
    dcfg = dataclasses.replace(jllama.tiny(vocab=128), d_model=64,
                               n_layers=1, n_heads=2, n_kv_heads=2,
                               d_ff=128, dtype=jnp.float32)
    hcfg = dataclasses.replace(jllama.tiny(vocab=320, seq=128),
                               dtype=jnp.float32)
    jax_side = {}
    for name, cfg, seed in (("target", tcfg, 0), ("draft", dcfg, 1),
                            ("http", hcfg, 21)):
        params = jllama.init_params(cfg, jax.random.PRNGKey(seed))
        jio.save_model(cfg, params, str(root / name))
        jax_side[name] = (cfg, params)
    port = {name: tio.load_model(str(root / name), device="cpu")
            for name in jax_side}
    return jax_side, port


def _spec(models, draft="draft", **kw):
    (tcfg, tparams), (dcfg, dparams) = (models[1]["target"],
                                        models[1][draft])
    return tspec.SpeculativeEngine(tcfg, tparams, dcfg, dparams,
                                   device="cpu", **kw)


def _jspec(models, **kw):
    (tcfg, tparams), (dcfg, dparams) = (models[0]["target"],
                                        models[0]["draft"])
    return jspec.SpeculativeEngine(tcfg, tparams, dcfg, dparams, **kw)


def _plain_greedy(models, prompt, n, gen=None, name="target"):
    cfg, params = models[1][name]
    eng = InferenceEngine(cfg, params, gen or GenerateConfig(max_len=128),
                          device="cpu")
    return eng.generate([prompt], n)[0]


def test_output_identical_to_plain_greedy_and_jax(models):
    """Speculative greedy equals the target's own greedy decode token for
    token, and the JAX engine's tokens and acceptance counts."""
    spec, jeng = _spec(models, k=4, max_len=128), _jspec(models, k=4,
                                                         max_len=128)
    for prompt in PROMPTS:
        stats, jstats = tspec.SpecStats(), jspec.SpecStats()
        got = spec.generate(prompt, 12, stats=stats)
        assert got == _plain_greedy(models, prompt, 12), prompt
        assert got == jeng.generate(prompt, 12, stats=jstats), prompt
        assert (stats.proposed, stats.accepted) == \
            (jstats.proposed, jstats.accepted)


def test_self_draft_accepts_everything(models):
    spec = _spec(models, draft="target", k=3, max_len=128)
    stats = tspec.SpecStats()
    got = spec.generate([5, 7, 11], 10, stats=stats)
    assert got == _plain_greedy(models, [5, 7, 11], 10)
    assert stats.proposed > 0
    assert stats.acceptance_rate == 1.0


def test_stats_and_vocab_guard(models):
    stats = tspec.SpecStats()
    spec = _spec(models, k=4, max_len=128)
    spec.generate([9, 1], 8, stats=stats)
    assert 0.0 <= stats.acceptance_rate <= 1.0
    assert stats.proposed > 0
    tcfg, tparams = models[1]["target"]
    dcfg, dparams = models[1]["draft"]
    bad = dataclasses.replace(dcfg, vocab_size=64)
    with pytest.raises(ValueError, match="share a vocabulary"):
        tspec.SpeculativeEngine(tcfg, tparams, bad, dparams, device="cpu")


def test_int8_draft(models):
    """An int8 draft (the port's ``maybe_quantize``) changes only the
    proposals: the output is still the target's greedy decode."""
    spec = _spec(models, k=4, max_len=128, quantize_draft="int8")
    assert type(spec.dp["layers"]["wq"]).__name__ != "Tensor"
    assert spec.generate([5, 7, 11], 8) == \
        _plain_greedy(models, [5, 7, 11], 8)


def test_capacity_guard(models):
    spec = _spec(models, max_len=32)
    with pytest.raises(ValueError, match="cache capacity 32"):
        spec.generate([1] * 30, 8)


def test_near_capacity_the_tail_is_plain_target_steps(models):
    """With the verify chunk past the cap the rounds stop and single
    target steps finish the budget, as in JAX."""
    spec = _spec(models, k=4, max_len=24)
    assert spec.generate([5, 7, 11], 20) == _plain_greedy(
        models, [5, 7, 11], 20, gen=GenerateConfig(max_len=24))


def test_stop_sequences_match_static_engine(models):
    """eos and multi-token stop sequences cut the speculative output
    where the static engine's ``hit_stop`` cuts greedy decoding."""
    spec = _spec(models, k=4, max_len=128)
    prompt = [5, 7, 11]
    plain = _plain_greedy(models, prompt, 16)
    anchor = len(plain) // 2
    gen = GenerateConfig(max_len=128, eos_id=plain[anchor])
    want = _plain_greedy(models, prompt, 16, gen=gen)
    got = spec.generate(prompt, 16, gen=gen)
    assert got == want
    assert len(got) <= anchor + 1
    stop = tuple(plain[anchor - 1:anchor + 1])
    gen2 = GenerateConfig(max_len=128, stop_sequences=(stop,))
    assert spec.generate(prompt, 16, gen=gen2) == \
        _plain_greedy(models, prompt, 16, gen=gen2)


def test_no_gen_config_is_unchanged(models):
    spec = _spec(models, k=3, max_len=128)
    assert len(spec.generate([1, 2], 9)) == 9


def test_a_failure_mid_generate_resets_the_caches(models):
    """An exception inside a step leaves fresh caches behind, and the
    next call decodes as before."""
    spec = _spec(models, k=3, max_len=128)
    want = spec.generate([5, 7, 11], 8)
    real = spec._step
    calls = []

    def planted(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("planted step fault")
        return real(*a, **kw)
    spec._step = planted
    with pytest.raises(RuntimeError, match="planted"):
        spec.generate([5, 7, 11], 8)
    spec._step = real
    assert not spec._t_cache["k"].any() and not spec._d_cache["k"].any()
    assert spec.generate([5, 7, 11], 8) == want


def test_sampled_tokens_equal_jax_for_a_seed(models):
    """Speculative sampling draws as the JAX engine does: the same host
    generator over the same filtered probabilities gives the same tokens
    for a seed; the greedy path and eos behave as in JAX."""
    spec = _spec(models, k=3, max_len=128)
    jeng = _jspec(models, k=3, max_len=128)
    gen = GenerateConfig(**SAMPLED)
    a = spec.generate([5, 7, 11], 12, gen=gen, seed=SEED)
    assert a == spec.generate([5, 7, 11], 12, gen=gen, seed=SEED)
    assert a == jeng.generate([5, 7, 11], 12, gen=JGen(**SAMPLED),
                              seed=SEED)
    c = spec.generate([5, 7, 11], 12, gen=gen, seed=SEED + 1)
    assert len(a) == 12 and all(0 <= t < 128 for t in a)
    assert a != c or len(set(a)) == 1
    assert spec.generate([5, 7, 11], 12, gen=GenerateConfig(max_len=128)) \
        == _plain_greedy(models, [5, 7, 11], 12)
    gen_eos = GenerateConfig(**SAMPLED, eos_id=a[2])
    assert spec.generate([5, 7, 11], 12, gen=gen_eos, seed=SEED) == a[:3]


def _post(url, path, body):
    req = urllib.request.Request(
        url + path, method="POST", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read().decode())


def test_the_adapter_behind_the_server(models):
    """Through ``InferenceServer``: ``:predict`` gives the target's greedy
    tokens, ``/metrics`` carries the spec gauges (a self-draft accepts
    everything; the adapter has no lanes), and ``/v1/embeddings`` runs on
    the target's weights: the static engine's vectors."""
    from kubedl_tpu_torch.serving.server import InferenceServer, ServerConfig
    from kubedl_tpu_torch.tokenizer import ByteTokenizer
    cfg, params = models[1]["http"]
    adapter = tspec.SpeculativeServingAdapter(
        tspec.SpeculativeEngine(cfg, params, cfg, params, k=2, max_len=96,
                                device="cpu"),
        gen=GenerateConfig(max_len=96))
    assert adapter.config is adapter.engine.tc
    assert adapter.params is adapter.engine.tp
    with pytest.raises(ValueError, match="logprobs are not available"):
        adapter.generate([[3, 5]], 4, return_logprobs=True)
    vectors = {}
    for name, eng in (("spec", adapter),
                      ("static", InferenceEngine(
                          cfg, params, GenerateConfig(max_len=96),
                          device="cpu"))):
        srv = InferenceServer(eng, ServerConfig(
            model_name="m", host="127.0.0.1", port=0,
            tokenizer=ByteTokenizer())).start()
        try:
            preds = _post(srv.url, "/v1/models/m:predict", {"instances": [
                {"prompt_tokens": [3, 5], "max_tokens": 8}]})
            emb = _post(srv.url, "/v1/embeddings",
                        {"input": ["the quick brown fox", "jumps"]})
            page = urllib.request.urlopen(srv.url + "/metrics").read() \
                .decode()
        finally:
            srv.stop()
        vectors[name] = np.asarray([d["embedding"] for d in emb["data"]])
        tokens = preds["predictions"][0]["tokens"]
        assert tokens == _plain_greedy(models, [3, 5], 8,
                                       gen=GenerateConfig(max_len=96),
                                       name="http")
        if name == "spec":
            assert "kubedl_serving_spec_proposed_total" in page
            assert "kubedl_serving_spec_acceptance_rate 1.0" in page
            assert "kubedl_serving_spec_lane_acceptance_rate" not in page
        else:
            assert "kubedl_serving_spec" not in page
    adapter.stop()
    np.testing.assert_array_equal(vectors["spec"], vectors["static"])


def test_run_batch_over_an_adapter(models, tmp_path):
    """The predictor's batch mode over an engine without ``submit``:
    buffered ``generate``, each row cut to its own cap (JAX's branch)."""
    from kubedl_tpu_torch.serving.__main__ import run_batch
    rows = [{"prompt": [5, 7, 11], "max_tokens": 6},
            {"prompt": [3], "max_tokens": 3},
            {"prompt": [9, 2, 4], "max_tokens": 9}]
    src, dst = tmp_path / "in.jsonl", tmp_path / "out.jsonl"
    src.write_text("\n".join(json.dumps(r) for r in rows))
    adapter = tspec.SpeculativeServingAdapter(_spec(models, k=3,
                                                    max_len=128))
    assert run_batch(adapter, None, str(src), str(dst)) == 0
    out = [json.loads(line) for line in dst.read_text().splitlines()]
    assert [o["prompt"] for o in out] == [r["prompt"] for r in rows]
    for o, r in zip(out, rows):
        assert o["tokens"] == _plain_greedy(models, r["prompt"],
                                            r["max_tokens"])
    assert adapter.stats.proposed > 0
