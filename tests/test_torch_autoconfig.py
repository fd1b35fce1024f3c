"""The port's serving auto-configurator (``serving/autoconfig.py``) held
against the JAX package's: the selection under the JAX tests' fake cost
model (``tests/test_autoconfig.py``) through both packages with equal
results, ``kv_cache_bytes`` equal for each family's tiny config, and
live probes on JAX-made tiny weights carried across by ``models/io.py``
(keys and positive numbers: timings cannot match)."""

import dataclasses

import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubedl_tpu.models import gemma as jgemma  # noqa: E402
from kubedl_tpu.models import io as jio  # noqa: E402
from kubedl_tpu.models import llama as jllama  # noqa: E402
from kubedl_tpu.models import moe as jmoe  # noqa: E402
from kubedl_tpu.serving import autoconfig as jauto  # noqa: E402
from kubedl_tpu_torch.models import gemma as tgemma  # noqa: E402
from kubedl_tpu_torch.models import io as tio  # noqa: E402
from kubedl_tpu_torch.models import llama as tllama  # noqa: E402
from kubedl_tpu_torch.models import moe as tmoe  # noqa: E402
from kubedl_tpu_torch.serving import autoconfig as tauto  # noqa: E402

#: what a probe reports, by the JAX source's return statement
PROBE_KEYS = {"batch", "quantize", "speculative_k", "kv_block",
              "pool_blocks", "decode_tokens_per_s", "p50_latency_ms",
              "p99_latency_ms", "ttft_ms"}


def fake_measure(cand):
    """The JAX tests' deterministic cost model: int8 halves per-token
    latency, speculative amortizes target passes, bigger batches raise
    throughput and latency."""
    lat = 10.0
    if cand.quantize == "int8":
        lat *= 0.55
    if cand.speculative_k > 0:
        lat *= 0.5
    lat *= 1.0 + 0.15 * (cand.batch - 1)
    tps = cand.batch * 1000.0 / lat
    return {"batch": cand.batch, "quantize": cand.quantize or "",
            "speculative_k": cand.speculative_k,
            "decode_tokens_per_s": round(tps, 2),
            "p50_latency_ms": lat, "p99_latency_ms": lat * 1.1,
            "ttft_ms": 30.0 + 5.0 * cand.batch}


def _both(slo_kw, **kw):
    """The same search in both packages, each with its own candidates and
    SLO, measured by the same cost model."""
    want = jauto.autoconfigure_multi(
        measure=fake_measure, slo=jauto.ServingSLO(**slo_kw), **kw)
    got = tauto.autoconfigure_multi(
        measure=fake_measure, slo=tauto.ServingSLO(**slo_kw), **kw)
    assert got.to_dict() == want.to_dict()
    assert got.to_env() == want.to_env()
    assert dataclasses.asdict(got.best) == dataclasses.asdict(want.best)
    assert got.measurements == want.measurements
    return got


def test_latency_bound_slo_picks_int8_speculative():
    res = _both(dict(p99_latency_ms=4.0, ttft_ms=100.0),
                batches=(1, 2, 4), spec_ks=(0, 4))
    assert res.best.quantize == "int8" and res.best.speculative_k == 4
    assert res.best_probe["p99_latency_ms"] <= 4.0


def test_quality_pinned_slo_excludes_int8():
    res = _both(dict(p99_latency_ms=20.0, pinned_quality=True),
                batches=(1, 2, 4), spec_ks=(0, 4))
    assert res.best.quantize is None
    assert all(p["quantize"] == "" for p in res.measurements)


def test_nothing_feasible_returns_least_violating():
    res = _both(dict(p99_latency_ms=0.001), batches=(1, 2), spec_ks=(0, 4))
    assert res.best.quantize == "int8" and res.best.speculative_k == 4


@pytest.mark.parametrize("slo_kw", [{}, dict(ttft_ms=45.0),
                                    dict(p99_latency_ms=8.0, ttft_ms=60.0)])
def test_the_search_and_its_early_stop_match(slo_kw):
    """Wider spaces: four batches, int4 and two block sizes, where the
    family's early stop and the fallback decide."""
    _both(slo_kw, batches=(1, 2, 4, 8), quantize_opts=(None, "int8", "int4"),
          spec_ks=(0, 2, 4), kv_blocks=(0, 32))


def test_env_contract_roundtrip():
    kw = dict(batch=4, quantize="int8", speculative_k=2, kv_block=32,
              pool_blocks=64)
    env = tauto.Candidate(**kw).to_env()
    assert env == jauto.Candidate(**kw).to_env() == {
        "KUBEDL_SERVING_LANES": "4", "KUBEDL_SERVING_QUANTIZE": "int8",
        "KUBEDL_SERVING_SPEC_K": "2", "KUBEDL_SERVING_KV_BLOCK": "32",
        "KUBEDL_SERVING_POOL_BLOCKS": "64"}


def test_the_env_reaches_the_predictors_engine_settings():
    from kubedl_tpu_torch.serving.__main__ import engine_settings
    env = tauto.Candidate(batch=8, quantize="int4", speculative_k=3,
                          kv_block=16, pool_blocks=40).to_env()
    got = engine_settings(env)
    assert {k: got[k] for k in ("lanes", "quantize", "spec_k", "kv_block",
                                "pool_blocks")} == {
        "lanes": 8, "quantize": "int4", "spec_k": 3, "kv_block": 16,
        "pool_blocks": 40}
    assert engine_settings({})["lanes"] == 4


FAMILIES = {"llama": (jllama, tllama), "gemma": (jgemma, tgemma),
            "moe": (jmoe, tmoe)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kv_block", [0, 16, 64])
@pytest.mark.parametrize("pool_blocks", [0, 24])
def test_kv_cache_bytes_match(family, kv_block, pool_blocks):
    jmod, tmod = FAMILIES[family]
    for batch, max_len in ((1, 88), (8, 1024), (3, 200)):
        kw = dict(batch=batch, kv_block=kv_block, pool_blocks=pool_blocks)
        got = tauto.kv_cache_bytes(tmod.tiny(), tauto.Candidate(**kw),
                                   max_len)
        want = jauto.kv_cache_bytes(jmod.tiny(), jauto.Candidate(**kw),
                                    max_len)
        assert got == want > 0


def test_the_budget_needs_a_model():
    for mod in (jauto, tauto):
        with pytest.raises(ValueError, match="hbm_budget_bytes needs"):
            mod.autoconfigure_multi(measure=fake_measure,
                                    hbm_budget_bytes=1 << 30)


def test_the_budget_prunes_as_jax_does():
    """The same pruning before any probe: only candidates whose pool fits
    are measured."""
    jm, tm = (jllama.tiny(), None), (tllama.tiny(), None)
    budget = tauto.kv_cache_bytes(tm[0], tauto.Candidate(batch=2), 88)
    want = jauto.autoconfigure_multi(model=jm, measure=fake_measure,
                                     batches=(1, 2, 4, 8),
                                     hbm_budget_bytes=budget)
    got = tauto.autoconfigure_multi(model=tm, measure=fake_measure,
                                    batches=(1, 2, 4, 8),
                                    hbm_budget_bytes=budget)
    assert got.to_dict() == want.to_dict()
    assert {p["batch"] for p in got.measurements} == {1, 2}


@pytest.fixture(scope="module")
def tiny_models(tmp_path_factory):
    """The JAX tests' target and draft (float32 tiny llama), made by JAX
    and carried across by the artifact format."""
    tcfg = dataclasses.replace(jllama.tiny(vocab=128), dtype=jnp.float32)
    dcfg = dataclasses.replace(jllama.tiny(vocab=128), d_model=64,
                               n_layers=1, n_heads=2, n_kv_heads=2,
                               d_ff=128, dtype=jnp.float32)
    out = []
    for i, cfg in enumerate((tcfg, dcfg)):
        path = str(tmp_path_factory.mktemp(f"auto{i}"))
        jio.save_model(cfg, jllama.init_params(cfg, jax.random.PRNGKey(i)),
                       path)
        out.append(tio.load_model(path, device="cpu"))
    return tuple(out)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cand", [
    dict(batch=2), dict(batch=1, quantize="int8"),
    dict(batch=1, speculative_k=2), dict(batch=2, speculative_k=2),
    dict(batch=2, kv_block=8, pool_blocks=12)],
    ids=["batch", "int8", "spec", "spec_lanes", "pool"])
def test_live_probe_each_dimension(tiny_models, cand):
    model, draft = tiny_models
    probe = tauto.probe_candidate(model, tauto.Candidate(**cand),
                                  prompt_len=8, new_tokens=4, draft=draft,
                                  repeats=2, device="cpu")
    assert set(probe) == PROBE_KEYS
    assert probe["batch"] == cand["batch"]
    assert probe["decode_tokens_per_s"] > 0 and probe["ttft_ms"] > 0
    assert probe["p99_latency_ms"] >= probe["p50_latency_ms"] > 0


def test_live_probe_refusals(tiny_models):
    model, _ = tiny_models
    assert tauto.probe_candidate(model, tauto.Candidate(speculative_k=2),
                                 prompt_len=8, new_tokens=4,
                                 device="cpu") is None
    with pytest.raises(ValueError, match="new_tokens >= 4"):
        tauto.probe_candidate(model, tauto.Candidate(), new_tokens=3,
                              device="cpu")


def test_live_search_over_the_cpu(tiny_models):
    """The default measure builds every engine on the named device."""
    model, draft = tiny_models
    res = tauto.autoconfigure_multi(
        model, draft, batches=(1, 2), quantize_opts=(None,),
        spec_ks=(0, 2), prompt_len=8, new_tokens=4,
        hbm_budget_bytes=1 << 30, device="cpu")
    assert len(res.measurements) >= 2
    assert res.best_probe in res.measurements
    assert all(set(p) == PROBE_KEYS for p in res.measurements)


def test_autoconfigure_on_the_static_engine(tiny_models):
    from kubedl_tpu_torch.serving import InferenceEngine, autoconfigure
    model, _ = tiny_models
    eng = InferenceEngine(*model, device="cpu")
    res = autoconfigure(eng, batch_candidates=(1, 2), prompt_len=8,
                        new_tokens=4, latency_slo_ms=1e9)
    assert res.best_batch in (1, 2)
    assert [m["batch"] for m in res.measurements] == [1, 2]
    assert all(m["decode_tokens_per_s"] > 0 for m in res.measurements)
    assert set(res.to_dict()) == {"bestBatch", "sloMs", "measurements"}
