"""The port's serving auto-configurator (``serving/autoconfig.py``) held
against the JAX package's: the selection under the JAX tests' fake cost
model (``tests/test_autoconfig.py``) through both packages with equal
results, ``kv_cache_bytes`` equal for each family's tiny config, and
live probes on JAX-made tiny weights carried across by ``models/io.py``
(keys and positive numbers: timings cannot match), and the probe's repeat
loop on a patched clock, where the port measures a repeat again whose long
run is not longer than its short one and JAX clamps it (reference fault
7)."""

import dataclasses
import types

import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubedl_tpu.models import gemma as jgemma  # noqa: E402
from kubedl_tpu.models import io as jio  # noqa: E402
from kubedl_tpu.models import llama as jllama  # noqa: E402
from kubedl_tpu.models import moe as jmoe  # noqa: E402
from kubedl_tpu.serving import autoconfig as jauto  # noqa: E402
from kubedl_tpu.serving import batching as jbatching  # noqa: E402
from kubedl_tpu_torch.models import gemma as tgemma  # noqa: E402
from kubedl_tpu_torch.models import io as tio  # noqa: E402
from kubedl_tpu_torch.models import llama as tllama  # noqa: E402
from kubedl_tpu_torch.models import moe as tmoe  # noqa: E402
from kubedl_tpu_torch.serving import autoconfig as tauto  # noqa: E402
from kubedl_tpu_torch.serving import batching as tbatching  # noqa: E402

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


def _stub_engines(monkeypatch, cost):
    """Both packages' ``ContinuousBatchingEngine`` replaced by a stub that
    computes nothing and schedules as the engine does: ``submit`` queues,
    ``step`` admits every queued request (its first token) and then runs
    one tick for every live lane (one token each), returning False once
    idle; ``run`` submits and steps. Admitting and ticking move the clock
    that both probes' ``time.perf_counter`` read by ``cost(lanes, run,
    "admit" or "tick")`` seconds, ``run`` counting the engine's runs (a
    run begins at a submit to an idle engine). Returns the runs as
    ``[lanes, run, requests, new tokens]``."""
    now, runs = [0.0], []

    class Req:
        def __init__(self, max_new):
            self.max_new, self.tokens = max_new, []

        def result(self):
            return self.tokens

    class Stub:
        def __init__(self, cfg, params, lanes=1, **kw):
            self.lanes, self.run_no, self.queue, self.live = lanes, -1, [], []

        def submit(self, prompt, max_new):
            if not self.queue and not self.live:
                self.run_no += 1
                runs.append([self.lanes, self.run_no, 0, max_new])
            runs[-1][2] += 1
            self.queue.append(Req(max_new))
            return self.queue[-1]

        def step(self):
            if self.queue:
                now[0] += cost(self.lanes, self.run_no, "admit")
                for r in self.queue:
                    r.tokens.append(0)
                self.live += [r for r in self.queue if r.max_new > 1]
                self.queue = []
            if not self.live:
                return False
            now[0] += cost(self.lanes, self.run_no, "tick")
            for r in self.live:
                r.tokens.append(0)
            self.live = [r for r in self.live if len(r.tokens) < r.max_new]
            return True

        def run(self, requests):
            reqs = [self.submit(p, n) for p, n in requests]
            while self.step():
                pass
            return [r.result() for r in reqs]
    clock = types.SimpleNamespace(perf_counter=lambda: now[0])
    for mod in (jauto, tauto):
        monkeypatch.setattr(mod, "time", clock)
    for mod in (jbatching, tbatching):
        monkeypatch.setattr(mod, "ContinuousBatchingEngine", Stub)
    return runs


def _clock(zero_ticks=(), stalls=(), tick=1 / 128):
    """Every admission 1/4 s, every tick ``tick`` s; the runs in
    ``zero_ticks`` tick in no time, those in ``stalls`` admit 2 s late
    (runs 0-2 are the warm-ups and the TTFT run). Dyadic seconds, so the
    clock's sums and differences are exact."""
    def cost(lanes, run, what):
        if what == "tick":
            return 0.0 if run in zero_ticks else tick
        return 0.25 + (2.0 if run in stalls else 0.0)
    return cost


def _probe(mod, cand_kw, **kw):
    model = ((jllama if mod is jauto else tllama).tiny(), None)
    return mod.probe_candidate(model, mod.Candidate(**cand_kw),
                               new_tokens=16, **kw)


#: the clock both probes run on below: the fourth run ticks in no time,
#: the sixth admits 2 s late. JAX's timed runs are short, long in turn
#: (runs 3-8), the port's are long runs (3-5, and 6 for the repeat it
#: measures again)
CLOCK = dict(zero_ticks=(4,), stalls=(5,))


def test_reference_fault_7_jax_clamps_a_repeat_to_1e9_s(monkeypatch):
    """Reference fault 7: JAX's probe reads a repeat whose 16-token run
    took no longer than its 2-token run as a decode time of 1e-9 s, so the
    batch reads ``batch * (hi - lo) / 1e-9`` tokens/s whatever its valid
    repeats say (the port does not repeat it)."""
    runs = _stub_engines(monkeypatch, _clock(**CLOCK))
    probe = _probe(jauto, dict(batch=8))
    assert probe["decode_tokens_per_s"] == 8 * (16 - 2) / 1e-9
    assert len(runs) == 3 + 2 * 3
    assert [r[3] for r in runs[3:]] == [2, 16] * 3


def test_the_port_measures_a_bad_repeat_again(monkeypatch):
    """The same clock through the port: a repeat's short run is its long
    run up to every lane's second token, so the late admission falls
    before the difference; the run that ticks in no time is not longer
    than its short run (``<=``), is measured again and is no sample. The
    probe's numbers are JAX's formulas over the valid differences, here
    14 ticks of 1/128 s each."""
    runs = _stub_engines(monkeypatch, _clock(**CLOCK))
    probe = _probe(tauto, dict(batch=8))
    assert probe == {
        "batch": 8, "quantize": "", "speculative_k": 0, "kv_block": 0,
        "pool_blocks": 0, "decode_tokens_per_s": 8 * 128.0,
        "p50_latency_ms": round(1000 / 128, 3),
        "p99_latency_ms": round(1000 / 128, 3), "ttft_ms": 250.0}
    assert [r[1:] for r in runs[3:]] == [[3, 8, 16], [4, 8, 16],
                                         [5, 8, 16], [6, 8, 16]]


@pytest.mark.parametrize("dropped", [(), (4, 5, 6, 7)],
                         ids=["three_samples", "repeat_dropped"])
def test_the_probe_reads_over_the_valid_samples(monkeypatch, dropped):
    """A repeat that never comes good within ``1 + REMEASURES`` attempts
    gives no sample: p50 and p99 are over the others, here ticks of 1/128
    s in the first repeat and 1/64 s in the later ones."""
    assert len(dropped) in (0, 1 + tauto.REMEASURES)

    def cost(lanes, run, what):
        if what == "admit":
            return 0.25
        return 1 / 128 if run == 3 else 0.0 if run in dropped else 1 / 64
    runs = _stub_engines(monkeypatch, cost)
    probe = _probe(tauto, dict(batch=8))
    per_token = [1 / 128, 1 / 64] + ([] if dropped else [1 / 64])
    assert probe["decode_tokens_per_s"] == 8 * 128.0
    assert probe["p50_latency_ms"] == round(1000 * per_token[1], 3)
    assert probe["p99_latency_ms"] == round(1000 / 64, 3)
    assert len(runs) == 3 + 2 + max(len(dropped), 1)


def test_the_port_raises_when_no_repeat_is_valid(monkeypatch):
    """Every attempt of every repeat ticks in no time: the probe raises,
    naming the candidate and the readings, after ``1 + REMEASURES``
    attempts a repeat."""
    runs = _stub_engines(monkeypatch, _clock(zero_ticks=range(3, 100)))
    with pytest.raises(RuntimeError) as err:
        _probe(tauto, dict(batch=4, quantize="int8"), repeats=2)
    attempts = 2 * (1 + tauto.REMEASURES)
    assert "Candidate(batch=4, quantize='int8'" in str(err.value)
    assert f"in {attempts} attempts" in str(err.value)
    assert str([(0.25, 0.25)] * attempts) in str(err.value)
    assert len(runs) == 3 + attempts


def test_the_search_picks_what_the_valid_repeats_pick(monkeypatch):
    """Two candidates: one lane ticks in 1/128 s (128 tokens/s), eight in
    1/8 s (64 tokens/s); the eight lanes' first timed run admits 2 s late
    and ticks in no time. JAX's search reads it as a clamped repeat and
    picks eight lanes; the port's measures it again and picks one lane,
    as the valid repeats do."""
    def cost(lanes, run, what):
        bad = lanes == 8 and run == 3
        if what == "admit":
            return 0.25 + (2.0 if bad else 0.0)
        return 0.0 if bad else 1 / 128 if lanes == 1 else 1 / 8
    kw = dict(batches=(1, 8), quantize_opts=(None,), spec_ks=(0,),
              new_tokens=16)
    runs = _stub_engines(monkeypatch, cost)
    want = jauto.autoconfigure_multi((jllama.tiny(), None), **kw)
    assert want.best.batch == 8
    assert want.best_probe["decode_tokens_per_s"] == 8 * 14 / 1e-9
    del runs[:]
    got = tauto.autoconfigure_multi((tllama.tiny(), None), **kw)
    assert got.best.batch == 1
    assert [p["decode_tokens_per_s"] for p in got.measurements] == [
        128.0, 64.0]
    # one lane: 3 warm-up runs and 3 timed; eight: one attempt more
    assert [r[0] for r in runs] == [1] * 6 + [8] * 7


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
