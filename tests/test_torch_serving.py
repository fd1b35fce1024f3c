"""The PyTorch port's serving engine and predictor server held against
the JAX package on the CPU, on one JAX-made artifact (``save_model`` →
the port's ``load_model``)."""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.serving import engine as jengine
from kubedl_tpu.serving.server import InferenceServer as JServer
from kubedl_tpu.serving.server import ServerConfig as JServerConfig
from kubedl_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.serving import engine as tengine
from kubedl_tpu_torch.serving.server import InferenceServer, ServerConfig
from kubedl_tpu_torch.tokenizer import ByteTokenizer

#: embeddings are unit vectors from f32 hidden states: the two sides sum
#: in other orders, ~1e-6 apart
EMBED_ATOL = 1e-4


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = dataclasses.replace(jllama.tiny(vocab=320, seq=128),
                              dtype=jnp.float32)
    params = jllama.init_params(cfg, jax.random.PRNGKey(21))
    path = str(tmp_path_factory.mktemp("serve"))
    jio.save_model(cfg, params, path)
    return cfg, params, path


@pytest.fixture(scope="module")
def server(artifact):
    _, _, path = artifact
    cfg, params = tio.load_model(path, device="cpu")
    eng = tengine.InferenceEngine(cfg, params,
                                  tengine.GenerateConfig(max_len=64),
                                  device="cpu")
    srv = InferenceServer(eng, ServerConfig(
        model_name="m", host="127.0.0.1", port=0,
        tokenizer=ByteTokenizer())).start()
    yield srv
    srv.stop()


def _post(url, path, body):
    req = urllib.request.Request(
        url + path, method="POST", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read().decode()


def _ragged_prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(3, 320, n).tolist() for n in (9, 4, 13)]


def test_generate_greedy_ragged_batch_matches_jax(artifact):
    cfg, params, path = artifact
    prompts = _ragged_prompts()
    jeng = jengine.InferenceEngine(cfg, params,
                                   jengine.GenerateConfig(max_len=64))
    want = jeng.generate(prompts, 8)
    tcfg, tparams = tio.load_model(path, device="cpu")
    teng = tengine.InferenceEngine(tcfg, tparams,
                                   tengine.GenerateConfig(max_len=64),
                                   device="cpu")
    assert teng.generate(prompts, 8) == want
    # equal-length prompts: the engine and greedy_rollout agree
    same = np.random.default_rng(8).integers(3, 320, (2, 10))
    rolled = tengine.greedy_rollout(tcfg, teng.params, same, 6)
    assert rolled.tolist() == teng.generate(same.tolist(), 6)


def test_generate_stops_and_logprobs(artifact):
    _, _, path = artifact
    tcfg, tparams = tio.load_model(path, device="cpu")
    eng = tengine.InferenceEngine(tcfg, tparams,
                                  tengine.GenerateConfig(max_len=64),
                                  device="cpu")
    prompt = _ragged_prompts()[:1]
    full = eng.generate(prompt, 6)[0]
    eng.gen = tengine.GenerateConfig(max_len=64, eos_id=full[2])
    stopped, lps = eng.generate(prompt, 6, return_logprobs=True)[0]
    assert stopped == full[:full.index(full[2]) + 1]
    assert len(lps) == len(stopped) and all(lp <= 0 for lp in lps)


def test_generate_records_trace_spans(artifact):
    from kubedl_tpu_torch.trace import Tracer
    _, _, path = artifact
    tcfg, tparams = tio.load_model(path, device="cpu")
    tracer = Tracer(enabled=True)
    eng = tengine.InferenceEngine(tcfg, tparams,
                                  tengine.GenerateConfig(max_len=64),
                                  tracer=tracer, device="cpu")
    eng.generate(_ragged_prompts(), 3)
    spans = {s.name: s for s in tracer.spans()}
    assert set(spans) == {"inference.prefill", "inference.decode",
                          "inference.generate"}
    root = spans["inference.generate"]
    assert spans["inference.prefill"].parent_id == root.span_id
    assert root.attributes == {"batch": 3, "tokens": 9}


def test_filtered_probs_identical_to_jax():
    logits = np.random.default_rng(9).standard_normal(64).astype(np.float32)
    for temp, k, p in ((0.7, 0, 1.0), (1.0, 5, 1.0), (1.3, 0, 0.8),
                       (0.9, 10, 0.5)):
        np.testing.assert_array_equal(
            tengine.filtered_probs(logits, temp, k, p),
            jengine.filtered_probs(logits, temp, k, p))


def test_samplers_stay_inside_the_filtered_set():
    """Draws cannot match JAX's (different RNGs); every draw must land
    in the top-k/top-p set that filtered_probs keeps."""
    logits = torch.from_numpy(
        np.random.default_rng(10).standard_normal((4, 50)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    for temp, k, p in ((1.0, 5, 1.0), (0.8, 0, 0.6), (1.2, 8, 0.7)):
        keep = [set(np.flatnonzero(tengine.filtered_probs(row, temp, k, p)))
                for row in logits.numpy()]
        for _ in range(20):
            draws = tengine.sample_logits(logits, gen, temp, k, p)
            assert all(int(d) in s for d, s in zip(draws, keep))
            many = tengine.sample_logits_many(
                logits, gen, torch.full((4,), temp), torch.full((4,), k),
                torch.full((4,), p))
            assert all(int(d) in s for d, s in zip(many, keep))
    greedy = tengine.sample_logits(logits, gen, 0.0, 0)
    assert greedy.tolist() == logits.argmax(-1).tolist()


def test_predict_stream_completions_round_trip(server):
    prompts = _ragged_prompts()
    got = json.loads(_post(server.url, "/v1/models/m:predict", {
        "instances": [{"prompt_tokens": p, "max_tokens": 5}
                      for p in prompts]}))
    want = server.engine.generate(prompts, 5)
    assert [p["tokens"] for p in got["predictions"]] == want
    raw = _post(server.url, "/v1/models/m:predict", {
        "instances": [{"prompt_tokens": prompts[0], "max_tokens": 4}],
        "stream": True})
    events = [json.loads(line[len("data: "):])
              for line in raw.splitlines() if line.startswith("data: ")]
    assert [e["token"] for e in events[:-1]] == want[0][:4]
    assert events[-1]["done"] and events[-1]["tokens"] == want[0][:4]
    cmpl = json.loads(_post(server.url, "/v1/completions",
                            {"prompt": "hello", "max_tokens": 3}))
    assert cmpl["object"] == "text_completion"
    assert cmpl["usage"]["completion_tokens"] == 3
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server.url, "/v1/models/m:registerPrefix",
              {"prefix_tokens": [5, 6]})
    assert err.value.code == 400
    for path in ("/healthz", "/v1/models", "/v1/models/m", "/metrics"):
        with urllib.request.urlopen(server.url + path, timeout=30) as r:
            assert r.status == 200
    with urllib.request.urlopen(server.url + "/metrics", timeout=30) as r:
        assert b"kubedl_serving_generated_tokens_total" in r.read()


def test_embeddings_match_the_jax_server(server, artifact):
    cfg, params, _ = artifact
    body = {"input": ["the quick brown fox", "jumps"]}
    got = json.loads(_post(server.url, "/v1/embeddings", body))
    jeng = jengine.InferenceEngine(cfg, params,
                                   jengine.GenerateConfig(max_len=64))
    jsrv = JServer(jeng, JServerConfig(model_name="m", host="127.0.0.1",
                                       port=0, tokenizer=JByteTokenizer()))
    jsrv.start()   # stop() waits for the serving loop, so it must run
    try:
        want = jsrv.openai_embeddings(body)
    finally:
        jsrv.stop()
    for g, w in zip(got["data"], want["data"]):
        vec = np.asarray(g["embedding"])
        assert np.isfinite(vec).all()
        assert abs(np.linalg.norm(vec) - 1) < 1e-5
        np.testing.assert_allclose(vec, np.asarray(w["embedding"]),
                                   atol=EMBED_ATOL)
    assert got["usage"] == want["usage"]
