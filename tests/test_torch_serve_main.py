"""The port's predictor entry point (``python -m kubedl_tpu_torch.serving``)
held against the JAX package's on the CPU: the offline batch mode writes
the same rows as the JAX ``run_batch`` on one JAX-made artifact, and the
HTTP server over the continuous-batching engine serves multi-instance
``:predict``, the token stream, ``:registerPrefix`` and the paged-KV and
speculative gauges on ``/metrics``. The entry point runs on the card
unless given ``device="cpu"``, as here; the subprocess and SIGTERM drain
run on the card in ``chip_smoke.py``."""

import dataclasses
import json
import os
import urllib.error
import urllib.request

import pytest

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.serving import __main__ as jmain
from kubedl_tpu.serving.engine import GenerateConfig as JGen
from kubedl_tpu.serving.engine import InferenceEngine as JEngine
from kubedl_tpu_torch.serving import __main__ as tmain
from kubedl_tpu_torch.serving.server import InferenceServer, ServerConfig


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_main")
    cfg = dataclasses.replace(jllama.tiny(vocab=128), dtype=jnp.float32)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    jio.save_model(cfg, params, str(root / "target"))
    dcfg = dataclasses.replace(jllama.tiny(vocab=128), d_model=64,
                               n_layers=1, n_heads=2, n_kv_heads=2,
                               d_ff=128, dtype=jnp.float32)
    jio.save_model(dcfg, jllama.init_params(dcfg, jax.random.PRNGKey(1)),
                   str(root / "draft"))
    return root, cfg, params


def _post(url, path, body):
    req = urllib.request.Request(
        url + path, method="POST", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read().decode()


def _scrape(url) -> str:
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        return r.read().decode()


def test_batch_mode_writes_the_jax_rows(artifacts, tmp_path, monkeypatch):
    root, _, _ = artifacts
    # the model's vocab (128) is below the byte tokenizer's: id prompts
    rows = [{"prompt": [1 + i, 2, 3] * (1 + i % 3), "max_tokens": 3 + i}
            for i in range(6)]
    inp = tmp_path / "in.jsonl"
    inp.write_text("\n".join(json.dumps(r) for r in rows))
    monkeypatch.setenv("KUBEDL_MODEL_PATH", str(root / "target"))
    monkeypatch.setenv("KUBEDL_SERVING_LANES", "2")
    monkeypatch.setenv("KUBEDL_SERVING_MAX_LEN", "64")
    monkeypatch.delenv("KUBEDL_TOKENIZER", raising=False)
    monkeypatch.delenv("KUBEDL_KV_MODE", raising=False)
    out_j, out_t = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    assert jmain.main(["--batch-input", str(inp),
                       "--batch-output", str(out_j)]) == 0
    assert tmain.main(["--batch-input", str(inp),
                       "--batch-output", str(out_t)], device="cpu") == 0
    got = [json.loads(ln) for ln in out_t.read_text().splitlines()]
    assert got == [json.loads(ln) for ln in out_j.read_text().splitlines()]
    assert [g["prompt"] for g in got] == [r["prompt"] for r in rows]
    assert [len(g["tokens"]) for g in got] == [r["max_tokens"] for r in rows]
    with pytest.raises(SystemExit):
        tmain.main(["--batch-input", str(inp)], device="cpu")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_batch_mode_writes_the_jax_rows(artifacts, tmp_path,
                                                  monkeypatch, mode):
    """``KUBEDL_SERVING_QUANTIZE``: both entry points quantize the same
    artifact and write the same rows; the port's engine holds quantized
    leaves loaded from the host."""
    root, _, _ = artifacts
    rows = [{"prompt": [3 + i, 1, 4] * (1 + i % 2), "max_tokens": 4 + i}
            for i in range(4)]
    inp = tmp_path / "in.jsonl"
    inp.write_text("\n".join(json.dumps(r) for r in rows))
    monkeypatch.setenv("KUBEDL_MODEL_PATH", str(root / "target"))
    monkeypatch.setenv("KUBEDL_SERVING_LANES", "2")
    monkeypatch.setenv("KUBEDL_SERVING_MAX_LEN", "64")
    monkeypatch.setenv("KUBEDL_SERVING_QUANTIZE", mode)
    monkeypatch.delenv("KUBEDL_TOKENIZER", raising=False)
    monkeypatch.delenv("KUBEDL_KV_MODE", raising=False)
    out_j, out_t = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    assert jmain.main(["--batch-input", str(inp),
                       "--batch-output", str(out_j)]) == 0
    assert tmain.main(["--batch-input", str(inp),
                       "--batch-output", str(out_t)], device="cpu") == 0
    assert out_t.read_text() == out_j.read_text()
    from kubedl_tpu_torch.ops import quant
    eng = tmain.build_engine(str(root / "target"), 2, mode, 0, max_len=64,
                             device="cpu")
    try:
        assert isinstance(eng.params["layers"]["w_up"],
                          quant.QTensor if mode == "int8" else quant.Q4Tensor)
    finally:
        eng.stop()


def test_server_over_the_continuous_engine(artifacts):
    root, cfg, params = artifacts
    eng = tmain.build_engine(str(root / "target"), lanes=2, quantize="",
                             spec_k=0, max_len=96, kv_block=8, device="cpu")
    srv = InferenceServer(eng, ServerConfig(
        model_name="m", host="127.0.0.1", port=0)).start()
    try:
        solo = JEngine(cfg, params, JGen(max_len=96))
        prompts = [[5, 9, 2], [3], [7, 7, 1, 4]]
        got = json.loads(_post(srv.url, "/v1/models/m:predict", {
            "instances": [{"prompt_tokens": p, "max_tokens": 6 - i}
                          for i, p in enumerate(prompts)]}))
        toks = [p["tokens"] for p in got["predictions"]]
        assert toks == [solo.generate([p], 6 - i)[0]
                        for i, p in enumerate(prompts)]
        raw = _post(srv.url, "/v1/models/m:predict", {
            "stream": True, "instances": [{"prompt_tokens": prompts[0],
                                           "max_tokens": 6}]})
        events = [json.loads(ln[6:]) for ln in raw.splitlines()
                  if ln.startswith("data: ")]
        assert [e["token"] for e in events[:-1]] == toks[0]
        assert events[-1] == {"done": True, "tokens": toks[0]}
        # a registered prefix serves matching prompts with the same tokens
        system = list(range(20, 40))
        assert json.loads(_post(srv.url, "/v1/models/m:registerPrefix", {
            "prefix_tokens": system})) == {"registered": 20}
        want = solo.generate([system + [5]], 5)[0]
        got = json.loads(_post(srv.url, "/v1/models/m:predict", {
            "instances": [{"prompt_tokens": system + [5],
                           "max_tokens": 5}]}))
        assert got["predictions"][0]["tokens"] == want
        # per-instance sampling rides its own lane
        hot = json.loads(_post(srv.url, "/v1/models/m:predict", {
            "instances": [{"prompt_tokens": [1, 2], "max_tokens": 4,
                           "temperature": 1.5, "top_k": 20}]}))
        assert len(hot["predictions"][0]["tokens"]) == 4
        for bad in ({"prompt_tokens": [1], "max_tokens": 4, "top_p": 0},
                    {"prompt_tokens": [1] * 95, "max_tokens": 4}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(srv.url, "/v1/models/m:predict", {"instances": [bad]})
            assert err.value.code == 400
        page = _scrape(srv.url)
        assert "kubedl_serving_kv_blocks_total 24.0" in page
        assert "kubedl_serving_kv_blocks_pinned 2.0" in page
        assert "kubedl_serving_peak_active_lanes 2.0" in page
        assert "kubedl_serving_spec_" not in page
    finally:
        srv.stop()
        eng.stop()


def test_speculative_predictor_reports_lane_acceptance(artifacts):
    root, cfg, params = artifacts
    eng = tmain.build_engine(str(root / "target"), lanes=2, quantize="",
                             spec_k=2, draft_path=str(root / "draft"),
                             max_len=96, device="cpu")
    srv = InferenceServer(eng, ServerConfig(
        model_name="m", host="127.0.0.1", port=0)).start()
    try:
        got = json.loads(_post(srv.url, "/v1/models/m:predict", {
            "instances": [{"prompt_tokens": [5, 9, 2], "max_tokens": 6}]}))
        solo = JEngine(cfg, params, JGen(max_len=96))
        assert got["predictions"][0]["tokens"] == \
            solo.generate([[5, 9, 2]], 6)[0]
        page = _scrape(srv.url)
        assert "kubedl_serving_spec_proposed_total" in page
        assert 'kubedl_serving_spec_lane_acceptance_rate{lane="0"}' in page
    finally:
        srv.stop()
        eng.stop()
    with pytest.raises(ValueError, match="DRAFT_PATH"):
        tmain.build_engine(str(root / "target"), 2, "", 2, device="cpu")


def test_startup_refusals(artifacts, monkeypatch):
    root, _, _ = artifacts
    path = str(root / "target")
    # the byte tokenizer's 259 ids do not fit a 128-token vocabulary
    with pytest.raises(ValueError, match="does not fit"):
        tmain.build_engine(path, 2, "", 0, tokenizer_vocab=259,
                           device="cpu")
    monkeypatch.setenv("KUBEDL_MODEL_PATH", path)
    monkeypatch.setenv("KUBEDL_TOKENIZER", "byte")
    with pytest.raises(ValueError, match="does not fit"):
        tmain.main([], device="cpu")
    # quantization is ported: an unknown mode is what it refuses
    with pytest.raises(ValueError, match="unknown quantize mode"):
        tmain.build_engine(path, 2, "int3", 0, device="cpu")
    # tensor-parallel serving is ported: more ranks than the host has
    # devices (on the CPU, cores) is refused in the JAX package's words
    many = (os.cpu_count() or 1) + 1
    with pytest.raises(ValueError, match=f"KUBEDL_SERVING_TP={many} but "
                       f"only {many - 1} local devices"):
        tmain.build_engine(path, 2, "", 0, tp=many, device="cpu")
    monkeypatch.delenv("KUBEDL_MODEL_PATH")
    assert tmain.main([], device="cpu") == 2
