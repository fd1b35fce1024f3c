"""The MoE family served by the port, held against the JAX package on
the CPU on a JAX-made float32 ``moe.tiny``: the KV-cache steps (dense,
and paged through the restored ``inner_body`` seam), the static engine
on a left-padded batch, ``/v1/embeddings`` (padded to the JAX server's
128-token bucket, since pads take expert capacity there) and the
predictor's batch mode. Greedy tokens equal, log-probabilities within
1e-4. The continuous engine is held in ``test_torch_moe_batching.py``."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import moe as jmoe
from kubedl_tpu.serving import __main__ as jsmain
from kubedl_tpu.serving import engine as jengine
from kubedl_tpu.serving.server import InferenceServer as JServer
from kubedl_tpu.serving.server import ServerConfig as JServerConfig
from kubedl_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.models import moe as tmoe
from kubedl_tpu_torch.serving import __main__ as tsmain
from kubedl_tpu_torch.serving import engine as tengine
from kubedl_tpu_torch.serving.server import InferenceServer, ServerConfig
from kubedl_tpu_torch.tokenizer import ByteTokenizer

VOCAB = 128
#: float32 on both sides; the two frameworks sum in other orders
LOGITS_ATOL = 1e-4
LOGPROB_ATOL = 1e-4
#: embeddings are unit vectors from f32 hidden states
EMBED_ATOL = 1e-4


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(JAX config, JAX params, port config, port params, artifact dir)
    of a float32 ``moe.tiny`` (artifact ``<dir>/target``)."""
    root = tmp_path_factory.mktemp("moe_serve")
    jcfg = dataclasses.replace(jmoe.tiny(vocab=VOCAB, seq=128),
                               dtype=jnp.float32)
    params = jmoe.init_params(jcfg, jax.random.PRNGKey(5))
    jio.save_model(jcfg, params, str(root / "target"))
    tcfg, tparams = tio.load_model(str(root / "target"), device="cpu")
    return jcfg, params, tcfg, tparams, root


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_kv_steps_match_jax_with_left_padding(model, paged):
    """``forward_step`` and ``forward_step_paged`` (MoE's body through
    ``inner_body``) against the JAX package's, on a left-padded batch
    whose pads are masked by ``valid``: a prefill, then 4 decode steps;
    then a per-row-position step (the continuous engine's tick), whose
    token mask is gathered per row."""
    jcfg, params, tcfg, tparams, _ = model
    b, plen, max_len, blk = 3, 20, 32, 8
    toks = _tokens(7, (b, plen + 4))
    pad = np.array([0, 6, 13])
    for i, n in enumerate(pad):
        toks[i, :n] = 0
    valid = np.arange(max_len)[None, :] >= pad[:, None]
    tables = np.arange(1, 1 + b * (max_len // blk)).reshape(b, -1)[:, ::-1]
    tables = np.ascontiguousarray(tables)

    def jstep(cache, t, start, v=valid):
        if paged:
            return jmoe.forward_step_paged(jcfg, params, jnp.asarray(t),
                                           cache, jnp.asarray(tables), start,
                                           None if v is None
                                           else jnp.asarray(v))
        return jmoe.forward_step(jcfg, params, jnp.asarray(t), cache, start,
                                 None if v is None else jnp.asarray(v))

    def tstep(cache, t, start, v=valid):
        t = torch.from_numpy(t).long()
        v = None if v is None else torch.from_numpy(v)
        if paged:
            return tmoe.forward_step_paged(tcfg, tparams, t, cache,
                                           torch.from_numpy(tables), start, v)
        return tmoe.forward_step(tcfg, tparams, t, cache, start, v)

    if paged:
        n_blocks = 1 + tables.size
        jcache = jmoe.init_block_pool(jcfg, n_blocks, blk)
        tcache = tmoe.init_block_pool(tcfg, n_blocks, blk, device="cpu")
    else:
        jcache = jmoe.init_cache(jcfg, b, max_len)
        tcache = tmoe.init_cache(tcfg, b, max_len, device="cpu")
    with torch.no_grad():
        jl, jcache = jstep(jcache, toks[:, :plen], 0)
        tl, tcache = tstep(tcache, toks[:, :plen], 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL)
        for p in range(plen, plen + 4):
            jl, jcache = jstep(jcache, toks[:, p:p + 1], p)
            tl, tcache = tstep(tcache, toks[:, p:p + 1], p)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=LOGITS_ATOL, err_msg=str(p))
        # per-row positions with the mask too: the pads' own K/V is
        # garbage that differs between the packages (a pad query masks
        # every key), so no step may attend to it unmasked
        pos = np.array([plen + 4, plen + 2, plen + 3])
        nxt = _tokens(8, (b, 1))
        jl, _ = jstep(jcache, nxt, jnp.asarray(pos))
        tl, _ = tstep(tcache, nxt, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL)


def _prompts(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB - 1, int(rng.integers(1, 20))).tolist()
            for _ in range(n)]


def test_static_engine_matches_jax(model):
    """A ragged batch, left-padded: the pads are masked out of the
    expert queues on both sides."""
    jcfg, params, tcfg, tparams, _ = model
    prompts = _prompts(seed=1, n=3)
    want = jengine.InferenceEngine(
        jcfg, params, jengine.GenerateConfig(max_len=64)).generate(
        prompts, 8, return_logprobs=True)
    got = tengine.InferenceEngine(
        tcfg, tparams, tengine.GenerateConfig(max_len=64),
        device="cpu").generate(prompts, 8, return_logprobs=True)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, atol=LOGPROB_ATOL)


def _embed_server(tcfg, tparams):
    eng = tengine.InferenceEngine(tcfg, tparams,
                                  tengine.GenerateConfig(max_len=64),
                                  device="cpu")
    return InferenceServer(eng, ServerConfig(
        model_name="m", host="127.0.0.1", port=0,
        tokenizer=ByteTokenizer()))


def test_embeddings_pad_to_the_jax_bucket(model):
    """``/v1/embeddings`` on an MoE model whose capacity drops tokens: the
    JAX server pads the batch to a 128-token bucket and its forward gets
    no token mask, so pads compete for expert slots. The port pads the
    same way and gives the JAX server's vectors; padding only to the
    longest input (the llama family's rule) would not."""
    jcfg, params, tcfg, tparams, _ = model
    jcfg = dataclasses.replace(jcfg, capacity_factor=1.0, max_seq_len=256)
    tcfg = dataclasses.replace(tcfg, capacity_factor=1.0, max_seq_len=256)
    body = {"input": ["the quick brown fox jumps over the lazy dog " * 2,
                      "jumps"]}
    srv = _embed_server(tcfg, tparams)
    got = srv.openai_embeddings(body)
    jeng = jengine.InferenceEngine(jcfg, params,
                                   jengine.GenerateConfig(max_len=64))
    jsrv = JServer(jeng, JServerConfig(model_name="m", host="127.0.0.1",
                                       port=0, tokenizer=JByteTokenizer()))
    jsrv.start()   # stop() waits for the serving loop, so it must run
    try:
        want = jsrv.openai_embeddings(body)
    finally:
        jsrv.stop()
    assert got["usage"] == want["usage"]
    for g, w in zip(got["data"], want["data"]):
        vec = np.asarray(g["embedding"])
        assert abs(np.linalg.norm(vec) - 1) < 1e-5
        np.testing.assert_allclose(vec, np.asarray(w["embedding"]),
                                   atol=EMBED_ATOL)
    # the fault the bucket reproduces: at the longest input's length
    # the capacity differs and no pads queue, so the vectors move
    from kubedl_tpu_torch.tokenizer import encode_prompt
    ids = [encode_prompt(ByteTokenizer(), t) for t in body["input"]]
    toks = np.zeros((2, max(map(len, ids))), np.int64)
    for i, r in enumerate(ids):
        toks[i, :len(r)] = r
    with torch.no_grad():
        x, _ = tmoe.forward_hidden(tcfg, tparams, torch.from_numpy(toks))
    longest = x[0].mean(0)           # row 0 is the longest: no pads
    longest = (longest / longest.norm()).numpy()
    assert np.abs(longest - np.asarray(want["data"][0]["embedding"])).max() \
        > 100 * EMBED_ATOL


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_predictor_batch_mode_serves_an_moe_artifact(model, tmp_path,
                                                     monkeypatch, quantize):
    """``python -m kubedl_tpu_torch.serving``'s batch mode on a JAX-made
    MoE artifact writes the JAX entry point's rows, with and without
    ``KUBEDL_SERVING_QUANTIZE=int8``."""
    root = model[4]
    rows = [{"prompt": [1 + i, 2, 3] * (1 + i % 3), "max_tokens": 3 + i}
            for i in range(5)]
    inp = tmp_path / "in.jsonl"
    inp.write_text("\n".join(json.dumps(r) for r in rows))
    monkeypatch.setenv("KUBEDL_MODEL_PATH", str(root / "target"))
    monkeypatch.setenv("KUBEDL_SERVING_LANES", "2")
    monkeypatch.setenv("KUBEDL_SERVING_MAX_LEN", "64")
    monkeypatch.setenv("KUBEDL_SERVING_QUANTIZE", quantize)
    monkeypatch.delenv("KUBEDL_TOKENIZER", raising=False)
    monkeypatch.delenv("KUBEDL_KV_MODE", raising=False)
    out_j, out_t = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    assert jsmain.main(["--batch-input", str(inp),
                        "--batch-output", str(out_j)]) == 0
    assert tsmain.main(["--batch-input", str(inp),
                        "--batch-output", str(out_t)], device="cpu") == 0
    got = [json.loads(ln) for ln in out_t.read_text().splitlines()]
    assert got == [json.loads(ln) for ln in out_j.read_text().splitlines()]
    assert [len(g["tokens"]) for g in got] == [r["max_tokens"] for r in rows]
