"""Tensor-parallel serving across processes (``tp=2``), held against the
port on one process and against the JAX package's engines.

One 2-rank gloo group is spawned once for the file
(``parallel.launch.spawn``, each rank on one CPU thread). Every case runs
in it: the static engine SPMD on both ranks; the continuous engine with
rank 0 scheduling and rank 1 following its device steps
(``ContinuousBatchingEngine.follow``). The weights are JAX-made float32
and cross over as numpy. Models: ``llama.tiny(vocab=128)`` with 4 query
and 2 KV heads (one KV head for the MQA cases), a Llama tiny with 3
query heads over 1 KV head (``odd``: ``tp`` does not divide its heads,
so rank 0 computes 2 and rank 1 one), Gemma tiny and MoE tiny at vocab
128, a 1-layer draft, and a vocab-320 Llama tiny for the HTTP front (the
byte tokenizer's ids need it).

Tolerances: float32 sums in another order (the ``tp`` partial sums)
move the logits by ~1e-7 of their scale, so greedy tokens are held
equal and logits and embedding vectors within 1e-5.

The rank functions import nothing of JAX (the ranks import this module);
the JAX side runs in the test process only.
"""

import dataclasses
import json

import numpy as np
import pytest

from kubedl_tpu_torch.parallel import launch

WORLD = 2
VOCAB = 128
ATOL = 1e-5
REQS = [([5, 7, 11], 6), ([3], 4), ([9, 2, 4], 5)]
PREFIX = [7, 7, 7, 7]
PREFIXED = [([7, 7, 7, 7, 1], 5)]
LONG = [(list(range(3 + i, 16 + 2 * i)), 10 + i) for i in range(5)]
STATIC_PROMPTS = [[5, 7, 11], [3], [9, 2]]
EMBED_INPUT = ["the quick brown fox", "jumps"]
EMBED_TOKENS = [[5, 7, 11, 2, 9], [3, 9, 4, 0, 0]]
#: the configurations by name: (family, JAX-side overrides)
MODELS = {
    "llama": ("llama", dict(vocab=VOCAB), dict(n_heads=4, n_kv_heads=2)),
    "mqa": ("llama", dict(vocab=VOCAB), dict(n_heads=4, n_kv_heads=1)),
    "odd": ("llama", dict(vocab=VOCAB),
            dict(n_heads=3, n_kv_heads=1, head_dim=32)),
    "gemma": ("gemma", dict(vocab=VOCAB), {}),
    "moe": ("moe", dict(vocab=VOCAB), {}),
    "draft": ("llama", dict(vocab=VOCAB),
              dict(d_model=64, n_layers=1, d_ff=128)),
    "http": ("llama", dict(vocab=320, seq=128), {}),
}
SEEDS = {"llama": 0, "mqa": 1, "odd": 5, "gemma": 3, "moe": 4, "draft": 2,
         "http": 21}
#: the refused configurations: Llama tiny with these overrides
REFUSED = {"n_heads": dict(n_heads=3, n_kv_heads=1, head_dim=33),
           "d_ff": dict(d_ff=255), "vocab_size": dict(vocab_size=127)}
#: what each refusal names
REFUSED_DIM = {"n_heads": "n_heads * head_dim", "d_ff": "d_ff",
               "vocab_size": "vocab_size"}
#: (kv_mode, engine keywords) of the continuous-engine cases on llama
ENGINES = {
    "paged_prefix": dict(lanes=2, max_len=96),
    "dense_prefix": dict(lanes=2, max_len=96, kv_mode="dense"),
    "parity": dict(lanes=2, max_len=96, kv_mode="parity"),
    "preempt": dict(lanes=3, max_len=48, kv_block=4, pool_blocks=12),
    "handoff": dict(lanes=3, max_len=64, kv_block=8, prefill_lanes=1),
}


def _tcfg(name):
    from kubedl_tpu_torch.models import gemma, llama, moe
    family, make_kw, over = MODELS[name]
    make = {"llama": llama.tiny, "gemma": gemma.tiny, "moe": moe.tiny}[family]
    return dataclasses.replace(make(**make_kw), dtype="float32", **over)


def _tparams(name, models):
    from kubedl_tpu_torch.models import io
    return io.params_from_numpy(_tcfg(name), models[name], device="cpu")


def _np_tree(params) -> dict:
    return {k: ({n: t.numpy().copy() for n, t in v.items()}
                if isinstance(v, dict) else v.numpy().copy())
            for k, v in params.items()}


# -- the cases, run the same way on every rank (rank 0 reports) -----------

def _continuous(mesh, name, models, body, **kw):
    """``body(engine)`` on rank 0 of a continuous engine over ``mesh``;
    rank 1 follows it. Returns the body's result on rank 0."""
    from kubedl_tpu_torch.serving.batching import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(_tcfg(name), _tparams(name, models),
                                   mesh=mesh, device="cpu", **kw)
    if not eng._channel.leader:
        return {"followed": eng.follow()}
    try:
        return body(eng)
    finally:
        eng.stop()


def _logit_recorder(eng) -> list:
    """The logits of every target decode tick the engine runs."""
    seen = []
    for seam in ("_decode", "_decode_p"):
        real = getattr(eng, seam)

        def record(*a, _real=real):
            out = _real(*a)
            seen.append(out.float().numpy().copy())
            return out
        setattr(eng, seam, record)
    return seen


def _run_with_prefix(eng) -> dict:
    seen = _logit_recorder(eng)
    out = {"tokens": eng.run(REQS)}
    eng.register_prefix(PREFIX)
    out["prefixed"] = eng.run(PREFIXED)
    out["logits"] = seen
    out["prefill_tokens"] = eng.prefill_tokens_total
    out["tick_launches"] = eng.tick_launches
    return out


def _engine_cases(mesh, models) -> dict:
    out = {}
    for case, kw in ENGINES.items():
        def body(eng, case=case):
            if case.endswith("prefix") or case == "parity":
                return _run_with_prefix(eng)
            res = {"tokens": eng.run(LONG), "preempted": eng.preempted,
                   "handoffs": eng.handoffs}
            return res
        out[case] = _continuous(mesh, "llama", models, body, **kw)
    for name in ("mqa", "odd", "gemma", "moe"):
        out[name] = _continuous(mesh, name, models, _run_with_prefix,
                                lanes=2, max_len=96)

    def embed(eng):
        return {"hidden": eng.hidden_states(np.asarray(EMBED_TOKENS))
                .numpy().copy()}
    out["odd_embed"] = _continuous(mesh, "odd", models, embed, lanes=2,
                                   max_len=64)

    def spec(eng):
        return {"tokens": eng.run(REQS), "proposed": eng.stats.proposed,
                "accepted": eng.stats.accepted}
    out["spec"] = _continuous(mesh, "llama", models, spec, lanes=2,
                              max_len=64, draft_config=_tcfg("draft"),
                              draft_params=_tparams("draft", models),
                              spec_k=2)
    return out


def _http(mesh, models) -> dict:
    """``:predict`` and ``/v1/embeddings`` through ``InferenceServer`` on
    rank 0 over the started engine."""
    import urllib.request

    from kubedl_tpu_torch.serving.server import InferenceServer, ServerConfig
    from kubedl_tpu_torch.tokenizer import ByteTokenizer

    def post(url, path, body):
        req = urllib.request.Request(
            url + path, method="POST", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read().decode())

    def body(eng):
        eng.start()
        srv = InferenceServer(eng, ServerConfig(
            model_name="tp", host="127.0.0.1", port=0,
            tokenizer=ByteTokenizer())).start()
        try:
            preds = post(srv.url, "/v1/models/tp:predict", {"instances": [
                {"prompt_tokens": p, "max_tokens": n} for p, n in REQS]})
            emb = post(srv.url, "/v1/embeddings", {"input": EMBED_INPUT})
        finally:
            srv.stop()
        return {"tokens": [p["tokens"] for p in preds["predictions"]],
                "embeddings": [d["embedding"] for d in emb["data"]],
                "usage": emb["usage"]}
    return _continuous(mesh, "http", models, body, lanes=2, max_len=64)


def _refusals(mesh, models) -> dict:
    """What every rank refuses at construction, before any collective."""
    from kubedl_tpu_torch.serving.batching import ContinuousBatchingEngine
    from kubedl_tpu_torch.serving.engine import InferenceEngine
    cfg = _tcfg("llama")
    out = {}
    tries = {
        "quantize_continuous": lambda: ContinuousBatchingEngine(
            cfg, {}, mesh=mesh, quantize="int4", device="cpu"),
        "quantize_static": lambda: InferenceEngine(
            cfg, {}, mesh=mesh, quantize="int8", device="cpu"),
        "n_heads": lambda: ContinuousBatchingEngine(
            dataclasses.replace(cfg, **REFUSED["n_heads"]), {}, mesh=mesh,
            device="cpu"),
        "d_ff": lambda: ContinuousBatchingEngine(
            dataclasses.replace(cfg, **REFUSED["d_ff"]), {}, mesh=mesh,
            device="cpu"),
        "vocab_size": lambda: InferenceEngine(
            dataclasses.replace(cfg, **REFUSED["vocab_size"]), {},
            mesh=mesh, device="cpu"),
    }
    for name, make in tries.items():
        try:
            make()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _fault(mesh, models) -> dict:
    """Rank 1 fails in its fourth step and leaves the group (its sockets
    close, as a dying process's do); rank 0's run must end with an error,
    not hang."""
    import time

    import torch.distributed as dist

    from kubedl_tpu_torch.serving.batching import ContinuousBatchingEngine
    from kubedl_tpu_torch.serving.tp import TIMEOUT_S
    eng = ContinuousBatchingEngine(_tcfg("llama"), _tparams("llama", models),
                                   mesh=mesh, lanes=2, max_len=64,
                                   device="cpu")
    if not eng._channel.leader:
        real, calls = eng._run_op, []

        def planted(op, args):
            calls.append(op)
            if len(calls) == 4:
                raise RuntimeError("planted follower fault")
            return real(op, args)
        eng._run_op = planted
        try:
            eng.follow()
        except RuntimeError as e:
            dist.destroy_process_group()
            return {"raised": str(e)}
        return {"raised": None}
    t0 = time.monotonic()
    try:
        eng.run(LONG)
        err = None
    except Exception as e:  # noqa: BLE001 — the observation under test
        err = f"{type(e).__name__}: {e}"
    seconds = time.monotonic() - t0
    eng.stop()
    dist.destroy_process_group()
    return {"error": err, "seconds": seconds, "timeout": TIMEOUT_S}


def rank_main(models, leaves_in):
    """One rank: open the group from the env, build the serving mesh and
    run every case; rank 0 reports the cases, every rank its shards."""
    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.runtime import bootstrap
    from kubedl_tpu_torch.serving.engine import (GenerateConfig,
                                                 InferenceEngine,
                                                 shard_for_serving)

    bootstrap.initialize_distributed(device="cpu")
    mesh = tmesh.build_mesh(tmesh.MeshConfig(dp=1, fsdp=1, tp=WORLD),
                            device="cpu")
    out = {"rank": dist.get_rank(), "leaves": {}}
    for name in ("llama", "mqa", "odd"):
        params, cache = shard_for_serving(
            _tcfg(name), _tparams(name, models),
            {k: torch.from_numpy(v) for k, v in leaves_in[name].items()},
            mesh)
        fresh = llama.init_cache(_tcfg(name), 1, 4, device="cpu", mesh=mesh)
        out["leaves"][name] = {"params": _np_tree(params),
                               "cache": {k: v.numpy() for k, v in
                                         cache.items()},
                               "fresh_cache": tuple(fresh["k"].shape)}
    out["static"] = {
        name: InferenceEngine(_tcfg(name), _tparams(name, models),
                              GenerateConfig(max_len=64), mesh=mesh,
                              device="cpu").generate(STATIC_PROMPTS, 8)
        for name in ("llama", "mqa", "odd")}
    out["refusals"] = _refusals(mesh, models)
    out["engines"] = _engine_cases(mesh, models)
    out["http"] = _http(mesh, models)
    out["fault"] = _fault(mesh, models)
    if dist.is_initialized():
        dist.destroy_process_group()
    return out


# -- the test process: references and checks -------------------------------

def _jax_models() -> dict:
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.models import gemma as jgemma
    from kubedl_tpu.models import llama as jllama
    from kubedl_tpu.models import moe as jmoe
    out = {}
    for name, (family, make_kw, over) in MODELS.items():
        mod, make = {"llama": (jllama, jllama.tiny),
                     "gemma": (jllama, jgemma.tiny),
                     "moe": (jmoe, jmoe.tiny)}[family]
        cfg = dataclasses.replace(make(**make_kw), dtype=jnp.float32, **over)
        params = mod.init_params(cfg, jax.random.PRNGKey(SEEDS[name]))
        out[name] = (cfg, params)
    return out


def _caches(jmodels) -> dict:
    """A whole cache per KV layout test (distinct values per KV head)."""
    out = {}
    for name in ("llama", "mqa", "odd"):
        cfg = jmodels[name][0]
        shape = (cfg.n_layers, 1, 4, cfg.n_kv_heads, cfg.hd)
        base = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        out[name] = {"k": base, "v": -base}
    return out


def _jax_refs(jmodels, caches) -> dict:
    """The JAX package: ``shard_for_serving``'s shards on devices 0 and 1
    of the fake mesh, the static engine over that mesh, the unsharded
    continuous engine, and the server's embeddings."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.models import llama as jllama
    from kubedl_tpu.parallel.mesh import MeshConfig, build_mesh
    from kubedl_tpu.serving import engine as jengine
    from kubedl_tpu.serving.batching import ContinuousBatchingEngine
    from kubedl_tpu.serving.server import InferenceServer, ServerConfig
    from kubedl_tpu.tokenizer import ByteTokenizer
    devices = jax.devices()[:WORLD]     # device r is tp rank r
    mesh = build_mesh(MeshConfig(dp=1, fsdp=1, tp=WORLD), devices)
    out = {"shards": {}, "static": {}, "continuous": {}}
    for name in ("llama", "mqa", "odd"):
        cfg, params = jmodels[name]
        p, c = jengine.shard_for_serving(
            cfg, params, {k: jnp.asarray(v) for k, v in caches[name].items()},
            mesh)

        def by_device(x):
            return {devices.index(s.device): np.asarray(s.data)
                    for s in x.addressable_shards}
        out["shards"][name] = {
            "params": jax.tree.map(by_device, p),
            "whole": jax.tree.map(np.asarray, params),
            "cache": {k: by_device(v) for k, v in c.items()}}
        eng = jengine.InferenceEngine(cfg, params,
                                      jengine.GenerateConfig(max_len=64),
                                      mesh=mesh)
        out["static"][name] = eng.generate(STATIC_PROMPTS, 8)
    for name in ("llama", "mqa", "odd", "gemma", "moe"):
        cfg, params = jmodels[name]
        eng = ContinuousBatchingEngine(cfg, params, lanes=2, max_len=96)
        out["continuous"][name] = eng.run(REQS)
        eng.register_prefix(PREFIX)
        out["continuous"][name + "_prefixed"] = eng.run(PREFIXED)
    cfg, params = jmodels["odd"]
    out["odd_hidden"] = np.asarray(jllama.forward_hidden(
        cfg, params, jnp.asarray(EMBED_TOKENS)))
    # the refused splits: JAX's placement refuses them too
    out["refused"] = {}
    for name, over in REFUSED.items():
        rcfg = dataclasses.replace(jmodels["llama"][0], **over)
        try:
            jengine.shard_for_serving(
                rcfg, jllama.init_params(rcfg, jax.random.PRNGKey(0)), None,
                mesh)
            out["refused"][name] = None
        except ValueError as e:
            out["refused"][name] = str(e)
    cfg, params = jmodels["http"]
    jsrv = InferenceServer(
        jengine.InferenceEngine(cfg, params,
                                jengine.GenerateConfig(max_len=64)),
        ServerConfig(model_name="m", host="127.0.0.1", port=0,
                     tokenizer=ByteTokenizer())).start()
    try:
        out["embeddings"] = [d["embedding"] for d in jsrv.openai_embeddings(
            {"input": EMBED_INPUT})["data"]]
    finally:
        jsrv.stop()
    return out


def _one_process(models) -> dict:
    """The port on one process, no mesh: the same cases."""
    from kubedl_tpu_torch.serving.batching import ContinuousBatchingEngine
    from kubedl_tpu_torch.serving.engine import (GenerateConfig,
                                                 InferenceEngine)
    from kubedl_tpu_torch.serving.server import InferenceServer, ServerConfig
    from kubedl_tpu_torch.tokenizer import ByteTokenizer

    def engine(name, **kw):
        return ContinuousBatchingEngine(_tcfg(name), _tparams(name, models),
                                        device="cpu", **kw)
    out = {"static": {
        name: InferenceEngine(_tcfg(name), _tparams(name, models),
                              GenerateConfig(max_len=64),
                              device="cpu").generate(STATIC_PROMPTS, 8)
        for name in ("llama", "mqa", "odd")}}
    for case, kw in ENGINES.items():
        eng = engine("llama", **kw)
        if case.endswith("prefix") or case == "parity":
            out[case] = _run_with_prefix(eng)
        else:
            out[case] = {"tokens": eng.run(LONG)}
    for name in ("mqa", "odd", "gemma", "moe"):
        out[name] = _run_with_prefix(engine(name, lanes=2, max_len=96))
    out["odd_hidden"] = engine("odd", lanes=2, max_len=64).hidden_states(
        np.asarray(EMBED_TOKENS)).numpy()
    out["spec_plain"] = engine("llama", lanes=2, max_len=64).run(REQS)
    srv = InferenceServer(engine("http", lanes=2, max_len=64),
                          ServerConfig(model_name="m", host="127.0.0.1",
                                       port=0, tokenizer=ByteTokenizer()))
    out["embeddings"] = [d["embedding"] for d in srv.openai_embeddings(
        {"input": EMBED_INPUT})["data"]]
    out["http_tokens"] = engine("http", lanes=2, max_len=64).run(REQS)
    return out


@pytest.fixture(scope="module")
def runs():
    """(rank results, one-process results, JAX results). The JAX side
    compiles on a thread while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    jmodels = _jax_models()
    models = {name: jax.tree.map(lambda x: np.asarray(x, np.float32), p)
              for name, (_, p) in jmodels.items()}
    caches = _caches(jmodels)
    with ThreadPoolExecutor(max_workers=1) as pool:
        jax_ref = pool.submit(_jax_refs, jmodels, caches)
        ranks = launch.spawn(rank_main, WORLD, models, caches, timeout=240)
        single = _one_process(models)
        return ranks, single, jax_ref.result()


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) and not all(isinstance(i, int) for i in v):
            yield from _leaf_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("name", ["llama", "mqa"])
def test_each_rank_holds_the_jax_shards(runs, name):
    """Every leaf a rank holds equals the JAX ``shard_for_serving`` shard
    on the same device of the fake mesh, except K/V under MQA: one KV
    head cannot split over tp=2, and the port holds ``wk``/``wv`` whole
    where JAX splits a head's columns (GSPMD pads and gathers). The
    cache: split by KV head, or whole on every rank under MQA."""
    ranks, _, jax_ref = runs
    want = jax_ref["shards"][name]
    whole = dict(_leaf_items(want["whole"]))
    for r, rank in enumerate(ranks):
        got = rank["leaves"][name]
        shards = dict(_leaf_items(want["params"]))
        assert set(dict(_leaf_items(got["params"]))) == set(shards)
        for key, leaf in _leaf_items(got["params"]):
            ref = (whole[key] if name == "mqa" and key in ("layers/wk",
                                                           "layers/wv")
                   else shards[key][r])
            np.testing.assert_array_equal(leaf, ref, err_msg=key)
        for k, leaf in got["cache"].items():
            np.testing.assert_array_equal(leaf, want["cache"][k][r])
        # a fresh cache: 2 KV heads split to 1 a rank, 1 held whole
        assert got["fresh_cache"][3] == 1


def test_uneven_heads_each_rank_holds_whole_heads(runs):
    """``odd``'s 3 query heads over ``tp=2``: rank 0 holds heads 0-1 and
    rank 1 head 2 of ``wq`` and ``wo`` (JAX splits the middle head's
    columns, 1.5 heads a rank), the whole KV head (as under MQA) and
    JAX's shards of every other leaf; the cache is whole on both."""
    ranks, _, jax_ref = runs
    want = jax_ref["shards"]["odd"]
    whole = dict(_leaf_items(want["whole"]))
    shards = dict(_leaf_items(want["params"]))
    hd = 32
    for r, (first, n) in enumerate([(0, 2), (2, 1)]):
        got = dict(_leaf_items(ranks[r]["leaves"]["odd"]["params"]))
        assert set(got) == set(shards)
        cols = slice(first * hd, (first + n) * hd)
        own = {"layers/wq": whole["layers/wq"][..., cols],
               "layers/wo": whole["layers/wo"][:, cols],
               "layers/wk": whole["layers/wk"],
               "layers/wv": whole["layers/wv"]}
        for key, leaf in got.items():
            ref = own[key] if key in own else shards[key][r]
            np.testing.assert_array_equal(leaf, ref, err_msg=key)
        for k, leaf in ranks[r]["leaves"]["odd"]["cache"].items():
            np.testing.assert_array_equal(leaf, want["cache"][k][r])


def test_uneven_heads_embeddings_match_one_process_and_jax(runs):
    """The embeddings forward (the flash path on each rank's 2 and 1
    heads) within 1e-5 of one process and of JAX's ``forward_hidden``."""
    ranks, single, jax_ref = runs
    got = ranks[0]["engines"]["odd_embed"]["hidden"]
    np.testing.assert_allclose(got, single["odd_hidden"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, jax_ref["odd_hidden"], rtol=0,
                               atol=ATOL)


def test_static_engine_matches_one_process_and_jax(runs):
    ranks, single, jax_ref = runs
    for name in ("llama", "mqa", "odd"):
        for rank in ranks:            # SPMD: every rank decodes the same
            assert rank["static"][name] == single["static"][name], name
        assert single["static"][name] == jax_ref["static"][name], name


@pytest.mark.parametrize("case", ["paged_prefix", "dense_prefix", "parity"])
def test_continuous_engine_with_a_prefix(runs, case):
    """Tokens equal JAX's and the one-process port's; every decode
    tick's logits within 1e-5 of the one-process port's; the prefix
    skipped its prefill on the sharded engine as on one process."""
    ranks, single, jax_ref = runs
    got, want = ranks[0]["engines"][case], single[case]
    assert got["tokens"] == want["tokens"] == jax_ref["continuous"]["llama"]
    assert got["prefixed"] == want["prefixed"] == \
        jax_ref["continuous"]["llama_prefixed"]
    assert got["prefill_tokens"] == want["prefill_tokens"]
    assert len(got["logits"]) == len(want["logits"]) > 0
    for a, b in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    # gloo collectives: the tick runs eager (on the CPU it would anyway)
    assert got["tick_launches"]["graph"] == 0
    assert got["tick_launches"]["eager"] > 0


@pytest.mark.parametrize("name", ["mqa", "odd", "gemma", "moe"])
def test_mqa_gemma_and_moe_tokens_match_jax(runs, name):
    """One KV head (MQA, Gemma: the cache whole on every rank), 3 query
    heads that ``tp=2`` does not divide (``odd``) and MoE (each rank's
    share of every expert; the router replicated)."""
    ranks, single, jax_ref = runs
    got = ranks[0]["engines"][name]
    assert got["tokens"] == single[name]["tokens"] == \
        jax_ref["continuous"][name]
    assert got["prefixed"] == jax_ref["continuous"][name + "_prefixed"]
    for a, b in zip(got["logits"], single[name]["logits"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["preempt", "handoff"])
def test_preemption_and_handoff_match_one_process(runs, case):
    ranks, single, _ = runs
    got = ranks[0]["engines"][case]
    assert got["tokens"] == single[case]["tokens"]
    assert got["preempted" if case == "preempt" else "handoffs"] > 0


def test_speculative_lanes_with_the_draft_on_the_mesh(runs):
    ranks, single, _ = runs
    got = ranks[0]["engines"]["spec"]
    assert got["tokens"] == single["spec_plain"]
    assert got["proposed"] > 0


def test_http_front_on_rank_zero(runs):
    """``:predict`` tokens and ``/v1/embeddings`` vectors through the
    server on rank 0 (the embeddings forward one of the engine's steps,
    run by both ranks) against the one-process port and JAX."""
    ranks, single, jax_ref = runs
    got = ranks[0]["http"]
    assert got["tokens"] == single["http_tokens"]
    for g, p, j in zip(got["embeddings"], single["embeddings"],
                       jax_ref["embeddings"]):
        np.testing.assert_allclose(g, p, rtol=0, atol=ATOL)
        np.testing.assert_allclose(g, j, rtol=0, atol=ATOL)
    assert got["usage"]["prompt_tokens"] > 0


def test_followers_ran_every_step(runs):
    ranks, _, _ = runs
    followed = ranks[1]["engines"]
    for case in list(ENGINES) + ["mqa", "odd", "odd_embed", "gemma", "moe",
                                 "spec"]:
        assert followed[case]["followed"] > 0, case
    assert ranks[1]["http"]["followed"] > 0


@pytest.mark.parametrize("name", ["quantize_continuous", "quantize_static",
                                  "n_heads", "d_ff", "vocab_size"])
def test_refusals_name_the_reason(runs, name):
    """Weight quantization with a mesh is refused in JAX's words; a split
    of a leaf into unequal shards names its dimension, and the JAX
    ``shard_for_serving`` refuses the same split (its ``device_put``).
    The query heads themselves need not divide (``odd``): their columns
    must."""
    ranks, _, jax_ref = runs
    for rank in ranks:
        msg = rank["refusals"][name]
        assert msg is not None, name
        if name.startswith("quantize"):
            assert msg == ("mesh-parallel serving does not compose with "
                           "weight quantization yet")
        else:
            assert f"needs {REFUSED_DIM[name]} divisible by 2" in msg
            assert "the JAX package refuses this split too" in msg
    if not name.startswith("quantize"):
        assert "should be divisible by 2" in (jax_ref["refused"][name]
                                              or ""), name


def test_tp_above_the_visible_devices_is_refused_before_loading(
        monkeypatch, tmp_path):
    """On a host with one card, ``KUBEDL_SERVING_TP=2`` is refused in the
    JAX package's words before the artifact is read (there is none)."""
    import torch

    from kubedl_tpu_torch.serving import __main__ as tmain
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="KUBEDL_SERVING_TP=2 but only 1 "
                       "local devices"):
        tmain.build_engine(str(tmp_path / "missing"), 2, "", 0, tp=2)


def test_a_follower_fault_ends_the_run_with_an_error(runs):
    ranks, _, _ = runs
    assert ranks[1]["fault"]["raised"] == "planted follower fault"
    seen = ranks[0]["fault"]
    assert seen["error"] is not None
    assert seen["seconds"] < seen["timeout"]
