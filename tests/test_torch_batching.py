"""The port's continuous-batching engine held against the JAX package's on
the CPU, on one JAX-made artifact (``save_model`` → the port's
``load_model``): greedy tokens identical and logprobs within 1e-4 in every
KV layout, prefix hits, preemption under a tiny pool, prefill-lane
handoffs, cancel, recovery after a failed step, and the host-side pieces
(``BlockPool``, ``fit_block``, ``resolve_kv_mode``) with the refusals of
what is not ported yet and of misused options."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.serving import batching as jbatching
from kubedl_tpu.serving.engine import GenerateConfig as JGen
from kubedl_tpu_torch.metrics.registry import PagedKVMetrics, Registry
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.parallel import mesh as tmesh
from kubedl_tpu_torch.serving import batching as tbatching
from kubedl_tpu_torch.serving.engine import GenerateConfig as TGen

#: float32 on both sides; the two frameworks sum in other orders
LOGPROB_ATOL = 1e-4
PREFIX = list(range(1, 11))       # 10 tokens: 1 full block of 8 + a tail


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    cfg = dataclasses.replace(jllama.tiny(vocab=128), dtype=jnp.float32)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("batching"))
    jio.save_model(cfg, params, path)
    tcfg, tparams = tio.load_model(path, device="cpu")
    return cfg, params, tcfg, tparams


def _jax(models, **kw):
    cfg, params, _, _ = models
    return jbatching.ContinuousBatchingEngine(cfg, params, **kw)


def _torch(models, **kw):
    _, _, tcfg, tparams = models
    return tbatching.ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                              **kw)


def _requests(seed: int = 0, n: int = 7, prefix_every: int = 0,
              new=(1, 9)) -> list:
    """Mixed prompt lengths and budgets (``new``: the range of max_new);
    with ``prefix_every`` every such request starts with PREFIX (a prefix
    hit, block sharing)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(1, 127, int(rng.integers(1, 20))).tolist()
        if prefix_every and i % prefix_every == 0:
            prompt = PREFIX + prompt
        out.append((prompt, int(rng.integers(*new))))
    return out


def _drain(engine, requests, **submit_kw):
    """Submit every request (with logprobs), drive the scheduler inline,
    return (tokens, logprobs) per request."""
    reqs = [engine.submit(p, n, logprobs=True, **submit_kw)
            for p, n in requests]
    engine.run([])
    return [r.result() for r in reqs], [r.logprobs for r in reqs]


@pytest.fixture(scope="module")
def eos_gen(models):
    """A stop token the greedy outputs really emit mid-generation, so
    ``hit_stop`` frees lanes early on both sides."""
    want = _jax(models, lanes=3, max_len=64, kv_mode="dense").run(
        _requests())
    eos = next(t[1] for t in want if len(t) > 2)
    return eos


@pytest.mark.parametrize("mode", ["dense", "paged", "parity"])
def test_greedy_identical_to_jax(models, eos_gen, mode):
    """More requests than lanes, mixed lengths, an eos that stops some
    of them: the same tokens as the JAX engine in each KV layout, with
    logprobs within 1e-4."""
    reqs = _requests()
    kw = dict(lanes=3, max_len=64, kv_mode=mode, kv_block=8)
    want, want_lp = _drain(_jax(models, gen=JGen(max_len=64, eos_id=eos_gen),
                                **kw), reqs)
    eng = _torch(models, gen=TGen(max_len=64, eos_id=eos_gen), **kw)
    got, got_lp = _drain(eng, reqs)
    assert got == want
    assert any(t[-1] == eos_gen and len(t) < n
               for t, (_, n) in zip(got, reqs))      # eos freed a lane
    for a, b in zip(got_lp, want_lp):
        np.testing.assert_allclose(a, b, atol=LOGPROB_ATOL)
    assert eng.tick_launches["graph"] == 0 < eng.tick_launches["eager"]
    if mode != "dense":
        assert eng._bpool.refcounts() == {}


def test_preemption_under_a_tiny_pool_matches_jax(models):
    """3 lanes over 12 blocks of 8 tokens (24 would hold 3 full lanes),
    a registered prefix and parity assertions in every step: both engines
    preempt, equally often, and emit the same tokens."""
    reqs = _requests(seed=1, n=6, prefix_every=3, new=(20, 34))
    kw = dict(lanes=3, max_len=64, kv_mode="parity", kv_block=8,
              pool_blocks=12)
    jeng = _jax(models, **kw)
    jeng.register_prefix(PREFIX)
    want = jeng.run(reqs)
    eng = _torch(models, **kw)
    eng.register_prefix(PREFIX)
    got = eng.run(reqs)
    assert got == want
    assert eng.preempted == jeng.preempted > 0
    st = eng.pool_stats()
    assert st["blocks_used"] == st["blocks_pinned"] == 1, st


def test_prefill_lane_handoffs_match_jax(models):
    reqs = _requests(seed=2, n=6)
    kw = dict(lanes=3, max_len=64, kv_mode="paged", kv_block=8,
              prefill_lanes=1)
    jeng = _jax(models, **kw)
    want = jeng.run(reqs)
    eng = _torch(models, **kw)
    got = eng.run(reqs)
    assert got == want
    assert eng.handoffs == jeng.handoffs > 0
    assert eng.health()["handoffs"] == eng.handoffs
    assert eng._bpool.refcounts() == {}


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_prefix_hits_leave_tokens_unchanged(models, mode):
    system = [7, 13, 21, 9, 2, 30, 17, 5, 44, 3, 8, 19]
    reqs = [(system + [40, 41], 5), (system + [50], 4),
            (system, 3),                    # prompt == prefix exactly
            ([1, 2, 3], 4)]                 # no prefix match
    kw = dict(lanes=2, max_len=64, kv_mode=mode, kv_block=4)
    want = _torch(models, **kw).run(reqs)
    cached = _torch(models, **kw)
    cached.register_prefix(system)
    assert cached.run(reqs) == want
    if mode == "paged":
        assert cached.pool_stats()["blocks_pinned"] == 3


def test_longest_prefix_match_wins(models):
    eng = _torch(models, lanes=1, max_len=64, kv_mode="dense")
    eng.register_prefix([7, 13])
    eng.register_prefix([7, 13, 21, 9])
    stored, start = eng._match_prefix([7, 13, 21, 9, 40])
    assert stored is not None and start == 4
    stored, start = eng._match_prefix([7, 13, 99])
    assert stored is not None and start == 2
    assert eng._match_prefix([8, 13]) == (None, 0)
    with pytest.raises(ValueError):
        eng.register_prefix([])

    paged = _torch(models, lanes=1, max_len=64, kv_mode="paged",
                   kv_block=2)
    paged.register_prefix([7, 13])
    paged.register_prefix([7, 13, 21, 9])
    blocks, start = paged._match_prefix_blocks([7, 13, 21, 9, 40])
    assert len(blocks) == 2 and start == 4
    blocks, start = paged._match_prefix_blocks([7, 13, 99])
    assert len(blocks) == 1 and start == 2
    assert paged._match_prefix_blocks([8, 13]) == ([], 0)
    assert paged.prefix_residency([7, 13, 21, 9, 40]) == 2


def test_prefix_cap_evicts_least_recently_hit(models):
    eng = _torch(models, lanes=1, max_len=64, kv_mode="paged", kv_block=4)
    eng.register_prefix(list(range(1, 9)), max_prefixes=2, pinned=True)
    eng.register_prefix(list(range(20, 28)), max_prefixes=2)
    eng.register_prefix(list(range(40, 48)), max_prefixes=2)
    assert eng.prefix_count == 2
    # the pinned one survives, the least recently hit one went
    assert [p[1] for p in eng.residency_snapshot()[1]] == \
        [tuple(range(1, 9)), tuple(range(40, 48))]
    assert eng.pool_stats()["blocks_pinned"] == 4
    with pytest.raises(ValueError, match="pinned"):
        eng.register_prefix([99, 98], max_prefixes=1)
    eng.clear_prefixes()
    assert eng._bpool.refcounts() == {} and eng.prefix_count == 0


def test_dense_prefix_refused_at_the_cap_keeps_no_stored_kv(models):
    """A re-registration under a lower cap passes the early check (its key
    is stored), prefills, then is refused under the lock: the KV it just
    stored is dropped, not kept beside the entries that hold theirs."""
    eng = _torch(models, lanes=1, max_len=64, kv_mode="dense")
    for start in (1, 20, 40):
        eng.register_prefix(list(range(start, start + 8)), max_prefixes=3,
                            pinned=True)
    held = set(eng._stored)
    assert held == {p.stored for p in eng._prefixes} and len(held) == 3
    with pytest.raises(ValueError, match="pinned"):
        eng.register_prefix(list(range(1, 9)), max_prefixes=1)
    assert set(eng._stored) == held and eng.prefix_count == 3


def test_cancel_midstream_keeps_partial_tokens_and_drains_blocks(models):
    eng = _torch(models, lanes=2, max_len=64, kv_mode="paged", kv_block=8)
    eng.register_prefix(PREFIX)
    real = eng._decode_p

    def slow(*a):
        time.sleep(0.02)
        return real(*a)

    eng._decode_p = slow
    eng.start()
    try:
        long_req = eng.submit(PREFIX + [60, 61], 40)
        short = eng.submit([5, 7], 4)
        got = []
        for tok, _ in long_req.stream(timeout=60):
            got.append(tok)
            if len(got) >= 3:
                long_req.cancel()
                break
        partial = long_req.result(timeout=60)
        assert 3 <= len(partial) < 40 and partial[:3] == got
        assert len(short.result(timeout=60)) == 4
        queued = eng.submit([7, 8], 8)       # may still be queued: cancel
        queued.cancel()
        assert len(queued.result(timeout=60)) <= 8
    finally:
        eng.stop()
    assert eng.pool_stats()["blocks_used"] == 1     # only the prefix pin
    eng.clear_prefixes()
    assert eng._bpool.refcounts() == {}
    assert eng._bpool.free_count == eng._bpool.total
    assert (eng._tables == 0).all()
    with pytest.raises(RuntimeError):
        eng.submit([1], 2)                   # a stopped engine refuses


def test_stop_unblocks_queued_waiters(models):
    eng = _torch(models, lanes=1, max_len=64)
    req = eng.submit([1, 2], 4)             # no loop: it stays queued
    errs = []

    def waiter():
        try:
            req.result(timeout=30)
        except RuntimeError as e:
            errs.append(str(e))

    t = threading.Thread(target=waiter)
    t.start()
    eng.stop()
    t.join(timeout=30)
    assert not t.is_alive()
    assert errs and "cancelled" in errs[0]


@pytest.mark.parametrize("mode", ["dense", "paged", "parity"])
def test_inline_failure_recovers_cache(models, mode):
    """A failed inline step cancels every request, and the engine serves
    correctly again afterwards (the JAX test's contract; here the cache is
    reset in place)."""
    eng = _torch(models, lanes=2, max_len=64, kv_mode=mode, kv_block=8)
    if mode != "dense":
        eng.register_prefix(PREFIX)
    want = eng.run([(PREFIX + [3, 1], 6)])[0]
    calls = {"n": 0}

    def boom(*a):
        calls["n"] += 1
        raise RuntimeError("injected decode failure")

    real = {n: getattr(eng, n) for n in ("_decode", "_decode_p")}
    for n in real:
        setattr(eng, n, boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.run([(PREFIX + [3, 1], 6), ([9, 2], 4)])
    assert calls["n"] == 1
    assert all(l.request is None for l in eng._lane_state)
    assert not eng._queue
    for n, fn in real.items():
        setattr(eng, n, fn)
    assert eng.run([(PREFIX + [3, 1], 6)])[0] == want
    if mode != "dense":
        assert eng.pool_stats()["blocks_pinned"] == 1


def test_request_that_never_fits_fails_with_a_reason(models):
    eng = _torch(models, lanes=2, max_len=64, kv_mode="paged", kv_block=8,
                 pool_blocks=8)
    eng.register_prefix(list(range(1, 49)))       # pins 6 of 8 blocks
    req = eng.submit([100, 101], 38)
    eng.run([])
    with pytest.raises(RuntimeError, match="free KV blocks"):
        req.result(timeout=5)
    assert len(eng.run([([7, 7], 2)])[0]) == 2


def test_per_request_sampling_isolates_lanes(models):
    """A greedy request co-batched with a hot one keeps its greedy tokens;
    the hot lane varies across seeds and repeats for one seed."""
    want = _torch(models, lanes=1, max_len=64).run([([3, 1, 4], 8)])[0]
    hot = []
    for seed in (0, 0, 1):
        eng = _torch(models, lanes=2, max_len=64, seed=seed)
        g = eng.submit([3, 1, 4], 8, temperature=0.0)
        h = eng.submit([3, 1, 4], 8, temperature=2.0, top_k=50)
        eng.run([])
        assert g.result() == want
        hot.append(h.result())
    assert hot[0] == hot[1] and hot[0] != hot[2]
    eng = _torch(models, lanes=2, max_len=64)
    for kw in ({"top_k": 129}, {"top_k": -1}, {"temperature": -0.5},
               {"top_p": 0.0}, {"top_p": 1.5}):
        with pytest.raises(ValueError):
            eng.submit([1, 2], 4, **kw)
    with pytest.raises(ValueError):
        eng.run([([1, 2, 3], 5), ([1] * 60, 8)])
    assert not eng._queue                    # nothing stranded


def test_request_spans(models):
    from kubedl_tpu_torch.trace import Tracer
    tracer = Tracer(enabled=True)
    eng = _torch(models, lanes=1, max_len=64, kv_block=8, pool_blocks=8,
                 tracer=tracer)
    eng.run([([5, 6, 7], 3), ([8] * 40, 20)])
    names = [s.name for s in tracer.spans()]
    for n in ("request.queue", "request.prefill", "request.decode",
              "serving.request"):
        assert n in names
    roots = [s for s in tracer.spans() if s.name == "serving.request"]
    assert [r.attributes["tokens"] for r in roots] == [3, 20]


def test_engine_growth_allocates_blockwise(models):
    eng = _torch(models, lanes=2, max_len=64, kv_mode="paged", kv_block=8)
    for pos in range(40):
        assert eng._ensure_blocks(0, pos)
    assert eng._bpool.allocs == 5
    assert list(eng._tables[0, :5]) == eng._lane_state[0].blocks
    eng._free_lane(0)
    assert eng._bpool.refcounts() == {} and (eng._tables[0] == 0).all()
    with pytest.raises(ValueError, match="pool_blocks"):
        _torch(models, lanes=2, max_len=64, kv_block=8, pool_blocks=4)
    with pytest.raises(ValueError, match="paged"):
        _torch(models, lanes=2, max_len=64, kv_mode="dense",
               prefill_lanes=1)


def test_block_pool_and_layout_helpers(monkeypatch):
    """The port's copies of the host-side helpers, on the JAX package's
    own expectations (``tests/test_paged_kv.py``)."""
    mod = tbatching
    assert [mod.fit_block(b, m) for b, m in
            ((64, 1024), (64, 96), (16, 96), (64, 100), (64, 7))] == \
        [64, 32, 16, 4, 1]
    assert mod.resolve_kv_mode("dense") == "dense"
    monkeypatch.setenv("KUBEDL_KV_MODE", "parity")
    assert mod.resolve_kv_mode() == "parity"
    monkeypatch.delenv("KUBEDL_KV_MODE")
    assert mod.resolve_kv_mode() == "paged"
    with pytest.raises(ValueError):
        mod.resolve_kv_mode("slab")
    pool = mod.BlockPool(4)
    a = pool.alloc(2)
    assert sorted(a) == [1, 2] and pool.free_count == 2
    assert pool.alloc(3) is None and pool.free_count == 2
    pool.incref(a[:1])
    assert pool.shared_count == 1
    pool.decref(a[:1])
    pool.decref(a)
    assert pool.free_count == 4 and pool.refcounts() == {}
    assert pool.allocs == 2
    assert [mod._bucket(n) for n in (1, 16, 17, 300)] == [16, 16, 32, 512]
    assert [mod._pow2_floor(n) for n in (1, 5, 64)] == [1, 4, 64]


def test_paged_kv_metrics_refresh():
    reg = Registry()
    m = PagedKVMetrics(reg)
    m.refresh({"kv_mode": "paged", "peak_active": 3, "kv_block": 16,
               "blocks_total": 32, "blocks_free": 20, "blocks_used": 12,
               "blocks_shared": 3, "blocks_pinned": 2, "block_allocs": 40,
               "preempted": 1})
    page = reg.expose()
    for line in ("kubedl_serving_kv_blocks_total 32.0",
                 "kubedl_serving_kv_blocks_free 20.0",
                 "kubedl_serving_kv_blocks_pinned 2.0",
                 "kubedl_serving_kv_shared_block_ratio 0.25",
                 "kubedl_serving_kv_preemptions_total 1.0",
                 "kubedl_serving_peak_active_lanes 3.0"):
        assert line in page
    m.refresh({"kv_mode": "dense", "peak_active": 4})
    assert "kubedl_serving_peak_active_lanes 4.0" in reg.expose()


def test_decode_tick_route():
    """The tick replays a CUDA graph on a card and runs eagerly
    elsewhere; an engine on the CPU counts only eager ticks."""
    assert tbatching.decode_tick_route("cpu") == "eager"
    assert tbatching.decode_tick_route(torch.device("cpu")) == "eager"
    assert tbatching.decode_tick_route("cuda") == "graph"
    assert tbatching.decode_tick_route(torch.device("cuda", 0)) == "graph"


def test_paged_forward_step_matches_the_dense_cache(models):
    """``forward_step_paged`` through scattered, shared and sink table
    entries gives the dense cache's logits, in a prefill and a per-row
    decode step."""
    _, _, cfg, params = models
    blk, bpl = 4, 4
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(1, 127, (2, 10)))
    cache = tllama.init_cache(cfg, 2, blk * bpl, device="cpu")
    pool = tllama.init_block_pool(cfg, 12, blk, device="cpu")
    tables = torch.as_tensor([[5, 2, 9, 0], [7, 1, 11, 0]])
    for row in range(2):
        dense_row = {k: v[:, row:row + 1] for k, v in cache.items()}
        want, _ = tllama.forward_step(cfg, params, toks[row:row + 1],
                                      dense_row, 0)
        got, _ = tllama.forward_step_paged(cfg, params, toks[row:row + 1],
                                           pool, tables[row:row + 1], 0)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    cur = torch.as_tensor([[3], [4]])
    pos = torch.as_tensor([10, 10])
    want, _ = tllama.forward_step(cfg, params, cur, cache, pos)
    got, _ = tllama.forward_step_paged(cfg, params, cur, pool, tables, pos)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # the decode wrote slot 10 of each row into its third block, in place
    np.testing.assert_allclose(pool["k"][:, 9, 2].numpy(),
                               cache["k"][:, 0, 10].numpy(), atol=1e-6)


#: what each option refuses: quantization, adapters and a serving mesh
#: are ported and refuse only a misuse, by name (a mesh with weight
#: quantization in the JAX package's words)
REFUSED = {
    "quantize": (dict(quantize="int3"), ValueError, "int3"),
    "quantize_draft": (dict(quantize_draft="fp8", spec_k=2,
                            draft_config=True), ValueError, "fp8"),
    "mesh": (dict(mesh=tmesh.Mesh(device=torch.device("cpu"),
                                  shape=dict.fromkeys(tmesh.AXES, 1)),
                  quantize="int8"), ValueError,
             "mesh-parallel serving does not compose with weight "
             "quantization yet"),
    "adapters": (dict(adapters=object(), kv_mode="dense"), ValueError,
                 "adapters require a paged KV layout"),
    "max_adapters": (dict(max_adapters=2), ValueError,
                     "max_adapters caps resident adapters"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_options_are_refused_by_name(models, name):
    kw, exc, match = REFUSED[name]
    if kw.get("draft_config"):
        kw = dict(kw, draft_config=models[2], draft_params=models[3])
    with pytest.raises(exc, match=match) as err:
        _torch(models, lanes=1, max_len=64, **kw)
    assert name.split("_")[0] in str(err.value)


def test_moe_and_standalone_speculative_engine_are_refused():
    """Since slice 17 the MoE family serves over its expert-parallel
    ``ep`` axis (``test_torch_serving_ep_cp.py``) and the standalone
    speculative engine runs (``test_torch_speculative.py``). What either
    still refuses: an ``ep`` mesh with no process group behind it, and a
    draft over another vocabulary (the JAX engine's guard)."""
    from kubedl_tpu_torch.models import llama as tllama
    from kubedl_tpu_torch.models import moe as tmoe
    from kubedl_tpu_torch.serving.speculative import SpeculativeEngine
    ep_mesh = tmesh.Mesh(device=torch.device("cpu"),
                         shape={a: 2 if a == "ep" else 1 for a in tmesh.AXES})
    with pytest.raises(ValueError, match="has no process group"):
        tbatching.ContinuousBatchingEngine(tmoe.tiny(), {}, mesh=ep_mesh,
                                           device="cpu")
    cfg = dataclasses.replace(tllama.tiny(vocab=64), n_layers=1)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    spec = SpeculativeEngine(cfg, params, cfg, params, k=2, max_len=32,
                             device="cpu")
    assert len(spec.generate([3, 5], 4)) == 4
    with pytest.raises(ValueError, match="share a vocabulary"):
        SpeculativeEngine(cfg, params,
                          dataclasses.replace(cfg, vocab_size=32), params,
                          device="cpu")
