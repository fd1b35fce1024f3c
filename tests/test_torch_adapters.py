"""Multi-model adapter pages in the port's continuous-batching engine, held
against the JAX package on the CPU.

Every scenario of the JAX package's engine-level multi-model tests
(``tests/test_multimodel.py``: LRU eviction mid-flight, the all-pinned
catalog, a cancel mid-handoff, the handoff moving the adapter share, the
caller-thread model check, the model-scoped prefix cache) runs on both
engines over one JAX-made artifact, with the same assertions, and the two
engines' observations (tokens, residency status, free pool blocks) must be
equal. Then the port's own pieces: recovery re-pins, the stats fields,
the ``:registerPrefix`` route's ``model`` field, the refusals, and the
framework-free catalog and residency copy driven beside the JAX one."""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.serving import adapters as jadapters
from kubedl_tpu.serving import batching as jbatching
from kubedl_tpu.serving import server as jserver
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.serving import adapters as tadapters
from kubedl_tpu_torch.serving import batching as tbatching
from kubedl_tpu_torch.serving import server as tserver

SIDES = {"jax": (jbatching, jadapters, jserver),
         "port": (tbatching, tadapters, tserver)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    cfg = dataclasses.replace(
        jllama.tiny(vocab=128), d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=128, dtype=jnp.float32)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("adapters"))
    jio.save_model(cfg, params, path)
    return {"jax": (cfg, params), "port": tio.load_model(path, device="cpu")}


class Side:
    """One package's engine factory and catalog, for a scenario."""

    def __init__(self, name, models):
        self.name = name
        self.batching, self.adapters, self.server = SIDES[name]
        self.cfg, self.params = models[name]

    def catalog(self, pages=2, models=("m-a", "m-b", "m-c")):
        cat = self.adapters.AdapterCatalog()
        for m in models:
            cat.register(self.adapters.AdapterSpec(model=m, pages=pages))
        return cat

    def engine(self, lanes=3, prefill_lanes=0, pool_blocks=24, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.batching.ContinuousBatchingEngine(
            self.cfg, self.params, lanes=lanes, max_len=64,
            kv_mode="paged", kv_block=8, pool_blocks=pool_blocks,
            prefill_lanes=prefill_lanes, **kw)


def _drain(eng):
    while eng.step():
        pass


def lru_evict_mid_flight(side):
    """Evicting the LRU adapter while a lane decodes under it drops only
    the pin: the lane's share keeps the pages until the request ends."""
    eng = side.engine(lanes=2, adapters=side.catalog(), max_adapters=2)
    req = eng.submit([5] * 12, 8, model="m-a")
    eng.step()
    st = eng.adapter_status()
    assert eng.adapter_resident("m-a")
    assert st["faults"] == {"m-a": 1} and st["active"] == {"m-a": 1}
    eng.load_adapter("m-b")
    eng.load_adapter("m-c")          # cap 2: evicts m-a (LRU), in flight
    mid = eng.adapter_status()
    assert not eng.adapter_resident("m-a")
    assert mid["resident"] == ["m-b", "m-c"] and mid["evictions"] == 1
    live_kv = sum(len(ln.blocks) for ln in eng._lane_state)
    assert eng._bpool.free_count == eng.pool_blocks - live_kv - 2 - 4
    _drain(eng)
    assert req.result() and len(req.tokens) == 8
    assert eng._bpool.free_count == eng.pool_blocks - 4
    assert all(r == 1 for r in eng._bpool.refcounts().values())
    assert eng.adapter_status()["active"] == {}
    return {"tokens": req.tokens, "mid": mid, "end": eng.adapter_status(),
            "free": eng._bpool.free_count}


def all_pinned_catalog_rejects(side):
    eng = side.engine(lanes=2, adapters=side.catalog(), max_adapters=2)
    eng.load_adapter("m-a", pinned=True)
    eng.load_adapter("m-b", pinned=True)
    with pytest.raises(ValueError, match="pinned"):
        eng.load_adapter("m-c")
    eng.load_adapter("m-a", pinned=True)     # idempotent: no new pages
    st = eng.adapter_status()
    assert st["resident"] == ["m-a", "m-b"] == st["pinned"]
    assert eng._bpool.free_count == eng.pool_blocks - 4
    return {"status": st, "free": eng._bpool.free_count}


def cancel_mid_handoff(side):
    """A model request cancelled while parked drops its adapter share
    exactly once; the pin stays."""
    eng = side.engine(lanes=3, prefill_lanes=1, pool_blocks=30,
                      adapters=side.catalog(), max_adapters=3)
    long_a = eng.submit([1, 2, 3], 30)
    long_b = eng.submit([4, 5, 6], 30)
    eng.step()
    assert eng.health()["active_lanes"] == 2
    victim = eng.submit([7] * 33, 10, model="m-a")
    eng.step()
    assert eng.health()["parked_lanes"] == 1
    assert eng.adapter_status()["active"] == {"m-a": 1}
    victim.cancel()
    eng.step()                       # the handoff pass frees it
    assert eng.health()["parked_lanes"] == 0
    st = eng.adapter_status()
    assert st["active"] == {} and st["resident"] == ["m-a"]
    live_kv = sum(len(ln.blocks) for ln in eng._lane_state)
    assert eng._bpool.free_count == eng.pool_blocks - live_kv - 2
    _drain(eng)
    assert long_a.result() and long_b.result()
    assert victim.done.is_set() and not victim.cancelled
    assert eng._bpool.free_count == eng.pool_blocks - 2
    assert all(r == 1 for r in eng._bpool.refcounts().values())
    return {"tokens": [long_a.tokens, long_b.tokens, victim.tokens],
            "status": eng.adapter_status()}


def handoff_moves_adapter_share(side):
    """The handoff MOVES the adapter share with the block-table row, and a
    model request's greedy tokens equal the base model's."""
    disagg = side.engine(lanes=4, prefill_lanes=1, adapters=side.catalog(),
                         max_adapters=3)
    req = disagg.submit([5] * 20, 4, model="m-b")
    _drain(disagg)
    assert req.result() and disagg.handoffs == 1
    base = side.engine().run([([5] * 20, 4)])
    assert [req.tokens] == base
    assert disagg._bpool.free_count == disagg.pool_blocks - 2
    assert all(r == 1 for r in disagg._bpool.refcounts().values())
    return {"tokens": req.tokens, "status": disagg.adapter_status()}


def submit_validates_model(side):
    eng = side.engine(lanes=2, adapters=side.catalog())
    with pytest.raises(ValueError, match="catalog"):
        eng.submit([1, 2], 2, model="nope")
    plain = side.engine(lanes=2)
    with pytest.raises(ValueError, match="base model"):
        plain.submit([1, 2], 2, model="m-a")
    # "" and the catalog's base name are the base model: no adapter
    r = eng.submit([1, 2], 2, model="base")
    _drain(eng)
    assert r.result() and eng.adapter_status()["faults"] == {}
    return {"tokens": r.tokens}


def prefix_cache_keyed_by_model(side):
    """Model A's prefix never serves model B or the base model; greedy
    tokens are identical either way."""
    eng = side.engine(lanes=2, pool_blocks=32, adapters=side.catalog(),
                      max_adapters=3)
    p = [3] * 16
    eng.register_prefix(p, model="m-a")
    assert eng.has_prefix(p, model="m-a")
    assert not eng.has_prefix(p) and not eng.has_prefix(p, model="m-b")
    probe = list(p) + [9, 9]
    assert eng.prefix_residency(probe, model="m-a") >= 2
    assert eng.prefix_residency(probe) == 0
    assert eng.prefix_residency(probe, model="m-b") == 0
    before = eng.prefill_tokens_total
    rb = eng.submit(probe, 2, model="m-b")
    _drain(eng)
    cold = eng.prefill_tokens_total - before
    before = eng.prefill_tokens_total
    ra = eng.submit(probe, 2, model="m-a")
    _drain(eng)
    warm = eng.prefill_tokens_total - before
    assert rb.result() == ra.result()
    assert warm <= cold - 16, (warm, cold)
    return {"tokens": ra.tokens, "cold": cold, "warm": warm,
            "snapshot": eng.residency_snapshot()[1:]}


SCENARIOS = {f.__name__: f for f in (
    lru_evict_mid_flight, all_pinned_catalog_rejects, cancel_mid_handoff,
    handoff_moves_adapter_share, submit_validates_model,
    prefix_cache_keyed_by_model)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_scenario_matches_jax(models, scenario):
    want = SCENARIOS[scenario](Side("jax", models))
    got = SCENARIOS[scenario](Side("port", models))
    assert got == want


def test_recovery_repins_adapters_and_serves_again(models):
    """A failed inline step cancels the lanes and re-pins every resident
    adapter into the fresh allocator (active counts restart at 0)."""
    side = Side("port", models)
    eng = side.engine(lanes=2, adapters=side.catalog(), max_adapters=2)
    eng.load_adapter("m-a", pinned=True)
    want = eng.run([([4, 4, 2], 5)])[0]
    epoch = eng.residency_epoch

    def boom(*a):
        raise RuntimeError("injected decode failure")

    real = eng._decode_p
    eng._decode_p = boom
    eng.submit([9, 9], 4, model="m-b")
    with pytest.raises(RuntimeError, match="injected"):
        eng.run([([4, 4, 2], 5)])
    eng._decode_p = real
    st = eng.adapter_status()
    assert st["resident"] == ["m-a", "m-b"] and st["active"] == {}
    assert st["pinned"] == ["m-a"] and eng.residency_epoch > epoch
    assert eng._bpool.free_count == eng.pool_blocks - 4
    assert eng.run([([4, 4, 2], 5)])[0] == want
    r = eng.submit([9, 9], 4, model="m-b")
    _drain(eng)
    assert r.result() == eng.run([([9, 9], 4)])[0]


def test_stats_appear_only_on_multi_model_engines(models):
    side = Side("port", models)
    plain = side.engine(lanes=2)
    assert not plain.multi_model and plain.adapter_status() == {}
    assert not any("adapter" in k for k in plain.health())
    assert not any("adapter" in k for k in plain.pool_stats())
    assert plain.residency_snapshot()[2] == frozenset()
    with pytest.raises(ValueError, match="no adapter catalog"):
        plain.load_adapter("m-a")
    eng = side.engine(lanes=2, adapters=side.catalog(), max_adapters=2)
    r = eng.submit([3, 1, 4], 3, model="m-c")
    eng.step()
    assert eng.adapter_fault_pages_step == 2
    _drain(eng)
    assert r.result()
    health, pool = eng.health(), eng.pool_stats()
    assert {k: health[k] for k in ("resident_adapters", "adapter_pages",
                                   "adapter_faults", "adapter_evictions")} \
        == {"resident_adapters": 1, "adapter_pages": 2,
            "adapter_faults": {"m-c": 1}, "adapter_evictions": 0}
    assert {k: pool[k] for k in ("adapter_pages", "adapter_peak_pages",
                                 "adapter_faults", "adapter_evictions")} \
        == {"adapter_pages": 2, "adapter_peak_pages": 2,
            "adapter_faults": 1, "adapter_evictions": 0}
    assert eng.residency_snapshot()[2] == frozenset({"m-c"})


def test_adapter_that_never_fits_fails_with_a_reason(models):
    side = Side("port", models)
    eng = side.engine(lanes=2, pool_blocks=8,
                      adapters=side.catalog(pages=9))
    req = eng.submit([1, 2], 2, model="m-a")
    eng.run([])
    with pytest.raises(RuntimeError, match="weight pages"):
        req.result(timeout=5)
    assert len(eng.run([([7, 7], 2)])[0]) == 2


def test_catalog_and_residency_match_jax():
    """The framework-free copy against the JAX module, driven by one
    sequence of loads, fault-ins, attaches, releases, evictions and a
    rebuild over each package's own block pool."""
    states = []
    for batching, adapters, _ in SIDES.values():
        cat = adapters.AdapterCatalog(base_model="gemma")
        for i, m in enumerate(("a", "b", "c", "d")):
            cat.register(adapters.AdapterSpec(model=m, pages=1 + i % 2,
                                              rank=16))
        with pytest.raises(ValueError, match="base model"):
            cat.register(adapters.AdapterSpec(model="gemma"))
        with pytest.raises(ValueError, match="pages"):
            adapters.AdapterSpec(model="x", pages=0)
        pool = batching.BlockPool(6)
        res = adapters.AdapterResidency(cat, pool, max_resident=3)
        log = [cat.normalize("gemma"), cat.normalize("b"), len(cat),
               "c" in cat, cat.models()]
        res.load("a", pinned=True)
        pages, faulted = res.ensure("b")
        held = res.attach("b")
        log += [list(pages), faulted, held, res.ensure("b")]
        res.ensure("c")
        res.ensure("d")                  # cap 3: evicts b (attached)
        log += [res.status(), pool.free_count, res.version]
        res.release("b", held)
        log += [res.ensure("c"), res.ensure("b"), pool.free_count]
        with pytest.raises(ValueError, match="unknown adapter"):
            res.load("zz")
        res.rebuild(batching.BlockPool(6))
        log += [res.status(), res.faults_total(), res.version]
        states.append(log)
    assert states[1] == states[0]


def _post(url, path, body):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.load(r)


@pytest.mark.parametrize("catalog", [True, False],
                         ids=["catalog", "no_catalog"])
def test_register_prefix_route_model_field(models, catalog):
    """``:registerPrefix`` scopes a prefix to one adapter with ``model``,
    answers as the JAX server does, and 400s an unknown model or a model
    on an engine without a catalog."""
    answers = {}
    for name in SIDES:
        side = Side(name, models)
        kw = dict(adapters=side.catalog(), max_adapters=3) if catalog else {}
        eng = side.engine(lanes=2, pool_blocks=32, **kw).start()
        server = side.server.InferenceServer(eng, side.server.ServerConfig(
            model_name="m", host="127.0.0.1", port=0)).start()
        got = []
        try:
            url = server.url + "/v1/models/m:registerPrefix"
            for body in ({"prefix_tokens": [1, 2, 3], "model": "m-a"},
                         {"prefix_tokens": [4, 5, 6]},
                         {"prefix_tokens": [7, 8], "model": "nope"}):
                try:
                    got.append(_post(url, "", body))
                except urllib.error.HTTPError as e:
                    got.append(e.code)
            got.append([eng.has_prefix([1, 2, 3], model="m-a"),
                        eng.has_prefix([1, 2, 3]), eng.has_prefix([4, 5, 6])])
        finally:
            server.stop()
            eng.stop()
        answers[name] = got
    assert answers["port"] == answers["jax"]
    if catalog:
        assert answers["port"] == [{"registered": 3, "model": "m-a"},
                                   {"registered": 3}, 400,
                                   [True, False, True]]
    else:
        assert answers["port"] == [400, {"registered": 3}, 400,
                                   [False, False, True]]


def test_engine_refuses_adapters_it_cannot_page(models):
    side = Side("port", models)
    with pytest.raises(ValueError, match="paged"):
        tbatching.ContinuousBatchingEngine(
            side.cfg, side.params, lanes=2, max_len=64, kv_mode="dense",
            adapters=side.catalog(), device="cpu")
    with pytest.raises(ValueError, match="needs an adapter catalog"):
        side.engine(lanes=2, max_adapters=2)
    assert np.array_equal(side.engine(lanes=2, adapters=side.catalog())
                          ._tables, np.zeros((2, 8), np.int64))


def test_an_adapter_requests_spans_carry_its_model(models):
    """Every span of a request under an adapter carries the same
    attributes on both engines: ``request.prefill`` names the model as
    ``serving.request`` does (a base-model request names none)."""
    from kubedl_tpu.trace import Tracer as JTracer
    from kubedl_tpu_torch.trace import Tracer as TTracer
    got = {}
    for name, tracer_cls in (("jax", JTracer), ("port", TTracer)):
        side = Side(name, models)
        tracer = tracer_cls(enabled=True, clock=lambda: 0.0)
        eng = side.engine(adapters=side.catalog(), max_adapters=2,
                          tracer=tracer)
        eng.submit([5, 6, 7, 8], 3, model="m-a")
        eng.submit([9, 10, 11], 2)
        _drain(eng)
        # the requests' spans (the port's engine adds its own decode-step
        # spans, ``engine.*``, on a trace of its own)
        got[name] = sorted((s.name, sorted(s.attributes.items()))
                           for s in tracer.spans()
                           if not s.name.startswith("engine."))
    assert got["port"] == got["jax"]
    prefills = [dict(a) for n, a in got["port"] if n == "request.prefill"]
    assert sorted(p.get("model", "") for p in prefills) == ["", "m-a"]
