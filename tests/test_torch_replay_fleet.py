"""The port's serving fleet held against the JAX package's on the CPU: the
routers, ``ServingFleet`` and ``ServingAutoscaler`` (copies of the JAX
modules) on one seeded stream of submits over stand-in engines, and whole
fleet days of ``ServingFleetReplay`` on the port's engines against the
JAX replay's on the same JAX-made float32 weights: the day of the JAX
package's ``test_smoke_fleet_replay_deterministic`` (60 requests, 120 s,
seed 1, the prefix-aware router), its disaggregated variant (prefill
lanes handing block tables to decode lanes) and an autoscaled day, each
observation dict equal key by key."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from kubedl_tpu.api.queue import QueueSpec as JQueue
from kubedl_tpu.controllers import servingfleet as jscale
from kubedl_tpu.metrics.registry import Registry as JRegistry
from kubedl_tpu.metrics.registry import ServingFleetMetrics as JMetrics
from kubedl_tpu.models import io as jio
from kubedl_tpu.replay import fleet as jfleet_replay
from kubedl_tpu.replay import serving as jserving
from kubedl_tpu.serving import fleet as jfleet
from kubedl_tpu.serving import router as jrouter
from kubedl_tpu_torch.api.queue import QueueSpec as TQueue
from kubedl_tpu_torch.controllers import servingfleet as tscale
from kubedl_tpu_torch.metrics.registry import (Registry,
                                               ServingFleetMetrics)
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.replay import fleet as tfleet_replay
from kubedl_tpu_torch.serving import fleet as tfleet
from kubedl_tpu_torch.serving import router as trouter

#: the JAX package's fleet smoke profile (tests/test_serving_fleet.py)
SMOKE = dict(sim_seconds=240.0, requests=160, bursts=6, replicas=2,
             max_replicas=2, decode_lanes=4, prefill_lanes=1,
             pool_blocks=48, prefixes=10, max_prefixes_per_replica=5,
             zipf_s=0.7)
DAY = dict(requests=60, sim_seconds=120.0)
#: the JAX test's disaggregated overrides, on the 60-request day
DISAGG = dict(DAY, long_prompt_frac=0.5, prefix_share=0.35,
              pool_blocks=100, decode_lanes=6, bursts=10)
#: one replica under one flash crowd, room for two more, the autoscaler
#: reconciling every 16 ticks: it scales up, then drains and reaps
AUTOSCALE = dict(DAY, replicas=1, max_replicas=3, bursts=1,
                 burst_frac=0.9, drain_every=16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's days on one CPU thread: their steps are many tiny ops,
    which intra-op threads only slow down (and, beside other test
    processes, slow down many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Req:
    def __init__(self):
        self.done = threading.Event()
        self.cancelled = False


class _Engine:
    """A stand-in engine with the surface the fleet, the router and the
    autoscaler read: submits queue up, each ``step`` finishes the oldest
    one, prefixes register with the least-recently-registered one
    evicted at the cap."""

    def __init__(self, lanes: int = 4, kv_block: int = 8):
        self.lanes = lanes
        self.kv_block = kv_block
        self.queue: list = []
        self.prefixes: list = []
        self.residency_epoch = 0
        self.handoffs = 0
        self.prefill_tokens_total = 0
        self.stopped = False

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def health(self) -> dict:
        return {"queue_depth": len(self.queue),
                "active_lanes": min(len(self.queue), self.lanes),
                "parked_lanes": 0,
                "free_blocks": 40 - 4 * len(self.queue),
                "handoffs": self.handoffs}

    def has_prefix(self, tokens, model: str = "") -> bool:
        return tuple(tokens) in self.prefixes

    def register_prefix(self, tokens, max_prefixes=None, pinned=False,
                        model=""):
        key = tuple(tokens)
        self.prefixes = [p for p in self.prefixes if p != key]
        if max_prefixes is not None and len(self.prefixes) >= max_prefixes:
            self.prefixes.pop(0)
        self.prefixes.insert(0, key)
        self.prefixes.sort(key=len, reverse=True)
        self.residency_epoch += 1

    def residency_snapshot(self):
        return (self.residency_epoch,
                tuple(("", p, len(p) // self.kv_block)
                      for p in self.prefixes), frozenset(), self.kv_block)

    def submit(self, prompt, max_new, **kw):
        req = _Req()
        self.queue.append(req)
        self.prefill_tokens_total += len(prompt)
        return req

    def step(self) -> bool:
        if self.queue:
            self.queue.pop(0).done.set()
            self.handoffs += 1
        return bool(self.queue)

    def stop(self) -> None:
        self.stopped = True


def _stream(seed: int = 0, n: int = 240):
    """Seeded submits: prompt, tenant, declared prefix (or None), and
    how many fleet steps run after it."""
    rng = np.random.default_rng(seed)
    prefixes = [[int(t) for t in rng.integers(1, 127, int(k))]
                for k in rng.integers(16, 33, 7)]
    out = []
    for _ in range(n):
        pre = (prefixes[int(rng.zipf(1.5)) % 7]
               if rng.random() < 0.7 else None)
        body = [int(t) for t in rng.integers(1, 127, int(rng.integers(3,
                                                                     12)))]
        out.append(((pre or []) + body,
                    ("ads", "search", "free", None)[int(rng.integers(4))],
                    pre, int(rng.integers(0, 2))))
    return out


def _route(fleet_mod, router_mod, queue_cls, router: str, seed: int):
    fleet = fleet_mod.ServingFleet(lambda i: _Engine(), replicas=3)
    kw = {"seed": seed, "max_prefixes": 3}
    if router == "prefix":
        kw["queues"] = [queue_cls(name=t, tenants=(t,))
                        for t in ("ads", "search", "free")]
    r = {"prefix": router_mod.PrefixAwareRouter,
         "random": router_mod.RandomRouter}[router](fleet, **kw)
    placed = []
    for i, (prompt, tenant, prefix, steps) in enumerate(_stream(seed)):
        if i == 120:
            # a rolled replica: version-pinned submits avoid the others
            fleet.replicas[1].policy_version = 1
        version = 1 if i >= 120 and i % 5 == 0 else None
        _, rep = r.submit(prompt, 8, tenant=tenant, prefix=prefix,
                          version=version)
        placed.append(rep.name)
        for _ in range(steps):
            fleet.step()
    return placed, r.stats(), [rep.engine.prefixes
                               for rep in fleet.replicas]


@pytest.mark.parametrize("router", ["prefix", "random"])
@pytest.mark.parametrize("seed", [0, 1])
def test_the_routers_place_as_the_jax_ones(router, seed):
    """Every placement, the hit and spill counters and what each replica
    holds agree, including version-pinned submits after a roll."""
    want = _route(jfleet, jrouter, JQueue, router, seed)
    got = _route(tfleet, trouter, TQueue, router, seed)
    assert got == want
    if router == "prefix":
        assert got[1]["prefix_hits"] > got[1]["prefix_misses"]
        assert got[1]["tenant_spills"] > 0


def _autoscale(fleet_mod, scale_mod, metrics):
    """Pressure (a queue past the bar) scales up to the cap, the quiet
    afterwards drains and reaps back to the floor."""
    fleet = fleet_mod.ServingFleet(lambda i: _Engine(), replicas=1,
                                   metrics=metrics)
    auto = scale_mod.ServingAutoscaler(
        fleet, config=scale_mod.AutoscalerConfig(
            min_replicas=1, max_replicas=3, cooldown_s=10.0,
            scale_down_idle_s=30.0, queue_high=4),
        metrics=fleet.metrics)
    actions = []
    for t in range(0, 400, 5):
        if t < 60:
            for rep in fleet.active():
                for _ in range(6):
                    rep.engine.submit([1, 2, 3], 4)
        for _ in range(4):
            fleet.step()
        actions.append((t, auto.step(float(t))))
    return (actions, auto.status(), fleet.status(),
            fleet.metrics.registry.expose())


def test_the_fleet_and_its_autoscaler_act_as_the_jax_ones():
    """Every action at every reconcile, the autoscaler's and the fleet's
    status, and the fleet families' exposition agree."""
    want = _autoscale(jfleet, jscale, JMetrics(JRegistry()))
    got = _autoscale(tfleet, tscale, ServingFleetMetrics(Registry()))
    assert got == want
    status = got[1]
    assert status["scaleUps"] >= 2 and status["drains"] >= 2 \
        and status["reaped"] >= 2


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    cfg, params = jserving._tiny_model()
    path = str(tmp_path_factory.mktemp("fleet_tiny"))
    jio.save_model(cfg, params, path)
    return (cfg, params), tio.load_model(path, device="cpu")


def _profiles(over: dict):
    return (jfleet_replay.FleetProfile(name="smoke", **{**SMOKE, **over}),
            tfleet_replay.FleetProfile(name="smoke", **{**SMOKE, **over}))


@pytest.mark.parametrize("over", [DAY, DISAGG, AUTOSCALE],
                         ids=["combined", "disaggregated", "autoscaled"])
def test_the_fleet_day_is_the_jax_one(tiny, over):
    jmodel, tmodel = tiny
    jp, tp = _profiles(over)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    dis = over is DISAGG
    auto = over is AUTOSCALE
    want = jfleet_replay.ServingFleetReplay(
        jfleet_replay.generate_fleet(jp, 1), router="prefix",
        disaggregate=dis, autoscale=auto, model=jmodel).run()
    got = tfleet_replay.ServingFleetReplay(
        tfleet_replay.generate_fleet(tp, 1), router="prefix",
        disaggregate=dis, autoscale=auto, model=tmodel,
        device="cpu").run()
    for key in want:
        assert got[key] == want[key], key
    assert got == want
    assert got["requests_completed"] == got["requests_submitted"] == 60
    assert (got["handoffs"] > 0) == dis
    if auto:
        assert got["fleet"]["scale_ups"] == got["fleet"]["reaped_count"] \
            == 1


@pytest.mark.parametrize("profile", sorted(jfleet_replay.FLEET_PROFILES))
def test_the_fleet_workloads_fingerprint_as_the_jax_ones(profile):
    assert tfleet_replay.generate_fleet(profile, 0).fingerprint() == \
        jfleet_replay.generate_fleet(profile, 0).fingerprint()
    jp, tp = _profiles(DISAGG)
    assert tfleet_replay.generate_fleet(tp, 1).fingerprint() == \
        jfleet_replay.generate_fleet(jp, 1).fingerprint()
