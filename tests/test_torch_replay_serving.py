"""The port's serving-day replay held against the JAX package's on the CPU:
the workload generator (every profile's fingerprint), the copied SLO
engine (``RequestSpanHarvester`` and ``SLOEvaluator``, headless and
backed by an API server) on one seeded span stream, and whole days of
``ServingReplay`` on the same JAX-made float32 weights, whose observation
dicts must be equal key by key: counts, ticks, every TTFT and queue wait,
the ``kv`` block and the SLO summary. Every request of a day has a fixed
``max_new`` and no stop token, so the days are scheduling alone and equal
to the last bit."""

import dataclasses

import numpy as np
import pytest
import torch

from kubedl_tpu.api.slo import new_slo as jnew_slo
from kubedl_tpu.core.apiserver import APIServer
from kubedl_tpu.core.clock import SimClock as JClock
from kubedl_tpu.core.events import Recorder
from kubedl_tpu.metrics.registry import Registry as JRegistry
from kubedl_tpu.metrics.registry import SLOMetrics
from kubedl_tpu.models import io as jio
from kubedl_tpu.replay import serving as jserving
from kubedl_tpu.replay import workload as jworkload
from kubedl_tpu.telemetry import slo as jslo
from kubedl_tpu.trace.tracer import Span as JSpan
from kubedl_tpu_torch.api import slo as tslo_api
from kubedl_tpu_torch.core.clock import SimClock as TClock
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.replay import serving as tserving
from kubedl_tpu_torch.replay import workload as tworkload
from kubedl_tpu_torch.telemetry import slo as tslo
from kubedl_tpu_torch.trace.tracer import Span as TSpan


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's days on one CPU thread: their steps are many tiny ops,
    which intra-op threads only slow down (and, beside other test
    processes, slow down many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Telemetry:
    """The ``telemetry=`` seam's duck type: records every call."""

    def __init__(self):
        self.calls = []
        self.api = object()
        self.profiles = self

    def observe_serving_stats(self, model, pool, stats):
        self.calls.append(("observe", model, pool, dict(stats)))

    def flush(self, api):
        self.calls.append(("flush", api is self.api))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX replay's tiny model, carried to the port by its artifact."""
    cfg, params = jserving._tiny_model()
    path = str(tmp_path_factory.mktemp("replay_tiny"))
    jio.save_model(cfg, params, path)
    tcfg, tparams = tio.load_model(path, device="cpu")
    return (cfg, params), (tcfg, tparams)


@pytest.fixture(scope="module")
def smoke_days(tiny):
    """The smoke serving day (``generate("smoke", 0)``) on both packages,
    each with a recording ``telemetry`` stub."""
    jmodel, tmodel = tiny
    jtel, ttel = _Telemetry(), _Telemetry()
    jres = jserving.ServingReplay(jworkload.generate("smoke", 0),
                                  model=jmodel, telemetry=jtel).run()
    treplay = tserving.ServingReplay(tworkload.generate("smoke", 0),
                                     model=tmodel, telemetry=ttel,
                                     device="cpu")
    tres = treplay.run()
    return jres, tres, jtel, ttel, treplay


@pytest.mark.parametrize("profile", sorted(jworkload.PROFILES))
def test_every_profile_fingerprints_as_the_jax_one(profile):
    """``replay/workload.py`` is a copy: each profile's day is the JAX
    day to the byte (the TPU pool labels are plain strings in it)."""
    assert dataclasses.asdict(tworkload.PROFILES[profile]) == \
        dataclasses.asdict(jworkload.PROFILES[profile])
    assert tworkload.generate(profile, 0).fingerprint() == \
        jworkload.generate(profile, 0).fingerprint()


def _span_stream(seed: int = 0, n: int = 160) -> list:
    """Request spans as the engine records them, seeded: a queue span
    (some requests preempted and re-queued, ``resumed``), a prefill span
    and the request's root; a flash crowd in the middle third makes the
    TTFTs of its requests long. Tuples ``(trace, span, name, start, end,
    attributes, status)`` in end order."""
    rng = np.random.default_rng(seed)
    out = []
    t = 1000.0
    for i in range(n):
        t += float(rng.exponential(2.0))
        trace = f"{i:032x}"
        crowd = n // 3 <= i < 2 * n // 3
        q = float(rng.exponential(3.0 if crowd else 0.2))
        pre = float(rng.uniform(0.01, 0.2))
        spans = [(f"{i:08x}q0", "request.queue", t, t + q,
                  {"resumed": False, "lane": 0}),
                 (f"{i:08x}p0", "request.prefill", t + q, t + q + pre,
                  {"tokens": 8, "lane": 0, "sharedBlocks": i % 2})]
        end = t + q + pre + float(rng.uniform(0.1, 1.0))
        if rng.random() < 0.2:        # preempted, re-queued, resumed
            r0 = end
            end = r0 + float(rng.uniform(0.1, 2.0))
            spans += [(f"{i:08x}q1", "request.queue", r0, end - 0.05,
                       {"resumed": True, "lane": 1}),
                      (f"{i:08x}p1", "request.prefill", end - 0.05, end,
                       {"tokens": 3, "lane": 1, "sharedBlocks": 0})]
        spans.append((f"{i:08x}r", "serving.request", t, end + 0.01,
                      {"tokens": 4}))
        out += [(trace, sid, name, a, b, attrs,
                 "error" if name == "serving.request" and i % 37 == 5
                 else "ok") for sid, name, a, b, attrs in spans]
    out.sort(key=lambda s: (s[4], s[1]))
    return out


def _spans(cls, stream) -> list:
    return [cls(trace_id=tr, span_id=sid, name=name, start=a, end=b,
                component="serving", status=st, attributes=dict(attrs))
            for tr, sid, name, a, b, attrs, st in stream]


@pytest.mark.parametrize("prune", [False, True])
def test_the_span_harvester_is_the_jax_one(prune):
    """The same stream fed in the same chunks gives the same samples,
    with both bookkeeping modes (a ring cleared between feeds, and the
    operator's ring-age pruning, where each feed re-offers the ring)."""
    stream = _span_stream()
    jh, th = jslo.RequestSpanHarvester(prune), tslo.RequestSpanHarvester(
        prune)
    jspans, tspans = _spans(JSpan, stream), _spans(TSpan, stream)
    jout, tout = [], []
    for lo in range(0, len(stream), 37):
        hi = lo + 37
        first = max(0, hi - 200) if prune else lo   # a ring of 200
        jout += jh.feed_traced(jspans[first:hi])
        tout += th.feed_traced(tspans[first:hi])
    assert tout == jout
    assert sum(1 for s in tout if s[0] == "ttft") == 160
    assert sum(1 for s in tout if s[0] == "queue") == 160


def _objectives(new_slo) -> list:
    return [new_slo("ttft", "ttft_p99", 1.0, goal=0.9, window_s=900.0,
                    alerting=[{"severity": "page", "shortSeconds": 30.0,
                               "longSeconds": 120.0, "burn": 2.0},
                              {"severity": "ticket", "shortSeconds": 60.0,
                               "longSeconds": 300.0, "burn": 1.0}]),
            new_slo("queue", "queue_p99", 0.5, goal=0.95, window_s=900.0)]


def _drive(mod, evaluator, clock, stream) -> None:
    """Harvest the stream into the evaluator on the clock with ``mod``'s
    harvester, evaluating on its cadence, as the replays do."""
    harvester = mod.RequestSpanHarvester(prune=False)
    spans = _spans(JSpan if mod is jslo else TSpan, stream)
    evaluator.evaluate(clock())
    for lo in range(0, len(spans), 16):
        chunk = spans[lo:lo + 16]
        clock.advance_to(max(s.end for s in chunk))
        for signal, value, t in harvester.feed(chunk):
            evaluator.observe(signal, value, t)
        evaluator.maybe_evaluate(clock())
    clock.advance(600.0)
    evaluator.evaluate(clock())


def test_the_headless_slo_evaluator_is_the_jax_one():
    """Budgets, burn rates and the alert log of both evaluators agree on
    one stream; the flash crowd fires the page pair and it clears."""
    assert _objectives(tslo_api.new_slo) == _objectives(jnew_slo)
    stream = _span_stream(1)
    runs = []
    for mod, clock_cls, new_slo in ((jslo, JClock, jnew_slo),
                                    (tslo, TClock, tslo_api.new_slo)):
        clock = clock_cls(t0=0.0)
        ev = mod.SLOEvaluator(clock=clock, evaluate_interval_s=5.0)
        for obj in _objectives(new_slo):
            ev.add(obj)
        _drive(mod, ev, clock, stream)
        runs.append((ev.summary(ndigits=6), ev.statuses(), ev.alert_log))
    assert runs[1] == runs[0]
    log = runs[1][2]
    assert [a["event"] for a in log if a["severity"] == "page"] == \
        ["fire", "clear"]


def _strip(obj: dict) -> dict:
    """An API object without what each server stamps on its own."""
    md = {k: v for k, v in obj["metadata"].items()
          if k not in ("uid", "resourceVersion")}
    return {**obj, "metadata": md}


def test_the_api_backed_slo_evaluator_is_the_jax_one():
    """Handed an API server (the JAX in-memory one: the evaluator takes
    any object with its verbs) and a recorder, the port's evaluator lists
    the same objectives and writes the same conditions and Events."""
    stream = _span_stream(2)
    runs = []
    for mod, new_slo in ((jslo, jnew_slo), (tslo, tslo_api.new_slo)):
        clock = JClock(t0=0.0)
        api = APIServer(clock=clock)
        for obj in _objectives(new_slo):
            api.create(obj)
        ev = mod.SLOEvaluator(api=api, clock=clock,
                              metrics=SLOMetrics(JRegistry()),
                              recorder=Recorder(api),
                              evaluate_interval_s=5.0)
        _drive(mod, ev, clock, stream)
        events = sorted((e["type"], e["reason"], e["message"],
                         e["involvedObject"]["name"])
                        for e in api.list("Event"))
        runs.append((ev.statuses(), ev.alert_log, events,
                     [_strip(o) for o in api.list("SLO")]))
    assert runs[1] == runs[0]
    assert any(e[1] == jslo.REASON_SLO_BURN for e in runs[1][2])


def test_the_smoke_serving_day_is_the_jax_one(smoke_days):
    jres, tres, _, _, replay = smoke_days
    for key in jres:
        assert tres[key] == jres[key], key
    assert tres == jres
    assert tres["requests_completed"] == tres["requests_submitted"] == 300
    assert tres["shared_prefix_admissions"] > 0
    # on the CPU every decode tick is eager (a step that only admits
    # launches none)
    launches = replay.engine.tick_launches
    assert launches["graph"] == 0 < launches["eager"] <= replay.ticks
    assert replay.registry.find("kubedl_trace_spans_total").value(
        component="serving") > 0


def test_the_telemetry_seam_sees_what_the_jax_one_sees(smoke_days):
    """Each drain folds the window's decode tokens/s into the stub, and
    the day ends with a profile flush to the stub's ``api``."""
    _, _, jtel, ttel, _ = smoke_days
    assert ttel.calls == jtel.calls
    assert ttel.calls[-1] == ("flush", True)
    assert sum(c[0] == "observe" and c[1:3] == ("serving",
                                                tworkload.POOL_V5E)
               for c in ttel.calls) >= 2


def test_the_burn_day_with_an_api_backed_slo_is_the_jax_one(tiny):
    """The flash-crowd day of the JAX SLO test (``drain_every=32``, an
    api-backed evaluator, one page pair): the port's replay fires and
    clears the same alert at the same sim times, writes the same Events
    and returns the same observation dict."""
    jmodel, tmodel = tiny
    runs = []
    for wmod, rmod, model, dev in (
            (jworkload, jserving, jmodel, {}),
            (tworkload, tserving, tmodel, {"device": "cpu"})):
        profile = wmod.Profile(
            name="slo-e2e", sim_seconds=3600.0, jobs=0, job_bursts=0,
            burst_frac=0.0, chaos_preemptions=0, capacity={},
            serving_requests=220, serving_bursts=1,
            serving_burst_frac=0.85, lanes=2, max_len=64, kv_block=8,
            pool_blocks=48, prefixes=4, serving_trace_capacity=16384)
        replay = rmod.ServingReplay(wmod.generate(profile, 3),
                                    drain_every=32, model=model, **dev)
        api = APIServer(clock=replay.clock)
        api.create(jnew_slo(
            "serving-ttft", "ttft_p99", 0.6, goal=0.9,
            window_s=4.0 * profile.sim_seconds,
            alerting=[{"severity": "page", "shortSeconds": 30.0,
                       "longSeconds": 120.0, "burn": 3.0}]))
        mod = jslo if rmod is jserving else tslo
        replay.slo = mod.SLOEvaluator(
            api=api, clock=replay.clock, metrics=SLOMetrics(JRegistry()),
            recorder=Recorder(api), evaluate_interval_s=5.0)
        res = replay.run()
        events = [(e["reason"], e["message"]) for e in api.list("Event")]
        runs.append((res, replay.slo.alert_log, events))
    (jres, jlog, jev), (tres, tlog, tev) = runs
    assert tres == jres
    assert tlog == jlog and [a["event"] for a in tlog] == ["fire", "clear"]
    assert tev == jev


def test_the_replay_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.ServingReplay(tworkload.generate("smoke", 0))
    from kubedl_tpu_torch.train.trainer import tree_leaves
    cfg, params = tserving._tiny_model("cpu")
    again = dict(tree_leaves(tserving._tiny_model("cpu")[1]))
    assert cfg.d_model == 64 and cfg.vocab_size == 128
    assert all(torch.equal(t, again[k]) for k, t in tree_leaves(params))
