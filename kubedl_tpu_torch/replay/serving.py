"""Serving-day replay: the port's continuous-batching engine on sim time;
the counterpart of ``kubedl_tpu/replay/serving.py``.

Drives the :class:`~kubedl_tpu_torch.serving.batching.ContinuousBatchingEngine`
(paged KV, by default the tiny model shapes — the measured quantity is
scheduling behavior, not device throughput) tick-by-tick through a
Zipf-prefix request day. The harness submits arrivals at their simulated
times, calls the engine's inline :meth:`step` seam once per tick, and
advances the shared :class:`SimClock` by a fixed per-tick cost — so
every span the engine's own tracer records (``request.queue``,
``request.prefill``, ``serving.request``) is measured in deterministic
simulated seconds. TTFT and queue-delay distributions are extracted from
those spans (drained periodically so a 50k-request day never wraps the
ring), and pool health comes from ``pool_stats()`` via
:class:`PagedKVMetrics` — the same signals production scrapes.

Every request of a day has a fixed ``max_new`` and no stop token, so
what the replay observes is a function of the workload and the sim clock
alone: the same day gives the same observation dict at any model width,
on the card or on the CPU. The replay runs on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..api.slo import new_slo
from ..core.clock import SimClock
from ..metrics.registry import PagedKVMetrics, Registry, TraceMetrics
from ..telemetry.slo import RequestSpanHarvester, SLOEvaluator
from ..trace import Tracer
from .workload import Workload


def default_serving_slos(profile) -> list:
    """The serving day's declared objectives (docs/slo.md): 99% of
    requests admitted (queue) and first-token-served (ttft) within the
    target, tracked over the whole day so the scorecard can gate on
    budget remaining. Targets sit above the committed p99 (2.75s) with
    headroom for flash-crowd tails, not above the max — a real queueing
    collapse burns the budget."""
    window = 4.0 * profile.sim_seconds
    return [
        new_slo("serving-ttft-p99", "ttft_p99", 5.0, window_s=window),
        new_slo("serving-queue-p99", "queue_p99", 5.0, window_s=window),
    ]


def _tiny_model(device=None):
    """The bench-standard tiny llama (the JAX replay's shapes): vocab 128,
    d_model 64, float32. Its weights are drawn from a ``torch.Generator``
    seeded 0; the two frameworks' generators differ, so a comparison with
    the JAX replay hands both the same weights through ``model=``."""
    import torch

    from ..models import llama
    cfg = dataclasses.replace(
        llama.tiny(vocab=128), d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=128, dtype="float32")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device=device)
    return cfg, params


class ServingReplay:
    """One serving-day replay. ``run()`` returns the raw observation
    dict (span-derived latency samples + pool metrics reads)."""

    def __init__(self, workload: Workload, model=None, slo=None,
                 drain_every: int = 512, telemetry=None,
                 serving_pool: Optional[str] = None,
                 model_key: str = "serving", device=None):
        from .._device import resolve_device
        from ..serving.batching import ContinuousBatchingEngine
        from .workload import POOL_V5E
        profile = workload.profile
        self.workload = workload
        #: the card unless the caller names the CPU
        self.device = resolve_device(device)
        self.clock = SimClock()
        #: FleetTelemetry bundle (docs/telemetry.md): when present, every
        #: span drain folds the window's decode tokens/s into the model's
        #: ThroughputProfile via the observe_serving_stats seam — the
        #: serving half of the Gavel placement currency — and run() ends
        #: with a profile flush, so a serving day leaves a PERSISTED
        #: profile the scheduler can score with
        self.telemetry = telemetry
        self.serving_pool = serving_pool or POOL_V5E
        self.model_key = model_key
        self._last_stats_t = 0.0
        self._last_stats_tokens = 0
        #: ticks between span drains (and therefore SLO evaluations /
        #: pool-metric samples); the default matches the committed
        #: scorecard cadence, tests lower it to watch burn windows live
        self.drain_every = int(drain_every)
        #: SLO engine over the serving signals (docs/slo.md): headless
        #: (no api) by default with the profile's default objectives; an
        #: injected evaluator (the e2e test's api-backed one) sees the
        #: identical sample stream
        self.slo = slo if slo is not None else SLOEvaluator(
            clock=self.clock, evaluate_interval_s=30.0)
        if slo is None:
            for obj in default_serving_slos(profile):
                self.slo.add(obj)
        self.registry = Registry()
        self.tracer = Tracer(enabled=True,
                             capacity=profile.serving_trace_capacity,
                             clock=self.clock,
                             metrics=TraceMetrics(self.registry))
        self.kv_metrics = PagedKVMetrics(self.registry)
        cfg, params = model if model is not None \
            else _tiny_model(self.device)
        self.engine = ContinuousBatchingEngine(
            cfg, params, lanes=profile.lanes, max_len=profile.max_len,
            kv_mode="paged", kv_block=profile.kv_block,
            pool_blocks=profile.pool_blocks, seed=workload.seed,
            tracer=self.tracer, device=self.device)
        for prefix in workload.serving_prefixes:
            self.engine.register_prefix(list(prefix))
        # span-derived accumulators
        self.queue_waits: list = []
        self.ttfts: list = []
        self.resumes = 0
        self.completed = 0
        self.errors = 0
        self.tokens_out = 0
        self.shared_block_admissions = 0
        # the ONE ttft/queue span derivation (docs/slo.md): shared with
        # the operator-side SLO engine so the scorecard's ttfts_s and
        # the SLO samples can never drift apart. prune=False because
        # _drain clears the ring between feeds.
        self._harvester = RequestSpanHarvester(prune=False)
        self.shared_ratio_peak = 0.0
        self.ticks = 0

    # -- span drain ------------------------------------------------------

    def _drain(self) -> None:
        spans = self.tracer.spans()
        if not spans:
            return
        self.tracer.clear()
        for signal, value, t in self._harvester.feed(spans):
            if signal == "ttft":
                self.ttfts.append(value)
            self.slo.observe(signal, value, t)
        for s in spans:
            if s.name == "request.queue":
                self.queue_waits.append(s.duration)
                if s.attributes.get("resumed"):
                    self.resumes += 1
            elif s.name == "request.prefill":
                if s.attributes.get("sharedBlocks", 0) > 0:
                    self.shared_block_admissions += 1
            elif s.name == "serving.request":
                self.completed += 1
                if s.status != "ok":
                    self.errors += 1
                self.tokens_out += int(s.attributes.get("tokens", 0))
        self.kv_metrics.refresh(self.engine.pool_stats())
        self.shared_ratio_peak = max(self.shared_ratio_peak,
                                     self.kv_metrics.shared_ratio.value())
        if self.telemetry is not None:
            # decode tokens/s over the drained window, in simulated
            # seconds — the observe_serving_stats seam (docs/telemetry.md)
            now = self.clock.elapsed
            dt = now - self._last_stats_t
            dtok = self.tokens_out - self._last_stats_tokens
            if dt > 0 and dtok > 0:
                self.telemetry.observe_serving_stats(
                    self.model_key, self.serving_pool,
                    {"decode_tokens_per_s": dtok / dt})
            self._last_stats_t = now
            self._last_stats_tokens = self.tokens_out
        self.slo.maybe_evaluate(self.clock())

    # -- the day loop ----------------------------------------------------

    def run(self) -> dict:
        profile = self.workload.profile
        # register api-listed objectives BEFORE the first samples land
        # (an injected api-backed evaluator discovers SLO objects on
        # evaluation; samples observed earlier would route nowhere)
        self.slo.evaluate(self.clock())
        arrivals = self.workload.serving
        requests = []
        i, n = 0, len(arrivals)
        active = False
        drain_every = self.drain_every
        while i < n or active:
            if not active and i < n \
                    and arrivals[i].arrival_s > self.clock.elapsed:
                # idle: fast-forward straight to the next arrival (the
                # epsilon absorbs t0-magnitude float rounding)
                self.clock.advance_to(arrivals[i].arrival_s + 1e-6)
            while i < n and arrivals[i].arrival_s \
                    <= self.clock.elapsed + 1e-6:
                a = arrivals[i]
                requests.append(self.engine.submit(list(a.prompt),
                                                   a.max_new))
                i += 1
            # the tick's sim-time cost elapses BEFORE its admissions
            # land: a request arriving mid-tick is picked up at the next
            # tick boundary, so even an uncontended TTFT is >= one tick
            self.clock.advance(profile.tick_s)
            active = self.engine.step()
            self.ticks += 1
            if self.ticks % drain_every == 0:
                self._drain()
        self._drain()
        self.slo.evaluate(self.clock())     # final windows + verdicts
        if self.telemetry is not None:
            # leave a PERSISTED ThroughputProfile behind (the scheduler
            # loads these on restart; docs/scheduling.md seeding order)
            self.telemetry.profiles.flush(self.telemetry.api)
        undone = sum(1 for r in requests if not r.done.is_set())
        return {
            "requests_submitted": len(requests),
            "requests_completed": self.completed,
            "requests_unfinished": undone,
            "errors": self.errors,
            "resumed_admissions": self.resumes,
            "shared_prefix_admissions": self.shared_block_admissions,
            "tokens_generated": self.tokens_out,
            "engine_ticks": self.ticks,
            "sim_span_s": round(self.clock.elapsed, 1),
            "slo": self.slo.summary(ndigits=4),
            "queue_waits_s": self.queue_waits,
            "ttfts_s": self.ttfts,
            "kv": {
                "peak_active_lanes": self.kv_metrics.peak_active.value(),
                "pool_blocks": self.kv_metrics.blocks_total.value(),
                "blocks_pinned": self.kv_metrics.blocks_pinned.value(),
                "preemptions": self.kv_metrics.preemptions.value(),
                "shared_block_ratio_peak": round(self.shared_ratio_peak, 4),
            },
        }
