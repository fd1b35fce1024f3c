"""RL-flywheel replay: one RLJob co-scheduled against the serving day;
the counterpart of ``kubedl_tpu/replay/rl.py``.

The end-to-end leg behind ``BENCH_RL.json`` (docs/rl.md): the EXACT
committed fleet day (:mod:`replay.fleet <kubedl_tpu.replay.fleet>`'s
``routing`` profile — same workload fingerprint, same engines, same
prefix-aware router, same SLO evaluator, same SimClock) with a real
:class:`~kubedl_tpu_torch.rl.RLFlywheel` riding it as the ``rollout`` tenant:

* rollout generations go through the replay's OWN router (dedicated
  low-priority queue via ``QueueSpec.tenants``; the fairness spill
  squeezes them off hot replicas during flash crowds), pinned to the
  freshest served policy version;
* the learner is a real :class:`~kubedl_tpu_torch.train.trainer
  .Trainer` on the SAME llama the engines serve, doing GRPO
  updates against a frozen reference, with ONE elastic resize
  (world ``learner_devices[0]`` -> ``[1]``) mid-job through the tiered
  checkpoint manager — the docs/elastic.md restart-free recipe. The
  worlds are capped at the process group's size, 1 without a group (the
  JAX replay caps them at its device count); at world 1 the resize is
  still the save -> remesh -> restore round trip;
* weight publishes roll through the :class:`~kubedl_tpu_torch.rl
  .WeightPublisher` between drains, one replica at a time, while user
  traffic keeps flowing. Each replica serves tensors of its own, which
  a publish overwrites in place (``load_weights``).

Span accounting is PARTITIONED: rollout-request spans divert off the
user-facing accumulators (``_filter_spans``) into their own harvester,
so the leg can gate user TTFT p99 against a no-RL baseline of the
identical day AND report the rollout tenant's own latency/throughput —
the two sides of the co-scheduling contract.

Rollouts sample at temperature 1, so the rewards and the losses depend
on the generator's draws; every other field of the observation is
scheduling, which the weights do not touch (fixed ``max_new``, no stop
token). The replay runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import tempfile
from dataclasses import asdict, dataclass

from ..api.queue import QueueSpec
from ..telemetry.slo import RequestSpanHarvester
from ..utils.stats import summarize
from .fleet import ServingFleetReplay, fleet_queues, generate_fleet


@dataclass(frozen=True)
class RLJobSpec:
    """One replayed RLJob — a pure value mirroring the CRD's
    ``spec.flywheel`` contract plus the replay-only knobs, fingerprinted
    with the fleet workload (bit-for-bit replayable)."""
    name: str = "grpo-tune"
    namespace: str = "rl"
    #: the fleet profile whose committed day the job rides
    fleet_profile: str = "routing"
    # -- spec.flywheel ----------------------------------------------------
    rollout_tenant: str = "rollout"
    rollout_floor_tokens_per_s: float = 1.0
    publish_every: int = 4
    # -- rollout shape ----------------------------------------------------
    group_size: int = 4
    prompts_per_batch: int = 2
    max_new_tokens: int = 8
    total_batches: int = 40
    #: pause between generations (sim seconds) — spreads the job across
    #: the day so it overlaps the bursts instead of finishing in the
    #: first quiet minute
    gen_interval_s: float = 20.0
    system_prompt_tokens: int = 24
    # -- learner ----------------------------------------------------------
    learning_rate: float = 1e-3
    #: elastic width: start world, post-resize world
    learner_devices: tuple = (8, 4)
    #: remesh after this many consumed batches (chosen off the publish
    #: cadence so the forced resize save never collides with a publish
    #: save at the same step)
    resize_after_batches: int = 9
    # -- observability ----------------------------------------------------
    observe_every_s: float = 60.0


def verifiable_reward(prompt, ids) -> float:
    """The replay's programmatic reward: fraction of completion tokens
    that are even — deterministic, prompt-independent, and varying
    within a temperature-1 group (nonzero advantages)."""
    if not ids:
        return 0.0
    return sum(1 for t in ids if t % 2 == 0) / len(ids)


def rl_prompts(spec: RLJobSpec, seed: int):
    """The job's prompt stream (namespaced rng, exactly the fleet-day
    convention): the pinned system prompt + per-batch prompt groups."""
    rng = random.Random(f"{seed}:rl:{spec.name}")
    system = [rng.randrange(1, 127)
              for _ in range(spec.system_prompt_tokens)]
    batches = [
        [[rng.randrange(1, 127) for _ in range(rng.randrange(4, 9))]
         for _ in range(spec.prompts_per_batch)]
        for _ in range(spec.total_batches)]
    return system, batches


class FlywheelReplay(ServingFleetReplay):
    """The committed fleet day + one RLJob on the shared SimClock.

    ``run()`` returns the base observation dict (user-facing — rollout
    spans diverted) plus an ``rl`` block with the flywheel's full
    status, rollout latency distributions, loss curve, and the
    publish/resize provenance the bench gates on."""

    def __init__(self, workload, spec: RLJobSpec = RLJobSpec(),
                 resize: bool = True, ckpt_dir: str = "", model=None,
                 device=None):
        import torch.distributed as dist

        from .._device import resolve_device
        from ..metrics.registry import RLMetrics
        from ..models import llama
        from ..parallel.mesh import MeshConfig, build_mesh
        from ..rl import RLFlywheel, RolloutClient, WeightPublisher
        from ..rl.learner import FlywheelLearner
        from ..train.checkpoint import (CheckpointConfig,
                                        TieredCheckpointManager)
        from ..train.grpo import GRPOConfig
        from ..train.trainer import TrainConfig, Trainer
        from .serving import _tiny_model

        # the learner trains the SAME weights the engines serve (the tiny
        # model unless ``model`` names another)
        device = resolve_device(device)
        cfg, params = model if model is not None else _tiny_model(device)
        super().__init__(workload, router="prefix", model=(cfg, params),
                         device=device)
        profile = workload.profile
        seed = workload.seed
        self.spec = spec
        # rebuild the router with the rollout tenant's DEDICATED queue
        # appended (same seed -> identical placement stream for user
        # traffic; the extra queue only routes the new tenant)
        from ..serving.router import PrefixAwareRouter
        self.router = PrefixAwareRouter(
            self.fleet, seed=seed,
            max_prefixes=profile.max_prefixes_per_replica,
            queues=fleet_queues(profile) + [
                QueueSpec(name="rollout", priority=-1,
                          tenants=(spec.rollout_tenant,))],
            metrics=self.metrics)

        # -- the RL stack -------------------------------------------------
        self._ckpt_tmp = None
        if not ckpt_dir:
            self._ckpt_tmp = tempfile.TemporaryDirectory(
                prefix="kubedl-rl-")
            ckpt_dir = self._ckpt_tmp.name
        self._mngr = TieredCheckpointManager(
            CheckpointConfig(os.path.join(ckpt_dir, "local"),
                             save_interval_steps=10 ** 9,
                             async_save=False),
            os.path.join(ckpt_dir, "object"))
        ndev = (dist.get_world_size()
                if dist.is_available() and dist.is_initialized() else 1)
        worlds = tuple(min(w, ndev) for w in spec.learner_devices)
        self._resize_world = worlds[1] if resize else None

        def make_mesh(world: int):
            return build_mesh(MeshConfig(dp=world), device=self.device)

        self._make_mesh = make_mesh
        gcfg = GRPOConfig(group_size=spec.group_size)
        trainer = Trainer(None,
                          TrainConfig(learning_rate=spec.learning_rate,
                                      warmup_steps=2, decay_steps=200),
                          param_specs=llama.param_specs(cfg),
                          mesh=make_mesh(worlds[0]))
        self.rl_metrics = RLMetrics(self.registry)
        self.learner = FlywheelLearner(
            cfg, trainer, params, grpo=gcfg, checkpoint=self._mngr,
            metrics=self.rl_metrics, job=spec.name)
        self.publisher = WeightPublisher(self.fleet,
                                         metrics=self.rl_metrics,
                                         job=spec.name)
        system, batches = rl_prompts(spec, seed)
        self._batches = batches
        self._next_batch = 0
        self._next_gen_at = 0.0
        self.rollouts = RolloutClient(
            self.router, verifiable_reward, cfg=gcfg,
            tenant=spec.rollout_tenant, system_prompt=system,
            max_new_tokens=spec.max_new_tokens)
        self.rollouts.pin_prefix()
        self.fly = RLFlywheel(
            spec.namespace, spec.name, self.rollouts, self.learner,
            self.publisher, self._feed_prompts,
            publish_every=spec.publish_every,
            rollout_floor_tokens_per_s=spec.rollout_floor_tokens_per_s,
            clock=self.clock, metrics=self.rl_metrics,
            tracer=self.tracer)

        # -- rollout-side accounting (diverted off the user SLO) ----------
        self._rl_traces: set = set()
        self._rl_harvester = RequestSpanHarvester(prune=False)
        self.rl_ttfts: list = []
        self.rl_queue_waits: list = []
        self.rl_completed = 0
        self.rl_errors = 0
        self.rl_gen_spans: list = []
        self._last_observe = 0.0
        self._resized_step = None
        self._resize_identical = None
        self._steps_seen: list = []

    def _replica_params(self, idx: int) -> dict:
        """Tensors of the replica's own: a publish copies the new version
        into the tensors one replica serves, while the others still
        serve (and advertise) the old one."""
        import torch

        from ..train.trainer import tree_map
        return tree_map(torch.clone, self._model[1])

    # -- the prompt stream ------------------------------------------------

    def _feed_prompts(self):
        """The flywheel's ``next_prompts``: one batch per generation
        interval until the job's budget is spent."""
        if self._next_batch >= len(self._batches):
            return None
        if self.clock.elapsed < self._next_gen_at:
            return None
        batch = self._batches[self._next_batch]
        self._next_batch += 1
        self._next_gen_at = self.clock.elapsed + self.spec.gen_interval_s
        return batch

    def _job_done(self) -> bool:
        return (self._next_batch >= len(self._batches)
                and not self.rollouts._reqs
                and self.publisher.idle
                and self.learner.batches_consumed
                >= self.spec.total_batches)

    # -- co-scheduling ----------------------------------------------------

    def _pump(self) -> None:
        """One flywheel reconcile inside the fleet tick: harvest / learn
        / publish / resubmit, plus the replay-owned resize trigger and
        rollout trace registration."""
        import torch

        from ..parallel.sharding import full_tensor
        from ..train.trainer import tree_leaves

        def host(tree) -> list:
            return [full_tensor(t).detach().cpu()
                    for _, t in tree_leaves(tree)]

        before = self.learner.batches_consumed
        self.fly.step(self.clock.elapsed)
        reqs = self.rollouts._reqs
        if reqs and reqs[0].trace_id not in self._rl_traces:
            for r in reqs:
                if r.trace_id:
                    self._rl_traces.add(r.trace_id)
        if self.learner.batches_consumed > before:
            self._steps_seen.append(int(self.learner.state.step))
        if (self._resize_world is not None
                and self.learner.resizes == 0
                and self.learner.batches_consumed
                >= self.spec.resize_after_batches):
            # the restart-free elastic resize (docs/elastic.md): forced
            # save -> remesh -> restore onto the new mesh's shardings.
            # Params gathered before/after must match bit-for-bit —
            # that IS loss-curve continuity, no tolerance needed.
            before_p = host(self.learner.state.params)
            self.learner.remesh(self._make_mesh(self._resize_world))
            after_p = host(self.learner.state.params)
            self._resize_identical = len(before_p) == len(after_p) and all(
                torch.equal(a, b) for a, b in zip(before_p, after_p))
            self._resized_step = int(self.learner.state.step)

    def _step_fleet(self) -> None:
        self._pump()
        super()._step_fleet()

    def _filter_spans(self, spans: list) -> list:
        """Divert rollout-request spans (and the flywheel's own
        ``rl.rollout`` generation spans) off the user accumulators."""
        user, rl = [], []
        for s in spans:
            if s.name == "rl.rollout":
                self.rl_gen_spans.append(round(s.duration, 6))
            elif s.trace_id in self._rl_traces:
                rl.append(s)
            else:
                user.append(s)
        if rl:
            for signal, value, _t in self._rl_harvester.feed(rl):
                if signal == "ttft":
                    self.rl_ttfts.append(value)
            for s in rl:
                if s.name == "request.queue":
                    self.rl_queue_waits.append(s.duration)
                elif s.name == "serving.request":
                    self.rl_completed += 1
                    if s.status != "ok":
                        self.rl_errors += 1
        return user

    def _drain(self) -> None:
        super()._drain()
        now = self.clock.elapsed
        if not self._job_done() and \
                now - self._last_observe >= self.spec.observe_every_s:
            self.fly.observe(now)
            self._last_observe = now

    # -- the day ----------------------------------------------------------

    def run(self) -> dict:
        try:
            res = super().run()
            # post-day continuation: the arrival loop exits once user
            # traffic drains; let the flywheel finish its remaining
            # budget (bounded — sim time only)
            profile = self.workload.profile
            deadline = self.clock.elapsed + 3600.0
            while not self._job_done() \
                    and self.clock.elapsed < deadline:
                self.clock.advance(profile.tick_s)
                self._step_fleet()
                self.ticks += 1
                if self.ticks % profile.drain_every == 0:
                    self._drain()
            self._drain()
            self.fly.observe(self.clock.elapsed)
            res["engine_ticks"] = self.ticks
            res["sim_span_s"] = round(self.clock.elapsed, 1)
            res["rl"] = self._rl_block()
            return res
        finally:
            self._mngr.close()
            if self._ckpt_tmp is not None:
                self._ckpt_tmp.cleanup()
                self._ckpt_tmp = None

    def _rl_block(self) -> dict:
        monotonic = all(b > a for a, b in zip(self._steps_seen,
                                              self._steps_seen[1:]))
        gen_s = sum(self.rl_gen_spans)
        status = self.fly.status()
        return {
            "job": self.spec.name,
            "spec": {
                "rolloutTenant": self.spec.rollout_tenant,
                "rolloutFloorTokensPerSecond":
                    self.spec.rollout_floor_tokens_per_s,
                "publishEvery": self.spec.publish_every,
                "groupSize": self.spec.group_size,
                "totalBatches": self.spec.total_batches,
            },
            "batches_consumed": self.learner.batches_consumed,
            "job_complete": int(self._job_done()),
            "policy_version": self.learner.version,
            "serving_versions": status["servingVersions"],
            "publishes": self.publisher.publishes,
            "replicas_rolled": self.publisher.replicas_rolled,
            "staleness_max": self.learner.staleness_max,
            "rollout_tokens": self.rollouts.tokens_total,
            "rollout_completed": self.rl_completed,
            "rollout_errors": self.rl_errors,
            "rollout_dropped": sum(
                1 for r in self.rollouts._reqs
                if r.done.is_set() and r.cancelled),
            "rollout_gen_s_total": round(gen_s, 3),
            #: the floor's numerator/denominator: harvested completion
            #: tokens over the time generations were actually open
            "rollout_tokens_per_gen_s": round(
                self.rollouts.tokens_total / gen_s, 4) if gen_s else 0.0,
            "floor_violations": self.fly.floor_violations,
            "tenant_spills": self.router.tenant_spills,
            "rollout_ttft_s": summarize(
                self.rl_ttfts, percentiles=(0.5, 0.99), ndigits=3),
            "rollout_queue_s": summarize(
                self.rl_queue_waits, percentiles=(0.5, 0.99), ndigits=3),
            "losses": [round(x, 6) for x in self.learner.losses],
            "loss_finite": int(all(x == x and abs(x) != float("inf")
                                   for x in self.learner.losses)),
            "step_monotonic": int(monotonic),
            "final_step": int(self.learner.state.step),
            "elastic_resizes": self.learner.resizes,
            "resize_at_step": self._resized_step,
            "resize_restore_bit_identical":
                int(bool(self._resize_identical))
                if self._resize_identical is not None else None,
        }


def run_flywheel_leg(seed: int = 0,
                     spec: RLJobSpec = RLJobSpec(), device=None) -> dict:
    """Baseline (no RL) vs flywheel on the IDENTICAL fleet day — the
    body of BENCH_RL.json's ``flywheel`` block."""
    wl = generate_fleet(spec.fleet_profile, seed)
    base = ServingFleetReplay(generate_fleet(spec.fleet_profile, seed),
                              router="prefix", device=device).run()
    fly = FlywheelReplay(wl, spec=spec, device=device).run()

    def _user(res: dict) -> dict:
        return {
            "requests_completed": res["requests_completed"],
            "dropped_streams": res["dropped_streams"],
            "errors": res["errors"],
            "ttft_s": summarize(res["ttfts_s"],
                                percentiles=(0.5, 0.9, 0.99), ndigits=3),
            "queue_s": summarize(res["queue_waits_s"],
                                 percentiles=(0.5, 0.99), ndigits=3),
            "tokens_generated": res["tokens_generated"],
        }

    base_p99 = _user(base)["ttft_s"]["p99"] or 0.0
    fly_p99 = _user(fly)["ttft_s"]["p99"] or 0.0
    doc = {"spec": asdict(spec), "seed": seed,
           "fingerprint": wl.fingerprint()}
    fp = hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()
    return {
        "seed": seed,
        "workload_fingerprint": wl.fingerprint(),
        "rl_fingerprint": fp,
        "baseline": _user(base),
        "with_rl": _user(fly),
        "ttft_p99_ratio": round(fly_p99 / base_p99, 4)
        if base_p99 else None,
        "rl": fly["rl"],
        "slo": fly["slo"],
        "slo_health": fly["slo_health"],
    }
