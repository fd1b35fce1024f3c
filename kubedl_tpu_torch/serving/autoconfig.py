"""Morphling-style serving auto-configuration.

The reference README points serving users at Morphling ("auto-configuration
for ML model serving", ACM SoCC 2021, ``README.md:33-35``) — a search over
a multi-dimensional serving-config space that maximizes throughput under
SLOs. This is the in-process version, searching the knobs the serving
stack actually has:

* **lane count / batch** — continuous-batching lanes (device memory for
  cache rows);
* **int8 / int4 weight quantization** — halves (or quarters) the weight
  bytes, changes outputs (excluded when the SLO pins quality; pass
  ``quantize_opts=(None, "int8", "int4")`` to search all three);
* **speculative decoding draft length k** — trades draft FLOPs for
  target-pass amortization; greedy-identical to the serving engine's own
  outputs, so it is quality-safe;

under a **p99 per-token latency SLO** and a **time-to-first-token SLO**
(TTFT is what streaming clients feel; serving/server.py streams tokens,
so the first event lands one prefill after the request).

Probes run against live engines (one warm-up + a short measured run per
candidate). Used two ways: offline (pick flags before rollout) and via the
Inference CR annotation ``serving.kubedl.io/autoconfig``, whose chosen
config the operator renders into the predictor env that
``serving/__main__.py`` reads.

Copied from ``kubedl_tpu/serving/autoconfig.py`` (the port imports nothing
of the JAX package), statement for statement, with one addition and one
repair. The addition: ``probe_candidate`` and ``autoconfigure_multi`` take
``device=`` (the card unless the caller names the CPU) and hand it to the
engines they build; ``autoconfigure`` uses the engine it is given. The
repair is ``probe_candidate``'s repeat loop: JAX's times a short and a
long run of the batch apart and clamps a repeat whose long run came in no
longer than its short one to 1e-9 s, which reads as near-infinite
throughput and wins the search. Here a repeat's short run is the start of
its long run, a repeat whose long run is not longer is measured again (at
most ``REMEASURES`` times) and is never a sample, and a probe left with no
sample raises. The choice depends on the hardware: on the card the cost
of int8 against bf16 is measured, not assumed. Every scheduler step ends
with its tokens on the host, so the wall clock needs no extra sync; on
the speculative lanes the last round's draft backfill tick is queued
after the last read-back, so its time lands in the next run's admitting
step, before that run's difference.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from .engine import InferenceEngine

#: how many times ``probe_candidate`` measures a repeat again whose long
#: run came in no longer than its short one: such a repeat holds no
#: decode time
REMEASURES = 3


@dataclass
class AutoConfigResult:
    best_batch: int
    measurements: list = field(default_factory=list)
    slo_ms: float = 0.0

    def to_dict(self) -> dict:
        return {"bestBatch": self.best_batch, "sloMs": self.slo_ms,
                "measurements": self.measurements}


def autoconfigure(engine: InferenceEngine,
                  batch_candidates: Sequence[int] = (1, 2, 4, 8, 16),
                  prompt_len: int = 128, new_tokens: int = 16,
                  latency_slo_ms: Optional[float] = None) -> AutoConfigResult:
    """Single-dimension (batch) search against a live engine; the
    original API, kept for offline probing of one engine instance. See
    :func:`autoconfigure_multi` for the full config space."""
    measurements = []
    best, best_tps = 0, -1.0
    prev_tps = -1.0
    for batch in batch_candidates:
        probe = engine.score_throughput(batch, prompt_len, new_tokens)
        measurements.append(probe)
        tps = probe["decode_tokens_per_s"]
        ok = (latency_slo_ms is None
              or probe["latency_per_token_ms"] <= latency_slo_ms)
        if ok and tps > best_tps:
            best, best_tps = batch, tps
        if prev_tps > 0 and tps < prev_tps * 0.9:
            break  # past saturation
        prev_tps = tps
    if best == 0:  # nothing met the SLO: smallest batch is closest
        best = batch_candidates[0]
    return AutoConfigResult(best_batch=best, measurements=measurements,
                            slo_ms=latency_slo_ms or 0.0)


# ---------------------------------------------------------------------------
# multi-dimensional search (VERDICT r3 next #6)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Candidate:
    """One point in the serving-config space."""
    batch: int = 1                    # continuous-batching lanes
    quantize: Optional[str] = None    # target weights: None|"int8"|"int4"
    speculative_k: int = 0            # 0 = off; >0 = draft lookahead
    #: paged-KV block size in tokens (0 = engine default); the pool is
    #: the HBM knob — smaller pools admit fewer concurrent prompts,
    #: bigger ones trade weight/activation headroom for cache
    kv_block: int = 0
    #: usable pool blocks (0 = lanes * ceil(max_len/block), the
    #: dense-capacity default — no overcommit)
    pool_blocks: int = 0

    def to_env(self) -> dict:
        """Env contract the predictor container reads at startup."""
        return {
            "KUBEDL_SERVING_LANES": str(self.batch),
            "KUBEDL_SERVING_QUANTIZE": self.quantize or "",
            "KUBEDL_SERVING_SPEC_K": str(self.speculative_k),
            "KUBEDL_SERVING_KV_BLOCK": str(self.kv_block),
            "KUBEDL_SERVING_POOL_BLOCKS": str(self.pool_blocks),
        }


def kv_cache_bytes(config, cand: Candidate, max_len: int) -> int:
    """The candidate's KV-cache HBM footprint. Paged serving is sized in
    BLOCKS, not ``lanes * max_len``: the pool (plus its one garbage
    block) is the allocation, however many lanes share it — that is the
    whole point of paging, lanes stop being an HBM commitment. Dense
    sizing (kv_block == 0 with no pool) falls out as the
    no-overcommit case."""
    from .batching import fit_block
    from .engine import kv_bytes_per_token
    block = fit_block(cand.kv_block or 64, max_len)
    bpl = max_len // block
    blocks = (cand.pool_blocks or cand.batch * bpl) + 1
    return blocks * block * kv_bytes_per_token(config)


@dataclass(frozen=True)
class ServingSLO:
    """Constraints the chosen config must honor.

    ``pinned_quality`` forbids target-weight quantization (int8 changes
    sampled outputs). Speculative decoding stays allowed: greedy
    acceptance is token-identical to the target engine's own decode."""
    p99_latency_ms: Optional[float] = None   # per generated token
    ttft_ms: Optional[float] = None          # time to first token
    pinned_quality: bool = False

    def allows(self, cand: Candidate) -> bool:
        return not (self.pinned_quality and cand.quantize)

    def met_by(self, probe: dict) -> bool:
        if self.p99_latency_ms is not None and \
                probe["p99_latency_ms"] > self.p99_latency_ms:
            return False
        if self.ttft_ms is not None and probe["ttft_ms"] > self.ttft_ms:
            return False
        return True

    def violation(self, probe: dict) -> float:
        """Relative overshoot, for picking the least-bad config when
        nothing satisfies the SLO."""
        v = 0.0
        if self.p99_latency_ms:
            v += max(0.0, probe["p99_latency_ms"] / self.p99_latency_ms - 1)
        if self.ttft_ms:
            v += max(0.0, probe["ttft_ms"] / self.ttft_ms - 1)
        return v


@dataclass
class MultiConfigResult:
    best: Candidate
    best_probe: dict
    measurements: list = field(default_factory=list)
    slo: Optional[ServingSLO] = None

    def to_dict(self) -> dict:
        return {"best": {"batch": self.best.batch,
                         "quantize": self.best.quantize,
                         "speculativeK": self.best.speculative_k,
                         "kvBlock": self.best.kv_block,
                         "poolBlocks": self.best.pool_blocks},
                "probe": self.best_probe,
                "measurements": self.measurements}

    def to_env(self) -> dict:
        return self.best.to_env()


def probe_candidate(model, cand: Candidate, prompt_len: int = 64,
                    new_tokens: int = 16, max_len: int = 0,
                    draft=None, repeats: int = 3,
                    device=None) -> Optional[dict]:
    """Measure one candidate on live engines.

    Three SLO-relevant numbers, each isolated from the others so the
    search compares what clients actually feel:

    * ``ttft_ms`` — ONE request's prefill + first token (what a
      streaming client waits before its first SSE event), never a whole
      batch of sequential prefills;
    * ``p50/p99_latency_ms`` — steady-state decode time per token,
      obtained by DIFFERENCING a short and a long run of the same batch
      (both pay identical prefills, so the prefill cost cancels instead
      of biasing large batches);
    * ``decode_tokens_per_s`` — batch / best per-token time (all lanes
      decode one token per tick).

    A repeat's short run is its long run up to the step after which
    every lane holds ``lo`` tokens, so the two share their prefills (two
    separate runs do not: on the card their host-bound prefills drift
    apart by more than the decode between them). A repeat whose long run
    is not longer than its short one is
    measured again, at most ``REMEASURES`` times, and gives no sample if
    it never is; a probe with no sample at all raises ``RuntimeError``
    naming the candidate and every (short, long) reading.

    Returns None when the candidate is unbuildable (speculative without
    a draft model). The engines run on ``device``: the card unless the
    caller names the CPU."""
    import numpy as np

    if new_tokens < 4:
        # the short/long differencing needs hi > lo by a real margin:
        # with new_tokens <= lo both runs are identical and the "decode
        # time" is clamped timing noise (absurd tps, ~0 latency)
        raise ValueError("probe_candidate needs new_tokens >= 4")
    cfg, params = model
    max_len = max_len or prompt_len + new_tokens + 8
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, cfg.vocab_size, prompt_len).tolist()

    from .batching import ContinuousBatchingEngine
    kv = {}
    if cand.kv_block:
        kv["kv_block"] = cand.kv_block
    if cand.pool_blocks:
        kv["pool_blocks"] = cand.pool_blocks
    if cand.speculative_k > 0:
        if draft is None:
            return None  # speculative points need a draft model
        # the production shape: speculative decoding ON the
        # continuous-batching lanes, so the draft-k dimension is measured
        # with concurrent lanes — exactly what the predictor deploys
        eng = ContinuousBatchingEngine(
            cfg, params, lanes=cand.batch, max_len=max_len,
            quantize=cand.quantize, draft_config=draft[0],
            draft_params=draft[1], spec_k=cand.speculative_k,
            device=device, **kv)
    else:
        eng = ContinuousBatchingEngine(cfg, params, lanes=cand.batch,
                                       max_len=max_len,
                                       quantize=cand.quantize,
                                       device=device, **kv)

    def gen(n):
        return eng.run([(prompt, n)] * cand.batch)

    def gen_one(n):
        return eng.run([(prompt, n)])

    lo, hi = min(2, new_tokens), new_tokens
    gen_one(1)                     # compile prefill + first decode shape
    gen(lo)                        # compile the steady decode tick
    t0 = time.perf_counter()
    gen_one(1)
    ttft = time.perf_counter() - t0

    samples, readings = [], []
    for _ in range(repeats):
        for _ in range(1 + REMEASURES):
            t0 = time.perf_counter()
            reqs = [eng.submit(prompt, hi) for _ in range(cand.batch)]
            d_lo = None
            while eng.step():
                if d_lo is None and all(len(r.tokens) >= lo for r in reqs):
                    d_lo = time.perf_counter() - t0
            for r in reqs:
                r.result()
            d_hi = time.perf_counter() - t0
            readings.append((d_lo, d_hi))
            if d_hi > d_lo:
                # one run, its prefills before d_lo: the rest is decode
                samples.append((d_hi - d_lo) / max(hi - lo, 1))
                break
    if not samples:
        raise RuntimeError(
            f"probe_candidate: {cand}: no {hi}-token run took longer than "
            f"its first {lo} tokens in {len(readings)} attempts; "
            f"(short, long) seconds: {readings}")
    tps = cand.batch / min(samples)
    return {
        "batch": cand.batch, "quantize": cand.quantize or "",
        "speculative_k": cand.speculative_k,
        "kv_block": cand.kv_block, "pool_blocks": cand.pool_blocks,
        "decode_tokens_per_s": round(tps, 2),
        "p50_latency_ms": round(
            1000 * sorted(samples)[len(samples) // 2], 3),
        "p99_latency_ms": round(1000 * max(samples), 3),
        "ttft_ms": round(1000 * ttft, 3),
    }


def autoconfigure_multi(
        model=None, draft=None,
        batches: Sequence[int] = (1, 2, 4, 8),
        quantize_opts: Sequence[Optional[str]] = (None, "int8"),
        spec_ks: Sequence[int] = (0, 4),
        kv_blocks: Sequence[int] = (0,),
        prompt_len: int = 64, new_tokens: int = 16,
        slo: Optional[ServingSLO] = None,
        measure: Optional[Callable[[Candidate], Optional[dict]]] = None,
        hbm_budget_bytes: Optional[int] = None,
        max_len: int = 0,
        device=None,
) -> MultiConfigResult:
    """Search {batch x int8 x speculative-k x kv-block} under the SLO.

    ``measure`` defaults to :func:`probe_candidate` over live engines
    built from ``model``/``draft``; tests (and remote probers) may inject
    their own. Within each (quantize, k, block) family the batch
    dimension keeps Morphling's unimodal early-stop: once throughput
    drops well below the family's best, bigger batches only add latency.
    ``hbm_budget_bytes`` prunes candidates whose KV footprint exceeds
    the cache budget BEFORE probing — and the footprint is the
    block-pool model (:func:`kv_cache_bytes`), not ``lanes * max_len``:
    under paging, big lane counts stay searchable as long as the pool
    fits, which is exactly where the paged engine wins. Selection: the
    highest-throughput candidate meeting the SLO; if none do, the
    least-violating one (Morphling's nearest-feasible fallback).
    ``device`` reaches the default measure's engines (the card unless the
    caller names the CPU)."""
    slo = slo or ServingSLO()
    if hbm_budget_bytes is not None and model is None:
        # the budget prunes via kv_cache_bytes(model[0], ...): without a
        # model config it would be silently ignored and over-budget
        # candidates could win — refuse loudly instead
        raise ValueError(
            "hbm_budget_bytes needs a (config, params) model to price "
            "candidates (pass model= even with a custom measure fn)")
    if measure is None:
        if model is None:
            raise ValueError("need a (config, params) model or a measure fn")
        measure = lambda c: probe_candidate(        # noqa: E731
            model, c, prompt_len=prompt_len, new_tokens=new_tokens,
            max_len=max_len, draft=draft, device=device)
    budget_len = max_len or prompt_len + new_tokens + 8

    measurements = []
    best: Optional[Candidate] = None
    best_probe: Optional[dict] = None
    fallback, fb_probe, fb_viol = None, None, math.inf
    for q in quantize_opts:
        for k in spec_ks:
            for blk in kv_blocks:
                family_best = -1.0
                for b in batches:
                    cand = Candidate(batch=b, quantize=q, speculative_k=k,
                                     kv_block=blk)
                    if not slo.allows(cand):
                        continue
                    if hbm_budget_bytes is not None \
                            and kv_cache_bytes(model[0], cand,
                                               budget_len) > hbm_budget_bytes:
                        continue   # cache alone busts the HBM budget
                    probe = measure(cand)
                    if probe is None:
                        continue   # unbuildable (no draft, multi-lane k)
                    measurements.append(probe)
                    tps = probe["decode_tokens_per_s"]
                    if slo.met_by(probe):
                        if best_probe is None or \
                                tps > best_probe["decode_tokens_per_s"]:
                            best, best_probe = cand, probe
                    else:
                        v = slo.violation(probe)
                        if v < fb_viol:
                            fallback, fb_probe, fb_viol = cand, probe, v
                    if family_best > 0 and tps < family_best * 0.9:
                        break   # past saturation in this family
                    family_best = max(family_best, tps)
    if best is None:
        # nothing met the SLO: surface the least-bad config rather than
        # guessing (the caller sees the probe and the violation)
        best, best_probe = fallback, fb_probe
    if best is None:
        raise ValueError("no buildable candidate in the search space")
    return MultiConfigResult(best=best, best_probe=best_probe,
                             measurements=measurements, slo=slo)
