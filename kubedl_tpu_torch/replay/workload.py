"""Seeded workload generator for the cluster replay (no wall clock).

Everything here is a pure function of ``(profile, seed)``: a
production-shaped day of training-job arrivals (diurnal rate with
arrival bursts, mixed single-/multislice gangs across tenant queues and
two TPU pools, scripted chaos preemptions) plus a serving-request stream
whose prompts share system-prompt-style prefixes with Zipf-distributed
popularity. The generators draw from namespaced ``random.Random``
streams only — no ``time``, no ``os.urandom`` — so the same inputs
produce the identical workload on any machine, which is what makes the
scorecard's bit-for-bit reproducibility contract possible.

Copied from ``kubedl_tpu/replay/workload.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import hashlib
import json
import math
import random
from dataclasses import asdict, dataclass, field
from typing import Optional

#: the two fleet pools (same naming as the scheduler inventory):
#: pool label -> (acceleratorType for the job spec, worker pods per slice)
POOL_V5P = "tpu-v5p-slice/2x2x4"
POOL_V5E = "tpu-v5-lite-podslice/4x4"
POOL_ACCELERATOR = {POOL_V5P: "v5p-32", POOL_V5E: "v5e-16"}
HOSTS_PER_SLICE = {POOL_V5P: 4, POOL_V5E: 4}

#: fleet economics for the scorecard's placement block (docs/scheduling.md
#: "Placement scoring"): $/chip-hour per pool, and which pools are the
#: spot/preemptible class. Module constants, NOT Profile fields — the
#: workload fingerprint (asdict(profile)) must not change under feet of
#: the committed scorecards.
POOL_COSTS = {POOL_V5P: 4.2, POOL_V5E: 1.2}
POOL_SPOT = frozenset({POOL_V5E})
#: chips per slice (cost weighting: $/chip-hour x chips x hours)
POOL_CHIPS = {POOL_V5P: 16, POOL_V5E: 16}


@dataclass(frozen=True)
class Profile:
    """One replay scale. ``smoke`` rides tier-1 (seconds, op-budgeted);
    ``day`` is the ``make bench-cluster`` fleet proof."""
    name: str
    # -- job day --------------------------------------------------------
    sim_seconds: float            # the arrival window (the day)
    jobs: int
    job_bursts: int               # arrival-burst windows inside the day
    burst_frac: float             # fraction of jobs arriving in bursts
    chaos_preemptions: int        # scripted node preemptions of running jobs
    capacity: dict = field(default_factory=dict)   # pool -> slices
    pod_start_s: float = 12.0     # kubelet admit+pull latency per round
    retire_after_s: float = 900.0  # succeeded job -> deletion (world bound)
    duration_mean_s: float = 1500.0
    trace_capacity: int = 131072
    sample_traces: int = 64       # jobs whose full trace is well-formed-checked
    # chaos fault rates (ChaosAPIServer, operator-facing writes)
    chaos_conflict: float = 0.03
    chaos_create_error: float = 0.02
    chaos_drop_watch: float = 0.01
    chaos_max_faults: Optional[int] = None
    # -- serving day ----------------------------------------------------
    serving_requests: int = 0
    serving_bursts: int = 0
    serving_burst_frac: float = 0.85
    lanes: int = 16
    max_len: int = 64
    kv_block: int = 8
    pool_blocks: int = 96         # overcommitted vs lanes*max_len/kv_block
    prefixes: int = 10            # registered shared prefixes (Zipf ranks)
    prefix_share: float = 0.75    # fraction of requests hitting a prefix
    tick_s: float = 0.05          # simulated cost of one engine tick
    serving_trace_capacity: int = 32768


PROFILES = {
    # tier-1 scale: real stack end to end, seconds of wall time, budgets
    # asserted on op counts (never wall clocks)
    "smoke": Profile(
        name="smoke", sim_seconds=3 * 3600.0, jobs=120, job_bursts=3,
        burst_frac=0.4, chaos_preemptions=4,
        capacity={POOL_V5P: 8, POOL_V5E: 12},
        duration_mean_s=1200.0, trace_capacity=32768, sample_traces=16,
        chaos_max_faults=40,
        serving_requests=300, serving_bursts=4, lanes=8,
        pool_blocks=48, prefixes=6, serving_trace_capacity=16384),
    # the fleet proof: >= 2,000 jobs and >= 50,000 serving requests
    "day": Profile(
        name="day", sim_seconds=86400.0, jobs=2200, job_bursts=10,
        burst_frac=0.45, chaos_preemptions=60,
        capacity={POOL_V5P: 24, POOL_V5E: 40},
        duration_mean_s=1500.0, trace_capacity=131072, sample_traces=64,
        chaos_max_faults=600,
        serving_requests=52000, serving_bursts=140, lanes=16,
        pool_blocks=96, prefixes=10, serving_trace_capacity=32768),
    # the chaos-campaign leg (docs/chaos.md): a moderate job day whose
    # ONLY preemptions come from the campaign's correlated primitives
    # (chaos_preemptions=0 keeps attribution exact) and whose background
    # fault rates stay low so the storm windows dominate the signal; no
    # serving leg — the campaign targets the job control plane
    "adversarial": Profile(
        name="adversarial", sim_seconds=6 * 3600.0, jobs=260,
        job_bursts=5, burst_frac=0.40, chaos_preemptions=0,
        capacity={POOL_V5P: 12, POOL_V5E: 16},
        duration_mean_s=1200.0, trace_capacity=65536, sample_traces=32,
        chaos_conflict=0.02, chaos_create_error=0.01,
        chaos_drop_watch=0.0, chaos_max_faults=200,
        serving_requests=0, serving_bursts=0),
    # the concurrency-elastic leg (docs/elastic.md): a small, chaos-free
    # job day for the shrink-vs-evict comparison — the `spot-shrink`
    # campaign halves the spot pool's capacity mid-day; the ONLY
    # disruption is that capacity drop, so shrink/regrow attribution and
    # the full-restart baseline comparison are exact. No serving leg.
    "elastic": Profile(
        name="elastic", sim_seconds=3 * 3600.0, jobs=48, job_bursts=2,
        burst_frac=0.35, chaos_preemptions=0,
        capacity={POOL_V5P: 8, POOL_V5E: 12},
        duration_mean_s=2400.0, trace_capacity=32768, sample_traces=16,
        chaos_conflict=0.0, chaos_create_error=0.0,
        chaos_drop_watch=0.0, chaos_max_faults=0,
        serving_requests=0, serving_bursts=0),
    # the multi-region leg (docs/federation.md): ONE global job day the
    # federation layer routes across N regions (each region runs this
    # profile's capacity), plus a modest serving day whose streams the
    # cross-region catalog partitions. Chaos-free background — the only
    # disruption is the `region-evacuation` campaign's region death, so
    # evacuation attribution and the zero-loss audit are exact. Long
    # mean durations keep jobs running at the mid-day kill.
    "federation": Profile(
        name="federation", sim_seconds=4 * 3600.0, jobs=24,
        job_bursts=2, burst_frac=0.35, chaos_preemptions=0,
        capacity={POOL_V5P: 6, POOL_V5E: 8},
        duration_mean_s=3600.0, trace_capacity=32768, sample_traces=8,
        chaos_conflict=0.0, chaos_create_error=0.0,
        chaos_drop_watch=0.0, chaos_max_faults=0,
        serving_requests=60, serving_bursts=3, lanes=4,
        max_len=64, pool_blocks=48, prefixes=6,
        serving_trace_capacity=16384),
}

#: tenant queues: prod is guaranteed, batch partially, best borrows only
QUEUES = (
    {"name": "prod", "min": 10, "max": None, "priority": 100},
    {"name": "batch", "min": 6, "max": None, "priority": 10},
    {"name": "best", "min": 0, "max": None, "priority": 0},
)
_QUEUE_WEIGHTS = (("prod", 0.30), ("batch", 0.45), ("best", 0.25))
_POOL_WEIGHTS = ((POOL_V5P, 0.40), (POOL_V5E, 0.60))
_SLICE_WEIGHTS = ((1, 0.82), (2, 0.15), (4, 0.03))


@dataclass(frozen=True)
class JobArrival:
    arrival_s: float
    name: str
    queue: str
    pool: str
    num_slices: int
    duration_s: float


@dataclass(frozen=True)
class ChaosPreemption:
    """Scripted node preemption at ``time_s``: the harness picks the
    ``ordinal``-th currently-running job (sorted by name — deterministic)
    and preempts one of its pods."""
    time_s: float
    ordinal: int


@dataclass(frozen=True)
class ServingArrival:
    arrival_s: float
    prompt: tuple
    max_new: int
    prefix_rank: int              # -1 = no shared prefix


@dataclass(frozen=True)
class Workload:
    profile: Profile
    seed: int
    jobs: tuple                   # JobArrival, arrival-sorted
    preemptions: tuple            # ChaosPreemption, time-sorted
    serving: tuple                # ServingArrival, arrival-sorted
    serving_prefixes: tuple       # tuple of token tuples, rank order

    def fingerprint(self) -> str:
        """sha256 over the canonical JSON rendering — the determinism
        probe (same (profile, seed) must reproduce it bit-for-bit)."""
        doc = {
            "profile": asdict(self.profile), "seed": self.seed,
            "jobs": [asdict(j) for j in self.jobs],
            "preemptions": [asdict(p) for p in self.preemptions],
            "serving": [asdict(s) for s in self.serving],
            "prefixes": [list(p) for p in self.serving_prefixes],
        }
        blob = json.dumps(doc, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


def _pick(rng: random.Random, weighted) -> object:
    r = rng.random()
    acc = 0.0
    for value, w in weighted:
        acc += w
        if r < acc:
            return value
    return weighted[-1][0]


def _diurnal_rate(t: float, day: float) -> float:
    """Two-peak daily arrival intensity in (0, 1] — the classic
    morning/evening shape production job traces show."""
    x = t / day
    return 0.35 + 0.65 * math.sin(math.pi * x * 2) ** 2


def _burst_windows(rng: random.Random, n: int, day: float,
                   width_lo: float, width_hi: float) -> list:
    return sorted((rng.uniform(0.05, 0.85) * day,
                   rng.uniform(width_lo, width_hi)) for _ in range(n))


def generate_jobs(profile: Profile, seed: int) -> tuple:
    rng = random.Random(f"{seed}:jobs")
    day = profile.sim_seconds
    bursts = _burst_windows(rng, profile.job_bursts, day, 60.0, 600.0)
    out = []
    for i in range(profile.jobs):
        if bursts and rng.random() < profile.burst_frac:
            t0, width = bursts[rng.randrange(len(bursts))]
            arrival = min(t0 + rng.uniform(0.0, width), day - 1.0)
        else:
            # rejection-sample the diurnal intensity (deterministic: the
            # rng stream is the only state)
            while True:
                arrival = rng.uniform(0.0, day)
                if rng.random() < _diurnal_rate(arrival, day):
                    break
        queue = _pick(rng, _QUEUE_WEIGHTS)
        pool = _pick(rng, _POOL_WEIGHTS)
        slices = _pick(rng, _SLICE_WEIGHTS)
        # lognormal-ish mixed durations, clipped to keep the tail finite
        dur = rng.lognormvariate(
            math.log(profile.duration_mean_s) - 0.32, 0.8)
        dur = max(120.0, min(dur, 4.0 * profile.duration_mean_s))
        out.append(JobArrival(
            arrival_s=round(arrival, 3), name=f"rj-{i:05d}", queue=queue,
            pool=pool, num_slices=slices, duration_s=round(dur, 1)))
    return tuple(sorted(out, key=lambda j: (j.arrival_s, j.name)))


def generate_preemptions(profile: Profile, seed: int) -> tuple:
    rng = random.Random(f"{seed}:chaos")
    day = profile.sim_seconds
    out = [ChaosPreemption(time_s=round(rng.uniform(0.10, 0.90) * day, 3),
                           ordinal=rng.randrange(1 << 16))
           for _ in range(profile.chaos_preemptions)]
    return tuple(sorted(out, key=lambda p: p.time_s))


def _zipf_weights(n: int, s: float = 1.1) -> list:
    w = [1.0 / (r + 1) ** s for r in range(n)]
    total = sum(w)
    return [x / total for x in w]


def generate_serving(profile: Profile, seed: int) -> tuple:
    """(arrivals, prefixes). Prompt tokens are in [1, 126] (the tiny
    bench vocabulary); prompts+max_new always fit ``max_len``."""
    rng = random.Random(f"{seed}:serving")
    day = profile.sim_seconds
    prefixes = tuple(
        tuple(rng.randrange(1, 127)
              for _ in range(rng.randrange(20, 33)))
        for _ in range(profile.prefixes))
    zipf = list(zip(range(profile.prefixes),
                    _zipf_weights(profile.prefixes)))
    # flash crowds: burst windows are SECONDS wide, so arrival rate
    # inside a burst exceeds the engine's drain rate and real queues
    # form — a TTFT p99 with room to move, not one tick
    bursts = _burst_windows(rng, profile.serving_bursts, day, 2.0, 15.0)
    out = []
    for _ in range(profile.serving_requests):
        if bursts and rng.random() < profile.serving_burst_frac:
            t0, width = bursts[rng.randrange(len(bursts))]
            arrival = min(t0 + rng.uniform(0.0, width), day - 1.0)
        else:
            arrival = rng.uniform(0.0, day)
        if rng.random() < profile.prefix_share:
            rank = _pick(rng, zipf)
            body = list(prefixes[rank])
        else:
            rank = -1
            body = [rng.randrange(1, 127)
                    for _ in range(rng.randrange(4, 17))]
        suffix = [rng.randrange(1, 127)
                  for _ in range(rng.randrange(3, 13))]
        prompt = tuple(body + suffix)
        max_new = rng.randrange(3, 11)
        # hard guarantee: every request fits the cache
        room = profile.max_len - 1 - len(prompt)
        max_new = max(1, min(max_new, room))
        out.append(ServingArrival(arrival_s=round(arrival, 3),
                                  prompt=prompt, max_new=max_new,
                                  prefix_rank=rank))
    arrivals = tuple(sorted(out, key=lambda s: s.arrival_s))
    return arrivals, prefixes


def generate(profile: Profile | str, seed: int = 0) -> Workload:
    """The whole day, reproducibly."""
    if isinstance(profile, str):
        profile = PROFILES[profile]
    serving, prefixes = generate_serving(profile, seed)
    return Workload(
        profile=profile, seed=seed,
        jobs=generate_jobs(profile, seed),
        preemptions=generate_preemptions(profile, seed),
        serving=serving, serving_prefixes=prefixes)
