"""Jittered retry for transient API errors + the slice-restart backoff.

Two related pieces of failure-handling math live here:

* ``retry_transient`` — bounded retries with *decorrelated jitter*
  exponential backoff (the AWS architecture-blog formula:
  ``delay' = min(cap, U(base, delay * 3))``), used by the engine around
  every api-server write so a transient 5xx/timeout never turns one
  reconcile into a failed job. Jitter matters at fleet scale: a thundering
  herd of operators retrying in lockstep is what turns a blip into an
  outage.

* ``restart_delay`` — the same decorrelated-jitter sequence made
  *deterministic per (job, round)* so the slice-failover gate computes the
  identical delay on every reconcile of the same round (the round counter
  and last-restart timestamp persist in ``JobStatus``; re-rolling the
  jitter each reconcile would make the gate flap).

Copied from ``kubedl_tpu/utils/retry.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class RetryPolicy:
    """Bounds for one logical API call: ``attempts`` tries total, sleeping
    a decorrelated-jitter delay in ``[base, cap]`` between them."""

    attempts: int = 4
    base: float = 0.02
    cap: float = 1.0


def retry_transient(fn: Callable, policy: Optional[RetryPolicy] = None, *,
                    retry_on: tuple = (), rng=None,
                    sleep: Callable[[float], None] = time.sleep,
                    on_retry: Optional[Callable] = None):
    """Call ``fn`` until it succeeds or ``policy.attempts`` is exhausted,
    retrying only on ``retry_on`` exceptions; the last error re-raises.

    ``sleep`` is injectable so deterministic tests can advance a fake
    clock instead of blocking; ``on_retry(attempt, delay, exc)`` is the
    observability seam.
    """
    policy = policy or RetryPolicy()
    rng = rng or random
    delay = policy.base
    last: Optional[BaseException] = None
    for attempt in range(max(1, policy.attempts)):
        try:
            return fn()
        except retry_on as e:  # noqa: B030 — tuple supplied by caller
            last = e
            if attempt == policy.attempts - 1:
                break
            if on_retry is not None:
                on_retry(attempt + 1, delay, e)
            sleep(delay)
            delay = min(policy.cap, rng.uniform(policy.base, delay * 3))
    assert last is not None
    raise last


def restart_delay(rounds: int, base: float, cap: float, *, key: str = "",
                  seed: int = 0) -> float:
    """Deterministic decorrelated-jitter delay before slice-restart round
    ``rounds`` (1-based): round 1 is immediate-after-``base``, later rounds
    grow as ``min(cap, U(base, prev * 3))``. Seeding from ``(key, seed)``
    keeps the value stable across reconciles of the same round while still
    de-correlating different jobs from each other."""
    if rounds <= 0:
        return 0.0
    rng = random.Random(f"{key}:{seed}")
    d = base
    for _ in range(rounds - 1):
        d = min(cap, rng.uniform(base, d * 3))
    return min(cap, d)
