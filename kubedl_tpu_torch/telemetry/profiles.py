"""Online throughput profiles: the scheduler's future placement currency.

Per-(profile key, pool) normalized-throughput estimates, maintained
online from the system's own signals:

* trainer ``train.step`` spans — tokens/second per step (the spans carry
  a ``tokens`` attribute since this layer landed);
* the serving engine's ``decode_tokens_per_s`` probe/steady-state stat.

Estimator: an **exponentially-decayed running mean** with a half-life.
Each estimate carries a confidence ``weight``; folding an observation in
first decays the existing weight by ``0.5 ** (Δt / halflife)`` and then
averages::

    w'   = w · 0.5^(Δt/halflife)
    rate = (rate · w' + obs) / (w' + 1)
    w    = min(w' + 1, weight_cap)

so recent steps dominate, a pool that went quiet for hours re-learns
quickly, and repeated same-timestamp observations (sim clock!) still
update. Deterministic, wall-clock-free (the clock is injected).

Estimates persist as cluster-scoped :mod:`ThroughputProfile
<kubedl_tpu_torch.api.throughputprofile>` objects so operator restarts keep
the learned profiles and the slice scheduler can consume them in a later
PR without touching the tracer.

Copied from ``kubedl_tpu/telemetry/profiles.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from ..api.throughputprofile import (PROFILE_KIND, pools_from_obj,
                                     profile_to_obj)
from ..core.apiserver import AlreadyExists, ApiError, NotFound

log = logging.getLogger("kubedl_tpu_torch.telemetry")


class ThroughputProfileStore:
    def __init__(self, halflife_s: float = 3600.0, weight_cap: float = 64.0,
                 clock=time.time, metrics=None):
        self.halflife_s = float(halflife_s)
        self.weight_cap = float(weight_cap)
        self.clock = clock
        self.metrics = metrics
        #: key -> pool -> {rate, weight, samples, updated_at}
        self._profiles: dict[str, dict] = {}
        #: keys observed since their last successful flush — flush()
        #: writes only these, so a retirement that contributed nothing
        #: doesn't rewrite every ThroughputProfile object
        self._dirty: set = set()

    # -- observation ------------------------------------------------------

    def observe(self, key: str, pool: str, tokens: float, seconds: float,
                now: Optional[float] = None) -> None:
        """Fold one (tokens, seconds) measurement in (a train.step)."""
        if seconds <= 0 or tokens <= 0:
            return
        self.observe_rate(key, pool, tokens / seconds, now=now)

    def observe_rate(self, key: str, pool: str, tokens_per_s: float,
                     now: Optional[float] = None) -> None:
        """Fold one already-normalized rate in (serving
        ``decode_tokens_per_s``)."""
        if tokens_per_s <= 0:
            return
        now = self.clock() if now is None else now
        entry = self._profiles.setdefault(key, {}).get(pool)
        if entry is None:
            entry = {"rate": float(tokens_per_s), "weight": 1.0,
                     "samples": 1, "updated_at": now}
            self._profiles[key][pool] = entry
        else:
            dt = max(now - entry["updated_at"], 0.0)
            w = entry["weight"] * (0.5 ** (dt / self.halflife_s))
            entry["rate"] = (entry["rate"] * w + tokens_per_s) / (w + 1.0)
            entry["weight"] = min(w + 1.0, self.weight_cap)
            entry["samples"] += 1
            entry["updated_at"] = now
        self._dirty.add(key)
        if self.metrics is not None:
            self.metrics.profile_tokens_per_s.set(
                entry["rate"], profile=key, pool=pool)
            self.metrics.profile_samples.inc(profile=key, pool=pool)

    # -- reading ----------------------------------------------------------

    def estimate(self, key: str, pool: str) -> Optional[float]:
        entry = self._profiles.get(key, {}).get(pool)
        return entry["rate"] if entry else None

    def normalized(self, key: str) -> dict:
        """Per-pool throughput normalized to the profile's best pool —
        the Gavel allocation currency (best pool = 1.0)."""
        pools = self._profiles.get(key, {})
        best = max((e["rate"] for e in pools.values()), default=0.0)
        if best <= 0:
            return {}
        return {pool: e["rate"] / best for pool, e in sorted(pools.items())}

    def snapshot(self) -> dict:
        """Deterministic copy (keys and pools sorted)."""
        return {k: {p: dict(e) for p, e in sorted(pools.items())}
                for k, pools in sorted(self._profiles.items())}

    # -- persistence (ThroughputProfile API objects) ----------------------

    def flush(self, api) -> int:
        """Write the profiles observed since the last successful flush
        as cluster-scoped ThroughputProfile objects; returns how many
        were written. Best-effort with bounded retries (a committed-
        then-timed-out create re-reads and lands as an update): a write
        that still fails stays dirty for the next flush, and the
        in-memory estimate is always the truth."""
        written = 0
        for key in sorted(self._dirty):
            pools = self._profiles.get(key)
            if not pools:
                self._dirty.discard(key)
                continue
            obj = profile_to_obj(key, pools)
            name = obj["metadata"]["name"]
            for _ in range(4):
                try:
                    existing = api.try_get(PROFILE_KIND, "default", name)
                    if existing is None:
                        api.create(obj)
                    else:
                        fresh = dict(existing)
                        fresh["spec"] = obj["spec"]
                        fresh["status"] = obj["status"]
                        api.update(fresh)
                    written += 1
                    self._dirty.discard(key)
                    break
                except (AlreadyExists, NotFound):
                    continue              # raced/committed: re-read, retry
                except ApiError as e:
                    log.warning("ThroughputProfile %s flush: %s", name, e)
                    continue
            else:
                log.warning("ThroughputProfile %s flush gave up", name)
        return written

    def load(self, api) -> int:
        """Seed the store from persisted objects (operator restart);
        in-memory entries win over stale persisted ones."""
        loaded = 0
        for obj in api.list(PROFILE_KIND):
            key = ((obj.get("spec") or {}).get("key")
                   or (obj.get("metadata") or {}).get("name", ""))
            if not key:
                continue
            pools = pools_from_obj(obj)
            if not pools:
                continue
            mine = self._profiles.setdefault(key, {})
            for pool, entry in pools.items():
                mine.setdefault(pool, entry)
            loaded += 1
        return loaded
