"""Shared descriptive statistics for benches and the fleet scorecard.

Every bench used to carry its own inline ``pct()`` closure
(``bench_controlplane.py``, ``bench_scheduler.py``); this module is the
one implementation they and the cluster replay scorecard share.

Two percentile methods:

* ``nearest`` (default) — the historical bench semantics: index
  ``min(int(n * q), n - 1)`` into the sorted samples. Deterministic,
  returns an actual sample, and keeps existing BENCH_*.json artifacts
  byte-stable.
* ``linear`` — classic linear interpolation between closest ranks (what
  ``numpy.percentile`` calls "linear"), for smoother small-sample
  summaries.

All functions are pure and wall-clock-free: the replay rig's bit-for-bit
reproducibility contract extends to everything computed here.

Copied from ``kubedl_tpu/utils/stats.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

__all__ = ["percentile", "mean", "summarize"]


def percentile(values: Iterable[float], q: float,
               method: str = "nearest",
               default: Optional[float] = None) -> float:
    """The ``q``-quantile (``0.0 <= q <= 1.0``) of ``values``.

    ``values`` need not be sorted. An empty input returns ``default``
    when given, else raises ValueError (a silent 0.0 for "no samples"
    poisons gate comparisons)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    data = sorted(float(v) for v in values)
    if not data:
        if default is not None:
            return default
        raise ValueError("percentile of empty sequence")
    n = len(data)
    if method == "nearest":
        return data[min(int(n * q), n - 1)]
    if method == "linear":
        if n == 1:
            return data[0]
        rank = q * (n - 1)
        lo = int(rank)
        frac = rank - lo
        if lo + 1 >= n:
            return data[-1]
        return data[lo] + (data[lo + 1] - data[lo]) * frac
    raise ValueError(f"unknown percentile method {method!r}")


def mean(values: Iterable[float], default: Optional[float] = None) -> float:
    data = [float(v) for v in values]
    if not data:
        if default is not None:
            return default
        raise ValueError("mean of empty sequence")
    return sum(data) / len(data)


def summarize(values: Sequence[float],
              percentiles: Sequence[float] = (0.50, 0.99),
              method: str = "nearest", ndigits: int = 4) -> dict:
    """One summary dict for a sample list: ``count``/``mean``/``min``/
    ``max`` plus a ``p<NN>`` key per requested quantile (``0.50`` →
    ``p50``, ``0.999`` → ``p99.9``). Empty input yields ``count: 0`` and
    zeros — a *summary* of nothing is legitimate scorecard output even
    though a bare percentile of nothing is an error."""
    data = sorted(float(v) for v in values)
    out = {"count": len(data)}
    keys = []
    for q in percentiles:
        pretty = f"{q * 100:g}"
        keys.append((f"p{pretty}", q))
    if not data:
        out.update({"mean": 0.0, "min": 0.0, "max": 0.0})
        out.update({k: 0.0 for k, _ in keys})
        return out
    out["mean"] = round(mean(data), ndigits)
    out["min"] = round(data[0], ndigits)
    out["max"] = round(data[-1], ndigits)
    for k, q in keys:
        out[k] = round(percentile(data, q, method=method), ndigits)
    return out
