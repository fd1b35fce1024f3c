"""The one injectable simulation clock.

Every deterministic rig in the repo — the API server's timestamping, the
manager's workqueue deadlines, scheduler queue-wait accounting, tracing,
the policy benches, and the cluster replay harness — takes a ``clock``
callable. This is the shared implementation: a monotone simulated time
source with no wall-clock coupling, so identical inputs produce
bit-identical timestamps (``bench_scheduler.py`` used to embed its own
copy; tests grew another as ``conftest.FakeClock``).

``t0`` defaults to a fixed epoch so rendered RFC3339 timestamps are
stable across runs and machines.

Copied from ``kubedl_tpu/core/clock.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

__all__ = ["SimClock"]


class SimClock:
    """Callable clock: ``clock()`` returns the current simulated unix
    seconds. Advance explicitly with :meth:`advance` (relative) or
    :meth:`advance_to` (absolute-in-sim-time, monotone)."""

    __slots__ = ("t0", "t")

    def __init__(self, t0: float = 1_700_000_000.0):
        self.t0 = self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        """Move forward ``dt`` seconds (negative deltas are ignored —
        simulated time never rewinds; retry helpers pass their backoff
        delays here)."""
        if dt > 0:
            self.t += dt

    def advance_to(self, sim_t: float) -> None:
        """Jump to ``t0 + sim_t`` if that is in the future (monotone:
        a stale event time never rewinds the clock)."""
        self.t = max(self.t, self.t0 + sim_t)

    @property
    def elapsed(self) -> float:
        """Simulated seconds since ``t0``."""
        return self.t - self.t0
