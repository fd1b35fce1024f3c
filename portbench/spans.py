"""The engine's spans placed on the device trace's clock.

The serving engine records its spans on the tracer's clock (Unix seconds,
``time.time()``); a traced segment's events are microseconds on the
profiler's clock, kept relative to its start (``profile.read``). Both see
every decode tick's CUDA graph launch: the trace as a ``cudaGraphLaunch``
(``Trace.graph_replays``), the engine as an ``engine.tick`` span whose
``launch`` is the tick's ordinal on its route and whose ``launch_at`` is
the tracer's clock read just before the replay.

:func:`join` pairs the segment's launches, in order, with ``engine.tick``
spans of consecutive ordinals: of every run of consecutive ordinals as
long as the segment's launches, the one with the fewest offsets (trace
launch time less ``launch_at``) more than :data:`MAX_SPREAD_US` from
their median, then the least median deviation. The offset is that
median. A launch whose offset lies more than :data:`MAX_SPREAD_US` above
it is *late*: the engine's thread was held between its clock read and
the call (the interpreter lock, the operating system); no launch comes
before the read, so none is early but under a wrong pairing. Late
launches keep their pairing and leave the offset; the spread is the
largest deviation of the others. A run holds with at least
:data:`MIN_MATCHED` launches not late, at most a tenth late and a spread
within :data:`MAX_SPREAD_US`. There is a join only where the best run
holds and the second does not (evenly spaced ticks give no hold on the
ordinals; the prefills between ticks do); otherwise, and where the
engine records no ``engine.tick`` spans, the readers that need one read
nothing.

The trace gives device operations on the device's clock, which does not
keep to its host events' clock: on an H100 under torch 2.11 it drifted
by 0.5-1% from it over the first seconds of a trace, then jumped back
by the 2-36 ms built up. :class:`DeviceClock` puts them on the host's
clock: a device-to-host copy into pageable memory ends before its
``cudaMemcpyAsync`` returns (by ~25 us where the clocks agree), and
every decode step makes one (the sampled tokens); between two such
copies the difference of the two clocks is interpolated. Every number
read here compares device operations on the host's clock.

:func:`idle_split` divides the segment's device-idle time among the spans
open on the engine's thread, innermost first: ``request.prefill``,
``engine.tick``, ``engine.sample``, the rest of ``engine.step``, and
outside any ``engine.step`` (the loop's wait, the scheduler lock, the
interpreter).
"""

from __future__ import annotations

import bisect
import statistics
import sys
from dataclasses import dataclass

from .profile import Trace

#: fewest launches a join needs
MIN_MATCHED = 10
#: the largest deviation of one launch's offset from the median, in us
MAX_SPREAD_US = 200.0
#: a device operation whose runtime call returns only once it has ended
SYNC_COPY = "Memcpy DtoH (Device -> Pageable)"
#: a change of the clocks' difference between two copies that is a jump,
#: not drift: over 1 ms and over 2% of the time between them (the drift
#: read 0.5-1.0% on an H100, the jumps 2-36 ms at 3-90%)
JUMP_US, JUMP_RATE = 1000.0, 0.02
#: the spans :func:`idle_split` puts idle time down to, innermost first,
#: then the rest of ``engine.step`` and what lies outside any
SPLIT = ("request.prefill", "engine.tick", "engine.sample", "engine.step")
SPLIT_NAMES = SPLIT[:3] + ("engine.step (rest)", "outside engine.step")


class DeviceClock:
    """Device times -> the trace's host clock, from the host's clock less
    the device's at the end of each :data:`SYNC_COPY` (its runtime call's
    return), linear between them and held beyond the first and last. A
    copy whose difference lies more than :data:`MAX_SPREAD_US` above both
    neighbours' is left out (the host came back late). Between two copies
    whose differences show a jump (:data:`JUMP_US`) the interpolation is a
    guess: :meth:`steady` says whether an interval avoids such a stretch."""

    def __init__(self, trace: Trace):
        ends = {(s, n): e for s, e, n, _ in trace.host
                if n == "cudaMemcpyAsync"}
        raw = sorted((e, ends[trace.launches[c]] - e)
                     for _, e, n, c in trace.device
                     if n == SYNC_COPY and trace.launches.get(c) in ends)
        keep = [x for i, x in enumerate(raw)
                if not 0 < i < len(raw) - 1
                or x[1] - max(raw[i - 1][1], raw[i + 1][1]) <= MAX_SPREAD_US]
        self.at = [t for t, _ in keep]
        self.diff = [d for _, d in keep]
        #: host times between two copies across a jump
        self.jumps = [(t0 + d0, t1 + d1)
                      for (t0, d0), (t1, d1) in zip(keep, keep[1:])
                      if abs(d1 - d0) > max(JUMP_US, JUMP_RATE * (t1 - t0))]

    def __len__(self) -> int:
        return len(self.at)

    def steady(self, a: float, b: float) -> bool:
        """Whether the host times [a, b] meet no stretch across a jump
        (where device operations may carry either side's clock)."""
        return not any(t0 < b and a < t1 for t0, t1 in self.jumps)

    def __call__(self, t: float) -> float:
        i = bisect.bisect_right(self.at, t)
        if i == 0:
            return t + self.diff[0]
        if i == len(self.at):
            return t + self.diff[-1]
        (t0, d0), (t1, d1) = ((self.at[i - 1], self.diff[i - 1]),
                              (self.at[i], self.diff[i]))
        return t + d0 + (d1 - d0) * (t - t0) / (t1 - t0)


@dataclass
class Join:
    """The engine's spans and the device's operations on a trace's host
    clock."""
    offset_us: float      # trace time = tracer seconds * 1e6 + offset_us
    spread_us: float
    #: launches late by more than :data:`MAX_SPREAD_US`
    late: int
    #: ``[(engine.tick span, the launch's device ops)]`` in launch order
    ticks: list
    #: span id -> ``engine.step`` span
    steps: dict
    device: DeviceClock

    def at(self, t: float) -> float:
        """Tracer seconds -> trace microseconds."""
        return t * 1e6 + self.offset_us

    def ops(self, ops) -> list:
        """``(start, end)`` of device operations on the host clock."""
        return [(self.device(s), self.device(e)) for s, e, _, _ in ops]


def _segment_launches(trace: Trace) -> list:
    return [(t, ops) for t, ops in trace.graph_replays()
            if trace.t0 <= t <= trace.t1]


@dataclass(order=True)
class Run:
    """The segment's launches paired with the ``engine.tick`` spans from
    index ``first`` on (see the module's docstring); runs sort best
    first."""
    outside: int          # offsets more than MAX_SPREAD_US from ``offset``
    mad: float            # their median deviation from ``offset``
    offset: float
    spread: float         # largest deviation of a launch that is not late
    late: int
    first: int

    def holds(self, n: int) -> bool:
        return (self.spread <= MAX_SPREAD_US and self.late <= n // 10
                and n - self.late >= MIN_MATCHED)


def align(launch_us: list, ticks: list) -> list:
    """Every :class:`Run` of ``len(launch_us)`` spans of consecutive
    ``launch`` ordinals in ``ticks`` (sorted by ordinal), the best
    first."""
    n = len(launch_us)
    ords = [s.attributes["launch"] for s in ticks]
    at = [s.attributes["launch_at"] * 1e6 for s in ticks]
    out = []
    for i in range(len(ticks) - n + 1):
        if ords[i + n - 1] - ords[i] != n - 1:
            continue
        d = [t - a for t, a in zip(launch_us, at[i:i + n])]
        med = statistics.median(d)
        dev = [abs(x - med) for x in d]
        on_time = [v for x, v in zip(d, dev) if x - med <= MAX_SPREAD_US]
        out.append(Run(outside=sum(1 for x in dev if x > MAX_SPREAD_US),
                       mad=statistics.median(dev), offset=med,
                       spread=max(on_time, default=0.0),
                       late=n - len(on_time), first=i))
    return sorted(out)


def join(ctx):
    """The :class:`Join` of a serve cell's spans and its trace, or None
    (kept on ``ctx``, so every reader of one run shares it)."""
    if hasattr(ctx, "spans_join"):
        return ctx.spans_join
    ctx.spans_join = out = _join(ctx)
    return out


def _join(ctx):
    if ctx.kind != "serve" or ctx.trace is None or not ctx.spans:
        return None
    launches = _segment_launches(ctx.trace)
    ticks = sorted((s for s in ctx.spans if s.name == "engine.tick"
                    and "launch" in s.attributes),
                   key=lambda s: s.attributes["launch"])
    if len(launches) < MIN_MATCHED:
        print(f"spans: {len(launches)} graph launches in the traced "
              f"segment, fewer than {MIN_MATCHED}: no join", file=sys.stderr)
        return None
    n = len(launches)
    runs = align([t for t, _ in launches], ticks)
    best = runs[0] if runs else None
    if best is None or not best.holds(n) \
            or (len(runs) > 1 and runs[1].holds(n)):
        print(f"spans: no join of {n} launches to {len(ticks)} engine.tick "
              f"spans (the best runs: {runs[:2]})", file=sys.stderr)
        return None
    device = DeviceClock(ctx.trace)
    if len(device) < MIN_MATCHED:
        print(f"spans: {len(device)} device-to-host copies to set the "
              f"device's clock by: no join", file=sys.stderr)
        return None
    steps = {s.span_id: s for s in ctx.spans if s.name == "engine.step"}
    return Join(offset_us=best.offset, spread_us=best.spread,
                late=best.late,
                ticks=[(s, ops) for s, (_, ops)
                       in zip(ticks[best.first:best.first + n], launches)],
                steps=steps, device=device)


class Busy:
    """The union of [start, end) intervals (device operations), as sorted
    disjoint intervals, for the busy time within any interval."""

    def __init__(self, intervals):
        self.starts, self.ends, self.cum = [], [], [0.0]
        for s, e in sorted(intervals):
            if self.ends and s <= self.ends[-1]:
                if e > self.ends[-1]:
                    self.cum[-1] += e - self.ends[-1]
                    self.ends[-1] = e
                continue
            self.starts.append(s)
            self.ends.append(e)
            self.cum.append(self.cum[-1] + e - s)

    def within(self, a: float, b: float) -> float:
        """Busy microseconds in [a, b)."""
        i = bisect.bisect_right(self.ends, a)
        k = bisect.bisect_left(self.starts, b)
        if i >= k:
            return 0.0
        total = self.cum[k] - self.cum[i]
        total -= max(0.0, a - self.starts[i])
        total -= max(0.0, self.ends[k - 1] - b)
        return total

    def idle(self, t0: float, t1: float) -> list:
        """The idle intervals of [t0, t1)."""
        out, at = [], t0
        i = bisect.bisect_right(self.ends, t0)
        for s, e in zip(self.starts[i:], self.ends[i:]):
            if s >= t1:
                break
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if at < t1:
            out.append((at, t1))
        return out


def idle_split(ctx, j: Join) -> dict:
    """Microseconds of the segment's device-idle time by the innermost of
    the engine's spans open at the time (:data:`SPLIT_NAMES`), and the
    idle total under ``"idle"``."""
    trace = ctx.trace
    t0, t1 = trace.t0, trace.t1
    idle = Busy(j.ops(trace.device)).idle(t0, t1)
    events = []
    for a, b in idle:
        events += [(a, len(SPLIT), 1), (b, len(SPLIT), -1)]
    for s in ctx.spans:
        if s.name in SPLIT:
            a, b = max(j.at(s.start), t0), min(j.at(s.end), t1)
            if b > a:
                k = SPLIT.index(s.name)
                events += [(a, k, 1), (b, k, -1)]
    events.sort()
    open_, out = [0] * (len(SPLIT) + 1), [0.0] * len(SPLIT_NAMES)
    prev = t0
    for t, k, d in events:
        if open_[-1] > 0 and t > prev:
            cat = next((c for c in range(len(SPLIT)) if open_[c] > 0),
                       len(SPLIT))
            out[cat] += t - prev
        open_[k] += d
        prev = t
    split = dict(zip(SPLIT_NAMES, out))
    split["idle"] = sum(b - a for a, b in idle)
    return split


def client_disagreements(ctx, j: Join) -> int:
    """Joined ticks whose ``lanes`` or ``context`` differ from what the
    client rebuilt from the tokens it saw (``Client.ticks``: the groups
    after the poll the profiler opened at, in order)."""
    groups = [v for k, v in sorted(ctx.client.ticks.items())
              if k[0] > ctx.client.trace_poll][:len(j.ticks)]
    return sum(1 for (s, _), g in zip(j.ticks, groups)
               if s.attributes["lanes"] != len(g)
               or s.attributes["context"] != sum(c for _, c in g))


def window_steps(ctx) -> dict:
    """Mean ms a decode step of the measured window (no profiler armed)
    spends in each of the engine's spans, from their host clock alone,
    over the steps that lie inside the window, from the first one's start
    to the last one's end: the steps' period, ``engine.tick``,
    ``engine.sample``, ``request.prefill``, the rest of ``engine.step``,
    and outside it."""
    w0, w1 = ctx.wall_window
    steps = [s for s in ctx.spans
             if s.name == "engine.step" and w0 <= s.start and s.end <= w1]
    if not steps:
        return {}
    a, b = min(s.start for s in steps), max(s.end for s in steps)
    ids = {s.span_id for s in steps}
    part = {"engine.tick": 0.0, "engine.sample": 0.0}
    for s in ctx.spans:
        if s.name in part and s.parent_id in ids:
            part[s.name] += s.duration
    part["request.prefill"] = sum(
        s.duration for s in ctx.spans
        if s.name == "request.prefill" and a <= s.start and s.end <= b)
    total = sum(s.duration for s in steps)
    part["engine.step (rest)"] = total - sum(part.values())
    part["outside engine.step"] = (b - a) - total
    n = len(steps)
    return {"steps": n, "period": 1e3 * (b - a) / n,
            **{k: 1e3 * v / n for k, v in part.items()}}


def report(ctx, j: Join) -> None:
    """The join, the idle split and :func:`window_steps`, to standard
    error."""
    steps = window_steps(ctx)
    if steps:
        print(f"spans: the window's {steps.pop('steps')} decode steps, one "
              f"every {steps.pop('period'):.3f} ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
              + " ms a step (host clock, no profiler)", file=sys.stderr)
    split = idle_split(ctx, j)
    idle = split.pop("idle")
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({100 * v / idle:.1f}%)"
                      if idle else f"{k} 0 ms" for k, v in split.items())
    lag = j.device.diff
    print(f"spans: joined {len(j.ticks)} graph launches, offset "
          f"{j.offset_us:.1f} us, spread {j.spread_us:.1f} us, {j.late} "
          f"late; device clock set by {len(lag)} copies, host less device "
          f"{min(lag):.0f} to {max(lag):.0f} us, {len(j.device.jumps)} "
          f"jumps; device idle "
          f"{idle / 1e3:.3f} ms of the segment: {parts}; accounted "
          f"{100 * sum(split.values()) / idle if idle else 100:.1f}%; "
          f"ticks whose lanes or context differ from the client's: "
          f"{client_disagreements(ctx, j)} of {len(j.ticks)}",
          file=sys.stderr)
