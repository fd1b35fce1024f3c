"""Reading the device trace of a traced run.

A segment after the measured window runs under ``torch.profiler`` (CPU
and CUDA activities), so that no timed number carries the profiler's
cost; its chrome trace is exported into the checkout's
``build/portbench/`` (one fixed file, removed once read) and reduced here
to what the per-layer metrics read:

* device operations (kernels, copies and fills) and their union over the
  window: :func:`union_s` is ``profile_torch_training.py``'s ``_union_us``,
  frozen here;
* which host call launched each device operation (the ``correlation`` of
  the runtime call), so a device operation belongs to the host range its
  launch fell in (``profile_torch_training.py``'s ``summarise``) and a
  CUDA graph's kernels to their ``cudaGraphLaunch``;
* the breakdown: the device operations that took most time, and the
  longest idle gaps, each named by the innermost host event open at the
  gap's start.
"""

from __future__ import annotations

import bisect
import json
import os
from dataclasses import dataclass
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
GRAPH_LAUNCH = ("cudaGraphLaunch",)


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _sync_all() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    """The device's peak allocated memory so far (0 off the card)."""
    import torch
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free(device) -> None:
    """Return what the freed program state held to the device."""
    import gc

    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def union_s(intervals) -> float:
    """Length of the union of [start, end) intervals (same unit out)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


@dataclass
class Trace:
    """The events of one traced window, times in microseconds."""
    device: list          # (start, end, name, correlation)
    host: list            # (start, end, name, cat)
    launches: dict        # correlation -> (host start, runtime call name)
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        return union_s((max(s, self.t0), min(e, self.t1))
                       for s, e, _, _ in self.device
                       if e > self.t0 and s < self.t1) / 1e6

    def graph_replays(self) -> list:
        """``[(host start, [device ops])]`` of every CUDA graph launch, in
        launch order."""
        by_corr: dict = {}
        for op in self.device:
            by_corr.setdefault(op[3], []).append(op)
        out = [(t, by_corr.get(c, [])) for c, (t, name)
               in self.launches.items() if name in GRAPH_LAUNCH]
        return sorted(out, key=lambda x: x[0])

    def in_ranges(self, name: str) -> list:
        """Device ops launched inside a host range called ``name``."""
        spans = sorted((s, e) for s, e, n, cat in self.host
                       if n == name and cat == "user_annotation")
        starts = [s for s, _ in spans]
        out = []
        for op in self.device:
            launch = self.launches.get(op[3])
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch[0]) - 1
            if i >= 0 and launch[0] <= spans[i][1]:
                out.append(op)
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for s, e, name, _ in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], self.t0
        for s, e, _, _ in sorted(self.device):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((end, self.t1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host)
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[self._host_at(host, g0), (g1 - g0) / 1e6]
                              for g0, g1 in gaps]}

    @staticmethod
    def _host_at(host: list, t: float) -> str:
        """The shortest host event open at ``t``: what the host was doing."""
        best = None
        i = bisect.bisect_right(host, (t, float("inf")))
        for s, e, name, cat in host[max(0, i - 4000):i]:
            if s <= t < e and (best is None or e - s < best[0]):
                best = (e - s, name)
        return f"host: {best[1]}" if best else "host: no event"


#: the host range the harness opens around the traced window
WINDOW = "portbench.window"


def read(path: Path) -> Trace:
    """Reduce an exported chrome trace; the window is the span of the
    :data:`WINDOW` range where the trace has one, else of its events."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    device, host, launches = [], [], {}
    lo, hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X":
            continue
        s, dur = float(e["ts"]), float(e.get("dur", 0.0))
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((s, s + dur, e["name"], corr))
        elif cat in HOST_CATS:
            host.append((s, s + dur, e["name"], cat))
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = (s, e["name"])
        lo, hi = min(lo, s), max(hi, s + dur)
    win = [(s, e) for s, e, n, cat in host if n == WINDOW]
    if win:
        lo, hi = win[0]
    return Trace(device=device, host=host, launches=launches, t0=lo, t1=hi)


def _activities() -> list:
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class Profiled:
    """A traced segment under ``torch.profiler`` when ``on``; a no-op
    otherwise. :meth:`warm` starts and stops one empty session during
    set-up, so that the profiler's slow first start (CUPTI with it) is
    paid there and nothing stays armed; :meth:`prepare` opens the session
    that traces, :meth:`start` and :meth:`stop` bound the traced segment,
    and :attr:`trace` holds it once stopped. The exported file lies at a
    fixed path in the checkout and is removed once read."""

    def __init__(self, on: bool, path: Path):
        self.on, self.path, self.trace = on, Path(path), None
        self._prof = self._range = None

    def warm(self) -> None:
        if not self.on:
            return
        from torch.profiler import profile
        with profile(activities=_activities()):
            _sync_all()

    def prepare(self) -> None:
        if not self.on:
            return
        from torch.profiler import profile, schedule
        self._prof = profile(
            activities=_activities(),
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=self._export)
        self._prof.__enter__()

    def start(self) -> None:
        if not self.on:
            return
        import torch
        _sync_all()
        self._prof.step()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def stop(self) -> None:
        if not self.on:
            return
        _sync_all()
        self._range.__exit__(None, None, None)
        self._prof.step()
        self._prof.__exit__(None, None, None)
        self._prof = self._range = None
        try:
            self.trace = read(self.path)
        finally:
            os.unlink(self.path)

    def _export(self, prof) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(self.path))


def tick_times(trace: Trace) -> list:
    """Seconds of device time of every CUDA graph launch (a decode tick)
    made inside the traced window: the union of its operations."""
    return [union_s((s, e) for s, e, _, _ in ops) / 1e6
            for t, ops in trace.graph_replays()
            if trace.t0 <= t <= trace.t1 and ops]
