"""A ``serve`` cell: the port's ``ContinuousBatchingEngine`` under traffic.

The engine is built as the predictor's ``serving.__main__.build_engine``
builds it (paged KV, the decode tick a CUDA graph, greedy, no early stop,
the background scheduler loop), on weights made on the card from the
seed. Set-up warms every prefill bucket the mix's prompts fall in and
captures the tick; then traffic starts.

The client is this process's main thread. It submits each request when it
is due (an open loop at the cell's rate) or as soon as one of its clients'
requests finishes (a closed loop), and polls every in-flight request's
tokens every ``POLL_S``: a token's time is the poll that first sees it.

* open loop (``poisson``, ``bursts``): the lead, the window, then a tail
  that keeps the load on until every request that arrived in the window
  has finished; ``itl_mean_ms`` is the mean of every gap between
  consecutive tokens of those requests and ``ttft_mean_ms`` the mean time
  from each one's due time to its first token (their percentiles, and the
  means of the window's two halves, go to standard error);
* closed loop: ``output_tokens_per_s`` counts the tokens seen inside the
  window over its seconds.

A traced run starts and stops one profiler session during set-up, so that
its slow first start is paid there, and runs its window with no profiler
armed; the profiler opens again once the window has closed, and traces
``TRACE_S`` seconds of the traffic going on after ``SETTLE_S`` seconds.
The engine is held between two steps while the profiler switches.

After the window (and the drain) a sample of finished requests drawn from
the seed is held to the reference (``check.py``): ``check_requests`` of
them, each by at most ``check_per_request`` served tokens: the longest
request by its last ones (the longest context), every other by its first
ones (the first comes from the prefill), so the sample spans several
requests and lanes.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np

from . import check, traffic, weights
from .profile import Profiled, free, peak_bytes, sync
from .spec import port_config

#: the kind of traffic mix this cell reads
MIX = "requests"

POLL_S = 0.0005
#: seconds a traced run traces after its window
TRACE_S = 4.0
#: seconds of traffic between the profiler's opening and the trace
SETTLE_S = 2.0
#: how long the counted requests may take to drain after the window
DRAIN_S = 120.0


def bucket(n: int, lo: int = 16) -> int:
    """The prefill bucket of an ``n``-token chunk: the engine's
    ``batching._bucket`` (the next power of two, at least ``lo``)."""
    b = lo
    while b < n:
        b *= 2
    return b


def warm_lengths(mix: dict) -> list:
    """One prompt length for every prefill bucket the mix's prompts fall
    in (the bucket's largest length, or the mix's longest)."""
    lo, hi = traffic.prompt_range(mix)
    out, b = [], bucket(lo)
    while True:
        out.append(min(b, hi))
        if b >= hi:
            return out
        b *= 2


def build(run, phases=None):
    """(engine, tracer) on the seed's weights, every prefill bucket of the
    mix warmed and the tick captured; ``phases`` takes the seconds of
    each step."""
    from kubedl_tpu_torch.serving import ContinuousBatchingEngine
    from kubedl_tpu_torch.serving.engine import GenerateConfig
    from kubedl_tpu_torch.trace import Tracer
    phases = {} if phases is None else phases
    t = time.perf_counter()
    cell = run.cell
    cfgp = port_config(run.cfg)
    params = weights.make_params(run.cfg, run.seed, run.device)
    sync(run.device)
    phases["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tracer = Tracer(enabled=True, capacity=1 << 20) if run.trace else None
    eng = ContinuousBatchingEngine(
        cfgp, params, lanes=cell["lanes"], max_len=cell["max_len"],
        gen=GenerateConfig(max_len=cell["max_len"], eos_id=-1),
        kv_mode="paged", tracer=tracer, device=run.device)
    rng = traffic.rng(run.seed, 9)
    warm = [(rng.integers(0, run.cfg["vocab_size"], n).tolist(), 2)
            for n in warm_lengths(run.mix)]
    eng.run(warm)
    sync(run.device)
    phases["engine_and_warm_s"] = time.perf_counter() - t
    return eng, tracer


class Client:
    """The main thread's view of the engine: submits, polls and keeps each
    token's time and the tick it came from."""

    def __init__(self, eng, t0: float):
        self.eng, self.t0 = eng, t0
        self.inflight: list = []
        self.done: list = []
        self.polls = 0
        #: the poll after which the profiler opened
        self.trace_poll = 0
        #: (poll, k) -> contexts of the tokens a tick gave, in tick order
        self.ticks: dict = {}

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def submit(self, r) -> None:
        r.handle = self.eng.submit(r.prompt, r.max_new)
        self.inflight.append(r)

    def poll(self) -> list:
        """Record new tokens; returns the requests that finished."""
        now, self.polls = self.now(), self.polls + 1
        finished, still = [], []
        for r in self.inflight:
            h = r.handle
            fin = h.done.is_set()
            n = len(h.tokens)
            for k in range(n - len(r.token_times)):
                i = len(r.token_times)
                r.token_times.append(now)
                if i:
                    self.ticks.setdefault((self.polls, k), []).append(
                        (now, len(r.prompt) + i))
            if fin:
                r.tokens = list(h.tokens)
                if h.cancelled or len(r.tokens) != r.max_new:
                    r.error = h.error or "cancelled"
                r.finished = True
                finished.append(r)
            else:
                still.append(r)
        self.inflight = still
        self.done += finished
        return finished


@contextmanager
def quiet(eng, device):
    """The engine held between two scheduler steps (by the lock its
    background loop takes around each one) and the device idle, so that
    the profiler switches on and off while no CUDA graph is launched
    beside it."""
    with eng._sched_lock:
        sync(device)
        yield


class Window:
    """The measured window on the client's clock, from the first poll past
    the lead for ``seconds``, the engine's queue read at both ends; in a
    traced run then the profiler opens (its seconds in ``open_s``),
    ``SETTLE_S`` seconds pass and ``TRACE_S`` seconds are traced, the
    traffic going on. Its state goes lead, window, (settle, trace,)
    after."""

    def __init__(self, run, client: Client, prof: Profiled):
        self.run, self.client, self.prof = run, client, prof
        self.state = "lead"
        self.t0 = self.t1 = self.trace_at = self.trace_end = None
        self.queue = [0, 0]
        self.open_s = None

    def step(self, now: float) -> None:
        c = self.client
        if self.state == "lead" and now >= self.run.mix["lead_s"]:
            self.t0, self.t1 = now, now + self.run.seconds
            self.queue[0] = c.eng.queue_depth
            self.state = "window"
        elif self.state == "window" and now >= self.t1:
            self.queue[1] = c.eng.queue_depth
            self.state = "after"
            if self.prof.on:
                t = time.perf_counter()
                with quiet(c.eng, self.run.device):
                    self.prof.prepare()
                self.open_s = time.perf_counter() - t
                self.trace_at = c.now() + SETTLE_S
                self.state = "settle"
        elif self.state == "settle" and now >= self.trace_at:
            with quiet(c.eng, self.run.device):
                self.prof.start()
            # the ticks the profiler sees come after the next poll
            c.trace_poll = c.polls + 1
            self.trace_end = c.now() + TRACE_S
            self.state = "trace"
        elif self.state == "trace" and now >= self.trace_end:
            with quiet(c.eng, self.run.device):
                self.prof.stop()
            self.state = "after"


def drive_open(run, reqs: list, client: Client, win: Window) -> None:
    """Open loop over ``reqs`` (sorted by due time) until every request
    due in the window has finished (or ``DRAIN_S`` has passed)."""
    pending = list(reqs)
    counted = [r for r in reqs if r.counted]
    while True:
        now = client.now()
        while pending and pending[0].due <= now:
            client.submit(pending.pop(0))
        client.poll()
        win.step(now)
        if win.state == "after" and (all(r.finished for r in counted)
                                     or now > win.t1 + DRAIN_S):
            return
        time.sleep(POLL_S)


def drive_closed(run, stream, client: Client, win: Window) -> None:
    """Closed loop of ``clients`` clients up to the window's end."""
    for _ in range(run.mix["arrival"]["clients"]):
        client.submit(next(stream))
    while win.state != "after":
        now = client.now()
        for _ in client.poll():
            client.submit(next(stream))
        win.step(now)
        time.sleep(POLL_S)


def drive(run, client: Client, win: Window):
    """The cell's traffic through the window (and, in an open loop, the
    drain); returns the open loop's requests, or None."""
    if traffic.is_closed(run.mix):
        drive_closed(run, traffic.closed_loop(
            run.mix, run.cfg["vocab_size"], run.seed), client, win)
        return None
    reqs = traffic.open_loop(run.mix, run.cell["rate_per_s"], run.seconds,
                             run.cfg["vocab_size"], run.seed, DRAIN_S)
    drive_open(run, reqs, client, win)
    return reqs


def sample(run, finished: list) -> list:
    """The served tokens held to the reference: ``check_requests`` finished
    requests, the longest and others drawn from the seed, each as a view
    ``(prompt, tokens, lo)`` whose ``tokens[lo:]`` are compared: the
    longest request's last ``check_per_request`` tokens, every other's
    first ones (the view then ends there)."""
    ok = sorted((r for r in finished if not r.error), key=lambda r: r.ident)
    if not ok:
        return []
    per = run.cell["check_per_request"]
    longest = max(ok, key=lambda r: (len(r.prompt) + len(r.tokens),
                                      -r.ident))
    out = [SimpleNamespace(prompt=longest.prompt, tokens=longest.tokens,
                           lo=max(0, len(longest.tokens) - per))]
    order = traffic.rng(run.seed, 7).permutation(len(ok))
    for i in order:
        if len(out) >= run.cell["check_requests"]:
            break
        if ok[i] is not longest:
            out.append(SimpleNamespace(prompt=ok[i].prompt,
                                       tokens=ok[i].tokens[:per], lo=0))
    return out


def compared(view) -> tuple:
    """(the reference's rows, over ``prompt + tokens[:-1]``, that predict
    the compared tokens; those tokens)."""
    return slice(len(view.prompt) - 1 + view.lo, None), view.tokens[view.lo:]


def reference_gaps(run, picked: list, precisions=("f32",)) -> dict:
    """Per precision, every compared position's gaps in the float32
    reference's logits: ``"f32"`` the served token's, another precision
    the token that precision puts first."""
    import torch
    from .reference.model import Leaves, final_hidden, head, mm
    leaves = Leaves(run.cfg, run.seed, run.device, weights.make_leaf)
    seqs = [r.prompt + r.tokens[:-1] for r in picked]
    hidden = {p: final_hidden(run.cfg, leaves, seqs, p) for p in precisions}
    leaves.close()
    w = head(run.cfg, leaves)
    out = {p: [] for p in precisions}
    with torch.no_grad():
        for j, r in enumerate(picked):
            rows, toks = compared(r)
            ref = hidden["f32"][j][rows] @ w
            served = torch.as_tensor(toks, device=ref.device)
            out["f32"] += check.served_gaps(ref, served)
            for p in precisions[1:]:
                low = mm(hidden[p][j][rows], w, p)
                out[p] += check.served_gaps(ref, low.argmax(-1))
    return out


def _ttft_itl(reqs: list) -> tuple:
    """(every TTFT, every inter-token gap) of ``reqs``, in ms."""
    ttft = [1e3 * (r.token_times[0] - r.due) for r in reqs if r.token_times]
    itl = [1e3 * (b - a) for r in reqs
           for a, b in zip(r.token_times, r.token_times[1:])]
    return ttft, itl


def summary(run, client: Client, win0: float, win1: float, reqs) -> dict:
    """The cell's end-to-end readings (``e2e``), what was attempted and
    failed, and for standard error the tails and each half's means."""
    if not traffic.is_closed(run.mix):
        counted = [r for r in reqs if r.counted]
        ttft, itl = _ttft_itl(counted)
        mid = run.mix["lead_s"] + run.seconds / 2
        halves = {}
        for half, rs in (("first", [r for r in counted if r.due < mid]),
                         ("second", [r for r in counted if r.due >= mid])):
            t, g = _ttft_itl(rs)
            if t and g:
                halves[half] = {"ttft_mean": round(float(np.mean(t)), 3),
                                "itl_mean": round(float(np.mean(g)), 3)}
        return {"e2e": {"itl_mean_ms": float(np.mean(itl)),
                        "ttft_mean_ms": float(np.mean(ttft))},
                "tails": {f"{k}_p{q}": round(float(np.percentile(v, q)), 3)
                          for k, v in (("ttft", ttft), ("itl", itl))
                          for q in (50, 90, 95, 99)},
                "halves": halves,
                "attempted": len(counted),
                "failed": sum(1 for r in counted if r.error
                              or not r.finished)}
    seen = client.done + client.inflight
    toks = sum(1 for r in seen for t in r.token_times if win0 <= t < win1)
    done = [r for r in client.done if r.token_times
            and r.token_times[-1] < win1]
    return {"e2e": {"output_tokens_per_s": toks / (win1 - win0)},
            "attempted": len(done),
            "failed": sum(1 for r in done if r.error)}


def run(run):
    phases = dict(getattr(run, "phases", {}))
    prof = Profiled(run.trace, run.trace_path)
    t = time.perf_counter()
    prof.warm()
    if run.trace:
        phases["profiler_warm_s"] = time.perf_counter() - t
    eng, tracer = build(run, phases)
    setup_s = time.perf_counter() - run.t_start
    client = Client(eng, time.perf_counter())
    win = Window(run, client, prof)
    eng.start()
    t_wall0 = time.time() - client.now()      # the tracer's clock at t0
    try:
        reqs = drive(run, client, win)
        win0, win1 = win.t0, win.t1
        setup_s += win0        # the lead warms the engine: set-up too
        phases["lead_s"] = win0
        peak = peak_bytes(run.device)
        picked = sample(run, [r for r in client.done
                              if r.counted or reqs is None])
        stats = summary(run, client, win0, win1, reqs)
        spans = tracer.spans() if tracer is not None else None
        counters = {"preempted": eng.preempted,
                    "prefill_tokens_total": eng.prefill_tokens_total,
                    "peak_active": eng.peak_active,
                    "tick_launches": dict(eng.tick_launches)}
    finally:
        eng.stop()
    del eng
    client.eng = None
    free(run.device)

    gaps = reference_gaps(run, picked)["f32"]
    numbers = {"logit_gap": max(gaps, default=float("inf")),
               "logit_gap_mean": (sum(gaps) / len(gaps) if gaps
                                  else float("inf"))}
    print(f"portbench: {len(gaps)} served tokens of {len(picked)} requests "
          f"held to the reference ({numbers}); queue {win.queue[0]} -> "
          f"{win.queue[1]} over the window; {stats}; {counters}",
          file=sys.stderr)
    print(f"portbench: set-up phases {phases}"
          + (f"; the profiler opened after the window in {win.open_s} s"
             if win.open_s is not None else ""), file=sys.stderr)
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in run.cell["limits"].items()}
    checks["failed"] = {"value": stats["failed"], "limit": 0}
    e2e = {"setup_s": setup_s, **stats["e2e"]}
    ctx = SimpleNamespace(
        kind="serve", cfg=run.cfg, cell=run.cell, trace=prof.trace,
        spans=spans, counters=counters, client=client,
        window=(win0, win1), wall_window=(t_wall0 + win0, t_wall0 + win1),
        window_s=win1 - win0, memory_peak=peak)
    return SimpleNamespace(e2e=e2e, checks=checks,
                           attempted=stats["attempted"],
                           failed=stats["failed"], ctx=ctx,
                           readings={"gaps": gaps})
