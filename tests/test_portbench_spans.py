"""The benchmark's join of the engine's spans to a device trace
(``portbench/spans.py``) and the two readers built on it, on synthetic
traces with a known clock offset."""

import random
from types import SimpleNamespace

import pytest

from kubedl_tpu_torch.trace.tracer import Span
from portbench import spans
from portbench.profile import Trace
from portbench.spec import reader

WALL0 = 1_790_000_000.0
#: trace microseconds = tracer seconds * 1e6 + OFFSET
OFFSET = -WALL0 * 1e6 + 5_000.0
TICK_S, GAP_S, PREFILL_S = 0.030, 0.004, 0.050


def _us(t: float) -> float:
    return t * 1e6 + OFFSET


def _dev(h: float, jump_at: float = float("inf")) -> float:
    """The device's clock at trace (host) time ``h``: 8 ms behind and
    drifting by 1%, and 10 ms ahead of that from ``jump_at`` on."""
    return h - 8_000.0 - 0.01 * (h - _us(WALL0)) + 10_000.0 * (h >= jump_at)


ADMIT = (3, 8, 14, 15, 21, 28, 33)


def synthetic(n=40, seg=(10, 30), admit=ADMIT, jitter=0.0, bump=None,
              copies=True, jump=False):
    """A serve context: ``n`` decode steps, each a tick of 30 ms launched
    4 ms after the last one's device work ended, and before the launches
    ``admit`` a 50 ms prefill of 100 tokens with 20 ms of device work;
    the trace holds launches ``seg[0]`` to ``seg[1] - 1``, each
    seen ``jitter`` us off at random, and launch k ``bump[k]`` us more.
    Device operations carry the device's clock (:func:`_dev`, jumping 2 ms
    before launch 18 with ``jump``); with ``copies`` each tick ends with a
    device-to-host copy of its tokens."""
    rng = random.Random(7)
    out, device, host, launches = [], [], [], {}
    jump_at = _us(WALL0 + 17 * (TICK_S + GAP_S) + 3 * PREFILL_S) - 2_000 \
        if jump else float("inf")

    def dev(h):
        return _dev(h, jump_at)

    launch = WALL0
    for k in range(1, n + 1):
        admitted = k in admit
        start = launch - (TICK_S + GAP_S) + TICK_S + 0.0012
        if admitted:
            out.append(Span("r", f"p{k}", "request.prefill", start,
                            start + PREFILL_S, parent_id="root",
                            attributes={"tokens": 100, "lane": 0,
                                        "sharedBlocks": 0}))
            device.append((dev(_us(start + 0.010)),
                           dev(_us(start + 0.030)), "prefill", None))
            launch += PREFILL_S
        tick0, tick1 = launch - 0.0001, launch + 0.0002
        out += [Span("e", f"t{k}", "engine.tick", tick0, tick1,
                     parent_id=f"s{k}",
                     attributes={"launch": k, "launch_at": launch,
                                 "lanes": 2, "context": 10 + k}),
                Span("e", f"a{k}", "engine.sample", tick1, tick1 + TICK_S,
                     parent_id=f"s{k}"),
                Span("e", f"s{k}", "engine.step", start, tick1 + TICK_S
                     + 0.001, attributes={"step": k, "admitted":
                                          int(admitted),
                                          "prefill_tokens":
                                          100 * admitted})]
        if seg[0] <= k < seg[1]:
            seen = _us(launch) + rng.uniform(-jitter, jitter)
            launches[k] = (seen + (bump or {}).get(k, 0.0),
                           "cudaGraphLaunch")
            device.append((dev(_us(launch) + 10),
                           dev(_us(launch + TICK_S) + 10), "tick", k))
        if copies:
            end = _us(launch + TICK_S) + 30
            device.append((dev(end - 10), dev(end), spans.SYNC_COPY,
                           1000 + k))
            host.append((end - 100, end, "cudaMemcpyAsync", "cuda_runtime"))
            launches[1000 + k] = (end - 100, "cudaMemcpyAsync")
        launch += TICK_S + GAP_S
    first, last = seg[0], seg[1] - 1
    trace = Trace(device=device, host=host, launches=launches,
                  t0=launches[first][0] - 2_000,
                  t1=launches[last][0] + 31_000)
    client = SimpleNamespace(trace_poll=3, ticks={
        (4 + i, 0): [(0.0, 5 + k), (0.0, 5)] for i, k in
        enumerate(range(seg[0], seg[1]))})
    return SimpleNamespace(kind="serve", trace=trace, spans=out,
                           client=client,
                           wall_window=(WALL0 - 0.01, launch))


@pytest.mark.parametrize("late", [0, 2])
def test_the_join_recovers_the_offset_through_jitter(late):
    # a launch the host made late keeps its pairing, not the offset
    ctx = synthetic(jitter=50.0, bump={13: 800.0, 22: 5e3}
                    if late else None)
    j = spans.join(ctx)
    assert j is not None and abs(j.offset_us - OFFSET) <= 50.0
    assert j.spread_us <= 100.0 and j.late == late
    assert [s.attributes["launch"] for s, _ in j.ticks] == list(range(10, 30))
    assert all(ops and ops[0][3] == s.attributes["launch"]
               for s, ops in j.ticks)
    assert spans.client_disagreements(ctx, j) == 0


@pytest.mark.parametrize("case", ["early", "late", "few", "even",
                                  "no_ticks", "no_copies"])
def test_no_join_without_a_hold_on_the_launches(case):
    ctx = {"early": lambda: synthetic(jitter=50.0, bump={13: -400.0}),
           "late": lambda: synthetic(bump={k: 400.0 for k in (11, 13, 17)}),
           "few": lambda: synthetic(seg=(10, 19)),
           "even": lambda: synthetic(admit=()),
           "no_ticks": lambda: synthetic(),
           "no_copies": lambda: synthetic(copies=False)}[case]()
    if case == "no_ticks":       # a program that records no engine.tick
        ctx.spans = [s for s in ctx.spans if s.name != "engine.tick"]
    assert spans.join(ctx) is None


@pytest.mark.parametrize("jump", [False, True])
def test_the_readers_read_hand_computed_values(capsys, jump):
    # a jump of the device's clock: the one gap across it is left out
    ctx = synthetic(jump=jump)
    # every counted gap: 3.8 ms from one step's sampled tokens on the
    # host to the next tick's launch_at, on the host's clock alone
    assert reader("tick_gap_ms.chat")(ctx) == pytest.approx(3.8, abs=1e-3)
    # each prefill: 50 ms, 20 of them busy, over 100 tokens
    assert reader("prefill_idle_ms_per_ktok.batch")(ctx) == pytest.approx(
        300.0, abs=1e-3)
    err = capsys.readouterr().err
    assert "joined 20 graph launches" in err and "accounted 100.0%" in err
    # 40 steps over 1.71 s from the first's start to the last's end, 7 of
    # them after a 50 ms prefill
    assert "40 decode steps, one every 42.750 ms" in err
    assert "request.prefill 8.750" in err
    split = spans.idle_split(ctx, spans.join(ctx))
    idle = split.pop("idle")
    assert sum(split.values()) == pytest.approx(idle)
    # the prefills inside the segment (before launches 14, 15, 21 and 28);
    # the split places the stretch across a jump (prefill 15's) by a guess
    assert split["request.prefill"] == pytest.approx(
        4 * 30_000, abs=200.0 if jump else 1.0)


@pytest.mark.parametrize("name", ["prefill_idle_ms_per_ktok.chat",
                                  "prefill_idle_ms_per_ktok.batch"])
def test_the_readers_read_nothing_without_a_join(name):
    ctx = synthetic()
    ctx.trace = None
    assert reader(name)(ctx) is None
    ctx = synthetic(seg=(10, 15))
    assert reader(name)(ctx) is None


@pytest.mark.parametrize("case", ["no_trace", "no_join", "window",
                                  "no_steps", "untraced"])
def test_the_tick_gap_reads_the_windows_spans(capsys, case):
    # it needs the window's engine.step spans and their children, not the
    # trace: without a join it reads the same and prints no split
    ctx = synthetic()
    want = 3.8
    if case == "no_trace":
        ctx.trace = None
    elif case == "no_join":
        ctx = synthetic(seg=(10, 15))
    elif case == "window":       # steps 11-30: of 19 pairs, 4 admit
        ctx.wall_window = (WALL0 + 10 * (TICK_S + GAP_S) + 2 * PREFILL_S
                           - 0.003, WALL0 + 30 * (TICK_S + GAP_S)
                           + 6 * PREFILL_S)
    elif case == "no_steps":     # a program that records no engine.step
        ctx.spans = [s for s in ctx.spans if s.name != "engine.step"]
        want = None
    else:                        # an untraced run records no spans
        ctx.spans = None
        want = None
    got = reader("tick_gap_ms.batch")(ctx)
    assert got == (None if want is None else pytest.approx(want, abs=1e-3))
    err = capsys.readouterr().err
    assert ("joined 20 graph launches" in err) == (case in ("window",
                                                            "no_steps"))
    if case == "window":
        assert "tick_gap_ms: 15 gaps of 20 window steps" in err
