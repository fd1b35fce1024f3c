"""``tick_gap_ms``: the scheduler's host path between two decode ticks,
in ms: from one step's sampled tokens on the host (the end of its
``engine.sample`` span) to the next tick's ``launch_at`` (the clock read
just before its graph's replay), averaged over the measured window's
consecutive ``engine.step`` spans whose second step admitted nothing (its
``admitted`` attribute), so that no prefill ran between them. It reads
the window's spans alone, on the host's clock with no profiler armed
(under the profiler a graph launch holds the host for milliseconds). It
also prints ``spans.report`` to standard error where the engine's spans
join the traced segment (``spans.join``). Without the engine's step spans
it reads nothing. Moves the cell's decode metric."""

import sys

from portbench import spans


def read(ctx):
    if ctx.kind != "serve" or not ctx.spans:
        return None
    j = spans.join(ctx)
    if j is not None:
        spans.report(ctx, j)
    w0, w1 = ctx.wall_window
    steps = sorted((s for s in ctx.spans if s.name == "engine.step"
                    and w0 <= s.start and s.end <= w1),
                   key=lambda s: s.attributes["step"])
    kids = {(s.parent_id, s.name): s for s in ctx.spans
            if s.name in ("engine.tick", "engine.sample")}
    gaps = []
    for a, b in zip(steps, steps[1:]):
        sample = kids.get((a.span_id, "engine.sample"))
        tick = kids.get((b.span_id, "engine.tick"))
        if b.attributes["step"] != a.attributes["step"] + 1 \
                or b.attributes["admitted"] or sample is None \
                or tick is None or "launch_at" not in tick.attributes:
            continue
        gaps.append(tick.attributes["launch_at"] - sample.end)
    if not gaps:
        return None
    print(f"tick_gap_ms: {len(gaps)} gaps of {len(steps)} window steps",
          file=sys.stderr)
    return 1e3 * sum(gaps) / len(gaps)
