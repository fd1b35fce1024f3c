"""``prefill_idle_ms_per_ktok``: device-idle ms inside the engine's
prefills per thousand prefilled tokens: over the ``request.prefill`` spans
that lie inside the traced segment once placed on the device trace's
clock (``spans.join``), each span's length less the union of the device
operations within it (on the same clock, ``spans.DeviceClock``; a span
across a jump of the device's clock is left out), over the sum of their
``tokens``. Beside
``prefill_ms_per_ktok`` it splits a prefill into card work and host work.
It prints the same spans' ms and device-busy ms per ktok to standard
error: these prefills ran under the profiler, which slows the host's
side and not the card's. Without a join, or with no prefill in the
segment, it reads nothing. Moves the cell's decode metric: a prefill
stalls every lane."""

import sys

from portbench import spans


def read(ctx):
    j = spans.join(ctx)
    if j is None:
        return None
    busy = spans.Busy(j.ops(ctx.trace.device))
    total = idle = tokens = n = 0
    for s in ctx.spans:
        if s.name != "request.prefill":
            continue
        a, b = j.at(s.start), j.at(s.end)
        if ctx.trace.t0 <= a and b <= ctx.trace.t1 \
                and j.device.steady(a, b):
            total += b - a
            idle += (b - a) - busy.within(a, b)
            tokens += s.attributes["tokens"]
            n += 1
    if not tokens:
        return None
    # microseconds a token are milliseconds a thousand
    print(f"prefill_idle_ms_per_ktok: {n} traced prefills of {tokens} "
          f"tokens: {total / tokens:.3f} ms/ktok under the profiler, "
          f"device busy {(total - idle) / tokens:.3f}, idle "
          f"{idle / tokens:.3f}", file=sys.stderr)
    return idle / tokens
