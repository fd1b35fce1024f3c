"""``decode_roofline``: the share of their roofline the decode ticks of
the traced window reach: the least time their work needs over the device
time they took (``tick_ms``'s union of each graph launch's operations).

The work is counted from what these ticks had to do (``counts.py``), not
from the tick's shapes: every weight read once (of the embedding only the
lanes' rows, of the experts at most ``lanes * top-k`` a layer), each live
lane's K/V read once and its new K/V written, and the forward of one token
a live lane. The live lanes and their contexts come from the tokens the
client saw, tick by tick, after the profiler opened; the first as many
ticks as the trace holds launches are counted. The least time is the
larger of all the ticks' bytes at the HBM rate and their operations at
the bf16 peak. Moves the cell's decode metric."""

from portbench import counts
from portbench.profile import tick_times


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    times = tick_times(ctx.trace)
    groups = [v for k, v in sorted(ctx.client.ticks.items())
              if k[0] > ctx.client.trace_poll][:len(times)]
    if not times or not groups:
        return None
    moved = ops = 0.0
    for g in groups:
        b, f = counts.decode_tick_work(ctx.cfg, [c for _, c in g])
        moved, ops = moved + b, ops + f
    bound = max(moved / counts.HBM_BYTES_PER_S,
                ops / counts.PEAK_FLOPS_PER_S["bfloat16"])
    return 100.0 * bound / sum(times[:len(groups)])
