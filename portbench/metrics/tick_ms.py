"""``tick_ms``: device ms of one decode tick: the union of the device
operations of each CUDA graph launch in the traced window (a tick on the
graph route is one launch), averaged over the launches. Moves the cell's
decode metric (``itl_mean_ms`` or ``output_tokens_per_s``)."""

from portbench.profile import tick_times


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    times = tick_times(ctx.trace)
    return 1e3 * sum(times) / len(times) if times else None
