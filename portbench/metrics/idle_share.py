"""``idle_share``: the share of the traced window, in %, in which no
device operation ran: 100 less the union of the device operations'
intervals (``profile.union_s``) over the window. Moves the cell's
end-to-end rate or tail."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
