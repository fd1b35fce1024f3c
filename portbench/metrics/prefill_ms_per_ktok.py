"""``prefill_ms_per_ktok``: host ms of the engine's prefills per thousand
prefilled tokens: the sum of the ``request.prefill`` spans that start in
the window over the sum of their ``tokens``. Moves ``itl_mean_ms``: a
prefill runs between two ticks and stalls every live lane."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.spans:
        return None
    w0, w1 = ctx.wall_window
    spans = [s for s in ctx.spans
             if s.name == "request.prefill" and w0 <= s.start < w1]
    tokens = sum(s.attributes.get("tokens", 0) for s in spans)
    if not tokens:
        return None
    return 1e3 * sum(s.end - s.start for s in spans) * 1e3 / tokens
