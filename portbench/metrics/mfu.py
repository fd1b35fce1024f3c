"""``mfu``: model FLOPs of the window over its seconds and the card's
bf16 peak (989 TFLOP/s), in %.

* training: ``bench.py``'s 6 N + 12 L hd nh s/2 a token (``counts.
  train_flops``), the attention term over the pairs each step's segment
  masks keep, recompute not counted; moves ``train_tokens_per_s``;
* serving: the forward FLOPs of the tokens prefilled (the
  ``request.prefill`` spans that start in the window, each prompt from
  position 0) and of the tokens decoded in the window (each at its
  context); moves ``output_tokens_per_s``."""

from portbench import counts

PEAK = counts.PEAK_FLOPS_PER_S["bfloat16"]


def read(ctx):
    cfg = ctx.cfg
    if ctx.kind == "train":
        flops = sum(counts.train_flops(cfg, ctx.batch * ctx.seq, pairs)
                    for pairs in ctx.steps)
        return 100.0 * flops / ctx.window_s / PEAK if flops else None
    if not ctx.spans:
        return None
    w0, w1 = ctx.wall_window
    flops = 0.0
    for s in ctx.spans:
        if s.name == "request.prefill" and w0 <= s.start < w1:
            n = s.attributes.get("tokens", 0)
            flops += counts.forward_flops(cfg, n, n * (n + 1) // 2)
    c0, c1 = ctx.window
    for group in ctx.client.ticks.values():
        for t, c in group:
            if c0 <= t < c1:
                flops += counts.forward_flops(cfg, 1, c)
    return 100.0 * flops / ctx.window_s / PEAK if flops else None
