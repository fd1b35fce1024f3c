"""``optimizer_ms``: device ms a step of the work launched inside the
trainer's ``train.optimizer`` range (``train/trainer.py``), the union of
those operations over the traced steps. Moves ``train_tokens_per_s``."""

from portbench.profile import union_s


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.traced_steps:
        return None
    ops = ctx.trace.in_ranges("train.optimizer")
    if not ops:
        return None
    return union_s((s, e) for s, e, _, _ in ops) / 1e3 / len(
        ctx.traced_steps)
