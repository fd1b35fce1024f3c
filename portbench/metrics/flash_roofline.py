"""``flash_roofline``: the share of their roofline the flash kernels
K1-K3 (``csrc/flash_*_sm90.cu``; K3's split reduction with it) reach over
the traced steps: the sum of each launch's least time over the sum of
their device times.

Each launch's least time is ``chip_smoke.py``'s ``_flash_bound`` rule
(``counts.flash_bound``) at the step's shapes and the (row, key) pairs its
segment masks keep. A step launches K1 twice a layer (the forward and its
recompute under remat) and K2 and K3 once; the launches the port's
counters saw in the window must agree, or nothing is read. Moves
``train_tokens_per_s``."""

import re
import sys

from portbench import counts

KERNELS = re.compile(r"flash_(fwd|dq|dkv)\w*_kernel|dkv_reduce_kernel")


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.traced_steps:
        return None
    m = counts.dims(ctx.cfg)
    L, n = m["L"], len(ctx.traced_steps)
    want = {"flash_forward": 2 * L * n, "flash_dq": L * n, "flash_dkv": L * n}
    if ctx.launches != want:
        print(f"flash_roofline: launches {ctx.launches}, want {want}",
              file=sys.stderr)
        return None
    device = sum(e - s for s, e, name, _ in ctx.trace.device
                 if KERNELS.search(name)) / 1e6
    if not device:
        return None
    bound = 0.0
    for pairs in ctx.traced_steps:
        shape = (ctx.batch, ctx.seq, ctx.seq, m["nh"], m["nkv"], m["hd"],
                 pairs)
        bound += L * (2 * counts.flash_bound("flash_forward", *shape)
                      + counts.flash_bound("flash_dq", *shape)
                      + counts.flash_bound("flash_dkv", *shape))
    return 100.0 * bound / device
