"""Pipeline parallelism over the ``pp`` mesh axis: the counterpart of
``kubedl_tpu/parallel/pipeline.py``.

The layers are split into ``pp`` contiguous stages (:func:`stack_stages`:
``[L, ...]`` -> ``[pp, L/pp, ...]``), each stage runs its own layers
(:func:`stage_scan`), and microbatches flow from stage to stage through a
neighbor exchange (``collectives.pp_shift``, ``dist.batch_isend_irecv``;
a gloo group stages CUDA tensors through the host and counts them in
``pp_shift.host_staged``). Two schedules:

* :func:`pipeline_apply`, GPipe: ``num_micro + pp - 1`` forward slots,
  then the same number of backward slots in reverse. JAX differentiates
  its forward scan through ``ppermute``; here one autograd Function holds
  both halves, and its backward is written out: each stage keeps every
  microbatch's autograd graph from the forward (``pp - s`` slots later
  the cotangent arrives from stage ``s + 1``), differentiates it with
  ``torch.autograd.grad`` and hands the input's cotangent to stage
  ``s - 1``. Stage parameter gradients add up over the microbatches in
  float32.
* :func:`pipeline_grads_1f1b`, 1F1B (PipeDream-flush) on the
  :class:`Schedule1F1B` tables: stage ``s`` stashes at most
  ``min(pp - s, num_micro)`` microbatch INPUTS, and each backward
  recomputes its stage forward from the stash. It returns ``(loss,
  stage_grads, head_grads)``, the mean over microbatches.

Both are written once over :class:`Stages`: where a pipeline runs and how
its neighbors exchange. A rank on its ``pp`` group holds its own stage
(:func:`group_stages`); one process can hold every stage and rotate its
list (:func:`local_stages`), running the same slots in the same order.
The tests hold the one-process form against the JAX schedules, and
``chip_smoke.py`` against the flat model on one card.

Bubble slots (a stage with no microbatch in that slot) are skipped, where
the JAX scan computes on don't-care data and masks the result: the values
are the same. Every stage still joins each slot's exchange, sending zeros
from a bubble, so every rank posts its sends and receives in one order.
"""

from __future__ import annotations

import numpy as np
import torch

from .collectives import is_sharded, pp_shift


class Schedule1F1B:
    """Static per-stage slot schedule for non-interleaved 1F1B: the JAX
    package's tables, computed by the same numpy.

    GPipe runs all forwards then all backwards, so every stage holds
    ``num_micro`` activation stashes at the bubble's peak; 1F1B starts
    microbatch i's backward as soon as the last stage finishes its
    forward, bounding stage ``s``'s live stashes to ``pp - s``. Both
    schedules occupy ``2 * (num_micro + pp - 1)`` slots: 1F1B buys
    memory, not bubble time.

    Attributes (numpy int32, ``-1`` = idle):

    * ``fwd_mb[s, t]``: microbatch whose FORWARD stage ``s`` runs at
      slot ``t``;
    * ``bwd_mb[s, t]``: microbatch whose BACKWARD it runs;
    * ``arr_f[s, t]`` / ``arr_b[s, t]``: microbatch arriving on the
      activation / cotangent wire at the top of slot ``t`` (what the
      neighbor computed last slot);
    * ``depth``: smallest safe ring-buffer depth for the activation stash
      and both arrival buffers (verified against the schedule).
      ``depth <= pp + 1``, the 1F1B memory bound, vs GPipe's
      ``num_micro``.
    """

    def __init__(self, pp: int, num_micro: int):
        S, M = pp, num_micro
        self.pp, self.num_micro = S, M
        # op list per stage: warmup forwards, steady 1F1B, cooldown
        ops = []
        for s in range(S):
            w = min(S - 1 - s, M)
            seq = [("F", i) for i in range(w)]
            nb = 0
            for i in range(w, M):
                seq.append(("F", i))
                seq.append(("B", nb))
                nb += 1
            seq += [("B", j) for j in range(nb, M)]
            ops.append(seq)

        # greedy list scheduling under the data dependencies:
        # F_s(i) after F_{s-1}(i);  B_s(i) after F_s(i) and B_{s+1}(i)
        f_slot = [[-1] * M for _ in range(S)]
        b_slot = [[-1] * M for _ in range(S)]
        ptr = [0] * S
        cols = []
        t = 0
        while any(ptr[s] < len(ops[s]) for s in range(S)):
            col = []
            for s in range(S):
                op = ops[s][ptr[s]] if ptr[s] < len(ops[s]) else None
                ok = False
                if op is not None:
                    kind, i = op
                    if kind == "F":
                        ok = s == 0 or 0 <= f_slot[s - 1][i] < t
                    else:
                        ok = 0 <= f_slot[s][i] < t and (
                            s == S - 1 or 0 <= b_slot[s + 1][i] < t)
                if ok:
                    col.append(op)
                    (f_slot if kind == "F" else b_slot)[s][i] = t
                    ptr[s] += 1
                else:
                    col.append(None)
            cols.append(col)
            t += 1
        T = t
        assert T == 2 * (M + S - 1) or S == 1, (T, S, M)

        self.slots = T
        self.fwd_mb = np.full((S, T), -1, np.int32)
        self.bwd_mb = np.full((S, T), -1, np.int32)
        for tt, col in enumerate(cols):
            for s, op in enumerate(col):
                if op is not None:
                    (self.fwd_mb if op[0] == "F" else
                     self.bwd_mb)[s, tt] = op[1]
        # arrivals: what the neighbor sent at the END of the previous slot
        self.arr_f = np.full((S, T), -1, np.int32)
        self.arr_b = np.full((S, T), -1, np.int32)
        self.arr_f[1:, 1:] = self.fwd_mb[:-1, :-1]
        self.arr_b[:-1, 1:] = self.bwd_mb[1:, :-1]

        # smallest ring depth with no live-entry overwrite, verified
        # against the actual slot assignment (mb % depth indexing):
        #   stash:   B_s(i) strictly before F_s(i+D) writes its slot
        #   act_in:  consumed at F_s(i); overwritten at F_{s-1}(i+D)+1
        #   grad_in: consumed at B_s(i); overwritten at B_{s+1}(i+D)+1
        def safe(D: int) -> bool:
            for s in range(S):
                for i in range(M - D):
                    if not f_slot[s][i + D] > b_slot[s][i]:
                        return False
                    if s > 0 and not f_slot[s - 1][i + D] + 1 > f_slot[s][i]:
                        return False
                    if s < S - 1 and \
                            not b_slot[s + 1][i + D] + 1 > b_slot[s][i]:
                        return False
            return True

        D = 1
        while not safe(D):
            D += 1
        assert D <= min(S + 1, M), (D, S, M)
        self.depth = min(D, M)

    def max_inflight(self, s: int) -> int:
        """Peak count of microbatches whose forward ran at stage ``s``
        but whose backward has not: the activation-memory bound the
        schedule exists to shrink."""
        f = self.fwd_mb[s]
        b = self.bwd_mb[s]
        live = peak = 0
        for t in range(self.slots):
            if f[t] >= 0:
                live += 1
                peak = max(peak, live)
            if b[t] >= 0:
                live -= 1
        return int(np.int32(peak))


# ---------------------------------------------------------------------------
# where a pipeline runs
# ---------------------------------------------------------------------------

class Stages:
    """Where a pipeline runs: ``pp``, the number of stages; ``ranks``, the
    stages this process holds, in the order of its lists (a held stage's
    parameters are row ``j`` of each stage leaf, ``j`` its place in
    ``ranks``); ``shift(xs, step)``, which hands every held stage's tensor
    to stage ``s + step`` and returns what stage ``s - step`` sent (zeros
    where there is no such stage); and ``reduce(t, op)``, which adds a
    per-stage value over the stages (``op`` "pp_sum") or averages a
    per-rank value over the data axes (``op`` "data_mean"), in place."""

    def __init__(self, pp: int, ranks: list, shift, reduce):
        self.pp, self.ranks, self.shift, self.reduce = pp, ranks, shift, \
            reduce

    @property
    def holds_last(self) -> bool:
        """Whether this process holds the last stage (which the loss
        follows)."""
        return self.pp - 1 in self.ranks


def group_stages(mesh, axis: str = "pp") -> Stages:
    """This rank's stage on ``mesh``'s ``axis``."""
    import torch.distributed as dist

    def reduce(t, op):
        if op == "pp_sum":
            dist.all_reduce(t, group=mesh.group(axis))
            return t
        for data in ("dp", "fsdp"):
            if mesh.size(data) > 1:
                dist.all_reduce(t, group=mesh.group(data))
                t.div_(mesh.size(data))
        return t

    return Stages(mesh.size(axis), [mesh.index(axis)],
                  lambda xs, step: [pp_shift(xs[0], mesh, step, axis)],
                  reduce)


def local_stages(pp: int) -> Stages:
    """All ``pp`` stages in one process: the exchange shifts the list
    (stage ``s`` receives what ``s - step`` sent; the first stage along
    ``step`` receives zeros), and the reductions have nothing to add
    (one accumulator serves every held stage)."""
    def shift(xs, step):
        zero = [torch.zeros_like(xs[0])]
        return zero + xs[:-1] if step == 1 else xs[1:] + zero

    return Stages(pp, list(range(pp)), shift, lambda t, op: t)


def stages_of(where) -> Stages:
    """``where`` as :class:`Stages`: itself, or a mesh's ``pp`` group (a
    mesh with no group behind ``pp`` holds one stage)."""
    if isinstance(where, Stages):
        return where
    if where is not None and is_sharded(where) and where.size("pp") > 1:
        return group_stages(where)
    return local_stages(1)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _micro(x, num_micro: int) -> list:
    b = x.shape[0]
    if b % num_micro:
        raise ValueError(f"batch {b} not divisible by num_micro={num_micro}")
    return list(x.reshape((num_micro, b // num_micro)
                          + tuple(x.shape[1:])).unbind(0))


def _flatten(tree, prefix: str = "") -> list:
    """``[(path, tensor)]`` of a tree of dicts (keys sorted)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(paths: list, leaves) -> dict:
    """The tree :func:`_flatten` read ``paths`` from, with ``leaves``."""
    if paths == [""]:
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _held(leaves, j: int) -> list:
    """Row ``j`` of every stage leaf, as fresh autograd leaves."""
    return [leaf[j].detach().requires_grad_(True) for leaf in leaves]


class _Stash:
    """Per-stage microbatch stash with its measured peak: the entries
    alive at once and their bytes (the tensors' own, not their graphs')."""

    def __init__(self):
        self.live: dict = {}
        self.peak = 0
        self.peak_bytes = 0

    def put(self, m: int, value, nbytes: int) -> None:
        self.live[m] = (value, nbytes)
        self.peak = max(self.peak, len(self.live))
        self.peak_bytes = max(self.peak_bytes,
                              sum(n for _, n in self.live.values()))

    def pop(self, m: int):
        return self.live.pop(m)[0]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _report(stats, stashes, stages) -> None:
    if stats is not None:
        stats["stages"] = list(stages.ranks)
        stats["stash_peak"] = [st.peak for st in stashes]
        stats["stash_peak_bytes"] = [st.peak_bytes for st in stashes]


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def _gpipe_forward(stages, stage_fn, num_micro, paths, leaves, x, stats,
                   keep: bool) -> tuple:
    """GPipe's forward slots over the held stages: (y, state). ``x`` is
    the whole batch (read by stage 0); y is the last stage's output, and
    zeros where this process does not hold it. With ``keep`` every
    microbatch's autograd graph stays in the stash for the backward, and
    ``state`` carries it."""
    S, M = stages.pp, num_micro
    xm = _micro(x, M)
    held = [_held(leaves, j) if keep else [leaf[j] for leaf in leaves]
            for j in range(len(stages.ranks))]
    zero = torch.zeros_like(xm[0])
    stash = [_Stash() for _ in stages.ranks]
    outs = [None] * M
    wire = [zero] * len(stages.ranks)
    for t in range(M + S - 1):
        sends = []
        for j, s in enumerate(stages.ranks):
            m = t - s
            if not 0 <= m < M:
                sends.append(zero)
                continue
            inp = (xm[m] if s == 0 else wire[j]).detach()
            if keep:
                inp.requires_grad_(True)
            with torch.set_grad_enabled(keep):
                y = stage_fn(_unflatten(paths, held[j]), inp)
            if keep:
                stash[j].put(m, (inp, y), _nbytes(inp))
            if s == S - 1:
                outs[m] = y.detach()
            sends.append(y.detach())
        if t + 1 < M + S - 1:
            wire = stages.shift(sends, 1)
    _report(stats, stash, stages)
    y = (torch.stack(outs).reshape(x.shape) if stages.holds_last
         else torch.zeros_like(x))
    return y, (stages, held, stash, M, zero, x.shape)


class _GPipe(torch.autograd.Function):
    """GPipe's forward (:func:`_gpipe_forward`, keeping the graphs) and
    its written-out backward over the held stages."""

    @staticmethod
    def forward(ctx, stages, stage_fn, num_micro, paths, stats, x, *leaves):
        y, ctx.state = _gpipe_forward(stages, stage_fn, num_micro, paths,
                                      leaves, x, stats, keep=True)
        return y

    @staticmethod
    def backward(ctx, dy):
        stages, held, stash, M, zero, shape = ctx.state
        del ctx.state
        S = stages.pp
        dym = _micro(dy.contiguous(), M) if stages.holds_last else None
        dxm = [None] * M
        acc = [[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in ps] for ps in held]
        wire = None
        for t in range(M + S - 1):
            sends = []
            for j, s in enumerate(stages.ranks):
                m = t - (S - 1 - s)
                if not 0 <= m < M:
                    sends.append(zero)
                    continue
                inp, y = stash[j].pop(m)
                g = dym[m] if s == S - 1 else wire[j]
                grads = torch.autograd.grad(y, [inp] + held[j], g)
                for a, gp in zip(acc[j], grads[1:]):
                    a.add_(gp)
                if s == 0:
                    dxm[m] = grads[0]
                sends.append(grads[0])
            if t + 1 < M + S - 1:
                wire = stages.shift(sends, -1)
        dx = torch.stack(dxm).reshape(shape) if 0 in stages.ranks else None
        dleaves = [torch.stack([acc[j][i] for j in range(len(held))]).to(
            held[0][i].dtype) for i in range(len(held[0]))]
        return (None, None, None, None, None, dx, *dleaves)


def pipeline_apply(stages, stage_fn, stage_params, x, num_micro: int,
                   stats=None):
    """Run ``x`` through a ``pp``-stage GPipe pipeline.

    ``stages``: a :class:`Stages` or a mesh (:func:`stages_of`);
    ``stage_fn(params_one_stage, x_micro) -> y_micro`` applies ONE stage
    and preserves the shape; ``stage_params``: a tree (dicts) whose
    leaves carry a leading axis of the held stages (``pp`` rows in one
    process, this rank's one row on a group); ``x``: ``[batch, ...]``
    with batch divisible by ``num_micro``.

    Returns y with x's shape: the last stage's output where this process
    holds it, zeros elsewhere (the caller takes the loss on the last
    stage). Differentiable in ``x`` and the stage params. ``stats``, a
    dict, receives each held stage's measured stash peak. With one stage
    it is ``stage_fn`` on the whole batch, as in JAX."""
    stages = stages_of(stages)
    paths, leaves = zip(*_flatten(stage_params))
    if stages.pp == 1:
        return stage_fn(_unflatten(list(paths), [t[0] for t in leaves]), x)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, *leaves))):
        return _gpipe_forward(stages, stage_fn, num_micro, list(paths),
                              leaves, x, stats, keep=False)[0]
    _micro(x, num_micro)
    return _GPipe.apply(stages, stage_fn, num_micro, list(paths), stats, x,
                        *leaves)


# ---------------------------------------------------------------------------
# 1F1B
# ---------------------------------------------------------------------------

def pipeline_grads_1f1b(stages, stage_fn, stage_params, head_params, x, aux,
                        num_micro: int, loss_fn_mb, stats=None):
    """Forward AND backward through a ``pp``-stage pipeline on the 1F1B
    schedule; returns ``(loss, stage_grads, head_grads)``.

    * ``stages``, ``stage_fn``, ``stage_params``, ``x``: as
      :func:`pipeline_apply`;
    * ``head_params``: the loss head's tree (final norm, LM head),
      consumed only by the LAST stage;
    * ``aux``: a dict of ``[batch, ...]`` tensors riding with the data
      (targets, masks), microbatched alongside ``x``;
    * ``loss_fn_mb(head_params, y_micro, aux_micro) -> scalar``: the
      per-microbatch mean loss.

    The loss is the mean over microbatches; the gradients are
    d(loss)/d(stage_params), one row per held stage, and
    d(loss)/d(head_params), float32 as JAX's accumulators are, averaged
    over the data axes on a group, with the loss and the head's gradients
    summed over ``pp`` so every stage holds them. ``x`` itself is not
    differentiated. ``stats`` receives each held stage's measured stash
    peak."""
    stages = stages_of(stages)
    S, M = stages.pp, num_micro
    xm = _micro(x, M)
    auxm = {k: _micro(v, M) for k, v in aux.items()}
    sched = Schedule1F1B(S, M)
    paths, leaves = zip(*_flatten(stage_params))
    paths = list(paths)
    hpaths, hleaves = zip(*_flatten(head_params))
    hpaths = list(hpaths)
    held = [_held(leaves, j) for j in range(len(stages.ranks))]
    head = [h.detach().requires_grad_(True) for h in hleaves]
    f32 = torch.float32
    gacc = [[torch.zeros(p.shape, dtype=f32, device=p.device) for p in ps]
            for ps in held]
    hacc = [torch.zeros(h.shape, dtype=f32, device=h.device) for h in head]
    lacc = torch.zeros((), dtype=f32, device=x.device)
    zero = torch.zeros_like(xm[0])
    act_in = [dict() for _ in stages.ranks]
    grad_in = [dict() for _ in stages.ranks]
    stash = [_Stash() for _ in stages.ranks]
    wire_f = wire_b = [zero] * len(stages.ranks)
    for t in range(sched.slots):
        send_f, send_b = [], []
        for j, s in enumerate(stages.ranks):
            # 1. bank last slot's arrivals under their microbatch id
            af, ab = int(sched.arr_f[s, t]), int(sched.arr_b[s, t])
            if af >= 0:
                act_in[j][af] = wire_f[j]
            if ab >= 0:
                grad_in[j][ab] = wire_b[j]
            fi, bi = int(sched.fwd_mb[s, t]), int(sched.bwd_mb[s, t])
            # 2. forward slot: the INPUT is stashed for the remat backward
            # (the last stage sends its output nowhere, so it only stashes)
            if fi >= 0:
                x_in = xm[fi] if s == 0 else act_in[j].pop(fi)
                stash[j].put(fi, x_in, _nbytes(x_in))
            if 0 <= fi and s < S - 1:
                with torch.no_grad():
                    send_f.append(stage_fn(_unflatten(paths, held[j]),
                                           x_in))
            else:
                send_f.append(zero)
            # 3. backward slot: recompute this stage's forward from the
            # stash; the last stage seeds 1.0 into its loss, the others
            # the banked neighbor cotangent
            if bi >= 0:
                x_s = stash[j].pop(bi).detach().requires_grad_(True)
                with torch.enable_grad():
                    y = stage_fn(_unflatten(paths, held[j]), x_s)
                    if s == S - 1:
                        amb = {k: v[bi] for k, v in auxm.items()}
                        loss = loss_fn_mb(_unflatten(hpaths, head), y, amb)
                        grads = torch.autograd.grad(
                            loss, [x_s] + held[j] + head, allow_unused=True,
                            materialize_grads=True)
                        lacc += loss.detach().float()
                        for a, g in zip(hacc, grads[1 + len(held[j]):]):
                            a.add_(g)
                    else:
                        grads = torch.autograd.grad(
                            y, [x_s] + held[j], grad_in[j].pop(bi))
                for a, g in zip(gacc[j], grads[1:1 + len(held[j])]):
                    a.add_(g)
                send_b.append(grads[0].to(zero.dtype))
            else:
                send_b.append(zero)
        # 4. one neighbor exchange per direction per slot
        if t + 1 < sched.slots:
            wire_f = stages.shift(send_f, 1)
            wire_b = stages.shift(send_b, -1)
    _report(stats, stash, stages)
    lacc = stages.reduce(stages.reduce(lacc, "pp_sum"), "data_mean")
    hg = [stages.reduce(stages.reduce(a, "pp_sum"), "data_mean") / M
          for a in hacc]
    sg = [torch.stack([stages.reduce(gacc[j][i], "data_mean")
                       for j in range(len(held))]) / M
          for i in range(len(paths))]
    return (lacc / M, _unflatten(paths, sg), _unflatten(hpaths, hg))


# ---------------------------------------------------------------------------
# stage layout
# ---------------------------------------------------------------------------

def stack_stages(layer_params, pp: int):
    """``[L, ...]``-stacked layer params -> ``[pp, L/pp, ...]``
    stage-stacked (views)."""
    def restack(p):
        L = p.shape[0]
        if L % pp:
            raise ValueError(f"{L} layers not divisible by pp={pp}")
        return p.reshape((pp, L // pp) + tuple(p.shape[1:]))
    paths, leaves = zip(*_flatten(layer_params))
    return _unflatten(list(paths), [restack(p) for p in leaves])


def stage_scan(layer_fn):
    """Lift a per-layer fn into a stage fn looping over its own layers:
    ``stage_fn(stage_params [L/pp, ...], x)`` -> x after those layers.
    Each leaf is unbound once, so the backward stacks its gradient once."""
    def stage_fn(stage_params, x):
        paths, leaves = zip(*_flatten(stage_params))
        per_layer = list(zip(*(leaf.unbind(0) for leaf in leaves)))
        for lp in per_layer:
            x = layer_fn(x, _unflatten(list(paths), list(lp)))
        return x
    return stage_fn


__all__ = ["Schedule1F1B", "Stages", "group_stages", "local_stages",
           "stages_of", "pipeline_apply", "pipeline_grads_1f1b",
           "stack_stages", "stage_scan"]
