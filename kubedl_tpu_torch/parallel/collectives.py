"""The collectives sharded training runs, as autograd functions.

Each rank computes on its own rows of the batch and, under ``tp``, its
own heads and MLP columns. Every backward here is the exact adjoint of
its forward over the whole group, so the sum over ranks of each rank's
gradient is the gradient of the sum over ranks of each rank's loss:

* :func:`gather` all-gathers a parameter's shards before use (per layer
  for ``fsdp``) and reduce-scatters its gradient back to the shards; on
  an axis where the parameter is replicated it all-reduces the gradient;
* :func:`tp_sum` sums a row-parallel product's partial outputs over
  ``tp`` in the forward and all-reduces their gradient in the backward
  (a value every ``tp`` rank holds, used on every rank, is a sum of the
  ranks' uses);
* each rank's loss is its share of the global loss (``loss_share``): its
  rows' sum over the global count, over ``tp``'s size, so the shares
  add up to the JAX package's global mean.

Tensor-parallel serving holds the embedding table and the LM head as
each rank's vocab shard (Megatron's form): :func:`vocab_lookup` reads
the rows of the ids the rank holds and sums them over ``tp``, and
:func:`vocab_gather` all-gathers each rank's logits over its shard into
the whole vocabulary. Outside autograd (serving runs under
``torch.inference_mode``, and a decode tick is captured into a CUDA
graph) ``tp_sum`` is a bare in-place all-reduce, with no autograd
``Function`` on the path.

Every axis of size 1 is skipped: on one rank nothing here runs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_gather(x, dim: int, group, n: int):
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(g, dim: int, group, n: int):
    g = g.movedim(dim, 0).contiguous()
    out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
    dist.reduce_scatter_tensor(out, g, group=group)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    """``steps``: ``(group, size, dim)`` innermost axis first; ``dim`` is
    the tensor dim the axis shards, or None where the leaf is replicated
    over it (no gather; the gradient is all-reduced)."""

    @staticmethod
    def forward(ctx, x, steps):
        ctx.steps = steps
        for group, n, dim in steps:
            if dim is not None:
                x = _all_gather(x, dim, group, n)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for group, n, dim in reversed(ctx.steps):
            if dim is None:
                g = g.clone()
                dist.all_reduce(g, group=group)
            else:
                g = _reduce_scatter(g, dim, group, n)
        return g, None


def gather_steps(spec: tuple, mesh, gather_tp: bool) -> list:
    """The plan of :class:`_Gather` for a leaf sharded by ``spec`` (one
    entry per tensor dim: None, an axis name or a tuple of them): every
    axis of size > 1 gathers, innermost first, except ``tp`` when the
    caller computes on its ``tp`` shard (``gather_tp`` False)."""
    from .mesh import AXES
    steps = []
    for axis in reversed(AXES):
        n = mesh.size(axis)
        if n == 1:
            continue
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        dim = dims[0] if dims else None
        if axis == "tp" and dim is not None and not gather_tp:
            continue
        steps.append((mesh.group(axis), n, dim))
    return steps


def gather(local, spec: tuple, mesh, gather_tp: bool = False):
    """The compute view of a parameter shard (see :func:`gather_steps`);
    the shard itself when nothing is gathered or reduced."""
    steps = gather_steps(spec, mesh, gather_tp)
    if not steps:
        return local
    return _Gather.apply(local, steps)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def tp_sum(x, mesh):
    """Sum the ``tp`` ranks' partial outputs (row-parallel products);
    forward only when autograd does not record."""
    if not is_sharded(mesh) or mesh.size("tp") == 1:
        return x
    if not torch.is_grad_enabled():
        x = x.contiguous().clone()
        dist.all_reduce(x, group=mesh.group("tp"))
        return x
    return _SumOver.apply(x, mesh.group("tp"))


def vocab_lookup(table, ids, mesh):
    """Rows of ``ids`` from this rank's vocab shard ``table`` [V/tp, d]
    of an embedding table, summed over ``tp``: each id's row comes from
    the one rank that holds it and zeros from the others, so the sum is
    exact. Forward only (serving)."""
    tp = mesh.size("tp") if is_sharded(mesh) else 1
    if tp == 1:
        return table[ids]
    n = table.shape[0]
    local = ids - mesh.index("tp") * n
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)] * hit[..., None].to(table.dtype)
    return tp_sum(rows, mesh)


def vocab_gather(logits, mesh):
    """``[..., V/tp]`` logits over each rank's vocab shard -> ``[...,
    V]`` on every rank, shards in ``tp`` order (one all-gather; forward
    only)."""
    tp = mesh.size("tp") if is_sharded(mesh) else 1
    if tp == 1:
        return logits
    return _all_gather(logits, logits.ndim - 1, mesh.group("tp"), tp)


@torch.no_grad()
def data_sum(x, mesh):
    """``x`` summed over the data axes (``dp``, ``fsdp``), no gradient:
    the global counts the loss shares divide by (``x`` itself, detached,
    off a sharded mesh)."""
    if not is_sharded(mesh):
        return x.detach()
    x = x.detach().clone()
    for axis in ("fsdp", "dp"):
        if mesh.size(axis) > 1:
            dist.all_reduce(x, group=mesh.group(axis))
    return x


def loss_share(total, count, mesh):
    """This rank's share of a global mean: its ``total`` over the count
    summed over the data axes, over ``tp``'s size (every ``tp`` rank
    holds the same value). The shares of all ranks add up to the mean;
    off a sharded mesh it is the mean itself, ``total / count``."""
    mean = total / torch.clamp_min(data_sum(count.float(), mesh), 1.0)
    return mean / mesh.size("tp") if is_sharded(mesh) else mean


def is_sharded(mesh) -> bool:
    """Whether ``mesh`` spans more than one rank (the sharded code paths
    run); False for None and for every one-rank mesh."""
    return (mesh is not None
            and getattr(mesh, "device_mesh", None) is not None
            and mesh.sharded)


@torch.no_grad()
def world_sum(x):
    """``x`` summed over every rank of the default group."""
    x = x.detach().clone()
    dist.all_reduce(x)
    return x
