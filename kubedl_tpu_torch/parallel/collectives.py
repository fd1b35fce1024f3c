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
  rows' sum over the global count (its tokens: the ``cp`` ranks hold
  different tokens of the same rows), over the sizes of ``tp`` and
  ``ep`` (whose ranks hold the same tokens), so the shares add up to the
  JAX package's global mean.

Context and expert parallelism move activations:

* :func:`ring_shift` hands a tensor to the next rank of the ``cp`` ring
  and takes the previous rank's (``dist.batch_isend_irecv``; a gloo
  group stages CUDA tensors through the host, counted in
  ``ring_shift.host_staged``); its backward shifts the gradient back;
* :func:`all_to_all` is the tiled all-to-all between heads and sequence
  of Ulysses attention; its backward is the reverse all-to-all;
* :func:`ep_sum` sums the ``ep`` ranks' partial expert outputs as
  ``tp_sum`` sums ``tp``'s, and expert stacks sharded on ``ep`` stay
  local in :func:`gather` as a ``tp`` shard does;
* :func:`cp_sum` adds per-row sums over the ``cp`` ranks' slices of the
  sequence (evaluation's row NLL, DPO's sequence log-probabilities);
* :func:`pp_shift` is the pipeline's neighbor exchange (stage ``s`` to
  ``s + 1`` for activations, back for cotangents), outside autograd: the
  pipeline writes its backward out (``parallel/pipeline.py``). A stage
  leaf stays local in :func:`gather`, and the trainer sums the gradients
  of the leaves every stage holds over ``pp``.

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
    caller computes on its ``tp`` shard (``gather_tp`` False) and ``ep``
    (an expert stack's rank computes on its own experts). An axis the
    leaf is replicated over (``cp`` always, ``ep`` for every leaf but the
    expert stacks) all-reduces the gradient. ``pp`` takes no step: a
    stage computes on its own layers, and a leaf every stage holds (the
    embedding, the head) has its gradient summed over ``pp`` by the
    trainer, after the pipeline's backward, since not every stage uses
    it."""
    from .mesh import AXES
    steps = []
    for axis in reversed(AXES):
        n = mesh.size(axis)
        if n == 1 or axis == "pp":
            continue
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        dim = dims[0] if dims else None
        if dim is not None and (axis == "ep"
                                or (axis == "tp" and not gather_tp)):
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


def _sum_over(x, mesh, axis: str):
    if not is_sharded(mesh) or mesh.size(axis) == 1:
        return x
    if not torch.is_grad_enabled():
        x = x.contiguous().clone()
        dist.all_reduce(x, group=mesh.group(axis))
        return x
    return _SumOver.apply(x, mesh.group(axis))


def tp_sum(x, mesh):
    """Sum the ``tp`` ranks' partial outputs (row-parallel products);
    forward only when autograd does not record."""
    return _sum_over(x, mesh, "tp")


def ep_sum(x, mesh):
    """Sum the ``ep`` ranks' partial expert outputs (each rank's experts'
    share of the combine), as :func:`tp_sum` sums ``tp``'s."""
    return _sum_over(x, mesh, "ep")


def cp_sum(x, mesh):
    """Sum per-row partial sums over the ``cp`` ranks, each of which holds
    a slice of every row's sequence (a row's summed log-probability or
    NLL), as :func:`tp_sum` sums ``tp``'s; the backward all-reduces the
    gradient, so a loss every ``cp`` rank takes a share of reaches each
    rank's own positions."""
    return _sum_over(x, mesh, "cp")


def _shift(x, group, n: int, step: int, counter=None, ring: bool = True):
    """``x`` sent ``step`` places along ``group``'s ranks (rank ``r`` to
    ``r + step``); returns the tensor rank ``r - step`` sent. On a
    ``ring`` the ends wrap around; on a chain an end sends or receives
    nothing, and a rank that receives nothing gets zeros. CUDA tensors on
    a gloo group go through the host, counted in ``counter.host_staged``
    (``ring_shift``'s by default): gloo's point-to-point calls take host
    memory only."""
    me = dist.get_rank(group)
    to, frm = me + step, me - step
    if ring:
        to, frm = to % n, frm % n
    x = x.contiguous()
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        (counter or ring_shift).host_staged += 1
        x = x.cpu()
    out = torch.zeros_like(x) if not 0 <= frm < n else torch.empty_like(x)
    ops = []
    if 0 <= to < n:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, to),
                              group))
    if 0 <= frm < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, frm), group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return out.cuda() if staged else out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _shift(x, group, n, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, ctx.n, -1), None, None


def ring_shift(x, mesh, axis: str = "cp"):
    """``x`` handed to the next rank of ``axis``'s ring, the previous
    rank's returned (``lax.ppermute`` by ``j -> j + 1``); the backward
    hands the gradient back the other way. Outside autograd a bare
    exchange."""
    n = mesh.size(axis)
    if n == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _RingShift.apply(x, mesh.group(axis), n)
    return _shift(x, mesh.group(axis), n, 1)


#: CUDA tensors a gloo ring shift carried through the host (a NCCL group
#: never does)
ring_shift.host_staged = 0


def pp_shift(x, mesh, step: int, axis: str = "pp"):
    """The pipeline's neighbor exchange: ``x`` handed from stage ``s`` to
    stage ``s + step`` of ``axis`` (``step`` 1 carries activations
    forward, -1 cotangents back), the tensor stage ``s - step`` sent
    returned; the first stage to receive along ``step`` gets zeros, and
    the last one's send goes nowhere (a chain, not a ring: JAX's
    ``ppermute`` wraps, and the pipeline masks what wrapped). A bare
    exchange: the pipeline writes its backward out
    (``parallel/pipeline.py``), so no autograd records it. Every stage
    calls it at every slot, so the sends and receives pair up in one
    order on every rank."""
    n = mesh.size(axis)
    if n == 1:
        return torch.zeros_like(x)
    return _shift(x, mesh.group(axis), n, step, counter=pp_shift, ring=False)


#: CUDA tensors a gloo pipeline exchange carried through the host
pp_shift.host_staged = 0


def _a2a(x, group, n: int, split_dim: int, concat_dim: int):
    """Tiled all-to-all: chunk ``j`` of ``x`` along ``split_dim`` goes to
    rank ``j``, and the chunks received are concatenated in rank order
    along ``concat_dim``."""
    parts = x.movedim(split_dim, 0)
    parts = parts.reshape((n, parts.shape[0] // n) + tuple(parts.shape[1:]))
    parts = parts.contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    # out[j] is rank j's chunk of this rank's split: [n, c, ...] with the
    # split dim leading; put it back, then lay the n chunks along concat
    out = out.movedim(1, split_dim + 1)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = (group, n, split_dim, concat_dim)
        return _a2a(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, n, split_dim, concat_dim = ctx.args
        return _a2a(g, group, n, concat_dim, split_dim), None, None, None, \
            None


def all_to_all(x, mesh, split_dim: int, concat_dim: int, axis: str = "cp"):
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` cut into ``axis``'s size chunks along ``split_dim``, chunk ``j``
    sent to rank ``j``, the received chunks laid in rank order along
    ``concat_dim``. Its backward is the reverse all-to-all."""
    n = mesh.size(axis)
    if n == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, mesh.group(axis), n, split_dim, concat_dim)
    return _a2a(x, mesh.group(axis), n, split_dim, concat_dim)


def all_gather(x, mesh, dim: int, axis: str = "cp"):
    """``x`` all-gathered over ``axis`` along ``dim`` (tiled, rank order);
    the backward reduce-scatters the gradient back to the shards."""
    n = mesh.size(axis)
    if n == 1:
        return x
    steps = [(mesh.group(axis), n, dim)]
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, steps)
    return _all_gather(x, dim, mesh.group(axis), n)


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
def data_sum(x, mesh, axes=("cp", "fsdp", "dp")):
    """``x`` summed over the axes whose ranks hold different tokens: the
    data axes (``dp``, ``fsdp``) and ``cp`` (each rank a slice of the
    sequence); ``axes`` names fewer (a value :func:`cp_sum` already
    summed over ``cp`` takes the data axes only). No gradient: the global
    counts the loss shares divide by (``x`` itself, detached, off a
    sharded mesh)."""
    if not is_sharded(mesh):
        return x.detach()
    x = x.detach().clone()
    for axis in axes:
        if mesh.size(axis) > 1:
            dist.all_reduce(x, group=mesh.group(axis))
    return x


def loss_share(total, count, mesh):
    """This rank's share of a global mean: its ``total`` over the count
    summed over the token axes (:func:`data_sum`), over the sizes of
    ``tp`` and ``ep`` (every rank of either holds the same value). The
    shares of all ranks add up to the mean; off a sharded mesh it is the
    mean itself, ``total / count``."""
    mean = total / torch.clamp_min(data_sum(count.float(), mesh), 1.0)
    if not is_sharded(mesh):
        return mean
    return mean / (mesh.size("tp") * mesh.size("ep"))


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
