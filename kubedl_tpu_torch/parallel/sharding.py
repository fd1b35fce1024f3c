"""Sharding rules: logical param/activation axes -> mesh placements. The
counterpart of ``kubedl_tpu/parallel/sharding.py``.

A spec is a tuple with one entry per tensor dim, each None, a mesh-axis
name or a tuple of them: the ``PartitionSpec`` of the JAX package, with
the same :data:`LOGICAL_RULES` and :func:`spec`. On a mesh it becomes
``torch.distributed.tensor`` placements, one per mesh dim
(:func:`placements`): an axis that shards tensor dim ``d`` is
``Shard(d)``, every other axis ``Replicate()``. ``("dp", "fsdp")`` on one
dim is ``Shard(d)`` on both mesh dims in that order, dp major: JAX's
major-to-minor split.

:func:`shard_tree` places a tree by its specs as ``DTensor`` leaves. Every
rank holds the full host tree (the same seed or the same artifact) and
keeps its own chunk, so placing needs no communication. Compute takes
:func:`views`: each leaf a :class:`ShardedTensor` (the rank's shard, its
spec and the mesh) that the model turns into the tensor it multiplies
with ``collectives.gather`` where it uses the weight, one layer at a
time. Shards are equal: a dim must divide by its axes' sizes.

The rules follow the megatron/maxtext conventions of the JAX package:
column-parallel weights (d_model -> hidden) shard their output dim on
``tp`` and input dim on ``fsdp``, row-parallel weights the reverse,
norms replicate, and the batch shards over ``(dp, fsdp)``, its sequence
over ``cp``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .collectives import gather
from .mesh import AXES

# logical axis name -> mesh axes
LOGICAL_RULES = {
    "batch": ("dp", "fsdp"),
    "seq": "cp",
    "embed": "fsdp",      # d_model dim of params (fsdp-sharded storage)
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "vocab": "tp",
    "experts": "ep",      # MoE expert dim of stacked expert weights
    "stages": "pp",       # leading stage dim of pipeline-stacked params
    "layers": None,
    "norm": None,
    "head_dim": None,
}


def spec(*logical_axes) -> tuple:
    """Translate logical axis names to a spec (one entry per dim)."""
    return tuple(LOGICAL_RULES.get(a) if a is not None else None
                 for a in logical_axes)


def map_specs(fn, spec_tree, *trees):
    """``fn(spec, *leaves)`` over a spec tree (dicts and lists; a spec is
    a tuple, so tuples are leaves) and trees of its structure."""
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, spec_tree[k], *(t[k] for t in trees))
                for k in spec_tree}
    if isinstance(spec_tree, list):
        return [map_specs(fn, s, *(t[i] for t in trees))
                for i, s in enumerate(spec_tree)]
    return fn(spec_tree, *trees)


def spec_leaves(spec_tree, prefix: str = "") -> dict:
    """``{path: spec}`` of a spec tree, paths as ``train.trainer``'s
    ``tree_leaves`` names a param tree's leaves (``layers/wq``)."""
    if isinstance(spec_tree, dict):
        items = [(k, spec_tree[k]) for k in sorted(spec_tree)]
    elif isinstance(spec_tree, list):
        items = list(enumerate(spec_tree))
    else:
        return {prefix[:-1]: spec_tree}
    out = {}
    for key, sub in items:
        out.update(spec_leaves(sub, f"{prefix}{key}/"))
    return out


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _sharded_dims(spec_: tuple) -> dict:
    """``{mesh axis: tensor dim}`` of a spec, with the JAX rules checked:
    an axis shards at most one dim, and the axes on one dim are in mesh
    order (the order a DTensor splits them)."""
    out = {}
    for d, entry in enumerate(spec_):
        axes = _axes_of(entry)
        if list(axes) != sorted(axes, key=AXES.index):
            raise ValueError(f"spec {spec_}: the axes of dim {d} must be "
                             f"in mesh order {AXES}")
        for a in axes:
            if a not in AXES:
                raise ValueError(f"spec {spec_}: unknown mesh axis {a!r}")
            if a in out:
                raise ValueError(f"spec {spec_}: axis {a!r} shards two dims")
            out[a] = d
    return out


def placements(spec_: tuple) -> list:
    """DTensor placements of ``spec_``, one per mesh dim (``AXES``)."""
    from torch.distributed.tensor import Replicate, Shard
    dims = _sharded_dims(spec_)
    return [Shard(dims[a]) if a in dims else Replicate() for a in AXES]


def spec_of(placements_) -> tuple:
    """The spec a DTensor's placements express (inverse of
    :func:`placements`; trailing unsharded dims are dropped)."""
    from torch.distributed.tensor import Shard
    per_dim = {}
    for axis, p in zip(AXES, placements_):
        if isinstance(p, Shard):
            per_dim.setdefault(p.dim, []).append(axis)
    n = max(per_dim, default=-1) + 1
    return tuple(None if d not in per_dim
                 else (per_dim[d][0] if len(per_dim[d]) == 1
                       else tuple(per_dim[d])) for d in range(n))


def tree_shardings(mesh, spec_tree):
    """The placements of every leaf (``NamedSharding``'s analogue)."""
    return map_specs(lambda s: placements(s), spec_tree)


def local_shard(full: torch.Tensor, mesh, spec_: tuple) -> torch.Tensor:
    """This rank's chunk of ``full`` under ``spec_`` (a view)."""
    for axis, d in sorted(_sharded_dims(spec_).items(),
                          key=lambda kv: AXES.index(kv[0])):
        n = mesh.size(axis)
        if n == 1:
            continue
        if full.shape[d] % n:
            raise ValueError(
                f"dim {d} of a {tuple(full.shape)} leaf does not split "
                f"over {axis}={n} (spec {spec_}): shards must be equal")
        full = full.chunk(n, d)[mesh.index(axis)]
    return full


def distribute(full: torch.Tensor, mesh, spec_: tuple):
    """``full`` placed by ``spec_``: a DTensor on a mesh with a process
    group, else ``full`` on the mesh's device."""
    if mesh.device_mesh is None:
        return full.to(mesh.device)
    from torch.distributed.tensor import DTensor
    local = local_shard(full, mesh, spec_).to(mesh.device).contiguous()
    return DTensor.from_local(local, mesh.device_mesh, placements(spec_),
                              run_check=False, shape=full.shape,
                              stride=full.contiguous().stride())


def shard_tree(tree, mesh, spec_tree):
    """Place a tree of full tensors by its specs (``device_put``'s
    analogue)."""
    return map_specs(lambda s, x: distribute(x.detach(), mesh, s),
                     spec_tree, tree)


def empty_like_placed(global_shape, dtype, mesh, spec_: tuple):
    """An uninitialized tensor of ``global_shape`` placed by ``spec_``:
    the restore target of one leaf (``ShapeDtypeStruct`` with a
    sharding)."""
    if mesh.device_mesh is None:
        return torch.empty(global_shape, dtype=dtype, device=mesh.device)
    from torch.distributed.tensor import DTensor
    meta = torch.empty(global_shape, dtype=dtype, device="meta")
    local = torch.empty_like(local_shard(meta, mesh, spec_),
                             device=mesh.device)
    return DTensor.from_local(local, mesh.device_mesh, placements(spec_),
                              run_check=False, shape=meta.shape,
                              stride=meta.stride())


def full_tensor(x):
    """The whole tensor of a placed leaf (an all-gather for a DTensor,
    which every rank of the group must join)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def local_of(x):
    """The rank's own tensor of a placed leaf (the shard of a DTensor,
    the tensor itself otherwise): an alias, for in-place updates."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        with torch.no_grad():
            return x.to_local()
    return x


@dataclass(frozen=True)
class ShardedTensor:
    """A parameter as a sharded step sees it: this rank's shard, the spec
    that cut it and the mesh. The model turns it into the tensor it
    computes with (:func:`materialize`), so an unconverted use fails
    loudly instead of computing on a shard. ``w[i]`` and ``w.unbind(0)``
    slice the leading (layer) axis, which is never sharded."""
    local: torch.Tensor
    spec: tuple
    mesh: object

    def _drop_lead(self):
        if self.spec and self.spec[0] is not None:
            raise ValueError(f"cannot slice sharded dim 0 (spec "
                             f"{self.spec})")
        return self.spec[1:]

    def __getitem__(self, i):
        return ShardedTensor(self.local[i], self._drop_lead(), self.mesh)

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("sharded weights unbind along their layer axis")
        rest = self._drop_lead()
        return [ShardedTensor(t, rest, self.mesh)
                for t in self.local.unbind(0)]

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def shape(self) -> tuple:
        """The global shape (the shard's, times each dim's axis sizes)."""
        shape = list(self.local.shape)
        for axis, d in _sharded_dims(self.spec).items():
            shape[d] *= self.mesh.size(axis)
        return tuple(shape)


def view(x, mesh, requires_grad: bool = False):
    """A placed leaf as a :class:`ShardedTensor` over an alias of its
    shard (a fresh autograd leaf when ``requires_grad``); a plain tensor
    passes through."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    local = local_of(x).detach()
    if requires_grad:
        local.requires_grad_(True)
    return ShardedTensor(local, spec_of(x.placements), mesh)


def views(tree, mesh, requires_grad: bool = False):
    """:func:`view` over a tree of placed leaves (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: views(v, mesh, requires_grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [views(v, mesh, requires_grad) for v in tree]
    return view(tree, mesh, requires_grad)


def materialize(w, gather_tp: bool = False):
    """The tensor the model computes with: a :class:`ShardedTensor`
    all-gathered over every axis but ``tp`` (and over ``tp`` too with
    ``gather_tp``), a wrapped weight (``LoraTensor`` ...) field by field;
    anything else as it is."""
    if isinstance(w, ShardedTensor):
        return gather(w.local, w.spec, w.mesh, gather_tp)
    arrays = getattr(w, "_arrays", ())
    if arrays and any(isinstance(getattr(w, f), ShardedTensor)
                      for f in arrays):
        import dataclasses
        return dataclasses.replace(
            w, **{f: materialize(getattr(w, f), gather_tp) for f in arrays})
    return w
