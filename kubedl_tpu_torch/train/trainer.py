"""Training loop, on one card or sharded over a process group's mesh:
the counterpart of ``kubedl_tpu/train/trainer.py``.

* ``Trainer.step``: the loss and its gradients by autograd (accumulated in
  float32 over ``accum_steps`` micro-batches), then one optimizer update;
* the optimizer is the JAX package's optax chain written out on tensors
  (:func:`make_optimizer`): global-norm clip, Adam with a float32 first
  moment and a second moment in the parameter's dtype (optax 0.2.6's
  ``scale_by_adam`` default), weight decay on every leaf, and a
  warmup-cosine learning rate read at the pre-increment count; the update
  is formed in float32 and cast back to the parameter's dtype (bf16
  weights keep no float32 master copy, as in the JAX trainer);
* unlike the JAX step, which returns new arrays, the update is applied in
  place, leaf by leaf, so no second copy of the parameters or of the
  float32 updates is ever alive.

With ``param_specs`` and a ``mesh`` over a process group
(``parallel/mesh.py``), the state is sharded as the JAX trainer's is:

* ``init_state`` places each param by its spec as a ``DTensor``
  (``parallel.sharding.shard_tree``), and ``mu``/``nu`` mirror their
  param's placement (the JAX ``_opt_specs``);
* the step hands ``loss_fn`` a tree of ``ShardedTensor`` views over
  aliases of the shards; the model gathers each weight where it uses it
  (per layer, so ``fsdp`` holds one layer whole at a time) and the
  gathers' backward reduce-scatters the gradients back to the shards
  (``parallel/collectives.py``). ``loss_fn(params, batch)`` gets this
  rank's rows and returns its *share* of the global loss (the families'
  ``loss_fn`` with ``mesh=``); the shares of all ranks add up to the
  JAX package's global mean, and the step returns that sum;
* under ``pp`` each rank holds its own stage's layers (a ``[1, L/pp,
  ...]`` shard of every ``stages`` leaf) and the leaves outside the
  stages whole; the pipeline's backward gives each stage its layers'
  gradients, and the step sums the other leaves' gradients over ``pp``
  (stage 0 uses the embedding, the last stage the head);
* the optimizer runs on the local shards, leaf by leaf, exactly the
  one-card update, with one ``all_reduce`` for the global norm: each
  sharded leaf's sum of squares is taken on its shard (``g*g`` in the
  leaf's dtype, summed in float32 and rounded to the leaf's dtype once,
  where one card rounds the one sum), counted once over the ranks that
  replicate it, and summed over all ranks. The update is elementwise, so
  running it on shards is the same arithmetic as on the whole leaf, and
  a local update needs no DTensor rule for the ``_weak`` scalars; that is
  why the optimizer takes local shards and not DTensors.

At world size 1 every collective is skipped and the losses, gradients
and updates are the one-card path's, bit for bit. With ``accum_steps >
1`` each rank splits its own rows into micro-batches: micro-batch ``i``
is the union of the ranks' ``i``-th slices, where the JAX step takes
rows ``[i*b/n, (i+1)*b/n)`` of the global batch (the same mean when no
mask weights the rows differently). Checkpoints are
``train/checkpoint.py``.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device


@dataclass
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    accum_steps: int = 1
    seed: int = 0
    #: torch.profiler trace directory ("" = off): one chrome trace of the
    #: window [profile_start_step, profile_start_step + profile_steps)
    profile_dir: str = ""
    profile_start_step: int = 10   # skip warmup steps
    profile_steps: int = 3


@dataclass
class AdamState:
    """Optimizer state: the update count (the schedule's and Adam's, which
    advance together) and the moments, keyed like :func:`tree_leaves`."""
    count: int
    mu: dict
    nu: dict


@dataclass
class TrainState:
    step: int
    params: dict
    opt_state: AdamState


def tree_leaves(tree, prefix: str = "") -> list:
    """``[(path, tensor)]`` of nested dicts and lists in the JAX package's
    leaf order (dict keys sorted, lists in index order), paths
    ``/``-joined (``stages/0/1/conv1``)."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix[:-1], tree)]
    out = []
    for key, sub in items:
        out += tree_leaves(sub, f"{prefix}{key}/")
    return out


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts and lists, keeping the
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def warmup_cosine_schedule(init_value: float, peak_value: float,
                           warmup_steps: int, decay_steps: int,
                           end_value: float) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` in float32: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    to ``end_value`` at ``decay_steps`` (warmup included)."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"the cosine needs decay_steps > warmup_steps, got "
                         f"{decay_steps} <= {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) \
                / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac
                         + f32(peak_value))
        t = f32(min(count - warmup_steps, span))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(span)))
        return float(f32(peak_value) * (f32(1 - alpha) * cos + f32(alpha)))

    return schedule


class Optimizer:
    """``trainer.py:make_optimizer``'s chain, exactly, on a dict of
    tensors: ``clip_by_global_norm(grad_clip)``, ``scale_by_adam(beta1,
    beta2, eps=1e-8, mu_dtype=float32)``,
    ``add_decayed_weights(weight_decay)`` and
    ``scale_by_learning_rate(schedule)``, as the jitted JAX step computes
    it. Each operation keeps JAX's dtype rules: a bf16 gradient squares,
    clips and enters the second moment in bf16, a Python scalar is first
    rounded to its tensor's dtype (:func:`_weak`), and float32 gradients
    (accumulated micro-batches) widen the second moment to float32, as
    JAX's promotion does."""

    eps = 1e-8

    def __init__(self, config: TrainConfig):
        self.config = config
        self.schedule = warmup_cosine_schedule(
            0.0, config.learning_rate, config.warmup_steps,
            max(config.decay_steps, config.warmup_steps + 1),
            config.learning_rate * 0.1)

    def init(self, params: dict) -> AdamState:
        leaves = tree_leaves(params)
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in leaves},
            nu={k: torch.zeros_like(p) for k, p in leaves})

    @torch.no_grad()
    def apply(self, params: dict, grads: dict, state: AdamState,
              sq_sums: Optional[dict] = None) -> AdamState:
        """One update of ``params`` in place from ``grads`` (keyed like
        :func:`tree_leaves`); returns the new state. ``sq_sums`` gives
        each leaf's sum of squares in its dtype when ``grads`` are shards
        (the sharded trainer's global values); by default each leaf's
        own."""
        c = self.config
        leaves = tree_leaves(params)
        # clip_by_global_norm: sqrt of the per-leaf sums of squares, each
        # in its leaf's dtype, summed in leaf order (0-dim promotion)
        total = 0
        for k, _ in leaves:
            g = grads[k]
            total = total + (sq_sums[k] if sq_sums is not None
                             else (g * g).sum())
        g_norm = torch.sqrt(total)
        keep = g_norm < c.grad_clip
        count = state.count + 1
        bc1 = 1 - torch.tensor(c.beta1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(c.beta2, dtype=torch.float32) ** count
        lr = torch.tensor(-self.schedule(state.count), dtype=torch.float32)
        mu, nu = dict(state.mu), dict(state.nu)
        for k, p in leaves:
            g = grads[k]
            g = torch.where(keep, g, (g / g_norm.to(g.dtype))
                            * _weak(c.grad_clip, g))
            # mu is float32: XLA forms (1 - b1) * g straight in float32
            # (the bf16 rounding between the product and the sum is
            # elided), so the product is taken in mu's dtype here too
            m = mu[k].mul_(_weak(c.beta1, mu[k])).add_(
                _weak(1 - c.beta1, g).to(mu[k].dtype) * g.to(mu[k].dtype))
            v = _weak(1 - c.beta2, g) * (g * g) \
                + _weak(c.beta2, nu[k]) * nu[k]
            nu[k] = v
            u = m / bc1.to(m.device)
            den = (v / bc2.to(device=v.device, dtype=v.dtype)).sqrt_()
            u.div_(den.add_(_weak(self.eps, den)))
            u.add_(_weak(c.weight_decay, p) * p)
            u.mul_(lr.to(device=u.device, dtype=u.dtype))
            p.copy_(u.add_(p))
        return AdamState(count=count, mu=mu, nu=nu)


def _weak(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar the way JAX's weak typing applies it to an array:
    first rounded to the array's dtype (0.1 is 0.10009765625 beside a
    bf16 array)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def make_optimizer(config: TrainConfig) -> Optimizer:
    return Optimizer(config)


class Trainer:
    """Wires ``loss_fn(params, batch) -> scalar`` to autograd and the
    optimizer on one device (the card unless ``device="cpu"``), or, with
    ``param_specs`` and a ``mesh`` over a process group, on this rank's
    shards of the state (see the module docstring)."""

    def __init__(self, loss_fn: Callable, config: Optional[TrainConfig] = None,
                 device=None, *, param_specs=None, mesh=None):
        self.loss_fn = loss_fn
        self.config = config or TrainConfig()
        self.optimizer = make_optimizer(self.config)
        if (param_specs is None) != (mesh is None):
            raise ValueError("param_specs and mesh come together")
        self.param_specs = param_specs
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else device

    @property
    def sharded(self) -> bool:
        """Whether the state lives as shards over a process group."""
        return self.mesh is not None and self.mesh.device_mesh is not None

    def init_state(self, params: dict) -> TrainState:
        """Params on the trainer's device as grad-requiring leaves, and
        zero moments (float32 ``mu``, ``nu`` in each param's dtype); under
        a mesh, every leaf placed by its spec (params, and the moments
        like their param)."""
        dev = resolve_device(self.device)
        self.device = dev
        if self.sharded:
            from ..parallel.sharding import shard_tree
            placed = shard_tree(params, self.mesh, self.param_specs)
            leaves = tree_leaves(placed)
            return TrainState(step=0, params=placed, opt_state=AdamState(
                count=0,
                mu={k: _zeros_placed(p, torch.float32) for k, p in leaves},
                nu={k: _zeros_placed(p, p.dtype) for k, p in leaves}))

        params = tree_map(
            lambda v: v.detach().to(dev).requires_grad_(True), params)
        return TrainState(step=0, params=params,
                          opt_state=self.optimizer.init(params))

    def remesh(self, mesh) -> None:
        """Adopt a new mesh (an elastic resize, ``docs/elastic.md``): the
        next :meth:`init_state` or :meth:`abstract_state` places by it. The
        caller restores the state into :meth:`abstract_state` on the new
        mesh, so a resize never re-initializes: the step counter and the
        loss curve continue where the checkpoint left them."""
        if (self.param_specs is None) != (mesh is None):
            raise ValueError("param_specs and mesh come together")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else self.device

    @property
    def placement_mesh(self):
        """The mesh the state and the batches live on: ``mesh``, or the
        one-device mesh of the trainer's device."""
        if self.mesh is not None:
            return self.mesh
        from ..parallel.mesh import AXES, Mesh
        return Mesh(device=resolve_device(self.device),
                    shape={a: 1 for a in AXES})

    def abstract_state(self, state: TrainState) -> TrainState:
        """Restore target for this trainer's placement (see
        ``checkpoint.abstract_state_like``)."""
        from .checkpoint import abstract_state_like
        specs = (self.param_specs if self.mesh is not None
                 else tree_map(lambda t: (), state.params))
        return abstract_state_like(state, self.placement_mesh, specs)

    def _value_and_grad(self, params: dict, batch: dict):
        from ..parallel.sharding import ShardedTensor
        leaves = [(k, p.local if isinstance(p, ShardedTensor) else p)
                  for k, p in tree_leaves(params)]
        loss = self.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                    allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: g for (k, _), g in zip(leaves, grads)}

    def step(self, state: TrainState, batch: dict):
        """One optimizer step on ``batch``; ``accum_steps > 1`` splits it
        into that many micro-batches along dim 0 and averages their
        losses and float32 gradients. Returns (new state, loss). The two
        halves run under ``torch.profiler`` ranges ``train.loss_and_grads``
        and ``train.optimizer``, which a profile window (``profile_dir``)
        records."""
        if self.sharded:
            return self._sharded_step(state, batch)
        with torch.profiler.record_function("train.loss_and_grads"):
            loss, grads = self._grads(state.params, batch)
        with torch.profiler.record_function("train.optimizer"):
            opt = self.optimizer.apply(state.params, grads, state.opt_state)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt), loss

    def _sharded_step(self, state: TrainState, batch: dict):
        from ..parallel import collectives
        from ..parallel.sharding import local_of, views
        mesh = self.mesh
        with torch.profiler.record_function("train.loss_and_grads"):
            view = views(state.params, mesh, requires_grad=True)
            batch = {k: local_of(v) for k, v in batch.items()}
            share, grads = self._grads(view, batch)
            if mesh.size("pp") > 1:
                self._sum_over_stages(state.params, grads)
            loss = collectives.world_sum(share)
        with torch.profiler.record_function("train.optimizer"):
            params = tree_map(local_of, state.params)
            opt = state.opt_state
            mu = {k: local_of(v) for k, v in opt.mu.items()}
            nu = {k: local_of(v) for k, v in opt.nu.items()}
            new = self.optimizer.apply(
                params, grads, AdamState(count=opt.count, mu=mu, nu=nu),
                sq_sums=self._sq_sums(state.params, grads))
            # nu is a new tensor each update: rewrap it in nu's placement
            nu = {k: _rewrap(new.nu[k], opt.nu[k]) for k in opt.nu}
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=AdamState(count=new.count, mu=opt.mu,
                                              nu=nu)), loss

    def _sum_over_stages(self, placed: dict, grads: dict) -> None:
        """Under ``pp``, sum over the stages the gradient of every leaf
        each stage holds whole (the embedding, the final norm, the head):
        stage 0 uses the embedding and the last stage the head (a tied
        one both), so every rank's copy takes the one update. A stage
        leaf (sharded on ``pp``) keeps its own."""
        import torch.distributed as dist

        from ..parallel.sharding import spec_of
        group = self.mesh.group("pp")
        for k, p in tree_leaves(placed):
            spec = spec_of(p.placements)
            if not any(e == "pp" or (isinstance(e, tuple) and "pp" in e)
                       for e in spec):
                dist.all_reduce(grads[k], group=group)

    def _sq_sums(self, placed: dict, grads: dict) -> dict:
        """Each leaf's global sum of squares of its gradient, in the
        leaf's dtype: a replicated leaf's own; a sharded leaf's shard
        sums (float32), counted once per replica set and summed over all
        ranks in one ``all_reduce``."""
        import torch.distributed as dist

        from ..parallel.mesh import AXES
        from ..parallel.sharding import spec_of
        mesh = self.mesh
        live = [a for a in AXES if mesh.size(a) > 1]
        out, keys, parts = {}, [], []
        for k, p in tree_leaves(placed):
            g = grads[k]
            spec = spec_of(p.placements)
            on = {a for e in spec if e is not None
                  for a in (e if isinstance(e, tuple) else (e,))}
            shard_axes = [a for a in live if a in on]
            if not shard_axes:
                out[k] = (g * g).sum()
                continue
            first = all(mesh.index(a) == 0 for a in live
                        if a not in shard_axes)
            keys.append(k)
            parts.append((g * g).sum(dtype=torch.float32) if first
                         else torch.zeros((), dtype=torch.float32,
                                          device=g.device))
        if parts:
            total = torch.stack(parts)
            dist.all_reduce(total)
            for k, v in zip(keys, total):
                out[k] = v.to(grads[k].dtype)
        return out

    def _grads(self, params: dict, batch: dict):
        n = self.config.accum_steps
        if n == 1:
            return self._value_and_grad(params, batch)
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"accum_steps={n} micro-batches")
        loss, grads = torch.zeros((), dtype=torch.float32), None
        for i in range(n):
            micro = {k: v.reshape((n, rows // n) + tuple(v.shape[1:]))[i]
                     for k, v in batch.items()}
            mloss, mgrads = self._value_and_grad(params, micro)
            loss = loss.to(mloss.device) + mloss.float()
            if grads is None:
                grads = {k: torch.zeros_like(g, dtype=torch.float32)
                         for k, g in mgrads.items()}
            for k, g in mgrads.items():
                grads[k].add_(g)
            del mgrads
        for g in grads.values():
            g.div_(n)
        return loss / n, grads

    def fit(self, state: TrainState, batches, num_steps: int,
            log_every: int = 10, on_step=None, checkpoint_manager=None,
            elastic_agent=None, eval_every: int = 0, eval_fn=None,
            data_state_fn=None, tracer=None):
        """Training loop, in the JAX package's order after each step:
        ``on_step(step, loss)``, the elastic agent's poll (an
        operator-requested checkpoint is taken between steps; every rank
        polls here, at the same point of every step, since the agent
        pairs one host broadcast per poll across the group), the
        checkpoint manager's periodic save, the log line, then
        ``eval_fn(state) -> dict`` every ``eval_every`` steps and after
        the last one. At the end a forced save and a wait for it.
        ``data_state_fn() -> dict`` supplies the data cursor stored with
        every checkpoint. ``tracer`` (``kubedl_tpu_torch.trace.Tracer``,
        enabled) records one ``train.step`` span per step with its tokens
        and replica, and ``train.checkpoint`` spans, attached to
        ``$KUBEDL_TRACEPARENT``'s trace when the operator injected one."""
        tr = tracer if tracer is not None and tracer.enabled else None
        trace_id = parent_id = None
        replica = ""
        if tr is not None:
            from ..trace import ENV_TRACEPARENT, parse_traceparent
            ctx = parse_traceparent(os.environ.get(ENV_TRACEPARENT, ""))
            if ctx is not None:
                trace_id, parent_id = ctx
            else:
                trace_id = tr.new_trace_id()
            # which worker this is (the operator injects TPU_WORKER_ID);
            # the telemetry layer compares step-time skew across replicas
            replica = (os.environ.get("TPU_WORKER_ID")
                       or os.environ.get("HOSTNAME", ""))

        def span(name, t0, **attrs):
            if tr is not None:
                tr.record(name, t0, time.time(), trace_id=trace_id,
                          parent_id=parent_id, component="train",
                          attributes=attrs)

        def data_state():
            return data_state_fn() if data_state_fn else None

        cfg = self.config
        t0 = time.time()
        tokens = 0
        step0 = state.step
        profile_at = -1
        if cfg.profile_dir and cfg.profile_steps > 0:
            profile_at = min(cfg.profile_start_step, max(num_steps - 1, 0))
        prof = None
        try:
            for i in range(num_steps):
                if i == profile_at:
                    prof = _start_profile()
                batch = next(batches)
                step_tokens = _batch_tokens(batch)
                tokens += step_tokens
                t_step = time.time()
                state, loss = self.step(state, batch)
                span("train.step", t_step, step=step0 + i + 1,
                     tokens=step_tokens, replica=replica)
                if prof is not None and i + 1 >= profile_at + cfg.profile_steps:
                    _stop_profile(prof, cfg.profile_dir, step0 + i + 1)
                    prof = None
                if on_step is not None:
                    on_step(state.step, float(loss))
                if elastic_agent is not None:
                    elastic_agent.poll(state)
                if checkpoint_manager is not None:
                    t_ck = time.time()
                    checkpoint_manager.save(state, step=step0 + i + 1,
                                            periodic=True,
                                            data_state=data_state())
                    span("train.checkpoint", t_ck, step=step0 + i + 1,
                         periodic=True)
                if log_every and (i + 1) % log_every == 0:
                    dt = time.time() - t0
                    print(f"step {state.step} loss {float(loss):.4f} "
                          f"{tokens / dt:.0f} tok/s")
                if eval_fn is not None and eval_every and \
                        ((i + 1) % eval_every == 0 or i + 1 == num_steps):
                    res = eval_fn(state)
                    print(f"step {state.step} eval "
                          + " ".join(f"{k} {v:.4f}" if isinstance(v, float)
                                     else f"{k} {v}"
                                     for k, v in res.items()))
        finally:
            if prof is not None:
                _stop_profile(prof, cfg.profile_dir, state.step)
        if checkpoint_manager is not None:
            t_ck = time.time()
            checkpoint_manager.save(state, force=True,
                                    data_state=data_state())
            checkpoint_manager.wait_until_finished()
            span("train.checkpoint", t_ck, step=state.step, periodic=False)
        return state


def _zeros_placed(p, dtype):
    """Zeros in ``p``'s placement (a DTensor's shard) and ``dtype``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(
        torch.zeros_like(p.to_local(), dtype=dtype), p.device_mesh,
        p.placements, run_check=False, shape=p.shape, stride=p.stride())


def _rewrap(local, like):
    """``local`` as the shard of a DTensor placed like ``like``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def _start_profile():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof, directory: str, step: int) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()   # close open device events
    prof.__exit__(None, None, None)
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(os.path.join(directory,
                                          f"train_step{step}.json"))


def _batch_tokens(batch: dict) -> int:
    leaf = batch[sorted(batch)[0]]
    return int(leaf.shape[0] * (leaf.shape[1] if leaf.ndim > 1 else 1))
