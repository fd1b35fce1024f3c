"""Training loop on one card: the counterpart of
``kubedl_tpu/train/trainer.py``.

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

Sharded state (the JAX trainer's mesh) and checkpointing are ROADMAP A5
and A6.
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


def tree_leaves(tree: dict, prefix: str = "") -> list:
    """``[(path, tensor)]`` of a nested dict in the JAX package's leaf
    order (keys sorted at every level), paths ``/``-joined."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            out += tree_leaves(tree[key], path + "/")
        else:
            out.append((path, tree[key]))
    return out


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
    def apply(self, params: dict, grads: dict, state: AdamState) -> AdamState:
        """One update of ``params`` in place from ``grads`` (keyed like
        :func:`tree_leaves`); returns the new state."""
        c = self.config
        leaves = tree_leaves(params)
        # clip_by_global_norm: sqrt of the per-leaf sums of squares, each
        # in its leaf's dtype, summed in leaf order (0-dim promotion)
        total = 0
        for k, _ in leaves:
            g = grads[k]
            total = total + (g * g).sum()
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
    optimizer on one device (the card unless ``device="cpu"``)."""

    def __init__(self, loss_fn: Callable, config: Optional[TrainConfig] = None,
                 device=None):
        self.loss_fn = loss_fn
        self.config = config or TrainConfig()
        self.optimizer = make_optimizer(self.config)
        self.device = device

    def init_state(self, params: dict) -> TrainState:
        """Params on the trainer's device as grad-requiring leaves, and
        zero moments (float32 ``mu``, ``nu`` in each param's dtype)."""
        dev = resolve_device(self.device)
        self.device = dev

        def leafify(tree):
            return {k: leafify(v) if isinstance(v, dict)
                    else v.detach().to(dev).requires_grad_(True)
                    for k, v in tree.items()}

        params = leafify(params)
        return TrainState(step=0, params=params,
                          opt_state=self.optimizer.init(params))

    def _value_and_grad(self, params: dict, batch: dict):
        leaves = tree_leaves(params)
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
        with torch.profiler.record_function("train.loss_and_grads"):
            loss, grads = self._grads(state.params, batch)
        with torch.profiler.record_function("train.optimizer"):
            opt = self.optimizer.apply(state.params, grads, state.opt_state)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt), loss

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
            log_every: int = 10, on_step=None, tracer=None):
        """Training loop. ``on_step(step, loss)`` runs after every step.
        ``tracer`` (``kubedl_tpu_torch.trace.Tracer``, enabled) records
        one ``train.step`` span per step with its tokens and replica,
        attached to ``$KUBEDL_TRACEPARENT``'s trace when the operator
        injected one. Checkpoints, the elastic agent and in-training
        evaluation are ROADMAP A6."""
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
                t_step = time.time() if tr is not None else 0.0
                state, loss = self.step(state, batch)
                if tr is not None:
                    tr.record("train.step", t_step, time.time(),
                              trace_id=trace_id, parent_id=parent_id,
                              component="train",
                              attributes={"step": step0 + i + 1,
                                          "tokens": step_tokens,
                                          "replica": replica})
                if prof is not None and i + 1 >= profile_at + cfg.profile_steps:
                    _stop_profile(prof, cfg.profile_dir, step0 + i + 1)
                    prof = None
                if on_step is not None:
                    on_step(state.step, float(loss))
                if log_every and (i + 1) % log_every == 0:
                    dt = time.time() - t0
                    print(f"step {state.step} loss {float(loss):.4f} "
                          f"{tokens / dt:.0f} tok/s")
        finally:
            if prof is not None:
                _stop_profile(prof, cfg.profile_dir, state.step)
        return state


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
