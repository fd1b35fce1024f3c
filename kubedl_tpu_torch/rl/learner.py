"""FlywheelLearner: GRPO updates on the port's ``Trainer``; the
counterpart of ``kubedl_tpu/rl/learner.py``.

The learner is a plain ``train.Trainer`` client (the same step as
pre-training), wired for the flywheel's three contracts:

* **versioned consumption**: every rollout batch carries the policy
  version that generated it (any object with ``batch``, the dict
  ``train.grpo.rollout_batch`` returns, and ``version``); the learner
  records the off-policy gap (its own version minus the batch's) as
  STALENESS. GRPO's clipped ratio tolerates a small gap; the gauge makes
  the gap visible;
* **frozen reference**: the starting policy's params are kept on the host
  and score ``ref_logps`` for the KL term, so late policies stay anchored
  to the same distribution. They are a copy: the trainer updates its
  parameters in place;
* **elastic width**: :meth:`remesh` is the restart-free resize: a forced
  save through the checkpoint manager, ``Trainer.remesh``, and a restore
  onto the new mesh's placement. The step counter and the loss curve
  continue where they left off.

Weights publish through the ``TieredCheckpointManager``'s object tier
(:meth:`publish`): its atomic tmp+rename upload is the never-serve-a-torn-
checkpoint guarantee. ``metrics`` is duck-typed
(``batches_consumed.inc(job=)``, ``staleness.set(v, job=)``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..parallel.sharding import full_tensor
from ..train.data import shard_batch
from ..train.grpo import GRPOConfig, make_grpo_loss_fn, token_logps
from ..train.trainer import tree_map


def _host(tree) -> dict:
    """A host copy of a (placed) param tree, whole."""
    return tree_map(lambda t: full_tensor(t).detach().to(
        "cpu", copy=True), tree)


class FlywheelLearner:
    """Consume versioned rollout batches; produce policy versions."""

    def __init__(self, model_config, trainer, params,
                 grpo: Optional[GRPOConfig] = None, checkpoint=None,
                 metrics=None, job: str = ""):
        self.model_config = model_config
        self.trainer = trainer
        self.grpo = grpo or GRPOConfig()
        #: TieredCheckpointManager (or None: publish() then only cuts the
        #: version, and remesh() refuses)
        self.checkpoint = checkpoint
        self.metrics = metrics
        self.job = job
        if trainer.loss_fn is None:
            mesh = trainer.mesh if trainer.sharded else None
            trainer.loss_fn = make_grpo_loss_fn(model_config, self.grpo,
                                                mesh=mesh)
        #: frozen reference = the starting policy, on the host: survives
        #: remesh untouched, moved to the device per scoring call
        self.ref_params = _host(params)
        self.state = trainer.init_state(params)
        #: the learner's CURRENT policy version; bumped by publish()
        self.version = 0
        self.batches_consumed = 0
        self.staleness_last = 0
        self.staleness_max = 0
        self.resizes = 0
        self.losses: list = []

    # -- consumption ------------------------------------------------------

    def step(self, rollout) -> float:
        """One GRPO update on a rollout batch; returns the loss. Scores
        the frozen reference here, on the whole batch (ref logps are data,
        never differentiated), then shards the batch over the trainer's
        current mesh."""
        mesh = self.trainer.placement_mesh
        b = dict(rollout.batch)
        with torch.no_grad():
            ref = tree_map(lambda t: t.to(mesh.device), self.ref_params)
            lp = token_logps(
                self.model_config, ref,
                torch.as_tensor(b["tokens"], device=mesh.device).long(),
                torch.as_tensor(b["targets"], device=mesh.device).long())
        b["ref_logps"] = lp.float().cpu().numpy().astype(np.float32)
        b.pop("rewards", None)        # reward stats, not a loss input
        self.state, loss = self.trainer.step(self.state,
                                             shard_batch(b, mesh))
        loss = float(loss)
        self.losses.append(loss)
        self.batches_consumed += 1
        self.staleness_last = self.version - rollout.version
        self.staleness_max = max(self.staleness_max, self.staleness_last)
        if self.metrics is not None:
            self.metrics.batches_consumed.inc(job=self.job)
            self.metrics.staleness.set(self.staleness_last, job=self.job)
        return loss

    # -- publication ------------------------------------------------------

    def publish(self) -> dict:
        """Cut a new policy version: bump the counter, push the state
        through the checkpoint manager (the object tier's atomic upload:
        a fresh host restores exactly this), and return the new version's
        params as a host tree for the weight publisher to install."""
        self.version += 1
        if self.checkpoint is not None:
            self.checkpoint.save(self.state, force=True,
                                 step=int(self.state.step))
            self.checkpoint.wait_until_finished()
            tiers = getattr(self.checkpoint, "tiers", None)
            if tiers is not None:
                tiers.flush()
        return _host(self.state.params)

    # -- elastic width ----------------------------------------------------

    def remesh(self, mesh) -> None:
        """Adopt a new mesh without restarting: forced save at the
        current step, ``Trainer.remesh``, restore onto the NEW mesh's
        placement (the checkpoint reshards; nothing re-initializes)."""
        if self.checkpoint is None:
            raise ValueError(
                "remesh needs a checkpoint manager: the restart-free "
                "resize IS a save/restore through the tiers")
        self.checkpoint.save(self.state, force=True,
                             step=int(self.state.step))
        self.checkpoint.wait_until_finished()
        old = self.state
        self.trainer.remesh(mesh)
        self.state = self.checkpoint.restore(
            self.trainer.abstract_state(old))
        self.resizes += 1


__all__ = ["FlywheelLearner"]
