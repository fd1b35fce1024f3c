"""RL post-training: the training half of the JAX package's flywheel
(``kubedl_tpu/rl``). :class:`~kubedl_tpu_torch.rl.learner.FlywheelLearner`
takes GRPO updates on the port's ``Trainer``, tracks how stale each
rollout batch is, publishes policy versions through the tiered
checkpoint manager and adopts a new mesh without restarting. The rollout
client, the weight publisher and the flywheel's loop drive the serving
fleet and stay with the operator's half (ROADMAP A8)."""

from .learner import FlywheelLearner

__all__ = ["FlywheelLearner"]
