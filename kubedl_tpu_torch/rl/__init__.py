"""RL post-training flywheel: the port's counterpart of
``kubedl_tpu/rl``.

Rollout generation IS serving and learning IS training; the flywheel
closes the loop between the port's engines and its trainer:

* :class:`~kubedl_tpu_torch.rl.rollout.RolloutClient` — prompt groups
  ride a serving fleet's router as a dedicated low-priority tenant,
  pinned to ONE policy version per batch;
* :class:`~kubedl_tpu_torch.rl.learner.FlywheelLearner` — GRPO updates
  on the port's ``Trainer``, staleness-tracked, checkpointed through the
  tiered manager, with a restart-free elastic resize;
* :class:`~kubedl_tpu_torch.rl.publisher.WeightPublisher` — new policy
  versions roll across the fleet's replicas between drains, one replica
  at a time, installed with ``ContinuousBatchingEngine.load_weights``;
* :class:`~kubedl_tpu_torch.rl.flywheel.RLFlywheel` — one RLJob's loop,
  composed.
"""

from .flywheel import RLFlywheel
from .learner import FlywheelLearner
from .publisher import WeightPublisher
from .rollout import ROLLOUT_TENANT, RolloutBatch, RolloutClient

__all__ = ["ROLLOUT_TENANT", "RolloutBatch", "RolloutClient",
           "FlywheelLearner", "WeightPublisher", "RLFlywheel"]
