"""Training of the port: the optimizer and loop (``trainer``), the data
streams (``data``) and the ``python -m kubedl_tpu_torch.train``
entrypoint."""

from .trainer import TrainConfig, Trainer, TrainState, make_optimizer

__all__ = ["TrainConfig", "TrainState", "Trainer", "make_optimizer"]
