"""kubedl-tpu's compute stack ported to PyTorch and CUDA (NVIDIA Hopper).

The JAX package ``kubedl_tpu`` is the reference; this package mirrors its
module names (``ops.attention``, ``models.llama``, ``serving.engine`` ...)
so every function has a counterpart with the same contract. It imports
``torch`` and never ``jax``, and nothing from ``kubedl_tpu``: what it
needs from there (tokenizers, the metrics registry, the span recorder) is
copied in.

Every TPU Pallas kernel on a ported path is a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(``ops/_build.py``). Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"`` (``_device.resolve_device``).
"""

from ._device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
