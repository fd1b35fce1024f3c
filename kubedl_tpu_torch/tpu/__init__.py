"""TPU placement: topology tables, slice math, pod-spec rendering.

Copied from ``kubedl_tpu/tpu/__init__.py`` (the port imports nothing of the JAX package).
"""
