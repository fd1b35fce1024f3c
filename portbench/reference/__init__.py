"""Plain float32 PyTorch references of the benchmark's configurations: no
module of the port, nor ``jax``, is imported here."""
