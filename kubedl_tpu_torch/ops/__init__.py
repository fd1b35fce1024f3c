"""Tensor ops of the port: attention (with the Hopper flash kernel) and the
matmul dispatch."""
