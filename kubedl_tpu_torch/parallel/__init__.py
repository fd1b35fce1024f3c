"""Parallelism of the port: the mesh layout (one device so far)."""
