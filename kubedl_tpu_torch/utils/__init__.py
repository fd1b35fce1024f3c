"""Shared helpers: descriptive statistics (``stats``), a copy of the JAX
package's framework-free module."""
