"""The benchmark of ``kubedl_tpu_torch`` on one H100 a cell (README.md)."""
