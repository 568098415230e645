"""Kernel A, ``csrc/stats.cu`` via ``ops/stats.py``: an InstanceNorm's sum
and sum of squares per (batch, channel). Bytes: ``grid.bytes_a``."""
SYMBOL = "spatial_sum_sumsq_kernel"
BOUND = "hbm"
