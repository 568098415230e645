"""Kernel B, ``csrc/finalize.cu`` via ``ops/finalize.py``: the s2d sweep's
labels from its accumulator rows. Bytes: ``grid.bytes_b``."""
SYMBOL = "grouped_argmax_kernel"
BOUND = "hbm"
