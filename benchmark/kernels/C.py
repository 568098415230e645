"""Kernel C, ``csrc/s2d_accumulate.cu`` via ``ops/s2d_accumulate.py``: the
s2d head, gaussian weighting and accumulation of a tile batch. Bytes:
``grid.bytes_c``."""
SYMBOL = "s2d_accumulate_kernel"
BOUND = "hbm"
