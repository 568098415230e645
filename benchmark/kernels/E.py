"""Kernel E, ``csrc/norm_apply.cu`` via ``ops/norm_apply.py``: an s2d
InstanceNorm's affine and LeakyReLU in one pass (both template instances,
with and without the activation). Bytes: ``grid.bytes_e``."""
SYMBOL = "norm_apply_kernel"
BOUND = "hbm"
