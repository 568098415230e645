"""Global tunables (a copy of fast_nnunet_tpu/configuration.py's constant)."""

# spacing anisotropy ratio above which resampling treats the out-of-plane axis
# separately (ref configuration.py ANISO_THRESHOLD = 3)
ANISO_THRESHOLD = 3
