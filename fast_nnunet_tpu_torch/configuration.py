"""Global tunables (copies of fast_nnunet_tpu/configuration.py's)."""
import os

# spacing anisotropy ratio above which resampling treats the out-of-plane axis
# separately (ref configuration.py ANISO_THRESHOLD = 3)
ANISO_THRESHOLD = 3


def get_allowed_n_proc_DA() -> int:
    """Number of host-side data-augmentation workers: the env override
    ``nnUNet_n_proc_DA``, else the CPU count less two, in [2, 12]."""
    if "nnUNet_n_proc_DA" in os.environ:
        return int(os.environ["nnUNet_n_proc_DA"])
    n = os.cpu_count() or 8
    return max(2, min(12, n - 2))
