"""Dataset path conventions — a copy of fast_nnunet_tpu/paths.py: the
``nnUNet_raw``, ``nnUNet_preprocessed`` and ``nnUNet_results`` environment
variables, read when asked for (so tests and callers may set them late)."""
import os


def _folder(env: str, hint: str = "") -> str:
    p = os.environ.get(env)
    if p is None:
        raise RuntimeError(f"{env} is not set.{hint}")
    return p


def get_raw_folder() -> str:
    return _folder("nnUNet_raw", " Point it at your raw dataset folder "
                   "(Dataset{ID}_{Name} layout, same convention as nnU-Net "
                   "v2).")


def get_preprocessed_folder() -> str:
    return _folder("nnUNet_preprocessed")


def get_results_folder() -> str:
    return _folder("nnUNet_results")
