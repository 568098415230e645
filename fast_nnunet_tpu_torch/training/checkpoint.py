"""Reader for the JAX package's ``.fnnx`` checkpoints.

A ``.fnnx`` file (fast_nnunet_tpu/training/checkpoint.py ``save_checkpoint``)
is a plain pickle of nested dicts of numpy arrays; its ``network_weights`` is
the flax state dict ``{"params": {...}}``, so no template network is needed to
read it. Unpickling runs code, so this reader admits only numpy's array and
dtype reconstructors: any other global (an ``ml_dtypes`` dtype, an optax
object, anything else) raises ``pickle.UnpicklingError`` before it is
imported. Orbax directory checkpoints are not read here.
"""
import os
import pickle

_ALLOWED = {
    ("numpy", "dtype"), ("numpy", "ndarray"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint references disallowed global {module}.{name} "
            "(only numpy arrays of builtin dtypes are read)")


def load_checkpoint(fname: str) -> dict:
    """Read a pickle-format ``.fnnx`` checkpoint through the numpy-only
    unpickler. Returns the checkpoint dict (``network_weights``,
    ``init_args``, ``trainer_name``, ...)."""
    if os.path.isdir(fname):
        raise NotImplementedError(
            f"{fname} is an orbax directory checkpoint; the port reads only "
            "pickle-format .fnnx files")
    with open(fname, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()
