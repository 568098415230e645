"""``.fnnx`` checkpoints, read and written in the JAX package's pickle
layout (fast_nnunet_tpu/training/checkpoint.py ``save_checkpoint``).

A ``.fnnx`` file is a plain pickle of a dict: ``network_weights`` is the flax
state dict ``{"params": {...}}`` of numpy arrays, ``optimizer_state`` flax's
``to_state_dict`` of the optax chain state (for ``nnunet_sgd``:
``{"0": {}, "1": {}, "2": {"trace": <flax-shaped momentum tree>},
"3": {"count": int32}}``, one ``{}`` per stateless link), then
``current_epoch``, ``logging``, ``_best_ema``, ``init_args``,
``trainer_name``, ``inference_allowed_mirroring_axes`` and extras such as
``train_step``. No template network is needed to read it, and each package
reads what the other writes, momentum included.

Unpickling runs code, so the reader admits only numpy's array and dtype
reconstructors: any other global (an ``ml_dtypes`` dtype, an optax object,
anything else) raises ``pickle.UnpicklingError`` before it is imported.
Orbax directory checkpoints are neither read nor written.
"""
import os
import pickle
from typing import Optional

import numpy as np
import torch

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


def save_checkpoint(fname: str, *, network_weights: dict,
                    optimizer_state: Optional[dict] = None,
                    current_epoch: int = 0, logging: Optional[dict] = None,
                    best_ema: Optional[float] = None,
                    init_args: Optional[dict] = None,
                    trainer_name: str = "NNUNetTrainer",
                    inference_allowed_mirroring_axes=None,
                    extras: Optional[dict] = None) -> None:
    """Write a pickle ``.fnnx`` with the JAX package's keys; the trees are
    flax-shaped nested dicts of numpy arrays (``models.unet.params_to_jax``,
    :func:`sgd_state_to_jax`)."""
    ckpt = {
        "network_weights": network_weights,
        "optimizer_state": optimizer_state,
        "grad_scaler_state": None,
        "current_epoch": current_epoch,
        "logging": logging,
        "_best_ema": best_ema,
        "init_args": init_args,
        "trainer_name": trainer_name,
        "inference_allowed_mirroring_axes": inference_allowed_mirroring_axes,
    }
    if extras:
        ckpt.update(extras)
    with open(fname, "wb") as f:
        pickle.dump(ckpt, f, protocol=pickle.HIGHEST_PROTOCOL)


def _sgd_links(optimizer) -> tuple:
    """Chain positions of (momentum trace, schedule count) in the optax
    chain ``nnunet_sgd`` builds with the same options."""
    group = optimizer.inner.param_groups[0]
    i = int(optimizer.grad_clip is not None) + int(bool(group["weight_decay"]))
    return i, i + 1


def sgd_state_to_jax(optimizer, net) -> dict:
    """``optimizer`` (training/optimizers.py ``nnunet_sgd``) as the state
    dict of the JAX package's optax chain; the momentum buffers of ``net``'s
    parameters become the flax-shaped trace (zeros before the first step)."""
    from ..models.unet import tree_to_jax
    if not isinstance(optimizer.inner, torch.optim.SGD):
        raise NotImplementedError("only the SGD optimizer state is written "
                                  "in the optax layout")
    state = optimizer.inner.state

    def momentum(p):
        buf = state.get(p, {}).get("momentum_buffer")
        return torch.zeros_like(p) if buf is None else buf

    i_trace, i_count = _sgd_links(optimizer)
    out = {str(i): {} for i in range(i_trace)}
    out[str(i_trace)] = {"trace": tree_to_jax(net, momentum)}
    out[str(i_count)] = {"count": np.asarray(optimizer.count, np.int32)}
    return out


def sgd_state_from_jax(optimizer, net, state_dict: dict) -> None:
    """Load an optax SGD chain state dict (as :func:`sgd_state_to_jax`
    writes it, or the JAX trainer) into ``optimizer``: the momentum buffers
    and the step count."""
    from ..models.unet import from_flax_layout, jax_param_paths, tree_get
    i_trace, i_count = _sgd_links(optimizer)
    trace = state_dict[str(i_trace)]["trace"]
    for path, p, kind in jax_param_paths(net):
        w = from_flax_layout(kind, tree_get(trace, path))
        if tuple(w.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: momentum shape {w.shape} "
                             f"!= parameter shape {tuple(p.shape)}")
        optimizer.inner.state[p]["momentum_buffer"] = torch.tensor(
            np.asarray(w, np.float32), device=p.device, dtype=p.dtype)
    optimizer.count = int(state_dict[str(i_count)]["count"])
