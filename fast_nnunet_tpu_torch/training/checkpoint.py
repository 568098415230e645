"""``.fnnx`` checkpoints, read and written in the JAX package's pickle
layout (fast_nnunet_tpu/training/checkpoint.py ``save_checkpoint``).

A ``.fnnx`` file is a plain pickle of a dict: ``network_weights`` is the flax
state dict ``{"params": {...}}`` of numpy arrays (plus ``"batch_stats"`` for
a BatchNorm network), ``optimizer_state`` flax's ``to_state_dict`` of the
optax chain state, one entry per link of the chain (for ``nnunet_sgd``:
``{"0": {}, "1": {}, "2": {"trace": <flax-shaped momentum tree>},
"3": {"count": int32}}``, one ``{}`` per stateless link; Adam links hold
``{count, mu, nu}``, Adan links ``{m, v, n, g, t}``, nested chains nest),
then
``current_epoch``, ``logging``, ``_best_ema``, ``init_args``,
``trainer_name``, ``inference_allowed_mirroring_axes`` and extras such as
``train_step``. No template network is needed to read it, and each package
reads what the other writes, momentum included.

Unpickling runs code, so the reader admits only numpy's array and dtype
reconstructors: any other global (an ``ml_dtypes`` dtype, an optax object,
anything else) raises ``pickle.UnpicklingError`` before it is imported.
Orbax directory checkpoints are neither read nor written: their arrays
live in tensorstore's OCDBT store, out of reach of numpy and the standard
library.
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
            f"{fname} is an orbax directory checkpoint (FNN_CKPT_BACKEND="
            "orbax): its arrays sit in tensorstore's OCDBT key-value store "
            "(state/manifest.ocdbt, state/ocdbt.process_0/d/*) as zarr3 "
            "chunks, which numpy and the standard library cannot read; "
            "re-save it with the JAX package's pickle backend (.fnnx)")
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
    :func:`optimizer_state_to_jax`)."""
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


# optax state of one link <-> the torch optimizer's per-parameter state
_TREES = {"trace": {"trace": "momentum_buffer"},
          "adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
          "adan": {"m": "m", "v": "v", "n": "n", "g": "g"}}
_COUNTS = {"adam": "count", "adan": "t", "count": "count"}


def optimizer_state_to_jax(optimizer, net) -> dict:
    """``optimizer`` (a training/optimizers.py ``ChainedOptimizer``) as the
    state dict of the JAX package's optax chain with the same options,
    following ``optimizer.layout``; the per-parameter buffers of ``net``'s
    parameters become flax-shaped trees (zeros before the first step)."""
    from ..models.unet import tree_to_jax
    state = optimizer.inner.state
    count = np.asarray(optimizer.count, np.int32)

    def buffer(p, name):
        buf = state.get(p, {}).get(name)
        return torch.zeros_like(p) if buf is None else buf

    def link(kind):
        if isinstance(kind, list):
            return {str(i): link(k) for i, k in enumerate(kind)}
        out = {}
        for key, name in _TREES.get(kind, {}).items():
            out[key] = tree_to_jax(net, lambda p, _n=name: buffer(p, _n))
        if kind in _COUNTS:
            out[_COUNTS[kind]] = count
        return out

    return link(optimizer.layout)


def optimizer_state_from_jax(optimizer, net, state_dict: dict) -> None:
    """Load an optax chain state dict (as :func:`optimizer_state_to_jax`
    writes it, or the JAX trainer) into ``optimizer``: its per-parameter
    buffers and the step count."""
    from ..models.unet import from_flax_layout, jax_param_paths, tree_get
    items = [it for it in jax_param_paths(net) if it[0][0] == "params"]
    state = optimizer.inner.state

    def link(kind, sd):
        if isinstance(kind, list):
            for i, k in enumerate(kind):
                link(k, sd[str(i)])
            return
        for key, buf in _TREES.get(kind, {}).items():
            for path, p, lk in items:
                w = from_flax_layout(lk, tree_get(sd[key], path))
                if tuple(w.shape) != tuple(p.shape):
                    raise ValueError(
                        f"{'/'.join(path)}: {key} shape {w.shape} != "
                        f"parameter shape {tuple(p.shape)}")
                state[p][buf] = torch.tensor(
                    np.asarray(w, np.float32), device=p.device, dtype=p.dtype)
        if kind in _COUNTS:
            optimizer.count = int(sd[_COUNTS[kind]])
        if kind == "adam":      # torch's Adam counts per parameter
            for _, p, _ in items:
                state[p]["step"] = torch.tensor(float(optimizer.count))
        elif kind == "adan":
            optimizer.inner.t = optimizer.count

    link(optimizer.layout, state_dict)
