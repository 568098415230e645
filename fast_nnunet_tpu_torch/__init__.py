"""fast_nnunet_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of
fast_nnunet_tpu.

The JAX package beside it is the reference this package is held against;
this package imports nothing of it (nor jax, flax or ml_dtypes) and keeps its
own copies of the numpy-only helpers it needs. Module layout and names follow
the JAX package so each counterpart is easy to find.

Ported so far: the bone_turbo serving path — ``inference.turbo.TurboPipeline``
(device preprocess -> space-to-depth sweep -> nearest revert) with its three
hand-written Hopper kernels (``ops.stats``, ``ops.s2d_accumulate``,
``ops.finalize``); the plain full-res route — ``models.unet.PlainConvUNet``
through ``inference.engine.SlidingWindowEngine`` (``predict_logits``, the
rolling sweep, kernel ``ops.scatter_accumulate``); and the nnU-Net file path,
``inference.predictor.NNUNetPredictor`` with the ``run.predict`` CLI. Kernel
sources live in ``csrc/`` and are built by ``ops._build`` at first use.
Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
