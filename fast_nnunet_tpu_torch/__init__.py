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
``inference.predictor.NNUNetPredictor`` with the ``run.predict`` CLI;
training (``training``, ``run.run_training``, ``run.distillation_train``);
and nnU-Net's host steps around them — ``planning`` (fingerprint, planners),
``preprocessing``, ``run.plan_and_preprocess``, ``postprocessing``,
``ensembling``, ``evaluation`` and ``run.evaluate`` (numpy/scipy, no
device); nnU-Net's 2d, 3d_lowres and cascade configurations; export
(``export.export_model``, a ``torch.export`` artifact with its JSON
sidecar) and the fast-inference module (``fast_inference``: the
inferencer, its REST API and VTK export), the JHU predictor, the inference
data iterators and the libdeflate NIfTI codec (``utils.fastgz``). Kernel
sources live in ``csrc/`` and are built by ``ops._build``
at first use. Every entry point that uses the card runs on ``cuda`` unless
the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
