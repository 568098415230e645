"""Network factory: plans architecture dict -> ``nn.Module`` — the port of
fast_nnunet_tpu/models/factory.py.

Plans name their classes by the reference's dotted paths
(``dynamic_network_architectures.architectures.unet.PlainConvUNet``,
``torch.nn.modules.conv.Conv3d``, ...); the last component is what counts,
as in the JAX package. Built: ``PlainConvUNet`` / ``LiteNNUNetStudent``
and ``ResidualEncoderUNet`` / ``LiteResEncStudent`` in 3D, with InstanceNorm
or BatchNorm (``BatchStatsNorm``), in the inference form or, with
``norm_onepass``, ``remat`` and ``trainable``, the training form
(models/unet.py). A residual encoder's ``n_blocks_per_stage`` falls back to
``n_conv_per_stage``. A BatchNorm network with remat raises ``ValueError``
(a recomputed BatchNorm would move its running averages twice); 2D networks
raise ``NotImplementedError``.
"""
import copy
from typing import Optional, Sequence, Union

import torch

from .unet import PlainConvUNet, ResidualEncoderUNet

_ARCH_MAP = {
    "PlainConvUNet": PlainConvUNet,
    "LiteNNUNetStudent": PlainConvUNet,
    "ResidualEncoderUNet": ResidualEncoderUNet,
    "LiteResEncStudent": ResidualEncoderUNet,
}


def _dim_from_conv_op(conv_op_name: Optional[str], kernel_sizes) -> int:
    if conv_op_name is not None:
        for d in (3, 2, 1):
            if conv_op_name.endswith(f"{d}d"):
                return d
    ks0 = kernel_sizes[0]
    return len(ks0) if hasattr(ks0, "__len__") else 3


def _negative_slope(nonlin_name: Optional[str],
                    nonlin_kwargs: Optional[dict]) -> float:
    if nonlin_name is None:
        return 0.01
    short = nonlin_name.rsplit(".", 1)[-1]
    if short == "LeakyReLU":
        return float((nonlin_kwargs or {}).get("negative_slope", 0.01))
    if short == "ReLU":
        return 0.0
    raise ValueError(f"Unsupported nonlinearity {nonlin_name}")


def with_batch_norm(architecture: dict) -> dict:
    """A copy of a plans ``architecture`` dict with BatchNorm in place of
    its norm (``NNUNetTrainerBN``'s network)."""
    arch = copy.deepcopy(architecture)
    kw = arch.get("arch_kwargs", arch)
    if "norm_op" not in kw:
        raise RuntimeError("'norm_op' not found in arch kwargs: this does "
                           "not look like a default nnU-Net architecture")
    kw["norm_op"] = "torch.nn.modules.batchnorm.BatchNorm3d"
    kw["norm_op_kwargs"] = {"eps": 1e-5, "affine": True}
    return arch


def build_network_from_arch_dict(architecture: dict, input_channels: int,
                                 num_classes: int,
                                 compute_dtype: torch.dtype = torch.bfloat16,
                                 remat=False, norm_onepass: bool = False,
                                 trainable: bool = False):
    """architecture = plans['configurations'][cfg]['architecture']."""
    return get_network_from_plans(
        architecture["network_class_name"], architecture["arch_kwargs"],
        architecture.get("_kw_requires_import", ()), input_channels,
        num_classes, compute_dtype=compute_dtype, remat=remat,
        norm_onepass=norm_onepass, trainable=trainable)


def get_network_from_plans(arch_class_name: str, arch_kwargs: dict,
                           arch_kwargs_req_import: Sequence[str],
                           input_channels: int, output_channels: int,
                           allow_init: bool = True,
                           deep_supervision: Union[bool, None] = None,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           remat=False, norm_onepass: bool = False,
                           trainable: bool = False):
    """The JAX function's signature (``dtype`` becomes ``compute_dtype``;
    ``allow_init`` / ``deep_supervision`` are accepted and unused, as
    there: deep supervision is a forward flag)."""
    short = arch_class_name.rsplit(".", 1)[-1]
    if short not in _ARCH_MAP:
        raise ValueError(f"Unknown architecture class {arch_class_name}. "
                         f"Supported: {sorted(_ARCH_MAP)}")
    cls = _ARCH_MAP[short]
    kw = dict(arch_kwargs)
    dim = _dim_from_conv_op(kw.get("conv_op"), kw["kernel_sizes"])
    if dim != 3:
        raise NotImplementedError(f"{dim}D networks are not ported yet")
    norm_op = kw.get("norm_op")
    if norm_op is None or "InstanceNorm" in norm_op:
        norm = "instance1p" if norm_onepass else "instance"
    elif "BatchNorm" in norm_op:
        norm = "batch"
        if remat:
            raise ValueError(
                "BatchNorm networks are built without remat: a recomputed "
                "BatchNorm would move its running averages twice per step")
    else:
        raise ValueError(f"Only InstanceNorm and BatchNorm are supported, "
                         f"got {norm_op}")
    common = dict(
        input_channels=input_channels,
        n_stages=int(kw["n_stages"]),
        features_per_stage=tuple(int(f) for f in kw["features_per_stage"]),
        kernel_sizes=tuple(tuple(k) if hasattr(k, "__len__") else (int(k),) * dim
                           for k in kw["kernel_sizes"]),
        strides=tuple(tuple(s) if hasattr(s, "__len__") else (int(s),) * dim
                      for s in kw["strides"]),
        num_classes=output_channels,
        n_conv_per_stage_decoder=tuple(
            int(n) for n in kw["n_conv_per_stage_decoder"]),
        conv_bias=bool(kw.get("conv_bias", True)),
        norm_eps=float((kw.get("norm_op_kwargs") or {}).get("eps", 1e-5)),
        nonlin_negative_slope=_negative_slope(kw.get("nonlin"),
                                              kw.get("nonlin_kwargs")),
        dim=dim, compute_dtype=compute_dtype, norm=norm, remat=remat,
        trainable=trainable)
    if cls is PlainConvUNet:
        return cls(n_conv_per_stage=tuple(
            int(n) for n in kw["n_conv_per_stage"]), **common)
    return cls(n_blocks_per_stage=tuple(int(n) for n in (
        kw.get("n_blocks_per_stage") or kw["n_conv_per_stage"])), **common)
