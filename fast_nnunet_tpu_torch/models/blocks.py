"""Building blocks of the U-Nets: conv + norm + leaky-ReLU stacks and the
residual encoder's ``BasicResBlockD`` — the port of
fast_nnunet_tpu/models/blocks.py.

Layout is torch's NCDHW, with the JAX package's spatial order (X, Y, Z) as
(D, H, W). Convolutions pad k//2 on each side, as the JAX blocks do, and
cast their weights to the input's dtype (the network's compute dtype), as a
flax ``nn.Conv(dtype=...)`` does with its float32 parameters: an inference
network stores its conv weights in the compute dtype already (the cast is a
no-op), a training network keeps float32 master weights. InstanceNorm
parameters are float32 in both.

InstanceNorm has the JAX block's two forms:
- inference (blocks.py:74-83): two passes in float32 (mean, then the biased
  variance), ``(x - mean) * rsqrt(var + eps) * scale + bias``, cast back to
  the input dtype;
- one-pass, ``onepass=True``, the training form (``norm_kind="instance1p"``,
  blocks.py:56-73): mean = E[x] and m2 = E[x^2] accumulated in float32 from
  the (bf16) input, var = max(m2 - mean^2, 0), then the folded affine
  ``y = x * a + b``. At or above ``STATS_MIN_VOXELS`` spatial voxels (the gate
  models/s2d.py uses) the sums come from kernel A through
  ``ops.stats.SpatialSumSumsq`` (forward on the card, plain torch backward);
  below it from torch's mean.

``BatchStatsNorm`` is torch-parity BatchNorm (JAX blocks.py:86-135), plain
torch as in the JAX package (no kernel): in training mode (``.train()``) it
normalises with the batch's two-pass float32 statistics over batch and
spatial dims (biased variance) and moves its running averages once per
forward, ``ra = (1 - 0.1) ra + 0.1 batch`` with the unbiased variance; in
evaluation mode (``.eval()``: validation, prediction) it normalises with the
running averages. The norm of a block is chosen by ``norm``: "instance"
(two-pass), "instance1p" (one-pass) or "batch", the JAX ``norm_kind``.

``StackedConvBlocks(remat=True)`` recomputes its blocks in the backward
(``torch.utils.checkpoint``, the counterpart of flax ``nn.remat``); the
residual encoder does the same per ``BasicResBlockD`` (models/unet.py). A
recomputed BatchNorm would move its running averages a second time, so
BatchNorm networks are built without remat (models/factory.py), as JAX's
``NNUNetTrainerBN`` builds them.
"""
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.stats import SpatialSumSumsq
from .s2d import STATS_MIN_VOXELS


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Two-pass float32 InstanceNorm over the spatial dims of NC...."""
    dims = tuple(range(2, x.dim()))
    y = x.to(torch.float32, copy=True)
    var, mean = torch.var_mean(y, dim=dims, correction=0, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y.sub_(mean).mul_(torch.rsqrt(var + eps))
    y.mul_(scale.float().reshape(shape)).add_(bias.float().reshape(shape))
    return y.to(x.dtype)


def instance_norm_onepass(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float) -> torch.Tensor:
    """One-pass folded InstanceNorm (the JAX training form), differentiable.
    Statistics from kernel A at >= ``STATS_MIN_VOXELS`` spatial voxels."""
    n = math.prod(x.shape[2:])
    if n >= STATS_MIN_VOXELS:
        s, q = SpatialSumSumsq.apply(x)                   # (B, C) f32
        mean, m2 = s / n, q / n
    else:
        dims = tuple(range(2, x.dim()))
        x32 = x.float()
        mean, m2 = x32.mean(dims), x32.square().mean(dims)
    var = torch.clamp(m2 - mean * mean, min=0.0)
    a = torch.rsqrt(var + eps) * scale.float()
    b = bias.float() - mean * a
    shape = tuple(x.shape[:2]) + (1,) * (x.dim() - 2)
    return torch.addcmul(b.reshape(shape), x.float(),
                         a.reshape(shape)).to(x.dtype)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` applied with its weight and bias in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` (no output size argument) applied with its
    weight and bias in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose3d(x, self.weight.to(x.dtype), b, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class InstanceNorm(nn.Module):
    """Affine InstanceNorm parameters (float32, like the flax params) and
    the form to apply (two-pass, or ``onepass`` for training builds)."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 onepass: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.eps = float(eps)
        self.onepass = bool(onepass)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.onepass:
            return instance_norm_onepass(x, self.weight, self.bias, self.eps)
        return instance_norm(x, self.weight, self.bias, self.eps)


class BatchStatsNorm(nn.Module):
    """Affine BatchNorm with float32 running averages (module docstring);
    ``weight``/``bias`` are the flax ``scale``/``bias``, ``running_mean``/
    ``running_var`` the ``batch_stats`` ``mean``/``var``."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = float(eps)
        self.momentum = float(momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            dims = (0,) + tuple(range(2, x.dim()))
            var, mean = torch.var_mean(x32, dim=dims, correction=0)
            n = x.numel() // x.shape[1]
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * (var * (n / max(n - 1, 1))))
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = (x32 - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                      + self.eps)
        y = y * self.weight.float().reshape(shape) \
            + self.bias.float().reshape(shape)
        return y.to(x.dtype)


NORM_KINDS = ("instance", "instance1p", "batch")


def make_norm(norm: str, channels: int, eps: float) -> nn.Module:
    """The norm module of kind ``norm`` (:data:`NORM_KINDS`)."""
    if norm == "batch":
        return BatchStatsNorm(channels, eps)
    if norm not in NORM_KINDS:
        raise ValueError(f"norm must be one of {NORM_KINDS}, got {norm!r}")
    return InstanceNorm(channels, eps, onepass=norm == "instance1p")


def _conv(in_channels: int, features: int, kernel_size: Sequence[int],
          strides: Sequence[int], bias: bool) -> Conv3d:
    kernel_size = tuple(int(k) for k in kernel_size)
    return Conv3d(in_channels, features, kernel_size,
                  tuple(int(s) for s in strides),
                  tuple(k // 2 for k in kernel_size), bias=bias)


class ConvDropoutNormReLU(nn.Module):
    """conv -> norm -> leaky ReLU, the nnU-Net unit block (dropout is not
    used by the plans the port runs)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int],
                 conv_bias: bool = True, norm_eps: float = 1e-5,
                 nonlin_negative_slope: float = 0.01,
                 norm: str = "instance"):
        super().__init__()
        self.conv = _conv(in_channels, features, kernel_size, strides,
                          conv_bias)
        self.norm = make_norm(norm, features, norm_eps)
        self.slope = float(nonlin_negative_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu_(self.norm(self.conv(x)), self.slope)


class StackedConvBlocks(nn.Module):
    """n ConvDropoutNormReLU blocks; the first carries the stride. Children
    are named ``block_{i}`` as in the flax tree. With ``remat`` set, a
    forward under autograd keeps only the stack's input and recomputes the
    blocks in the backward."""

    def __init__(self, n_convs: int, in_channels: int, features: int,
                 kernel_size: Sequence[int], initial_strides: Sequence[int],
                 conv_bias: bool = True, norm_eps: float = 1e-5,
                 nonlin_negative_slope: float = 0.01,
                 norm: str = "instance", remat: bool = False):
        super().__init__()
        ones = (1,) * len(kernel_size)
        self.blocks = nn.ModuleDict({
            f"block_{i}": ConvDropoutNormReLU(
                in_channels if i == 0 else features, features, kernel_size,
                initial_strides if i == 0 else ones, conv_bias, norm_eps,
                nonlin_negative_slope, norm)
            for i in range(int(n_convs))})
        self.remat = bool(remat)

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks.values():
            x = blk(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._run, x, use_reentrant=False)
        return self._run(x)


class BasicResBlockD(nn.Module):
    """conv(stride) -> norm -> leaky ReLU -> conv -> norm, plus the input or,
    when the stride or the channel count changes, a 1x1 strided
    ``skip_conv`` (no bias) and ``skip_norm``; leaky ReLU after the sum
    (JAX blocks.py:204-241, which decides on the skip from the input's
    channels at call time; here they are known at construction)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int],
                 conv_bias: bool = True, norm_eps: float = 1e-5,
                 nonlin_negative_slope: float = 0.01,
                 norm: str = "instance"):
        super().__init__()
        ones = (1,) * len(kernel_size)
        self.conv1 = _conv(in_channels, features, kernel_size, strides,
                           conv_bias)
        self.norm1 = make_norm(norm, features, norm_eps)
        self.conv2 = _conv(features, features, kernel_size, ones, conv_bias)
        self.norm2 = make_norm(norm, features, norm_eps)
        if tuple(strides) != ones or in_channels != features:
            self.skip_conv = _conv(in_channels, features, ones, strides,
                                   False)
            self.skip_norm = make_norm(norm, features, norm_eps)
        else:
            self.skip_conv = self.skip_norm = None
        self.slope = float(nonlin_negative_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu_(self.norm1(self.conv1(x)), self.slope)
        y = self.norm2(self.conv2(y))
        skip = x if self.skip_conv is None else \
            self.skip_norm(self.skip_conv(x))
        return F.leaky_relu_(y + skip, self.slope)
