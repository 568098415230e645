"""Building blocks of the plain U-Net: conv + InstanceNorm + leaky-ReLU
stacks — the port of fast_nnunet_tpu/models/blocks.py.

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

``StackedConvBlocks(remat=True)`` recomputes its blocks in the backward
(``torch.utils.checkpoint``, the counterpart of flax ``nn.remat``).
``BatchStatsNorm`` and ``BasicResBlockD`` are not ported: models/factory.py
raises ``NotImplementedError`` for the networks that need them.
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


class ConvDropoutNormReLU(nn.Module):
    """conv -> instance norm -> leaky ReLU, the nnU-Net unit block (dropout
    is not used by the plans the port runs)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int],
                 conv_bias: bool = True, norm_eps: float = 1e-5,
                 nonlin_negative_slope: float = 0.01,
                 norm_onepass: bool = False):
        super().__init__()
        kernel_size = tuple(int(k) for k in kernel_size)
        self.conv = Conv3d(in_channels, features, kernel_size,
                           tuple(int(s) for s in strides),
                           tuple(k // 2 for k in kernel_size), bias=conv_bias)
        self.norm = InstanceNorm(features, norm_eps, norm_onepass)
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
                 norm_onepass: bool = False, remat: bool = False):
        super().__init__()
        ones = (1,) * len(kernel_size)
        self.blocks = nn.ModuleDict({
            f"block_{i}": ConvDropoutNormReLU(
                in_channels if i == 0 else features, features, kernel_size,
                initial_strides if i == 0 else ones, conv_bias, norm_eps,
                nonlin_negative_slope, norm_onepass)
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
