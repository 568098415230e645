"""Building blocks of the plain U-Net: conv + InstanceNorm + leaky-ReLU
stacks — the port of fast_nnunet_tpu/models/blocks.py.

Layout is torch's NCDHW, with the JAX package's spatial order (X, Y, Z) as
(D, H, W). Convolutions pad k//2 on each side, as the JAX blocks do.
Weights live in the network's compute dtype (what the flax modules cast
their kernels to); InstanceNorm parameters stay float32.

InstanceNorm is the inference form of the JAX block (blocks.py:74-83): two
passes in float32 (mean, then the biased variance), then
``(x - mean) * rsqrt(var + eps) * scale + bias``, cast back to the input
dtype. The one-pass training form, ``BatchStatsNorm`` and ``BasicResBlockD``
are not ported: models/factory.py raises ``NotImplementedError`` for the
networks that need them.
"""
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


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


class InstanceNorm(nn.Module):
    """Affine InstanceNorm parameters (float32, like the flax params)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.eps = float(eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias, self.eps)


class ConvDropoutNormReLU(nn.Module):
    """conv -> instance norm -> leaky ReLU, the nnU-Net unit block (dropout
    is inert at inference)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int],
                 conv_bias: bool = True, norm_eps: float = 1e-5,
                 nonlin_negative_slope: float = 0.01):
        super().__init__()
        kernel_size = tuple(int(k) for k in kernel_size)
        self.conv = nn.Conv3d(in_channels, features, kernel_size,
                              tuple(int(s) for s in strides),
                              tuple(k // 2 for k in kernel_size),
                              bias=conv_bias)
        self.norm = InstanceNorm(features, norm_eps)
        self.slope = float(nonlin_negative_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu_(self.norm(self.conv(x)), self.slope)


class StackedConvBlocks(nn.Module):
    """n ConvDropoutNormReLU blocks; the first carries the stride. Children
    are named ``block_{i}`` as in the flax tree."""

    def __init__(self, n_convs: int, in_channels: int, features: int,
                 kernel_size: Sequence[int], initial_strides: Sequence[int],
                 conv_bias: bool = True, norm_eps: float = 1e-5,
                 nonlin_negative_slope: float = 0.01):
        super().__init__()
        ones = (1,) * len(kernel_size)
        self.blocks = nn.ModuleDict({
            f"block_{i}": ConvDropoutNormReLU(
                in_channels if i == 0 else features, features, kernel_size,
                initial_strides if i == 0 else ones, conv_bias, norm_eps,
                nonlin_negative_slope)
            for i in range(int(n_convs))})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks.values():
            x = blk(x)
        return x
