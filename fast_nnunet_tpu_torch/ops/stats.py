"""Kernel A — InstanceNorm statistics: per-(batch, channel) f32 sum and sum of
squares over all spatial voxels, in one pass over the activation.

Replaces: fast_nnunet_tpu/ops/pallas_stats.py ``spatial_sum_sumsq`` (the
Pallas TPU kernel, opt-in there under ``FNN_PALLAS_STATS=1``). The port's
InstanceNorm (models/s2d.py) calls it for every norm with >= 4096 spatial
voxels — always on the card.

Contract: ``x`` is (B, C, *spatial), NCDHW-contiguous (the port network's
layout; the TPU kernel took channels-last), float32 or bfloat16. Returns
``(sum, sumsq)``, both (B, C) float32, summed in f32.

Bound on the card: bytes. Each element is read once (2 B in bf16) and two
f32 ops are done per element, far under the H100's 295 flop/byte ridge, so
the floor is B*C*S*itemsize / 3.35 TB/s. Design: one block per (b, c) row —
the row's S voxels are contiguous, so the block streams them with 16-byte
loads and reduces in a fixed order (compensated per-thread partial sums,
warp shuffles, one shared-memory step). No atomics and no second pass:
results are bit-for-bit reproducible run to run. They differ from the plain
version's summation order, so the two agree to f32 rounding:
|kernel - plain| <= 1e-5 * sum|x| per row (sum) and <= 1e-5 * sumsq
(checked in chip_smoke.py and tests/test_torch_kernels_cuda.py).

On a CPU tensor the wrapper runs :func:`spatial_sum_sumsq_plain`; on a CUDA
tensor it launches the kernel or raises.

Training: :class:`SpatialSumSumsq` puts the wrapper under autograd for the
one-pass training InstanceNorm (models/blocks.py). The JAX package has no
backward kernel for these statistics (XLA differentiates the reductions), and
neither does the port: the backward is plain torch, d/dx = g_sum + 2 x g_sumsq
broadcast over the spatial dims, computed in f32 and returned in x's dtype.
"""
from typing import Tuple

import torch

from . import _build


def spatial_sum_sumsq_plain(x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's contract, summed in float64
    (so that, as the reference, it carries no summation drift of its own).
    A float64 input keeps float64 results (the gradient check runs so)."""
    out = torch.float64 if x.dtype == torch.float64 else torch.float32
    xd = x.reshape(x.shape[0], x.shape[1], -1).double()
    return xd.sum(-1).to(out), (xd * xd).sum(-1).to(out)


def spatial_sum_sumsq(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, *spatial) NCDHW-contiguous f32/bf16 -> (sum, sumsq) (B, C) f32.
    CUDA tensors go through the hand-written kernel (counted in
    ``spatial_sum_sumsq.launches``), CPU tensors through the plain version."""
    if x.device.type == "cpu":
        return spatial_sum_sumsq_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() < 3 or not x.is_contiguous():
        raise ValueError(
            "stats kernel reads NCDHW-contiguous rows of S voxels per (b, c); "
            f"got shape {tuple(x.shape)} strides {x.stride()} (channels-last "
            "or strided views are not accepted)")
    code = _build.dtype_code(x)
    B, C = x.shape[0], x.shape[1]
    rows = B * C
    out = torch.empty((2, B, C), dtype=torch.float32, device=x.device)
    S = x.numel() // max(rows, 1)
    if rows == 0 or S == 0:
        return out[0].zero_(), out[1].zero_()
    vec = int((S * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0)
    lib = _build.library()
    err = lib.fnn_spatial_sum_sumsq(
        x.data_ptr(), code, rows, S, vec, out[0].data_ptr(),
        out[1].data_ptr(), _build.stream_ptr(x))
    _build.check(err, "spatial_sum_sumsq")
    spatial_sum_sumsq.launches += 1
    return out[0], out[1]


spatial_sum_sumsq.launches = 0


class SpatialSumSumsq(torch.autograd.Function):
    """``(sum, sumsq) = SpatialSumSumsq.apply(x)`` with a gradient: forward
    through :func:`spatial_sum_sumsq` (the kernel on the card, counted in its
    ``launches``; the plain version on the CPU), backward in plain torch."""

    @staticmethod
    def forward(ctx, x: torch.Tensor):
        ctx.save_for_backward(x)
        return spatial_sum_sumsq(x)

    @staticmethod
    def backward(ctx, g_sum: torch.Tensor, g_sumsq: torch.Tensor):
        (x,) = ctx.saved_tensors
        shape = tuple(x.shape[:2]) + (1,) * (x.dim() - 2)
        dt = torch.promote_types(x.dtype, torch.float32)
        dx = x.to(dt) * (2 * g_sumsq.to(dt).reshape(shape)) \
            + g_sum.to(dt).reshape(shape)
        return dx.to(x.dtype)
