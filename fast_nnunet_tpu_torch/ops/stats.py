"""Kernel A — InstanceNorm statistics: per-(batch, channel) f32 sum and sum of
squares over all spatial voxels, in one pass over the activation.

Replaces: fast_nnunet_tpu/ops/pallas_stats.py:58 ``spatial_sum_sumsq`` (the
Pallas TPU kernel, opt-in there under ``FNN_PALLAS_STATS=1``). The port's
InstanceNorm (models/s2d.py) calls it for every norm with >= 4096 spatial
voxels — always on the card.

Contract: ``x`` is (B, C, *spatial), NCDHW-contiguous (the port network's
layout; the TPU kernel took channels-last), float32 or bfloat16. Returns
``(sum, sumsq)``, both (B, C) float32, summed in f32.

Bound on the card: bytes. Each element is read once (2 B in bf16) and a few
f32 operations are done per element, far under the H100's 295 flop/byte
ridge, so the floor is B*C*S*itemsize / 3.35 TB/s. To get near it the card
needs many 16-byte loads in flight on every SM: each thread issues 4
independent 16-byte loads per step before it reduces them.

The row-count limit, and what the cluster split does about it: the natural
unit is one block per (b, c) row (its S voxels are contiguous), which fills
the card at the serving calls (1024-2048 rows) but leaves most of the 132
SMs idle at the training calls (32-64 rows at full resolution). So
:func:`launch_plan` splits each row over a thread-block cluster of ``k``
blocks (Hopper, ``sm_90a``; up to 8, the portable cluster size): block
``rank`` reduces the contiguous range [rank * chunk, min((rank + 1) * chunk,
S)), and cluster rank 0 reads the k partials through distributed shared
memory in rank order and writes the row. ``k`` doubles while the call keeps
at most 2 blocks per SM and every block at least 64 KB (the best split at
every training shape, tools/bench_stats.py on an H100): k = 4 for the
teacher's 64 full-resolution rows, 8 for the student's 32; the serving
calls keep ``k = 1``. One launch per call, no workspace, no atomics: results
are bit-for-bit reproducible run to run. The kernel computes nothing the
plan does not give it (``k``, ``chunk``, the 16-byte path). Per-thread sums
are compensated (Kahan) against drift on nearly constant rows, over pairwise
partials of each 16-byte load. They differ from the plain version's
summation order, so the two agree to f32 rounding: |kernel - plain| <= 1e-5
* sum|x| + 1e-6 per row (sum) and <= 1e-5 * sumsq + 1e-6 (checked in
chip_smoke.py and tests/test_torch_kernels_cuda.py).

On a CPU tensor the wrapper runs :func:`spatial_sum_sumsq_plain`; on a CUDA
tensor it launches the kernel or raises.

Training: :class:`SpatialSumSumsq` puts the wrapper under autograd for the
one-pass training InstanceNorm (models/blocks.py). The JAX package has no
backward kernel for these statistics (XLA differentiates the reductions), and
neither does the port: the backward is plain torch, d/dx = g_sum + 2 x g_sumsq
broadcast over the spatial dims, computed in f32 and returned in x's dtype.
"""
import functools
from typing import Tuple

import torch

from . import _build

CLUSTER_MAX = 8             # blocks per row: Hopper's portable cluster
MIN_BLOCK_BYTES = 64 << 10  # a row is never split below this per block
BLOCKS_PER_SM = 2           # a split call keeps at most this many per SM
ALIGN_BYTES = 128           # block ranges start on 128-byte boundaries


@functools.lru_cache(maxsize=256)
def launch_plan(rows: int, S: int, itemsize: int, n_sms: int = 132,
                aligned: bool = True) -> dict:
    """Kernel A's launch for ``rows`` rows of ``S`` voxels of ``itemsize``
    bytes on a card of ``n_sms`` SMs: ``k`` blocks per row (one cluster),
    block r of a row reduces ``ranges[r]`` = [r * chunk, min((r + 1) *
    chunk, S)), and ``vec`` says whether the 16-byte path is taken (rows of
    whole 16-byte units at a 16-byte ``aligned`` base). Cached: do not
    mutate."""
    k = 1
    while (2 * k <= CLUSTER_MAX and rows * 2 * k <= BLOCKS_PER_SM * n_sms
           and S * itemsize >= 2 * k * MIN_BLOCK_BYTES):
        k *= 2
    return _split_plan(rows, S, itemsize, k, aligned)


def _split_plan(rows: int, S: int, itemsize: int, k: int,
                aligned: bool = True) -> dict:
    """The plan that splits each row over ``k`` blocks: :func:`launch_plan`'s
    choice, or a forced one (the tests and tools/bench_stats.py's sweep)."""
    if not 1 <= k <= CLUSTER_MAX:
        raise ValueError(f"k={k} outside [1, {CLUSTER_MAX}]")
    align = ALIGN_BYTES // itemsize
    chunk = max(1, -(-S // (k * align))) * align
    vec = bool(aligned) and S * itemsize % 16 == 0
    return {"k": k, "chunk": chunk, "vec": vec,
            "ranges": tuple((min(r * chunk, S), min((r + 1) * chunk, S))
                            for r in range(k)),
            "blocks": rows * k, "cluster_limit": CLUSTER_MAX}


@functools.lru_cache(maxsize=None)
def _n_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
    ptr = x.data_ptr()
    plan = launch_plan(rows, S, x.element_size(), _n_sms(x.get_device()),
                       ptr % 16 == 0)
    _launch(x, code, rows, S, plan, out)
    spatial_sum_sumsq.launches += 1
    return out[0], out[1]


def _launch(x: torch.Tensor, code: int, rows: int, S: int, plan: dict,
            out: torch.Tensor) -> None:
    """One launch of kernel A on the NCDHW-contiguous CUDA tensor ``x``
    (``rows`` rows of ``S`` voxels, dtype ``code``) with ``plan``, writing
    sum and sumsq into ``out`` (2, B, C) float32. Not counted: the wrapper
    counts its launches; the tests and tools/bench_stats.py force plans
    through this."""
    o = out.data_ptr()
    err = _build.library().fnn_spatial_sum_sumsq(
        x.data_ptr(), code, rows, S, plan["chunk"], plan["k"],
        int(plan["vec"]), o, o + 4 * rows, _build.stream_ptr(x))
    _build.check(err, "spatial_sum_sumsq")


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
