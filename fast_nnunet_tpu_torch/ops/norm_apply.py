"""Kernel E — the s2d InstanceNorm's affine and LeakyReLU in one pass over the
activation.

The JAX package has no Pallas kernel here: XLA fuses the norm's arithmetic
itself. Eager PyTorch does not: the plain version below is seven full-size
passes (a f32 copy, four broadcast f32 ops, the cast back, the in-place
LeakyReLU) and about 48 B of traffic per bf16 element. The kernel reads the
conv output once and writes the activation once (4 B per element). The s2d
network (models/s2d.py) runs it in every block, above and below kernel A's
gate; only the source of the moments differs between the two.

Contract: ``x`` (B, C8, *spatial) NCDHW-contiguous, float32 or bfloat16;
``mean`` and ``rstd`` (B, c) float32, one per logical channel, where c =
C8 // groups and channel ``ch`` of x is logical channel ``ch % c`` (the
offset-major s2d layout; groups 1 or 8); ``scale`` and ``bias`` (c,)
float32; optionally ``conv_bias`` (C8,) float32, one per channel of x (the
bias of the convolution that made x, which the s2d blocks fold in here in
place of a separate add). Returns ``y = ((v - mean) * rstd) * scale +
bias`` with ``v = x + conv_bias[ch]`` (``v = x`` without it: no add at
all, so a -0 stays -0), each step rounded in f32, rounded to x's dtype,
then with ``slope`` LeakyReLU on the rounded value as torch computes it
(``v > 0 ? v : v * slope`` in f32, rounded). The kernel gives the plain
version's result bit for bit. ``out`` (x's shape and dtype, contiguous; it
may be x itself) takes the result in place of a new tensor.

Bound on the card: bytes, 2 * x's bytes (read once, written once) / 3.35
TB/s. The launch (:func:`launch_plan`) follows from the rows (B * C8) and
their length S alone: a block covers part of one row, so its five
parameters stay in registers; each thread issues 4 independent 16-byte
loads where a row is whole 16-byte units at a 16-byte base, element loads
where it is not (the 45-voxel rows of the deepest stage).

On a CPU tensor the wrapper runs :func:`norm_apply_plain`; on a CUDA tensor
it launches the kernel or raises.
"""
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

THREADS = 256   # most threads per block (the kernel's __launch_bounds__)
UNROLL = 4      # independent loads per thread (kUnroll in csrc/norm_apply.cu)


@functools.lru_cache(maxsize=256)
def launch_plan(rows: int, S: int, itemsize: int, aligned: bool = True
                ) -> dict:
    """Kernel E's launch for ``rows`` rows of ``S`` voxels of ``itemsize``
    bytes: ``vec`` (16-byte units: rows of whole units at a 16-byte
    ``aligned`` base, else elements), ``threads`` per block (a multiple of
    32, at most 256, no more than a row's units need), ``chunks`` blocks per
    row, ``blocks`` in all. Cached: do not mutate."""
    vec = bool(aligned) and S * itemsize % 16 == 0
    units = S * itemsize // 16 if vec else S
    threads = min(THREADS, max(32, -(-units // (UNROLL * 32)) * 32))
    chunks = max(1, -(-units // (UNROLL * threads)))
    return {"vec": vec, "threads": threads, "chunks": chunks,
            "blocks": rows * chunks}


def _tiled(v: torch.Tensor, groups: int, shape) -> torch.Tensor:
    """(B, c) or (c,) per logical channel -> broadcastable over (B, C8, ...)
    with C8 = groups * c (offset-major: channel ch takes ch % c)."""
    reps = (1, groups) if v.dim() == 2 else (groups,)
    return v.float().repeat(*reps).reshape(shape)


def norm_apply_plain(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor, groups: int,
                     slope: Optional[float] = None,
                     out: Optional[torch.Tensor] = None,
                     conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the contract: the s2d norm's former torch
    sequence, op for op, on ``x + conv_bias`` in f32 where it is given."""
    B, C8 = x.shape[0], x.shape[1]
    shape = (B, C8) + (1,) * (x.dim() - 2)
    y = x.to(torch.float32, copy=True)
    if conv_bias is not None:
        y.add_(conv_bias.float().reshape((1, C8) + shape[2:]))
    y.sub_(_tiled(mean, groups, shape)).mul_(_tiled(rstd, groups, shape))
    shape = (1,) + shape[1:]
    y.mul_(_tiled(scale, groups, shape)).add_(_tiled(bias, groups, shape))
    y = y.to(x.dtype) if out is None else out.copy_(y)
    return y if slope is None else F.leaky_relu_(y, slope)


def norm_apply(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor, groups: int,
               slope: Optional[float] = None,
               out: Optional[torch.Tensor] = None,
               conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The contract above. CUDA tensors go through the hand-written kernel
    (counted in ``norm_apply.launches``, and those that took a conv bias in
    ``norm_apply.bias_launches``), CPU tensors through the plain version."""
    if x.device.type == "cpu":
        return norm_apply_plain(x, mean, rstd, scale, bias, groups, slope, out,
                                conv_bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() < 3 or not x.is_contiguous():
        raise ValueError(
            "norm kernel reads NCDHW-contiguous rows of S voxels per (b, c); "
            f"got shape {tuple(x.shape)} strides {x.stride()}")
    B, C8 = x.shape[0], x.shape[1]
    if groups < 1 or C8 % groups:
        raise ValueError(f"{C8} channels do not split into {groups} groups")
    c = C8 // groups
    params = [mean.float().contiguous(), rstd.float().contiguous(),
              scale.float().contiguous(), bias.float().contiguous()]
    shapes = [(B, c), (B, c), (c,), (c,)]
    if conv_bias is not None:
        params.append(conv_bias.float().contiguous())
        shapes.append((C8,))
    for t, want in zip(params, shapes):
        if tuple(t.shape) != want or t.device != x.device:
            raise ValueError(f"norm parameter {tuple(t.shape)} on {t.device};"
                             f" want {want} on {x.device}")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or not out.is_contiguous() or out.device != x.device):
        raise ValueError("out must be a contiguous tensor of x's shape, "
                         "dtype and device")
    code = _build.dtype_code(x)
    rows = B * C8
    S = math.prod(x.shape[2:])
    if rows == 0 or S == 0:
        return out
    plan = launch_plan(rows, S, x.element_size(),
                       x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    if plan["blocks"] >= 1 << 31:
        raise ValueError(f"{plan['blocks']} blocks exceed the grid's limit")
    m, r, sc, bi = params[:4]
    cb = params[4].data_ptr() if conv_bias is not None else None
    err = _build.library().fnn_norm_apply(
        x.data_ptr(), out.data_ptr(), code, rows, S, C8, c, plan["threads"],
        plan["chunks"], int(plan["vec"]), cb, m.data_ptr(), r.data_ptr(),
        sc.data_ptr(), bi.data_ptr(), int(slope is not None),
        0.0 if slope is None else float(slope), _build.stream_ptr(x))
    _build.check(err, "norm_apply")
    norm_apply.launches += 1
    norm_apply.bias_launches += conv_bias is not None
    return out


norm_apply.launches = 0
norm_apply.bias_launches = 0
