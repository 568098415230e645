"""Kernel B — the s2d sweep's finalize: per-offset argmax over the flat
offset-major accumulator, with the cyclic-accumulator bookkeeping.

Replaces: fast_nnunet_tpu/ops/pallas_finalize.py ``grouped_argmax`` (on by
default in the JAX sweep on a TPU).

Contract: ``acc`` is (p0h, Yh, Zh, c8p) float32 or bfloat16; lanes
[o*K, (o+1)*K) hold the K class scores of s2d offset o, lanes >= 8K are
padding and are never read. For ``n_rows`` virtual rows — virtual row i is
physical row (row_base + i) % p0h — returns (n_rows, 8, Yh, Zh) uint8, the
first-max class of each offset group (ties take the lowest index, NaN counts
as the maximum, as jnp.argmax does). When ``n_zero`` > 0 the first ``n_zero``
virtual rows (all c8p lanes) are zeroed IN PLACE after they are read: the
sweep retires its finalized rows this way and advances ``row_base`` instead
of shifting the accumulator.

Bound on the card: bytes — each finalized row of the accumulator is read
once (plus written once when zeroed) and 1/8 byte per class lane is written;
no tensor-core work. Design (launch plan: :func:`launch_plan`): a block owns
a run of ``RUN`` consecutive voxels of one (virtual row, plane row) line —
contiguous in the accumulator — and copies lanes [0, 8K) of each voxel to
shared memory with 16-byte ``cp.async``, rows an odd number of 16-byte units
apart so that the voxels a warp reads together fall on distinct bank groups.
Retired rows are then zeroed with 16-byte stores of the same run. Thread
(o, v) scans offset group o of voxel v with 16-byte shared-memory reads and
no shuffles (the design this one replaced: one warp per voxel, 80 shuffles
and 8 scattered byte stores per voxel, 2-byte loads); consecutive threads
take consecutive voxels of one group, so the uint8 stores coalesce. The TPU
kernel's arithmetic first-match trick (a workaround for Mosaic layout
limits) is not carried over. The result is exact: the kernel and the plain
version agree bit for bit. Measured (chip_smoke.py, H100 80GB HBM3 at
700 W): about 0.445 ms at the main path's call, 87% of its byte bound.

On a CPU tensor the wrapper runs :func:`grouped_argmax_plain`; on a CUDA
tensor it launches the kernel or raises.
"""
from typing import Sequence

import torch

from . import _build

RUN = 32             # voxels per block: 8 groups x 32 voxels = 256 threads
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100


def launch_plan(acc_shape: Sequence[int], itemsize: int,
                num_classes: int) -> dict:
    """Grid and shared-memory layout: runs of ``run`` voxels (RUN, or half
    of it where f32 rows of many classes would not fit), ``8 * run``
    threads, voxel rows ``stride16`` 16-byte units apart (odd, at least
    lanes [0, 8K))."""
    stride16 = -(-8 * num_classes * itemsize // 16) | 1
    run = RUN if RUN * stride16 * 16 <= SMEM_LIMIT else RUN // 2
    return {"run": run, "threads": 8 * run, "stride16": stride16,
            "smem": run * stride16 * 16, "n_runs": -(-acc_shape[2] // run)}


def _check_args(acc, num_classes, n_rows, row_base, n_zero):
    if acc.dim() != 4:
        raise ValueError(f"acc must be (p0h, Yh, Zh, c8p), got {tuple(acc.shape)}")
    p0h = acc.shape[0]
    if not (8 * num_classes <= acc.shape[3] and 0 < n_rows <= p0h):
        raise ValueError(f"bad finalize geometry: acc {tuple(acc.shape)}, "
                         f"K={num_classes}, n_rows={n_rows}")
    if not 0 <= n_zero <= n_rows:
        raise ValueError(f"n_zero={n_zero} must lie in [0, n_rows={n_rows}]")
    if num_classes > 255:
        raise ValueError("uint8 output holds at most 255 classes")
    if not 0 <= row_base < p0h:
        raise ValueError(f"row_base={row_base} outside [0, {p0h})")


def grouped_argmax_plain(acc: torch.Tensor, num_classes: int, n_rows: int,
                         row_base: int = 0, n_zero: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract."""
    _check_args(acc, num_classes, n_rows, row_base, n_zero)
    p0h, Yh, Zh, _ = acc.shape
    K = num_classes
    rows = (row_base + torch.arange(n_rows, device=acc.device)) % p0h
    r = acc[rows][..., :8 * K].reshape(n_rows, Yh, Zh, 8, K)
    cls = r.argmax(-1).to(torch.uint8).permute(0, 3, 1, 2).contiguous()
    if n_zero:
        acc[rows[:n_zero]] = 0
    return cls


def grouped_argmax(acc: torch.Tensor, num_classes: int, n_rows: int,
                   row_base: int = 0, n_zero: int = 0) -> torch.Tensor:
    """(p0h, Yh, Zh, c8p) accumulator -> (n_rows, 8, Yh, Zh) uint8 per-offset
    argmax of virtual rows (row_base + i) % p0h; zeroes the first n_zero of
    them in place. CUDA tensors go through the hand-written kernel (counted
    in ``grouped_argmax.launches``), CPU tensors through the plain version."""
    if acc.device.type == "cpu":
        return grouped_argmax_plain(acc, num_classes, n_rows, row_base,
                                    n_zero)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    _check_args(acc, num_classes, n_rows, row_base, n_zero)
    if not acc.is_contiguous():
        raise ValueError("accumulator must be contiguous")
    code = _build.dtype_code(acc)
    p0h, Yh, Zh, c8p = acc.shape
    size = acc.element_size()
    plan = launch_plan(acc.shape, size, num_classes)
    vec16 = (8 * num_classes * size % 16 == 0 and c8p * size % 16 == 0
             and acc.data_ptr() % 16 == 0)
    out = torch.empty((n_rows, 8, Yh, Zh), dtype=torch.uint8,
                      device=acc.device)
    lib = _build.library()
    err = lib.fnn_grouped_argmax(
        acc.data_ptr(), code, p0h, Yh, Zh, c8p, num_classes, n_rows,
        row_base, n_zero, plan["run"], plan["stride16"], plan["smem"],
        int(vec16), out.data_ptr(), _build.stream_ptr(acc))
    _build.check(err, "grouped_argmax")
    grouped_argmax.launches += 1
    return out


grouped_argmax.launches = 0
