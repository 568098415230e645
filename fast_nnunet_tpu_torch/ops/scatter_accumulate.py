"""Kernel D — the plain (full-resolution) sweep's accumulate: every tile of a
batch, multiplied by the gaussian importance map, added into the sweep
accumulator at its coordinates.

Replaces: fast_nnunet_tpu/ops/pallas_kernels.py ``fused_scatter_accumulate``
(the JAX engine's ``use_pallas_accumulate`` route, engine.py:267-288). Same
signature and contract, so one test feeds identical arrays to both::

    acc (X, Y, Z, C) += logits[b] * gauss   at coords[b], for b < n_real

- ``acc`` (X, Y, Z, C), updated IN PLACE and returned (the JAX function
  returns a new array through an aliased output);
- ``logits`` (B, px, py, pz, C) in ``acc.dtype``: the network's logits with
  channel K a constant-1 weight channel and zero channels up to C;
- ``gauss_flat`` (px, py, pz * C) in ``acc.dtype``: the gaussian broadcast
  over the flattened (z, channel) minor dim;
- ``coords`` host (B, 3) int; ``n_real`` host int — items from it on are
  ignored (padding of a same-coset batch);
- C a multiple of 8.

The TPU kernel also needed items < n_real to be pairwise disjoint and y/z
coords multiples of 16 (its DMA pipeline and Mosaic's offset proofs). This
one does not: tiles are applied in batch order, so overlapping tiles are
well defined, and any in-bounds coordinate is taken.

Numerics, identical in the kernel and :func:`fused_scatter_accumulate_plain`
(so the two agree bit for bit on the card):

- bfloat16: ``acc = bf16(f32(acc) + f32(l) * f32(g))`` — the bf16 x bf16
  product is exact in f32, so each add rounds once (to f32, then to bf16);
- float32: ``acc + l * g`` with no fused multiply-add.

Bound on the card: bytes. Per live tile the logits and the accumulator
footprint are read and the footprint written once, plus the gaussian; two
flop per element, far under the card's ridge. Design: the TPU version
double-buffers DMAs through a small VMEM; here block r owns one (x, y) row of
the batch's footprint and walks the tiles in batch order, adding each
covering tile's contiguous z*C lane run with 16-byte vector loads; a barrier
between two covering tiles keeps their order. No atomics, and every element
is written by one block: the result is deterministic.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
import numpy as np
import torch

from . import _build

MAX_TILES = 32  # csrc/scatter_accumulate.cu kMaxTiles


def _host_coords(coords, n_real: int, batch: int) -> np.ndarray:
    if isinstance(coords, torch.Tensor):
        if coords.device.type != "cpu":
            raise ValueError("coords must be on the host (numpy or a CPU "
                             "tensor): the kernel takes them by value")
        coords = coords.numpy()
    coords = np.ascontiguousarray(np.asarray(coords, np.int32))
    if coords.shape != (batch, 3):
        raise ValueError(f"coords {coords.shape}, expected ({batch}, 3)")
    if not 0 <= n_real <= batch:
        raise ValueError(f"n_real {n_real} outside [0, {batch}]")
    return coords


def _check(acc, logits, gauss_flat, coords, n_real):
    B, px, py, pz, C = logits.shape
    X, Y, Z, C2 = acc.shape
    if C != C2 or C % 8:
        raise ValueError(f"channels: logits {C}, acc {C2} (must match and "
                         "be a multiple of 8)")
    if tuple(gauss_flat.shape) != (px, py, pz * C):
        raise ValueError(f"gauss_flat {tuple(gauss_flat.shape)}, expected "
                         f"{(px, py, pz * C)}")
    if logits.dtype != acc.dtype or gauss_flat.dtype != acc.dtype:
        raise TypeError(f"logits {logits.dtype} and gauss_flat "
                        f"{gauss_flat.dtype} must have acc's dtype "
                        f"{acc.dtype}")
    c = _host_coords(coords, int(n_real), B)
    live = c[:int(n_real)]
    if len(live) and not ((live >= 0).all()
                          and (live[:, 0] + px <= X).all()
                          and (live[:, 1] + py <= Y).all()
                          and (live[:, 2] + pz <= Z).all()):
        raise ValueError("tile coords fall outside the accumulator")
    return c


def fused_scatter_accumulate_plain(acc: torch.Tensor, logits: torch.Tensor,
                                   gauss_flat: torch.Tensor, coords,
                                   n_real: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract (same op order)."""
    c = _check(acc, logits, gauss_flat, coords, n_real)
    _, px, py, pz, C = logits.shape
    g = gauss_flat.reshape(px, py, pz, C)
    bf16 = acc.dtype == torch.bfloat16
    if bf16:
        g = g.float()
    for b in range(int(n_real)):
        x, y, z = (int(v) for v in c[b])
        sl = (slice(x, x + px), slice(y, y + py), slice(z, z + pz))
        cur = acc[sl]
        if bf16:
            acc[sl] = (cur.float() + logits[b].float() * g).bfloat16()
        else:
            acc[sl] = cur + logits[b] * g
    return acc


def fused_scatter_accumulate(acc: torch.Tensor, logits: torch.Tensor,
                             gauss_flat: torch.Tensor, coords,
                             n_real: int) -> torch.Tensor:
    """Accumulate one tile batch into ``acc`` in place (see the module
    docstring) and return it. CUDA tensors go through the hand-written
    kernel (counted in ``fused_scatter_accumulate.launches``), CPU tensors
    through the plain version."""
    if acc.device.type == "cpu":
        return fused_scatter_accumulate_plain(acc, logits, gauss_flat, coords,
                                              n_real)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    c = _check(acc, logits, gauss_flat, coords, n_real)
    for name, t in (("logits", logits), ("gauss_flat", gauss_flat)):
        if t.device != acc.device:
            raise ValueError(f"{name} on {t.device}, acc on {acc.device}")
    for name, t in (("acc", acc), ("logits", logits),
                    ("gauss_flat", gauss_flat)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    n_real = int(n_real)
    if n_real > MAX_TILES:
        raise ValueError(f"{n_real} tiles (kernel takes up to {MAX_TILES})")
    if n_real == 0:
        return acc
    _, px, py, pz, C = logits.shape
    live = c[:n_real]
    x_lo, y_lo = int(live[:, 0].min()), int(live[:, 1].min())
    x_hi, y_hi = int(live[:, 0].max()) + px, int(live[:, 1].max()) + py
    x0, y0, z0 = (np.ascontiguousarray(c[:, i]) for i in range(3))
    lib = _build.library()
    err = lib.fnn_scatter_accumulate(
        acc.data_ptr(), _build.dtype_code(acc), logits.data_ptr(),
        gauss_flat.data_ptr(), x0.ctypes.data, y0.ctypes.data, z0.ctypes.data,
        n_real, px, py, pz, acc.shape[1], acc.shape[2], C, x_lo, x_hi, y_lo,
        y_hi, _build.stream_ptr(acc))
    _build.check(err, "fused_scatter_accumulate")
    fused_scatter_accumulate.launches += 1
    return acc


fused_scatter_accumulate.launches = 0
