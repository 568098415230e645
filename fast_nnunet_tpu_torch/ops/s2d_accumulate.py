"""Kernel C — the s2d sweep's hot loop: 1^3 seg head + gaussian weight +
accumulator read-modify-write, fused, for one batch of tiles.

Replaces: fast_nnunet_tpu/ops/pallas_s2d.py ``fused_head_gauss_accumulate``
(opt-in there under ``FNN_PALLAS_S2D``) and, in its bf16 mode, the XLA
``accumulate_batch`` the JAX sweep runs by default
(fast_nnunet_tpu/inference/turbo.py:653-671, engine.py:1273-1292).

Contract, for every tile t of the batch with ``valid[t] != 0``, in batch
order (tiles of one batch may overlap: step 0.5)::

    acc[(row_base + i) % p0h, yh0_t + y, zh0_t + z, o*K + k]  "+="
        (sum_f feats[t, o*F + f, i, y, z] * w[o, f, k] + b[o*K + k])
        * g_s2d[i, y, z, o] * valid[t]

- ``acc`` (p0h, Yh, Zh, c8p), updated IN PLACE; lanes >= 8K untouched.
- ``feats`` (B, 8F, p0h, pyh, pzh) — the network's pre-head s2d features,
  channels-first (the TPU kernel took them channels-last).
- ``w`` (8, F, K) — the per-offset diagonal blocks of the block-diagonal
  (8F, 8K) seg head (the 7/8 structural zeros of the dense TPU form add exact
  zeros, so skipping them changes nothing); ``b`` (8K,). Both are used as
  f32 values (bf16 weights convert exactly).
- ``g_s2d`` (p0h, pyh, pzh, 8) f32 gaussian; ``coords_h`` host (B, 2)
  half-res (yh0, zh0); ``valid`` host (B,) 0/1 — a 0 slot is skipped.

Two accumulator modes, chosen by ``acc.dtype``:

- float32 — the Pallas contract: ``acc += (dot + b) * g`` in f32.
- bfloat16 — the XLA default sweep op for op: ``y = bf16(bf16(dot) + b)``,
  ``c = bf16(f32(y) * g)``, ``acc = bf16(acc + c)``.

The head dot is an ordered f32 sum of unrounded-product terms f = 0..F-1
(no fused multiply-add), identical in the kernel and the plain version, so
the two agree bit for bit in both modes.

Bound on the card: bytes. Per tile the accumulator region is read and
written once (2 x p0h*pyh*pzh*8K*itemsize) and the features read once; the
head is 2*F flop per output lane, about 16 flop per accumulator byte in
bf16 — far under the 295 flop/byte ridge, so CUDA cores suffice and tensor
cores would not move the floor. Design: block (Y, i) owns one accumulator
row and walks the batch's tiles in batch order, so overlapping tiles need
neither atomics nor one launch per tile, and every element is written by one
block (deterministic). The tile's feature row and gaussian row are staged in
shared memory; the per-offset weights stay there for the block's life.
Blocks whose row no valid tile covers exit at once.

On a CPU tensor the wrapper runs :func:`s2d_accumulate_plain`; on a CUDA
tensor it launches the kernel or raises.
"""
from typing import Sequence

import numpy as np
import torch

from . import _build

MAX_TILES = 32  # csrc/s2d_accumulate.cu kMaxTiles


def _host_tiles(coords_h, valid):
    coords = np.ascontiguousarray(np.asarray(coords_h, np.int32).reshape(-1, 2))
    valid = np.ascontiguousarray(np.asarray(valid, np.float32).reshape(-1))
    if len(coords) != len(valid):
        raise ValueError(f"{len(coords)} tile coords but {len(valid)} flags")
    return coords, valid


def _check_shapes(acc, feats, g_s2d, w, b, coords):
    p0h, Yh, Zh, c8p = acc.shape
    B, F8, p0h_f, pyh, pzh = feats.shape
    _, F, K = w.shape
    if not (w.shape[0] == 8 and F8 == 8 * F and p0h_f == p0h and
            8 * K <= c8p and b.shape == (8 * K,) and
            tuple(g_s2d.shape) == (p0h, pyh, pzh, 8) and len(coords) == B):
        raise ValueError(
            f"inconsistent shapes: acc {tuple(acc.shape)}, feats "
            f"{tuple(feats.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}, "
            f"g {tuple(g_s2d.shape)}, {len(coords)} coords")
    if len(coords) and not (coords[:, 0].min() >= 0 and coords[:, 1].min() >= 0
                            and coords[:, 0].max() + pyh <= Yh
                            and coords[:, 1].max() + pzh <= Zh):
        raise ValueError("tile coords fall outside the accumulator plane")


def s2d_accumulate_plain(acc: torch.Tensor, feats: torch.Tensor,
                         g_s2d: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor, coords_h: Sequence, valid: Sequence,
                         row_base: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract (same op order)."""
    coords, valid = _host_tiles(coords_h, valid)
    _check_shapes(acc, feats, g_s2d, w, b, coords)
    p0h = acc.shape[0]
    _, F8, _, pyh, pzh = feats.shape
    F, K = w.shape[1], w.shape[2]
    w = w.float()
    bias = b.float().view(8, 1, K)
    g8 = g_s2d.reshape(-1, 8).t()                    # (8, S)
    rows = (row_base + torch.arange(p0h, device=acc.device)) % p0h
    bf16 = acc.dtype == torch.bfloat16
    for t in range(len(valid)):
        v = float(valid[t])
        if v == 0.0:
            continue
        x = feats[t].float().reshape(8, F, -1)       # (8, F, S)
        y = x[:, 0, :, None] * w[:, 0, None, :]      # (8, S, K)
        for f in range(1, F):
            y = y + x[:, f, :, None] * w[:, f, None, :]
        gw = (g8 * v)[..., None]                     # (8, S, 1)
        if bf16:
            y = (y.bfloat16().float() + bias).bfloat16().float()
            contrib = (y * gw).bfloat16()
        else:
            contrib = (y + bias) * gw
        contrib = contrib.reshape(8, p0h, pyh, pzh, K).permute(
            1, 2, 3, 0, 4).reshape(p0h, pyh, pzh, 8 * K)
        y0, z0 = int(coords[t, 0]), int(coords[t, 1])
        idx = (rows, slice(y0, y0 + pyh), slice(z0, z0 + pzh),
               slice(0, 8 * K))
        cur = acc[idx]
        acc[idx] = (cur.float() + contrib.float()).bfloat16() if bf16 \
            else cur + contrib
    return acc


def s2d_accumulate(acc: torch.Tensor, feats: torch.Tensor,
                   g_s2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   coords_h: Sequence, valid: Sequence,
                   row_base: int = 0) -> torch.Tensor:
    """Accumulate one tile batch into ``acc`` in place (see the module
    docstring) and return it. CUDA tensors go through the hand-written
    kernel (counted in ``s2d_accumulate.launches``), CPU tensors through the
    plain version."""
    if acc.device.type == "cpu":
        return s2d_accumulate_plain(acc, feats, g_s2d, w, b, coords_h,
                                    valid, row_base)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    coords, valid = _host_tiles(coords_h, valid)
    _check_shapes(acc, feats, g_s2d, w, b, coords)
    for name, t in (("feats", feats), ("g_s2d", g_s2d), ("w", w), ("b", b)):
        if t.device != acc.device:
            raise ValueError(f"{name} on {t.device}, acc on {acc.device}")
    if not (acc.is_contiguous() and feats.is_contiguous()):
        raise ValueError("acc and feats must be contiguous")
    B = len(valid)
    if not 1 <= B <= MAX_TILES:
        raise ValueError(f"batch of {B} tiles (kernel takes 1..{MAX_TILES})")
    live = valid != 0
    if not live.any():
        return acc
    p0h, Yh, Zh, c8p = acc.shape
    pyh, pzh = feats.shape[3], feats.shape[4]
    F, K = w.shape[1], w.shape[2]
    y_lo = int(coords[live, 0].min())
    y_hi = int(coords[live, 0].max()) + pyh
    g32 = g_s2d.float().contiguous()
    w32 = w.float().contiguous()
    b32 = b.float().contiguous()
    yh0 = np.ascontiguousarray(coords[:, 0])
    zh0 = np.ascontiguousarray(coords[:, 1])
    lib = _build.library()
    err = lib.fnn_s2d_accumulate(
        acc.data_ptr(), _build.dtype_code(acc), feats.data_ptr(),
        _build.dtype_code(feats), g32.data_ptr(), w32.data_ptr(),
        b32.data_ptr(), yh0.ctypes.data, zh0.ctypes.data, valid.ctypes.data,
        B, p0h, pyh, pzh, F, K, Yh, Zh, c8p, int(row_base) % p0h, y_lo, y_hi,
        _build.stream_ptr(acc))
    _build.check(err, "s2d_accumulate")
    s2d_accumulate.launches += 1
    return acc


s2d_accumulate.launches = 0


def seg_head_blocks(w_dense: torch.Tensor) -> torch.Tensor:
    """(8F, 8K) block-diagonal seg head (fast_nnunet_tpu expand_seg_head
    layout) -> (8, F, K) per-offset diagonal blocks."""
    F8, C8 = w_dense.shape
    F, K = F8 // 8, C8 // 8
    w4 = w_dense.reshape(8, F, 8, K)
    return torch.stack([w4[o, :, o, :] for o in range(8)])
