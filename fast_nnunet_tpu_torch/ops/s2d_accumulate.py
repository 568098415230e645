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
  f32 values (bf16 weights convert exactly); bf16 weights passed as bf16
  (the engine does) let the kernel fuse the head dot (below).
- ``g_s2d`` (p0h, pyh, pzh, 8) f32 gaussian; ``coords_h`` host (B, 2)
  half-res (yh0, zh0); ``valid`` host (B,) 0/1 — a 0 slot is skipped.

Two accumulator modes, chosen by ``acc.dtype``:

- float32 — the Pallas contract: ``acc += (dot + b) * g`` in f32.
- bfloat16 — the XLA default sweep op for op: ``y = bf16(bf16(dot) + b)``,
  ``c = bf16(f32(y) * g)``, ``acc = bf16(acc + c)``.

The head dot is an ordered f32 sum over f = 0..F-1 of products each rounded
to f32, so the kernel and the plain version agree bit for bit in both modes. The
kernel fuses a multiply-add (one rounding) only where that changes no bit:
when the features and the weights both arrive as bf16 tensors (a host fact,
no sync), every product has at most 16 significant bits and is exact in
f32. One exception: a product whose lowest bit falls below 2^-149 (one
under f32's normal range, ``|x * w| < 2^-126`` or so) is rounded by the
plain version and not by the fused one, and the dot may then differ by a
few units of 2^-149 (tests/test_torch_kernels_cuda.py bounds it).

Bound on the card: bytes, on paper. The accumulator's union of covering
tiles is read and written once and the features read once; the head is
2F+3 f32 flop per output lane, and at the main path's call (8 live tiles)
the flop floor (0.376 ms at 67 TFLOP/s) lies under the byte floor
(0.454 ms at 3.35 TB/s). Design (launch plan: :func:`launch_plan`): a block
owns one (virtual row i, plane row Y) line of the accumulator for the whole
launch and walks it in z-segments of 16 voxels (8 where 16 would not fit in
shared memory), all lanes. Each segment's piece is copied to shared memory
once with 16-byte ``cp.async``, gets every covering tile in batch order and
is written back once: the accumulator moves once per launch (the design
this one replaced, one block per accumulator row walking the tiles, moved
it once per covering tile, about 2.5 times), without atomics and
deterministic. One warp lists the block's steps (segment, covering tile)
with ballots; a step costs one barrier, and while its math runs the step
after next is loading (bf16 features as aligned 16-byte chunks, whatever the
tile's z-start), the next is staged as f32, and at a segment's first step
the next segment's piece is in flight. Each thread keeps two lanes of one
offset group and their head weights for f < 32 in registers; any F is
taken (a head wider than 32 reads the rest of its weights through L1).

What bounds it, measured (``python tools/ablate_s2d_accumulate.py`` and
chip_smoke.py, H100 80GB HBM3 at 700 W): about 1.7 ms at the main path's
captured call, a quarter of the byte bound; with every load and store
switched off it keeps most of that time, so instruction issue on the CUDA
cores bounds it — 16 multiply-adds per output lane and tile plus the bf16
epilogue's roundings. Tensor cores (``mma``) would take the head dot off
the CUDA cores but sum in another order than the plain version's ordered
f32 sum, and the kernel would lose its bit-exact check.

On a CPU tensor the wrapper runs :func:`s2d_accumulate_plain`; on a CUDA
tensor it launches the kernel or raises.
"""
import ctypes
from typing import Sequence

import numpy as np
import torch

from . import _build

MAX_TILES = 32    # csrc/s2d_accumulate.cu kMaxTiles
SEGS = (16, 8)    # z voxels of a block's accumulator piece, by preference
THREADS = 256     # kThreads: thread (o, kq) holds lanes 2kq, 2kq + 1 of o
FEATURE_PAD = 4   # kFPad: floats after each offset group's staged features
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100


class _Geometry(ctypes.Structure):
    """csrc/s2d_accumulate.cu FnnS2dGeometry, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "B", "p0h", "pyh", "pzh", "F", "K", "Yh", "Zh", "c8p",
        "row_base", "y_lo", "y_hi", "seg", "seg_lo", "seg_hi",
        "lane_pairs", "n_pass", "piece_off", "fb_off", "gb_off",
        "steps_off", "segs_off", "smem", "vec16", "fvec", "fuse")]


def launch_plan(acc_shape: Sequence[int], acc_itemsize: int, F: int, K: int,
                pyh: int, pzh: int, live_coords: np.ndarray) -> dict:
    """The kernel's grid and shared-memory layout for one call.

    Block (Y, i) owns accumulator row i, plane row Y in [y_lo, y_hi), and
    walks it in z-segments [s * seg, min((s + 1) * seg, Zh)) for s in
    [seg_lo, seg_hi): the segments tile the live tiles' z-span, so every
    (Y, z) a live tile covers belongs to exactly one piece of one block.
    seg is 16, or 8 where 16 would not fit. A step is (segment, covering
    tile); a block has at most n_seg * B. Shared memory, in order: three
    piece buffers (seg voxels x c8p lanes, piece_off apart), two staged
    feature buffers ((8, F, seg) f32 with FEATURE_PAD floats after each
    offset group), two gaussian buffers (seg, 8), the step list (16 B a
    step), the segment pieces (8 B each)."""
    _, _, Zh, c8p = acc_shape
    if not len(live_coords):
        raise ValueError("no live tile to plan for")
    B = len(live_coords)
    lane_pairs = -(-K // 2)
    z_lo = int(live_coords[:, 1].min())
    z_hi = int(live_coords[:, 1].max()) + pzh
    for seg in SEGS:
        seg_lo, seg_hi = z_lo // seg, -(-z_hi // seg)
        piece = -(-seg * c8p * acc_itemsize // 16) * 16
        fb_off = 3 * piece
        gb_off = fb_off + 2 * 8 * (F * seg + FEATURE_PAD) * 4
        steps_off = gb_off + 2 * seg * 8 * 4
        segs_off = steps_off + 16 * (seg_hi - seg_lo) * B
        smem = segs_off + -(-8 * (seg_hi - seg_lo) // 16) * 16
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"kernel C needs {smem} B of shared memory "
                         f"(> {SMEM_LIMIT}) for c8p={c8p}, F={F}")
    return {"y_lo": int(live_coords[:, 0].min()),
            "y_hi": int(live_coords[:, 0].max()) + pyh,
            "seg": seg, "seg_lo": seg_lo, "seg_hi": seg_hi,
            "lane_pairs": lane_pairs,
            "n_pass": -(-8 * lane_pairs // THREADS),
            "piece_off": piece, "fb_off": fb_off, "gb_off": gb_off,
            "steps_off": steps_off, "segs_off": segs_off, "smem": smem}


def feature_runs_16b(feats: torch.Tensor) -> bool:
    """Whether the kernel may load features in aligned 16-byte chunks: bf16
    features whose (pzh) z-rows are whole chunks, 16-byte aligned. Any tile
    z-start is then fine (a run of 8 z is cut from the two chunks that hold
    it); otherwise the kernel loads them z by z."""
    return (feats.dtype == torch.bfloat16 and feats.shape[4] % 8 == 0
            and feats.data_ptr() % 16 == 0)


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
    if not (valid != 0).any():
        return acc
    launch_kernel(_build.library(), acc, feats, g_s2d, w, b, coords, valid,
                  row_base)
    s2d_accumulate.launches += 1
    return acc


s2d_accumulate.launches = 0


def launch_kernel(lib, acc, feats, g_s2d, w, b, coords: np.ndarray,
                  valid: np.ndarray, row_base: int) -> None:
    """Plan kernel C for one call and launch it from ``lib`` (the kernel
    library :func:`_build.library` built) on inputs :func:`s2d_accumulate`
    has checked, with at least one live tile."""
    p0h, Yh, Zh, c8p = acc.shape
    pyh, pzh = feats.shape[3], feats.shape[4]
    F, K = w.shape[1], w.shape[2]
    acc_code, feat_code = _build.dtype_code(acc), _build.dtype_code(feats)
    plan = launch_plan(acc.shape, acc.element_size(), F, K, pyh, pzh,
                       coords[valid != 0])
    g32 = g_s2d.float().contiguous()
    if g32.data_ptr() % 16:  # the kernel reads it as float4
        g32 = g32.clone()
    w32 = w.float().contiguous()
    b32 = b.float().contiguous()
    geom = _Geometry(
        B=len(valid), p0h=p0h, pyh=pyh, pzh=pzh, F=F, K=K, Yh=Yh, Zh=Zh,
        c8p=c8p, row_base=int(row_base) % p0h,
        vec16=int(c8p * acc.element_size() % 16 == 0
                  and acc.data_ptr() % 16 == 0),
        fvec=int(feature_runs_16b(feats)),
        fuse=int(feats.dtype == w.dtype == torch.bfloat16), **plan)
    yh0 = np.ascontiguousarray(coords[:, 0])
    zh0 = np.ascontiguousarray(coords[:, 1])
    err = lib.fnn_s2d_accumulate(
        acc.data_ptr(), acc_code, feats.data_ptr(), feat_code,
        g32.data_ptr(), w32.data_ptr(), b32.data_ptr(), yh0.ctypes.data,
        zh0.ctypes.data, valid.ctypes.data, ctypes.addressof(geom),
        _build.stream_ptr(acc))
    _build.check(err, "s2d_accumulate")


def seg_head_blocks(w_dense: torch.Tensor) -> torch.Tensor:
    """(8F, 8K) block-diagonal seg head (fast_nnunet_tpu expand_seg_head
    layout) -> (8, F, K) per-offset diagonal blocks."""
    F8, C8 = w_dense.shape
    F, K = F8 // 8, C8 // 8
    w4 = w_dense.reshape(8, F, 8, K)
    return torch.stack([w4[o, :, o, :] for o in range(8)])
