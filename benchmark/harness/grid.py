"""The serving cell's geometry, frozen: the s2d sweep's tile grid, its
batches, the air rule, and the work counted from shapes.

Everything here is worked out from a configuration and a CT's geometry,
without the program: the reference and the per-layer readers use it, so
that a change to the program does not move the yardstick.

Axis orders: "image" is the CT's (z, y, x); "engine" is the image order
sorted by patch extent (stable), so the chunk axis (engine axis 0) carries
the smallest extent, as the configuration's deployment does.
"""
import math
from typing import List, Sequence, Tuple

import numpy as np

from .. import kernels

#: H100 SXM, NVIDIA's data sheet (dense, no sparsity), at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
#: the peak each kernel file's ``BOUND`` divides its work by
PEAKS = {"hbm": HBM_BYTES_PER_S, "bf16": BF16_FLOPS_PER_S}
SHAPE_BUCKET = 32            # in-plane padding of the sweep volume


def round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def transpose_forward(patch_image: Sequence[int]) -> List[int]:
    """Image axes in engine order: sorted by patch extent, ties kept."""
    return sorted(range(len(patch_image)), key=lambda a: patch_image[a])


def nnunet_steps(size: int, patch: int, step: float) -> List[int]:
    """nnU-Net's tile starts along one axis: at most patch*step apart,
    evenly spread, the last ending at the border."""
    n = int(math.ceil((size - patch) / (patch * step))) + 1
    if n == 1:
        return [0]
    d = (size - patch) / (n - 1)
    return [int(np.round(d * i)) for i in range(n)]


def target_shape(in_shape: Sequence[int], spacing: Sequence[float],
                 target_spacing: Sequence[float], patch: Sequence[int]):
    """The target-spacing grid of a CT (any one axis order), at least the
    patch."""
    return tuple(max(int(round(n * s / t)), p) for n, s, t, p in
                 zip(in_shape, spacing, target_spacing, patch))


def sweep_plan(new_shape: Sequence[int], patch: Sequence[int], step: float):
    """Engine order: (vol_shape, steps). Each axis is tightened to even;
    the starts are nnU-Net's on the tight extent, rounded down to even;
    the in-plane axes are padded to the shape bucket."""
    tight = [round_up(max(int(n), p), 2) for n, p in zip(new_shape, patch)]
    steps = [sorted({s - s % 2 for s in nnunet_steps(t, p, step)})
             for t, p in zip(tight, patch)]
    vol = [tight[0]] + [round_up(round_up(t, SHAPE_BUCKET), 2)
                        for t in tight[1:]]
    return tuple(vol), steps


def plane_batches(steps, batch: int) -> Tuple[np.ndarray, np.ndarray]:
    """The in-plane tiles of one chunk, z fastest, in batches of ``batch``
    (fewer when the plane has fewer tiles), the last padded by repeats:
    (coords (nb, B, 2), valid (nb, B))."""
    ys, zs = np.meshgrid(steps[1], steps[2], indexing="ij")
    coords = np.stack([ys.ravel(), zs.ravel()], 1).astype(np.int64)
    n = len(coords)
    B = min(batch, max(1, n))
    nt = round_up(n, B)
    if nt > n:
        coords = np.concatenate([coords, np.repeat(coords[-1:], nt - n, 0)])
    valid = np.zeros(nt, np.float32)
    valid[:n] = 1
    return coords.reshape(nt // B, B, 2), valid.reshape(nt // B, B)


def flags_from_rowmax(rowmax: np.ndarray, starts_x, coords: np.ndarray,
                      patch: Sequence[int], fill: float, threshold: float
                      ) -> np.ndarray:
    """The configuration's air rule, per tile: a tile holds body when the
    largest voxel over its chunk's exact x extent and the 8 x 8 in-plane
    blocks its window touches exceeds ``threshold``. ``rowmax``: per row
    of the padded sweep volume (engine order, bf16 values), the maxima of
    its 8 x 8 blocks, the plane padded with ``fill`` to whole blocks.
    Returns (n_chunks, nb, B) bool."""
    p0, py, pz = (int(p) for p in patch)
    wy, wz = py // 8 + 1, pz // 8 + 1
    out = np.zeros((len(starts_x),) + coords.shape[:2], bool)
    for k, x0 in enumerate(starts_x):
        blocks = rowmax[x0:x0 + p0].max(0)
        if p0 % 8:
            blocks = np.maximum(blocks, fill)
        by, bz = blocks.shape
        padded = np.full((by + wy - 1, bz + wz - 1), -np.inf, np.float32)
        padded[:by, :bz] = blocks
        box = np.lib.stride_tricks.sliding_window_view(
            padded, (wy, wz)).max((2, 3))
        out[k] = box[coords[..., 0] // 8, coords[..., 1] // 8] > threshold
    return out


def owned_rows(starts_x, k: int, p0: int) -> int:
    """Half-resolution rows chunk k finishes."""
    if k == len(starts_x) - 1:
        return p0 // 2
    return (starts_x[k + 1] - starts_x[k]) // 2


# ------------------------------------------------------------- the network
def unet_stages(arch: dict, patch: Sequence[int]):
    """Per encoder stage: (features, spatial shape) of a PlainConvUNet."""
    shape = list(patch)
    out = []
    for f, st in zip(arch["features_per_stage"], arch["strides"]):
        shape = [s // t for s, t in zip(shape, st)]
        out.append((int(f), tuple(shape)))
    return out


def conv_flops(cin: int, cout: int, kernel: Sequence[int], voxels: int
               ) -> int:
    """Multiply-adds x 2 of one convolution over ``voxels`` outputs."""
    return 2 * cin * cout * math.prod(kernel) * voxels


def unet_forward_flops(arch: dict, in_channels: int, num_classes: int,
                       patch: Sequence[int], deep_supervision: bool) -> int:
    """Model FLOPs of one PlainConvUNet forward on one patch, counted from
    the shapes: convolutions, transposed convolutions and seg heads (norms
    and activations are a few operations a voxel and are left out). No
    recomputation is counted."""
    st = unet_stages(arch, patch)
    ks = arch["kernel_sizes"]
    total, cin = 0, in_channels
    for s, (f, shape) in enumerate(st):
        v = math.prod(shape)
        for i in range(arch["n_conv_per_stage"][s]):
            total += conv_flops(cin if i == 0 else f, f, ks[s], v)
        cin = f
    n = len(st)
    for d in range(n - 1):
        s = n - 1 - d              # the stage it rises from
        fin, fout = st[s][0], st[s - 1][0]
        v = math.prod(st[s - 1][1])
        # a transposed conv (kernel = stride): every input voxel spreads
        # over prod(stride) outputs
        total += conv_flops(fin, fout, arch["strides"][s],
                            math.prod(st[s][1]))
        for i in range(arch["n_conv_per_stage_decoder"][d]):
            total += conv_flops(2 * fout if i == 0 else fout, fout,
                                ks[s - 1], v)
        if deep_supervision or d == n - 2:
            total += conv_flops(fout, num_classes, (1, 1, 1), v)
    return total


def gated_norm_shapes(arch: dict, patch: Sequence[int], batch: int,
                      s2d: bool, min_voxels: int = 4096):
    """The input shapes of the InstanceNorms whose statistics come from
    kernel A in one forward, in forward order: every norm with at least
    ``min_voxels`` spatial voxels. In the s2d form the outer octave runs at
    half resolution with 8 x the channels."""
    st = unet_stages(arch, patch)
    n = len(st)
    enc, dec = [], []
    for s, (f, shape) in enumerate(st):
        c, sh = f, shape
        if s2d and s == 0:
            c, sh = 8 * f, tuple(v // 2 for v in shape)
        enc += [(batch, c) + tuple(sh)] * arch["n_conv_per_stage"][s]
    for d in range(n - 1):
        s = n - 2 - d
        f, shape = st[s]
        c, sh = f, shape
        if s2d and s == 0:
            c, sh = 8 * f, tuple(v // 2 for v in shape)
        dec += [(batch, c) + tuple(sh)] * arch["n_conv_per_stage_decoder"][d]
    return [t for t in enc + dec if math.prod(t[2:]) >= min_voxels]


# ------------------------------------------------------------ kernel bytes
def bytes_a(shape, itemsize: int = 2) -> int:
    """Kernel A: the activation read once, (sum, sumsq) f32 written."""
    return math.prod(shape) * itemsize + 2 * shape[0] * shape[1] * 4


def bytes_b(n_rows: int, plane_h: Tuple[int, int], K: int, zeroes: bool,
            itemsize: int = 2) -> int:
    """Kernel B: n_rows accumulator rows (8K values a voxel) read, the
    uint8 labels of their 8 offsets written, and the rows written back as
    zeros when it retires them."""
    vox = n_rows * plane_h[0] * plane_h[1]
    acc = vox * 8 * K * itemsize
    return acc + vox * 8 + (acc if zeroes else 0)


def bytes_c(coords_h: np.ndarray, live: np.ndarray, p0h: int,
            tile_h: Tuple[int, int], plane_h: Tuple[int, int], F: int,
            K: int, itemsize: int = 2) -> int:
    """Kernel C: the live tiles' pre-head features read, the accumulator
    under their union read and written (p0h rows, 8K values a voxel), the
    gaussian and the head's weights and bias read (counted as f32)."""
    pyh, pzh = tile_h
    union = np.zeros(plane_h, bool)
    n_live = 0
    for (y, z), v in zip(coords_h, live):
        if v:
            union[y:y + pyh, z:z + pzh] = True
            n_live += 1
    S = p0h * pyh * pzh
    return (2 * int(union.sum()) * p0h * 8 * K * itemsize
            + n_live * 8 * F * S * itemsize
            + S * 8 * 4 + 8 * F * K * 4 + 8 * K * 4)


def bytes_e(shape, itemsize: int = 2) -> int:
    """Kernel E: the activation read once and written once (the norm's
    statistics and affine, a few values a channel, left out)."""
    return 2 * math.prod(shape) * itemsize


def roofline_percent(run: dict, kernel: str):
    """A kernel's share of its roofline over a traced slice, in %: the work
    its launches need (the runner's ``work[kernel] = (launches, amount)``,
    bytes or FLOPs as the kernel file's ``BOUND`` says) at that bound's
    peak, over its kernel time; None where the trace holds no such kernel,
    or holds another number of launches than the shapes' count (the count
    then does not describe the work)."""
    t, w = run.get("trace"), run.get("work")
    if not t or not w or kernel not in w or kernel not in t["kernels"]:
        return None
    seconds, launches = t["kernels"][kernel]
    want, amount = w[kernel]
    if launches != want or seconds <= 0:
        return None
    return 100.0 * amount / PEAKS[kernels.registry()[kernel][1]] / seconds
