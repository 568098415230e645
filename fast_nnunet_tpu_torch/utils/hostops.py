"""ctypes binding of the port's host library (csrc/host_ops.cpp, built at
first use by ops/_build.py ``host_library``): the turbo pipeline's host
route — the CT preprocess (clip, z-score, trilinear resize to the target
grid, bf16 out), its box form for one strip, the raw-HU non-air bounding
box, and the nearest mask revert. The port of fast_nnunet_tpu/utils/
hostops.py.

bf16 results are raw ``uint16`` bit patterns; ``torch.from_numpy(bits)
.view(torch.bfloat16)`` reads them (no ml_dtypes). Every function can write
into a caller's array (``out``), such as a view of a pinned staging buffer.
The library is built on first use; a failed build raises with the
compiler's stderr.
"""
import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops import _build


def library() -> ctypes.CDLL:
    """The built host library (builds it on first use)."""
    return _build.host_library()


def _shape3(shape) -> "ctypes.Array":
    return (ctypes.c_int64 * 3)(*[int(s) for s in shape])


def _per_channel(values, n_ch: int) -> "ctypes.Array":
    return (ctypes.c_float * n_ch)(
        *[float(x) for x in np.broadcast_to(values, (n_ch,))])


def _ct_volume(volume: np.ndarray) -> np.ndarray:
    if volume.dtype != np.int16 or volume.ndim != 4:
        raise ValueError(f"expected a (C, D, H, W) int16 volume, got "
                         f"{volume.dtype} {volume.shape}")
    return np.ascontiguousarray(volume)


def _out_array(out: Optional[np.ndarray], shape, dtype) -> np.ndarray:
    shape = tuple(int(s) for s in shape)
    if out is None:
        return np.empty(shape, dtype)
    if out.dtype != dtype or out.shape != shape or \
            not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError(f"out must be a writable C-contiguous {dtype} array "
                         f"of shape {shape}, got {out.dtype} {out.shape}")
    return out


def box_ok(out_shape: Sequence[int], box: Sequence[int]) -> bool:
    """Whether box (k0, k1, j0, j1, i0, i1) is a non-empty half-open box of
    the out_shape grid: 0 <= k0 < k1 <= out_shape[0], and so on."""
    if len(box) != 6 or len(out_shape) != 3:
        return False
    return all(0 <= int(box[2 * a]) < int(box[2 * a + 1]) <= int(out_shape[a])
               for a in range(3))


def preprocess_ct_i16(volume: np.ndarray, out_shape: Sequence[int], lb, ub,
                      mean, std, out: Optional[np.ndarray] = None
                      ) -> np.ndarray:
    """(C, D, H, W) int16 -> (C, *out_shape) bf16 bits (uint16): clip to
    [lb, ub], z-score with (mean, std), trilinear resize (per-channel
    scalars)."""
    shape = [int(s) for s in out_shape]
    return preprocess_ct_i16_box(volume, shape, [0, shape[0], 0, shape[1],
                                                 0, shape[2]],
                                 lb, ub, mean, std, out)


def preprocess_ct_i16_box(volume: np.ndarray, out_shape: Sequence[int],
                          box: Sequence[int], lb, ub, mean, std,
                          out: Optional[np.ndarray] = None
                          ) -> Optional[np.ndarray]:
    """The output voxels in the half-open box [k0,k1) x [j0,j1) x [i0,i1)
    of the whole out_shape grid, as (C, k1-k0, j1-j0, i1-i0) bf16 bits;
    bit-identical to the same region of :func:`preprocess_ct_i16`. A box
    that is not inside the grid, or is empty or reversed, returns None
    before anything is allocated."""
    if not box_ok(out_shape, box):
        return None
    vol = _ct_volume(volume)
    n_ch = vol.shape[0]
    k0, k1, j0, j1, i0, i1 = [int(b) for b in box]
    out = _out_array(out, (n_ch, k1 - k0, j1 - j0, i1 - i0), np.uint16)
    rc = library().fnn_preprocess_ct_i16_box(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        _shape3(vol.shape[1:]), n_ch, _per_channel(lb, n_ch),
        _per_channel(ub, n_ch), _per_channel(mean, n_ch),
        _per_channel(std, n_ch), _shape3(out_shape),
        (ctypes.c_int64 * 6)(k0, k1, j0, j1, i0, i1),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc == 3:
        return None
    if rc != 0:
        raise RuntimeError(f"fnn_preprocess_ct_i16_box returned {rc} for "
                           f"{vol.shape} -> {tuple(out_shape)}")
    return out


def nonair_bbox_i16(volume: np.ndarray, lb) -> Tuple[List[int], List[int]]:
    """Per-axis ([lo]*3, [hi]*3) source-grid extents of the voxels where any
    channel's raw HU exceeds its clip floor lb; ([0]*3, [0]*3) when the
    whole volume is air."""
    vol = _ct_volume(volume)
    n_ch = vol.shape[0]
    lo = (ctypes.c_int64 * 3)()
    hi = (ctypes.c_int64 * 3)()
    rc = library().fnn_nonair_bbox_i16(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        _shape3(vol.shape[1:]), n_ch, _per_channel(lb, n_ch), lo, hi)
    if rc != 0:
        raise RuntimeError(f"fnn_nonair_bbox_i16 returned {rc} for "
                           f"{vol.shape}")
    return [int(x) for x in lo], [int(x) for x in hi]


def nearest_revert_u8(seg: np.ndarray, out_shape: Sequence[int],
                      out: Optional[np.ndarray] = None) -> np.ndarray:
    """uint8 (d, h, w) -> out_shape with jax.image.resize(method="nearest")'s
    index map (floor((i + 0.5) * in / out) in float32)."""
    if seg.dtype != np.uint8 or seg.ndim != 3:
        raise ValueError(f"expected a 3-D uint8 mask, got {seg.dtype} "
                         f"{seg.shape}")
    seg = np.ascontiguousarray(seg)
    out = _out_array(out, out_shape, np.uint8)
    rc = library().fnn_nearest_revert_u8(
        seg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _shape3(seg.shape), _shape3(out_shape),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"fnn_nearest_revert_u8 returned {rc} for "
                           f"{seg.shape} -> {tuple(out_shape)}")
    return out
