"""Spacing resampling on the host (numpy/scipy), copied from
fast_nnunet_tpu/ops/resampling.py: skimage's ``resize(order, mode='edge',
anti_aliasing=False)`` as ``scipy.ndimage.zoom(..., mode='nearest',
grid_mode=True)`` plus clipping, the separate-z path for anisotropic
spacings, and the plans' name -> function resolution."""
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import map_coordinates, zoom

from ..configuration import ANISO_THRESHOLD


def get_do_separate_z(spacing, anisotropy_threshold=ANISO_THRESHOLD) -> bool:
    return (np.max(spacing) / np.min(spacing)) > anisotropy_threshold


def get_lowres_axis(new_spacing) -> np.ndarray:
    return np.where(max(new_spacing) / np.array(new_spacing) == 1)[0]


def compute_new_shape(old_shape: Sequence[int], old_spacing: Sequence[float],
                      new_spacing: Sequence[float]) -> np.ndarray:
    assert len(old_spacing) == len(old_shape) == len(new_spacing)
    return np.array([int(round(i / j * k)) for i, j, k in
                     zip(old_spacing, new_spacing, old_shape)])


def determine_do_sep_z_and_axis(force_separate_z: Optional[bool],
                                current_spacing, new_spacing,
                                separate_z_anisotropy_threshold: float =
                                ANISO_THRESHOLD
                                ) -> Tuple[bool, Optional[int]]:
    if force_separate_z is not None:
        do_separate_z = force_separate_z
        axis = get_lowres_axis(current_spacing) if force_separate_z else None
    elif get_do_separate_z(current_spacing, separate_z_anisotropy_threshold):
        do_separate_z, axis = True, get_lowres_axis(current_spacing)
    elif get_do_separate_z(new_spacing, separate_z_anisotropy_threshold):
        do_separate_z, axis = True, get_lowres_axis(new_spacing)
    else:
        do_separate_z, axis = False, None
    if axis is not None:
        if len(axis) >= 2:  # 2+ axes tied for most anisotropic
            do_separate_z, axis = False, None
        else:
            axis = int(axis[0])
    return do_separate_z, axis


def skimage_resize(image: np.ndarray, output_shape: Sequence[int],
                   order: int, clip: bool = True) -> np.ndarray:
    """skimage.transform.resize(image, shape, order, mode='edge',
    anti_aliasing=False, clip=True) on scipy only."""
    output_shape = tuple(int(s) for s in output_shape)
    if tuple(image.shape) == output_shape:
        return image.astype(float, copy=False)
    img = image.astype(float, copy=False)
    zoom_factors = [o / i for o, i in zip(output_shape, img.shape)]
    out = zoom(img, zoom_factors, order=order, mode="nearest", grid_mode=True)
    if out.shape != output_shape:
        # ndi.zoom's output-shape rounding: map pixel centers explicitly
        coords = np.meshgrid(*[(np.arange(o) + 0.5) * (i / o) - 0.5
                               for o, i in zip(output_shape, img.shape)],
                             indexing="ij")
        out = map_coordinates(img, np.array(coords), order=order,
                              mode="nearest")
    if clip and order > 0:
        out = np.clip(out, img.min(), img.max())
    return out


def resize_segmentation(segmentation: np.ndarray, new_shape: Sequence[int],
                        order: int = 3) -> np.ndarray:
    """Label-safe resize: per-label soft resize + 0.5 threshold."""
    tpe = segmentation.dtype
    if order == 0:
        return skimage_resize(segmentation.astype(float), new_shape,
                              order).astype(tpe)
    reshaped = np.zeros(tuple(int(s) for s in new_shape), dtype=tpe)
    for c in np.unique(segmentation):
        mask = (segmentation == c).astype(float)
        reshaped[skimage_resize(mask, new_shape, order) >= 0.5] = c
    return reshaped


def _pixel_center_grid(old_shape, new_shape) -> np.ndarray:
    """(ndim, *new_shape) map of output pixel centers into input index space
    (align_corners=False)."""
    axes = [(o / n) * (np.arange(n, dtype=float) + 0.5) - 0.5
            for o, n in zip(old_shape, new_shape)]
    return np.stack(np.meshgrid(*axes, indexing="ij"))


def resample_data_or_seg(data: np.ndarray, new_shape: Sequence[int],
                         is_seg: bool = False, axis: Optional[int] = None,
                         order: int = 3, do_separate_z: bool = False,
                         order_z: int = 0, dtype_out=None) -> np.ndarray:
    """(c, x, y, z) resampling; with do_separate_z the anisotropic axis is
    resampled separately with order_z. Several channels resample in
    threads, one channel each."""
    assert data.ndim == 4, "data must be (c, x, y, z)"
    assert len(new_shape) == data.ndim - 1
    shape = np.array(data[0].shape)
    new_shape = np.array([int(s) for s in new_shape])
    if dtype_out is None:
        dtype_out = data.dtype
    if not np.any(shape != new_shape):
        return data
    reshaped_final = np.zeros((data.shape[0], *new_shape), dtype=dtype_out)
    data = data.astype(float, copy=False)

    def _resize(arr, target_shape):
        if is_seg:
            return resize_segmentation(arr, target_shape, order)
        return skimage_resize(arr, target_shape, order)

    if do_separate_z:
        assert axis is not None, "do_separate_z requires the anisotropic axis"
        plane_shape = np.delete(new_shape, axis)

    def resample_channel(c):
        if not do_separate_z:
            reshaped_final[c] = _resize(data[c], new_shape)
            return
        planes = [_resize(plane, plane_shape)
                  for plane in np.moveaxis(data[c], axis, 0)]
        stacked = np.moveaxis(np.stack(planes), 0, axis)
        if shape[axis] == new_shape[axis]:
            reshaped_final[c] = stacked
            return
        grid = _pixel_center_grid(stacked.shape, new_shape)
        if not is_seg or order_z == 0:
            reshaped_final[c] = map_coordinates(stacked, grid, order=order_z,
                                                mode="nearest")
            return
        for lbl in np.sort(np.unique(stacked)):
            on = map_coordinates((stacked == lbl).astype(float), grid,
                                 order=order_z, mode="nearest")
            reshaped_final[c][np.round(on) > 0.5] = lbl

    # channels are independent and scipy's zoom releases the GIL: a
    # prediction's many classes resample in threads, with the same result
    channels = range(data.shape[0])
    n_threads = min(len(channels), len(os.sched_getaffinity(0)))
    if n_threads > 1:
        with ThreadPoolExecutor(n_threads) as pool:
            list(pool.map(resample_channel, channels))
    else:
        for c in channels:
            resample_channel(c)
    return reshaped_final


def resample_data_or_seg_to_shape(data: np.ndarray, new_shape,
                                  current_spacing, new_spacing,
                                  is_seg: bool = False, order: int = 3,
                                  order_z: int = 0,
                                  force_separate_z: Optional[bool] = False,
                                  separate_z_anisotropy_threshold: float =
                                  ANISO_THRESHOLD):
    do_separate_z, axis = determine_do_sep_z_and_axis(
        force_separate_z, current_spacing, new_spacing,
        separate_z_anisotropy_threshold)
    assert data.ndim == 4, "data must be c x y z"
    return resample_data_or_seg(data, new_shape, is_seg, axis, order,
                                do_separate_z, order_z=order_z)


def no_resampling_data_or_seg_to_shape(data: np.ndarray, new_shape,
                                       current_spacing, new_spacing,
                                       **kwargs):
    assert tuple(data.shape[1:]) == tuple(int(s) for s in new_shape), \
        "no_resampling requires shapes to already match"
    return data


_RESAMPLING_FNS = {
    "resample_data_or_seg_to_shape": resample_data_or_seg_to_shape,
    "no_resampling_data_or_seg_to_shape": no_resampling_data_or_seg_to_shape,
    # the reference's torch variants share the pixel-center convention
    "resample_torch_simple": resample_data_or_seg_to_shape,
    "resample_torch_fornnunet": resample_data_or_seg_to_shape,
}


def resolve_resampling_fn(name: str, kwargs: dict):
    """Plans name a resampling function; returns callable(data, new_shape,
    current_spacing, new_spacing) with the plans' kwargs bound."""
    if name not in _RESAMPLING_FNS:
        raise KeyError(f"Unknown resampling fn '{name}'. Known: "
                       f"{list(_RESAMPLING_FNS)}")
    fn = _RESAMPLING_FNS[name]

    def bound(data, new_shape, current_spacing, new_spacing):
        return fn(data, new_shape, current_spacing, new_spacing, **kwargs)

    return bound
