"""Sliding-window tiling math (a numpy-only copy of
fast_nnunet_tpu/ops/sliding_window.py; the port imports nothing of the JAX
package).

Parity: distillation/nnunetv2/inference/sliding_window_prediction.py:10-54.
The gaussian map and step grid are computed host-side once per (patch, image)
shape pair and fed to the jitted accumulation engine as constants.
"""
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter


@lru_cache(maxsize=8)
def compute_gaussian(tile_size: Tuple[int, ...], sigma_scale: float = 1.0 / 8,
                     value_scaling_factor: float = 1.0,
                     dtype=np.float32) -> np.ndarray:
    """Gaussian importance map: unit impulse at the tile center filtered with
    sigma = tile_size * sigma_scale, normalized so max == value_scaling_factor,
    zeros clamped to the smallest positive value (avoids division by zero at the
    volume border)."""
    tmp = np.zeros(tile_size)
    center_coords = [i // 2 for i in tile_size]
    sigmas = [i * sigma_scale for i in tile_size]
    tmp[tuple(center_coords)] = 1
    gaussian_importance_map = gaussian_filter(tmp, sigmas, 0, mode="constant", cval=0)

    gaussian_importance_map = gaussian_importance_map / (
        gaussian_importance_map.max() / value_scaling_factor)
    gaussian_importance_map = gaussian_importance_map.astype(dtype)
    mask = gaussian_importance_map == 0
    gaussian_importance_map[mask] = gaussian_importance_map[~mask].min()
    return gaussian_importance_map


def compute_steps_for_sliding_window(image_size: Sequence[int], tile_size: Sequence[int],
                                     tile_step_size: float) -> List[List[int]]:
    """Per-axis tile start coordinates: steps of at most tile_size*step_size,
    evenly spread so the last tile ends exactly at the image border."""
    assert all(i >= j for i, j in zip(image_size, tile_size)), \
        "image size must be as large or larger than patch_size"
    assert 0 < tile_step_size <= 1, "step_size must be in (0, 1]"

    target_step_sizes_in_voxels = [i * tile_step_size for i in tile_size]
    num_steps = [int(np.ceil((i - k) / j)) + 1
                 for i, j, k in zip(image_size, target_step_sizes_in_voxels, tile_size)]

    steps = []
    for dim in range(len(tile_size)):
        max_step_value = image_size[dim] - tile_size[dim]
        if num_steps[dim] > 1:
            actual_step_size = max_step_value / (num_steps[dim] - 1)
        else:
            actual_step_size = 99999999999
        steps.append([int(np.round(actual_step_size * i)) for i in range(num_steps[dim])])
    return steps


def tile_coords_from_steps(steps: List[List[int]]) -> np.ndarray:
    """Cartesian product of per-axis steps -> (n_tiles, ndim) int32 array, ordered
    with the last axis fastest (same nesting order as the reference's slicer loop)."""
    grids = np.meshgrid(*steps, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1).astype(np.int32)
