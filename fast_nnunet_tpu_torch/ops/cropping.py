"""Crop-to-nonzero: the part of fast_nnunet_tpu/ops/cropping.py that the
preprocessor uses, copied (numpy/scipy)."""
from typing import List, Tuple

import numpy as np
from scipy.ndimage import binary_fill_holes


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    """(c, x, y, z) or (c, x, y) -> bool mask, OR over channels, holes
    filled."""
    assert data.ndim in (3, 4), "data must have shape (C, X, Y, Z) or (C, X, Y)"
    return binary_fill_holes((data != 0).any(axis=0))


def get_bbox_from_mask(mask: np.ndarray) -> List[List[int]]:
    """Per-axis [min, max) bounding box of True voxels."""
    axes = list(range(mask.ndim))
    bbox = []
    for ax in axes:
        other = tuple(a for a in axes if a != ax)
        nz = np.where(mask.any(axis=other))[0]
        if len(nz) == 0:
            bbox.append([0, mask.shape[ax]])
        else:
            bbox.append([int(nz[0]), int(nz[-1]) + 1])
    return bbox


def bounding_box_to_slice(bbox: List[List[int]]) -> Tuple[slice, ...]:
    return tuple(slice(b[0], b[1]) for b in bbox)


def crop_to_nonzero(data: np.ndarray, seg: np.ndarray = None,
                    nonzero_label: int = -1):
    """Crop data (c,x,y,z) to its nonzero bbox; voxels outside the nonzero
    mask are labeled ``nonzero_label`` in seg. Returns (data, seg, bbox)."""
    nonzero_mask = create_nonzero_mask(data)
    bbox = get_bbox_from_mask(nonzero_mask)
    sl = bounding_box_to_slice(bbox)
    nonzero_mask = nonzero_mask[sl][None]
    slicer = (slice(None),) + sl
    data = data[slicer]
    if seg is not None:
        seg = seg[slicer]
        seg[(seg == 0) & (~nonzero_mask)] = nonzero_label
    else:
        seg = np.where(nonzero_mask, np.int8(0), np.int8(nonzero_label))
    return data, seg, bbox
