"""Patch extraction for the training sampler — a copy of
fast_nnunet_tpu/ops/pad.py ``crop_and_pad_nd`` (acvl_utils semantics)."""
from typing import List

import numpy as np


def crop_and_pad_nd(image: np.ndarray, bbox: List[List[int]],
                    pad_value=0) -> np.ndarray:
    """Extract ``bbox`` (which may exceed the image) from the trailing axes
    of ``image``, filling the out-of-bounds part with ``pad_value``."""
    n_lead = image.ndim - len(bbox)
    out_shape = list(image.shape[:n_lead]) + [b[1] - b[0] for b in bbox]
    out = np.full(out_shape, pad_value, dtype=image.dtype)

    img_slices, out_slices = [], []
    for ax, (lo, hi) in enumerate(bbox):
        size = image.shape[n_lead + ax]
        img_lo, img_hi = max(lo, 0), min(hi, size)
        if img_lo >= img_hi:
            return out  # bbox entirely outside
        img_slices.append(slice(img_lo, img_hi))
        out_slices.append(slice(img_lo - lo, img_hi - lo))
    full_img = (slice(None),) * n_lead + tuple(img_slices)
    full_out = (slice(None),) * n_lead + tuple(out_slices)
    out[full_out] = image[full_img]
    return out
