"""Intensity normalization schemes, copied from
fast_nnunet_tpu/ops/normalization.py (host-side numpy, once per case)."""
from typing import Optional, Type

import numpy as np


class ImageNormalization:
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true: \
        Optional[bool] = None

    def __init__(self, use_mask_for_norm: bool = None,
                 intensityproperties: dict = None, target_dtype=np.float32):
        assert use_mask_for_norm is None or isinstance(use_mask_for_norm, bool)
        self.use_mask_for_norm = use_mask_for_norm
        assert intensityproperties is None or \
            isinstance(intensityproperties, dict)
        self.intensityproperties = intensityproperties \
            if intensityproperties is not None else {}
        self.target_dtype = target_dtype

    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        """seg carries -1 outside the nonzero-crop mask; schemes may use
        seg >= 0 as the normalization mask."""
        raise NotImplementedError


class ZScoreNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = True

    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        image = image.astype(self.target_dtype, copy=True)
        if self.use_mask_for_norm:
            mask = seg >= 0
            mean = image[mask].mean()
            std = image[mask].std()
            image[mask] = (image[mask] - mean) / (max(std, 1e-8))
        else:
            mean = image.mean()
            std = image.std()
            image = (image - mean) / (max(std, 1e-8))
        return image


class CTNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        assert self.intensityproperties, \
            "CTNormalization requires foreground intensity properties"
        props = self.intensityproperties
        image = image.astype(self.target_dtype, copy=True)
        np.clip(image, props["percentile_00_5"], props["percentile_99_5"],
                out=image)
        image -= props["mean"]
        image /= max(props["std"], 1e-8)
        return image


class NoNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        return image.astype(self.target_dtype, copy=False)


class RescaleTo01Normalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        image = image.astype(self.target_dtype, copy=True)
        image -= image.min()
        image /= np.clip(image.max(), a_min=1e-8, a_max=None)
        return image


class RGBTo01Normalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        assert image.min() >= 0 and image.max() <= 255, \
            "RGB images must be uint8-ranged [0, 255]"
        return (image / 255.0).astype(self.target_dtype)


_SCHEMES_BY_NAME = {cls.__name__: cls for cls in (
    ZScoreNormalization, CTNormalization, NoNormalization,
    RescaleTo01Normalization, RGBTo01Normalization)}


def get_normalization_scheme_by_class_name(name: str
                                           ) -> Type[ImageNormalization]:
    return _SCHEMES_BY_NAME[name]
