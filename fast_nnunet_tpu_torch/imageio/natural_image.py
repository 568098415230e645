"""2D natural images (png, bmp, jpg) through PIL — a copy of
fast_nnunet_tpu/imageio/natural_image.py (the reference's
NaturalImage2DIO): each channel file is 2D, or RGB(A) for 3-4 channels;
arrays come back (C, 1, X, Y) with spacing (999, 1, 1), so the planner
treats the data as 2D. PIL is imported in the functions that use it."""
from typing import Sequence, Tuple

import numpy as np

from .nifti import _check_all_same


def pil_image():
    """PIL's ``Image`` module, or a ``RuntimeError`` naming the package."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("reading or writing TIFF, PNG, BMP or JPEG files "
                           "needs the 'Pillow' package (PIL)") from e
    return Image


class NaturalImage2DIO:
    supported_file_endings = [".png", ".bmp", ".tif", ".jpg", ".jpeg"]

    def read_images(self, image_fnames: Sequence[str]) -> Tuple[np.ndarray, dict]:
        Image = pil_image()
        images = []
        for f in image_fnames:
            arr = np.asarray(Image.open(f))
            if arr.ndim == 3:  # RGB(A): channels first
                images.extend(arr[..., c] for c in range(arr.shape[-1]))
            else:
                images.append(arr)
        if not _check_all_same([i.shape for i in images]):
            raise RuntimeError(f"Inconsistent shapes: {[i.shape for i in images]}")
        data = np.stack(images)[:, None].astype(np.float32)  # (C, 1, X, Y)
        return data, {"spacing": (999.0, 1.0, 1.0)}

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        Image = pil_image()
        seg = np.asarray(seg)
        if seg.ndim == 3:
            assert seg.shape[0] == 1
            seg = seg[0]
        Image.fromarray(seg.astype(np.uint8)).save(output_fname)
