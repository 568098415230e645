"""3D TIFF stacks through PIL's multipage support — a copy of
fast_nnunet_tpu/imageio/tiff.py (the reference's Tiff3DIO): a TIFF cannot
carry 3D spacing, so it sits in a sidecar ``<name>.json``
(``{"spacing": [sz, sy, sx]}``). PIL is imported in the functions that
use it."""
import json
import os
from typing import Sequence, Tuple

import numpy as np

from .natural_image import pil_image
from .nifti import _check_all_same


def _read_tiff_stack(fname: str) -> np.ndarray:
    Image = pil_image()
    img = Image.open(fname)
    frames = []
    try:
        i = 0
        while True:
            img.seek(i)
            frames.append(np.asarray(img))
            i += 1
    except EOFError:
        pass
    return np.stack(frames)  # (Z, Y, X)


def _write_tiff_stack(fname: str, volume: np.ndarray) -> None:
    Image = pil_image()
    frames = [Image.fromarray(volume[z]) for z in range(volume.shape[0])]
    frames[0].save(fname, save_all=True, append_images=frames[1:])


class Tiff3DIO:
    """(C, Z, Y, X) arrays; spacing from a sidecar ``<name>.json``
    ({"spacing": [sz, sy, sx]}) like the reference."""
    supported_file_endings = [".tif", ".tiff"]

    def read_images(self, image_fnames: Sequence[str]) -> Tuple[np.ndarray, dict]:
        images, spacings = [], []
        for f in image_fnames:
            images.append(_read_tiff_stack(f))
            sidecar = os.path.splitext(f)[0] + ".json"
            if os.path.isfile(sidecar):
                with open(sidecar) as fh:
                    spacings.append([float(s) for s in json.load(fh)["spacing"]])
            else:
                spacings.append([1.0, 1.0, 1.0])
        if not _check_all_same([i.shape for i in images]):
            raise RuntimeError(f"shape mismatch: {[i.shape for i in images]}")
        if not _check_all_same(spacings):
            raise RuntimeError(f"spacing mismatch: {spacings}")
        return np.stack(images).astype(np.float32), {"spacing": spacings[0]}

    def read_seg(self, seg_fname: str):
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict):
        _write_tiff_stack(output_fname, seg.astype(np.uint8))
        sidecar = os.path.splitext(output_fname)[0] + ".json"
        with open(sidecar, "w") as fh:
            json.dump({"spacing": list(properties["spacing"])}, fh)
