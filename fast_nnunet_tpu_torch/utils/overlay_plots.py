"""QC overlay plots: an image slice with the segmentation overlaid in
colour, as PNGs — a copy of fast_nnunet_tpu/utils/overlay_plots.py. PIL is
imported only where a PNG is written."""
import os

import numpy as np

COLOR_CYCLE = np.array([
    [0, 0, 0], [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
    [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128],
], dtype=np.float32)


def select_slice(seg: np.ndarray, axis: int = 0) -> int:
    """Slice with the most foreground."""
    fg = (seg > 0).sum(axis=tuple(a for a in range(seg.ndim) if a != axis))
    return int(np.argmax(fg))


def generate_overlay(image_2d: np.ndarray, seg_2d: np.ndarray,
                     overlay_intensity: float = 0.6) -> np.ndarray:
    img = image_2d.astype(np.float32)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-8) * 255
    rgb = np.stack([img] * 3, -1)
    for c in np.unique(seg_2d):
        if c == 0:
            continue
        color = COLOR_CYCLE[int(c) % len(COLOR_CYCLE)]
        mask = seg_2d == c
        rgb[mask] = (1 - overlay_intensity) * rgb[mask] + \
            overlay_intensity * color
    return rgb.astype(np.uint8)


def plot_overlay(image_file: str, seg_file: str, image_reader_writer,
                 output_file: str, overlay_intensity: float = 0.6) -> None:
    from PIL import Image
    img, _ = image_reader_writer.read_images([image_file])
    seg, _ = image_reader_writer.read_seg(seg_file)
    img, seg = img[0], seg[0]
    sl = select_slice(seg)
    rgb = generate_overlay(img[sl], seg[sl], overlay_intensity)
    Image.fromarray(rgb).save(output_file)


def generate_overlays_for_folder(images_folder: str, segs_folder: str,
                                 output_folder: str, image_reader_writer,
                                 file_ending: str, num_channels: int = 1,
                                 overlay_intensity: float = 0.6) -> None:
    from ..utils.io import maybe_mkdir_p, subfiles, join
    maybe_mkdir_p(output_folder)
    for f in subfiles(segs_folder, suffix=file_ending, join_path=False):
        ident = f[: -len(file_ending)]
        image_file = join(images_folder, f"{ident}_0000{file_ending}")
        if not os.path.isfile(image_file):
            continue
        plot_overlay(image_file, join(segs_folder, f), image_reader_writer,
                     join(output_folder, ident + ".png"), overlay_intensity)
