"""Host-side numpy data augmentation — a copy of
fast_nnunet_tpu/training/augment.py (numpy/scipy), so that one
``np.random.RandomState`` gives the same batch in both packages, bit for bit.

The reference's default batchgeneratorsv2 training pipeline: spatial
(rotation/scale), gaussian noise/blur, brightness, contrast, simulate
low-res, gamma (inverted + plain), mirroring, mask-for-norm zeroing, -1
label removal, region conversion and deep-supervision target downsampling,
plus the initial-patch-size math. Runs in dataloader workers on the host;
per sample, channels-first (C, *spatial) like the on-disk layout, which is
also the port's NCDHW device layout. DA5 is in training/augment_da5.py.
"""
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import affine_transform, gaussian_filter

from ..ops.resampling import skimage_resize


# --------------------------------------------------------------- geometry utils
def _rot_x(a):
    return np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)],
                     [0, math.sin(a), math.cos(a)]])


def _rot_y(a):
    return np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                     [-math.sin(a), 0, math.cos(a)]])


def _rot_z(a):
    return np.array([[math.cos(a), -math.sin(a), 0],
                     [math.sin(a), math.cos(a), 0], [0, 0, 1]])


def rotate_coords_3d(coords, ax, ay, az):
    R = _rot_x(ax) @ _rot_y(ay) @ _rot_z(az)
    return R @ np.asarray(coords, dtype=float)


def rotate_coords_2d(coords, a):
    R = np.array([[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]])
    return R @ np.asarray(coords, dtype=float)


def get_patch_size(final_patch_size, rot_x, rot_y, rot_z, scale_range) -> np.ndarray:
    """Enlarged sampling patch so rotation+zoom never read outside the crop."""
    if isinstance(rot_x, (tuple, list)):
        rot_x = max(np.abs(rot_x))
    if isinstance(rot_y, (tuple, list)):
        rot_y = max(np.abs(rot_y))
    if isinstance(rot_z, (tuple, list)):
        rot_z = max(np.abs(rot_z))
    rot_x, rot_y, rot_z = [min(math.pi / 2, r) for r in (rot_x, rot_y, rot_z)]
    coords = np.array(final_patch_size)
    final_shape = np.copy(coords).astype(float)
    if len(coords) == 3:
        final_shape = np.max(np.vstack(
            (np.abs(rotate_coords_3d(coords, rot_x, 0, 0)), final_shape)), 0)
        final_shape = np.max(np.vstack(
            (np.abs(rotate_coords_3d(coords, 0, rot_y, 0)), final_shape)), 0)
        final_shape = np.max(np.vstack(
            (np.abs(rotate_coords_3d(coords, 0, 0, rot_z)), final_shape)), 0)
    elif len(coords) == 2:
        final_shape = np.max(np.vstack(
            (np.abs(rotate_coords_2d(coords, rot_x)), final_shape)), 0)
    final_shape /= min(scale_range)
    return final_shape.astype(int)


def configure_rotation_dummyDA_mirroring_and_initial_patch_size(patch_size):
    """(rotation_for_DA, do_dummy_2d, initial_patch_size, mirror_axes) — ref
    nnUNetTrainer.py:427-468."""
    from ..configuration import ANISO_THRESHOLD
    dim = len(patch_size)
    if dim == 2:
        do_dummy_2d = False
        if max(patch_size) / min(patch_size) > 1.5:
            rotation = (-15 / 360 * 2 * math.pi, 15 / 360 * 2 * math.pi)
        else:
            rotation = (-math.pi, math.pi)
        mirror_axes = (0, 1)
    elif dim == 3:
        do_dummy_2d = (max(patch_size) / patch_size[0]) > ANISO_THRESHOLD
        if do_dummy_2d:
            rotation = (-math.pi, math.pi)
        else:
            rotation = (-30 / 360 * 2 * math.pi, 30 / 360 * 2 * math.pi)
        mirror_axes = (0, 1, 2)
    else:
        raise RuntimeError(f"unsupported dim {dim}")
    initial_patch_size = get_patch_size(patch_size[-dim:], rotation, rotation,
                                        rotation, (0.85, 1.25))
    if do_dummy_2d:
        initial_patch_size[0] = patch_size[0]
    return rotation, do_dummy_2d, initial_patch_size, mirror_axes


# --------------------------------------------------------------- single transforms
def spatial_augment(data: np.ndarray, seg: np.ndarray, final_patch_size,
                    rotation_range, rng: np.random.RandomState,
                    p_rotation: float = 0.2, p_scaling: float = 0.2,
                    scale_range=(0.7, 1.4), dummy_2d: bool = False,
                    data_order: int = 1):
    """Random rotation + isotropic zoom about the patch center, then center-crop
    to final_patch_size. Data: linear interp; seg: nearest."""
    dim = len(final_patch_size)
    do_rot = rng.uniform() < p_rotation
    do_scale = rng.uniform() < p_scaling
    if not do_rot and not do_scale:
        return (_center_crop(data, final_patch_size),
                _center_crop(seg, final_patch_size))

    scale = rng.uniform(*scale_range) if do_scale else 1.0
    if dim == 3:
        if dummy_2d:
            # in-plane rotation only (axes 1, 2); the anisotropic axis 0 is
            # never rotated through
            angle = rng.uniform(*rotation_range) if do_rot else 0.0
            rot = np.eye(3)
            c, s = math.cos(angle), math.sin(angle)
            rot[1, 1], rot[1, 2], rot[2, 1], rot[2, 2] = c, -s, s, c
        else:
            ax, ay, az = (rng.uniform(*rotation_range) if do_rot else 0.0
                          for _ in range(3))
            rot = _rot_x(ax) @ _rot_y(ay) @ _rot_z(az)
    else:
        angle = rng.uniform(*rotation_range) if do_rot else 0.0
        c, s = math.cos(angle), math.sin(angle)
        rot = np.array([[c, -s], [s, c]])

    # output->input mapping: x_in = M @ (x_out - c_out) + c_in; zoom out = /scale
    M = rot / scale
    in_center = (np.array(data.shape[1:]) - 1) / 2
    out_center = (np.array(final_patch_size) - 1) / 2
    offset = in_center - M @ out_center

    out_data = np.empty((data.shape[0], *final_patch_size), dtype=data.dtype)
    for c_ in range(data.shape[0]):
        out_data[c_] = affine_transform(data[c_], M, offset=offset,
                                        output_shape=tuple(final_patch_size),
                                        order=data_order, mode="constant",
                                        cval=0.0)
    out_seg = np.empty((seg.shape[0], *final_patch_size), dtype=seg.dtype)
    for c_ in range(seg.shape[0]):
        out_seg[c_] = affine_transform(seg[c_], M, offset=offset,
                                       output_shape=tuple(final_patch_size),
                                       order=0, mode="constant", cval=-1)
    return out_data, out_seg


def _center_crop(arr: np.ndarray, target_shape) -> np.ndarray:
    slices = [slice(None)]
    for cur, tgt in zip(arr.shape[1:], target_shape):
        lo = (cur - tgt) // 2
        slices.append(slice(lo, lo + tgt))
    return np.ascontiguousarray(arr[tuple(slices)])


def gaussian_noise(data, rng, p: float = 0.1, noise_variance=(0, 0.1)):
    if rng.uniform() < p:
        var = rng.uniform(*noise_variance)
        data = data + rng.normal(0, math.sqrt(var), data.shape).astype(data.dtype)
    return data


def gaussian_blur(data, rng, p: float = 0.2, sigma_range=(0.5, 1.0),
                  p_per_channel: float = 0.5):
    if rng.uniform() < p:
        for c in range(data.shape[0]):
            if rng.uniform() < p_per_channel:
                data[c] = gaussian_filter(data[c], rng.uniform(*sigma_range))
    return data


def multiplicative_brightness(data, rng, p: float = 0.15, rng_range=(0.75, 1.25)):
    if rng.uniform() < p:
        data = data * rng.uniform(*rng_range)
    return data


def contrast_augment(data, rng, p: float = 0.15, rng_range=(0.75, 1.25),
                     preserve_range: bool = True):
    if rng.uniform() < p:
        factor = rng.uniform(*rng_range)
        for c in range(data.shape[0]):
            mean = data[c].mean()
            if preserve_range:
                mn, mx = data[c].min(), data[c].max()
            data[c] = (data[c] - mean) * factor + mean
            if preserve_range:
                np.clip(data[c], mn, mx, out=data[c])
    return data


def simulate_low_resolution(data, rng, p: float = 0.25, scale_range=(0.5, 1.0),
                            p_per_channel: float = 0.5):
    if rng.uniform() < p:
        for c in range(data.shape[0]):
            if rng.uniform() < p_per_channel:
                scale = rng.uniform(*scale_range)
                shp = data[c].shape
                small = [max(1, int(round(s * scale))) for s in shp]
                down = skimage_resize(data[c], small, order=0, clip=False)
                data[c] = skimage_resize(down, shp, order=1, clip=False
                                         ).astype(data.dtype)
    return data


def gamma_augment(data, rng, p: float = 0.3, gamma_range=(0.7, 1.5),
                  invert_image: bool = False, retain_stats: bool = True,
                  p_invert_image: float = 0.0):
    if rng.uniform() >= p:
        return data
    for c in range(data.shape[0]):
        img = data[c]
        invert = invert_image
        if invert:
            img = -img
        if retain_stats:
            mean, sd = img.mean(), img.std()
        if rng.uniform() < 0.5 and gamma_range[0] < 1:
            gamma = rng.uniform(gamma_range[0], 1)
        else:
            gamma = rng.uniform(max(gamma_range[0], 1), gamma_range[1])
        mn, rng_ = img.min(), img.max() - img.min()
        img = np.power((img - mn) / max(rng_, 1e-7), gamma) * max(rng_, 1e-7) + mn
        if retain_stats:
            img = (img - img.mean()) / max(img.std(), 1e-8) * max(sd, 1e-8) + mean
        data[c] = -img if invert else img
    return data


def mirror_augment(data, seg, rng, allowed_axes: Tuple[int, ...]):
    for ax in allowed_axes:
        if rng.uniform() < 0.5:
            data = np.flip(data, ax + 1)
            seg = np.flip(seg, ax + 1)
    return np.ascontiguousarray(data), np.ascontiguousarray(seg)


def mask_image(data, seg, use_mask_for_norm: Sequence[bool]):
    """Zero data outside the nonzero-crop mask (seg == -1) for channels that were
    masked-normalized (ref MaskImageTransform)."""
    mask = seg[0] < 0
    for c, use in enumerate(use_mask_for_norm):
        if use:
            data[c][mask] = 0
    return data


def downsample_seg_for_ds(seg: np.ndarray, ds_scales: List[Tuple[float, ...]]
                          ) -> List[np.ndarray]:
    """seg (C, *S) -> list of nearest-downsampled segs per deep-supervision scale
    (ref DownsampleSegForDSTransform)."""
    out = []
    for scale in ds_scales:
        if all(s == 1 for s in scale):
            out.append(seg.copy())
        else:
            new_shape = [max(1, int(round(sh * sc)))
                         for sh, sc in zip(seg.shape[1:], scale)]
            lvl = np.empty((seg.shape[0], *new_shape), dtype=seg.dtype)
            for c in range(seg.shape[0]):
                lvl[c] = _nearest_resize(seg[c], new_shape)
            out.append(lvl)
    return out


def _nearest_resize(arr: np.ndarray, new_shape) -> np.ndarray:
    idx = tuple(np.round(np.linspace(0, s - 1, n)).astype(int)
                for s, n in zip(arr.shape, new_shape))
    return arr[np.ix_(*idx)]


def convert_labels_to_regions(seg: np.ndarray, regions,
                              ignore_label: Optional[int] = None) -> np.ndarray:
    """(1, *S) labelmap -> (R[+1], *S) one-hot region maps; with ignore the last
    channel is the ignore mask (ref ConvertSegmentationToRegionsTransform)."""
    s = seg[0]
    chans = []
    for region in regions:
        members = region if isinstance(region, (tuple, list)) else [region]
        m = np.zeros(s.shape, dtype=np.uint8)
        for lbl in members:
            m |= (s == lbl).astype(np.uint8)
        chans.append(m)
    if ignore_label is not None:
        chans.append((s == ignore_label).astype(np.uint8))
    return np.stack(chans)


# --------------------------------------------------------------- pipeline
class TrainingAugmenter:
    """The default nnU-Net training pipeline as one per-sample callable (the
    cascade's previous-stage channels are not ported)."""

    def __init__(self, patch_size, rotation_range, mirror_axes,
                 use_mask_for_norm=None, dummy_2d: bool = False,
                 regions=None, ignore_label: Optional[int] = None,
                 ds_scales: Optional[List[Tuple[float, ...]]] = None,
                 spatial_data_order: int = 1):
        self.spatial_data_order = spatial_data_order
        self.patch_size = tuple(patch_size)
        self.rotation_range = rotation_range
        self.mirror_axes = tuple(mirror_axes) if mirror_axes is not None else ()
        self.use_mask_for_norm = use_mask_for_norm
        self.dummy_2d = dummy_2d
        self.regions = regions
        self.ignore_label = ignore_label
        self.ds_scales = ds_scales

    def __call__(self, data: np.ndarray, seg: np.ndarray, rng: np.random.RandomState):
        data = np.ascontiguousarray(data, dtype=np.float32)
        seg = np.ascontiguousarray(seg)
        data, seg = spatial_augment(data, seg, self.patch_size,
                                    self.rotation_range, rng,
                                    dummy_2d=self.dummy_2d,
                                    data_order=self.spatial_data_order)
        data = gaussian_noise(data, rng)
        data = gaussian_blur(data, rng)
        data = multiplicative_brightness(data, rng)
        data = contrast_augment(data, rng)
        data = simulate_low_resolution(data, rng)
        data = gamma_augment(data, rng, p=0.1, invert_image=True)
        data = gamma_augment(data, rng, p=0.3, invert_image=False)
        if self.mirror_axes:
            data, seg = mirror_augment(data, seg, rng, self.mirror_axes)
        if self.use_mask_for_norm is not None and any(self.use_mask_for_norm):
            data = mask_image(data, seg, self.use_mask_for_norm)
        seg = seg.copy()
        seg[seg == -1] = 0  # RemoveLabelTransform
        if self.regions is not None:
            seg = convert_labels_to_regions(seg, self.regions, self.ignore_label)
        targets = downsample_seg_for_ds(seg, self.ds_scales) \
            if self.ds_scales is not None else [seg]
        return data, targets


class ValidationAugmenter:
    """Center crop + -1 removal + region conversion + DS downsampling only."""

    def __init__(self, patch_size, regions=None, ignore_label=None, ds_scales=None):
        self.patch_size = tuple(patch_size)
        self.regions = regions
        self.ignore_label = ignore_label
        self.ds_scales = ds_scales

    def __call__(self, data, seg, rng):
        data = _center_crop(np.asarray(data, dtype=np.float32), self.patch_size)
        seg = _center_crop(np.asarray(seg), self.patch_size)
        seg = seg.copy()
        seg[seg == -1] = 0
        if self.regions is not None:
            seg = convert_labels_to_regions(seg, self.regions, self.ignore_label)
        targets = downsample_seg_for_ds(seg, self.ds_scales) \
            if self.ds_scales is not None else [seg]
        return data, targets
