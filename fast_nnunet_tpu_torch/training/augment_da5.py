"""DA5 strong augmentation for small datasets — a copy of
fast_nnunet_tpu/training/augment_da5.py (numpy/scipy host work, the same
draws in the same order, so one ``np.random.RandomState`` gives the same
sample in both packages, bit for bit; a cascade stage's previous-stage
channels are moved into the data, one-hot and corrupted, as in the default
pipeline).

The reference builds its DA5 pipeline from 16 batchgenerators transforms in
a fixed order with per-transform probabilities (ref distillation/nnunetv2/
training/nnUNetTrainer/variants/data_augmentation/nnUNetTrainerDA5.py:
80-292). `DA5TrainingAugmenter` below replays that pipeline: same transform
families, same ORDER, same per-sample / per-channel probabilities, same
parameter ranges (scale (0.7, 1.43) with independent per-axis sampling,
rot90/transpose gated on matching patch axes, median filter (2, 8),
additive brightness N(0, 0.5), OneOf contrast pair, low-res zoom (0.25, 1)
with cubic upsampling, DOUBLE inverted gamma, blank rectangles
[p//10, p//3] x (1, 5), gaussian-bump brightness gradient and local gamma
with sigma ~ exp(U(log(size/6), log(size))), laplacian sharpening
(0.1, 1)). Randomness uses numpy draws in transform order, so sequences
are not bit-equal to batchgenerators' — per-voxel incidence and parameter
distributions are pinned statistically instead
(tests/test_augment_da5.py; the port is held bit for bit against the JAX
package by tests/test_torch_da5.py).

`DA5CondensedAugmenter` keeps the previous 6-family condensed
reinterpretation as a documented cheap variant (~40% less host time, same
spirit, NOT the pipeline the reference's +2-5% small-dataset robustness
claim was measured with — ref docs/Distillation.md:294-299).
"""
import math
from typing import Optional, Tuple

import numpy as np
from scipy.ndimage import affine_transform, laplace, median_filter

from ..ops.resampling import skimage_resize
from .augment import (TrainingAugmenter, contrast_augment,
                      convert_labels_to_regions, downsample_seg_for_ds,
                      gamma_augment, gaussian_blur, gaussian_noise,
                      get_patch_size, mask_image, mirror_augment,
                      move_prev_stage_to_data, multiplicative_brightness,
                      simulate_low_resolution, spatial_augment)


def _matching_axes(patch_size) -> Tuple[np.ndarray, list]:
    """Reference gating rule (ref nnUNetTrainerDA5.py:93-94): per-axis
    count of equal extents; rot90/transpose act on the axes sharing the
    maximal count and only exist when any count > 1."""
    patch_size = list(patch_size)
    matching = np.array([sum(i == j for j in patch_size)
                         for i in patch_size])
    valid = list(np.where(matching == matching.max())[0])
    return matching, valid


def _balanced_uniform(rng, lo: float, hi: float) -> float:
    """batchgenerators' half-below-1 / half-above-1 sampling used by its
    scale, contrast and gamma draws."""
    if rng.uniform() < 0.5 and lo < 1:
        return rng.uniform(lo, 1)
    return rng.uniform(max(lo, 1), hi)


# --------------------------------------------------------- spatial (DA5 flavor)
def spatial_augment_da5(data, seg, final_patch_size, rotation_range, rng,
                        dummy_2d: bool = False, order_data: int = 3,
                        order_seg: int = 1):
    """SpatialTransform with the DA5 parameterization (ref
    nnUNetTrainerDA5.py:107-131): p_rot_per_sample=0.4 with PER-AXIS gating
    p=0.5, p_scale_per_sample=0.2 with INDEPENDENT per-axis scale from
    (0.7, 1.43) (balanced below/above 1), cubic data interpolation,
    order-1 segmentation via per-label linear interpolation + argmax
    (batchgenerators' is_seg behavior), border -1 for seg."""
    dim = len(final_patch_size)
    do_rot = rng.uniform() < 0.4
    do_scale = rng.uniform() < 0.2
    if not do_rot and not do_scale:
        from .augment import _center_crop
        return (_center_crop(data, final_patch_size),
                _center_crop(seg, final_patch_size))

    def axis_angle():
        # p_rot_per_axis = 0.5 (ref :116)
        return rng.uniform(*rotation_range) if (do_rot and
                                                rng.uniform() <= 0.5) else 0.0

    from .augment import _rot_x, _rot_y, _rot_z
    if dim == 3:
        if dummy_2d:
            angle = rng.uniform(*rotation_range) if do_rot else 0.0
            rot = np.eye(3)
            c, s = math.cos(angle), math.sin(angle)
            rot[1, 1], rot[1, 2], rot[2, 1], rot[2, 2] = c, -s, s, c
        else:
            rot = _rot_x(axis_angle()) @ _rot_y(axis_angle()) @ _rot_z(
                axis_angle())
    else:
        angle = rng.uniform(*rotation_range) if do_rot else 0.0
        c, s = math.cos(angle), math.sin(angle)
        rot = np.array([[c, -s], [s, c]])

    # independent_scale_for_each_axis=True (ref :129): per-axis balanced
    if do_scale:
        scales = np.array([_balanced_uniform(rng, 0.7, 1.43)
                           for _ in range(dim)])
    else:
        scales = np.ones(dim)

    M = rot / scales[None, :]  # output->input: zoom out = divide
    in_center = (np.array(data.shape[1:]) - 1) / 2
    out_center = (np.array(final_patch_size) - 1) / 2
    offset = in_center - M @ out_center

    out_data = np.empty((data.shape[0], *final_patch_size), dtype=data.dtype)
    for c_ in range(data.shape[0]):
        out_data[c_] = affine_transform(
            data[c_], M, offset=offset, output_shape=tuple(final_patch_size),
            order=order_data, mode="constant", cval=0.0)
    out_seg = np.empty((seg.shape[0], *final_patch_size), dtype=seg.dtype)
    for c_ in range(seg.shape[0]):
        if order_seg == 0:
            out_seg[c_] = affine_transform(
                seg[c_], M, offset=offset,
                output_shape=tuple(final_patch_size), order=0,
                mode="constant", cval=-1)
        else:
            # batchgenerators is_seg: interpolate each label's indicator at
            # the given order, argmax — smooth label boundaries without
            # inventing intermediate label values (border region -> -1)
            labels = np.unique(seg[c_])
            stack = np.stack([affine_transform(
                (seg[c_] == lab).astype(np.float32), M, offset=offset,
                output_shape=tuple(final_patch_size), order=order_seg,
                mode="constant", cval=1.0 if lab == -1 else 0.0)
                for lab in labels])
            if -1 not in labels:
                # border support: track out-of-bounds weight explicitly
                inside = affine_transform(
                    np.ones_like(seg[c_], np.float32), M, offset=offset,
                    output_shape=tuple(final_patch_size), order=order_seg,
                    mode="constant", cval=0.0)
                stack = np.concatenate(
                    [(1.0 - inside)[None], stack])
                labels = np.concatenate([[-1], labels])
            out_seg[c_] = np.asarray(labels)[stack.argmax(0)]
    return out_data, out_seg


# ------------------------------------------------------------ geometric extras
def rot90_augment(data, seg, rng, valid_axes, p: float = 0.5):
    """Rot90Transform((0,1,2,3), axes=valid_axes, p_per_sample=0.5) (ref
    nnUNetTrainerDA5.py:136-141): k sampled from {0,1,2,3}, plane sampled
    from the equal-extent axes."""
    if rng.uniform() >= p or len(valid_axes) < 2:
        return data, seg
    a, b = rng.choice(valid_axes, size=2, replace=False)
    a, b = int(a), int(b)
    k = int(rng.choice([0, 1, 2, 3]))
    if k == 0:
        return data, seg
    data = np.rot90(data, k, axes=(a + 1, b + 1))
    seg = np.rot90(seg, k, axes=(a + 1, b + 1))
    return np.ascontiguousarray(data), np.ascontiguousarray(seg)


def transpose_axes_augment(data, seg, rng, valid_axes, p: float = 0.5):
    """TransposeAxesTransform(valid_axes, p_per_sample=0.5) (ref :143-146):
    random permutation of the equal-extent axes."""
    if rng.uniform() >= p or len(valid_axes) < 2:
        return data, seg
    perm = list(range(data.ndim - 1))
    shuffled = list(valid_axes)
    rng.shuffle(shuffled)
    for src, dst in zip(valid_axes, shuffled):
        perm[src] = dst
    order = [0] + [p_ + 1 for p_ in perm]
    return (np.ascontiguousarray(data.transpose(order)),
            np.ascontiguousarray(seg.transpose(order)))


# -------------------------------------------------------------- intensity extras
def median_filter_augment(data, rng, p: float = 0.2,
                          p_per_channel: float = 0.5,
                          filter_size=(2, 8)):
    """MedianFilterTransform((2, 8), same_for_each_channel=False,
    p_per_sample=0.2, p_per_channel=0.5) (ref :149-154)."""
    if rng.uniform() < p:
        for c in range(data.shape[0]):
            if rng.uniform() < p_per_channel:
                data[c] = median_filter(
                    data[c], size=int(rng.randint(*filter_size)))
    return data


def additive_brightness(data, rng, mu: float = 0.0, sigma: float = 0.5,
                        p: float = 0.1, p_per_channel: float = 0.5):
    """BrightnessTransform(0, 0.5, per_channel=True, p_per_sample=0.1,
    p_per_channel=0.5) (ref :163-169): per-channel additive N(mu, sigma)."""
    if rng.uniform() < p:
        for c in range(data.shape[0]):
            if rng.uniform() < p_per_channel:
                data[c] = data[c] + rng.normal(mu, sigma)
    return data


def contrast_augment_da5(data, rng, preserve_range: bool, p: float = 0.2,
                         p_per_channel: float = 0.5,
                         contrast_range=(0.5, 2.0)):
    """ContrastAugmentationTransform((0.5, 2), per_channel=True,
    p_per_channel=0.5) (ref :171-190): per-channel balanced factor,
    centered on the channel mean; preserve_range clips to the original
    min/max."""
    if rng.uniform() >= p:
        return data
    for c in range(data.shape[0]):
        if rng.uniform() >= p_per_channel:
            continue
        factor = _balanced_uniform(rng, *contrast_range)
        mean = data[c].mean()
        if preserve_range:
            mn, mx = data[c].min(), data[c].max()
        data[c] = (data[c] - mean) * factor + mean
        if preserve_range:
            np.clip(data[c], mn, mx, out=data[c])
    return data


def simulate_low_resolution_da5(data, rng, p: float = 0.15,
                                p_per_channel: float = 0.5,
                                zoom_range=(0.25, 1.0),
                                ignore_axes: Optional[Tuple[int, ...]] = None):
    """SimulateLowResolutionTransform(zoom (0.25, 1), per_channel,
    p_per_channel=0.5, order_down=0, order_up=3, ignore_axes) (ref
    :192-201): nearest downsample, CUBIC upsample; dummy-2d keeps the
    anisotropic axis untouched."""
    if rng.uniform() >= p:
        return data
    for c in range(data.shape[0]):
        if rng.uniform() >= p_per_channel:
            continue
        zoom = rng.uniform(*zoom_range)
        shp = data[c].shape
        small = [s if (ignore_axes and ax in ignore_axes)
                 else max(1, int(round(s * zoom)))
                 for ax, s in enumerate(shp)]
        down = skimage_resize(data[c], small, order=0, clip=False)
        data[c] = skimage_resize(down, shp, order=3, clip=False
                                 ).astype(data.dtype)
    return data


def blank_rectangles_augment(data, rng, patch_size, p: float = 0.4,
                             p_per_channel: float = 0.5,
                             num_rectangles=(1, 5)):
    """BlankRectangleTransform([[max(1, p//10), p//3] per axis],
    value=np.mean, num_rectangles=(1, 5), p_per_sample=0.4,
    p_per_channel=0.5) (ref :211-219): each rectangle is replaced by ITS
    OWN mean, per channel."""
    if rng.uniform() >= p:
        return data
    sizes = [(max(1, s // 10), max(2, s // 3)) for s in patch_size]
    for c in range(data.shape[0]):
        if rng.uniform() >= p_per_channel:
            continue
        for _ in range(rng.randint(num_rectangles[0], num_rectangles[1])):
            sl = []
            for (lo_s, hi_s), s in zip(sizes, data.shape[1:]):
                ext = int(rng.randint(lo_s, max(lo_s + 1, hi_s)))
                ext = min(ext, s)
                lo = rng.randint(0, max(1, s - ext))
                sl.append(slice(lo, lo + ext))
            sl = tuple(sl)
            data[(c,) + sl] = data[(c,) + sl].mean()
    return data


def _gaussian_bump(rng, spatial) -> np.ndarray:
    """Shared kernel of BrightnessGradientAdditive / LocalGamma (ref
    :221-242 + :677-686): per-axis center uniform in (-0.5, 1.5) x extent
    (may sit outside the patch), per-axis sigma
    exp(U(log(size // 6), log(size)))."""
    grids = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in spatial],
                        indexing="ij")
    k = np.zeros(spatial, np.float32)
    for ax, g in enumerate(grids):
        size = spatial[ax]
        loc = rng.uniform(-0.5, 1.5) * size
        scale = math.exp(rng.uniform(math.log(max(size // 6, 1)),
                                     math.log(size)))
        k += ((g - loc) / scale) ** 2
    return np.exp(-0.5 * k)


def brightness_gradient_additive(data, rng, p: float = 0.3,
                                 p_per_channel: float = 0.5):
    """BrightnessGradientAdditiveTransform (ref :221-231): add a gaussian
    bump scaled to max |strength|, strength = +-U(1, 5) (ref :681-682),
    NOT mean-centered, independent per channel."""
    if rng.uniform() >= p:
        return data
    for c in range(data.shape[0]):
        if rng.uniform() >= p_per_channel:
            continue
        kernel = _gaussian_bump(rng, data.shape[1:])
        strength = rng.uniform(-5, -1) if rng.uniform() < 0.5 \
            else rng.uniform(1, 5)
        mx = np.abs(kernel).max()
        if mx > 0:
            data[c] = data[c] + kernel * (strength / mx)
    return data


def local_gamma_augment(data, rng, p: float = 0.3,
                        p_per_channel: float = 0.5):
    """LocalGammaTransform (ref :233-242): gamma = U(0.01, 0.8) or
    U(1.5, 4) (ref :685-686) applied through the gaussian bump — exponent
    interpolates from 1 (far field) to gamma (bump center) on the
    [0, 1]-normalized image, independent per channel."""
    if rng.uniform() >= p:
        return data
    for c in range(data.shape[0]):
        if rng.uniform() >= p_per_channel:
            continue
        kernel = _gaussian_bump(rng, data.shape[1:])
        kernel = kernel - kernel.min()
        mx = kernel.max()
        if mx <= 0:
            continue
        kernel /= mx
        gamma = rng.uniform(0.01, 0.8) if rng.uniform() < 0.5 \
            else rng.uniform(1.5, 4.0)
        img = data[c]
        mn, rng_ = img.min(), img.max() - img.min()
        norm = (img - mn) / max(rng_, 1e-8)
        data[c] = np.power(norm, (gamma - 1.0) * kernel + 1.0) * \
            max(rng_, 1e-8) + mn
    return data


def sharpening_augment(data, rng, p: float = 0.2,
                       p_per_channel: float = 0.5, strength=(0.1, 1.0)):
    """SharpeningTransform(strength=(0.1, 1), same_for_each_channel=False,
    p_per_sample=0.2, p_per_channel=0.5) (ref :244-251): laplacian
    sharpening, img - s * laplace(img), per-channel strength."""
    if rng.uniform() >= p:
        return data
    for c in range(data.shape[0]):
        if rng.uniform() < p_per_channel:
            s = rng.uniform(*strength)
            data[c] = data[c] - s * laplace(data[c])
    return data


def one_of(rng, fns):
    """OneOfTransform (ref :148, :171): pick exactly one branch uniformly;
    the chosen transform still applies its own probabilities."""
    return fns[int(rng.randint(len(fns)))]


def configure_da5_rotation_dummyDA_mirroring_and_initial_patch_size(
        patch_size):
    """DA5's geometry envelope (ref nnUNetTrainerDA5.py:40-78): same
    rotation/dummy-2d/mirror rules as the default trainer but the initial
    patch size is computed with the WIDER (0.7, 1.43) scale range."""
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
        rotation = (-math.pi, math.pi) if do_dummy_2d else \
            (-30 / 360 * 2 * math.pi, 30 / 360 * 2 * math.pi)
        mirror_axes = (0, 1, 2)
    else:
        raise RuntimeError(f"unsupported dim {dim}")
    initial_patch_size = get_patch_size(patch_size[-dim:], rotation,
                                        rotation, rotation, (0.7, 1.43))
    if do_dummy_2d:
        initial_patch_size[0] = patch_size[0]
    return rotation, do_dummy_2d, initial_patch_size, mirror_axes


class DA5TrainingAugmenter(TrainingAugmenter):
    """The reference DA5 pipeline, transform-for-transform (ref
    nnUNetTrainerDA5.py:80-292). Order and probabilities:

    spatial(rot p=.4/axis p=.5, scale p=.2 indep (0.7,1.43), data order 3,
    seg order `seg_order`) -> rot90 p=.5 -> transpose p=.5 ->
    OneOf(median(2,8) | blur(0.3,1.5)) each p=.2/ch .5 -> noise p=.1 ->
    additive brightness N(0,.5) p=.1/ch .5 -> OneOf(contrast preserve |
    contrast free) each p=.2/ch .5 -> lowres zoom(.25,1) p=.15/ch .5 ->
    inverted gamma(.7,1.5) p=.1 TWICE -> mirror -> blank rects p=.4/ch .5
    -> brightness gradient p=.3/ch .5 -> local gamma p=.3/ch .5 ->
    sharpening p=.2/ch .5 -> mask -> -1 removal -> regions -> DS."""

    seg_order = 1  # DA5Segord0 sets 0 (ref :461-513 order_data=0/order_seg=0)
    data_order = 3

    def __call__(self, data: np.ndarray, seg: np.ndarray,
                 rng: np.random.RandomState):
        data = np.ascontiguousarray(data, dtype=np.float32)
        seg = np.ascontiguousarray(seg)
        matching, valid_axes = _matching_axes(self.patch_size)
        ignore_axes = (0,) if self.dummy_2d else None

        data, seg = spatial_augment_da5(
            data, seg, self.patch_size, self.rotation_range, rng,
            dummy_2d=self.dummy_2d, order_data=self.data_order,
            order_seg=self.seg_order)
        if (matching > 1).any():
            data, seg = rot90_augment(data, seg, rng, valid_axes)
            data, seg = transpose_axes_augment(data, seg, rng, valid_axes)
        data = one_of(rng, [
            lambda d: median_filter_augment(d, rng),
            lambda d: gaussian_blur(d, rng, p=0.2, sigma_range=(0.3, 1.5),
                                    p_per_channel=0.5)])(data)
        data = gaussian_noise(data, rng, p=0.1)
        data = additive_brightness(data, rng)
        data = one_of(rng, [
            lambda d: contrast_augment_da5(d, rng, preserve_range=True),
            lambda d: contrast_augment_da5(d, rng, preserve_range=False)])(
                data)
        data = simulate_low_resolution_da5(data, rng,
                                           ignore_axes=ignore_axes)
        data = gamma_augment(data, rng, p=0.1, invert_image=True)
        data = gamma_augment(data, rng, p=0.1, invert_image=True)
        if self.mirror_axes:
            data, seg = mirror_augment(data, seg, rng, self.mirror_axes)
        data = blank_rectangles_augment(data, rng, self.patch_size)
        data = brightness_gradient_additive(data, rng)
        data = local_gamma_augment(data, rng)
        data = sharpening_augment(data, rng)
        if self.use_mask_for_norm is not None and any(self.use_mask_for_norm):
            data = mask_image(data, seg, self.use_mask_for_norm)
        if self.cascade_labels is not None and seg.shape[0] > 1:
            data, seg = move_prev_stage_to_data(data, seg,
                                                self.cascade_labels, rng)
        seg = seg.copy()
        seg[seg == -1] = 0
        if self.regions is not None:
            seg = convert_labels_to_regions(seg, self.regions,
                                            self.ignore_label)
        targets = downsample_seg_for_ds(seg, self.ds_scales) \
            if self.ds_scales is not None else [seg]
        return data, targets


class DA5CondensedAugmenter(TrainingAugmenter):
    """The pre-round-5 condensed DA5 (6 transform families, ~150 LoC):
    kept as a documented CHEAP variant — same spirit, not the pipeline the
    reference's robustness numbers were measured with."""

    SCALE_RANGE = (0.7, 1.43)

    def __call__(self, data: np.ndarray, seg: np.ndarray,
                 rng: np.random.RandomState):
        data = np.ascontiguousarray(data, dtype=np.float32)
        seg = np.ascontiguousarray(seg)
        _, valid_axes = _matching_axes(self.patch_size)
        data, seg = spatial_augment(data, seg, self.patch_size,
                                    self.rotation_range, rng, p_rotation=0.4,
                                    p_scaling=0.4,
                                    scale_range=self.SCALE_RANGE,
                                    dummy_2d=self.dummy_2d)
        data, seg = rot90_augment(data, seg, rng, valid_axes, p=0.2)
        data, seg = transpose_axes_augment(data, seg, rng, valid_axes, p=0.2)
        data = gaussian_noise(data, rng, p=0.15)
        data = gaussian_blur(data, rng, p=0.25)
        data = median_filter_augment(data, rng)
        data = sharpening_augment(data, rng)
        data = multiplicative_brightness(data, rng, p=0.2)
        data = contrast_augment(data, rng, p=0.2)
        data = simulate_low_resolution(data, rng, p=0.3)
        data = gamma_augment(data, rng, p=0.15, invert_image=True)
        data = gamma_augment(data, rng, p=0.35, invert_image=False)
        data = local_gamma_augment(data, rng, p=0.2)
        data = blank_rectangles_augment(data, rng, self.patch_size, p=0.2)
        if self.mirror_axes:
            data, seg = mirror_augment(data, seg, rng, self.mirror_axes)
        if self.use_mask_for_norm is not None and any(self.use_mask_for_norm):
            data = mask_image(data, seg, self.use_mask_for_norm)
        seg = seg.copy()
        seg[seg == -1] = 0
        if self.regions is not None:
            seg = convert_labels_to_regions(seg, self.regions,
                                            self.ignore_label)
        targets = downsample_seg_for_ds(seg, self.ds_scales) \
            if self.ds_scales is not None else [seg]
        return data, targets
