"""Case preprocessing on the host: transpose -> crop-to-nonzero -> normalize
-> resample, the ``run_case`` / ``run_case_npy`` half of
fast_nnunet_tpu/preprocessing/preprocessor.py ``DefaultPreprocessor``,
copied (numpy/scipy). Normalization runs BEFORE resampling so the nonzero
mask still aligns with the image. With a segmentation the foreground
locations for the patch sampler are collected as there. Preprocessing whole
datasets for training is not ported."""
import math
from typing import List, Optional, Union

import numpy as np

from ..core.plans import ConfigurationManager, PlansManager
from ..ops.cropping import crop_to_nonzero
from ..ops.normalization import get_normalization_scheme_by_class_name
from ..ops.resampling import compute_new_shape
from ..utils.io import load_json


class DefaultPreprocessor:
    def __init__(self, verbose: bool = False):
        self.verbose = verbose

    def run_case_npy(self, data: np.ndarray, seg: Optional[np.ndarray],
                     properties: dict, plans_manager: PlansManager,
                     configuration_manager: ConfigurationManager,
                     dataset_json: Union[dict, str]):
        if isinstance(dataset_json, str):
            dataset_json = load_json(dataset_json)
        data = data.astype(np.float32)
        if seg is not None:
            assert data.shape[1:] == seg.shape[1:], \
                "image/segmentation shape mismatch"
            seg = np.copy(seg)
        has_seg = seg is not None

        tf = plans_manager.transpose_forward
        data = data.transpose([0, *[i + 1 for i in tf]])
        if seg is not None:
            seg = seg.transpose([0, *[i + 1 for i in tf]])
        original_spacing = [properties["spacing"][i] for i in tf]

        properties["shape_before_cropping"] = data.shape[1:]
        data, seg, bbox = crop_to_nonzero(data, seg)
        properties["bbox_used_for_cropping"] = bbox
        properties["shape_after_cropping_and_before_resampling"] = \
            data.shape[1:]

        target_spacing = list(configuration_manager.spacing)
        if len(target_spacing) < len(data.shape[1:]):
            # 2d config on 3d data: keep the between-slice spacing
            target_spacing = [original_spacing[0]] + target_spacing
        new_shape = compute_new_shape(data.shape[1:], original_spacing,
                                      target_spacing)
        data = self._normalize(
            data, seg, configuration_manager,
            plans_manager.foreground_intensity_properties_per_channel)
        data = configuration_manager.resampling_fn_data(
            data, new_shape, original_spacing, target_spacing)
        seg = configuration_manager.resampling_fn_seg(
            seg, new_shape, original_spacing, target_spacing)

        if has_seg:
            label_manager = plans_manager.get_label_manager(dataset_json)
            collect = list(label_manager.foreground_regions) \
                if label_manager.has_regions \
                else list(label_manager.foreground_labels)
            if label_manager.has_ignore_label:
                collect.append([-1] + label_manager.all_labels)
            properties["class_locations"] = \
                self._sample_foreground_locations(seg, collect,
                                                  verbose=self.verbose)
        seg = seg.astype(np.int16 if np.max(seg) > 127 else np.int8)
        return data, seg, properties

    def run_case(self, image_files: List[str], seg_file: Optional[str],
                 plans_manager: PlansManager,
                 configuration_manager: ConfigurationManager,
                 dataset_json: Union[dict, str]):
        if isinstance(dataset_json, str):
            dataset_json = load_json(dataset_json)
        rw = plans_manager.image_reader_writer_class()()
        data, data_properties = rw.read_images(image_files)
        seg = rw.read_seg(seg_file)[0] if seg_file is not None else None
        return self.run_case_npy(data, seg, data_properties, plans_manager,
                                 configuration_manager, dataset_json)

    @staticmethod
    def _sample_foreground_locations(seg: np.ndarray, classes_or_regions,
                                     seed: int = 1234,
                                     verbose: bool = False) -> dict:
        """Up to 10k voxel coordinates per foreground class or region (at
        least 1% of it; at most 1e7 candidates)."""
        num_samples = 10000
        min_percent_coverage = 0.01
        rndst = np.random.RandomState(seed)
        class_locs = {}
        foreground_mask = seg != 0
        foreground_coords = np.argwhere(foreground_mask)
        seg_fg = seg[foreground_mask]
        if len(foreground_coords) > 1e7:
            take_every = math.floor(len(foreground_coords) / 1e7)
            foreground_coords = foreground_coords[::take_every]
            seg_fg = seg_fg[::take_every]
        unique_labels = set(np.unique(seg_fg).tolist())
        for c in classes_or_regions:
            k = tuple(c) if isinstance(c, (tuple, list)) else c
            members = c if isinstance(c, (tuple, list)) else [c]
            if not any(ci in unique_labels or ci == -1 for ci in members):
                class_locs[k] = []
                continue
            mask = np.zeros(len(seg_fg), dtype=bool)
            for ci in members:
                mask |= seg_fg == ci
            all_locs = foreground_coords[mask]
            if len(all_locs) == 0:
                class_locs[k] = []
                continue
            target = min(num_samples, len(all_locs))
            target = max(target, int(np.ceil(len(all_locs)
                                             * min_percent_coverage)))
            class_locs[k] = all_locs[rndst.choice(len(all_locs), target,
                                                  replace=False)]
            if verbose:
                print(c, target)
            seg_fg = seg_fg[~mask]
            foreground_coords = foreground_coords[~mask]
        return class_locs

    def _normalize(self, data: np.ndarray, seg: np.ndarray,
                   configuration_manager: ConfigurationManager,
                   intensity_properties: dict) -> np.ndarray:
        for c in range(data.shape[0]):
            cls = get_normalization_scheme_by_class_name(
                configuration_manager.normalization_schemes[c])
            normalizer = cls(
                use_mask_for_norm=configuration_manager.use_mask_for_norm[c],
                intensityproperties=intensity_properties.get(
                    str(c), intensity_properties.get(c)))
            data[c] = normalizer.run(data[c], seg[0] if seg is not None
                                     else None)
        return data
