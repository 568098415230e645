"""Experiment planner, nnU-Net's self-configuration — a copy of
fast_nnunet_tpu/planning/planner.py (reference:
experiment_planners/default_experiment_planner.py). Same heuristics and
constants, including the 8 GB default memory target (``-gpu_memory_target``
changes it); the memory budget comes from the analytic feature-map estimator
(models/estimator.py) instead of a network built per candidate patch size.
Writes ``nnUNetPlans.json`` and copies ``dataset.json`` into
``nnUNet_preprocessed/<dataset>/``."""
import shutil
from typing import List, Optional, Tuple, Union

import numpy as np

from ..configuration import ANISO_THRESHOLD
from ..models.estimator import compute_conv_feature_map_size
from ..ops.normalization import get_normalization_scheme
from ..ops.resampling import compute_new_shape
from ..utils.dataset_io import get_filenames_of_train_images_and_targets
from ..utils.io import (isfile, join, load_json, maybe_mkdir_p, save_json,
                        recursive_fix_for_json_export)
from ..utils.misc import maybe_convert_to_dataset_name
from .topology import get_pool_and_conv_props


class ExperimentPlanner:
    UNet_class_name = "dynamic_network_architectures.architectures.unet.PlainConvUNet"

    def __init__(self, dataset_name_or_id: Union[str, int],
                 gpu_memory_target_in_gb: float = 8,
                 preprocessor_name: str = "DefaultPreprocessor",
                 plans_name: str = "nnUNetPlans",
                 overwrite_target_spacing: Optional[List[float]] = None,
                 suppress_transpose: bool = False):
        from ..paths import get_preprocessed_folder, get_raw_folder
        self.dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        self.suppress_transpose = suppress_transpose
        self.raw_dataset_folder = join(get_raw_folder(), self.dataset_name)
        self.preprocessed_folder = join(get_preprocessed_folder(), self.dataset_name)
        self.dataset_json = load_json(join(self.raw_dataset_folder, "dataset.json"))
        self.dataset = get_filenames_of_train_images_and_targets(
            self.raw_dataset_folder, self.dataset_json)

        fp_file = join(self.preprocessed_folder, "dataset_fingerprint.json")
        if not isfile(fp_file):
            raise RuntimeError(f"Fingerprint missing ({fp_file}). Run "
                               "extract_fingerprints first.")
        self.dataset_fingerprint = load_json(fp_file)

        self.anisotropy_threshold = ANISO_THRESHOLD

        # reference constants (default_experiment_planner.py:51-75); the reference
        # values correspond to the dynamic_network_architectures feature-map
        # accounting, which our estimator reproduces
        self.UNet_base_num_features = 32
        self.UNet_reference_val_3d = 560000000
        self.UNet_reference_val_2d = 85000000
        self.UNet_reference_com_nfeatures = 32
        self.UNet_reference_val_corresp_GB = 8
        self.UNet_reference_val_corresp_bs_2d = 12
        self.UNet_reference_val_corresp_bs_3d = 2
        self.UNet_featuremap_min_edge_length = 4
        self.UNet_blocks_per_stage_encoder = (2,) * 14
        self.UNet_blocks_per_stage_decoder = (2,) * 13
        self.UNet_min_batch_size = 2
        self.UNet_max_features_2d = 512
        self.UNet_max_features_3d = 320
        self.max_dataset_covered = 0.05
        self.UNet_vram_target_GB = gpu_memory_target_in_gb
        self.lowres_creation_threshold = 0.25

        self.preprocessor_name = preprocessor_name
        self.plans_identifier = plans_name
        self.overwrite_target_spacing = overwrite_target_spacing
        self.plans = None

    # ------------------------------------------------------------------ pieces
    def determine_reader_writer(self):
        from ..imageio.registry import determine_reader_writer_from_dataset_json
        example = self.dataset[next(iter(self.dataset))]["images"][0]
        return determine_reader_writer_from_dataset_json(self.dataset_json, example)

    def static_estimate_VRAM_usage(self, patch_size, input_channels: int,
                                   output_channels: int, arch_class_name: str,
                                   arch_kwargs: dict) -> int:
        return compute_conv_feature_map_size(arch_class_name, arch_kwargs,
                                             patch_size, output_channels, True)

    def determine_resampling(self):
        kwargs_data = {"is_seg": False, "order": 3, "order_z": 0,
                       "force_separate_z": None}
        kwargs_seg = {"is_seg": True, "order": 1, "order_z": 0,
                      "force_separate_z": None}
        return ("resample_data_or_seg_to_shape", kwargs_data,
                "resample_data_or_seg_to_shape", kwargs_seg)

    def determine_segmentation_softmax_export_fn(self):
        return ("resample_data_or_seg_to_shape",
                {"is_seg": False, "order": 1, "order_z": 0, "force_separate_z": None})

    def determine_fullres_target_spacing(self) -> np.ndarray:
        """Median spacing; on strongly anisotropic datasets the worst axis takes
        the 10th percentile instead (ref :155-196)."""
        if self.overwrite_target_spacing is not None:
            return np.array(self.overwrite_target_spacing)
        spacings = np.vstack(self.dataset_fingerprint["spacings"])
        sizes = np.vstack(self.dataset_fingerprint["shapes_after_crop"])
        target = np.percentile(spacings, 50, 0)
        target_size = np.percentile(sizes, 50, 0)
        worst = int(np.argmax(target))
        other = [i for i in range(len(target)) if i != worst]
        other_spacings = [target[i] for i in other]
        other_sizes = [target_size[i] for i in other]
        has_aniso_spacing = target[worst] > self.anisotropy_threshold * max(other_spacings)
        has_aniso_voxels = target_size[worst] * self.anisotropy_threshold < min(other_sizes)
        if has_aniso_spacing and has_aniso_voxels:
            t = np.percentile(spacings[:, worst], 10)
            if t < max(other_spacings):
                t = max(max(other_spacings), t) + 1e-5
            target[worst] = t
        return target

    def determine_normalization_scheme_and_whether_mask_is_used_for_norm(self):
        modalities = self.dataset_json.get("channel_names",
                                           self.dataset_json.get("modality"))
        schemes = [get_normalization_scheme(m) for m in modalities.values()]
        if self.dataset_fingerprint["median_relative_size_after_cropping"] < 3 / 4:
            use_mask = [s.leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true
                        for s in schemes]
            use_mask = [bool(m) for m in use_mask]
        else:
            use_mask = [False] * len(schemes)
        return [s.__name__ for s in schemes], use_mask

    def determine_transpose(self):
        if self.suppress_transpose:
            return [0, 1, 2], [0, 1, 2]
        target_spacing = self.determine_fullres_target_spacing()
        max_axis = int(np.argmax(target_spacing))
        remaining = [i for i in range(3) if i != max_axis]
        forward = [max_axis] + remaining
        backward = [forward.index(i) for i in range(3)]
        return forward, backward

    # ------------------------------------------------------------------ per config
    def _features_per_stage(self, num_stages: int, max_features: int) -> Tuple[int, ...]:
        return tuple(min(max_features, self.UNet_base_num_features * 2 ** i)
                     for i in range(num_stages))

    def _make_arch_kwargs(self, num_stages: int, conv_kernel_sizes, pool_op_kernel_sizes,
                          max_features: int, dim: int) -> dict:
        return {
            "network_class_name": self.UNet_class_name,
            "arch_kwargs": {
                "n_stages": num_stages,
                "features_per_stage": self._features_per_stage(num_stages, max_features),
                "conv_op": f"torch.nn.modules.conv.Conv{dim}d",
                "kernel_sizes": conv_kernel_sizes,
                "strides": pool_op_kernel_sizes,
                "n_conv_per_stage": self.UNet_blocks_per_stage_encoder[:num_stages],
                "n_conv_per_stage_decoder": self.UNet_blocks_per_stage_decoder[:num_stages - 1],
                "conv_bias": True,
                "norm_op": f"torch.nn.modules.instancenorm.InstanceNorm{dim}d",
                "norm_op_kwargs": {"eps": 1e-5, "affine": True},
                "dropout_op": None,
                "dropout_op_kwargs": None,
                "nonlin": "torch.nn.LeakyReLU",
                "nonlin_kwargs": {"inplace": True},
            },
            "_kw_requires_import": ("conv_op", "norm_op", "dropout_op", "nonlin"),
        }

    def get_plans_for_configuration(self, spacing, median_shape, data_identifier: str,
                                    approximate_n_voxels_dataset: float,
                                    _cache: dict) -> dict:
        assert all(s > 0 for s in spacing), f"spacing must be > 0: {spacing}"
        dim = len(spacing)
        num_input_channels = len(self.dataset_json.get(
            "channel_names", self.dataset_json.get("modality")))
        num_output = len(self.dataset_json["labels"])
        max_features = self.UNet_max_features_2d if dim == 2 else self.UNet_max_features_3d

        # aspect-ratio initial patch ~ volume of 256^3 (2048^2 in 2d), clipped to median
        tmp = 1 / np.array(spacing)
        if dim == 3:
            initial = [round(i) for i in tmp * (256 ** 3 / np.prod(tmp)) ** (1 / 3)]
        elif dim == 2:
            initial = [round(i) for i in tmp * (2048 ** 2 / np.prod(tmp)) ** (1 / 2)]
        else:
            raise RuntimeError(f"unsupported dim {dim}")
        initial = np.array([min(i, j) for i, j in zip(initial, median_shape[:dim])])

        num_pool, strides, kernels, patch_size, must_div = get_pool_and_conv_props(
            spacing, initial, self.UNet_featuremap_min_edge_length, 999999)
        num_stages = len(strides)
        arch = self._make_arch_kwargs(num_stages, kernels, strides, max_features, dim)

        def estimate(ps, st):
            key = str(ps) + "_" + str(st)
            if key not in _cache:
                _cache[key] = self.static_estimate_VRAM_usage(
                    ps, num_input_channels, num_output,
                    arch["network_class_name"], arch["arch_kwargs"])
            return _cache[key]

        est = estimate(patch_size, strides)
        reference = ((self.UNet_reference_val_2d if dim == 2
                      else self.UNet_reference_val_3d)
                     * (self.UNet_vram_target_GB / self.UNet_reference_val_corresp_GB))
        ref_bs = (self.UNet_reference_val_corresp_bs_2d if dim == 2
                  else self.UNet_reference_val_corresp_bs_3d)

        while (est / ref_bs * 2) > reference:
            # shrink the axis most oversized relative to the median shape; step
            # down carefully so no valid size is skipped (ref :325-345)
            axis = int(np.argsort([p / m for p, m in
                                   zip(patch_size, median_shape[:dim])])[-1])
            patch_size = list(patch_size)
            tmp_ps = list(patch_size)
            tmp_ps[axis] -= must_div[axis]
            _, _, _, _, must_div = get_pool_and_conv_props(
                spacing, tmp_ps, self.UNet_featuremap_min_edge_length, 999999)
            patch_size[axis] -= must_div[axis]
            num_pool, strides, kernels, patch_size, must_div = get_pool_and_conv_props(
                spacing, patch_size, self.UNet_featuremap_min_edge_length, 999999)
            num_stages = len(strides)
            arch = self._make_arch_kwargs(num_stages, kernels, strides, max_features, dim)
            est = estimate(patch_size, strides)

        batch_size = round((reference / est) * ref_bs)
        bs_5pct = round(approximate_n_voxels_dataset * self.max_dataset_covered
                        / np.prod(patch_size, dtype=np.float64))
        batch_size = max(min(batch_size, bs_5pct), self.UNet_min_batch_size)

        (res_data, res_data_kw, res_seg, res_seg_kw) = self.determine_resampling()
        res_prob, res_prob_kw = self.determine_segmentation_softmax_export_fn()
        norm_schemes, mask_for_norm = \
            self.determine_normalization_scheme_and_whether_mask_is_used_for_norm()

        return {
            "data_identifier": data_identifier,
            "preprocessor_name": self.preprocessor_name,
            "batch_size": int(batch_size),
            "patch_size": [int(p) for p in patch_size],
            "median_image_size_in_voxels": [float(m) for m in median_shape[:dim]],
            "spacing": [float(s) for s in spacing],
            "normalization_schemes": norm_schemes,
            "use_mask_for_norm": mask_for_norm,
            "resampling_fn_data": res_data,
            "resampling_fn_seg": res_seg,
            "resampling_fn_data_kwargs": res_data_kw,
            "resampling_fn_seg_kwargs": res_seg_kw,
            "resampling_fn_probabilities": res_prob,
            "resampling_fn_probabilities_kwargs": res_prob_kw,
            "architecture": arch,
        }

    # ------------------------------------------------------------------ full plan
    def plan_experiment(self) -> dict:
        _tmp = {}
        transpose_forward, transpose_backward = self.determine_transpose()
        fullres_spacing = self.determine_fullres_target_spacing()
        fullres_spacing_transposed = fullres_spacing[transpose_forward]

        new_shapes = [compute_new_shape(j, i, fullres_spacing) for i, j in
                      zip(self.dataset_fingerprint["spacings"],
                          self.dataset_fingerprint["shapes_after_crop"])]
        new_median_shape = np.median(new_shapes, 0)
        new_median_shape_transposed = new_median_shape[transpose_forward]

        approx_voxels = float(np.prod(new_median_shape_transposed, dtype=np.float64)
                              * self.dataset_json["numTraining"])

        plan_3d_fullres, plan_3d_lowres = None, None
        if new_median_shape_transposed[0] != 1:
            plan_3d_fullres = self.get_plans_for_configuration(
                fullres_spacing_transposed, new_median_shape_transposed,
                self.generate_data_identifier("3d_fullres"), approx_voxels, _tmp)
            patch_fullres = plan_3d_fullres["patch_size"]
            median_num_voxels = np.prod(new_median_shape_transposed, dtype=np.float64)
            num_voxels_in_patch = np.prod(patch_fullres, dtype=np.float64)
            lowres_spacing = np.array(plan_3d_fullres["spacing"], dtype=np.float64)
            spacing_increase_factor = 1.03
            while num_voxels_in_patch / median_num_voxels < self.lowres_creation_threshold:
                max_spacing = max(lowres_spacing)
                if np.any((max_spacing / lowres_spacing) > 2):
                    lowres_spacing[(max_spacing / lowres_spacing) > 2] *= \
                        spacing_increase_factor
                else:
                    lowres_spacing *= spacing_increase_factor
                median_num_voxels = np.prod(
                    np.array(plan_3d_fullres["spacing"]) / lowres_spacing
                    * new_median_shape_transposed, dtype=np.float64)
                plan_3d_lowres = self.get_plans_for_configuration(
                    tuple(lowres_spacing),
                    tuple(round(i) for i in np.array(plan_3d_fullres["spacing"])
                          / lowres_spacing * new_median_shape_transposed),
                    self.generate_data_identifier("3d_lowres"),
                    float(median_num_voxels * self.dataset_json["numTraining"]), _tmp)
                num_voxels_in_patch = np.prod(plan_3d_lowres["patch_size"],
                                              dtype=np.int64)
            if plan_3d_lowres is not None and \
                    np.prod(new_median_shape_transposed, dtype=np.float64) \
                    / median_num_voxels < 2:
                plan_3d_lowres = None  # too close to fullres to be useful
            if plan_3d_lowres is not None:
                plan_3d_lowres["batch_dice"] = False
                plan_3d_fullres["batch_dice"] = True
            else:
                plan_3d_fullres["batch_dice"] = False

        plan_2d = self.get_plans_for_configuration(
            fullres_spacing_transposed[1:], new_median_shape_transposed[1:],
            self.generate_data_identifier("2d"), approx_voxels, _tmp)
        plan_2d["batch_dice"] = True

        median_spacing = np.median(self.dataset_fingerprint["spacings"], 0)[transpose_forward]
        median_shape = np.median(self.dataset_fingerprint["shapes_after_crop"], 0)[transpose_forward]

        try:
            shutil.copy(join(self.raw_dataset_folder, "dataset.json"),
                        join(self.preprocessed_folder, "dataset.json"))
        except shutil.SameFileError:
            pass

        plans = {
            "dataset_name": self.dataset_name,
            "plans_name": self.plans_identifier,
            "original_median_spacing_after_transp": [float(i) for i in median_spacing],
            "original_median_shape_after_transp": [int(round(i)) for i in median_shape],
            "image_reader_writer": self.determine_reader_writer().__name__,
            "transpose_forward": [int(i) for i in transpose_forward],
            "transpose_backward": [int(i) for i in transpose_backward],
            "configurations": {"2d": plan_2d},
            "experiment_planner_used": self.__class__.__name__,
            "label_manager": "LabelManager",
            "foreground_intensity_properties_per_channel":
                self.dataset_fingerprint["foreground_intensity_properties_per_channel"],
        }
        if plan_3d_lowres is not None:
            plans["configurations"]["3d_lowres"] = plan_3d_lowres
            if plan_3d_fullres is not None:
                plans["configurations"]["3d_lowres"]["next_stage"] = "3d_cascade_fullres"
        if plan_3d_fullres is not None:
            plans["configurations"]["3d_fullres"] = plan_3d_fullres
            if plan_3d_lowres is not None:
                plans["configurations"]["3d_cascade_fullres"] = {
                    "inherits_from": "3d_fullres",
                    "previous_stage": "3d_lowres",
                }
        self.plans = plans
        self.save_plans(plans)
        return plans

    def save_plans(self, plans: dict) -> None:
        recursive_fix_for_json_export(plans)
        maybe_mkdir_p(self.preprocessed_folder)
        plans_file = join(self.preprocessed_folder, self.plans_identifier + ".json")
        if isfile(plans_file):
            # keep custom configurations added by the user
            old = load_json(plans_file)["configurations"]
            for c in plans["configurations"]:
                old.pop(c, None)
            plans["configurations"].update(old)
        save_json(plans, plans_file, sort_keys=False)

    def generate_data_identifier(self, configuration_name: str) -> str:
        return f"{self.plans_identifier}_{configuration_name}"
