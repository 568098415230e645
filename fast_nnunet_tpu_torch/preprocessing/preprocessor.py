"""Case preprocessing on the host: transpose -> crop-to-nonzero -> normalize
-> resample, fast_nnunet_tpu/preprocessing/preprocessor.py's
``DefaultPreprocessor`` copied (numpy/scipy). Normalization runs BEFORE
resampling so the nonzero mask still aligns with the image. With a
segmentation the foreground locations for the patch sampler are collected
as there. ``run`` preprocesses a whole raw dataset into the ``.npy`` case
store (``training/dataset.NpyCaseDataset``), in a spawned process pool when
``num_processes`` > 1 (the card hidden from its workers,
``utils.mp_env``), or into the chunked-zstd ``.fnnz`` store
(``storage="fnnz"``, ``FNNT_STORE=fnnz``; ``training/zstd_store.py``, bricks
sized from the configuration's patch). ``run`` also copies the raw
dataset.json next to the plans, as the reference's preprocessing does (the
JAX package copies it only when planning)."""
import math
import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import List, Optional, Union

import numpy as np

from ..core.plans import ConfigurationManager, PlansManager
from ..ops.cropping import crop_to_nonzero
from ..ops.normalization import get_normalization_scheme_by_class_name
from ..ops.resampling import compute_new_shape
from ..training.dataset import NpyCaseDataset
from ..training.zstd_store import ZstdCaseDataset
from ..utils.dataset_io import get_filenames_of_train_images_and_targets
from ..utils.io import join, load_json, maybe_mkdir_p
from ..utils.mp_env import cpu_only_child_env


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
            seg = self.modify_seg_fn(seg, plans_manager, dataset_json,
                                     configuration_manager)
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

    def run_case_save(self, output_filename_truncated: str,
                      image_files: List[str], seg_file: Optional[str],
                      plans_manager: PlansManager,
                      configuration_manager: ConfigurationManager,
                      dataset_json: Union[dict, str],
                      storage: str = "npy") -> None:
        _check_storage(storage)
        data, seg, properties = self.run_case(
            image_files, seg_file, plans_manager, configuration_manager,
            dataset_json)
        if storage == "fnnz":
            ZstdCaseDataset.save_case(
                data, seg, properties, output_filename_truncated,
                patch_size=configuration_manager.patch_size)
        else:
            NpyCaseDataset.save_case(data, seg, properties,
                                     output_filename_truncated)

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

    def modify_seg_fn(self, seg: np.ndarray, plans_manager: PlansManager,
                      dataset_json: dict,
                      configuration_manager: ConfigurationManager
                      ) -> np.ndarray:
        """Extension hook for subclasses; the default keeps the seg."""
        return seg

    def run(self, dataset_name_or_id, configuration_name: str,
            plans_identifier: str = "nnUNetPlans", num_processes: int = 8,
            storage: Optional[str] = None) -> None:
        """Preprocess a whole raw dataset into
        ``nnUNet_preprocessed/<dataset>/<data_identifier>``. ``storage``
        None reads ``FNNT_STORE`` (default ``npy``)."""
        from ..paths import get_preprocessed_folder, get_raw_folder
        from ..utils.misc import maybe_convert_to_dataset_name

        dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        preprocessed = join(get_preprocessed_folder(), dataset_name)
        plans_manager = PlansManager(join(preprocessed,
                                          plans_identifier + ".json"))
        configuration_manager = plans_manager.get_configuration(
            configuration_name)
        raw = join(get_raw_folder(), dataset_name)
        dataset_json = load_json(join(raw, "dataset.json"))
        # as the reference's preprocess_dataset: training reads it from
        # here, also when the plans were moved in rather than planned
        shutil.copy(join(raw, "dataset.json"), join(preprocessed,
                                                    "dataset.json"))
        dataset = get_filenames_of_train_images_and_targets(raw,
                                                            dataset_json)
        if storage is None:
            storage = os.environ.get("FNNT_STORE", "npy")
        _check_storage(storage)
        out_folder = join(preprocessed, configuration_manager.data_identifier)
        maybe_mkdir_p(out_folder)

        jobs = [(join(out_folder, ident), d["images"], d["label"])
                for ident, d in dataset.items()]
        if num_processes <= 1:
            for out_trunc, images, label in jobs:
                self.run_case_save(out_trunc, images, label, plans_manager,
                                   configuration_manager, dataset_json,
                                   storage=storage)
            return
        ctx = multiprocessing.get_context("spawn")
        with cpu_only_child_env(), \
                ProcessPoolExecutor(max_workers=num_processes,
                                    mp_context=ctx) as ex:
            futures = [ex.submit(_run_case_save_worker, type(self), out_trunc,
                                 images, label, plans_manager.plans,
                                 configuration_name, dataset_json, storage)
                       for out_trunc, images, label in jobs]
            for fut in as_completed(futures):
                fut.result()  # re-raise a worker's error here


def _check_storage(storage: str) -> None:
    if storage not in ("npy", "fnnz"):
        raise ValueError(f"unknown storage {storage!r} (npy or fnnz)")


def _run_case_save_worker(preproc_cls, out_trunc, images, label, plans_dict,
                          configuration_name, dataset_json, storage="npy"):
    pm = PlansManager(plans_dict)
    cm = pm.get_configuration(configuration_name)
    preproc_cls().run_case_save(out_trunc, images, label, pm, cm,
                                dataset_json, storage=storage)
