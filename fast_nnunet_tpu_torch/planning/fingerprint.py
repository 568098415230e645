"""Dataset fingerprint extraction — a copy of
fast_nnunet_tpu/planning/fingerprint.py (host numpy): per case
crop-to-nonzero, sample foreground intensities (``RandomState(1234)``),
record shapes and spacings; per-channel intensity statistics over the pooled
samples -> ``dataset_fingerprint.json``. With ``num_processes`` > 1 the
cases are read in a spawned process pool; the workers never touch the
card."""
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import List

import numpy as np

from ..imageio.registry import determine_reader_writer_from_dataset_json
from ..ops.cropping import crop_to_nonzero
from ..utils.dataset_io import get_filenames_of_train_images_and_targets
from ..utils.io import (isfile, join, load_json, maybe_mkdir_p, save_json,
                        recursive_fix_for_json_export)
from ..utils.misc import maybe_convert_to_dataset_name


class DatasetFingerprintExtractor:
    def __init__(self, dataset_name_or_id, num_processes: int = 8, verbose: bool = False):
        from ..paths import get_raw_folder
        self.dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        self.input_folder = join(get_raw_folder(), self.dataset_name)
        self.num_processes = num_processes
        self.verbose = verbose
        self.dataset_json = load_json(join(self.input_folder, "dataset.json"))
        self.dataset = get_filenames_of_train_images_and_targets(
            self.input_folder, self.dataset_json)
        # ~1e7 fg voxels total across the dataset for the intensity stats
        self.num_foreground_voxels_for_intensitystats = int(10e7 // 10)

    @staticmethod
    def collect_foreground_intensities(segmentation: np.ndarray, images: np.ndarray,
                                       seed: int = 1234, num_samples: int = 10000):
        assert images.ndim == 4 and segmentation.ndim == 4
        assert not np.any(np.isnan(segmentation)), "segmentation contains NaNs"
        assert not np.any(np.isnan(images)), "images contain NaNs"
        rs = np.random.RandomState(seed)
        fg_mask = segmentation[0] > 0
        per_channel = []
        stats_per_channel = []
        for c in range(len(images)):
            fg = images[c][fg_mask]
            n = len(fg)
            per_channel.append(rs.choice(fg, num_samples, replace=True) if n > 0 else [])
            if n > 0:
                p00_5, median, p99_5 = np.percentile(fg, (0.5, 50.0, 99.5))
                stats = {"mean": float(np.mean(fg)), "median": float(median),
                         "min": float(np.min(fg)), "max": float(np.max(fg)),
                         "percentile_99_5": float(p99_5),
                         "percentile_00_5": float(p00_5)}
            else:
                stats = {k: np.nan for k in ("mean", "median", "min", "max",
                                             "percentile_99_5", "percentile_00_5")}
            stats_per_channel.append(stats)
        return per_channel, stats_per_channel

    @staticmethod
    def analyze_case(image_files: List[str], segmentation_file: str,
                     reader_writer_class,
                     num_samples: int = 10000):
        rw = reader_writer_class()
        images, props = rw.read_images(image_files)
        segmentation, _ = rw.read_seg(segmentation_file)
        data_cropped, seg_cropped, _ = crop_to_nonzero(images, segmentation)
        fg_per_channel, fg_stats = DatasetFingerprintExtractor.collect_foreground_intensities(
            seg_cropped, data_cropped, num_samples=num_samples)
        shape_before = images.shape[1:]
        shape_after = data_cropped.shape[1:]
        rel_size = float(np.prod(shape_after) / np.prod(shape_before))
        return shape_after, props["spacing"], fg_per_channel, fg_stats, rel_size

    def run(self, overwrite_existing: bool = False) -> dict:
        from ..paths import get_preprocessed_folder
        out_folder = join(get_preprocessed_folder(), self.dataset_name)
        maybe_mkdir_p(out_folder)
        props_file = join(out_folder, "dataset_fingerprint.json")
        if isfile(props_file) and not overwrite_existing:
            return load_json(props_file)

        rw_class = determine_reader_writer_from_dataset_json(
            self.dataset_json,
            self.dataset[next(iter(self.dataset))]["images"][0])
        samples_per_case = max(1, int(self.num_foreground_voxels_for_intensitystats
                                      // max(len(self.dataset), 1)))

        keys = list(self.dataset.keys())
        if self.num_processes <= 1:
            results = [self.analyze_case(self.dataset[k]["images"],
                                         self.dataset[k]["label"], rw_class,
                                         samples_per_case) for k in keys]
        else:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=self.num_processes,
                                     mp_context=ctx) as ex:
                futures = [ex.submit(self.analyze_case, self.dataset[k]["images"],
                                     self.dataset[k]["label"], rw_class,
                                     samples_per_case) for k in keys]
                results = [f.result() for f in futures]

        shapes_after_crop = [r[0] for r in results]
        spacings = [r[1] for r in results]
        fg_intensities_per_channel = [np.concatenate([r[2][c] for r in results])
                                      if len(results) else []
                                      for c in range(len(results[0][2]))]
        median_relative_size = float(np.median([r[4] for r in results]))

        intensity_props = {}
        for c, pooled in enumerate(fg_intensities_per_channel):
            if len(pooled) > 0:
                p00_5, median, p99_5 = np.percentile(pooled, (0.5, 50.0, 99.5))
                intensity_props[str(c)] = {
                    "mean": float(np.mean(pooled)), "median": float(median),
                    "std": float(np.std(pooled)), "min": float(np.min(pooled)),
                    "max": float(np.max(pooled)),
                    "percentile_99_5": float(p99_5), "percentile_00_5": float(p00_5)}
            else:
                intensity_props[str(c)] = {k: 0.0 for k in (
                    "mean", "median", "std", "min", "max",
                    "percentile_99_5", "percentile_00_5")}

        fingerprint = {
            "spacings": [list(map(float, s)) for s in spacings],
            "shapes_after_crop": [list(map(int, s)) for s in shapes_after_crop],
            "foreground_intensity_properties_per_channel": intensity_props,
            "median_relative_size_after_cropping": median_relative_size,
        }
        recursive_fix_for_json_export(fingerprint)
        save_json(fingerprint, props_file, sort_keys=False)
        return fingerprint
