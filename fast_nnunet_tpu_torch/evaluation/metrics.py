"""Segmentation evaluation: per-case Dice/IoU/TP/FP/FN/TN per label or
region and the folder summary.json — a copy of
fast_nnunet_tpu/evaluation/metrics.py (the reference's
evaluate_predictions.py, region keys as '(1, 2)', ignore-label masking),
reading through the port's image reader/writers."""
from typing import List, Optional, Tuple, Union

import numpy as np

from ..utils.io import join, save_json, subfiles

LabelOrRegion = Union[int, Tuple[int, ...]]


def label_or_region_to_key(label_or_region: LabelOrRegion) -> str:
    return str(label_or_region)


def key_to_label_or_region(key: str) -> LabelOrRegion:
    try:
        return int(key)
    except ValueError:
        key = key.replace("(", "").replace(")", "")
        return tuple(int(i) for i in key.split(",") if len(i.strip()) > 0)


def region_or_label_to_mask(segmentation: np.ndarray, region_or_label) -> np.ndarray:
    if np.isscalar(region_or_label):
        return segmentation == region_or_label
    mask = np.zeros_like(segmentation, dtype=bool)
    for r in region_or_label:
        mask |= segmentation == r
    return mask


def compute_tp_fp_fn_tn(mask_ref: np.ndarray, mask_pred: np.ndarray,
                        ignore_mask: Optional[np.ndarray] = None):
    use = ~ignore_mask if ignore_mask is not None else None
    if use is None:
        tp = int(np.sum(mask_ref & mask_pred))
        fp = int(np.sum(~mask_ref & mask_pred))
        fn = int(np.sum(mask_ref & ~mask_pred))
        tn = int(np.sum(~mask_ref & ~mask_pred))
    else:
        tp = int(np.sum(mask_ref & mask_pred & use))
        fp = int(np.sum(~mask_ref & mask_pred & use))
        fn = int(np.sum(mask_ref & ~mask_pred & use))
        tn = int(np.sum(~mask_ref & ~mask_pred & use))
    return tp, fp, fn, tn


def compute_metrics(reference_file: str, prediction_file: str,
                    image_reader_writer,
                    labels_or_regions: List[LabelOrRegion],
                    ignore_label: Optional[int] = None) -> dict:
    seg_ref, _ = image_reader_writer.read_seg(reference_file)
    seg_pred, _ = image_reader_writer.read_seg(prediction_file)
    ignore_mask = (seg_ref == ignore_label) if ignore_label is not None else None

    results = {"reference_file": reference_file, "prediction_file": prediction_file,
               "metrics": {}}
    for lr in labels_or_regions:
        key = label_or_region_to_key(lr)
        mask_ref = region_or_label_to_mask(seg_ref, lr)
        mask_pred = region_or_label_to_mask(seg_pred, lr)
        tp, fp, fn, tn = compute_tp_fp_fn_tn(mask_ref, mask_pred, ignore_mask)
        m = {}
        if tp + fp + fn == 0:
            m["Dice"] = np.nan
            m["IoU"] = np.nan
        else:
            m["Dice"] = 2 * tp / (2 * tp + fp + fn)
            m["IoU"] = tp / (tp + fp + fn)
        m.update({"FP": fp, "TP": tp, "FN": fn, "TN": tn,
                  "n_pred": fp + tp, "n_ref": fn + tp})
        results["metrics"][key] = m
    return results


def compute_metrics_on_folder(folder_ref: str, folder_pred: str, output_file: Optional[str],
                              image_reader_writer, file_ending: str,
                              regions_or_labels: List[LabelOrRegion],
                              ignore_label: Optional[int] = None,
                              num_processes: int = 8, chill: bool = True) -> dict:
    files_pred = subfiles(folder_pred, suffix=file_ending, join_path=False)
    files_ref = subfiles(folder_ref, suffix=file_ending, join_path=False)
    if not chill:
        present = [f in files_pred for f in files_ref]
        assert all(present), "Not all reference files have predictions"
    files_ref = [f for f in files_ref if f in files_pred]

    results = [compute_metrics(join(folder_ref, f), join(folder_pred, f),
                               image_reader_writer, regions_or_labels, ignore_label)
               for f in files_ref]

    metric_list = list(results[0]["metrics"][
        label_or_region_to_key(regions_or_labels[0])].keys())
    means = {}
    for lr in regions_or_labels:
        key = label_or_region_to_key(lr)
        means[key] = {m: float(np.nanmean(
            [r["metrics"][key][m] for r in results])) for m in metric_list}
    fg_keys = [label_or_region_to_key(lr) for lr in regions_or_labels
               if not (np.isscalar(lr) and lr == 0)]
    foreground_mean = {m: float(np.mean([means[k][m] for k in fg_keys]))
                       for m in metric_list}

    result = {"metric_per_case": results, "mean": means,
              "foreground_mean": foreground_mean}
    if output_file is not None:
        save_json(result, output_file, sort_keys=False)
    return result
