"""Connected-component postprocessing — a copy of
fast_nnunet_tpu/postprocessing/connected_components.py (scipy.ndimage):
keep the largest component jointly over all foreground, then per label or
region, each step kept only when the mean foreground Dice does not fall; the
accepted steps are saved as ``postprocessing.json`` and can be applied to a
folder of predictions."""
from typing import List, Tuple, Union

import numpy as np
from scipy import ndimage

from ..evaluation.metrics import compute_metrics_on_folder
from ..utils.io import join, maybe_mkdir_p, save_json, subfiles


def remove_all_but_largest_component(binary_mask: np.ndarray) -> np.ndarray:
    labeled, n = ndimage.label(binary_mask)
    if n <= 1:
        return binary_mask
    sizes = ndimage.sum_labels(np.ones_like(labeled, dtype=np.int64), labeled,
                               index=np.arange(1, n + 1))
    keep = 1 + int(np.argmax(sizes))
    return labeled == keep


def remove_all_but_largest_component_from_segmentation(
        segmentation: np.ndarray,
        labels_or_regions: Union[int, Tuple[int, ...],
                                 List[Union[int, Tuple[int, ...]]]],
        background_label: int = 0) -> np.ndarray:
    """For each entry (a label or a region = tuple of labels), keep only the
    largest connected component of its mask; removed voxels become background."""
    if not isinstance(labels_or_regions, list):
        labels_or_regions = [labels_or_regions]
    seg = np.copy(segmentation)
    for lr in labels_or_regions:
        members = lr if isinstance(lr, (tuple, list)) else (lr,)
        mask = np.isin(seg, members)
        if not mask.any():
            continue
        keep = remove_all_but_largest_component(mask)
        seg[mask & ~keep] = background_label
    return seg


def apply_postprocessing(segmentation: np.ndarray, pp_fns: List[str],
                         pp_fn_kwargs: List[dict]) -> np.ndarray:
    for fn_name, kwargs in zip(pp_fns, pp_fn_kwargs):
        fn = _PP_FNS[fn_name]
        segmentation = fn(segmentation, **kwargs)
    return segmentation


_PP_FNS = {
    "remove_all_but_largest_component_from_segmentation":
        remove_all_but_largest_component_from_segmentation,
}


def apply_postprocessing_to_folder(input_folder: str, output_folder: str,
                                   pp_fns: List[str], pp_fn_kwargs: List[dict],
                                   plans_manager, dataset_json: dict,
                                   num_processes: int = 8) -> None:
    maybe_mkdir_p(output_folder)
    rw = plans_manager.image_reader_writer_class()()
    fe = dataset_json["file_ending"]
    for f in subfiles(input_folder, suffix=fe, join_path=False):
        seg, props = rw.read_seg(join(input_folder, f))
        seg_pp = apply_postprocessing(seg[0], pp_fns, pp_fn_kwargs)
        rw.write_seg(seg_pp, join(output_folder, f), props)


def determine_postprocessing(folder_predictions: str, folder_ref: str,
                             plans_manager, dataset_json: dict,
                             num_processes: int = 8,
                             keep_postprocessed_files: bool = True) -> Tuple[List[str], List[dict], dict]:
    """Try candidate postprocessing steps; accept each only if the mean fg Dice
    does not get worse (ref :21-230). Returns (fns, kwargs, final_metrics) and
    writes postprocessing.json next to the predictions."""
    label_manager = plans_manager.get_label_manager(dataset_json)
    rw = plans_manager.image_reader_writer_class()()
    fe = dataset_json["file_ending"]
    classes_or_regions = label_manager.foreground_regions \
        if label_manager.has_regions else label_manager.foreground_labels

    baseline = compute_metrics_on_folder(
        folder_ref, folder_predictions, None, rw, fe, classes_or_regions,
        label_manager.ignore_label, num_processes)

    pp_fns: List[str] = []
    pp_fn_kwargs: List[dict] = []
    current_folder = folder_predictions
    current_metrics = baseline

    # candidate 1: largest component over ALL foreground jointly
    # candidate 2: largest component per label/region
    candidates = [
        {"labels_or_regions": [tuple(sorted({l for lr in classes_or_regions
                                             for l in (lr if isinstance(lr, (tuple, list))
                                                       else (lr,))}))]},
        {"labels_or_regions": list(classes_or_regions)},
    ]
    for cand_kwargs in candidates:
        trial_folder = folder_predictions + "_pp_trial"
        apply_postprocessing_to_folder(
            current_folder, trial_folder,
            ["remove_all_but_largest_component_from_segmentation"],
            [cand_kwargs], plans_manager, dataset_json, num_processes)
        trial_metrics = compute_metrics_on_folder(
            folder_ref, trial_folder, None, rw, fe, classes_or_regions,
            label_manager.ignore_label, num_processes)
        if trial_metrics["foreground_mean"]["Dice"] >= \
                current_metrics["foreground_mean"]["Dice"] - 1e-8:
            pp_fns.append("remove_all_but_largest_component_from_segmentation")
            pp_fn_kwargs.append(cand_kwargs)
            current_metrics = trial_metrics
            current_folder = trial_folder
        else:
            import shutil
            shutil.rmtree(trial_folder, ignore_errors=True)

    save_json({"pp_fns": pp_fns, "pp_fn_kwargs": pp_fn_kwargs},
              join(folder_predictions, "postprocessing.json"), sort_keys=False)
    if not keep_postprocessed_files and current_folder != folder_predictions:
        import shutil
        shutil.rmtree(current_folder, ignore_errors=True)
    return pp_fns, pp_fn_kwargs, current_metrics
