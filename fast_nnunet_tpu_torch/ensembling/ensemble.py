"""Probability ensembling across model folders and cross-validation folds —
a copy of fast_nnunet_tpu/ensembling/ensemble.py: average the saved ``.npz``
probabilities per case, convert them to a segmentation with the label
manager and write it with the case's original geometry."""
import argparse
from typing import List

import numpy as np

from ..core.plans import PlansManager
from ..utils.io import join, load_json, load_pickle, maybe_mkdir_p, subfiles


def average_probabilities(list_of_files: List[str]) -> np.ndarray:
    assert list_of_files, "no probability files to average"
    avg = None
    for f in list_of_files:
        probs = np.load(f)["probabilities"].astype(np.float32)
        avg = probs if avg is None else avg + probs
    return avg / len(list_of_files)


def merge_files(list_of_files: List[str], properties_file: str,
                output_file_truncated: str, plans_manager: PlansManager,
                dataset_json: dict, label_manager,
                save_merged_probabilities: bool = False) -> None:
    probs = average_probabilities(list_of_files)
    props = load_pickle(properties_file)
    seg = label_manager.convert_probabilities_to_segmentation(probs)
    rw = plans_manager.image_reader_writer_class()()
    rw.write_seg(seg, output_file_truncated + dataset_json["file_ending"], props)
    if save_merged_probabilities:
        np.savez_compressed(output_file_truncated + ".npz", probabilities=probs)
        import shutil
        shutil.copy(properties_file, output_file_truncated + ".pkl")


def ensemble_folders(list_of_input_folders: List[str], output_folder: str,
                     save_merged_probabilities: bool = False,
                     num_processes: int = 8,
                     dataset_json_file_or_dict=None,
                     plans_json_file_or_dict=None) -> None:
    """Each input folder must contain per-case .npz probabilities + .pkl
    properties (produced by predict with --save_probabilities)."""
    if dataset_json_file_or_dict is None:
        dataset_json_file_or_dict = join(list_of_input_folders[0], "dataset.json")
    dataset_json = load_json(dataset_json_file_or_dict) \
        if isinstance(dataset_json_file_or_dict, str) else dataset_json_file_or_dict
    if plans_json_file_or_dict is None:
        plans_json_file_or_dict = join(list_of_input_folders[0], "plans.json")
    plans_manager = PlansManager(plans_json_file_or_dict)
    label_manager = plans_manager.get_label_manager(dataset_json)

    maybe_mkdir_p(output_folder)
    cases = [f[:-4] for f in subfiles(list_of_input_folders[0], suffix=".npz",
                                      join_path=False)]
    for folder in list_of_input_folders[1:]:
        have = {f[:-4] for f in subfiles(folder, suffix=".npz", join_path=False)}
        missing = set(cases) - have
        assert not missing, f"{folder} is missing probabilities for {missing}"

    for case in cases:
        files = [join(f, case + ".npz") for f in list_of_input_folders]
        merge_files(files, join(list_of_input_folders[0], case + ".pkl"),
                    join(output_folder, case), plans_manager, dataset_json,
                    label_manager, save_merged_probabilities)


def ensemble_crossvalidations(list_of_trained_model_folders: List[str],
                              output_folder: str,
                              folds: List[int] = (0, 1, 2, 3, 4),
                              num_processes: int = 8) -> None:
    """Merge the saved validation-set probabilities of CV folds so each case
    (validated in exactly one fold per model) gets the cross-model average
    (ref ensemble.py:92-160)."""
    dataset_json = load_json(join(list_of_trained_model_folders[0], "dataset.json"))
    plans_manager = PlansManager(join(list_of_trained_model_folders[0],
                                      "plans.json"))
    label_manager = plans_manager.get_label_manager(dataset_json)
    maybe_mkdir_p(output_folder)

    # case -> list of (npz, pkl) per model
    per_case = {}
    import os
    for model in list_of_trained_model_folders:
        for f in folds:
            val_folder = join(model, f"fold_{f}", "validation")
            if not os.path.isdir(val_folder):
                raise RuntimeError(f"Missing validation folder {val_folder} — "
                                   "train with --npz to save probabilities")
            for npz in subfiles(val_folder, suffix=".npz", join_path=False):
                case = npz[:-4]
                per_case.setdefault(case, []).append(
                    (join(val_folder, npz), join(val_folder, case + ".pkl")))

    for case, entries in per_case.items():
        files = [e[0] for e in entries]
        merge_files(files, entries[0][1], join(output_folder, case),
                    plans_manager, dataset_json, label_manager)


def ensemble_entry(argv=None):
    parser = argparse.ArgumentParser(description="ensemble predicted probabilities")
    parser.add_argument("-i", nargs="+", required=True, help="input folders")
    parser.add_argument("-o", required=True, help="output folder")
    parser.add_argument("--save_npz", action="store_true")
    parser.add_argument("-np", type=int, default=8)
    args = parser.parse_args(argv)
    ensemble_folders(args.i, args.o, args.save_npz, args.np)
