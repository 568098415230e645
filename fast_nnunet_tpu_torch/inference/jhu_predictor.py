"""JHU AbdomenAtlas benchmark predictor — the port of
fast_nnunet_tpu/inference/jhu_predictor.py. The JHU harness expects, per case, a
``predictions/`` folder holding one binary mask file per foreground class
named by its label name (ref distillation/nnunetv2/inference/
JHU_inference.py:22-66), with cases laid out as ``<input>/<case>/ct.nii.gz``
-> ``<output>/<case>/predictions/*.nii.gz`` (ref :182-197).

Device compute is the port's sliding-window engine on ``device`` (``cuda``
unless the caller passes ``"cpu"``); the per-case resample/split/write runs
in a background thread pool so the card does not wait on disk (the
reference uses a spawn pool for the same reason, ref :78-139)."""
import argparse
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from ..postprocessing.connected_components import \
    remove_all_but_largest_component_from_segmentation
from ..preprocessing.preprocessor import DefaultPreprocessor
from ..utils.io import join, maybe_mkdir_p, save_pickle, subdirs
from .export import convert_predicted_logits_to_segmentation_with_correct_shape
from .predictor import NNUNetPredictor


def export_prediction_to_class_files(logits, props: dict, plans_manager,
                                     configuration_manager, dataset_json: dict,
                                     output_file_truncated: str,
                                     save_probabilities: bool = False,
                                     apply_largest_component: bool = False) -> None:
    """JHU output structure: output_file_truncated is a per-case folder; the
    label maps land in its ``predictions/`` subfolder, one uint8 file per
    foreground class (ref JHU_inference.py export_prediction_from_logits_
    singleFiles:22-66)."""
    label_manager = plans_manager.get_label_manager(dataset_json)
    ret = convert_predicted_logits_to_segmentation_with_correct_shape(
        logits, plans_manager, configuration_manager, label_manager, props,
        return_probabilities=save_probabilities)
    out_folder = join(output_file_truncated, "predictions")
    # before the probabilities, which go beside the case folder: the JAX
    # package writes them first and fails on a new output folder
    maybe_mkdir_p(out_folder)
    if save_probabilities:
        seg, probs = ret
        np.savez_compressed(output_file_truncated + ".npz", probabilities=probs)
        save_pickle(props, output_file_truncated + ".pkl")
    else:
        seg = ret

    rw = plans_manager.image_reader_writer_class()()
    fe = dataset_json["file_ending"]
    name_of = {}
    for name, val in dataset_json["labels"].items():
        if np.isscalar(val):
            name_of[int(val)] = name
    for l in label_manager.foreground_labels:
        mask = (seg == l).astype(np.uint8, copy=False)
        if apply_largest_component and mask.any():
            mask = remove_all_but_largest_component_from_segmentation(
                mask, [1]).astype(np.uint8)
        rw.write_seg(mask, join(out_folder, f"{name_of[int(l)]}{fe}"), props)


class JHUPredictor(NNUNetPredictor):
    """predict_from_files writes the JHU benchmark structure instead of one
    labelmap per case (ref JHU_inference.py:67-147)."""

    def predict_cases_to_class_folders(self, list_of_input_files: Sequence,
                                       output_folders: Sequence[str],
                                       save_probabilities: bool = False,
                                       num_export_workers: int = 3,
                                       apply_largest_component: bool = False) -> None:
        preproc = DefaultPreprocessor(verbose=self.verbose)
        with ThreadPoolExecutor(num_export_workers) as pool:
            pending: List = []
            for files, out in zip(list_of_input_files, output_folders):
                data, _, props = preproc.run_case(
                    list(files), None, self.plans_manager,
                    self.configuration_manager, self.dataset_json)
                logits = self.predict_logits_from_preprocessed_data(data)
                pending.append(pool.submit(
                    export_prediction_to_class_files, logits, props,
                    self.plans_manager, self.configuration_manager,
                    self.dataset_json, out, save_probabilities,
                    apply_largest_component))
                # bound the queue so fast device prediction can't swamp RAM
                # with whole-volume logits (ref check_workers_alive_and_busy)
                while sum(not f.done() for f in pending) > 2:
                    pending[0].result()
                    for f in pending:  # every finished export's error
                        if f.done():
                            f.result()
                    pending = [f for f in pending if not f.done()]
            for f in pending:
                f.result()

    # backward-compatible single-case form
    def predict_case_to_class_files(self, image_files, output_folder: str,
                                    apply_largest_component: bool = False) -> None:
        self.predict_cases_to_class_folders(
            [image_files], [output_folder],
            apply_largest_component=apply_largest_component)


def jhu_predict_entry(argv: Optional[Sequence[str]] = None) -> None:
    """CLI matching the reference's __main__ (ref JHU_inference.py:150-197):
    <input_dir>/<case>/ct.nii.gz -> <output_dir>/<case>/predictions/."""
    parser = argparse.ArgumentParser()
    parser.add_argument("input_dir")
    parser.add_argument("output_dir")
    parser.add_argument("-model", required=True,
                        help="trained model folder (contains fold_all or folds)")
    parser.add_argument("-f", nargs="+", default=("all",))
    parser.add_argument("-chk", default="checkpoint_final.fnnx")
    parser.add_argument("--save_probabilities", action="store_true")
    parser.add_argument("--largest_component", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    predictor = JHUPredictor(tile_step_size=0.5, use_gaussian=True,
                             use_mirroring=True, device=args.device,
                             verbose=False)
    folds = [f if f == "all" else int(f) for f in args.f]
    predictor.initialize_from_trained_model_folder(args.model, folds, args.chk)

    case_ids = subdirs(args.input_dir, join_path=False)
    inputs = [[join(args.input_dir, c, "ct.nii.gz")] for c in case_ids]
    outputs = [join(args.output_dir, c) for c in case_ids]
    predictor.predict_cases_to_class_folders(
        inputs, outputs, save_probabilities=args.save_probabilities,
        apply_largest_component=args.largest_component)


if __name__ == "__main__":
    jhu_predict_entry()
