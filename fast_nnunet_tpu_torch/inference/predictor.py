"""``NNUNetPredictor`` — the port of fast_nnunet_tpu/inference/predictor.py:
restore a trained model folder (plans.json + dataset.json + fold
checkpoints) and run file-to-file or array inference.

Host work (read, preprocess, export, write) is the numpy/scipy code copied
from the JAX package; the device part is the port's
:class:`~.engine.SlidingWindowEngine` ``predict_logits`` on the card, folds
ensembled and mirror TTA averaged in every tile forward. Runs on ``cuda``
unless the caller passes ``device="cpu"``.

Ported: 2D and 3D ``PlainConvUNet`` and ``ResidualEncoderUNet``
checkpoints (a 2D network predicts a 3D volume slice by slice, the engine's
2D-over-slices), their distilled students (LiteNNUNetStudent,
LiteResEncStudent), BatchNorm networks (``NNUNetTrainerBN``: a checkpoint
whose weights carry ``batch_stats`` is rebuilt with BatchNorm and predicts
with its running averages) and the cascade's second stage: the previous
stage's segmentation of each case (``folder_with_segs_from_prev_stage``,
``{ident}{file_ending}``) rides the seg path of the preprocessor, so it
shares the image's crop, skips intensity normalisation and is resampled
label-safely, and enters the network as one one-hot channel per foreground
label. A checkpoint whose ``init_args`` carry ``primus_arch`` (a Primus
trainer's) is rebuilt as that ``Primus`` at the plans' patch and predicts
through the same sliding window.
"""
import os
import queue
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.labels import (convert_labelmap_to_one_hot,
                           determine_num_input_channels)
from ..core.plans import PlansManager
from ..device import resolve_device
from ..models.factory import build_network_from_arch_dict, with_batch_norm
from ..models.primus import Primus
from ..models.students import build_lite_student
from ..preprocessing.preprocessor import DefaultPreprocessor
from ..training.checkpoint import load_checkpoint
from ..utils.dataset_io import get_identifiers_from_splitted_dataset_folder
from ..utils.io import (isfile, join, load_json, maybe_mkdir_p, save_json,
                        subdirs)
from .engine import SlidingWindowEngine
from .export import (
    convert_predicted_logits_to_segmentation_with_correct_shape,
    export_prediction_from_logits)


def network_for_checkpoint(plans_manager: PlansManager, dataset_json: dict,
                           checkpoint: dict, compute_dtype: torch.dtype):
    """(network, configuration manager) of a checkpoint, the network rebuilt
    as the checkpoint's trainer built it (no weights loaded): a distilled
    student at its reduced widths, a Primus from ``primus_arch`` (drop path
    0.2, LayerScale 0.1, the plans' patch), BatchNorm where the
    weights carry ``batch_stats``. The predictor and the exporter both
    build through it."""
    init_args = checkpoint.get("init_args") or {}
    trainer_name = checkpoint.get("trainer_name", "NNUNetTrainer")
    configuration_manager = plans_manager.get_configuration(
        init_args.get("configuration", "3d_fullres"))
    num_input_channels = determine_num_input_channels(
        plans_manager, configuration_manager, dataset_json)
    k = plans_manager.get_label_manager(dataset_json).num_segmentation_heads
    arch = configuration_manager.configuration["architecture"]
    if "batch_stats" in checkpoint["network_weights"]:
        arch = with_batch_norm(arch)
    if trainer_name and "Distillation" in trainer_name:
        network = build_lite_student(
            arch["network_class_name"], arch["arch_kwargs"],
            num_input_channels, k,
            init_args.get("feature_reduction_factor", 2),
            init_args.get("block_reduction_strategy", "reduce"),
            compute_dtype=compute_dtype)
    elif init_args.get("primus_arch"):
        pa = init_args["primus_arch"]
        network = Primus(
            input_channels=num_input_channels,
            embed_dim=int(pa["embed_dim"]),
            patch_embed_size=tuple(int(p) for p in pa["patch_embed_size"]),
            num_classes=k, depth=int(pa["depth"]),
            num_heads=int(pa["num_heads"]),
            patch_size=tuple(configuration_manager.patch_size),
            drop_path_rate=0.2, init_values=0.1, compute_dtype=compute_dtype)
    else:
        network = build_network_from_arch_dict(
            arch, num_input_channels, k, compute_dtype)
    return network, configuration_manager


class NNUNetPredictor:
    """compute_dtype: the network's convolution dtype and the tiles' dtype
    (the JAX predictor builds its network in bfloat16). The sweep always
    runs on ``device``: the JAX predictor's ``perform_everything_on_device``
    and ``allow_tqdm`` options are not taken."""

    def __init__(self, tile_step_size: float = 0.5, use_gaussian: bool = True,
                 use_mirroring: bool = True, device=None,
                 verbose: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.tile_step_size = tile_step_size
        self.use_gaussian = use_gaussian
        self.use_mirroring = use_mirroring
        self.device = resolve_device(device)
        self.verbose = verbose
        self.compute_dtype = compute_dtype

        self.plans_manager: Optional[PlansManager] = None
        self.configuration_manager = None
        self.dataset_json = None
        self.label_manager = None
        self.network = None
        self.list_of_parameters: List = []
        self.allowed_mirroring_axes: Tuple[int, ...] = ()
        self.trainer_name = None
        self.engine: Optional[SlidingWindowEngine] = None

    # --------------------------------------------------------------- restore
    @staticmethod
    def auto_detect_available_folds(model_training_output_dir: str,
                                    checkpoint_name: str) -> List[int]:
        folds = [int(d.split("_")[-1]) for d in
                 subdirs(model_training_output_dir, prefix="fold_",
                         join_path=False)
                 if d != "fold_all" and
                 isfile(join(model_training_output_dir, d, checkpoint_name))]
        assert folds, f"no usable folds in {model_training_output_dir}"
        return sorted(folds)

    def initialize_from_trained_model_folder(
            self, model_training_output_dir: str,
            use_folds: Union[None, Sequence[Union[int, str]]] = None,
            checkpoint_name: str = "checkpoint_final.fnnx") -> None:
        if use_folds is None:
            use_folds = self.auto_detect_available_folds(
                model_training_output_dir, checkpoint_name)
        if isinstance(use_folds, (int, str)):
            use_folds = [use_folds]
        dataset_json = load_json(join(model_training_output_dir,
                                      "dataset.json"))
        plans_manager = PlansManager(join(model_training_output_dir,
                                          "plans.json"))
        parameters, first = [], None
        for f in use_folds:
            f = int(f) if f != "all" else f
            ckpt = load_checkpoint(join(model_training_output_dir,
                                        f"fold_{f}", checkpoint_name))
            first = first or ckpt
            parameters.append(ckpt["network_weights"])
        network, configuration_manager = network_for_checkpoint(
            plans_manager, dataset_json, first, self.compute_dtype)
        self.manual_initialization(
            network, plans_manager, configuration_manager, parameters,
            dataset_json, first.get("trainer_name", "NNUNetTrainer"),
            first.get("inference_allowed_mirroring_axes"))

    def manual_initialization(self, network, plans_manager,
                              configuration_manager, parameters: List,
                              dataset_json: dict, trainer_name: str,
                              inference_allowed_mirroring_axes) -> None:
        """network: a port U-Net (models/unet.py); parameters: one
        JAX-layout tree per fold (numpy arrays), loaded into the network and
        its fold copies by the engine."""
        self.network = network.to(self.device)
        self.plans_manager = plans_manager
        self.configuration_manager = configuration_manager
        self.list_of_parameters = list(parameters)
        self.dataset_json = dataset_json
        self.trainer_name = trainer_name
        self.allowed_mirroring_axes = tuple(
            inference_allowed_mirroring_axes or ())
        self.label_manager = plans_manager.get_label_manager(dataset_json)
        mirror = self.allowed_mirroring_axes if self.use_mirroring else ()
        self.engine = SlidingWindowEngine(
            self.network, configuration_manager.patch_size,
            self.label_manager.num_segmentation_heads,
            tile_step_size=self.tile_step_size,
            use_gaussian=self.use_gaussian, mirror_axes=mirror,
            compute_dtype=self.compute_dtype, device=self.device)

    # -------------------------------------------------------------- file API
    def _manage_input_and_output_lists(self, list_of_lists_or_source_folder,
                                       output_folder_or_list,
                                       folder_with_segs_from_prev_stage=None,
                                       overwrite: bool = True,
                                       part_id: int = 0, num_parts: int = 1):
        """(input file lists, truncated output files, previous-stage
        segmentation files or None per case)."""
        fe = self.dataset_json["file_ending"]
        if isinstance(list_of_lists_or_source_folder, str):
            idents = get_identifiers_from_splitted_dataset_folder(
                list_of_lists_or_source_folder, fe)
            num_channels = len(self.dataset_json.get(
                "channel_names", self.dataset_json.get("modality")))
            list_of_lists = [
                [join(list_of_lists_or_source_folder, f"{i}_{c:04d}{fe}")
                 for c in range(num_channels)] for i in idents]
        else:
            list_of_lists = list_of_lists_or_source_folder
            idents = [os.path.basename(x[0])[:-(len(fe) + 5)]
                      for x in list_of_lists]
        list_of_lists = list_of_lists[part_id::num_parts]
        idents = idents[part_id::num_parts]
        if isinstance(output_folder_or_list, str):
            output_files = [join(output_folder_or_list, i) for i in idents]
        else:
            output_files = output_folder_or_list
        seg_prev = [join(folder_with_segs_from_prev_stage, i + fe)
                    if folder_with_segs_from_prev_stage is not None else None
                    for i in idents]
        if not overwrite:
            keep = [not isfile(o + fe) for o in output_files]
            list_of_lists = [x for x, k in zip(list_of_lists, keep) if k]
            output_files = [o for o, k in zip(output_files, keep) if k]
            seg_prev = [x for x, k in zip(seg_prev, keep) if k]
        return list_of_lists, output_files, seg_prev

    def predict_from_files(self, list_of_lists_or_source_folder,
                           output_folder_or_list_of_truncated_output_files,
                           save_probabilities: bool = False,
                           overwrite: bool = True,
                           num_processes_preprocessing: int = 3,
                           num_processes_segmentation_export: int = 3,
                           folder_with_segs_from_prev_stage: Optional[str] =
                           None,
                           part_id: int = 0, num_parts: int = 1) -> None:
        """Preprocess (one worker thread) -> logits on the device -> export
        (worker threads), with a bounded queue for backpressure, as the JAX
        predictor does. An output folder also gets the model's
        ``dataset.json`` and ``plans.json``, so that its probabilities
        ensemble with ``fast_nnunet_ensemble_torch`` as they are."""
        self._check_prev_stage(folder_with_segs_from_prev_stage is not None)
        out = output_folder_or_list_of_truncated_output_files
        if isinstance(out, str):
            maybe_mkdir_p(out)
            save_json({
                "input": str(list_of_lists_or_source_folder),
                "output": out,
                "save_probabilities": save_probabilities,
                "overwrite": overwrite,
                "tile_step_size": self.tile_step_size,
                "use_gaussian": self.use_gaussian,
                "use_mirroring": self.use_mirroring,
                "mirror_axes": list(self.allowed_mirroring_axes),
                "trainer_name": self.trainer_name,
                "num_folds": len(self.list_of_parameters),
                "prev_stage": folder_with_segs_from_prev_stage,
                "device": str(self.device),
            }, join(out, "predict_from_raw_data_args.json"), sort_keys=False)
            # what fast_nnunet_ensemble_torch reads from its first input
            # folder (the reference's nnUNetv2_predict writes them too)
            save_json(self.dataset_json, join(out, "dataset.json"),
                      sort_keys=False)
            save_json(self.plans_manager.plans, join(out, "plans.json"),
                      sort_keys=False)
        lists, out_files, seg_prev = self._manage_input_and_output_lists(
            list_of_lists_or_source_folder, out,
            folder_with_segs_from_prev_stage, overwrite, part_id, num_parts)
        if not lists:
            return
        preproc = DefaultPreprocessor(verbose=self.verbose)
        work_q: "queue.Queue" = queue.Queue(maxsize=2)

        def producer():
            try:
                for img_files, out_file, prev in zip(lists, out_files,
                                                     seg_prev):
                    data, seg, props = preproc.run_case(
                        img_files, prev, self.plans_manager,
                        self.configuration_manager, self.dataset_json)
                    if prev is not None:
                        data = self._stack_prev_stage_onehot(data, seg)
                    work_q.put((data, props, out_file))
                work_q.put(None)
            except Exception as e:  # handed to the consumer, re-raised there
                work_q.put(e)

        threading.Thread(target=producer, daemon=True).start()
        export_threads: List[threading.Thread] = []
        errors: list = []

        def export(*args):
            try:
                export_prediction_from_logits(*args)
            except Exception as e:
                errors.append(e)

        while True:
            item = work_q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            data, props, out_file = item
            logits = self.predict_logits_from_preprocessed_data(data)
            th = threading.Thread(target=export, daemon=True, args=(
                logits, props, self.configuration_manager,
                self.plans_manager, self.dataset_json, out_file,
                save_probabilities))
            th.start()
            export_threads.append(th)
            while sum(x.is_alive() for x in export_threads) > \
                    num_processes_segmentation_export:
                export_threads[0].join(timeout=0.5)
        for th in export_threads:
            th.join()
        if errors:
            raise errors[0]

    def _check_prev_stage(self, given: bool) -> None:
        """A cascade stage needs the previous stage's segmentation, any
        other configuration takes none."""
        cascade = self.configuration_manager.previous_stage_name is not None
        if given != cascade:
            raise ValueError(
                f"configuration with previous stage "
                f"{self.configuration_manager.previous_stage_name!r}: the "
                f"previous stage's segmentation was "
                f"{'given' if given else 'not given'}")

    def _stack_prev_stage_onehot(self, data: np.ndarray,
                                 seg_prev: np.ndarray) -> np.ndarray:
        """Cascade: append the one-hot previous-stage channels. ``seg_prev``
        is the (1, *S) seg that ``run_case`` / ``run_case_npy`` return:
        already cropped to the image's box and resampled label-safely."""
        onehot = convert_labelmap_to_one_hot(
            seg_prev[0], self.label_manager.foreground_labels, data.dtype)
        return np.vstack([data, onehot])

    # ---------------------------------------------------------------- arrays
    def predict_logits_from_preprocessed_data(self, data: np.ndarray
                                              ) -> np.ndarray:
        """(C, *spatial) preprocessed -> fold-ensembled logits (K,
        *spatial), float32 on the host."""
        return self.engine.predict_logits(self.list_of_parameters, data)

    def predict_single_npy_array(self, input_image: np.ndarray,
                                 image_properties: dict,
                                 segmentation_previous_stage:
                                 Optional[np.ndarray] = None,
                                 output_file_truncated: Optional[str] = None,
                                 save_or_return_probabilities: bool = False):
        """(C, X, Y, Z) raw array + {'spacing': ...} -> segmentation in the
        original geometry (or written to ``output_file_truncated``). A
        cascade stage takes the previous stage's segmentation ((X, Y, Z) or
        (1, X, Y, Z)) on the raw grid."""
        self._check_prev_stage(segmentation_previous_stage is not None)
        seg_in = None
        if segmentation_previous_stage is not None:
            # signed: crop_to_nonzero labels the voxels outside the mask -1
            seg_in = np.asarray(segmentation_previous_stage).astype(
                np.int16, copy=False)
            if seg_in.ndim == input_image.ndim - 1:
                seg_in = seg_in[None]
        data, seg, props = DefaultPreprocessor(verbose=self.verbose
                                               ).run_case_npy(
            input_image, seg_in, dict(image_properties), self.plans_manager,
            self.configuration_manager, self.dataset_json)
        if seg_in is not None:
            data = self._stack_prev_stage_onehot(data, seg)
        logits = self.predict_logits_from_preprocessed_data(data)
        if output_file_truncated is not None:
            export_prediction_from_logits(
                logits, props, self.configuration_manager, self.plans_manager,
                self.dataset_json, output_file_truncated,
                save_or_return_probabilities)
            return None
        return convert_predicted_logits_to_segmentation_with_correct_shape(
            logits, self.plans_manager, self.configuration_manager,
            self.label_manager, props,
            return_probabilities=save_or_return_probabilities)
