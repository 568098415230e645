"""FastnnUNetInferencer — the port of
fast_nnunet_tpu/fast_inference/inferencer.py: config-driven inference from an
exported artifact (export/export_model.py, ``model.pt2``) or a trained model
folder. The documented pipeline (reference docs/Inference.md:118-147):
reorient -> resample -> window/normalize -> sliding window (+- mirroring) ->
postprocessing -> save with the original geometry.

The device part is the port's ``SlidingWindowEngine.predict_logits`` on
``device`` (``cuda`` unless the caller passes ``"cpu"``); the host steps are
the numpy/scipy code of the JAX module. Eager PyTorch compiles nothing, so
the JAX module's persistent compile cache has no counterpart here.
"""
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..imageio.nifti import NiftiIOWithReorient
# registers fnn_torch::instance_norm, which an exported network holds
from ..models import blocks as _blocks  # noqa: F401
from ..ops.cropping import crop_to_nonzero
from ..ops.normalization import get_normalization_scheme_by_class_name
from ..ops.resampling import compute_new_shape, resample_data_or_seg_to_shape
from ..postprocessing.connected_components import \
    remove_all_but_largest_component_from_segmentation
from ..utils.io import join, maybe_mkdir_p, subfiles
from .config_manager import ConfigManager


class _ArtifactNetwork:
    """An exported ``model.pt2`` as the tile network the engine calls:
    (B, C, *patch) in, logits out, the input cast to the export dtype. The
    program's constants live on the device it was exported on, so it runs
    there or raises."""

    def __init__(self, artifact_path: str, exported_on: str,
                 device: torch.device, in_dtype: torch.dtype):
        if torch.device(exported_on).type != device.type:
            raise ValueError(
                f"{artifact_path} was exported on {exported_on!r} and "
                f"cannot serve on {str(device)!r}: export it again with "
                f"fast_nnunet_export_model_torch --device {device.type}")
        self.module = torch.export.load(artifact_path).module()
        self.in_dtype = in_dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.module(x.to(self.in_dtype))


class FastnnUNetInferencer:
    def __init__(self, config_file: Optional[str] = None,
                 model_folder: Optional[str] = None,
                 folds=None, tile_step_size: Optional[float] = None,
                 use_mirroring: Optional[bool] = None,
                 verbose: bool = False, device=None):
        self.device = resolve_device(device)
        self.verbose = verbose
        self.config: Optional[ConfigManager] = None
        self.engine = None
        self.predictor = None
        self._params = None
        self._model_info = {}
        #: host seconds per step of the last predict_single_image (the
        #: artifact route's steps, postprocessing, VTK)
        self.timings: dict = {}
        if config_file is not None:
            self.load_model(config_file, tile_step_size, use_mirroring)
        elif model_folder is not None:
            self.load_model_folder(model_folder, folds, tile_step_size,
                                   use_mirroring)

    # ------------------------------------------------------------------ loading
    def load_model(self, config_file: str, tile_step_size=None,
                   use_mirroring=None) -> None:
        """Load from a per-model JSON config + exported artifact."""
        from ..export.export_model import FRAMEWORK
        from ..inference.engine import SlidingWindowEngine
        cfg = ConfigManager(config_file)
        if cfg.config.get("framework", FRAMEWORK) != FRAMEWORK or \
                not cfg.model_path.endswith(".pt2"):
            raise ValueError(
                f"{config_file} describes {cfg.model_path!r} "
                f"({cfg.config.get('framework')}), not a torch.export "
                "artifact: a JAX StableHLO export cannot be loaded without "
                "JAX; export the model folder with "
                "fast_nnunet_export_model_torch")
        compute_dtype = getattr(torch, cfg.compute_dtype)
        network = _ArtifactNetwork(cfg.model_path,
                                   cfg.config.get("device", "cuda"),
                                   self.device, compute_dtype)
        num_classes = cfg.num_classes or (len(cfg.labels) if cfg.labels else None)
        assert num_classes, "config must specify num_classes or labels"
        mirroring = cfg.use_mirroring if use_mirroring is None else use_mirroring
        # artifacts exported with --tta already average flips inside the
        # traced computation: never flip again at the engine level
        if cfg.mirroring_baked_into_artifact:
            mirroring = False
        self.engine = SlidingWindowEngine(
            network, cfg.patch_size, num_classes,
            tile_step_size=tile_step_size or cfg.tile_step_size,
            use_gaussian=cfg.use_gaussian,
            mirror_axes=cfg.mirror_axes if mirroring else (),
            compute_dtype=compute_dtype,
            # artifacts have a FIXED batch dim (export -b, default 8): feed
            # exactly that many patches per call, padding short batches
            tile_batch=cfg.tile_batch, pad_to_tile_batch=True,
            device=self.device)
        self._params = [{}]  # weights are baked into the artifact
        self.config = cfg
        self._model_info = {"source": "artifact", "config_file": config_file,
                            "model_path": cfg.model_path,
                            "patch_size": list(cfg.patch_size),
                            "num_classes": num_classes}

    def load_model_folder(self, model_folder: str, folds=None,
                          tile_step_size=None, use_mirroring=None) -> None:
        """Load from a trained results folder (full predictor path), its
        tiles in full batches as on the artifact route."""
        from ..inference.predictor import NNUNetPredictor
        predictor = NNUNetPredictor(
            tile_step_size=tile_step_size or 0.5,
            use_mirroring=bool(use_mirroring) if use_mirroring is not None else False,
            device=self.device, verbose=self.verbose)
        predictor.initialize_from_trained_model_folder(model_folder, folds)
        # feed the network the artifact route's fixed tile batches: cuDNN
        # picks its convolution algorithm by shape, so on the card a tile's
        # bf16 logits depend on the size of its batch (a chunk of 4 tiles
        # against 4 + 4 padded); with the same batches both routes give the
        # same logits
        predictor.engine.pad_to_tile_batch = True
        self.predictor = predictor
        self._model_info = {"source": "model_folder", "model_folder": model_folder,
                            "patch_size": predictor.configuration_manager.patch_size,
                            "num_classes":
                                predictor.label_manager.num_segmentation_heads}

    def get_model_info(self) -> dict:
        return dict(self._model_info)

    def predict_logits_from_preprocessed(self, data: np.ndarray) -> np.ndarray:
        """(C, *spatial) already-preprocessed volume -> logits (K, *spatial).
        The /predict_array serving endpoint (and the C++ engine) hit this."""
        if self.engine is not None:
            return self.engine.predict_logits(self._params, data)
        assert self.predictor is not None, "no model loaded"
        return self.predictor.predict_logits_from_preprocessed_data(data)

    # ------------------------------------------------------------------ predict
    def predict_single_image(self, input_file: str, output_file: str,
                             save_probabilities: bool = False,
                             largest_component_postprocessing: bool = False,
                             generate_vtk: bool = False,
                             vtk_output_file: Optional[str] = None,
                             color_file: Optional[str] = None,
                             smoothing_factor: float = 0.5,
                             decimation_factor: float = 0.2) -> dict:
        t0 = time.time()
        self.timings = {}
        if self.predictor is not None:
            seg, props, rw = self._predict_via_predictor(input_file, output_file,
                                                         save_probabilities)
        else:
            seg, props, rw = self._predict_via_artifact(input_file, output_file)

        if largest_component_postprocessing:
            t1 = time.perf_counter()
            fg = sorted(set(np.unique(seg).tolist()) - {0})
            seg = remove_all_but_largest_component_from_segmentation(seg, fg)
            # same reader-writer that produced the original output: geometry
            # (and any reorientation restore) stays consistent
            rw.write_seg(seg, output_file, props)
            self.timings["postprocess_s"] = time.perf_counter() - t1

        result = {"input": input_file, "output": output_file,
                  "seconds": round(time.time() - t0, 3),
                  "labels_present": sorted(int(x) for x in np.unique(seg))}
        if generate_vtk:
            from .vtk_export import VTKModelGenerator
            t1 = time.perf_counter()
            vtk_file = vtk_output_file or os.path.splitext(
                output_file.replace(".nii.gz", ""))[0] + ".vtk"
            gen = VTKModelGenerator(color_file=color_file)
            gen.generate_vtk_model(seg, props.get("spacing", (1, 1, 1)), vtk_file,
                                   smoothing_factor=smoothing_factor,
                                   decimation_factor=decimation_factor)
            result["vtk_model"] = vtk_file
            self.timings["vtk_s"] = time.perf_counter() - t1
        return result

    def _predict_via_predictor(self, input_file, output_file, save_probabilities):
        out_trunc = output_file
        fe = self.predictor.dataset_json["file_ending"]
        if out_trunc.endswith(fe):
            out_trunc = out_trunc[: -len(fe)]
        self.predictor.predict_from_files([[input_file]], [out_trunc],
                                          save_probabilities=save_probabilities)
        rw = self.predictor.plans_manager.image_reader_writer_class()()
        seg, props = rw.read_seg(out_trunc + fe)
        return seg[0], props, rw

    def _predict_via_artifact(self, input_file: str, output_file: str):
        """Documented pipeline (docs/Inference.md:118-147) on the artifact path:
        reorient-to-canonical -> transpose -> crop -> normalize -> resample ->
        sliding window -> resample back -> argmax -> uncrop -> untranspose ->
        restore original orientation -> save. Host seconds per step go to
        ``self.timings``.

        The reference's documented step 1 is LPS canonicalization (ref
        docs/Inference.md:118-147, simpleitk_reader_writer.py:132-231); using a
        plain reader here would silently segment a non-canonically-stored NIfTI
        in voxel order against a canonically-trained model."""
        cfg = self.config
        t = {}
        clock = [time.perf_counter()]

        def lap(name):
            now = time.perf_counter()
            t[name] = now - clock[0]
            clock[0] = now

        rw = NiftiIOWithReorient()
        data, props = rw.read_images([input_file])
        lap("read_s")

        tf = cfg.transpose_forward
        data = data.transpose([0, *[i + 1 for i in tf]])
        original_spacing = [props["spacing"][i] for i in tf]
        shape_before_crop = data.shape[1:]
        data, seg_mask, bbox = crop_to_nonzero(data)
        shape_after_crop = data.shape[1:]

        for c in range(data.shape[0]):
            scheme = cfg.normalization_schemes[min(c, len(cfg.normalization_schemes) - 1)]
            cls = get_normalization_scheme_by_class_name(scheme)
            ip = cfg.intensity_properties.get(str(c), next(iter(
                cfg.intensity_properties.values())))
            data[c] = cls(use_mask_for_norm=False, intensityproperties=ip).run(
                data[c], seg_mask[0])
        lap("crop_normalize_s")

        new_shape = compute_new_shape(shape_after_crop, original_spacing,
                                      cfg.target_spacing)
        data = resample_data_or_seg_to_shape(data, new_shape, original_spacing,
                                             cfg.target_spacing, is_seg=False,
                                             order=3, order_z=0,
                                             force_separate_z=None)
        lap("resample_in_s")

        logits = self.engine.predict_logits(self._params, data)
        lap("sliding_window_s")
        logits = resample_data_or_seg_to_shape(
            logits, shape_after_crop, cfg.target_spacing, original_spacing,
            is_seg=False, order=1, order_z=0, force_separate_z=None)
        lap("resample_back_s")
        seg_cropped = logits.argmax(0).astype(np.uint8)
        del logits
        lap("argmax_s")

        seg = np.zeros(shape_before_crop, np.uint8)
        seg[tuple(slice(b[0], b[1]) for b in bbox)] = seg_cropped
        seg = seg.transpose(cfg.transpose_backward)
        rw.write_seg(seg, output_file, props)
        lap("write_s")
        self.timings.update(t)
        return seg, props, rw

    def predict_batch(self, input_folder: str, output_folder: str,
                      pattern_suffix: str = ".nii.gz", **kwargs) -> List[dict]:
        maybe_mkdir_p(output_folder)
        results = []
        for f in subfiles(input_folder, suffix=pattern_suffix, join_path=False):
            out = join(output_folder, f)
            results.append(self.predict_single_image(join(input_folder, f), out,
                                                     **kwargs))
        return results
