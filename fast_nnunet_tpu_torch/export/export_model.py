"""Deployable model export — the port of fast_nnunet_tpu/export/export_model.py.

Where the JAX package writes a StableHLO artifact through ``jax.export``,
the port writes a ``torch.export`` program, ``model.pt2``: the network's
evaluation forward (no deep supervision) at a fixed input ``(B, C, *patch)``
in the export dtype, weights baked in and, with ``--tta``, the flips-average
over the training mirror axes traced in. Beside it goes the JSON sidecar
``model_config.json`` with the JAX sidecar's keys (patch, spacing,
normalization, labels...), which ``fast_inference`` reads. Its differences:
``framework``, ``artifact``, ``input_layout`` (channels-first) and
``input_shape`` in that layout, and ``device``, the device the program was
exported on: an ``ExportedProgram`` records the device of its constants, so
the artifact serves on that device only.

The native artifact (``aoti=True``, ``--aoti`` on the three CLIs):
``model_aoti.pt2`` beside ``model.pt2``, the AOTInductor package of the same
``ExportForward`` at the same input shape (inference/aot.py's compile), which
the engine's in-process backend (``engine/src/aoti_backend.cpp``) loads with
libtorch. It is the counterpart of the JAX exporter's ``model_pjrt.mlir``:
the sidecar names it as ``aoti_artifact`` (JAX: ``pjrt_artifact``), with its
device as ``aoti_device``; it runs on that device only. Unlike JAX's, which
it always writes, it is opt-in: the compile costs about a minute on a CPU
for a small network, where ``torch.export`` takes seconds.

The network is rebuilt as the port's predictor builds it
(``inference.predictor.network_for_checkpoint``: students, BatchNorm with
its running averages in evaluation mode); a Primus checkpoint raises
``NotImplementedError``, as the JAX exporter cannot export one either (it
builds the plans' CNN and fails to restore). Validation reloads the artifact
and holds it against the native forward: max relative deviation <= 1e-2,
else it raises; the native artifact is reloaded and held the same way.
"""
import argparse
import itertools
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.labels import determine_num_input_channels
from ..core.plans import PlansManager
from ..device import resolve_device
from ..inference.aot import compile_package, load_package
from ..inference.predictor import network_for_checkpoint
from ..models.unet import params_from_jax
from ..training.checkpoint import load_checkpoint
from ..utils.io import join, load_json, maybe_mkdir_p, save_json
from ..utils.misc import get_output_folder

ARTIFACT = "model.pt2"
AOTI_ARTIFACT = "model_aoti.pt2"
FRAMEWORK = "fast-nnunet-tpu-torch"


class ExportForward(nn.Module):
    """The exported computation: ``network``'s evaluation forward and, with
    mirror axes, the average over every subset of them of flip -> forward
    -> flip back (JAX export_model.py:80-98, the same order of sums)."""

    def __init__(self, network: nn.Module, mirror_axes: Sequence[int] = ()):
        super().__init__()
        self.network = network
        self.mirror_axes = tuple(int(a) for a in mirror_axes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.mirror_axes:
            return self.network(x)
        combos = [c for r in range(len(self.mirror_axes) + 1)
                  for c in itertools.combinations(self.mirror_axes, r)]
        acc = None
        for combo in combos:
            dims = tuple(a + 2 for a in combo)
            out = self.network(torch.flip(x, dims) if combo else x)
            out = torch.flip(out, dims) if combo else out
            acc = out if acc is None else acc + out
        return acc / len(combos)


def export_model_folder_to_artifact(
        model_training_output_dir: str, fold, output_folder: str,
        checkpoint_name: str = "checkpoint_final.fnnx",
        batch_size: int = 8,
        validate: bool = True,
        dtype: str = "bfloat16",
        bake_mirroring: bool = False,
        device=None, stats: Optional[dict] = None,
        aoti: bool = False) -> str:
    """Export one fold of a trained model folder to
    <output_folder>/{model.pt2, model_config.json} on ``device`` (``cuda``
    unless the caller passes ``"cpu"``), and with ``aoti`` also the native
    artifact ``model_aoti.pt2``. Returns the artifact's path. A ``stats``
    dict given gets the export's and the validation's seconds
    (``export_s``, ``validate_s``) and the validation's ``max_rel``; with
    ``aoti`` also ``aoti_s``, ``aoti_validate_s`` and ``aoti_max_rel``."""
    dev = resolve_device(device)
    dataset_json = load_json(join(model_training_output_dir, "dataset.json"))
    plans_manager = PlansManager(join(model_training_output_dir, "plans.json"))
    ckpt = load_checkpoint(join(model_training_output_dir, f"fold_{fold}",
                                checkpoint_name))
    init_args = ckpt.get("init_args") or {}
    if init_args.get("primus_arch"):
        raise NotImplementedError(
            "a Primus checkpoint (init_args carry primus_arch) is not "
            "exported: the JAX exporter this one follows builds the plans' "
            "CNN for every checkpoint, so it cannot restore a Primus either")
    configuration_name = init_args.get("configuration", "3d_fullres")
    compute_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    network, cfg = network_for_checkpoint(plans_manager, dataset_json, ckpt,
                                          compute_dtype)
    params_from_jax(network, ckpt["network_weights"])
    network.to(dev).eval()  # BatchNorm: its running averages
    num_in = determine_num_input_channels(plans_manager, cfg, dataset_json)
    num_out = plans_manager.get_label_manager(
        dataset_json).num_segmentation_heads
    patch = tuple(cfg.patch_size)
    mirror_axes = tuple(ckpt.get("inference_allowed_mirroring_axes") or []) \
        if bake_mirroring else ()
    forward = ExportForward(network, mirror_axes).eval()

    in_shape = (batch_size, num_in, *patch)
    t0 = time.perf_counter()
    with torch.no_grad():
        exported = torch.export.export(
            forward, (torch.zeros(in_shape, dtype=compute_dtype, device=dev),))
    maybe_mkdir_p(output_folder)
    artifact_path = join(output_folder, ARTIFACT)
    torch.export.save(exported, artifact_path)
    stats = {} if stats is None else stats
    stats["export_s"] = time.perf_counter() - t0
    if aoti:
        t0 = time.perf_counter()
        compile_package(exported, join(output_folder, AOTI_ARTIFACT))
        stats["aoti_s"] = time.perf_counter() - t0

    trainer_name = ckpt.get("trainer_name", "NNUNetTrainer")
    meta = {
        "framework": FRAMEWORK,
        "artifact": ARTIFACT,
        "input_layout": "B * C * spatial (channels-first)",
        "input_shape": list(in_shape),
        "compute_dtype": dtype,
        "device": str(dev),
        "patch_size": list(patch),
        "target_spacing": cfg.spacing,
        "transpose_forward": plans_manager.transpose_forward,
        "transpose_backward": plans_manager.transpose_backward,
        "normalization_schemes": cfg.normalization_schemes,
        "intensity_properties":
            plans_manager.foreground_intensity_properties_per_channel,
        "num_classes": num_out,
        "labels": dataset_json["labels"],
        "regions_class_order": dataset_json.get("regions_class_order"),
        "file_ending": dataset_json.get("file_ending", ".nii.gz"),
        "tile_step_size": 0.5,
        "use_gaussian": True,
        "use_mirroring": bool(mirror_axes),
        # True = flips-average already traced into the artifact: consumers
        # must NOT add their own test-time mirroring on top
        "mirroring_baked_into_artifact": bool(mirror_axes),
        "inference_allowed_mirroring_axes":
            list(ckpt.get("inference_allowed_mirroring_axes") or []),
        "trainer_name": trainer_name,
        "configuration": configuration_name,
        "fold": fold,
    }
    if aoti:
        meta["aoti_artifact"] = AOTI_ARTIFACT
        meta["aoti_device"] = str(dev)
    save_json(meta, join(output_folder, "model_config.json"), sort_keys=False)

    if validate:
        t0 = time.perf_counter()
        rel = validate_exported_artifact(artifact_path, forward, in_shape,
                                         compute_dtype, dev)
        stats.update(validate_s=time.perf_counter() - t0, max_rel=rel)
        print(f"Export validation: max relative deviation {rel:.2e}")
        if aoti:
            t0 = time.perf_counter()
            rel = validate_exported_artifact(
                join(output_folder, AOTI_ARTIFACT), forward, in_shape,
                compute_dtype, dev, load=load_package)
            stats.update(aoti_validate_s=time.perf_counter() - t0,
                         aoti_max_rel=rel)
            print(f"Native artifact validation: max relative deviation "
                  f"{rel:.2e}")
    print(f"Exported fold {fold} -> {artifact_path}")
    return artifact_path


def validate_exported_artifact(artifact_path: str, reference_fn: Callable,
                               input_shape: Sequence[int],
                               compute_dtype: torch.dtype, device,
                               load: Optional[Callable] = None) -> float:
    """Reload the artifact and compare it with the native forward closure,
    baked-in mirroring included, on a seeded input (JAX :157-176): returns
    the max deviation relative to the reference's largest magnitude and
    raises above 1e-2. ``load`` (default: ``torch.export.load``'s module)
    turns the path into the callable; the native artifact passes
    ``inference.aot.load_package``."""
    restored = load(artifact_path) if load is not None \
        else torch.export.load(artifact_path).module()
    x = np.random.RandomState(0).rand(*input_shape).astype(np.float32) - 0.5
    xa = torch.from_numpy(x).to(device, compute_dtype)
    with torch.no_grad():
        got = restored(xa).float()
        want = reference_fn(xa).float()
    rel = float((got - want).abs().max() / (want.abs().max() + 1e-6))
    if not rel <= 1e-2:
        raise RuntimeError(f"Exported artifact deviates from native forward "
                           f"(max rel {rel:.3e})")
    return rel


def export_entry(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="export a trained (distilled) model to a torch.export "
                    "artifact (model.pt2 + model_config.json)")
    parser.add_argument("-d", required=True, help="dataset name or id")
    parser.add_argument("-f", type=int, default=0, help="fold")
    parser.add_argument("-c", default="3d_fullres")
    parser.add_argument("-tr", default="NNUNetDistillationTrainer")
    parser.add_argument("-p", default="nnUNetPlans")
    parser.add_argument("-o", default=None, help="output folder")
    parser.add_argument("-chk", default="checkpoint_final.fnnx")
    parser.add_argument("-b", type=int, default=8,
                        help="tile batch size baked into the artifact (the "
                             "serving engine reads it from input_shape)")
    parser.add_argument("--no_validate", action="store_true")
    parser.add_argument("--tta", action="store_true",
                        help="bake mirror-TTA (flips-average over the "
                             "training mirror axes) into the artifact")
    parser.add_argument("--device", default=None,
                        help="device to export on and serve from: cuda "
                             "(default) or cpu")
    parser.add_argument("--aoti", action="store_true",
                        help="also write the native artifact "
                             "model_aoti.pt2 (an AOTInductor package for "
                             "the engine's in-process backend; compiling "
                             "takes about a minute)")
    args = parser.parse_args(argv)
    model_folder = get_output_folder(args.d, args.tr, args.p, args.c)
    out = args.o or join(model_folder, f"fold_{args.f}", "export")
    export_model_folder_to_artifact(model_folder, args.f, out, args.chk, args.b,
                                    not args.no_validate,
                                    bake_mirroring=args.tta,
                                    device=args.device, aoti=args.aoti)


# the reference's CLI names map onto the same exporter
distillation_export_entry = export_entry
resenc_distillation_export_entry = export_entry
