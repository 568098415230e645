"""Trainer variants — the port of fast_nnunet_tpu/training/trainer_variants.py:
epoch presets, augmentation variants (NoMirroring, onlyMirror01, NoDA,
NoDummy2D, DAOrd0, DA5 and its order-0 forms), the deep-supervision
toggle, the loss variants (class attribute ``loss_kind``, which the base
trainer hands to its train step), Adam / AdamW / Adan / VanillaAdam with
their learning-rate presets, warmup and cosine schedules, probabilistic
oversampling, the benchmark trainers and ``NNUNetTrainerBN``. Every class
keeps the JAX package's behaviour, including where it departs from the
reference: the Adam and AdamW trainers run at a fixed 3e-4 whatever their
``initial_lr``, and the ``*DASegOrd0`` names are aliases (the spatial
augmentation already resamples labels with order 0).

The JAX hooks ``_batch_to_device`` / ``get_dataloaders`` are the port's
``batch_to_device`` / ``get_dataloaders``.
"""
import os
import platform
import socket

import numpy as np
import torch

from ..models.factory import build_network_from_arch_dict, with_batch_norm
from ..utils.io import isfile, join, load_json, save_json
from .augment import TrainingAugmenter, ValidationAugmenter
from .augment_da5 import (
    DA5CondensedAugmenter, DA5TrainingAugmenter,
    configure_da5_rotation_dummyDA_mirroring_and_initial_patch_size)
from .optimizers import (nnunet_adam, nnunet_adamw, nnunet_adan, nnunet_sgd,
                         vanilla_adam)
from .schedules import linear_warmup_cosine, linear_warmup_poly, poly_lr
from .trainer import NNUNetTrainer


def _set_attrs(base, name: str, **attrs):
    """A subclass of ``base`` named ``name`` whose constructor sets
    ``attrs`` after the base constructor's."""
    def __init__(self, *a, **kw):
        base.__init__(self, *a, **kw)
        for k, v in attrs.items():
            setattr(self, k, v)
    return type(name, (base,), {"__init__": __init__})


def _epochs_variant(n: int, base=NNUNetTrainer, name=None):
    return _set_attrs(base, name or f"NNUNetTrainer_{n}epochs", num_epochs=n)


# --------------------------------------------------------------- epoch presets
NNUNetTrainer_1epochs = _epochs_variant(1)
NNUNetTrainer_1epoch = NNUNetTrainer_1epochs
NNUNetTrainer_5epochs = _epochs_variant(5)
NNUNetTrainer_10epochs = _epochs_variant(10)
NNUNetTrainer_20epochs = _epochs_variant(20)
NNUNetTrainer_50epochs = _epochs_variant(50)
NNUNetTrainer_100epochs = _epochs_variant(100)
NNUNetTrainer_250epochs = _epochs_variant(250)
NNUNetTrainer_500epochs = _epochs_variant(500)
NNUNetTrainer_750epochs = _epochs_variant(750)
NNUNetTrainer_2000epochs = _epochs_variant(2000)
NNUNetTrainer_4000epochs = _epochs_variant(4000)
NNUNetTrainer_8000epochs = _epochs_variant(8000)


# --------------------------------------------------------------- augmentation
class NNUNetTrainerNoMirroring(NNUNetTrainer):
    """No mirroring in training, none at test time."""

    def _make_training_transform(self, patch_size, rotation, mirror_axes,
                                 dummy_2d, lm, ds_scales):
        self.inference_allowed_mirroring_axes = ()
        return super()._make_training_transform(
            patch_size, rotation, (), dummy_2d, lm, ds_scales)


class NNUNetTrainer_onlyMirror01(NNUNetTrainer):
    """Mirror only the first two spatial axes."""

    def _make_training_transform(self, patch_size, rotation, mirror_axes,
                                 dummy_2d, lm, ds_scales):
        axes = tuple(a for a in mirror_axes if a < 2)
        self.inference_allowed_mirroring_axes = axes
        return super()._make_training_transform(
            patch_size, rotation, axes, dummy_2d, lm, ds_scales)


class NNUNetTrainerNoDA(NNUNetTrainer):
    """The validation transform (centre crop) in training."""

    def _make_training_transform(self, patch_size, rotation, mirror_axes,
                                 dummy_2d, lm, ds_scales):
        self.inference_allowed_mirroring_axes = ()
        return ValidationAugmenter(
            patch_size,
            regions=lm.foreground_regions if lm.has_regions else None,
            ignore_label=lm.ignore_label, ds_scales=ds_scales)


class NNUNetTrainerNoDummy2D(NNUNetTrainer):
    """No dummy-2D augmentation on anisotropic patches."""

    def _make_training_transform(self, patch_size, rotation, mirror_axes,
                                 dummy_2d, lm, ds_scales):
        return super()._make_training_transform(
            patch_size, rotation, mirror_axes, False, lm, ds_scales)


class NNUNetTrainerDAOrd0(NNUNetTrainer):
    """Nearest-neighbour (order 0) spatial resampling of the data."""

    def _make_training_transform(self, patch_size, rotation, mirror_axes,
                                 dummy_2d, lm, ds_scales):
        return TrainingAugmenter(
            patch_size, rotation, mirror_axes,
            use_mask_for_norm=self.configuration_manager.use_mask_for_norm,
            dummy_2d=dummy_2d,
            regions=lm.foreground_regions if lm.has_regions else None,
            ignore_label=lm.ignore_label, ds_scales=ds_scales,
            cascade_labels=lm.foreground_labels if self.is_cascaded else None,
            spatial_data_order=0)


class NNUNetTrainerDA5(NNUNetTrainer):
    """The DA5 pipeline (training/augment_da5.py) with its wider initial
    patch; ``FNN_DA5_CONDENSED=1`` takes the condensed variant."""

    def _configure_rotation_dummyDA_mirroring_and_initial_patch_size(
            self, patch_size):
        return configure_da5_rotation_dummyDA_mirroring_and_initial_patch_size(
            patch_size)

    def _make_training_transform(self, patch_size, rotation, mirror_axes,
                                 dummy_2d, lm, ds_scales):
        cls = DA5CondensedAugmenter if os.environ.get(
            "FNN_DA5_CONDENSED", "0") == "1" else DA5TrainingAugmenter
        return cls(
            patch_size, rotation, mirror_axes,
            use_mask_for_norm=self.configuration_manager.use_mask_for_norm,
            dummy_2d=dummy_2d,
            regions=lm.foreground_regions if lm.has_regions else None,
            ignore_label=lm.ignore_label, ds_scales=ds_scales,
            cascade_labels=lm.foreground_labels if self.is_cascaded else None)


class NNUNetTrainerDA5ord0(NNUNetTrainerDA5):
    """DA5 with order-0 spatial resampling of data and labels."""

    def _make_training_transform(self, *args):
        aug = super()._make_training_transform(*args)
        aug.spatial_data_order = aug.data_order = 0
        aug.seg_order = 0
        return aug


class NNUNetTrainerDA5Segord0(NNUNetTrainerDA5):
    """DA5 with order-0 label resampling only."""

    def _make_training_transform(self, *args):
        aug = super()._make_training_transform(*args)
        aug.seg_order = 0
        return aug


class NNUNetTrainer_onlyMirror01_DA5(NNUNetTrainerDA5):
    """DA5 with mirroring on axes (0, 1) only."""

    def _make_training_transform(self, patch_size, rotation, mirror_axes,
                                 dummy_2d, lm, ds_scales):
        self.inference_allowed_mirroring_axes = (0, 1)
        return super()._make_training_transform(
            patch_size, rotation, (0, 1), dummy_2d, lm, ds_scales)


NNUNetTrainer_250epochs_NoMirroring = _epochs_variant(
    250, NNUNetTrainerNoMirroring, "NNUNetTrainer_250epochs_NoMirroring")
NNUNetTrainer_2000epochs_NoMirroring = _epochs_variant(
    2000, NNUNetTrainerNoMirroring, "NNUNetTrainer_2000epochs_NoMirroring")
NNUNetTrainer_4000epochs_NoMirroring = _epochs_variant(
    4000, NNUNetTrainerNoMirroring, "NNUNetTrainer_4000epochs_NoMirroring")
NNUNetTrainer_8000epochs_NoMirroring = _epochs_variant(
    8000, NNUNetTrainerNoMirroring, "NNUNetTrainer_8000epochs_NoMirroring")
NNUNetTrainer_onlyMirror01_1500ep = _epochs_variant(
    1500, NNUNetTrainer_onlyMirror01, "NNUNetTrainer_onlyMirror01_1500ep")
NNUNetTrainerDA5_10epochs = _epochs_variant(
    10, NNUNetTrainerDA5, "NNUNetTrainerDA5_10epochs")
NNUNetTrainer_DASegOrd0 = type("NNUNetTrainer_DASegOrd0", (NNUNetTrainer,),
                               {})
NNUNetTrainer_DASegOrd0_NoMirroring = type(
    "NNUNetTrainer_DASegOrd0_NoMirroring", (NNUNetTrainerNoMirroring,), {})
NNUNetTrainer_onlyMirror01_DASegOrd0 = type(
    "NNUNetTrainer_onlyMirror01_DASegOrd0", (NNUNetTrainer_onlyMirror01,), {})
NNUNetTrainer_noDummy2DDA = type("NNUNetTrainer_noDummy2DDA",
                                 (NNUNetTrainerNoDummy2D,), {})


# ------------------------------------------------------- deep supervision
NNUNetTrainerNoDeepSupervision = _set_attrs(
    NNUNetTrainer, "NNUNetTrainerNoDeepSupervision",
    enable_deep_supervision=False)


# --------------------------------------------------------------- loss variants
def _loss_variant(name: str, kind: str, base=NNUNetTrainer):
    return type(name, (base,), {"loss_kind": kind})


NNUNetTrainerCELoss = _loss_variant("NNUNetTrainerCELoss", "ce")
NNUNetTrainerDiceLoss = _loss_variant("NNUNetTrainerDiceLoss", "dice")
NNUNetTrainerTopk10Loss = _loss_variant("NNUNetTrainerTopk10Loss", "topk10")
NNUNetTrainerTopk10LossLS01 = _loss_variant("NNUNetTrainerTopk10LossLS01",
                                            "topk10_ls01")
NNUNetTrainerDiceTopK10Loss = _loss_variant("NNUNetTrainerDiceTopK10Loss",
                                            "dc_topk10")
NNUNetTrainerDiceCELoss_noSmooth = _loss_variant(
    "NNUNetTrainerDiceCELoss_noSmooth", "dc_ce_nosmooth")
NNUNetTrainerCELoss_5epochs = _epochs_variant(
    5, NNUNetTrainerCELoss, "NNUNetTrainerCELoss_5epochs")


# --------------------------------------------------------------- optimizers
class NNUNetTrainerAdam(NNUNetTrainer):
    """clip 12 -> Adam -> poly from 3e-4 (the JAX trainer's fixed rate)."""

    def configure_optimizer(self, total_steps: int):
        return nnunet_adam(self.network.parameters(),
                           poly_lr(3e-4, total_steps))


class NNUNetTrainerAdamW(NNUNetTrainer):
    """clip 1 -> Adam (b2 0.98) -> decay 5e-2 -> poly from 3e-4."""

    def configure_optimizer(self, total_steps: int):
        return nnunet_adamw(self.network.parameters(),
                            poly_lr(3e-4, total_steps))


class NNUNetTrainerVanillaAdam(NNUNetTrainer):
    """clip 12 -> optax.adam on the poly schedule of ``initial_lr``."""

    def configure_optimizer(self, total_steps: int):
        return vanilla_adam(self.network.parameters(),
                            poly_lr(self.initial_lr, total_steps))


class NNUNetTrainerAdan(NNUNetTrainer):
    """clip 12 -> optax.adan (weight decay 3e-5) on the poly schedule."""

    def configure_optimizer(self, total_steps: int):
        return nnunet_adan(self.network.parameters(),
                           poly_lr(self.initial_lr, total_steps),
                           weight_decay=self.weight_decay)


class NNUNetTrainerAdanCosAnneal(NNUNetTrainerAdan):
    """Adan on a cosine schedule without warmup."""

    def configure_optimizer(self, total_steps: int):
        return nnunet_adan(self.network.parameters(),
                           linear_warmup_cosine(self.initial_lr, total_steps,
                                                0),
                           weight_decay=self.weight_decay)


NNUNetTrainerAdam1en3 = _set_attrs(NNUNetTrainerAdam, "NNUNetTrainerAdam1en3",
                                   initial_lr=1e-3)
NNUNetTrainerAdam3en4 = _set_attrs(NNUNetTrainerAdam, "NNUNetTrainerAdam3en4",
                                   initial_lr=3e-4)
NNUNetTrainerVanillaAdam1en3 = _set_attrs(
    NNUNetTrainerVanillaAdam, "NNUNetTrainerVanillaAdam1en3", initial_lr=1e-3)
NNUNetTrainerVanillaAdam3en4 = _set_attrs(
    NNUNetTrainerVanillaAdam, "NNUNetTrainerVanillaAdam3en4", initial_lr=3e-4)
NNUNetTrainerAdan1en3 = _set_attrs(NNUNetTrainerAdan, "NNUNetTrainerAdan1en3",
                                   initial_lr=1e-3)
NNUNetTrainerAdan3en4 = _set_attrs(NNUNetTrainerAdan, "NNUNetTrainerAdan3en4",
                                   initial_lr=3e-4)
NNUNetTrainerAdan1en1 = _set_attrs(NNUNetTrainerAdan, "NNUNetTrainerAdan1en1",
                                   initial_lr=1e-1)


class NNUNetTrainer_warmup(NNUNetTrainer):
    """SGD with a linear warmup over ``warmup_epochs``, then poly decay."""
    warmup_epochs = 50

    def configure_optimizer(self, total_steps: int):
        warmup_steps = self.warmup_epochs * self.num_iterations_per_epoch
        return nnunet_sgd(self.network.parameters(),
                          linear_warmup_poly(self.initial_lr, total_steps,
                                             warmup_steps),
                          momentum=0.99, weight_decay=self.weight_decay,
                          nesterov=True, grad_clip=12.0)


class NNUNetTrainerCosAnneal(NNUNetTrainer):
    """SGD on a cosine schedule over the run, no warmup."""

    def configure_optimizer(self, total_steps: int):
        return nnunet_sgd(self.network.parameters(),
                          linear_warmup_cosine(self.initial_lr, total_steps,
                                               0),
                          momentum=0.99, weight_decay=self.weight_decay,
                          nesterov=True, grad_clip=12.0)


# --------------------------------------------------------------- sampling
NNUNetTrainer_probabilisticOversampling = _set_attrs(
    NNUNetTrainer, "NNUNetTrainer_probabilisticOversampling",
    probabilistic_oversampling=True)
NNUNetTrainer_probabilisticOversampling_033 = type(
    "NNUNetTrainer_probabilisticOversampling_033",
    (NNUNetTrainer_probabilisticOversampling,), {})
NNUNetTrainer_probabilisticOversampling_010 = _set_attrs(
    NNUNetTrainer_probabilisticOversampling,
    "NNUNetTrainer_probabilisticOversampling_010",
    oversample_foreground_percent=0.10)
NNUNetTrainer_probabilisticOversampling_050 = _set_attrs(
    NNUNetTrainer_probabilisticOversampling,
    "NNUNetTrainer_probabilisticOversampling_050",
    oversample_foreground_percent=0.50)


class nnUNet_Trainer_BS8(NNUNetTrainer):
    """The plain trainer at batch size 8."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.configuration_manager.configuration["batch_size"] = 8


# --------------------------------------------------------------- benchmarking
class NNUNetTrainerBenchmark_5epochs(NNUNetTrainer):
    """Speed test: 5 epochs, no checkpoints; the fastest epoch, keyed by
    host and device, goes into ``benchmark_result.json``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.num_epochs = 5
        self.crashed_with_oom = False

    def save_checkpoint(self, filename: str) -> None:
        pass

    def run_training(self) -> None:
        try:
            super().run_training()
        except torch.cuda.OutOfMemoryError:
            self.crashed_with_oom = True
            self.print_to_log_file("Not enough memory!")
        finally:
            self._write_benchmark_result()

    def _write_benchmark_result(self) -> None:
        fname = join(self.output_folder, "benchmark_result.json")
        lg = self.logger.logging
        times = [e - s for s, e in zip(lg["epoch_start_timestamps"],
                                       lg["epoch_end_timestamps"]) if s and e]
        dev = self._environment().get("gpu_name", str(self.device))
        entry = {
            "fastest_epoch": float(np.min(times)) if times else None,
            "crashed_with_oom": self.crashed_with_oom,
            "hostname": socket.gethostname(), "devices": [dev],
            "torch_version": torch.__version__,
            "python": platform.python_version(),
            "num_iterations_per_epoch": self.num_iterations_per_epoch,
            "trainer": self.__class__.__name__,
        }
        existing = load_json(fname) if isfile(fname) else {}
        existing[f"{entry['hostname']}__{dev}"[:80]] = entry
        save_json(existing, fname, sort_keys=False)


class _Const:
    """One batch forever (``shutdown`` is a no-op)."""

    def __init__(self, batch):
        self._b = batch

    def __iter__(self):
        return self

    def __next__(self):
        return self._b

    def shutdown(self):
        pass


class NNUNetTrainerBenchmark_5epochs_noDataLoading(
        NNUNetTrainerBenchmark_5epochs):
    """Feeds one cached batch every iteration (copied to the device once)
    to time the step without the input pipeline."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._device_batch_cache = {}

    def batch_to_device(self, batch: dict):
        key = id(batch)
        if key not in self._device_batch_cache:
            self._device_batch_cache[key] = super().batch_to_device(batch)
        return self._device_batch_cache[key]

    def get_dataloaders(self):
        super().get_dataloaders()
        real = (self.dataloader_train, self.dataloader_val)
        self.dataloader_train, self.dataloader_val = (_Const(next(d))
                                                      for d in real)
        for d in real:
            d.shutdown()
        return self.dataloader_train, self.dataloader_val


# --------------------------------------------------------------- BatchNorm
class NNUNetTrainerBN(NNUNetTrainer):
    """BatchNorm instead of InstanceNorm (torch BatchNorm3d parity,
    models/blocks.py ``BatchStatsNorm``), built without remat: training
    steps move the running averages once, validation, the final
    validation and the predictor normalise with them, checkpoints carry
    them as ``batch_stats``."""

    def build_network_architecture(self):
        return build_network_from_arch_dict(
            with_batch_norm(
                self.configuration_manager.configuration["architecture"]),
            self.num_input_channels,
            self.label_manager.num_segmentation_heads,
            compute_dtype=self.compute_dtype, trainable=True)

    def _use_remat(self):
        return False
