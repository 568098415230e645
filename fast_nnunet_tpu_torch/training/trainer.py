"""NNUNetTrainer on one GPU — the port of fast_nnunet_tpu/training/trainer.py.

The same runtime as the JAX trainer, in PyTorch's idiom: the network is an
``nn.Module`` with float32 master parameters cast to bf16 inside its
forward, built in the training form (one-pass InstanceNorm, whose
statistics at >= 4096 voxels come from kernel A, and stage-level
``torch.utils.checkpoint`` by the JAX remat rule); the step is eager
forward, backward and a ``torch.optim`` update behind optax's chain order
(training/optimizers.py); host threads feed pinned NCDHW batches that are
copied to the card with ``non_blocking=True``. Reference defaults: 1000
epochs x 250 iterations, SGD nesterov 0.99, poly learning rate from 1e-2,
weight decay 3e-5, gradient clip 12, foreground oversampling 0.33, EMA
pseudo-Dice model selection. ``FNNT_ITERS_PER_EPOCH``,
``FNNT_VAL_ITERS_PER_EPOCH`` and ``FNNT_NUM_EPOCHS`` override the counts,
``FNN_REMAT`` the remat rule.

Checkpoints are the JAX package's pickle ``.fnnx`` (flax-shaped weights, a
BatchNorm network's running averages, and the optax-shaped optimizer state:
SGD momentum, Adam and Adan moments), so either package resumes the other's.
Trainer variants (training/trainer_variants.py) override
``build_network_architecture``, ``configure_optimizer``,
``_configure_rotation_dummyDA_mirroring_and_initial_patch_size``,
``_make_training_transform`` and the class attribute ``loss_kind``
(training/losses.py ``loss_of_kind``; "dc_ce" is the default loss). Not
ported (``NotImplementedError``): cascaded configurations, multi-GPU and
multi-host training.
"""
import os
import sys
import time
from datetime import datetime
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..configuration import get_allowed_n_proc_DA
from ..core.labels import determine_num_input_channels
from ..core.plans import PlansManager
from ..device import resolve_device
from ..models.factory import build_network_from_arch_dict
from ..models.unet import init_he_normal_, params_from_jax, params_to_jax
from ..utils.io import isfile, join, load_json, maybe_mkdir_p, save_json
from ..utils.misc import generate_crossval_split
from .augment import (TrainingAugmenter, ValidationAugmenter,
                      configure_rotation_dummyDA_mirroring_and_initial_patch_size)
from .checkpoint import load_checkpoint as load_ckpt_file
from .checkpoint import (optimizer_state_from_jax, optimizer_state_to_jax,
                         save_checkpoint)
from .dataloader import AsyncBatchIterator, PatchSampler
from .dataset import infer_dataset_class
from .logger import NNUNetLogger
from .losses import loss_of_kind
from .optimizers import nnunet_sgd
from .schedules import poly_lr
from .train_step import make_train_step, make_val_step, timed_phase


class NNUNetTrainer:
    #: the training loss: "dc_ce" (DC + CE, or DC + BCE for regions) or a
    #: kind of training/losses.py ``loss_of_kind``
    loss_kind = "dc_ce"

    def __init__(self, plans: Union[dict, str], configuration: str, fold,
                 dataset_json: dict, device=None):
        self.device = resolve_device(device)
        self.plans_manager = PlansManager(plans)
        self.configuration_manager = \
            self.plans_manager.get_configuration(configuration)
        self.configuration_name = configuration
        self.dataset_json = dataset_json
        self.fold = fold
        self.label_manager = self.plans_manager.get_label_manager(dataset_json)
        if self.configuration_manager.previous_stage_name is not None:
            raise NotImplementedError(
                "cascaded configurations are not ported to the PyTorch trainer")

        # ---- hyperparameters (reference defaults)
        self.initial_lr = 1e-2
        self.weight_decay = 3e-5
        self.oversample_foreground_percent = 0.33
        self.probabilistic_oversampling = False
        self.num_iterations_per_epoch = int(os.environ.get(
            "FNNT_ITERS_PER_EPOCH", 250))
        self.num_val_iterations_per_epoch = int(os.environ.get(
            "FNNT_VAL_ITERS_PER_EPOCH", 50))
        self.num_epochs = int(os.environ.get("FNNT_NUM_EPOCHS", 1000))
        self.current_epoch = 0
        self.enable_deep_supervision = True
        self.save_every = 50
        self.disable_checkpointing = False
        self.compute_dtype = torch.bfloat16

        self._best_ema = None
        self.logger = NNUNetLogger()
        self.was_initialized = False

        self.preprocessed_dataset_folder_base = None
        self.output_folder_base = None
        self.output_folder = None
        try:
            from ..paths import get_preprocessed_folder, get_results_folder
            self.preprocessed_dataset_folder_base = join(
                get_preprocessed_folder(), self.plans_manager.dataset_name)
            self.output_folder_base = join(
                get_results_folder(), self.plans_manager.dataset_name,
                f"{self.__class__.__name__}__{self.plans_manager.plans_name}__"
                f"{configuration}")
            self.output_folder = join(self.output_folder_base, f"fold_{fold}")
        except RuntimeError:
            pass  # paths unset: fine for in-memory use

        self.network = None
        self.optimizer = None
        self.train_step = None
        self.val_step = None
        self.inference_allowed_mirroring_axes = None
        self.dataloader_train = None
        self.dataloader_val = None
        self.log_file = None
        #: optional inference.engine.PhaseTimer: the loop brackets "data"
        #: (waiting for the next batch) and "h2d", the step its own phases
        self.timer = None

    # ------------------------------------------------------------------ setup
    @property
    def preprocessed_dataset_folder(self) -> str:
        return join(self.preprocessed_dataset_folder_base,
                    self.configuration_manager.data_identifier)

    def print_to_log_file(self, *args, also_print_to_console: bool = True
                          ) -> None:
        msg = " ".join(str(a) for a in args)
        stamped = f"{datetime.now().isoformat(timespec='seconds')}: {msg}"
        if self.output_folder is not None:
            maybe_mkdir_p(self.output_folder)
            if self.log_file is None:
                self.log_file = join(self.output_folder,
                                     f"training_log_{int(time.time())}.txt")
            try:
                with open(self.log_file, "a") as f:
                    f.write(stamped + "\n")
            except IOError:
                pass
        if also_print_to_console:
            print(stamped)

    def _get_deep_supervision_scales(self) -> Optional[List[List[float]]]:
        if not self.enable_deep_supervision:
            return None
        strides = self.configuration_manager.pool_op_kernel_sizes
        return list(list(i) for i in
                    1 / np.cumprod(np.vstack(strides), axis=0))[:-1]

    def _n_ds_levels(self) -> int:
        return len(self._get_deep_supervision_scales() or [None])

    def initialize(self) -> None:
        if self.was_initialized:
            raise RuntimeError("initialize() called twice")
        self.num_input_channels = determine_num_input_channels(
            self.plans_manager, self.configuration_manager, self.dataset_json)
        net = self.build_network_architecture()
        init_he_normal_(net, 12345 + self.fold
                        if isinstance(self.fold, int) else 0)
        self.network = net.to(self.device)
        total_steps = self.num_epochs * self.num_iterations_per_epoch
        self.optimizer = self.configure_optimizer(total_steps)
        step_kwargs = self._step_kwargs()
        self.train_step = make_train_step(self.network, self.optimizer,
                                          loss_fn=self._train_loss_fn(),
                                          **step_kwargs)
        self.val_step = make_val_step(
            self.network, num_heads=self.label_manager.num_segmentation_heads,
            **step_kwargs)
        self.was_initialized = True

    def _step_kwargs(self) -> dict:
        return dict(has_regions=self.label_manager.has_regions,
                    has_ignore=self.label_manager.has_ignore_label,
                    ignore_label=self.label_manager.ignore_label,
                    batch_dice=self.configuration_manager.batch_dice,
                    n_ds_levels=self._n_ds_levels())

    def _train_loss_fn(self):
        """None for the default loss, else the variant's ``loss_kind`` (the
        validation step keeps the default, as in the JAX trainers)."""
        if self.loss_kind == "dc_ce":
            return None
        lm = self.label_manager
        return loss_of_kind(
            self.loss_kind, batch_dice=self.configuration_manager.batch_dice,
            ignore_label=lm.ignore_label if lm.has_ignore_label else None)

    def build_network_architecture(self):
        """The training form: float32 master parameters, one-pass
        InstanceNorm (kernel A's statistics), remat by the JAX rule."""
        return build_network_from_arch_dict(
            self.configuration_manager.configuration["architecture"],
            self.num_input_channels,
            self.label_manager.num_segmentation_heads,
            compute_dtype=self.compute_dtype, remat=self._use_remat(),
            norm_onepass=True, trainable=True)

    def _use_remat(self):
        """Stage-level activation checkpointing, the JAX trainer's rule: on
        from 2M voxels per batch (e.g. 2 x 128^3). ``FNN_REMAT=0/1``
        overrides."""
        env = os.environ.get("FNN_REMAT", "")
        if env in ("0", "1"):
            return env == "1"
        voxels = self.configuration_manager.batch_size * int(
            np.prod(self.configuration_manager.patch_size))
        return voxels >= 2 ** 21

    def configure_optimizer(self, total_steps: int):
        return nnunet_sgd(self.network.parameters(),
                          poly_lr(self.initial_lr, total_steps),
                          momentum=0.99, weight_decay=self.weight_decay,
                          nesterov=True, grad_clip=12.0)

    # ------------------------------------------------------------------ data
    def do_split(self) -> Tuple[List[str], List[str]]:
        keys = infer_dataset_class(self.preprocessed_dataset_folder) \
            .get_identifiers(self.preprocessed_dataset_folder)
        if self.fold == "all":
            return keys, keys
        splits_file = join(self.preprocessed_dataset_folder_base,
                           "splits_final.json")
        if not isfile(splits_file):
            splits = generate_crossval_split(keys, seed=12345, n_splits=5)
            save_json(splits, splits_file)
        else:
            splits = load_json(splits_file)
        if self.fold < len(splits):
            return splits[self.fold]["train"], splits[self.fold]["val"]
        rng = np.random.RandomState(12345 + self.fold)
        idx = rng.choice(len(keys), int(len(keys) * 0.8), replace=False)
        tr = [keys[i] for i in idx]
        return tr, [k for k in keys if k not in set(tr)]

    def _configure_rotation_dummyDA_mirroring_and_initial_patch_size(
            self, patch_size):
        """The DA geometry envelope (rotation, dummy 2D, initial patch,
        mirror axes); DA5 widens the initial patch's scale range."""
        return configure_rotation_dummyDA_mirroring_and_initial_patch_size(
            patch_size)

    def get_dataloaders(self):
        patch_size = self.configuration_manager.patch_size
        rotation, dummy_2d, initial_patch, mirror_axes = \
            self._configure_rotation_dummyDA_mirroring_and_initial_patch_size(
                patch_size)
        self.inference_allowed_mirroring_axes = mirror_axes
        ds_scales = self._get_deep_supervision_scales()
        lm = self.label_manager

        tr_keys, val_keys = self.do_split()
        dataset_class = infer_dataset_class(self.preprocessed_dataset_folder)
        ds_tr = dataset_class(self.preprocessed_dataset_folder, tr_keys)
        ds_val = dataset_class(self.preprocessed_dataset_folder, val_keys)
        regions = lm.foreground_regions if lm.has_regions else None
        train_transform = self._make_training_transform(
            patch_size, rotation, mirror_axes, dummy_2d, lm, ds_scales)
        val_transform = ValidationAugmenter(
            patch_size, regions=regions, ignore_label=lm.ignore_label,
            ds_scales=ds_scales)

        bs = self.configuration_manager.batch_size
        oversample = self.oversample_foreground_percent
        sampler_tr = PatchSampler(
            ds_tr, bs, initial_patch, patch_size, oversample,
            transform=train_transform,
            probabilistic_oversampling=self.probabilistic_oversampling)
        sampler_val = PatchSampler(ds_val, bs, patch_size, patch_size,
                                   oversample, transform=val_transform)
        n_proc = get_allowed_n_proc_DA()
        pin = self.device.type == "cuda"
        seed = 12345
        self.dataloader_train = AsyncBatchIterator(
            sampler_tr, num_workers=n_proc, seed=seed, pin_memory=pin)
        self.dataloader_val = AsyncBatchIterator(
            sampler_val, num_workers=max(1, n_proc // 2), seed=seed + 500,
            pin_memory=pin)
        return self.dataloader_train, self.dataloader_val

    def _make_training_transform(self, patch_size, rotation, mirror_axes,
                                 dummy_2d, lm, ds_scales):
        return TrainingAugmenter(
            patch_size, rotation, mirror_axes,
            use_mask_for_norm=self.configuration_manager.use_mask_for_norm,
            dummy_2d=dummy_2d,
            regions=lm.foreground_regions if lm.has_regions else None,
            ignore_label=lm.ignore_label, ds_scales=ds_scales)

    def batch_to_device(self, batch: dict):
        """(data (B, C, *patch), targets) on the trainer's device: label
        targets (B, *S) int64, region targets (B, R[+1], *S) as they come.
        Pinned host tensors are copied asynchronously."""
        def put(x):
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(x))
            return t.to(self.device, non_blocking=t.is_pinned())

        data = put(batch["data"])
        if self.label_manager.has_regions:
            targets = tuple(put(t) for t in batch["target"])
        else:
            targets = tuple(put(t)[:, 0].long() for t in batch["target"])
        return data, targets

    def next_batch(self, loader):
        with timed_phase(self.timer, "data"):
            batch = next(loader)
        with timed_phase(self.timer, "h2d"):
            return self.batch_to_device(batch)

    # ------------------------------------------------------------------ loop
    def run_train_iterations(self, epoch: int) -> None:
        losses = [self.train_step(*self.next_batch(self.dataloader_train))
                  for _ in range(self.num_iterations_per_epoch)]
        self.logger.log("train_losses",
                        float(torch.stack(losses).float().mean()), epoch)

    def run_val_iterations(self, epoch: int) -> None:
        val_losses, tps, fps, fns = [], [], [], []
        for _ in range(self.num_val_iterations_per_epoch):
            loss, tp, fp, fn = self.val_step(
                *self.next_batch(self.dataloader_val))
            val_losses.append(float(loss))
            tps.append(tp.cpu().numpy())
            fps.append(fp.cpu().numpy())
            fns.append(fn.cpu().numpy())
        self.on_validation_epoch_end(val_losses, tps, fps, fns, epoch)

    def run_training(self) -> None:
        self.on_train_start()
        try:
            for epoch in range(self.current_epoch, self.num_epochs):
                self.logger.log("epoch_start_timestamps", time.time(), epoch)
                self.run_train_iterations(epoch)
                self.logger.log("lrs", self.optimizer.lr(
                    epoch * self.num_iterations_per_epoch), epoch)
                self.run_val_iterations(epoch)
                self.on_epoch_end(epoch)
        finally:
            self.on_train_end()

    def _environment(self) -> dict:
        env = {"python": sys.version.split()[0], "torch": torch.__version__,
               "cuda": torch.version.cuda, "device": str(self.device),
               "cudnn": torch.backends.cudnn.version()
               if torch.backends.cudnn.is_available() else None}
        if self.device.type == "cuda":
            env["gpu_name"] = torch.cuda.get_device_name(self.device)
            env["gpu_count"] = torch.cuda.device_count()
        return env

    def on_train_start(self) -> None:
        if not self.was_initialized:
            self.initialize()
        maybe_mkdir_p(self.output_folder)
        save_json(self.plans_manager.plans,
                  join(self.output_folder_base, "plans.json"), sort_keys=False)
        save_json(self.dataset_json,
                  join(self.output_folder_base, "dataset.json"),
                  sort_keys=False)
        debug = self._environment()
        debug.update({
            "trainer": self.__class__.__name__,
            "configuration": self.configuration_name, "fold": str(self.fold),
            "batch_size": self.configuration_manager.batch_size,
            "patch_size": self.configuration_manager.patch_size,
            "initial_lr": self.initial_lr, "weight_decay": self.weight_decay,
            "num_epochs": self.num_epochs,
            "num_iterations_per_epoch": self.num_iterations_per_epoch,
            "oversample_foreground_percent":
                self.oversample_foreground_percent,
            "enable_deep_supervision": self.enable_deep_supervision,
            "compute_dtype": str(self.compute_dtype),
            "remat": self._use_remat(),
        })
        save_json(debug, join(self.output_folder, "debug.json"),
                  sort_keys=False)
        self.get_dataloaders()
        self.print_to_log_file(
            f"Starting training: {self.plans_manager.dataset_name} "
            f"{self.configuration_name} fold {self.fold}, {self.num_epochs} "
            f"epochs x {self.num_iterations_per_epoch} iters on "
            f"{debug.get('gpu_name', self.device)}")

    def on_validation_epoch_end(self, val_losses, tps, fps, fns,
                                epoch: int) -> None:
        tp, fp, fn = np.sum(tps, 0), np.sum(fps, 0), np.sum(fns, 0)
        dice_per_class = 2 * tp / np.maximum(2 * tp + fp + fn, 1e-8)
        self.logger.log("val_losses", float(np.mean(val_losses)), epoch)
        self.logger.log("dice_per_class_or_region", dice_per_class.tolist(),
                        epoch)
        self.logger.log("mean_fg_dice", float(np.nanmean(dice_per_class)),
                        epoch)

    def on_epoch_end(self, epoch: int) -> None:
        self.logger.log("epoch_end_timestamps", time.time(), epoch)
        self.current_epoch = epoch + 1
        ema = self.logger.logging["ema_fg_dice"][epoch]
        if self._best_ema is None or ema > self._best_ema:
            self._best_ema = ema
            if not self.disable_checkpointing:
                self.save_checkpoint(join(self.output_folder,
                                          "checkpoint_best.fnnx"))
            self.print_to_log_file(
                f"New best EMA pseudo Dice: {np.round(ema, 4)}")
        if (epoch + 1) % self.save_every == 0 and epoch + 1 != self.num_epochs \
                and not self.disable_checkpointing:
            self.save_checkpoint(join(self.output_folder,
                                      "checkpoint_latest.fnnx"))
        lg = self.logger.logging
        self.print_to_log_file(
            f"Epoch {epoch}: train {lg['train_losses'][epoch]:.4f} "
            f"val {lg['val_losses'][epoch]:.4f} pseudo-dice "
            f"{np.round(lg['mean_fg_dice'][epoch], 4)} (EMA "
            f"{np.round(ema, 4)})")
        try:
            self.logger.plot_progress_png(self.output_folder)
        except Exception:
            pass  # no matplotlib: no plot

    def on_train_end(self) -> None:
        if not self.disable_checkpointing:
            self.save_checkpoint(join(self.output_folder,
                                      "checkpoint_final.fnnx"))
            latest = join(self.output_folder, "checkpoint_latest.fnnx")
            if isfile(latest):
                os.remove(latest)
        for loader in (self.dataloader_train, self.dataloader_val):
            if loader is not None:
                loader.shutdown()
        self.print_to_log_file("Training done.")

    # ------------------------------------------------------------------ ckpt
    def _init_args(self) -> dict:
        return {"configuration": self.configuration_name, "fold": self.fold,
                "plans_name": self.plans_manager.plans_name,
                "dataset_name": self.plans_manager.dataset_name}

    def save_checkpoint(self, filename: str) -> None:
        save_checkpoint(
            filename,
            network_weights=params_to_jax(self.network),
            optimizer_state=optimizer_state_to_jax(self.optimizer,
                                                   self.network),
            current_epoch=self.current_epoch,
            logging=self.logger.get_checkpoint(),
            best_ema=self._best_ema,
            init_args=self._init_args(),
            trainer_name=self.__class__.__name__,
            inference_allowed_mirroring_axes=
            self.inference_allowed_mirroring_axes,
            extras={"train_step": int(self.optimizer.count)})

    def load_checkpoint(self, filename_or_checkpoint: Union[str, dict]
                        ) -> None:
        """Resume: weights (and running averages), the optimizer's state
        and step count, epoch, logs."""
        if not self.was_initialized:
            self.initialize()
        ckpt = filename_or_checkpoint
        if isinstance(ckpt, str):
            ckpt = load_ckpt_file(ckpt)
        params_from_jax(self.network, ckpt["network_weights"])
        if ckpt.get("optimizer_state") is not None:
            optimizer_state_from_jax(self.optimizer, self.network,
                                     ckpt["optimizer_state"])
        self.optimizer.count = int(ckpt.get("train_step",
                                            self.optimizer.count))
        self.current_epoch = ckpt.get("current_epoch", 0)
        self._best_ema = ckpt.get("_best_ema")
        if ckpt.get("logging") is not None:
            self.logger.load_checkpoint(ckpt["logging"])
        if ckpt.get("inference_allowed_mirroring_axes") is not None:
            self.inference_allowed_mirroring_axes = \
                ckpt["inference_allowed_mirroring_axes"]

    # ------------------------------------------------------------- final val
    def perform_actual_validation(self, save_probabilities: bool = False
                                  ) -> dict:
        """Sliding-window prediction of the validation split
        (``SlidingWindowEngine.predict_logits``, gaussian, step 0.5, the
        trainer's mirror axes), export to the raw grid and the metrics
        summary.json against nnUNet_raw's labelsTr."""
        from ..evaluation.metrics import compute_metrics_on_folder
        from ..inference.engine import SlidingWindowEngine
        from ..inference.export import export_prediction_from_logits
        from ..paths import get_raw_folder

        validation_output_folder = join(self.output_folder, "validation")
        maybe_mkdir_p(validation_output_folder)
        _, val_keys = self.do_split()
        ds_val = infer_dataset_class(self.preprocessed_dataset_folder)(
            self.preprocessed_dataset_folder, val_keys)
        engine = SlidingWindowEngine(
            self.network, self.configuration_manager.patch_size,
            self.label_manager.num_segmentation_heads, tile_step_size=0.5,
            use_gaussian=True,
            mirror_axes=self.inference_allowed_mirroring_axes or (),
            compute_dtype=self.compute_dtype, device=self.device)
        params = params_to_jax(self.network)
        for ident in val_keys:
            data, _, props = ds_val.load_case(ident, mmap=False)
            logits = engine.predict_logits(params, np.asarray(data))
            export_prediction_from_logits(
                logits, props, self.configuration_manager, self.plans_manager,
                self.dataset_json, join(validation_output_folder, ident),
                save_probabilities)

        gt_folder = join(get_raw_folder(), self.plans_manager.dataset_name,
                         "labelsTr")
        lm = self.label_manager
        metrics = compute_metrics_on_folder(
            gt_folder, validation_output_folder,
            join(validation_output_folder, "summary.json"),
            self.plans_manager.image_reader_writer_class()(),
            self.dataset_json["file_ending"],
            lm.foreground_regions if lm.has_regions else lm.foreground_labels,
            lm.ignore_label, chill=True)
        self.print_to_log_file(
            f"Validation complete. Mean fg Dice: "
            f"{metrics['foreground_mean']['Dice']:.4f}")
        return metrics
