"""Knowledge-distillation trainer — the port of
fast_nnunet_tpu/training/distill.py, Fast-nnUNet's own contribution: a
frozen N-fold teacher ensemble compressed into a width-reduced student
(features max(f // r, 8)), trained with

    total = (1 - alpha) * seg_loss + alpha * KL(teacher/T || student/T) * T^2

on the highest-resolution logits, the teachers' float32 logits averaged over
folds (the JAX step sums them in fold order and divides once; so does this
one), and optional rotation of the student's training fold.

Teachers are inference-form networks (conv weights in the compute dtype,
which is what the JAX apply casts its float32 parameters to) with the
one-pass InstanceNorm, so every teacher norm at >= 4096 voxels runs kernel A
too; they run under ``torch.no_grad()`` in evaluation mode. Teachers and
students are either U-Net: a residual-encoder teacher (ResEnc plans)
distils into a LiteResEncStudent, its block counts mapped by
``block_reduction_strategy``. Every configuration distils: the teachers are
built from the teacher plans' configuration of the student's name with
the student's input channels, so a ``2d`` student learns from 2D teachers
(its norms on 4-D batches, kernel A at 4-D) and a ``3d_cascade_fullres``
student and its teachers take the image plus one one-hot channel per
foreground label of the previous stage. ``NNUNetDistillationTrainerDA5``
trains the student under the DA5 augmentation.

Data parallel, as the JAX trainer inherits its mesh: each rank holds the
frozen teachers (replicated, never reduced) and a student replica; the
seg loss takes its global terms over the group, the KL term is a mean
over equal local batches, and only the student's gradients are averaged.
"""
import time
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..core.plans import PlansManager
from ..models.factory import build_network_from_arch_dict, with_batch_norm
from ..models.students import build_lite_student
from ..models.unet import params_from_jax, params_from_jax_partial
from ..parallel.collectives import average_gradients_, global_mean_
from ..utils.io import isfile, join, load_json, subdirs
from ..utils.profiling import phase
from .augment_da5 import DA5TrainingAugmenter
from .checkpoint import load_checkpoint as load_ckpt_file
from .train_step import ds_weights, forward_loss, make_loss_fn
from .trainer import NNUNetTrainer


def distillation_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    """KL(softmax(t/T) || softmax(s/T)) * T^2 averaged over ALL elements
    (torch ``F.kl_div(..., reduction='mean')``), logits (B, K, *S)."""
    s = student_logits.float() / temperature
    t = teacher_logits.float() / temperature
    kl = torch.softmax(t, 1) * (torch.log_softmax(t, 1)
                                - torch.log_softmax(s, 1))
    return kl.mean() * temperature ** 2


@torch.no_grad()
def ensemble_teacher_logits(teachers: Sequence[torch.nn.Module],
                            data: torch.Tensor) -> torch.Tensor:
    """Mean of the teachers' float32 full-resolution logits."""
    total = None
    for net in teachers:
        out = net(data, deep_supervision=False).float()
        total = out if total is None else total + out
    return total / len(teachers)


def make_distill_train_step(student, teachers: Sequence[torch.nn.Module],
                            optimizer, *, alpha: float, temperature: float,
                            has_regions: bool = False,
                            has_ignore: bool = False,
                            ignore_label: Optional[int] = None,
                            batch_dice: bool = False, n_ds_levels: int = 1,
                            timer=None, group=None):
    """Returns step(data, targets) -> (total, seg_loss, distill_loss),
    detached device scalars (the global batch's with ``group``), after one
    update of ``student`` in place."""
    loss_fn = make_loss_fn(has_regions=has_regions, has_ignore=has_ignore,
                           ignore_label=ignore_label, batch_dice=batch_dice,
                           group=group)
    weights = ds_weights(n_ds_levels)
    params = [p for p in student.parameters() if p.requires_grad]

    def step(data, targets):
        student.train()
        optimizer.zero_grad()
        with phase(step.timer, "forward_loss"):
            outputs, seg_loss = forward_loss(student, loss_fn, weights, data,
                                             targets)
            with phase(step.timer, "teachers"):
                t_logits = ensemble_teacher_logits(teachers, data)
            dloss = distillation_loss(outputs[0], t_logits, temperature)
            total = (1.0 - alpha) * seg_loss + alpha * dloss
        with phase(step.timer, "backward"):
            total.backward()
        losses = torch.stack([total.detach(), seg_loss.detach(),
                              dloss.detach()])
        if group is not None:
            with phase(step.timer, "all_reduce"):
                average_gradients_(params, group)
                losses = global_mean_(losses, group)
        with phase(step.timer, "optimizer"):
            optimizer.step()
        return tuple(losses.unbind())

    step.timer = timer
    return step


class NNUNetDistillationTrainer(NNUNetTrainer):
    def __init__(self, plans, configuration: str, fold, dataset_json: dict,
                 device=None,
                 teacher_model_folder: Optional[str] = None,
                 teacher_fold: Union[int, Sequence[int]] = (0, 1, 2, 3, 4),
                 teacher_checkpoint_name: str = "checkpoint_final.fnnx",
                 alpha: float = 0.3, temperature: float = 3.0,
                 feature_reduction_factor: int = 2,
                 block_reduction_strategy: str = "reduce",
                 rotate_training_folds: bool = False,
                 rotate_folds_frequency: int = 50,
                 student_plans_identifier: str = "nnUNetPlans"):
        super().__init__(plans, configuration, fold, dataset_json, device)
        self.teacher_model_folder = teacher_model_folder
        self.teacher_fold = list(teacher_fold) if isinstance(
            teacher_fold, (list, tuple)) else [teacher_fold]
        self.teacher_checkpoint_name = teacher_checkpoint_name
        self.alpha = alpha
        self.temperature = temperature
        self.feature_reduction_factor = feature_reduction_factor
        self.block_reduction_strategy = block_reduction_strategy
        self.rotate_training_folds = rotate_training_folds
        self.rotate_folds_frequency = rotate_folds_frequency
        self.initial_fold = fold
        self.all_available_folds = None
        self.fold_rotation_counter = 0
        self.student_plans_identifier = student_plans_identifier

        self.teachers: List[torch.nn.Module] = []
        self.distill_step = None
        self.logger.logging.setdefault("train_seg_losses", [])
        self.logger.logging.setdefault("train_distill_losses", [])

    # ------------------------------------------------------------------ student
    def build_network_architecture(self):
        arch = self.configuration_manager.configuration["architecture"]
        return build_lite_student(
            arch["network_class_name"], arch["arch_kwargs"],
            self.num_input_channels,
            self.label_manager.num_segmentation_heads,
            self.feature_reduction_factor, self.block_reduction_strategy,
            compute_dtype=self.compute_dtype, remat=self._use_remat(),
            norm_onepass=True, trainable=True)

    # ------------------------------------------------------------------ teachers
    def load_teacher_model(self) -> None:
        if self.teacher_model_folder is None:
            raise ValueError("teacher_model_folder is not set")
        teacher_plans = PlansManager(join(self.teacher_model_folder,
                                          "plans.json"))
        arch = teacher_plans.get_configuration(
            self.configuration_name).configuration["architecture"]
        self.teachers = []
        for f in self.teacher_fold:
            ckpt_path = join(self.teacher_model_folder, f"fold_{f}",
                             self.teacher_checkpoint_name)
            if not isfile(ckpt_path):
                alt = join(self.teacher_model_folder, f"fold_{f}",
                           "checkpoint_best.fnnx")
                if not isfile(alt):
                    raise FileNotFoundError(
                        f"No teacher checkpoint for fold {f} in "
                        f"{self.teacher_model_folder}")
                ckpt_path = alt
            weights = load_ckpt_file(ckpt_path)["network_weights"]
            net = build_network_from_arch_dict(
                with_batch_norm(arch) if "batch_stats" in weights else arch,
                self.num_input_channels,
                self.label_manager.num_segmentation_heads,
                compute_dtype=self.compute_dtype, norm_onepass=True)
            params_from_jax(net, weights)
            self.teachers.append(net.to(self.device).eval())
        self.print_to_log_file(
            f"Loaded {len(self.teachers)} frozen teacher fold(s) "
            f"{self.teacher_fold} from {self.teacher_model_folder}")

    @staticmethod
    def detect_available_teacher_folds(
            teacher_model_folder: str,
            checkpoint_names=("checkpoint_final.fnnx", "checkpoint_best.fnnx")
    ) -> List[int]:
        """fold_* folders that hold a usable checkpoint."""
        folds = []
        for d in subdirs(teacher_model_folder, prefix="fold_",
                         join_path=False):
            try:
                f = int(d.split("_")[1])
            except (IndexError, ValueError):
                continue
            if any(isfile(join(teacher_model_folder, d, c))
                   for c in checkpoint_names):
                folds.append(f)
        return sorted(folds)

    # ------------------------------------------------------------------ setup
    def initialize(self) -> None:
        super().initialize()
        self.initialize_fold_rotation()
        self.load_teacher_model()
        self.distill_step = make_distill_train_step(
            self.network, self.teachers, self.optimizer, alpha=self.alpha,
            temperature=self.temperature, group=self.group,
            **self._step_kwargs())
        self.print_to_log_file(
            f"Distillation: alpha={self.alpha} T={self.temperature} "
            f"r={self.feature_reduction_factor} "
            f"block_strategy={self.block_reduction_strategy} "
            f"teachers={self.teacher_fold}")

    def initialize_fold_rotation(self) -> None:
        if not self.rotate_training_folds:
            return
        split_file = join(self.preprocessed_dataset_folder_base,
                          "splits_final.json")
        if not isfile(split_file):
            self.print_to_log_file(
                "splits_final.json missing; fold rotation off")
            self.rotate_training_folds = False
            return
        self.all_available_folds = list(range(len(load_json(split_file))))
        self.print_to_log_file(
            f"Fold rotation over {self.all_available_folds} every "
            f"{self.rotate_folds_frequency} epochs")

    def update_fold_for_next_rotation(self) -> bool:
        """Rotate the student's training-data fold on schedule."""
        if not self.rotate_training_folds or self.all_available_folds is None:
            return False
        if self.current_epoch == 0 or \
                (self.current_epoch % self.rotate_folds_frequency) != 0:
            return False
        idx = self.all_available_folds.index(self.fold)
        next_fold = self.all_available_folds[
            (idx + 1) % len(self.all_available_folds)]
        if self.fold_rotation_counter >= len(self.all_available_folds):
            next_fold = self.initial_fold
            self.fold_rotation_counter = 0
        if next_fold == self.fold:
            return False
        self.print_to_log_file(
            f"Rotating training fold {self.fold} -> {next_fold}")
        self.fold = next_fold
        self.fold_rotation_counter += 1
        if self.dataloader_train is not None:
            self.dataloader_train.shutdown()
            self.dataloader_val.shutdown()
        self.get_dataloaders()
        return True

    # ------------------------------------------------------------------ loop
    def run_train_iterations(self, epoch: int) -> None:
        out = [self.distill_step(*self.next_batch(self.dataloader_train))
               for _ in range(self.num_iterations_per_epoch)]
        total, seg, dist = (float(torch.stack(v).float().mean())
                            for v in zip(*out))
        self.logger.log("train_losses", total, epoch)
        self.logger.logging["train_seg_losses"].append(seg)
        self.logger.logging["train_distill_losses"].append(dist)

    def run_training(self) -> None:
        self.on_train_start()
        try:
            for epoch in range(self.current_epoch, self.num_epochs):
                self.update_fold_for_next_rotation()
                self.logger.log("epoch_start_timestamps", time.time(), epoch)
                self.run_train_iterations(epoch)
                self.logger.log("lrs", self.initial_lr, epoch)
                self.run_val_iterations(epoch)
                self.on_epoch_end(epoch)
                self.print_to_log_file(
                    f"  seg_loss "
                    f"{self.logger.logging['train_seg_losses'][-1]:.4f}  "
                    f"distill_loss "
                    f"{self.logger.logging['train_distill_losses'][-1]:.4f}")
        finally:
            self.on_train_end()

    # ------------------------------------------------------------------ ckpt
    def _init_args(self) -> dict:
        args = super()._init_args()
        args.update({
            "teacher_model_folder": self.teacher_model_folder,
            "teacher_fold": self.teacher_fold,
            "teacher_checkpoint_name": self.teacher_checkpoint_name,
            "alpha": self.alpha, "temperature": self.temperature,
            "feature_reduction_factor": self.feature_reduction_factor,
            "block_reduction_strategy": self.block_reduction_strategy,
            "rotate_training_folds": self.rotate_training_folds,
            "rotate_folds_frequency": self.rotate_folds_frequency,
            "student_plans_identifier": self.student_plans_identifier,
        })
        return args

    def load_student_checkpoint(self, filename: str) -> Tuple[int, int]:
        """Tolerant partial restore of the student (every tensor whose path
        and shape match); returns (n_loaded, n_total)."""
        if not self.was_initialized:
            self.initialize()
        ckpt = load_ckpt_file(filename)
        n_loaded, n_total = params_from_jax_partial(self.network,
                                                    ckpt["network_weights"])
        self.current_epoch = ckpt.get("current_epoch", 0)
        self._best_ema = ckpt.get("_best_ema")
        if ckpt.get("logging"):
            self.logger.load_checkpoint(ckpt["logging"])
        self.print_to_log_file(
            f"Partial checkpoint load: {n_loaded}/{n_total} tensors matched "
            f"({100.0 * n_loaded / max(n_total, 1):.1f}%)")
        return n_loaded, n_total


class NNUNetDistillationTrainerDA5(NNUNetDistillationTrainer):
    """Distillation with the DA5 strong augmentation for small datasets
    (training/augment_da5.py; the default geometry envelope, as in the JAX
    trainer)."""

    def _make_training_transform(self, patch_size, rotation, mirror_axes,
                                 dummy_2d, lm, ds_scales):
        return DA5TrainingAugmenter(
            patch_size, rotation, mirror_axes,
            use_mask_for_norm=self.configuration_manager.use_mask_for_norm,
            dummy_2d=dummy_2d,
            regions=lm.foreground_regions if lm.has_regions else None,
            ignore_label=lm.ignore_label, ds_scales=ds_scales)
