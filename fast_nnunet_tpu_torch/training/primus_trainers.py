"""Primus transformer trainers — the port of
fast_nnunet_tpu/training/primus_trainers.py: AdamW (b1 0.9, b2 0.98, weight
decay 5e-2, gradient clip 1), linear warmup over 50 epochs then poly from
3e-4, no deep supervision, and the NaN watchdog: a step whose loss is not
finite leaves the parameters and the whole optimizer state (moments and
schedule count) as they were (training/train_step.py ``skip_nonfinite``).

The network is models/primus.py's ``Primus`` at the class's dims, the
plans' patch and the compute dtype, with drop path 0.2 that stays inert:
the JAX step applies the network deterministically (no dropout rng), and
so does this one. Its weights start from flax's initialisers
(``init_primus_``). The checkpoint's ``init_args`` carry ``primus_arch``
(``embed_dim``, ``depth``, ``num_heads``, ``patch_embed_size``), from
which the predictor rebuilds the network. ``train_step`` in a checkpoint is
the JAX ``TrainState.step``, which counts skipped steps too; the
optimizer's count (the schedule's) comes from the optax state.
"""
from typing import Tuple

from ..models.primus import Primus, init_primus_
from .optimizers import nnunet_adamw
from .schedules import linear_warmup_poly
from .trainer import NNUNetTrainer
from .trainer_variants import nnUNet_Trainer_BS8  # noqa: F401 (re-export)


class AbstractPrimusTrainer(NNUNetTrainer):
    embed_dim: int = 396
    depth: int = 12
    num_heads: int = 6
    patch_embed_size: Tuple[int, int, int] = (8, 8, 8)
    skip_nonfinite = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.enable_deep_supervision = False
        self.initial_lr = 3e-4
        self.weight_decay = 5e-2
        self.warmup_epochs = 50

    def _init_args(self) -> dict:
        args = super()._init_args()
        args["primus_arch"] = {
            "embed_dim": int(self.embed_dim), "depth": int(self.depth),
            "num_heads": int(self.num_heads),
            "patch_embed_size": [int(p) for p in self.patch_embed_size]}
        return args

    def build_network_architecture(self):
        return Primus(
            input_channels=self.num_input_channels,
            embed_dim=self.embed_dim,
            patch_embed_size=self.patch_embed_size,
            num_classes=self.label_manager.num_segmentation_heads,
            depth=self.depth, num_heads=self.num_heads,
            patch_size=tuple(self.configuration_manager.patch_size),
            drop_path_rate=0.2, init_values=0.1,
            compute_dtype=self.compute_dtype, trainable=True)

    def init_network_weights(self, net, seed: int) -> None:
        init_primus_(net, seed)

    def _use_remat(self):
        return False   # the JAX Primus has no remat

    def configure_optimizer(self, total_steps: int):
        warmup_steps = self.warmup_epochs * self.num_iterations_per_epoch
        return nnunet_adamw(
            self.network.parameters(),
            linear_warmup_poly(self.initial_lr, total_steps, warmup_steps),
            weight_decay=self.weight_decay, b1=0.9, b2=0.98, grad_clip=1.0)

    def _train_step_count(self) -> int:
        return int(self.optimizer.count) + self.train_step.skipped

    def _restore_train_step_count(self, ckpt: dict) -> None:
        """The schedule count stays the optax state's; the steps beyond it
        are skipped ones."""
        if ckpt.get("optimizer_state") is None:
            super()._restore_train_step_count(ckpt)
        steps = int(ckpt.get("train_step", self.optimizer.count))
        self.train_step.skipped = max(steps - int(self.optimizer.count), 0)


class nnUNet_Primus_S_Trainer(AbstractPrimusTrainer):
    embed_dim, depth, num_heads = 396, 12, 6


class nnUNet_Primus_B_Trainer(AbstractPrimusTrainer):
    embed_dim, depth, num_heads = 792, 12, 12


class nnUNet_Primus_M_Trainer(AbstractPrimusTrainer):
    embed_dim, depth, num_heads = 864, 16, 12


class nnUNet_Primus_L_Trainer(AbstractPrimusTrainer):
    embed_dim, depth, num_heads = 1056, 24, 16


def _override_config(trainer, batch_size=None, patch_size=None):
    cfg = trainer.configuration_manager.configuration
    if batch_size is not None:
        cfg["batch_size"] = batch_size
    if patch_size is not None:
        cfg["patch_size"] = list(patch_size)


class nnUNet_Primus_M_Trainer_BS8(nnUNet_Primus_M_Trainer):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _override_config(self, batch_size=8)


class nnUNet_Primus_M_Trainer_BS8_2e4(nnUNet_Primus_M_Trainer):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.initial_lr = 2e-4
        _override_config(self, batch_size=8)


class _Primus_S_96_BS1(nnUNet_Primus_S_Trainer):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _override_config(self, batch_size=1, patch_size=(96, 96, 96))


class _Primus_B_96_BS1(nnUNet_Primus_B_Trainer):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _override_config(self, batch_size=1, patch_size=(96, 96, 96))


class _Primus_M_96_BS1(nnUNet_Primus_M_Trainer):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _override_config(self, batch_size=1, patch_size=(96, 96, 96))


class _Primus_L_48_BS1(nnUNet_Primus_L_Trainer):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _override_config(self, batch_size=1, patch_size=(48, 48, 48))
