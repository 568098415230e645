"""Lite students for distillation (a copy of fast_nnunet_tpu/models/
students.py): features f -> max(f // r, 8) per stage, residual block counts
mapped by strategy; ``build_lite_student`` builds the LiteNNUNetStudent /
LiteResEncStudent as a reduced instance of the teacher's architecture."""
from typing import Sequence

import torch

from .factory import get_network_from_plans

MIN_STUDENT_FEATURES = 8


def reduce_features(features_per_stage: Sequence[int],
                    reduction_factor: int) -> tuple:
    return tuple(max(int(f) // reduction_factor, MIN_STUDENT_FEATURES)
                 for f in features_per_stage)


def apply_block_strategy(n_blocks_per_stage: Sequence[int],
                         strategy: str) -> tuple:
    """Map teacher residual block counts to the student's
    (reduce / keep / increase / adaptive)."""
    blocks = [int(b) for b in n_blocks_per_stage]
    if strategy == "reduce":
        return tuple(max(1, b // 2) for b in blocks)
    if strategy == "keep":
        return tuple(blocks)
    if strategy == "increase":
        return tuple(b + 1 for b in blocks)
    if strategy == "adaptive":
        n = len(blocks)
        return tuple(b if i < n // 2 else max(1, b // 2)
                     for i, b in enumerate(blocks))
    raise ValueError(f"Unknown block_reduction_strategy '{strategy}' "
                     "(expected reduce/keep/increase/adaptive)")


def build_student_arch_kwargs(teacher_arch_kwargs: dict,
                              reduction_factor: int = 2,
                              block_reduction_strategy: str = "reduce"
                              ) -> dict:
    kw = dict(teacher_arch_kwargs)
    kw["features_per_stage"] = list(reduce_features(kw["features_per_stage"],
                                                    reduction_factor))
    if kw.get("n_blocks_per_stage") is not None:
        kw["n_blocks_per_stage"] = list(apply_block_strategy(
            kw["n_blocks_per_stage"], block_reduction_strategy))
    return kw


def build_lite_student(arch_class_name: str, teacher_arch_kwargs: dict,
                       input_channels: int, num_classes: int,
                       reduction_factor: int = 2,
                       block_reduction_strategy: str = "reduce",
                       compute_dtype: torch.dtype = torch.bfloat16, **kw):
    """A LiteNNUNetStudent / LiteResEncStudent: the teacher's architecture
    class at the reduced kwargs (``kw`` goes to the factory: ``remat``,
    ``norm_onepass``, ``trainable``)."""
    return get_network_from_plans(
        arch_class_name, build_student_arch_kwargs(
            teacher_arch_kwargs, reduction_factor, block_reduction_strategy),
        (), input_channels, num_classes, compute_dtype=compute_dtype, **kw)
