"""Residual-encoder planners — a copy of
fast_nnunet_tpu/planning/resenc_planner.py: deeper encoders (1, 3, 4, 6, 6,
...) with single-conv decoder stages, and the M/L/XL presets for 8/24/40 GB
memory targets. Their plans name ``ResidualEncoderUNet``, which the port's
network factory builds (models/unet.py) for training, distillation and
prediction."""
import warnings
from typing import List, Optional

from .planner import ExperimentPlanner


class ResEncUNetPlanner(ExperimentPlanner):
    UNet_class_name = "dynamic_network_architectures.architectures.unet.ResidualEncoderUNet"

    def __init__(self, dataset_name_or_id, gpu_memory_target_in_gb: float = 8,
                 preprocessor_name: str = "DefaultPreprocessor",
                 plans_name: str = "nnUNetResEncUNetPlans",
                 overwrite_target_spacing: Optional[List[float]] = None,
                 suppress_transpose: bool = False):
        super().__init__(dataset_name_or_id, gpu_memory_target_in_gb,
                         preprocessor_name, plans_name, overwrite_target_spacing,
                         suppress_transpose)
        self.UNet_reference_val_3d = 680000000
        self.UNet_reference_val_2d = 135000000
        self.UNet_blocks_per_stage_encoder = (1, 3, 4, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6)
        self.UNet_blocks_per_stage_decoder = (1,) * 12

    def _make_arch_kwargs(self, num_stages, conv_kernel_sizes, pool_op_kernel_sizes,
                          max_features, dim):
        arch = super()._make_arch_kwargs(num_stages, conv_kernel_sizes,
                                         pool_op_kernel_sizes, max_features, dim)
        kw = arch["arch_kwargs"]
        kw["n_blocks_per_stage"] = kw.pop("n_conv_per_stage")
        return arch


class nnUNetPlannerResEncM(ResEncUNetPlanner):
    """~8 GB memory target (ref :221-244)."""

    def __init__(self, dataset_name_or_id, gpu_memory_target_in_gb: float = 8,
                 preprocessor_name: str = "DefaultPreprocessor",
                 plans_name: str = "nnUNetResEncUNetMPlans",
                 overwrite_target_spacing=None, suppress_transpose: bool = False):
        if gpu_memory_target_in_gb != 8:
            warnings.warn(f"nnUNetPlannerResEncM expects 8 GB target, got "
                          f"{gpu_memory_target_in_gb}")
        super().__init__(dataset_name_or_id, gpu_memory_target_in_gb,
                         preprocessor_name, plans_name, overwrite_target_spacing,
                         suppress_transpose)
        self.UNet_reference_val_corresp_GB = 8
        self.UNet_reference_val_3d = 680000000
        self.UNet_reference_val_2d = 135000000
        self.max_dataset_covered = 1


class nnUNetPlannerResEncL(ResEncUNetPlanner):
    """~24 GB memory target (ref :247-270) — the default teacher plans for ResEnc
    distillation (fast_nnunet_resenc_distillation_train.py -tpl)."""

    def __init__(self, dataset_name_or_id, gpu_memory_target_in_gb: float = 24,
                 preprocessor_name: str = "DefaultPreprocessor",
                 plans_name: str = "nnUNetResEncUNetLPlans",
                 overwrite_target_spacing=None, suppress_transpose: bool = False):
        if gpu_memory_target_in_gb != 24:
            warnings.warn(f"nnUNetPlannerResEncL expects 24 GB target, got "
                          f"{gpu_memory_target_in_gb}")
        super().__init__(dataset_name_or_id, gpu_memory_target_in_gb,
                         preprocessor_name, plans_name, overwrite_target_spacing,
                         suppress_transpose)
        self.UNet_reference_val_corresp_GB = 24
        self.UNet_reference_val_3d = 2100000000
        self.UNet_reference_val_2d = 380000000
        self.max_dataset_covered = 1


class nnUNetPlannerResEncXL(ResEncUNetPlanner):
    """~40 GB memory target (ref :272-296)."""

    def __init__(self, dataset_name_or_id, gpu_memory_target_in_gb: float = 40,
                 preprocessor_name: str = "DefaultPreprocessor",
                 plans_name: str = "nnUNetResEncUNetXLPlans",
                 overwrite_target_spacing=None, suppress_transpose: bool = False):
        if gpu_memory_target_in_gb != 40:
            warnings.warn(f"nnUNetPlannerResEncXL expects 40 GB target, got "
                          f"{gpu_memory_target_in_gb}")
        super().__init__(dataset_name_or_id, gpu_memory_target_in_gb,
                         preprocessor_name, plans_name, overwrite_target_spacing,
                         suppress_transpose)
        self.UNet_reference_val_corresp_GB = 40
        self.UNet_reference_val_3d = 3600000000
        self.UNet_reference_val_2d = 560000000
        self.max_dataset_covered = 1
