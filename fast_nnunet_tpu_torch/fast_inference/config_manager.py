"""Per-model inference config — the port's copy of
fast_nnunet_tpu/fast_inference/config_manager.py. Schema of the reference's
inference/config/3d_fullres/sample_config.json (patch_size, target_spacing,
intensity_properties{mean,std,percentile_00_5,percentile_99_5}, model_path),
extended with the fields the exporter writes (export/export_model.py)."""
import os
from typing import Optional

from ..utils.io import join, load_json


class ConfigManager:
    REQUIRED = ("patch_size", "target_spacing", "intensity_properties",
                "model_path")

    def __init__(self, config_file_or_dict):
        if isinstance(config_file_or_dict, str):
            self.config_dir = os.path.dirname(os.path.abspath(config_file_or_dict))
            self.config = load_json(config_file_or_dict)
        else:
            self.config_dir = os.getcwd()
            self.config = dict(config_file_or_dict)
        missing = [k for k in self.REQUIRED if k not in self.config
                   and not (k == "model_path" and "artifact" in self.config)]
        if missing:
            raise ValueError(f"inference config missing keys: {missing}")

    @property
    def patch_size(self):
        return tuple(int(p) for p in self.config["patch_size"])

    @property
    def target_spacing(self):
        return tuple(float(s) for s in self.config["target_spacing"])

    @property
    def intensity_properties(self) -> dict:
        ip = self.config["intensity_properties"]
        # both flat (reference style) and per-channel (our exporter) layouts
        if "mean" in ip:
            return {"0": ip}
        return ip

    @property
    def model_path(self) -> str:
        p = self.config.get("model_path") or self.config.get("artifact")
        if not os.path.isabs(p):
            p = join(self.config_dir, p)
        return p

    @property
    def num_classes(self) -> Optional[int]:
        return self.config.get("num_classes")

    @property
    def tile_batch(self) -> int:
        """Tile batch the artifact was exported with. An exported program
        has a FIXED leading batch dim (export_model.py `-b`); serving must
        feed exactly that many patches per call, so the engine's tile_batch
        is read from the exported input_shape (fallback: explicit tile_batch
        key, then 1)."""
        shape = self.config.get("input_shape")
        if shape:
            return max(1, int(shape[0]))
        return max(1, int(self.config.get("tile_batch", 1)))

    @property
    def labels(self) -> Optional[dict]:
        return self.config.get("labels")

    @property
    def compute_dtype(self) -> str:
        """Engine compute dtype — matches what the artifact was traced with
        (export_model.py writes it) so the serving path doesn't round patch
        data through bfloat16 in front of a float32 artifact."""
        return str(self.config.get("compute_dtype", "bfloat16"))

    @property
    def tile_step_size(self) -> float:
        return float(self.config.get("tile_step_size", 0.5))

    @property
    def use_gaussian(self) -> bool:
        return bool(self.config.get("use_gaussian", True))

    @property
    def use_mirroring(self) -> bool:
        return bool(self.config.get("use_mirroring", False))

    @property
    def mirroring_baked_into_artifact(self) -> bool:
        return bool(self.config.get("mirroring_baked_into_artifact", False))

    @property
    def mirror_axes(self):
        return tuple(self.config.get("inference_allowed_mirroring_axes", (0, 1, 2)))

    @property
    def normalization_schemes(self):
        return self.config.get("normalization_schemes", ["CTNormalization"])

    @property
    def transpose_forward(self):
        return list(self.config.get("transpose_forward", [0, 1, 2]))

    @property
    def transpose_backward(self):
        return list(self.config.get("transpose_backward", [0, 1, 2]))
