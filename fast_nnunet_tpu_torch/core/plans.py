"""Plans handling: the subset of fast_nnunet_tpu/core/plans.py that the turbo
loader, the preprocessor, the predictor, the export and the trainers read,
copied (same plans.json schema, inheritance resolution). Image reader/writers resolve to
the port's NIfTI classes only."""
import json
from typing import List, Optional, Union

from .labels import LabelManager


class ConfigurationManager:
    """Typed view over one (inheritance-resolved) configuration dict."""

    def __init__(self, configuration_dict: dict):
        self.configuration = configuration_dict

    @property
    def data_identifier(self) -> str:
        return self.configuration["data_identifier"]

    @property
    def batch_size(self) -> int:
        return self.configuration["batch_size"]

    @property
    def batch_dice(self) -> bool:
        return self.configuration["batch_dice"]

    @property
    def patch_size(self) -> List[int]:
        return list(self.configuration["patch_size"])

    @property
    def pool_op_kernel_sizes(self) -> List[List[int]]:
        return [list(s) for s in
                self.configuration["architecture"]["arch_kwargs"]["strides"]]

    @property
    def spacing(self) -> List[float]:
        return list(self.configuration["spacing"])

    @property
    def normalization_schemes(self) -> List[str]:
        return self.configuration["normalization_schemes"]

    @property
    def use_mask_for_norm(self) -> List[bool]:
        return self.configuration["use_mask_for_norm"]

    @property
    def previous_stage_name(self) -> Optional[str]:
        return self.configuration.get("previous_stage")

    @property
    def next_stage_names(self) -> Optional[List[str]]:
        ret = self.configuration.get("next_stage")
        return [ret] if isinstance(ret, str) else ret

    @property
    def resampling_fn_data(self):
        return self._resampling_fn("resampling_fn_data")

    @property
    def resampling_fn_seg(self):
        return self._resampling_fn("resampling_fn_seg")

    @property
    def resampling_fn_probabilities(self):
        return self._resampling_fn("resampling_fn_probabilities")

    def _resampling_fn(self, key: str):
        """The plans' function name and kwargs, resolved and bound."""
        from ..ops.resampling import resolve_resampling_fn
        return resolve_resampling_fn(self.configuration[key],
                                     self.configuration[key + "_kwargs"])


class PlansManager:
    """Loads a plans dict/JSON and hands out inheritance-resolved
    configurations."""

    def __init__(self, plans: Union[str, dict]):
        if isinstance(plans, str):
            with open(plans) as f:
                plans = json.load(f)
        self.plans = plans
        self._config_cache: dict = {}
        self._label_manager_cache: dict = {}

    def _resolve_configuration_inheritance(self, configuration_name: str,
                                           visited: Optional[set] = None
                                           ) -> dict:
        if configuration_name not in self.plans["configurations"]:
            raise ValueError(
                f"Requested configuration {configuration_name} not found in "
                f"plans {self.plans.get('plans_name')}. Available: "
                f"{list(self.plans['configurations'].keys())}")
        configuration = dict(self.plans["configurations"][configuration_name])
        if "inherits_from" in configuration:
            parent_name = configuration["inherits_from"]
            if visited is None:
                visited = {configuration_name}
            elif parent_name in visited:
                raise RuntimeError(
                    f"Circular 'inherits_from' detected involving "
                    f"{parent_name} (chain: {visited}).")
            visited.add(parent_name)
            base = self._resolve_configuration_inheritance(parent_name,
                                                           visited)
            base.update(configuration)
            configuration = base
        return configuration

    def get_configuration(self, configuration_name: str
                          ) -> ConfigurationManager:
        if configuration_name not in self._config_cache:
            cfg = self._resolve_configuration_inheritance(configuration_name)
            self._config_cache[configuration_name] = ConfigurationManager(cfg)
        return self._config_cache[configuration_name]

    def get_label_manager(self, dataset_json: dict, **kwargs) -> LabelManager:
        key = id(dataset_json)
        if key not in self._label_manager_cache:
            self._label_manager_cache[key] = LabelManager(
                label_dict=dataset_json["labels"],
                regions_class_order=dataset_json.get("regions_class_order"),
                **kwargs)
        return self._label_manager_cache[key]

    @property
    def dataset_name(self) -> str:
        return self.plans["dataset_name"]

    @property
    def available_configurations(self) -> List[str]:
        return list(self.plans["configurations"].keys())

    @property
    def plans_name(self) -> str:
        return self.plans["plans_name"]

    @property
    def transpose_forward(self) -> List[int]:
        return self.plans["transpose_forward"]

    @property
    def transpose_backward(self) -> List[int]:
        return self.plans["transpose_backward"]

    def image_reader_writer_class(self):
        from ..imageio.registry import find_reader_writer_by_name
        return find_reader_writer_by_name(self.plans["image_reader_writer"])

    @property
    def foreground_intensity_properties_per_channel(self) -> dict:
        if "foreground_intensity_properties_per_channel" not in self.plans:
            if "foreground_intensity_properties_by_modality" in self.plans:
                return self.plans["foreground_intensity_properties_by_modality"]
        return self.plans["foreground_intensity_properties_per_channel"]
