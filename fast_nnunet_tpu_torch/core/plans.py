"""Plans handling: the subset of fast_nnunet_tpu/core/plans.py that the turbo
loader uses, copied (same plans.json schema, inheritance resolution)."""
import json
from typing import List, Optional, Union

from .labels import LabelManager


class ConfigurationManager:
    """Typed view over one (inheritance-resolved) configuration dict."""

    def __init__(self, configuration_dict: dict):
        self.configuration = configuration_dict

    @property
    def patch_size(self) -> List[int]:
        return list(self.configuration["patch_size"])

    @property
    def spacing(self) -> List[float]:
        return list(self.configuration["spacing"])

    @property
    def normalization_schemes(self) -> List[str]:
        return self.configuration["normalization_schemes"]

    @property
    def previous_stage_name(self) -> Optional[str]:
        return self.configuration.get("previous_stage")


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
    def foreground_intensity_properties_per_channel(self) -> dict:
        if "foreground_intensity_properties_per_channel" not in self.plans:
            if "foreground_intensity_properties_by_modality" in self.plans:
                return self.plans["foreground_intensity_properties_by_modality"]
        return self.plans["foreground_intensity_properties_per_channel"]
