"""Label bookkeeping: the subset of fast_nnunet_tpu/core/labels.py that the
turbo loader uses (plain labels, regions, the ignore label), copied."""
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

LabelValue = Union[int, Tuple[int, ...]]


class LabelManager:
    def __init__(self, label_dict: dict,
                 regions_class_order: Optional[Sequence[int]],
                 force_use_labels: bool = False):
        self._sanity_check(label_dict)
        self.label_dict = label_dict
        self.regions_class_order = list(regions_class_order) \
            if regions_class_order is not None else None
        self._force_use_labels = force_use_labels
        if force_use_labels:
            self._has_regions = False
        else:
            self._has_regions = any(
                isinstance(v, (tuple, list)) and len(v) > 1
                for v in label_dict.values())
        self._ignore_label = self._determine_ignore_label()
        self._all_labels = self._collect_all_labels()
        self._regions = self._collect_regions()
        if self.has_ignore_label and \
                self.ignore_label != max(self._all_labels) + 1:
            raise ValueError(
                "The ignore label must have the highest label value "
                f"(expected {max(self._all_labels) + 1}, "
                f"got {self.ignore_label}).")

    @staticmethod
    def _sanity_check(label_dict: dict) -> None:
        if "background" not in label_dict:
            raise ValueError("Label dict must declare 'background' (label 0).")
        bg = label_dict["background"]
        if isinstance(bg, (tuple, list)) or int(bg) != 0:
            raise ValueError(f"Background label must be the scalar 0, got {bg!r}.")

    def _collect_all_labels(self) -> List[int]:
        vals: List[int] = []
        for name, v in self.label_dict.items():
            if name == "ignore":
                continue
            if isinstance(v, (tuple, list)):
                vals.extend(int(x) for x in v)
            else:
                vals.append(int(v))
        return sorted(set(vals))

    def _collect_regions(self) -> Optional[List[LabelValue]]:
        if not self._has_regions or self._force_use_labels:
            return None
        if self.regions_class_order is None:
            raise ValueError("Region-based labels require regions_class_order.")
        regions: List[LabelValue] = []
        for name, v in self.label_dict.items():
            if name == "ignore":
                continue
            if np.isscalar(v) and v == 0:
                continue
            if isinstance(v, (tuple, list)):
                if set(int(x) for x in v) == {0}:
                    continue
                regions.append(tuple(int(x) for x in v))
            else:
                regions.append(int(v))
        if len(self.regions_class_order) != len(regions):
            raise ValueError("regions_class_order must have one entry per region.")
        return regions

    def _determine_ignore_label(self) -> Optional[int]:
        v = self.label_dict.get("ignore")
        if v is not None and not isinstance(v, int):
            raise ValueError(f"Ignore label must be an int, got {type(v)}.")
        return v

    @property
    def has_regions(self) -> bool:
        return self._has_regions

    @property
    def has_ignore_label(self) -> bool:
        return self._ignore_label is not None

    @property
    def ignore_label(self) -> Optional[int]:
        return self._ignore_label

    @property
    def all_labels(self) -> List[int]:
        return self._all_labels

    @property
    def num_segmentation_heads(self) -> int:
        """Output channels of the network: #regions if region-based else
        #labels."""
        return len(self._regions) if self.has_regions \
            else len(self._all_labels)

    @property
    def foreground_labels(self) -> List[int]:
        return [v for v in self._all_labels if v != 0]


def determine_num_input_channels(plans_manager, configuration_manager,
                                 dataset_json: dict) -> int:
    """Image channels, plus one-hot fg-label channels when this config is a
    cascade stage."""
    label_manager = plans_manager.get_label_manager(dataset_json)
    num_modalities = len(dataset_json["channel_names"]) \
        if "channel_names" in dataset_json else len(dataset_json["modality"])
    if configuration_manager.previous_stage_name is not None:
        num_modalities += len(label_manager.foreground_labels)
    return num_modalities
