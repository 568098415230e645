"""Label bookkeeping: fast_nnunet_tpu/core/labels.py copied (plain labels,
regions, the ignore label, and the host-side numpy conversions from logits
to probabilities and segmentations that the export uses)."""
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
    def all_regions(self) -> Optional[List[LabelValue]]:
        return self._regions

    @property
    def foreground_regions(self) -> Optional[List[LabelValue]]:
        return self.filter_background(self._regions) \
            if self._regions is not None else None

    @property
    def foreground_labels(self) -> List[int]:
        return self.filter_background(self._all_labels)

    def apply_inference_nonlin(self, logits: np.ndarray) -> np.ndarray:
        """(c, x, y, z) logits -> probabilities (sigmoid for regions,
        softmax else)."""
        logits = np.asarray(logits, dtype=np.float32)
        if self.has_regions:
            return 1.0 / (1.0 + np.exp(-logits))
        e = np.exp(logits - logits.max(axis=0, keepdims=True))
        return e / e.sum(axis=0, keepdims=True)

    def convert_probabilities_to_segmentation(self, probs: np.ndarray
                                              ) -> np.ndarray:
        if probs.shape[0] != self.num_segmentation_heads:
            raise ValueError(f"Expected {self.num_segmentation_heads} "
                             f"channels, got {probs.shape[0]}.")
        if self.has_regions:
            seg = np.zeros(probs.shape[1:], dtype=np.uint16)
            for i, c in enumerate(self.regions_class_order):
                seg[probs[i] > 0.5] = c
            return seg
        return probs.argmax(0)

    def convert_logits_to_segmentation(self, logits: np.ndarray
                                       ) -> np.ndarray:
        # argmax is invariant to softmax: the nonlin matters for regions only
        if self.has_regions:
            return self.convert_probabilities_to_segmentation(
                self.apply_inference_nonlin(logits))
        return np.asarray(logits).argmax(0)

    def revert_cropping_on_probabilities(self, probs: np.ndarray,
                                         bbox: List[List[int]],
                                         original_shape: Sequence[int]
                                         ) -> np.ndarray:
        out = np.zeros((probs.shape[0], *original_shape), dtype=probs.dtype)
        if not self.has_regions:
            out[0] = 1  # the padded area is certainly background
        out[(slice(None),) + tuple(slice(b[0], b[1]) for b in bbox)] = probs
        return out

    @staticmethod
    def filter_background(classes_or_regions):
        def is_bg(v):
            if isinstance(v, (tuple, list)):
                return set(int(x) for x in v) == {0}
            return v == 0
        return [v for v in classes_or_regions if not is_bg(v)]


def convert_labelmap_to_one_hot(segmentation: np.ndarray,
                                all_labels: Sequence[int],
                                dtype=np.uint8) -> np.ndarray:
    """(x, y, z) labelmap -> (len(all_labels), x, y, z) one-hot: the
    cascade's previous-stage segmentation as extra input channels."""
    out = np.zeros((len(all_labels), *segmentation.shape), dtype=dtype)
    for i, lbl in enumerate(all_labels):
        out[i][segmentation == lbl] = 1
    return out


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
