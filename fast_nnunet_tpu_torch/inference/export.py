"""Prediction export on the host (numpy/scipy), copied from
fast_nnunet_tpu/inference/export.py: resample the logits back to the
cropped original grid, convert them to a segmentation, revert the crop and
the transpose, write with the plans' reader/writer; and, for the cascade,
:func:`resample_and_save`, a stage's prediction on the next stage's
grid."""
from typing import Union

import numpy as np

from ..core.labels import LabelManager
from ..core.plans import ConfigurationManager, PlansManager
from ..utils.io import load_json, save_pickle


def convert_predicted_logits_to_segmentation_with_correct_shape(
        predicted_logits: np.ndarray, plans_manager: PlansManager,
        configuration_manager: ConfigurationManager,
        label_manager: LabelManager, properties_dict: dict,
        return_probabilities: bool = False):
    """predicted_logits: (K, *resampled_shape) float32 in the preprocessed
    (transposed, cropped, resampled) space."""
    spacing_transposed = [properties_dict["spacing"][i]
                          for i in plans_manager.transpose_forward]
    current_spacing = configuration_manager.spacing
    shape_cropped = properties_dict[
        "shape_after_cropping_and_before_resampling"]
    if len(current_spacing) < len(shape_cropped):
        current_spacing = [spacing_transposed[0]] + list(current_spacing)
    predicted_logits = configuration_manager.resampling_fn_probabilities(
        predicted_logits, shape_cropped, current_spacing, spacing_transposed)

    if return_probabilities:
        probabilities = label_manager.apply_inference_nonlin(predicted_logits)
        segmentation = label_manager.convert_probabilities_to_segmentation(
            probabilities)
    else:
        segmentation = label_manager.convert_logits_to_segmentation(
            predicted_logits)

    seg_reverted = np.zeros(properties_dict["shape_before_cropping"],
                            dtype=np.uint8
                            if len(label_manager.foreground_labels) < 255
                            else np.uint16)
    bbox = properties_dict["bbox_used_for_cropping"]
    seg_reverted[tuple(slice(b[0], b[1]) for b in bbox)] = segmentation
    seg_reverted = seg_reverted.transpose(plans_manager.transpose_backward)

    if return_probabilities:
        probabilities = label_manager.revert_cropping_on_probabilities(
            probabilities, bbox, properties_dict["shape_before_cropping"])
        probabilities = probabilities.transpose(
            [0] + [i + 1 for i in plans_manager.transpose_backward])
        return seg_reverted, probabilities
    return seg_reverted


def export_prediction_from_logits(predicted_logits: np.ndarray,
                                  properties_dict: dict,
                                  configuration_manager: ConfigurationManager,
                                  plans_manager: PlansManager,
                                  dataset_json: Union[dict, str],
                                  output_file_truncated: str,
                                  save_probabilities: bool = False) -> None:
    if isinstance(dataset_json, str):
        dataset_json = load_json(dataset_json)
    label_manager = plans_manager.get_label_manager(dataset_json)
    ret = convert_predicted_logits_to_segmentation_with_correct_shape(
        predicted_logits, plans_manager, configuration_manager, label_manager,
        properties_dict, return_probabilities=save_probabilities)
    if save_probabilities:
        segmentation, probabilities = ret
        np.savez_compressed(output_file_truncated + ".npz",
                            probabilities=probabilities.astype(np.float16))
        save_pickle(properties_dict, output_file_truncated + ".pkl")
    else:
        segmentation = ret
    rw = plans_manager.image_reader_writer_class()()
    rw.write_seg(segmentation,
                 output_file_truncated + dataset_json["file_ending"],
                 properties_dict)


def resample_and_save(predicted_logits: np.ndarray, target_shape,
                      output_file: str, plans_manager: PlansManager,
                      configuration_manager: ConfigurationManager,
                      properties_dict: dict,
                      dataset_json: Union[dict, str]) -> None:
    """Cascade: resample this stage's logits to ``target_shape`` (the next
    stage's preprocessed grid) and save their segmentation as the next
    stage's prior, ``np.savez_compressed(output_file, seg=uint8)``."""
    if isinstance(dataset_json, str):
        dataset_json = load_json(dataset_json)
    spacing_transposed = [properties_dict["spacing"][i]
                          for i in plans_manager.transpose_forward]
    current_spacing = configuration_manager.spacing
    if len(current_spacing) < len(target_shape):
        current_spacing = [spacing_transposed[0]] + list(current_spacing)
    target_spacing = configuration_manager.spacing
    resampled = configuration_manager.resampling_fn_probabilities(
        predicted_logits, target_shape, current_spacing, target_spacing)
    label_manager = plans_manager.get_label_manager(dataset_json)
    segmentation = label_manager.convert_logits_to_segmentation(resampled)
    np.savez_compressed(output_file, seg=segmentation.astype(np.uint8))

