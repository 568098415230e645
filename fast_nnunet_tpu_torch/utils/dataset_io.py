"""Raw-dataset layout helpers (a copy of fast_nnunet_tpu/utils/dataset_io.py):
``Dataset{ID}_{Name}/imagesTr|labelsTr`` plus ``dataset.json``, case files
named ``{identifier}_{channel:04d}{file_ending}``."""
import os
from typing import Dict, List, Optional

from . import io as ffo


def get_identifiers_from_splitted_dataset_folder(folder: str,
                                                 file_ending: str
                                                 ) -> List[str]:
    crop = len(file_ending) + 5  # _XXXX + ending
    return sorted(set(f[:-crop] for f in
                      ffo.subfiles(folder, suffix=file_ending,
                                   join_path=False)))


def _abs(raw_dataset_folder: str, f: str) -> str:
    return f if os.path.isabs(f) else \
        os.path.abspath(ffo.join(raw_dataset_folder, f))


def get_filenames_of_train_images_and_targets(
        raw_dataset_folder: str, dataset_json: Optional[dict] = None
) -> Dict[str, dict]:
    """identifier -> {"images": [one file per channel], "label": file}, from
    the ``dataset`` listing of dataset.json when it has one, else from
    imagesTr/labelsTr."""
    if dataset_json is None:
        dataset_json = ffo.load_json(ffo.join(raw_dataset_folder,
                                              "dataset.json"))
    if "dataset" in dataset_json:
        return {k: {"images": [_abs(raw_dataset_folder, i)
                               for i in v["images"]],
                    "label": _abs(raw_dataset_folder, v["label"])}
                for k, v in dataset_json["dataset"].items()}
    file_ending = dataset_json["file_ending"]
    num_channels = len(dataset_json.get("channel_names",
                                        dataset_json.get("modality", {0: 0})))
    identifiers = get_identifiers_from_splitted_dataset_folder(
        ffo.join(raw_dataset_folder, "imagesTr"), file_ending)
    return {ident: {
        "images": [ffo.join(raw_dataset_folder, "imagesTr",
                            f"{ident}_{c:04d}{file_ending}")
                   for c in range(num_channels)],
        "label": ffo.join(raw_dataset_folder, "labelsTr",
                          ident + file_ending)}
        for ident in identifiers}


def generate_dataset_json(output_folder: str, channel_names: dict,
                          labels: dict, num_training_cases: int,
                          file_ending: str,
                          regions_class_order: Optional[tuple] = None,
                          dataset_name: Optional[str] = None,
                          overwrite_image_reader_writer: Optional[str] = None,
                          **kwargs) -> dict:
    """Write ``output_folder/dataset.json`` and return it."""
    has_regions = any(isinstance(v, (tuple, list)) and len(v) > 1
                      for v in labels.values())
    if has_regions:
        assert regions_class_order is not None, \
            "region-based labels need regions_class_order"
    dataset_json = {
        "channel_names": {str(k): v for k, v in channel_names.items()},
        "labels": labels,
        "numTraining": num_training_cases,
        "file_ending": file_ending,
    }
    if dataset_name is not None:
        dataset_json["name"] = dataset_name
    if overwrite_image_reader_writer is not None:
        dataset_json["overwrite_image_reader_writer"] = \
            overwrite_image_reader_writer
    if regions_class_order is not None:
        dataset_json["regions_class_order"] = list(regions_class_order)
    dataset_json.update(kwargs)
    ffo.save_json(dataset_json, ffo.join(output_folder, "dataset.json"),
                  sort_keys=False)
    return dataset_json
