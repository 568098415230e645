"""Dataset integrity check — a copy of fast_nnunet_tpu/planning/verify.py:
dataset.json against the files, label values, image/label geometry."""
import numpy as np

from ..imageio.registry import determine_reader_writer_from_dataset_json
from ..utils.dataset_io import get_filenames_of_train_images_and_targets
from ..utils.io import isfile, join, load_json


def verify_dataset_integrity(dataset_name: str, num_processes: int = 8) -> None:
    from ..paths import get_raw_folder
    folder = join(get_raw_folder(), dataset_name)
    assert isfile(join(folder, "dataset.json")), f"dataset.json missing in {folder}"
    dataset_json = load_json(join(folder, "dataset.json"))

    for required in ("labels", "numTraining", "file_ending"):
        assert required in dataset_json, f"dataset.json missing key '{required}'"
    assert "channel_names" in dataset_json or "modality" in dataset_json, \
        "dataset.json needs 'channel_names'"

    dataset = get_filenames_of_train_images_and_targets(folder, dataset_json)
    assert len(dataset) == dataset_json["numTraining"], (
        f"numTraining={dataset_json['numTraining']} but found {len(dataset)} "
        "cases in imagesTr")

    missing = []
    for ident, entry in dataset.items():
        for f in entry["images"] + [entry["label"]]:
            if not isfile(f):
                missing.append(f)
    assert not missing, f"Missing files: {missing[:10]}"

    # collect allowed labels
    from ..core.labels import LabelManager
    lm = LabelManager(dataset_json["labels"],
                      dataset_json.get("regions_class_order"))
    allowed = set(lm.all_labels)
    if lm.has_ignore_label:
        allowed.add(lm.ignore_label)

    rw = determine_reader_writer_from_dataset_json(
        dataset_json, dataset[next(iter(dataset))]["images"][0])()
    for ident, entry in dataset.items():
        images, iprops = rw.read_images(entry["images"])
        seg, sprops = rw.read_seg(entry["label"])
        assert images.shape[1:] == seg.shape[1:], (
            f"{ident}: image/seg shape mismatch {images.shape[1:]} vs "
            f"{seg.shape[1:]}")
        assert np.allclose(iprops["spacing"], sprops["spacing"], rtol=1e-3), (
            f"{ident}: image/seg spacing mismatch")
        present = set(np.unique(seg).astype(int).tolist())
        bad = present - allowed
        assert not bad, f"{ident}: unexpected labels {bad} (allowed: {allowed})"
        assert not np.any(np.isnan(images)), f"{ident}: NaNs in image"
    print(f"Dataset {dataset_name}: integrity OK ({len(dataset)} cases)")
