"""Medical Segmentation Decathlon task -> nnU-Net v2 raw dataset — a copy of
fast_nnunet_tpu/dataset_conversion/convert_msd.py (the reference's
convert_MSD_dataset.py): 4D MSD volumes are split into one ``_XXXX`` file
per channel, and dataset.json is rewritten to the v2 schema.
``fast_nnunet_convert_msd_torch -i TaskXX_Name [-overwrite_id N]``."""
import argparse
import os
import shutil
from typing import Optional

import numpy as np

from ..imageio.nifti import read_nifti, write_nifti
from ..utils.dataset_io import generate_dataset_json
from ..utils.io import isdir, join, load_json, maybe_mkdir_p, subfiles


def _split_4d_file(src: str, target_folder: str, identifier: str,
                   file_ending: str = ".nii.gz") -> int:
    data, hdr = read_nifti(src)
    if data.ndim == 3:
        shutil.copy(src, join(target_folder, f"{identifier}_0000{file_ending}"))
        return 1
    assert data.ndim == 4, f"{src}: expected 3D or 4D"
    n = data.shape[3]
    for c in range(n):
        hdr_c = dict(hdr)
        hdr_c["dim"] = [3] + list(data.shape[:3]) + [1, 1, 1, 1]
        write_nifti(join(target_folder, f"{identifier}_{c:04d}{file_ending}"),
                    np.ascontiguousarray(data[..., c]), header=hdr_c)
    return n


def convert_msd_dataset(source_folder: str,
                        overwrite_target_id: Optional[int] = None,
                        num_processes: int = 8) -> str:
    """source_folder: an extracted MSD task (e.g. Task04_Hippocampus)."""
    from ..paths import get_raw_folder
    source_folder = source_folder.rstrip("/")
    task_name = os.path.basename(source_folder)
    assert task_name.startswith("Task"), \
        f"expected a TaskXX_Name folder, got {task_name}"
    task_id = int(task_name[4:6])
    name = task_name[7:]
    target_id = overwrite_target_id if overwrite_target_id is not None else task_id
    target_name = f"Dataset{target_id:03d}_{name}"
    target = join(get_raw_folder(), target_name)
    maybe_mkdir_p(join(target, "imagesTr"))
    maybe_mkdir_p(join(target, "labelsTr"))

    old_json = load_json(join(source_folder, "dataset.json"))
    file_ending = ".nii.gz"

    n_channels = 1
    n_train = 0
    for f in subfiles(join(source_folder, "imagesTr"), suffix=file_ending,
                      join_path=False):
        if f.startswith("."):
            continue  # MSD tars ship mac metadata files
        ident = f[: -len(file_ending)]
        n_channels = _split_4d_file(join(source_folder, "imagesTr", f),
                                    join(target, "imagesTr"), ident, file_ending)
        shutil.copy(join(source_folder, "labelsTr", f),
                    join(target, "labelsTr", f))
        n_train += 1

    if isdir(join(source_folder, "imagesTs")):
        maybe_mkdir_p(join(target, "imagesTs"))
        for f in subfiles(join(source_folder, "imagesTs"), suffix=file_ending,
                          join_path=False):
            if f.startswith("."):
                continue
            ident = f[: -len(file_ending)]
            _split_4d_file(join(source_folder, "imagesTs", f),
                           join(target, "imagesTs"), ident, file_ending)

    # MSD labels dict is {value: name}; v2 wants {name: value}
    labels = {v: int(k) for k, v in old_json["labels"].items()}
    channel_names = {int(k): v for k, v in
                     old_json.get("modality", {"0": "CT"}).items()}
    generate_dataset_json(target, channel_names, labels, n_train, file_ending,
                          dataset_name=target_name,
                          description=old_json.get("description", ""),
                          reference=old_json.get("reference", ""),
                          licence=old_json.get("licence", ""))
    print(f"Converted {task_name} -> {target}")
    return target


def convert_msd_entry(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-i", required=True, help="extracted MSD task folder")
    parser.add_argument("-overwrite_id", type=int, default=None)
    parser.add_argument("-np", type=int, default=8)
    args = parser.parse_args(argv)
    convert_msd_dataset(args.i, args.overwrite_id, args.np)
