"""Raw-dataset layout helpers that the predictor calls (a copy of part of
fast_nnunet_tpu/utils/dataset_io.py): case files are named
``{identifier}_{channel:04d}{file_ending}``."""
from typing import List

from .io import subfiles


def get_identifiers_from_splitted_dataset_folder(folder: str,
                                                 file_ending: str
                                                 ) -> List[str]:
    crop = len(file_ending) + 5  # _XXXX + ending
    return sorted(set(f[:-crop] for f in
                      subfiles(folder, suffix=file_ending, join_path=False)))
