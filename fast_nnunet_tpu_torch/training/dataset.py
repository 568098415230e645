"""Preprocessed case store — the ``.npy`` store of
fast_nnunet_tpu/training/dataset.py, copied: one memmap-able ``{id}.npy``
(data, float32 (C, X, Y, Z)), one ``{id}_seg.npy`` (int8/int16 (1, X, Y, Z))
and one ``{id}.pkl`` (properties incl. ``class_locations``) per case. The
chunked-zstd ``.fnnz`` store and the reference's blosc2 ``.b2nd`` store are
not ported: :func:`infer_dataset_class` raises ``NotImplementedError`` for a
folder that holds them."""
import os
from typing import List, Optional, Tuple

import numpy as np

from ..utils.io import load_pickle, save_pickle, subfiles


class NpyCaseDataset:
    suffix_data = ".npy"
    suffix_seg = "_seg.npy"
    suffix_props = ".pkl"

    def __init__(self, folder: str, identifiers: Optional[List[str]] = None):
        self.folder = folder
        if identifiers is None:
            identifiers = self.get_identifiers(folder)
        self.identifiers = list(identifiers)

    @staticmethod
    def get_identifiers(folder: str) -> List[str]:
        files = subfiles(folder, suffix=NpyCaseDataset.suffix_props,
                         join_path=False)
        return sorted(f[: -len(NpyCaseDataset.suffix_props)] for f in files)

    def __len__(self):
        return len(self.identifiers)

    def keys(self):
        return list(self.identifiers)

    @classmethod
    def save_case(cls, data: np.ndarray, seg: Optional[np.ndarray],
                  properties: dict, output_filename_truncated: str) -> None:
        np.save(output_filename_truncated + cls.suffix_data,
                np.ascontiguousarray(data, dtype=np.float32))
        if seg is not None:
            seg_dtype = np.int16 if (seg.max() > 127 or seg.min() < -128) \
                else np.int8
            np.save(output_filename_truncated + cls.suffix_seg,
                    np.ascontiguousarray(seg, dtype=seg_dtype))
        save_pickle(properties, output_filename_truncated + cls.suffix_props)

    def load_case(self, identifier: str, mmap: bool = True
                  ) -> Tuple[np.ndarray, Optional[np.ndarray], dict]:
        base = os.path.join(self.folder, identifier)
        mmap_mode = "r" if mmap else None
        data = np.load(base + self.suffix_data, mmap_mode=mmap_mode)
        seg_path = base + self.suffix_seg
        seg = np.load(seg_path, mmap_mode=mmap_mode) \
            if os.path.isfile(seg_path) else None
        properties = load_pickle(base + self.suffix_props)
        return data, seg, properties

    def load_properties(self, identifier: str) -> dict:
        return load_pickle(os.path.join(self.folder, identifier)
                           + self.suffix_props)


def infer_dataset_class(folder: str):
    """The store class for the files in ``folder``: ``.npy`` is ported; a
    ``.fnnz`` (chunked zstd) or ``.b2nd`` (blosc2) store raises."""
    try:
        names = os.listdir(folder)
    except OSError:
        names = []
    for ext in (".fnnz", ".b2nd"):
        if any(n.endswith(ext) for n in names):
            raise NotImplementedError(
                f"the {ext} case store is not ported; convert the dataset "
                "to the .npy store")
    return NpyCaseDataset
