"""``fast_nnunet_convert_b2nd_torch -i SRC -o DST [--fnnz]``: migrate a
folder that the reference nnU-Net preprocessed (``{id}.b2nd``,
``{id}_seg.b2nd``, ``{id}.pkl``) into the port's case store, ``.npy``
(``training/dataset.py``) or, with ``--fnnz``, chunked zstd
(``training/zstd_store.py``) — a copy of fast_nnunet_tpu/run/convert_b2nd.py.
The properties pickles are copied as they are (the schema is shared); the
folder's other files and subfolders ride along."""
import argparse
import os
import shutil

import numpy as np

from ..training.dataset import NpyCaseDataset
from ..training.zstd_store import ZstdCaseDataset
from ..utils.b2nd import read_b2nd
from ..utils.io import load_pickle


def convert_case(src_truncated: str, dst_truncated: str,
                 use_fnnz: bool = False, patch_size=None) -> None:
    data = read_b2nd(src_truncated + ".b2nd").astype(np.float32, copy=False)
    seg = None
    if os.path.isfile(src_truncated + "_seg.b2nd"):
        seg = read_b2nd(src_truncated + "_seg.b2nd")
    props = load_pickle(src_truncated + ".pkl") \
        if os.path.isfile(src_truncated + ".pkl") else {}
    if use_fnnz:
        ZstdCaseDataset.save_case(data, seg, props, dst_truncated,
                                  patch_size=patch_size)
    else:
        NpyCaseDataset.save_case(data, seg, props, dst_truncated)


def convert_folder(src: str, dst: str, use_fnnz: bool = False,
                   patch_size=None) -> int:
    """Convert every case of ``src`` into ``dst``; returns the count."""
    os.makedirs(dst, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(src)):
        full = os.path.join(src, name)
        if name.endswith("_seg.b2nd"):
            continue
        if name.endswith(".b2nd"):
            ident = name[:-len(".b2nd")]
            convert_case(os.path.join(src, ident), os.path.join(dst, ident),
                         use_fnnz, patch_size)
            n += 1
        elif os.path.isfile(full) and not name.endswith(".pkl"):
            shutil.copy(full, os.path.join(dst, name))
        elif os.path.isdir(full):
            shutil.copytree(full, os.path.join(dst, name), dirs_exist_ok=True)
    return n


def convert_b2nd_entry(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="convert a reference blosc2 (.b2nd) preprocessed folder "
                    "to the port's case store")
    ap.add_argument("-i", required=True,
                    help="source folder (with .b2nd files)")
    ap.add_argument("-o", required=True, help="destination folder")
    ap.add_argument("--fnnz", action="store_true",
                    help="write the chunked-zstd .fnnz store instead of .npy")
    args = ap.parse_args(argv)
    n = convert_folder(args.i, args.o, use_fnnz=args.fnnz)
    print(f"converted {n} cases -> {args.o}")


if __name__ == "__main__":
    convert_b2nd_entry()
