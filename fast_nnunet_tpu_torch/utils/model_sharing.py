"""Trained-model export and import as zip archives — the port of
fast_nnunet_tpu/utils/model_sharing.py (ref distillation/nnunetv2/
model_sharing/{model_export,model_import,model_download,entry_points}.py).

The archive holds paths relative to ``nnUNet_results``
(``Dataset.../Trainer__Plans__configuration/{plans,dataset}.json`` and
``fold_X/<checkpoint>``), as the JAX package's does, and both packages
write the same ``.fnnx`` checkpoints: a zip written by either installs
through the other. The port deflates at level 1, where JAX takes zlib's
default 6: checkpoints are float arrays that deflate barely shrinks, and
level 1 writes a teacher's 200 MB several times faster (the entries are
the same bytes). The download is the standard library's ``urllib``, as in
JAX."""
import argparse
import os
import zipfile

from . import io as ffo
from .misc import get_output_folder, maybe_convert_to_dataset_name


def export_pretrained_model(dataset_name_or_id, output_file: str,
                            configurations=("3d_fullres",),
                            trainer: str = "NNUNetTrainer",
                            plans_identifier: str = "nnUNetPlans",
                            folds=(0, 1, 2, 3, 4),
                            strict: bool = True,
                            save_checkpoints=("checkpoint_final.fnnx",),
                            export_crossval_predictions: bool = False) -> None:
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    with zipfile.ZipFile(output_file, "w", zipfile.ZIP_DEFLATED,
                         allowZip64=True, compresslevel=1) as zf:
        for c in configurations:
            folder = get_output_folder(dataset_name, trainer, plans_identifier, c)
            if not ffo.isdir(folder):
                if strict:
                    raise RuntimeError(f"{folder} missing: train it first or "
                                       "use strict=False")
                continue
            rel_root = os.path.dirname(os.path.dirname(folder))
            for fname in ("plans.json", "dataset.json"):
                p = ffo.join(folder, fname)
                if ffo.isfile(p):
                    zf.write(p, os.path.relpath(p, rel_root))
            for f in folds:
                fold_dir = ffo.join(folder, f"fold_{f}")
                if not ffo.isdir(fold_dir):
                    if strict:
                        raise RuntimeError(f"fold {f} of {folder} missing")
                    continue
                for ck in save_checkpoints:
                    p = ffo.join(fold_dir, ck)
                    if ffo.isfile(p):
                        zf.write(p, os.path.relpath(p, rel_root))
                if export_crossval_predictions and \
                        ffo.isdir(ffo.join(fold_dir, "validation")):
                    for vf in ffo.subfiles(ffo.join(fold_dir, "validation"),
                                           join_path=True):
                        zf.write(vf, os.path.relpath(vf, rel_root))
    print(f"Exported {dataset_name} to {output_file}")


def install_model_from_zip_file(zip_file: str) -> None:
    from ..paths import get_results_folder
    with zipfile.ZipFile(zip_file) as zf:
        zf.extractall(get_results_folder())
    print(f"Installed model(s) from {zip_file} into {get_results_folder()}")


def download_file(url: str, local_filename: str,
                  chunk_size: int = 8192 * 16) -> str:
    """Stream a URL to disk (stdlib urllib)."""
    import urllib.request
    req = urllib.request.Request(url,
                                 headers={"User-Agent": "fast-nnunet-torch"})
    with urllib.request.urlopen(req, timeout=100) as r, \
            open(local_filename, "wb") as f:
        total = int(r.headers.get("Content-Length") or 0)
        done = 0
        while True:
            chunk = r.read(chunk_size)
            if not chunk:
                break
            f.write(chunk)
            done += len(chunk)
            if total:
                print(f"\r  {done / 1e6:.1f}/{total / 1e6:.1f} MB", end="",
                      flush=True)
        print()
    return local_filename


def download_and_install_from_url(url: str) -> None:
    """Fetch a model zip from a URL and install it into nnUNet_results (ref
    model_sharing/model_download.py:12-35)."""
    import tempfile
    from ..paths import get_results_folder
    get_results_folder()  # raises when nnUNet_results is not set
    print("Downloading pretrained model from url:", url)
    fd, tmp = tempfile.mkstemp(suffix=".zip", prefix="fnnt_download_")
    os.close(fd)
    try:
        download_file(url, tmp)
        print("Download finished. Extracting...")
        install_model_from_zip_file(tmp)
        print("Done")
    finally:
        if ffo.isfile(tmp):
            os.remove(tmp)


def export_entry(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="zip a trained model folder for sharing")
    parser.add_argument("dataset_name_or_id")
    parser.add_argument("-o", required=True, help="output zip")
    parser.add_argument("-c", nargs="+", default=["3d_fullres"])
    parser.add_argument("-tr", default="NNUNetTrainer")
    parser.add_argument("-p", default="nnUNetPlans")
    parser.add_argument("-f", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    parser.add_argument("-chk", nargs="+", default=["checkpoint_final.fnnx"])
    parser.add_argument("--not_strict", action="store_true")
    parser.add_argument("--exp_cv_preds", action="store_true")
    args = parser.parse_args(argv)
    export_pretrained_model(args.dataset_name_or_id, args.o, args.c, args.tr,
                            args.p, args.f, not args.not_strict, args.chk,
                            args.exp_cv_preds)


def install_entry(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="install a model zip into nnUNet_results")
    parser.add_argument("zip_file")
    args = parser.parse_args(argv)
    install_model_from_zip_file(args.zip_file)


def download_entry(argv=None) -> None:
    """nnUNetv2_download_pretrained_model_by_url's counterpart."""
    parser = argparse.ArgumentParser(
        description="download a model zip and install it into nnUNet_results")
    parser.add_argument("url")
    args = parser.parse_args(argv)
    download_and_install_from_url(args.url)
