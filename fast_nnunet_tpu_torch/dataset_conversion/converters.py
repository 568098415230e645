"""Public datasets -> nnU-Net v2 raw layout — a copy of
fast_nnunet_tpu/dataset_conversion/converters.py (the reference's most-used
dataset recipes: BraTS, KiTS, AMOS, ACDC, ToothFairy2, AbdomenAtlas,
RibFrac, TotalSegmentator MRI, autoPET, CTA aorta, EMIDEC, M&Ms, a
cell-tracking set, road segmentation) on the port's readers and writers.
Each converter writes ``nnUNet_raw/DatasetXXX_Name/{imagesTr,labelsTr}``
and a v2 ``dataset.json``. ``fast_nnunet_convert_dataset_torch RECIPE SRC
[-d ID]`` runs one; ``fast_nnunet_convert_old_nnunet_torch TaskXXX_YYY
DatasetXXX_YYY`` moves an nnU-Net v1 raw task to v2."""
import argparse
import shutil
from copy import deepcopy
from typing import Optional

import numpy as np

from ..imageio.mha import MhaIO, read_mha
from ..imageio.natural_image import pil_image
from ..imageio.nifti import read_nifti, write_nifti
from ..utils.dataset_io import generate_dataset_json
from ..utils.io import (isdir, join, load_json, maybe_mkdir_p, save_json,
                        subdirs, subfiles)


def _out_base(dataset_id: int, name: str) -> str:
    from ..paths import get_raw_folder
    out = join(get_raw_folder(), f"Dataset{dataset_id:03d}_{name}")
    maybe_mkdir_p(join(out, "imagesTr"))
    maybe_mkdir_p(join(out, "labelsTr"))
    return out


# --------------------------------------------------------------------- BraTS
def convert_brats_labels_to_nnunet(in_file: str, out_file: str) -> None:
    """BraTS labels (0, 1, 2, 4) -> consecutive nnU-Net labels: necrosis 1->2,
    edema 2->1, enhancing 4->3 (matches the reference's remap so region
    definitions line up)."""
    seg, hdr = read_nifti(in_file)
    u = np.unique(seg)
    if not np.all(np.isin(u, [0, 1, 2, 4])):
        raise RuntimeError(f"unexpected BraTS labels {u} in {in_file}")
    out = np.zeros_like(seg, dtype=np.uint8)
    out[seg == 2] = 1
    out[seg == 1] = 2
    out[seg == 4] = 3
    write_nifti(out_file, out, header=hdr)


def convert_brats_labels_back(seg: np.ndarray) -> np.ndarray:
    """Inverse remap for submitting predictions in BraTS convention."""
    out = np.zeros_like(seg)
    out[seg == 1] = 2
    out[seg == 2] = 1
    out[seg == 3] = 4
    return out


def convert_folder_back_to_brats(input_folder: str, output_folder: str) -> None:
    maybe_mkdir_p(output_folder)
    for f in subfiles(input_folder, suffix=".nii.gz"):
        seg, hdr = read_nifti(join(input_folder, f))
        write_nifti(join(output_folder, f), convert_brats_labels_back(seg),
                    header=hdr)


def convert_brats21(brats_data_dir: str, dataset_id: int = 137,
                    name: str = "BraTS2021") -> str:
    """BraTS 2021 (also works for 2018/2019 folder layouts with per-case
    <case>_{t1,t1ce,t2,flair,seg}.nii.gz): region-based training with
    whole-tumor/tumor-core/enhancing regions."""
    out = _out_base(dataset_id, name)
    cases = subdirs(brats_data_dir, prefix="BraTS")
    for c in cases:
        for i, mod in enumerate(("t1", "t1ce", "t2", "flair")):
            shutil.copy(join(brats_data_dir, c, f"{c}_{mod}.nii.gz"),
                        join(out, "imagesTr", f"{c}_{i:04d}.nii.gz"))
        convert_brats_labels_to_nnunet(join(brats_data_dir, c, f"{c}_seg.nii.gz"),
                                       join(out, "labelsTr", f"{c}.nii.gz"))
    generate_dataset_json(
        out, channel_names={0: "T1", 1: "T1ce", 2: "T2", 3: "Flair"},
        labels={"background": 0, "whole tumor": (1, 2, 3),
                "tumor core": (2, 3), "enhancing tumor": (3,)},
        num_training_cases=len(cases), file_ending=".nii.gz",
        regions_class_order=(1, 2, 3))
    return out


# ------------------------------------------------------------------ KiTS2023
def convert_kits2023(kits_base_dir: str, dataset_id: int = 220,
                     name: str = "KiTS2023") -> str:
    """KiTS23: kidney/masses/tumor as overlapping regions, export order
    (1, 3, 2) so tumor overwrites cyst."""
    out = _out_base(dataset_id, name)
    cases = subdirs(kits_base_dir, prefix="case_")
    for c in cases:
        shutil.copy(join(kits_base_dir, c, "imaging.nii.gz"),
                    join(out, "imagesTr", f"{c}_0000.nii.gz"))
        shutil.copy(join(kits_base_dir, c, "segmentation.nii.gz"),
                    join(out, "labelsTr", f"{c}.nii.gz"))
    generate_dataset_json(
        out, channel_names={0: "CT"},
        labels={"background": 0, "kidney": (1, 2, 3), "masses": (2, 3),
                "tumor": 2},
        num_training_cases=len(cases), file_ending=".nii.gz",
        regions_class_order=(1, 3, 2))
    return out


# ------------------------------------------------------------------ AMOS2022
def convert_amos_task1(amos_base_dir: str, dataset_id: int = 218,
                       name: str = "AMOS2022_postChallenge_task1") -> str:
    """AMOS task 1 (CT only, ids < 500): 15 abdominal organs, plain labels.
    Validation images are folded into the training pool like the reference."""
    out = _out_base(dataset_id, name)
    src_json = load_json(join(amos_base_dir, "dataset.json"))
    n = 0
    for images, labels in (("imagesTr", "labelsTr"), ("imagesVa", "labelsVa")):
        if not isdir(join(amos_base_dir, images)):
            continue
        for f in subfiles(join(amos_base_dir, images), suffix=".nii.gz",
                          join=False):
            case = f[:-len(".nii.gz")]
            if int(case.split("_")[-1]) >= 500:
                continue  # ids >= 500 are MRI (task 2 handles them)
            shutil.copy(join(amos_base_dir, images, f),
                        join(out, "imagesTr", f"{case}_0000.nii.gz"))
            shutil.copy(join(amos_base_dir, labels, f),
                        join(out, "labelsTr", f))
            n += 1
    generate_dataset_json(
        out, channel_names={0: "CT"},
        labels={v: int(k) for k, v in src_json["labels"].items()},
        num_training_cases=n, file_ending=".nii.gz")
    return out


def convert_amos_task2(amos_base_dir: str, dataset_id: int = 219,
                       name: str = "AMOS2022_postChallenge_task2") -> str:
    """AMOS task 2: CT + MRI mixed; the single channel is declared nonCT so
    z-score normalization is used for every case."""
    out = _out_base(dataset_id, name)
    src_json = load_json(join(amos_base_dir, "dataset.json"))
    n = 0
    for images, labels in (("imagesTr", "labelsTr"), ("imagesVa", "labelsVa")):
        if not isdir(join(amos_base_dir, images)):
            continue
        for f in subfiles(join(amos_base_dir, images), suffix=".nii.gz",
                          join=False):
            case = f[:-len(".nii.gz")]
            shutil.copy(join(amos_base_dir, images, f),
                        join(out, "imagesTr", f"{case}_0000.nii.gz"))
            shutil.copy(join(amos_base_dir, labels, f),
                        join(out, "labelsTr", f))
            n += 1
    generate_dataset_json(
        out, channel_names={0: "nonCT"},
        labels={v: int(k) for k, v in src_json["labels"].items()},
        num_training_cases=n, file_ending=".nii.gz")
    return out


# ---------------------------------------------------------------------- ACDC
def convert_acdc(src_data_folder: str, dataset_id: int = 27,
                 name: str = "ACDC") -> str:
    """ACDC cardiac cine MRI: the ED and ES frames of each patient become
    separate training cases (the 4d series and its frames without _gt are
    skipped/copied per the reference's recipe)."""
    out = _out_base(dataset_id, name)
    maybe_mkdir_p(join(out, "imagesTs"))
    n = 0
    for patient in subdirs(join(src_data_folder, "training"), join_path=True):
        for f in subfiles(patient, suffix=".nii.gz"):
            if "_4d" in f:
                continue
            if "_gt" in f:
                shutil.copy(join(patient, f),
                            join(out, "labelsTr", f.replace("_gt", "")))
            else:
                case = f[:-len(".nii.gz")]
                shutil.copy(join(patient, f),
                            join(out, "imagesTr", f"{case}_0000.nii.gz"))
                n += 1
    if isdir(join(src_data_folder, "testing")):
        for patient in subdirs(join(src_data_folder, "testing"), join_path=True):
            for f in subfiles(patient, suffix=".nii.gz"):
                if "_4d" in f or "_gt" in f:
                    continue
                case = f[:-len(".nii.gz")]
                shutil.copy(join(patient, f),
                            join(out, "imagesTs", f"{case}_0000.nii.gz"))
    generate_dataset_json(
        out, channel_names={0: "cineMRI"},
        labels={"background": 0, "RV": 1, "MLV": 2, "LVC": 3},
        num_training_cases=n, file_ending=".nii.gz")
    return out


# --------------------------------------------------------------- ToothFairy2
def toothfairy2_label_mapping() -> dict:
    """FDI tooth numbering (11-18, 21-28, 31-38, 41-48) + jaw structures 1-18
    -> consecutive labels (ref Dataset119_ToothFairy2_All.py mapping_DS119:
    each quadrant's gap of 2 collapses)."""
    mapping = {i: i for i in range(1, 19)}
    for q, off in ((21, 2), (31, 4), (41, 6)):
        mapping.update({i: i - off for i in range(q, q + 8)})
    return mapping


def convert_toothfairy2(src_data_folder: str, dataset_id: int = 119,
                        name: str = "ToothFairy2_All") -> str:
    """ToothFairy2 CBCT (.mha images/labels): compact the sparse FDI label ids
    and convert to NIfTI."""
    out = _out_base(dataset_id, name)
    mapping = toothfairy2_label_mapping()
    rw = MhaIO()
    imgs = subfiles(join(src_data_folder, "imagesTr"), suffix=".mha",
                    join_path=False)
    for f in imgs:
        data, props = rw.read_images([join(src_data_folder, "imagesTr", f)])
        case = f[:-len(".mha")]
        if case.endswith("_0000"):
            case = case[:-5]
        write_nifti(join(out, "imagesTr", f"{case}_0000.nii.gz"),
                    np.ascontiguousarray(data[0].transpose(2, 1, 0)),
                    spacing=tuple(props["spacing"][::-1]))
        seg, sprops = rw.read_seg(
            join(src_data_folder, "labelsTr", f"{case}.mha"))
        remapped = np.zeros_like(seg[0], dtype=np.uint8)
        for src, dst in mapping.items():
            remapped[seg[0] == src] = dst
        write_nifti(join(out, "labelsTr", f"{case}.nii.gz"),
                    np.ascontiguousarray(remapped.transpose(2, 1, 0)),
                    spacing=tuple(sprops["spacing"][::-1]))
    labels = {"background": 0}
    labels.update({f"structure_{v}": v for v in sorted(set(mapping.values()))})
    generate_dataset_json(out, channel_names={0: "CBCT"}, labels=labels,
                          num_training_cases=len(imgs), file_ending=".nii.gz")
    return out


# ------------------------------------------------------------- AbdomenAtlas
def convert_abdomenatlas(src_data_folder: str, dataset_id: int = 224,
                         name: str = "AbdomenAtlas1.0") -> str:
    """AbdomenAtlas1.0(Mini): per-case folders BDMAP* with ct.nii.gz +
    combined_labels.nii.gz, 9 abdominal organs (ref
    Dataset224_AbdomenAtlas1.0.py)."""
    out = _out_base(dataset_id, name)
    cases = subdirs(src_data_folder, prefix="BDMAP", join_path=False)
    for c in cases:
        shutil.copy(join(src_data_folder, c, "ct.nii.gz"),
                    join(out, "imagesTr", f"{c}_0000.nii.gz"))
        shutil.copy(join(src_data_folder, c, "combined_labels.nii.gz"),
                    join(out, "labelsTr", f"{c}.nii.gz"))
    generate_dataset_json(
        out, channel_names={0: "nonCT"},  # ref uses nonCT: data is prenormalized
        labels={"background": 0, "aorta": 1, "gall_bladder": 2,
                "kidney_left": 3, "kidney_right": 4, "liver": 5, "pancreas": 6,
                "postcava": 7, "spleen": 8, "stomach": 9},
        num_training_cases=len(cases), file_ending=".nii.gz")
    return out


# ------------------------------------------------------------------- RibFrac
def convert_ribfrac(src_data_folder: str, dataset_id: int = 15,
                    name: str = "RibFrac") -> str:
    """RibFrac fracture detection: one flat folder of <case>-image.nii.gz and
    <case>-label.nii.gz; label -1 (undefined fracture type) becomes class 5 and
    'fracture' is the union region (ref Dataset015_018_RibFrac_RibSeg.py)."""
    out = _out_base(dataset_id, name)
    maybe_mkdir_p(join(out, "imagesTs"))
    images = subfiles(src_data_folder, suffix="-image.nii.gz", join_path=False)
    n_tr = 0
    for f in images:
        case = f[:-len("-image.nii.gz")]
        seg_file = join(src_data_folder, f"{case}-label.nii.gz")
        if not subfiles(src_data_folder, prefix=f"{case}-label",
                        join_path=False):
            shutil.copy(join(src_data_folder, f),
                        join(out, "imagesTs", f"{case}_0000.nii.gz"))
            continue
        n_tr += 1
        shutil.copy(join(src_data_folder, f),
                    join(out, "imagesTr", f"{case}_0000.nii.gz"))
        seg, hdr = read_nifti(seg_file)
        seg = seg.astype(np.int16)
        seg[seg == -1] = 5
        write_nifti(join(out, "labelsTr", f"{case}.nii.gz"),
                    seg.astype(np.uint8), header=hdr)
    generate_dataset_json(
        out, channel_names={0: "CT"},
        labels={"background": 0, "fracture": (1, 2, 3, 4, 5),
                "displaced rib fracture": 1, "non-displaced rib fracture": 2,
                "buckle rib fracture": 3, "segmental rib fracture": 4},
        num_training_cases=n_tr, file_ending=".nii.gz",
        regions_class_order=(5, 1, 2, 3, 4))
    return out


def convert_ribseg(src_data_folder: str, dataset_id: int = 18,
                   name: str = "RibSeg") -> str:
    """RibSeg rib segmentation (labels 1-24, one per rib), images shared with
    RibFrac; segs end with -rib-seg.nii.gz (ref Dataset015_018 part 2)."""
    out = _out_base(dataset_id, name)
    segs = subfiles(src_data_folder, suffix="-rib-seg.nii.gz", join_path=False)
    n = 0
    for f in segs:
        case = f[:-len("-rib-seg.nii.gz")]
        img = join(src_data_folder, f"{case}-image.nii.gz")
        if not subfiles(src_data_folder, prefix=f"{case}-image",
                        join_path=False):
            continue
        n += 1
        shutil.copy(img, join(out, "imagesTr", f"{case}_0000.nii.gz"))
        shutil.copy(join(src_data_folder, f),
                    join(out, "labelsTr", f"{case}.nii.gz"))
    generate_dataset_json(
        out, channel_names={0: "CT"},
        labels={"background": 0, **{f"rib_{i}": i for i in range(1, 25)}},
        num_training_cases=n, file_ending=".nii.gz")
    return out


# --------------------------------------------------- TotalSegmentator MRI
def convert_totalsegmentator_mri(src_data_folder: str, dataset_id: int = 227,
                                 name: str = "TotalSegmentatorMRI") -> str:
    """TotalSegmentator MRI: per-case folders with mri.nii.gz and a
    segmentations/ directory of one binary mask per structure; masks merge
    into one labelmap in the discovered structure order (ref
    Dataset227_TotalSegmentatorMRI.py)."""
    out = _out_base(dataset_id, name)
    cases = subdirs(src_data_folder, join_path=False)
    structures = [f[:-len(".nii.gz")] for f in subfiles(
        join(src_data_folder, cases[0], "segmentations"), suffix=".nii.gz",
        join_path=False)]
    label_dict = {s: i + 1 for i, s in enumerate(structures)}
    for c in cases:
        shutil.copy(join(src_data_folder, c, "mri.nii.gz"),
                    join(out, "imagesTr", f"{c}_0000.nii.gz"))
        merged, hdr = None, None
        for s in structures:
            mask, h = read_nifti(join(src_data_folder, c, "segmentations",
                                      f"{s}.nii.gz"))
            if merged is None:
                merged, hdr = np.zeros_like(mask, dtype=np.uint8), h
            merged[mask > 0] = label_dict[s]
        write_nifti(join(out, "labelsTr", f"{c}.nii.gz"), merged, header=hdr)
    generate_dataset_json(
        out, channel_names={0: "MRI"},
        labels={"background": 0, **label_dict},
        num_training_cases=len(cases), file_ending=".nii.gz",
        overwrite_image_reader_writer="NibabelIOWithReorient")
    return out


# ------------------------------------------------------------------ AutoPET
def convert_autopet2(src_data_folder: str, dataset_id: int = 221,
                     name: str = "AutoPETII_2023") -> str:
    """AutoPET-II PET/CT: PETCT_*/acquisition/ folders with CTres/SUV/SEG;
    two input channels, plus a 5-fold split that keeps every patient's
    acquisitions in the same fold (ref Dataset221_AutoPETII_2023.py)."""
    out = _out_base(dataset_id, name)
    patients = subdirs(src_data_folder, prefix="PETCT", join_path=False)
    identifiers = []
    for pat in patients:
        for acq in subdirs(join(src_data_folder, pat), join_path=False):
            ident = f"{pat}_{acq}"
            identifiers.append(ident)
            src = join(src_data_folder, pat, acq)
            shutil.copy(join(src, "CTres.nii.gz"),
                        join(out, "imagesTr", f"{ident}_0000.nii.gz"))
            shutil.copy(join(src, "SUV.nii.gz"),
                        join(out, "imagesTr", f"{ident}_0001.nii.gz"))
            shutil.copy(join(src, "SEG.nii.gz"),
                        join(out, "labelsTr", f"{ident}.nii.gz"))
    generate_dataset_json(
        out, channel_names={0: "CT", 1: "CT"},  # ref normalizes SUV CT-style
        labels={"background": 0, "tumor": 1},
        num_training_cases=len(identifiers), file_ending=".nii.gz")
    # per-patient split: all acquisitions of a patient share a fold
    splits = []
    for fold in range(5):
        val_pat = set(patients[fold::5])
        splits.append({
            "train": [i for i in identifiers
                      if not any(i.startswith(p) for p in val_pat)],
            "val": [i for i in identifiers
                    if any(i.startswith(p) for p in val_pat)],
        })
    save_json(splits, join(out, "splits_final.json"), sort_keys=False)
    return out


# ------------------------------------------------------- BraTS 2018 / 2019
def _convert_brats_hgg_lgg(brats_data_dir: str, dataset_id: int, name: str,
                           case_prefix: str) -> str:
    """BraTS 2018/2019 layout: HGG/ and LGG/ grade folders of per-case
    <case>_{t1,t1ce,t2,flair,seg}.nii (uncompressed NIfTI — ref
    Dataset042_BraTS18.py:75-95, Dataset043_BraTS19.py:75-95)."""
    out = _out_base(dataset_id, name)
    cases = []
    for grade in ("HGG", "LGG"):
        for c in subdirs(join(brats_data_dir, grade), prefix=case_prefix):
            cases.append(c)
            for i, mod in enumerate(("t1", "t1ce", "t2", "flair")):
                shutil.copy(join(brats_data_dir, grade, c, f"{c}_{mod}.nii"),
                            join(out, "imagesTr", f"{c}_{i:04d}.nii"))
            convert_brats_labels_to_nnunet(
                join(brats_data_dir, grade, c, f"{c}_seg.nii"),
                join(out, "labelsTr", f"{c}.nii"))
    generate_dataset_json(
        out, channel_names={0: "T1", 1: "T1ce", 2: "T2", 3: "Flair"},
        labels={"background": 0, "whole tumor": (1, 2, 3),
                "tumor core": (2, 3), "enhancing tumor": (3,)},
        num_training_cases=len(cases), file_ending=".nii",
        regions_class_order=(1, 2, 3))
    return out


def convert_brats18(brats_data_dir: str, dataset_id: int = 42,
                    name: str = "BraTS2018") -> str:
    return _convert_brats_hgg_lgg(brats_data_dir, dataset_id, name, "Brats")


def convert_brats19(brats_data_dir: str, dataset_id: int = 43,
                    name: str = "BraTS2019") -> str:
    return _convert_brats_hgg_lgg(brats_data_dir, dataset_id, name, "BraTS")


def convert_brats2024_gli(src_data_folder: str, dataset_id: int = 226,
                          name: str = "BraTS2024-BraTS-GLI") -> str:
    """BraTS 2024 adult-glioma post-treatment: per-case
    <case>-{t1n,t1c,t2w,t2f,seg}.nii.gz; labels kept as-is (NETC/SNFH/ET/RC,
    no region conversion — ref Dataset226_BraTS2024-BraTS-GLI.py:18-52)."""
    out = _out_base(dataset_id, name)
    cases = subdirs(src_data_folder)
    for c in cases:
        for i, mod in enumerate(("t1n", "t1c", "t2w", "t2f")):
            shutil.copy(join(src_data_folder, c, f"{c}-{mod}.nii.gz"),
                        join(out, "imagesTr", f"{c}_{i:04d}.nii.gz"))
        shutil.copy(join(src_data_folder, c, f"{c}-seg.nii.gz"),
                    join(out, "labelsTr", f"{c}.nii.gz"))
    generate_dataset_json(
        out, channel_names={0: "T1", 1: "T1C", 2: "T2W", 3: "T2F"},
        labels={"background": 0, "NETC": 1, "SNFH": 2, "ET": 3, "RC": 4},
        num_training_cases=len(cases), file_ending=".nii.gz")
    return out


# -------------------------------------------------------- AortaSeg24 (CTA)
def convert_ctaaorta(src_data_folder: str, dataset_id: int = 21,
                     name: str = "CTAAorta") -> str:
    """AortaSeg24: images/subject*_CTA.mha + masks/subject*_label.mha,
    transcoded .mha -> .nii.gz; 23 aortic zones/branches (ref
    Dataset021_CTAAorta.py:24-78)."""
    out = _out_base(dataset_id, name)
    cases = subfiles(join(src_data_folder, "images"), prefix="subject")
    for case in cases:
        ident = case.replace("_CTA.mha", "")
        img, fields = read_mha(join(src_data_folder, "images", case))
        write_nifti(join(out, "imagesTr", f"{ident}_0000.nii.gz"),
                    img.astype(np.float32), spacing=fields["_spacing"])
        seg, sfields = read_mha(join(src_data_folder, "masks",
                                     case.replace("_CTA.mha", "_label.mha")))
        write_nifti(join(out, "labelsTr", f"{ident}.nii.gz"),
                    seg.astype(np.uint8), spacing=sfields["_spacing"])
    zones = ["Zone_0", "Innominate", "Zone_1", "Left_Common_Carotid",
             "Zone_2", "Left_Subclavian_Artery", "Zone_3", "Zone_4",
             "Zone_5", "Zone_6", "Celiac_Artery", "Zone_7", "SMA", "Zone_8",
             "Right_Renal_Artery", "Left_Renal_Artery", "Zone_9",
             "Zone_10_R_(Right_Common_Iliac_Artery)",
             "Zone_10_L_(Left_Common_Iliac_Artery)",
             "Right_Internal_Iliac_Artery", "Left_Internal_Iliac_Artery",
             "Zone_11_R_(Right_External_Iliac_Artery)",
             "Zone_11_L_(Left_External_Iliac_Artery)"]
    generate_dataset_json(
        out, channel_names={0: "CTA"},
        labels={"background": 0, **{z: i + 1 for i, z in enumerate(zones)}},
        num_training_cases=len(cases), file_ending=".nii.gz",
        overwrite_image_reader_writer="NibabelIOWithReorient")
    return out


# ------------------------------------------------------------------ EMIDEC
def convert_emidec(src_data_folder: str, dataset_id: int = 115,
                   name: str = "EMIDEC", test_folder: Optional[str] = None
                   ) -> str:
    """EMIDEC cardiac MRI: per-patient Images/<case>.nii.gz +
    Contours/<case>.nii.gz (ref Dataset115_EMIDEC.py:9-45)."""
    out = _out_base(dataset_id, name)
    patients = subdirs(src_data_folder)
    for pat in patients:
        shutil.copy(join(src_data_folder, pat, "Images", f"{pat}.nii.gz"),
                    join(out, "imagesTr", f"{pat}_0000.nii.gz"))
        shutil.copy(join(src_data_folder, pat, "Contours", f"{pat}.nii.gz"),
                    join(out, "labelsTr", f"{pat}.nii.gz"))
    if test_folder:
        maybe_mkdir_p(join(out, "imagesTs"))
        for pat in subdirs(test_folder):
            shutil.copy(join(test_folder, pat, "Images", f"{pat}.nii.gz"),
                        join(out, "imagesTs", f"{pat}_0000.nii.gz"))
    generate_dataset_json(
        out, channel_names={0: "cineMRI"},
        labels={"background": 0, "cavity": 1, "normal_myocardium": 2,
                "myocardial_infarction": 3, "no_reflow": 4},
        num_training_cases=len(patients), file_ending=".nii.gz")
    return out


# -------------------------------------------- AMOS 2022 post-challenge (223)
def convert_amos_post_challenge(amos_base_dir: str, dataset_id: int = 223,
                                name: str = "AMOS2022postChallenge") -> str:
    """Merges imagesTr+imagesVa (and their labels) into one training pool,
    imagesTs stays test; labels come from the bundled dataset.json (ref
    Dataset223_AMOS2022postChallenge.py:8-60)."""
    out = _out_base(dataset_id, name)
    maybe_mkdir_p(join(out, "imagesTs"))
    n_train = 0
    for src_img, src_lab in (("imagesTr", "labelsTr"), ("imagesVa", "labelsVa")):
        for s in subfiles(join(amos_base_dir, src_img), suffix=".nii.gz"):
            shutil.copy(join(amos_base_dir, src_img, s),
                        join(out, "imagesTr", s[:-7] + "_0000.nii.gz"))
            n_train += 1
        if isdir(join(amos_base_dir, src_lab)):
            for s in subfiles(join(amos_base_dir, src_lab), suffix=".nii.gz"):
                shutil.copy(join(amos_base_dir, src_lab, s),
                            join(out, "labelsTr", s))
    for s in subfiles(join(amos_base_dir, "imagesTs"), suffix=".nii.gz"):
        shutil.copy(join(amos_base_dir, "imagesTs", s),
                    join(out, "imagesTs", s[:-7] + "_0000.nii.gz"))
    old = load_json(join(amos_base_dir, "dataset.json"))
    labels = {str(v): int(k) for k, v in old["labels"].items()} \
        if all(str(k).isdigit() for k in old["labels"]) else old["labels"]
    generate_dataset_json(
        out, channel_names={0: "either_CT_or_MR"}, labels=labels,
        num_training_cases=n_train, file_ending=".nii.gz")
    return out


# --------------------------------------------- AbdomenAtlas 1.1 Mini (023)
def convert_abdomenatlas_mini(src_data_folder: str, dataset_id: int = 23,
                              name: str = "AbdomenAtlas1.1Mini") -> str:
    """Same per-case ct.nii.gz + combined_labels.nii.gz layout as
    AbdomenAtlas 1.0 with the core 9-organ label set (ref
    Dataset023_AbdomenAtlas1_1Mini.py); delegates to the 1.0 recipe."""
    return convert_abdomenatlas(src_data_folder, dataset_id=dataset_id,
                                name=name)


# ------------------------------------------------------------------- M&Ms
def convert_mnms(src_data_folder: str, dataset_id: int = 114,
                 name: str = "MNMs",
                 csv_file_name: str = "211230_M&Ms_Dataset_information_diagnosis_opendataset.csv"
                 ) -> str:
    """M&Ms multi-vendor cardiac MRI: Training/Labeled/<patient>/
    <patient>_sa.nii.gz is a 4D cine; the per-patient CSV rows (columns
    'External code', 'ED', 'ES') name the end-diastole/end-systole frames to
    extract as separate 3D training cases (ref Dataset114_MNMs.py:14-112)."""
    import csv as _csv
    out = _out_base(dataset_id, name)
    info = {}
    with open(join(src_data_folder, csv_file_name), newline="") as fh:
        reader = _csv.reader(fh)
        headers = next(reader)
        i_pat = headers.index("External code")
        i_ed, i_es = headers.index("ED"), headers.index("ES")
        for row in reader:
            info[row[i_pat]] = (int(row[i_ed]), int(row[i_es]))

    n_cases = 0
    labeled = join(src_data_folder, "Training", "Labeled")
    for pat in subdirs(labeled):
        img4d, hdr = read_nifti(join(labeled, pat, f"{pat}_sa.nii.gz"))
        seg4d, _ = read_nifti(join(labeled, pat, f"{pat}_sa_gt.nii.gz"))
        spacing = hdr["pixdim"][1:4]
        for frame in info[pat]:
            ident = f"{pat}_frame{frame:02d}"
            write_nifti(join(out, "imagesTr", f"{ident}_0000.nii.gz"),
                        np.ascontiguousarray(img4d[..., frame]),
                        spacing=spacing)
            write_nifti(join(out, "labelsTr", f"{ident}.nii.gz"),
                        np.ascontiguousarray(seg4d[..., frame]).astype(np.uint8),
                        spacing=spacing)
            n_cases += 1
    generate_dataset_json(
        out, channel_names={0: "cineMRI"},
        labels={"background": 0, "LVBP": 1, "LVM": 2, "RV": 3},
        num_training_cases=n_cases, file_ending=".nii.gz")
    return out


# ------------------------------------------- Fluo-C3DH-A549-SIM (cell, tif)
def convert_fluo_c3dh_a549_sim(train_source: str, dataset_id: int = 73,
                               name: str = "Fluo_C3DH_A549_SIM",
                               test_source: Optional[str] = None) -> str:
    """Cell Tracking Challenge Fluo-C3DH-A549-SIM: sequences 01/02 of .tif
    stacks with 01_GT/SEG ground truth; files are copied (no conversion) with
    the per-case spacing sidecar our Tiff3DIO expects, plus the reference's
    custom 2-fold cross-sequence split (ref Dataset073_*.py:36-86)."""
    from ..paths import get_preprocessed_folder
    spacing = (1, 0.126, 0.126)
    out = _out_base(dataset_id, name)
    n = 0
    for seq in ("01", "02"):
        images = subfiles(join(train_source, seq), suffix=".tif")
        segs = subfiles(join(train_source, seq + "_GT", "SEG"), suffix=".tif")
        for i, (im, se) in enumerate(zip(images, segs)):
            ident = f"{seq}_image_{i:03d}"
            shutil.copy(join(train_source, seq, im),
                        join(out, "imagesTr", f"{ident}_0000.tif"))
            save_json({"spacing": spacing}, join(out, "imagesTr", f"{ident}.json"))
            shutil.copy(join(train_source, seq + "_GT", "SEG", se),
                        join(out, "labelsTr", f"{ident}.tif"))
            save_json({"spacing": spacing}, join(out, "labelsTr", f"{ident}.json"))
            n += 1
    if test_source:
        maybe_mkdir_p(join(out, "imagesTs"))
        for seq in ("01", "02"):
            for i, im in enumerate(subfiles(join(test_source, seq),
                                            suffix=".tif")):
                ident = f"{seq}_image_{i:03d}"
                shutil.copy(join(test_source, seq, im),
                            join(out, "imagesTs", f"{ident}_0000.tif"))
                save_json({"spacing": spacing},
                          join(out, "imagesTs", f"{ident}.json"))
    generate_dataset_json(out, channel_names={0: "fluorescence_microscopy"},
                          labels={"background": 0, "cell": 1},
                          num_training_cases=n, file_ending=".tif")
    # cross-sequence 2-fold split
    caseids = [f[:-4] for f in subfiles(join(out, "labelsTr"), suffix=".tif")]
    splits = [
        {"train": [c for c in caseids if c.startswith("01_")],
         "val": [c for c in caseids if c.startswith("02_")]},
        {"train": [c for c in caseids if c.startswith("02_")],
         "val": [c for c in caseids if c.startswith("01_")]},
    ]
    pre = join(get_preprocessed_folder(), f"Dataset{dataset_id:03d}_{name}")
    maybe_mkdir_p(pre)
    save_json(splits, join(pre, "splits_final.json"), sort_keys=False)
    return out


# --------------------------------------------- Massachusetts roads (2D png)
def convert_road_segmentation(src_data_folder: str, dataset_id: int = 120,
                              name: str = "RoadSegmentation",
                              min_component_size: int = 50) -> str:
    """Massachusetts road segmentation (2D RGB png): label 255 -> 1, and road
    labels inside the tiles' large blank-white regions (no image content) are
    cleared — white mask, small components dropped, holes filled (ref
    Dataset120_RoadSegmentation.py:15-87)."""
    Image = pil_image()
    from scipy import ndimage
    out = _out_base(dataset_id, name)

    def one(img_path, seg_path, out_img, out_seg):
        seg = np.asarray(Image.open(seg_path)).copy()
        seg[seg == 255] = 1
        image = np.asarray(Image.open(img_path)).astype(np.int32)
        mask = image.sum(2) == 3 * 255
        lab, n_comp = ndimage.label(mask)
        if n_comp:
            sizes = ndimage.sum_labels(np.ones_like(lab), lab,
                                       index=np.arange(1, n_comp + 1))
            keep = np.isin(lab, np.nonzero(sizes > min_component_size)[0] + 1)
        else:
            keep = np.zeros_like(mask)
        mask = ndimage.binary_fill_holes(keep)
        seg[mask] = 0
        Image.fromarray(seg.astype(np.uint8)).save(out_seg)
        shutil.copy(img_path, out_img)

    n_train = 0
    for split, img_dir, lab_dir in (("training", "imagesTr", "labelsTr"),
                                    ("testing", "imagesTs", "labelsTs")):
        src = join(src_data_folder, split)
        if not isdir(src):
            continue
        maybe_mkdir_p(join(out, img_dir))
        maybe_mkdir_p(join(out, lab_dir))
        for v in subfiles(join(src, "output"), suffix="png"):
            one(join(src, "input", v), join(src, "output", v),
                join(out, img_dir, v[:-4] + "_0000.png"),
                join(out, lab_dir, v))
            if split == "training":
                n_train += 1
    generate_dataset_json(out, channel_names={0: "R", 1: "G", 2: "B"},
                          labels={"background": 0, "road": 1},
                          num_training_cases=n_train, file_ending=".png")
    return out


# ----------------------------------------------------- old nnU-Net v1 layout
def convert_old_nnunet_task(source_folder: str, target_dataset_name: str) -> str:
    """TaskXXX_YYY (nnU-Net v1 raw) -> DatasetXXX_YYY (v2): copies the image/
    label trees verbatim and rewrites dataset.json (modality->channel_names,
    inverted labels dict, drops the training/test case lists)."""
    from ..paths import get_raw_folder
    target = join(get_raw_folder(), target_dataset_name)
    if isdir(target):
        raise RuntimeError(f"{target} already exists, refusing to overwrite")
    for sub in ("imagesTr", "labelsTr", "imagesTs", "labelsTs"):
        if isdir(join(source_folder, sub)):
            shutil.copytree(join(source_folder, sub), join(target, sub))
    dj = deepcopy(load_json(join(source_folder, "dataset.json")))
    for k in ("tensorImageSize", "numTest", "training", "test"):
        dj.pop(k, None)
    dj["channel_names"] = {str(k): v for k, v in dj.pop("modality").items()}
    dj["labels"] = {v: int(k) for k, v in dj["labels"].items()}
    dj["file_ending"] = ".nii.gz"
    save_json(dj, join(target, "dataset.json"), sort_keys=False)
    return target


_CONVERTERS = {
    "brats18": convert_brats18,
    "brats19": convert_brats19,
    "brats21": convert_brats21,
    "brats2024_gli": convert_brats2024_gli,
    "ctaaorta": convert_ctaaorta,
    "emidec": convert_emidec,
    "amos_post_challenge": convert_amos_post_challenge,
    "abdomenatlas_mini": convert_abdomenatlas_mini,
    "mnms": convert_mnms,
    "fluo_c3dh_a549_sim": convert_fluo_c3dh_a549_sim,
    "road_segmentation": convert_road_segmentation,
    "kits2023": convert_kits2023,
    "amos_task1": convert_amos_task1,
    "amos_task2": convert_amos_task2,
    "acdc": convert_acdc,
    "toothfairy2": convert_toothfairy2,
    "abdomenatlas": convert_abdomenatlas,
    "ribfrac": convert_ribfrac,
    "ribseg": convert_ribseg,
    "totalsegmentator_mri": convert_totalsegmentator_mri,
    "autopet2": convert_autopet2,
}


def convert_old_nnunet_entry(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="nnU-Net v1 TaskXXX_YYY raw folder -> v2 DatasetXXX_YYY")
    p.add_argument("input_folder")
    p.add_argument("target_dataset_name",
                   help="e.g. Dataset042_Old (must not exist yet)")
    args = p.parse_args(argv)
    out = convert_old_nnunet_task(args.input_folder, args.target_dataset_name)
    print(f"converted -> {out}")


def convert_dataset_entry(argv=None) -> None:
    p = argparse.ArgumentParser(description="public-dataset -> nnUNet_raw")
    p.add_argument("recipe", choices=sorted(_CONVERTERS))
    p.add_argument("source_folder")
    p.add_argument("-d", type=int, default=None, help="override dataset id")
    args = p.parse_args(argv)
    kwargs = {} if args.d is None else {"dataset_id": args.d}
    out = _CONVERTERS[args.recipe](args.source_folder, **kwargs)
    print(f"converted -> {out}")


if __name__ == "__main__":
    convert_dataset_entry()
