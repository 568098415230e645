"""The port's dataset converters (``dataset_conversion/``) against the JAX
package's on the synthetic sources of tests/test_dataset_conversion.py:
every recipe, the MSD 4D split and the nnU-Net v1 task conversion write
the same output tree — the same files, equal JSON, NIfTI headers and
voxels byte for byte (the gzip streams may differ: the port writes at
level 1), other files byte for byte. The port runs through its console
scripts' entry functions."""
import gzip
import os

import numpy as np
import pytest

from fast_nnunet_tpu.dataset_conversion import converters as jconv
from fast_nnunet_tpu.dataset_conversion.convert_msd import \
    convert_msd_dataset as jmsd
from fast_nnunet_tpu_torch.dataset_conversion.convert_msd import \
    convert_msd_entry
from fast_nnunet_tpu_torch.dataset_conversion.converters import (
    convert_dataset_entry, convert_old_nnunet_entry)
from fast_nnunet_tpu_torch.imageio.mha import write_mha
from fast_nnunet_tpu_torch.imageio.nifti import write_nifti
from fast_nnunet_tpu_torch.imageio.tiff import _write_tiff_stack
from fast_nnunet_tpu_torch.utils.io import join, load_json, save_json


def _mk(*parts):
    path = join(*parts)
    os.makedirs(path, exist_ok=True)
    return path


def _vol(fname, rng, shape):
    write_nifti(fname, rng.rand(*shape).astype(np.float32))


def _seg(fname, rng, shape, values):
    write_nifti(fname, rng.choice(values, size=shape).astype(
        np.int16 if min(values) < 0 else np.uint8))


def _brats21(src, rng):
    for c in ("BraTS2021_00000", "BraTS2021_00002"):
        for mod in ("t1", "t1ce", "t2", "flair"):
            _vol(join(_mk(src, c), f"{c}_{mod}.nii.gz"), rng, (8, 8, 8))
        _seg(join(src, c, f"{c}_seg.nii.gz"), rng, (8, 8, 8), [0, 1, 2, 4])


def _kits2023(src, rng):
    for c in ("case_00000", "case_00001"):
        _vol(join(_mk(src, c), "imaging.nii.gz"), rng, (6, 6, 6))
        _seg(join(src, c, "segmentation.nii.gz"), rng, (6, 6, 6), range(4))


def _acdc(src, rng):
    for pat in ("patient001", "patient002"):
        d = _mk(src, "training", pat)
        for frame in ("frame01", "frame12"):
            _vol(join(d, f"{pat}_{frame}.nii.gz"), rng, (6, 6, 6))
            _seg(join(d, f"{pat}_{frame}_gt.nii.gz"), rng, (6, 6, 6),
                 range(4))
        _vol(join(d, f"{pat}_4d.nii.gz"), rng, (6, 6, 6))


def _rib(src, rng):
    _mk(src)
    for c in ("RibFrac1", "RibFrac2"):
        _vol(join(src, f"{c}-image.nii.gz"), rng, (6, 6, 6))
        _seg(join(src, f"{c}-label.nii.gz"), rng, (6, 6, 6),
             [0, 1, 2, 3, 4, -1])
        _seg(join(src, f"{c}-rib-seg.nii.gz"), rng, (6, 6, 6), range(25))
    _vol(join(src, "RibFrac9-image.nii.gz"), rng, (6, 6, 6))


def _abdomenatlas(src, rng):
    for c in ("BDMAP_0001", "BDMAP_0002"):
        _vol(join(_mk(src, c), "ct.nii.gz"), rng, (5, 5, 5))
        _seg(join(src, c, "combined_labels.nii.gz"), rng, (5, 5, 5),
             range(10))


def _totalseg_mri(src, rng):
    for c in ("s0001", "s0002"):
        _mk(src, c, "segmentations")
        _vol(join(src, c, "mri.nii.gz"), rng, (5, 5, 5))
        for s in ("liver", "spleen"):
            write_nifti(join(src, c, "segmentations", f"{s}.nii.gz"),
                        (rng.rand(5, 5, 5) > 0.7).astype(np.uint8))


def _autopet2(src, rng):
    for pat in ("PETCT_a", "PETCT_b"):
        for acq in ("01", "02"):
            d = _mk(src, pat, acq)
            _vol(join(d, "CTres.nii.gz"), rng, (4, 4, 4))
            _vol(join(d, "SUV.nii.gz"), rng, (4, 4, 4))
            write_nifti(join(d, "SEG.nii.gz"),
                        (rng.rand(4, 4, 4) > 0.8).astype(np.uint8))


def _toothfairy2(src, rng):
    write_mha(join(_mk(src, "imagesTr"), "ToothFairy2F_001_0000.mha"),
              rng.rand(6, 6, 6).astype(np.float32), (1.0, 1.0, 1.0))
    write_mha(join(_mk(src, "labelsTr"), "ToothFairy2F_001.mha"),
              rng.choice([0, 1, 11, 21, 31, 41, 48], size=(6, 6, 6))
              .astype(np.uint8), (1.0, 1.0, 1.0))


def _brats18(src, rng):
    for grade, c in (("HGG", "Brats18_A_1"), ("LGG", "Brats18_B_1")):
        for mod in ("t1", "t1ce", "t2", "flair"):
            _vol(join(_mk(src, grade, c), f"{c}_{mod}.nii"), rng, (6, 6, 6))
        _seg(join(src, grade, c, f"{c}_seg.nii"), rng, (6, 6, 6),
             [0, 1, 2, 4])


def _brats2024_gli(src, rng):
    c = "BraTS-GLI-00000-000"
    for mod in ("t1n", "t1c", "t2w", "t2f"):
        _vol(join(_mk(src, c), f"{c}-{mod}.nii.gz"), rng, (6, 6, 6))
    _seg(join(src, c, f"{c}-seg.nii.gz"), rng, (6, 6, 6), range(5))


def _ctaaorta(src, rng):
    write_mha(join(_mk(src, "images"), "subject001_CTA.mha"),
              rng.rand(7, 6, 5).astype(np.float32), (1.0, 0.8, 2.0))
    write_mha(join(_mk(src, "masks"), "subject001_label.mha"),
              rng.randint(0, 24, (7, 6, 5)).astype(np.uint8), (1.0, 0.8, 2.0))


def _emidec(src, rng):
    for pat in ("Case_P001", "Case_P002"):
        _vol(join(_mk(src, pat, "Images"), f"{pat}.nii.gz"), rng, (6, 6, 4))
        _seg(join(_mk(src, pat, "Contours"), f"{pat}.nii.gz"), rng,
             (6, 6, 4), range(5))


def _amos_post(src, rng):
    for name, img, lab in (("amos_0001", "imagesTr", "labelsTr"),
                           ("amos_0500", "imagesVa", "labelsVa")):
        _vol(join(_mk(src, img), f"{name}.nii.gz"), rng, (6, 6, 4))
        _seg(join(_mk(src, lab), f"{name}.nii.gz"), rng, (6, 6, 4), range(3))
    _vol(join(_mk(src, "imagesTs"), "amos_0600.nii.gz"), rng, (6, 6, 4))
    save_json({"labels": {"0": "background", "1": "spleen", "2": "liver"}},
              join(src, "dataset.json"))


def _mnms(src, rng):
    d = _mk(src, "Training", "Labeled", "A0S9V9")
    seg4d = np.zeros((6, 6, 4, 10), np.uint8)
    seg4d[..., 2], seg4d[..., 7] = 1, 3
    write_nifti(join(d, "A0S9V9_sa.nii.gz"),
                rng.rand(6, 6, 4, 10).astype(np.float32),
                spacing=(1.2, 1.2, 8.0, 1.0))
    write_nifti(join(d, "A0S9V9_sa_gt.nii.gz"), seg4d,
                spacing=(1.2, 1.2, 8.0, 1.0))
    with open(join(src, "211230_M&Ms_Dataset_information_diagnosis_"
                        "opendataset.csv"), "w") as f:
        f.write("External code,Vendor,ED,ES\nA0S9V9,A,2,7\n")


def _roads(src, rng):
    from PIL import Image
    img = rng.randint(0, 255, (32, 32, 3)).astype(np.uint8)
    img[:16, :16] = 255
    seg = np.zeros((32, 32), np.uint8)
    seg[:, 8] = 255
    Image.fromarray(img).save(join(_mk(src, "training", "input"),
                                   "img-1.png"))
    Image.fromarray(seg).save(join(_mk(src, "training", "output"),
                                   "img-1.png"))


def _fluo(src, rng):
    for seq in ("01", "02"):
        for t in range(2):
            _write_tiff_stack(join(_mk(src, seq), f"t{t:03d}.tif"),
                              (rng.rand(3, 8, 8) * 100).astype(np.uint16))
            _write_tiff_stack(join(_mk(src, seq + "_GT", "SEG"),
                                   f"man_seg{t:03d}.tif"),
                              rng.randint(0, 2, (3, 8, 8)).astype(np.uint16))


RECIPES = {"brats21": _brats21, "kits2023": _kits2023, "acdc": _acdc,
           "ribfrac": _rib, "ribseg": _rib, "abdomenatlas": _abdomenatlas,
           "totalsegmentator_mri": _totalseg_mri, "autopet2": _autopet2,
           "toothfairy2": _toothfairy2, "brats18": _brats18,
           "brats2024_gli": _brats2024_gli, "ctaaorta": _ctaaorta,
           "emidec": _emidec, "amos_post_challenge": _amos_post,
           "mnms": _mnms, "road_segmentation": _roads,
           "fluo_c3dh_a549_sim": _fluo}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b):
    files = _files(a)
    assert files == _files(b) and files
    for f in files:
        pa, pb = join(a, f), join(b, f)
        if f.endswith(".json"):
            assert load_json(pa) == load_json(pb), f
        elif f.endswith(".gz"):
            with gzip.open(pa, "rb") as fa, gzip.open(pb, "rb") as fb:
                assert fa.read() == fb.read(), f
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), f
    return len(files)


def _roots(tmp_path, monkeypatch, who):
    for k in ("raw", "preprocessed"):
        monkeypatch.setenv(f"nnUNet_{k}", _mk(str(tmp_path), who, k))
    return join(str(tmp_path), who)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_output_equals_jax(tmp_path, monkeypatch, recipe):
    src = _mk(str(tmp_path), "src")
    RECIPES[recipe](src, np.random.RandomState(sorted(RECIPES).index(recipe)))
    _roots(tmp_path, monkeypatch, "port")
    convert_dataset_entry([recipe, src, "-d", "901"])
    _roots(tmp_path, monkeypatch, "jax")
    jconv._CONVERTERS[recipe](src, dataset_id=901)
    assert _same_tree(join(str(tmp_path), "port"),
                      join(str(tmp_path), "jax")) >= 3


def test_msd_4d_split_equals_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(11)
    src = _mk(str(tmp_path), "Task04_Prostate")
    for sub, n in (("imagesTr", 2), ("imagesTs", 1)):
        for i in range(n):
            write_nifti(join(_mk(src, sub), f"prostate_{sub[-2:]}{i}.nii.gz"),
                        rng.rand(6, 5, 4, 2).astype(np.float32),
                        spacing=(0.6, 0.6, 3.6, 1.0))
            if sub == "imagesTr":
                write_nifti(join(_mk(src, "labelsTr"),
                                 f"prostate_Tr{i}.nii.gz"),
                            rng.randint(0, 3, (6, 5, 4)).astype(np.uint8))
    (open(join(src, "imagesTr", "._prostate_Tr9.nii.gz"), "wb")).close()
    save_json({"name": "Prostate", "modality": {"0": "T2", "1": "ADC"},
               "labels": {"0": "background", "1": "PZ", "2": "TZ"},
               "description": "d", "reference": "r", "licence": "l"},
              join(src, "dataset.json"))
    _roots(tmp_path, monkeypatch, "port")
    convert_msd_entry(["-i", src, "-overwrite_id", "904"])
    _roots(tmp_path, monkeypatch, "jax")
    jmsd(src, 904)
    assert _same_tree(join(str(tmp_path), "port"),
                      join(str(tmp_path), "jax")) == 2 * 2 + 2 + 2 + 1
    dj = load_json(join(str(tmp_path), "port", "raw",
                        "Dataset904_Prostate", "dataset.json"))
    assert dj["channel_names"] == {"0": "T2", "1": "ADC"}
    assert dj["labels"] == {"background": 0, "PZ": 1, "TZ": 2}


def test_old_nnunet_task_equals_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(3)
    src = _mk(str(tmp_path), "Task042_Old")
    _vol(join(_mk(src, "imagesTr"), "case_0000.nii.gz"), rng, (6, 6, 6))
    _seg(join(_mk(src, "labelsTr"), "case.nii.gz"), rng, (6, 6, 6), [0, 1])
    _vol(join(_mk(src, "imagesTs"), "test_0000.nii.gz"), rng, (6, 6, 6))
    save_json({"modality": {"0": "CT"},
               "labels": {"0": "background", "1": "organ"},
               "tensorImageSize": "3D", "numTraining": 1, "numTest": 0,
               "training": [{"image": "x", "label": "y"}], "test": []},
              join(src, "dataset.json"))
    _roots(tmp_path, monkeypatch, "port")
    convert_old_nnunet_entry([src, "Dataset942_Old"])
    assert "Dataset942_Old" in capsys.readouterr().out
    with pytest.raises(RuntimeError):
        convert_old_nnunet_entry([src, "Dataset942_Old"])
    _roots(tmp_path, monkeypatch, "jax")
    jconv.convert_old_nnunet_task(src, "Dataset942_Old")
    assert _same_tree(join(str(tmp_path), "port"),
                      join(str(tmp_path), "jax")) == 4
    dj = load_json(join(str(tmp_path), "port", "raw", "Dataset942_Old",
                        "dataset.json"))
    assert dj["channel_names"] == {"0": "CT"} and "training" not in dj
