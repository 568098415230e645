"""The port's planning modules against the JAX package's (numpy only, no
card): topology, the feature-map estimator, the default and ResEnc
planners, the channel-name normalization map, the reader/writer registry,
the raw-dataset helpers and the plans transfer. Every comparison is exact:
the same dicts, the same JSON bytes on disk."""
import json
import os

import numpy as np
import pytest

import chip_smoke
from fast_nnunet_tpu.models import estimator as jest
from fast_nnunet_tpu.planning import topology as jtop
from fast_nnunet_tpu_torch.models import estimator as pest
from fast_nnunet_tpu_torch.planning import topology as ptop

from . import torch_port_common  # noqa: F401  (caps torch threads)
from .test_planner_ground_truth import wholebody_env  # noqa: F401


@pytest.mark.parametrize("spacing, patch, min_fm, max_pool", [
    ((2.0, 0.9765625, 0.9765625), (160, 96, 96), 4, 999999),
    ((1.0, 1.0, 1.0), (128, 128, 128), 4, 999999),
    ((5.0, 0.7, 0.7), (20, 320, 256), 4, 999999),
    ((3.0, 1.0, 1.0), (40, 112, 112), 4, 5),
    ((0.8, 0.8), (512, 448), 4, 999999),
    ((1.5, 0.9, 2.1), (77, 131, 50), 4, 999999),
    ((1.0, 1.0, 4.0), (96, 96, 14), 4, 999999),
])
def test_topology_matches_jax(spacing, patch, min_fm, max_pool):
    p = ptop.get_pool_and_conv_props(spacing, patch, min_fm, max_pool)
    j = jtop.get_pool_and_conv_props(spacing, patch, min_fm, max_pool)
    assert p[:4] == j[:4]
    np.testing.assert_array_equal(p[4], j[4])


_PLAIN = {"features_per_stage": [32, 64, 128, 256, 320, 320],
          "strides": [[1, 1, 1], [1, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2],
                      [2, 1, 1]],
          "n_conv_per_stage": [2] * 6, "n_conv_per_stage_decoder": [2] * 5}
_RES = {"features_per_stage": [32, 64, 128, 256],
        "strides": [1, 2, 2, [1, 2, 2]],
        "n_blocks_per_stage": [1, 3, 4, 6], "n_conv_per_stage_decoder": [1] * 3}


@pytest.mark.parametrize("cls, kw, patch, k, ds", [
    ("dynamic_network_architectures.architectures.unet.PlainConvUNet",
     _PLAIN, (160, 96, 96), 61, True),
    ("PlainConvUNet", _PLAIN, (160, 96, 96), 61, False),
    ("LiteNNUNetStudent", _PLAIN, (96, 64, 80), 3, True),
    ("dynamic_network_architectures.architectures.unet.ResidualEncoderUNet",
     _RES, (64, 96, 96), 4, True),
    ("LiteResEncStudent", _RES, (32, 48, 64), 2, False),
])
def test_estimator_matches_jax(cls, kw, patch, k, ds):
    p = pest.compute_conv_feature_map_size(cls, kw, patch, k, ds)
    assert p == jest.compute_conv_feature_map_size(cls, kw, patch, k, ds)
    assert p > 0


def test_estimator_rejects_unknown_architecture():
    with pytest.raises(ValueError):
        pest.compute_conv_feature_map_size("Primus", _PLAIN, (8, 8, 8), 2)


def _read(path):
    with open(path) as f:
        return f.read()


def _plan_both(dataset, planner="ExperimentPlanner", **kwargs):
    """(port plans, JAX plans, port JSON text, JAX JSON text); each planner
    writes its plans file, read back after each run."""
    from fast_nnunet_tpu.run import plan_and_preprocess as jpp
    from fast_nnunet_tpu_torch.run import plan_and_preprocess as ppp
    from fast_nnunet_tpu_torch.utils.io import join
    pre = join(os.environ["nnUNet_preprocessed"], dataset)
    out = []
    for mod in (ppp, jpp):
        cls = mod.PLANNERS[planner]
        planner_obj = cls(dataset, **kwargs)
        plans = planner_obj.plan_experiment()
        out.append((plans, _read(join(pre, planner_obj.plans_identifier
                                      + ".json"))))
        os.remove(join(pre, planner_obj.plans_identifier + ".json"))
    (pp, pt), (jp, jt) = out
    return pp, jp, pt, jt


def test_bone_turbo_ground_truth_plans_equal_jax(wholebody_env):  # noqa: F811
    """The round-5 whole-body CT fingerprint (tests/test_planner_ground_truth
    .py): every configuration, dict for dict and byte for byte."""
    pp, jp, pt, jt = _plan_both("Dataset501_WholeBodyBones")
    assert pp == jp and pt == jt
    c = pp["configurations"]["3d_fullres"]
    assert c["patch_size"] == [160, 96, 96] and c["batch_size"] == 2
    assert {"2d", "3d_lowres", "3d_cascade_fullres"} <= set(
        pp["configurations"])


@pytest.fixture()
def pipeline_env(tmp_path, monkeypatch):
    """chip_smoke.py phase 11's dataset as a fingerprint: 5 CT cases of
    TRAIN_CASE voxels at TRAIN_SPACING, 61 labels, nothing cropped."""
    ds = chip_smoke.PIPELINE_DS
    raw = tmp_path / "raw" / ds
    pre = tmp_path / "pre" / ds
    (raw / "imagesTr").mkdir(parents=True)
    pre.mkdir(parents=True)
    monkeypatch.setenv("nnUNet_raw", str(tmp_path / "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pre"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))
    n = chip_smoke.PIPELINE_N_TRAIN
    dj = {"channel_names": {"0": "CT"},
          "labels": {("background" if i == 0 else f"bone_{i}"): i
                     for i in range(chip_smoke.TRAIN_K)},
          "numTraining": n, "file_ending": ".nii.gz"}
    (raw / "dataset.json").write_text(json.dumps(dj))
    for i in range(n):
        (raw / "imagesTr" / f"case_{i:03d}_0000.nii.gz").write_bytes(b"")
    fp = {"spacings": [list(chip_smoke.TRAIN_SPACING)] * n,
          "shapes_after_crop": [list(chip_smoke.TRAIN_CASE)] * n,
          "median_relative_size_after_cropping": 1.0,
          "foreground_intensity_properties_per_channel": {"0": {
              "mean": 512.5, "std": 171.2, "percentile_00_5": 240.0,
              "percentile_99_5": 790.0, "median": 505.0, "min": 200.0,
              "max": 820.0}}}
    (pre / "dataset_fingerprint.json").write_text(json.dumps(fp))
    return ds


def test_chip_smoke_frozen_topology_is_the_planners(pipeline_env):
    """chip_smoke.PIPELINE_3D_FULLRES is what both planners give for the
    smoke run's raw dataset; the whole plans are equal too."""
    pp, jp, pt, jt = _plan_both(pipeline_env)
    assert pp == jp and pt == jt
    assert chip_smoke.plan_topology(pp["configurations"]["3d_fullres"]) \
        == chip_smoke.PIPELINE_3D_FULLRES
    assert "3d_lowres" not in pp["configurations"]


def test_chip_smoke_frozen_resenc_l_topology_is_the_planners(pipeline_env):
    """chip_smoke.PIPELINE_RESENC_L (phase 12) is what both packages'
    nnUNetPlannerResEncL give for the smoke run's raw dataset; the whole
    plans are equal too."""
    pp, jp, pt, jt = _plan_both(pipeline_env, "nnUNetPlannerResEncL")
    assert pp == jp and pt == jt
    assert pp["plans_name"] == chip_smoke.RESENC_PLANS
    assert chip_smoke.plan_topology(pp["configurations"]["3d_fullres"],
                                    chip_smoke.RESENC_KEYS) \
        == chip_smoke.PIPELINE_RESENC_L


@pytest.fixture()
def cascade_env(tmp_path, monkeypatch):
    """chip_smoke.py phase 13's dataset as a fingerprint: 5 CT cases of
    CASCADE_CASE voxels at CASCADE_SPACING, 61 labels, nothing cropped."""
    ds = chip_smoke.CASCADE_DS
    raw = tmp_path / "raw" / ds
    pre = tmp_path / "pre" / ds
    (raw / "imagesTr").mkdir(parents=True)
    pre.mkdir(parents=True)
    monkeypatch.setenv("nnUNet_raw", str(tmp_path / "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pre"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))
    n = chip_smoke.PIPELINE_N_TRAIN
    dj = {"channel_names": {"0": "CT"},
          "labels": {("background" if i == 0 else f"bone_{i}"): i
                     for i in range(chip_smoke.TRAIN_K)},
          "numTraining": n, "file_ending": ".nii.gz"}
    (raw / "dataset.json").write_text(json.dumps(dj))
    for i in range(n):
        (raw / "imagesTr" / f"case_{i:03d}_0000.nii.gz").write_bytes(b"")
    fp = {"spacings": [list(chip_smoke.CASCADE_SPACING)] * n,
          "shapes_after_crop": [list(chip_smoke.CASCADE_CASE)] * n,
          "median_relative_size_after_cropping": 1.0,
          "foreground_intensity_properties_per_channel": {"0": {
              "mean": 512.5, "std": 171.2, "percentile_00_5": 240.0,
              "percentile_99_5": 790.0, "median": 505.0, "min": 200.0,
              "max": 820.0}}}
    (pre / "dataset_fingerprint.json").write_text(json.dumps(fp))
    return ds


def test_chip_smoke_frozen_cascade_topologies_are_the_planners(cascade_env):
    """chip_smoke.CASCADE_PLANS (phase 13: 2d, 3d_fullres, 3d_lowres and
    3d_cascade_fullres) are what both planners give for the smoke run's CT
    dataset of 48 slices of 512 x 512 at 2.5 x 0.8 x 0.8 mm; the whole plans
    are equal too, the lowres
    stage names the cascade as its next stage and the cascade inherits
    3d_fullres."""
    pp, jp, pt, jt = _plan_both(cascade_env)
    assert pp == jp and pt == jt
    assert chip_smoke.cascade_topologies(pp) == chip_smoke.CASCADE_PLANS
    cfgs = pp["configurations"]
    assert sorted(cfgs) == sorted(chip_smoke.CASCADE_CONFIGS)
    assert cfgs["3d_lowres"]["next_stage"] == "3d_cascade_fullres"
    assert cfgs["3d_cascade_fullres"] == {"inherits_from": "3d_fullres",
                                          "previous_stage": "3d_lowres"}


@pytest.mark.parametrize("planner", ["ResEncUNetPlanner",
                                     "nnUNetPlannerResEncM",
                                     "nnUNetPlannerResEncL",
                                     "nnUNetPlannerResEncXL"])
def test_resenc_planners_equal_jax(wholebody_env, planner):  # noqa: F811
    pp, jp, pt, jt = _plan_both("Dataset501_WholeBodyBones", planner)
    assert pp == jp and pt == jt
    arch = pp["configurations"]["3d_fullres"]["architecture"]
    assert arch["network_class_name"].endswith("ResidualEncoderUNet")
    assert "n_blocks_per_stage" in arch["arch_kwargs"]


@pytest.mark.parametrize("target_gb", [None, 4, 8, 80])
def test_memory_target_plans_equal_jax(pipeline_env, target_gb):
    """Both planners' default (None: not passed) is the 8 GB target, and an
    explicit target plans alike."""
    kw = {} if target_gb is None else {"gpu_memory_target_in_gb": target_gb}
    pp, jp, pt, jt = _plan_both(pipeline_env, **kw)
    assert pp == jp and pt == jt
    if target_gb in (None, 8):
        assert pp["configurations"]["3d_fullres"]["batch_size"] == 2


@pytest.mark.parametrize("name", ["CT", "noNorm", "zscore", "rescale_to_0_1",
                                  "rgb_to_0_1", "T2", "MRI"])
def test_normalization_scheme_by_channel_name(name):
    from fast_nnunet_tpu.ops.normalization import get_normalization_scheme as j
    from fast_nnunet_tpu_torch.ops.normalization import \
        get_normalization_scheme as p
    assert p(name).__name__ == j(name).__name__
    assert p(name).leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true \
        == j(name).leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true


def test_registry_matches_jax_for_nifti_and_raises_for_the_rest():
    from fast_nnunet_tpu.imageio import registry as jr
    from fast_nnunet_tpu_torch.imageio import nifti as pn
    from fast_nnunet_tpu_torch.imageio import registry as pr
    for fe in (".nii.gz", ".nii", "nii.gz", ".gz"):
        assert pr.determine_reader_writer_from_file_ending(fe).__name__ == \
            jr.determine_reader_writer_from_file_ending(fe).__name__
    dj = {"file_ending": ".nii.gz"}
    assert pr.determine_reader_writer_from_dataset_json(dj).__name__ == \
        jr.determine_reader_writer_from_dataset_json(dj).__name__ == "NiftiIO"
    for name in ("NiftiIO", "SimpleITKIO", "NibabelIOWithReorient"):
        assert pr.find_reader_writer_by_name(name).__name__ == \
            jr.find_reader_writer_by_name(name).__name__
        assert pn.find_reader_writer_by_name(name) is \
            pr.find_reader_writer_by_name(name)
    # the other formats resolve as in JAX (the readers are ported); only
    # unknown names and endings raise
    for fe in (".nrrd", ".mha", ".tif", ".png", ".dcm"):
        assert pr.determine_reader_writer_from_file_ending(fe).__name__ == \
            jr.determine_reader_writer_from_file_ending(fe).__name__
    for name in ("NrrdIO", "MhaIO", "Tiff3DIO", "NaturalImage2DIO",
                 "DicomIO"):
        assert pr.find_reader_writer_by_name(name).__name__ == name
        assert pr.determine_reader_writer_from_dataset_json(
            {"file_ending": ".nii.gz",
             "overwrite_image_reader_writer": name}).__name__ == \
            jr.determine_reader_writer_from_dataset_json(
                {"file_ending": ".nii.gz",
                 "overwrite_image_reader_writer": name}).__name__ == name
    with pytest.raises(KeyError):
        pr.find_reader_writer_by_name("NoSuchIO")
    with pytest.raises(RuntimeError):
        pr.determine_reader_writer_from_file_ending(".xyz")


def test_dataset_io_matches_jax(tmp_path):
    from fast_nnunet_tpu.utils import dataset_io as jd
    from fast_nnunet_tpu_torch.utils import dataset_io as pd
    for mod, sub in ((pd, "p"), (jd, "j")):
        d = tmp_path / sub
        (d / "imagesTr").mkdir(parents=True)
        for case in ("b_case", "a_case"):
            for c in range(2):
                (d / "imagesTr" / f"{case}_{c:04d}.nii.gz").write_bytes(b"")
        mod.generate_dataset_json(str(d), {0: "CT", 1: "PET"},
                                  {"background": 0, "x": 1, "xy": [1, 2]},
                                  2, ".nii.gz", regions_class_order=(1, 2),
                                  dataset_name="Dataset1_X",
                                  overwrite_image_reader_writer="NiftiIO",
                                  description="d")
    assert _read(tmp_path / "p" / "dataset.json") == \
        _read(tmp_path / "j" / "dataset.json")
    got = pd.get_filenames_of_train_images_and_targets(str(tmp_path / "p"))
    ref = jd.get_filenames_of_train_images_and_targets(str(tmp_path / "j"))
    assert json.dumps(got).replace("/p/", "/j/") == json.dumps(ref)
    listed = {"file_ending": ".nii.gz", "dataset": {"c": {
        "images": ["imagesTr/c_0000.nii.gz", "/abs/c_0001.nii.gz"],
        "label": "labelsTr/c.nii.gz"}}}
    assert pd.get_filenames_of_train_images_and_targets("/r", listed) == \
        jd.get_filenames_of_train_images_and_targets("/r", listed)
    with pytest.raises(AssertionError):
        pd.generate_dataset_json(str(tmp_path), {0: "CT"},
                                 {"background": 0, "r": [1, 2]}, 1, ".nii.gz")


def test_move_plans_between_datasets_matches_jax(tmp_path, monkeypatch):
    from fast_nnunet_tpu.planning.plans_transfer import \
        move_plans_between_datasets as jmove
    from fast_nnunet_tpu_torch.planning.plans_transfer import (
        move_plans_between_datasets as pmove, move_plans_entry)
    monkeypatch.setenv("nnUNet_raw", str(tmp_path / "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pre"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))
    for ds, mean in (("Dataset001_Src", 1.0), ("Dataset002_Tgt", 7.0)):
        (tmp_path / "raw" / ds).mkdir(parents=True)
        (tmp_path / "pre" / ds).mkdir(parents=True)
        (tmp_path / "raw" / ds / "dataset.json").write_text(json.dumps(
            {"labels": {"background": 0, "a": 1}, "file_ending": ".nii.gz"}))
        (tmp_path / "pre" / ds / "dataset_fingerprint.json").write_text(
            json.dumps({"foreground_intensity_properties_per_channel":
                        {"0": {"mean": mean}}}))
    src = {"dataset_name": "Dataset001_Src", "plans_name": "nnUNetPlans",
           "foreground_intensity_properties_per_channel": {"0": {"mean": 1.0}},
           "configurations": {"3d_fullres": {
               "data_identifier": "nnUNetPlans_3d_fullres",
               "patch_size": [8, 8, 8]},
               "3d_cascade_fullres": {"inherits_from": "3d_fullres"}}}
    (tmp_path / "pre" / "Dataset001_Src" / "nnUNetPlans.json").write_text(
        json.dumps(src))
    out = tmp_path / "pre" / "Dataset002_Tgt" / "moved.json"
    texts = []
    for fn in (jmove, pmove):
        assert fn(1, 2, "nnUNetPlans", "moved") == \
            jmove(1, 2, "nnUNetPlans", "moved")
        texts.append(_read(out))
    move_plans_entry(["-s", "1", "-t", "Dataset002_Tgt", "-sp", "nnUNetPlans",
                      "-tp", "moved"])
    texts.append(_read(out))
    assert texts[0] == texts[1] == texts[2]
    moved = json.loads(texts[0])
    assert moved["dataset_name"] == "Dataset002_Tgt"
    assert moved["foreground_intensity_properties_per_channel"]["0"][
        "mean"] == 7.0
    assert moved["configurations"]["3d_fullres"]["data_identifier"] == \
        "moved_3d_fullres"
    os.remove(tmp_path / "pre" / "Dataset002_Tgt" / "dataset_fingerprint.json")
    with pytest.raises(AssertionError, match="fingerprint"):
        pmove(1, 2, "nnUNetPlans")
