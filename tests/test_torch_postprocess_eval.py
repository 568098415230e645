"""The port's steps after training against the JAX package's (numpy/scipy
only, no card): connected-component postprocessing and its decisions,
probability ensembling of folders and cross-validations, find-best
configuration (cross-validation summaries, postprocessing.json, the
inference instructions and both reports, byte-equal once the JAX side's
``nnUNetv2_*`` script names are mapped to the port's), and the evaluate /
postprocess / overlay entries. Every comparison is exact."""
import json
import os
import shutil
import sys

import numpy as np
import pytest

from fast_nnunet_tpu.postprocessing import connected_components as jcc
from fast_nnunet_tpu_torch.postprocessing import connected_components as pcc

from . import torch_port_common  # noqa: F401  (caps torch threads)
from .test_find_best_configuration import env as fbc_env  # noqa: F401

K = 3  # background + 2 classes
SPACING = [1.0, 1.0, 1.0]
#: the JAX package's script names -> the port's console scripts
SCRIPT_NAMES = {"nnUNetv2_predict": "fast_nnunet_predict_torch",
                "nnUNetv2_ensemble": "fast_nnunet_ensemble_torch"}


def to_port_names(text: str) -> str:
    for a, b in SCRIPT_NAMES.items():
        text = text.replace(a, b)
    return text


def _read(path) -> str:
    with open(path) as f:
        return f.read()


def _blobs(rng, shape=(16, 18, 14), n=5, k=K):
    """A label map of random boxes (several per class, so components
    compete)."""
    seg = np.zeros(shape, np.uint8)
    for _ in range(n):
        c = rng.randint(1, k)
        lo = [rng.randint(0, s - 3) for s in shape]
        hi = [lo[d] + rng.randint(1, 6) for d in range(3)]
        seg[tuple(slice(a, b) for a, b in zip(lo, hi))] = c
    return seg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_largest_component_matches_jax(seed):
    rng = np.random.RandomState(seed)
    mask = _blobs(rng, n=8) > 0
    np.testing.assert_array_equal(pcc.remove_all_but_largest_component(mask),
                                  jcc.remove_all_but_largest_component(mask))


@pytest.mark.parametrize("labels", [1, [1], [2, 1], [(1, 2)], [(1, 2), 2],
                                    [[1, 2]]])
def test_removal_from_segmentation_matches_jax(labels):
    seg = _blobs(np.random.RandomState(7), n=10)
    got = pcc.remove_all_but_largest_component_from_segmentation(seg, labels)
    np.testing.assert_array_equal(
        got, jcc.remove_all_but_largest_component_from_segmentation(seg,
                                                                   labels))
    fns = ["remove_all_but_largest_component_from_segmentation"] * 2
    kw = [{"labels_or_regions": [(1, 2)]}, {"labels_or_regions": [1, 2]}]
    np.testing.assert_array_equal(pcc.apply_postprocessing(seg, fns, kw),
                                  jcc.apply_postprocessing(seg, fns, kw))


def _plans(ds="Dataset998_Eval"):
    return {"dataset_name": ds, "plans_name": "nnUNetPlans",
            "image_reader_writer": "NiftiIO",
            "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
            "configurations": {c: {"patch_size": [8, 8, 8]}
                               for c in ("3d_fullres", "3d_lowres")}}


def _dataset_json(n=4):
    return {"channel_names": {"0": "CT"}, "numTraining": n,
            "labels": {"background": 0, "a": 1, "b": 2},
            "file_ending": ".nii.gz"}


def _write_seg(seg, path):
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    NiftiIO().write_seg(seg, path, {"spacing": SPACING})


def _write_prediction(folder, case, gt, rng, spurious: bool, probs=True):
    """A noisy prediction of ``gt`` (with spurious blobs when asked), its
    probabilities (.npz, float16 as the predictor writes them) and
    properties (.pkl)."""
    from fast_nnunet_tpu_torch.utils.io import save_pickle
    logits = rng.randn(K, *gt.shape).astype(np.float32)
    logits[gt[None] == np.arange(K)[:, None, None, None]] += 6
    if spurious:
        for _ in range(3):
            lo = [rng.randint(0, s - 2) for s in gt.shape]
            logits[(rng.randint(1, K),) + tuple(slice(a, a + 2)
                                                for a in lo)] += 9
    p = np.exp(logits - logits.max(0))
    p /= p.sum(0)
    _write_seg(p.argmax(0).astype(np.uint8), os.path.join(folder,
                                                          case + ".nii.gz"))
    if probs:
        np.savez_compressed(os.path.join(folder, case + ".npz"),
                            probabilities=p.astype(np.float16))
        save_pickle({"spacing": SPACING}, os.path.join(folder, case + ".pkl"))


def _gt_folder(root, n=4, seed=0, layout="blobs"):
    """Ground truth: random boxes (``blobs``), or two touching boxes, one
    per class (``boxes``), plus a far second box of class 1
    (``boxes_split``, which the largest-component steps would drop)."""
    rng = np.random.RandomState(seed)
    folder = os.path.join(root, "gt")
    os.makedirs(folder, exist_ok=True)
    gts = {}
    for i in range(n):
        if layout == "blobs":
            gt = _blobs(rng, n=3)
        else:
            gt = np.zeros((16, 18, 14), np.uint8)
            gt[2:8, 2:8, 2:8] = 1
            gt[8:11, 2:8, 2:8] = 2
            if layout == "boxes_split":
                gt[-4:, -4:, -4:] = 1
        gts[f"case_{i:03d}"] = gt
        _write_seg(gt, os.path.join(folder, f"case_{i:03d}.nii.gz"))
    return folder, gts


@pytest.mark.parametrize("layout, n_steps", [("boxes", 2),
                                             ("boxes_split", 0)],
                         ids=["pp_helps", "pp_hurts"])
def test_determine_postprocessing_matches_jax(tmp_path, layout, n_steps):
    from fast_nnunet_tpu.core.plans import PlansManager as JPM
    from fast_nnunet_tpu_torch.core.plans import PlansManager as PPM
    gt, gts = _gt_folder(str(tmp_path), layout=layout)
    res = {}
    for who, mod, pm in (("port", pcc, PPM), ("jax", jcc, JPM)):
        pred = str(tmp_path / who / "pred")
        os.makedirs(pred)
        rng = np.random.RandomState(1)
        for case, g in gts.items():
            _write_prediction(pred, case, g, rng, spurious=True, probs=False)
        fns, kw, metrics = mod.determine_postprocessing(
            pred, gt, pm(_plans()), _dataset_json(), num_processes=1)
        res[who] = (fns, kw, metrics, _read(os.path.join(
            pred, "postprocessing.json")), pred)
    (pf, pk, pm_, pj, ppred), (jf, jk, jm, jj, jpred) = res.values()
    assert (pf, pk, pj) == (jf, jk, jj)
    assert json.dumps(pm_).replace("/port/", "/jax/") == json.dumps(jm)
    assert len(pf) == n_steps
    if n_steps:
        got = _files(ppred + "_pp_trial", ".nii.gz")
        assert len(got) == 4 and got == _files(jpred + "_pp_trial", ".nii.gz")
    assert os.path.isdir(ppred + "_pp_trial") == \
        os.path.isdir(jpred + "_pp_trial")


def _model_folders(root, n_cases=4, folds=(0, 1), configs=("3d_fullres",
                                                           "3d_lowres")):
    """results/<ds>/NNUNetTrainer__nnUNetPlans__<config>/ with plans.json,
    dataset.json and each fold's validation predictions (.nii.gz, .npz,
    .pkl), raw labelsTr with the ground truth and preprocessed plans: the
    layout find-best reads."""
    from fast_nnunet_tpu_torch.utils.io import save_json
    ds = _plans()["dataset_name"]
    raw = os.path.join(root, "raw", ds)
    os.makedirs(raw)
    _, gts = _gt_folder(raw, n=n_cases)
    os.rename(os.path.join(raw, "gt"), os.path.join(raw, "labelsTr"))
    os.makedirs(os.path.join(root, "preprocessed", ds))
    save_json(_plans(), os.path.join(root, "preprocessed", ds,
                                     "nnUNetPlans.json"), sort_keys=False)
    cases = sorted(gts)
    for ci, cfg in enumerate(configs):
        folder = os.path.join(root, "results", ds,
                              f"NNUNetTrainer__nnUNetPlans__{cfg}")
        os.makedirs(folder)
        save_json(_plans(), os.path.join(folder, "plans.json"),
                  sort_keys=False)
        save_json(_dataset_json(n_cases),
                  os.path.join(folder, "dataset.json"), sort_keys=False)
        rng = np.random.RandomState(10 + ci)
        for f in folds:
            val = os.path.join(folder, f"fold_{f}", "validation")
            os.makedirs(val)
            for case in cases[f::len(folds)]:
                _write_prediction(val, case, gts[case], rng,
                                  spurious=ci == 0)
    return ds, gts


class _Env:
    def __init__(self, root):
        self.env = {f"nnUNet_{k}": os.path.join(root, k)
                    for k in ("raw", "preprocessed", "results")}

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _files(folder, suffix):
    """name -> content of the files with ``suffix``; a NIfTI as its voxel
    bytes, dtype, shape and spacing (the two packages gzip differently);
    paths under a ``port`` folder read as under ``jax``."""
    from fast_nnunet_tpu_torch.imageio.nifti import read_nifti
    out = {}
    for f in sorted(os.listdir(folder)):
        if not f.endswith(suffix):
            continue
        if f.endswith(".nii.gz"):
            data, hdr = read_nifti(os.path.join(folder, f))
            out[f] = (data.tobytes(), str(data.dtype), data.shape,
                      list(hdr["pixdim"][1:4]))
        else:
            with open(os.path.join(folder, f), "rb") as fh:
                out[f] = fh.read().replace(b"/port/", b"/jax/")
    return out


def test_find_best_configuration_matches_jax(tmp_path, capsys):
    from fast_nnunet_tpu.evaluation.find_best_configuration import \
        find_best_configuration as jfind
    from fast_nnunet_tpu_torch.evaluation.find_best_configuration import \
        find_best_configuration_entry
    out = {}
    for who in ("port", "jax"):
        root = str(tmp_path / who)
        with _Env(root):
            ds, _ = _model_folders(root)
            capsys.readouterr()
            if who == "port":
                find_best_configuration_entry(
                    [ds, "-c", "3d_fullres", "3d_lowres", "2d", "-f", "0",
                     "1", "-np", "1"])
            else:
                jfind(ds, [{"plans": "nnUNetPlans", "configuration": c,
                            "trainer": "NNUNetTrainer"}
                           for c in ("3d_fullres", "3d_lowres", "2d")],
                      True, 1, folds=[0, 1])
            out[who] = (os.path.join(root, "results", ds),
                        capsys.readouterr().out)
    (pres, pout), (jres, jout) = out["port"], out["jax"]
    assert pout.replace("fast_nnunet_apply_postprocessing_torch",
                        "fast_nnunet_tpu.postprocessing."
                        "apply_postprocessing_to_folder").replace(
        "/port/", "/jax/") == to_port_names(jout)
    for f in ("inference_information.json", "inference_report.md",
              "inference_report.html"):
        assert _read(os.path.join(pres, f)) == to_port_names(
            _read(os.path.join(jres, f))), f
    info = json.loads(_read(os.path.join(pres, "inference_information.json")))
    best = info["best_model_or_ensemble"]
    assert set(info["considered_manually"]) == {
        "NNUNetTrainer__nnUNetPlans__3d_fullres",
        "NNUNetTrainer__nnUNetPlans__3d_lowres",
        "ensemble___NNUNetTrainer__nnUNetPlans__3d_fullres___"
        "NNUNetTrainer__nnUNetPlans__3d_lowres"}
    assert "fast_nnunet_predict_torch" in _read(os.path.join(
        pres, "inference_report.md"))
    for sub in ("crossval_results_folds_0_1/"
                "NNUNetTrainer__nnUNetPlans__3d_fullres",
                "ensembles/ensemble___NNUNetTrainer__nnUNetPlans__3d_fullres"
                "___NNUNetTrainer__nnUNetPlans__3d_lowres"):
        for suffix in (".nii.gz", ".json"):
            assert _files(os.path.join(pres, sub), suffix) == \
                _files(os.path.join(jres, sub), suffix), (sub, suffix)
    assert isinstance(best["mean_fg_dice"], float)


def test_cascade_inference_commands_match_jax(fbc_env):  # noqa: F811
    from fast_nnunet_tpu.evaluation.find_best_configuration import \
        generate_inference_command as jgen
    from fast_nnunet_tpu_torch.evaluation.find_best_configuration import \
        generate_inference_command as pgen
    from .test_find_best_configuration import _trained
    ds, res, plans = fbc_env
    _trained(res, ds, "3d_cascade_fullres", plans)
    for kw in ({}, {"folds": (0,), "save_probabilities": True}):
        got = pgen(ds, "3d_cascade_fullres", **kw)
        assert got == to_port_names(jgen(ds, "3d_cascade_fullres", **kw))
        assert "-prev_stage_predictions OUTPUT_FOLDER_PREV_STAGE" in got
        assert got.count("fast_nnunet_predict_torch") == 2


def test_ensemble_folders_and_entry_match_jax(tmp_path):
    from fast_nnunet_tpu.ensembling.ensemble import ensemble_folders as jens
    from fast_nnunet_tpu_torch.ensembling.ensemble import (
        average_probabilities, ensemble_entry)
    from fast_nnunet_tpu_torch.utils.io import save_json
    _, gts = _gt_folder(str(tmp_path))
    folders = []
    for m in range(2):
        f = str(tmp_path / f"model{m}")
        os.makedirs(f)
        rng = np.random.RandomState(20 + m)
        for case, g in gts.items():
            _write_prediction(f, case, g, rng, spurious=m == 1)
        save_json(_plans(), os.path.join(f, "plans.json"))
        save_json(_dataset_json(), os.path.join(f, "dataset.json"))
        folders.append(f)
    ensemble_entry(["-i", *folders, "-o", str(tmp_path / "port"),
                    "--save_npz", "-np", "1"])
    jens(folders, str(tmp_path / "jax"), True, 1)
    for suffix in (".nii.gz", ".npz", ".pkl"):
        assert _files(str(tmp_path / "port"), suffix) == \
            _files(str(tmp_path / "jax"), suffix), suffix
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    case = sorted(gts)[0]
    files = [os.path.join(f, case + ".npz") for f in folders]
    mean = average_probabilities(files)
    ref = (np.load(files[0])["probabilities"].astype(np.float32)
           + np.load(files[1])["probabilities"].astype(np.float32)) / 2
    np.testing.assert_array_equal(mean, ref)
    mask = NiftiIO().read_seg(str(tmp_path / "port" / (case + ".nii.gz")))[0]
    np.testing.assert_array_equal(mask[0], ref.argmax(0))


def test_ensemble_crossvalidations_matches_jax(tmp_path):
    from fast_nnunet_tpu.ensembling.ensemble import \
        ensemble_crossvalidations as jcv
    from fast_nnunet_tpu_torch.ensembling.ensemble import \
        ensemble_crossvalidations as pcv
    root = str(tmp_path)
    with _Env(root):
        ds, _ = _model_folders(root)
    models = [os.path.join(root, "results", ds,
                           f"NNUNetTrainer__nnUNetPlans__{c}")
              for c in ("3d_fullres", "3d_lowres")]
    pcv(models, str(tmp_path / "port"), [0, 1], 1)
    jcv(models, str(tmp_path / "jax"), [0, 1], 1)
    got = _files(str(tmp_path / "port"), ".nii.gz")
    assert len(got) == 4 and got == _files(str(tmp_path / "jax"), ".nii.gz")
    with pytest.raises(RuntimeError, match="validation"):
        pcv(models, str(tmp_path / "x"), [0, 1, 2], 1)


def _eval_folders(tmp_path):
    gt, gts = _gt_folder(str(tmp_path), layout="boxes")
    pred = str(tmp_path / "pred")
    os.makedirs(pred)
    rng = np.random.RandomState(4)
    for case, g in gts.items():
        _write_prediction(pred, case, g, rng, spurious=True, probs=False)
    from fast_nnunet_tpu_torch.utils.io import save_json
    save_json(_plans(), str(tmp_path / "plans.json"))
    save_json(_dataset_json(), str(tmp_path / "dataset.json"))
    return gt, pred, str(tmp_path / "plans.json"), \
        str(tmp_path / "dataset.json")


@pytest.mark.parametrize("entry", ["evaluate_folder", "evaluate_simple"])
def test_evaluate_entries_match_jax(tmp_path, monkeypatch, capsys, entry):
    from fast_nnunet_tpu.run import evaluate as jev
    from fast_nnunet_tpu_torch.run import evaluate as pev
    gt, pred, pfile, dj = _eval_folders(tmp_path)
    args = [gt, pred, "-np", "1"] + (
        ["-djfile", dj, "-pfile", pfile] if entry == "evaluate_folder"
        else ["-l", "1", "2"])
    outs = []
    for who, mod in (("port", pev), ("jax", jev)):
        out = str(tmp_path / f"{who}.json")
        if who == "port":
            getattr(mod, entry + "_entry")(args + ["-o", out])
        else:
            monkeypatch.setattr(sys, "argv", ["x"] + args + ["-o", out])
            getattr(mod, entry + "_entry")()
        outs.append((_read(out), capsys.readouterr().out.replace(
            f"{who}.json", "")))
    assert outs[0] == outs[1]
    assert "mean fg Dice" in outs[0][1]


def test_postprocessing_entries_match_jax(tmp_path, monkeypatch, capsys):
    from fast_nnunet_tpu.run import evaluate as jev
    from fast_nnunet_tpu_torch.run import evaluate as pev
    gt, pred, pfile, dj = _eval_folders(tmp_path)
    jpred = str(tmp_path / "jpred")
    shutil.copytree(pred, jpred)
    pev.determine_postprocessing_entry(["-i", pred, "-ref", gt, "-djfile", dj,
                                        "-pfile", pfile, "-np", "1"])
    monkeypatch.setattr(sys, "argv", ["x", "-i", jpred, "-ref", gt, "-djfile",
                                      dj, "-pfile", pfile, "-np", "1"])
    jev.determine_postprocessing_entry()
    pp_json = os.path.join(pred, "postprocessing.json")
    assert _read(pp_json) == _read(os.path.join(jpred, "postprocessing.json"))
    assert json.loads(_read(pp_json))["pp_fns"]
    pev.apply_postprocessing_entry(["-i", pred, "-o", str(tmp_path / "p_pp"),
                                    "-pp_json", pp_json, "-djfile", dj,
                                    "-pfile", pfile])
    monkeypatch.setattr(sys, "argv", ["x", "-i", pred, "-o",
                                      str(tmp_path / "j_pp"), "-pp_json",
                                      pp_json, "-djfile", dj, "-pfile",
                                      pfile])
    jev.apply_postprocessing_entry()
    got = _files(str(tmp_path / "p_pp"), ".nii.gz")
    assert len(got) == 4 and got == _files(str(tmp_path / "j_pp"), ".nii.gz")


def test_overlay_entry_matches_jax(tmp_path, monkeypatch):
    from fast_nnunet_tpu.run.evaluate import plot_overlay_entry as jplot
    from fast_nnunet_tpu.utils.overlay_plots import generate_overlay as jgen
    from fast_nnunet_tpu_torch.imageio.nifti import write_nifti
    from fast_nnunet_tpu_torch.run.evaluate import plot_overlay_entry
    from fast_nnunet_tpu_torch.utils.overlay_plots import generate_overlay
    rng = np.random.RandomState(2)
    img = rng.rand(10, 12, 6).astype(np.float32)
    seg = _blobs(rng, shape=(10, 12, 6), n=4)
    np.testing.assert_array_equal(generate_overlay(img[3], seg[3], 0.4),
                                  jgen(img[3], seg[3], 0.4))
    for sub in ("img", "seg"):
        os.makedirs(tmp_path / sub)
    write_nifti(str(tmp_path / "img" / "c0_0000.nii.gz"), img)
    write_nifti(str(tmp_path / "seg" / "c0.nii.gz"), seg)
    args = ["-i", str(tmp_path / "img"), "-s", str(tmp_path / "seg")]
    plot_overlay_entry(args + ["-o", str(tmp_path / "p")])
    monkeypatch.setattr(sys, "argv", ["x"] + args + ["-o",
                                                     str(tmp_path / "j")])
    jplot()
    assert _files(str(tmp_path / "p"), ".png") == \
        _files(str(tmp_path / "j"), ".png")
    assert len(os.listdir(tmp_path / "p")) == 1
