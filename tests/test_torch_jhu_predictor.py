"""The port's JHU AbdomenAtlas predictor (fast_nnunet_tpu_torch/inference/
jhu_predictor.py) against the JAX package's, on the tests/test_jhu_predictor
.py contract: per case a ``predictions/`` folder with one binary uint8 file
per foreground class named by its label, the same files bit for bit as the
JAX predictor writes from the same weights (f32 networks and tiles on both
sides), with and without largest-component postprocessing and
probabilities; and ``fast_nnunet_jhu_predict_torch`` on the golden model
folder against the JAX CLI."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.inference.jhu_predictor import \
    JHUPredictor as JaxJHUPredictor
from fast_nnunet_tpu.inference.jhu_predictor import \
    jhu_predict_entry as jax_jhu_entry
from fast_nnunet_tpu_torch.core.plans import PlansManager
from fast_nnunet_tpu_torch.imageio.nifti import read_nifti, write_nifti
from fast_nnunet_tpu_torch.inference.jhu_predictor import (JHUPredictor,
                                                           jhu_predict_entry)
from fast_nnunet_tpu_torch.utils.io import join, maybe_mkdir_p

from .test_jhu_predictor import _small_plans
from .torch_port_common import (GOLDEN,  # noqa: F401  (fixture)
                                no_persistent_compile_cache)

DATASET_JSON = {"labels": {"background": 0, "liver": 1, "spleen": 2},
                "file_ending": ".nii.gz", "channel_names": {"0": "CT"}}


@pytest.fixture(scope="module")
def predictors():
    """(port, JAX) JHU predictors on the same seeded f32 weights."""
    from fast_nnunet_tpu.core.plans import PlansManager as JaxPlansManager
    from fast_nnunet_tpu.models.factory import \
        build_network_from_arch_dict as jax_build
    from fast_nnunet_tpu_torch.models.factory import \
        build_network_from_arch_dict
    plans = _small_plans()
    jpm = JaxPlansManager(plans)
    jcfg = jpm.get_configuration("3d_fullres")
    arch = jcfg.configuration["architecture"]
    jnet = jax_build(arch, 1, 3, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)),
        deep_supervision=False))
    jp = JaxJHUPredictor(use_mirroring=False, verbose=False)
    jp.manual_initialization(jnet, jpm, jcfg, [params], DATASET_JSON,
                             "NNUNetTrainer", ())
    jp.engine.compute_dtype = jnp.float32
    pm = PlansManager(plans)
    cfg = pm.get_configuration("3d_fullres")
    tp = JHUPredictor(use_mirroring=False, device="cpu",
                      compute_dtype=torch.float32)
    tp.manual_initialization(
        build_network_from_arch_dict(arch, 1, 3, torch.float32), pm, cfg,
        [params], DATASET_JSON, "NNUNetTrainer", ())
    return tp, jp


def _case(root, name, seed):
    img = (np.random.RandomState(seed).rand(20, 18, 16) * 300).astype(
        np.float32)
    folder = join(root, "in", name)
    maybe_mkdir_p(folder)
    write_nifti(join(folder, "ct.nii.gz"), img, spacing=(1.0, 1.0, 1.0))
    return join(folder, "ct.nii.gz"), img


@pytest.mark.parametrize("largest,probs", [(False, False), (True, True)])
def test_class_files_equal_jax(predictors, tmp_path, largest, probs):
    tp, jp = predictors
    root = str(tmp_path)
    cases = [_case(root, "caseA", 0), _case(root, "caseB", 1)]
    maybe_mkdir_p(join(root, "jax"))  # the JAX export needs it (ROADMAP §3)
    for k, pred in (("port", tp), ("jax", jp)):
        pred.predict_cases_to_class_folders(
            [[c] for c, _ in cases],
            [join(root, k, n) for n in ("caseA", "caseB")],
            save_probabilities=probs, apply_largest_component=largest)
    for name, (_, img) in zip(("caseA", "caseB"), cases):
        got = sorted(os.listdir(join(root, "port", name, "predictions")))
        assert got == ["liver.nii.gz", "spleen.nii.gz"]
        assert got == sorted(os.listdir(join(root, "jax", name,
                                             "predictions")))
        masks = []
        for f in got:
            p, _ = read_nifti(join(root, "port", name, "predictions", f))
            j, _ = read_nifti(join(root, "jax", name, "predictions", f))
            np.testing.assert_array_equal(p, j)
            assert p.shape == img.shape and p.dtype == np.uint8
            assert set(np.unique(p)) <= {0, 1}
            masks.append(p.astype(bool))
        assert not np.any(masks[0] & masks[1])  # argmax: disjoint classes
        if probs:
            a = np.load(join(root, "port", name + ".npz"))["probabilities"]
            b = np.load(join(root, "jax", name + ".npz"))["probabilities"]
            assert a.shape == b.shape == (3, *img.shape[::-1])
            assert np.abs(a - b).max() <= 1e-5
            assert os.path.isfile(join(root, "port", name + ".pkl"))


def test_single_case_form(predictors, tmp_path):
    tp, _ = predictors
    ct, img = _case(str(tmp_path), "caseC", 2)
    tp.predict_case_to_class_files([ct], str(tmp_path / "out"))
    mask, _ = read_nifti(str(tmp_path / "out" / "predictions" /
                             "liver.nii.gz"))
    assert mask.shape == img.shape


def test_jhu_cli_on_golden_equals_jax(tmp_path):
    """``<input>/<case>/ct.nii.gz -> <output>/<case>/predictions/`` through
    both CLIs (bf16 networks, mirror TTA) on the golden model: the same
    class files. Without ``--device`` the CLI asks for the card."""
    (tmp_path / "in" / "case_0").mkdir(parents=True)
    shutil.copy(os.path.join(GOLDEN, "input_0000.nii.gz"),
                tmp_path / "in" / "case_0" / "ct.nii.gz")
    model = os.path.join(GOLDEN, "model")
    jhu_predict_entry([str(tmp_path / "in"), str(tmp_path / "port"),
                       "-model", model, "-f", "0", "--device", "cpu"])
    jax_jhu_entry([str(tmp_path / "in"), str(tmp_path / "jax"),
                   "-model", model, "-f", "0"])
    pred = ("case_0", "predictions")
    files = sorted(os.listdir(tmp_path.joinpath("port", *pred)))
    assert files == ["class_1.nii.gz", "class_2.nii.gz"]
    for f in files:
        np.testing.assert_array_equal(
            read_nifti(str(tmp_path.joinpath("port", *pred, f)))[0],
            read_nifti(str(tmp_path.joinpath("jax", *pred, f)))[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            jhu_predict_entry([str(tmp_path / "in"), str(tmp_path / "x"),
                               "-model", model, "-f", "0"])


def test_every_export_error_surfaces(predictors, tmp_path, monkeypatch):
    """An export that fails while others are still running raises from
    predict_cases_to_class_folders. Case 1 fails at once; case 0 returns
    once case 3's export has started, so the queue's wait on its oldest
    export ends while cases 2 and 3 still run (the JAX loop then drops
    case 1's finished future unread, ROADMAP §3)."""
    import threading
    from fast_nnunet_tpu_torch.inference import jhu_predictor as mod
    tp, _ = predictors
    started3, release = threading.Event(), threading.Event()

    def export(logits, props, pm, cm, dj, out, *args):
        case = out[-1]
        if case == "1":
            raise OSError("disk full")
        if case == "0":
            assert started3.wait(30)
            threading.Timer(0.5, release.set).start()
            return
        if case == "3":
            started3.set()
        assert release.wait(30)

    monkeypatch.setattr(mod, "export_prediction_to_class_files", export)
    ct, _ = _case(str(tmp_path), "c", 3)
    with pytest.raises(OSError, match="disk full"):
        tp.predict_cases_to_class_folders(
            [[ct]] * 4, [str(tmp_path / f"case{i}") for i in range(4)],
            num_export_workers=4)
