"""The 2d configuration end to end on the CPU, through the port's entry
points (the counterpart of tests/test_2d_e2e.py, which the JAX package marks
slow, at tier-1 size): ``fast_nnunet_plan_and_preprocess_torch -c 2d
3d_fullres`` on a synthetic 3D dataset, ``fast_nnunet_train_torch DS 2d 0``
(2 iterations, a 2D network on pseudo-3D slices, validated
2D-over-slices) and ``... 3d_fullres 0``; ``fast_nnunet_predict_torch -c 2d``
segments a 3D NIfTI with the image's shape and spacing; with float32
networks on both sides the port's predictor writes the JAX predictor's
mask from the same checkpoint and their 2D-over-slices logits agree within
atol 3e-4; and the 2d + 3d_fullres ensemble that find-best proposes runs as
written: both predict with ``--save_probabilities`` and
``fast_nnunet_ensemble_torch`` merges the two folders as they are. The 2d
plan's pseudo-3D sampler and augmenter give the JAX package's batches bit
for bit; distillation of a 2d plan raises ``NotImplementedError`` (it waits in
ROADMAP.md §1's queue as "2d and cascade distillation")."""
import os
import shutil

import numpy as np
import pytest

from .helpers import make_synthetic_dataset
from .torch_port_common import jax_predictor_f32
from .torch_port_common import no_persistent_compile_cache  # noqa: F401

DS = "Dataset988_TwoD"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import \
        plan_and_preprocess_entry
    from fast_nnunet_tpu_torch.run.run_training import run_training_entry
    from fast_nnunet_tpu_torch.utils.io import join, load_json, save_json
    root = str(tmp_path_factory.mktemp("e2e2d"))
    env = {f"nnUNet_{k}": join(root, k)
           for k in ("raw", "preprocessed", "results")}
    env.update(FNNT_ITERS_PER_EPOCH="2", FNNT_VAL_ITERS_PER_EPOCH="1",
               FNNT_NUM_EPOCHS="1", nnUNet_n_proc_DA="2")
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    for k in ("raw", "preprocessed", "results"):
        os.makedirs(join(root, k))
    raw = make_synthetic_dataset(join(root, "raw"), DS, n_cases=5,
                                 shape=(10, 24, 20))
    plan_and_preprocess_entry(["-d", "988", "-c", "2d", "3d_fullres",
                               "-npfp", "1", "-np", "1"])
    pre = join(root, "preprocessed", DS)
    plans = load_json(join(pre, "nnUNetPlans.json"))
    cfg2d = plans["configurations"]["2d"]
    assert len(cfg2d["patch_size"]) == 2
    assert cfg2d["architecture"]["arch_kwargs"]["conv_op"].endswith("Conv2d")
    cfg2d["batch_size"] = 2     # keep the test tiny
    save_json(plans, join(pre, "nnUNetPlans.json"), sort_keys=False)
    for cfg in ("2d", "3d_fullres"):
        run_training_entry(["988", cfg, "0", "-device", "cpu"])
    ts = join(raw, "imagesTs")
    os.makedirs(ts)
    shutil.copy(join(raw, "imagesTr", "case_000_0000.nii.gz"),
                join(ts, "ts_000_0000.nii.gz"))
    yield root, raw
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _model(root, cfg):
    return os.path.join(root, "results", DS,
                        f"NNUNetTrainer__nnUNetPlans__{cfg}")


def test_2d_trains_and_predicts_a_3d_volume(trained, tmp_path):
    import torch
    from fast_nnunet_tpu.imageio.nifti import NiftiIO as JIO
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    from fast_nnunet_tpu_torch.run.predict import predict_entry_point
    from fast_nnunet_tpu_torch.training.checkpoint import load_checkpoint
    from fast_nnunet_tpu_torch.utils.io import join, load_json
    root, raw = trained
    fold = join(_model(root, "2d"), "fold_0")
    ckpt = load_checkpoint(join(fold, "checkpoint_final.fnnx"))
    assert ckpt["network_weights"]["params"]["decoder"]["seg_head_0"][
        "kernel"].ndim == 4                     # a 2D network's (1, 1, I, O)
    assert np.isfinite(load_json(join(fold, "validation", "summary.json"))[
        "foreground_mean"]["Dice"])
    out, out32, jout = (str(tmp_path / n) for n in ("p", "p32", "j"))
    predict_entry_point(["-i", join(raw, "imagesTs"), "-o", out, "-d", "988",
                         "-c", "2d", "-f", "0", "--disable_tta",
                         "-device", "cpu"])
    img_file = join(raw, "imagesTs", "ts_000_0000.nii.gz")
    img, iprops = JIO().read_images([img_file])
    seg, props = JIO().read_seg(join(out, "ts_000.nii.gz"))
    assert seg.shape == img.shape
    assert props["spacing"] == iprops["spacing"]
    assert set(np.unique(seg).tolist()) <= {0, 1, 2}
    tp = NNUNetPredictor(use_mirroring=False, device="cpu",
                         compute_dtype=torch.float32)
    tp.initialize_from_trained_model_folder(_model(root, "2d"),
                                            use_folds=(0,))
    tp.predict_from_files(join(raw, "imagesTs"), out32)
    jp = jax_predictor_f32(_model(root, "2d"), (0,), 1, 3)
    jp.predict_from_files(join(raw, "imagesTs"), jout)
    got, _ = JIO().read_seg(join(out32, "ts_000.nii.gz"))
    ref, _ = JIO().read_seg(join(jout, "ts_000.nii.gz"))
    np.testing.assert_array_equal(got, ref)
    data, _, _ = DefaultPreprocessor().run_case(
        [img_file], None, tp.plans_manager, tp.configuration_manager,
        tp.dataset_json)
    assert data.ndim == 4                       # a 3D volume, swept by slice
    np.testing.assert_allclose(
        tp.predict_logits_from_preprocessed_data(data),
        np.asarray(jp.predict_logits_from_preprocessed_data(data)),
        atol=3e-4)


def test_2d_plus_3d_ensemble_runs_as_find_best_writes_it(trained, tmp_path):
    """find-best's commands for the 2d and 3d_fullres members (with
    ``--save_probabilities``) into two folders, then the ensemble of the two
    folders as they are: the mask is the argmax of the mean
    probabilities."""
    import shlex
    from fast_nnunet_tpu_torch.ensembling.ensemble import ensemble_entry
    from fast_nnunet_tpu_torch.evaluation.find_best_configuration import \
        generate_inference_command
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.run.predict import predict_entry_point
    from fast_nnunet_tpu_torch.utils.io import join
    root, raw = trained
    outs = []
    for cfg in ("2d", "3d_fullres"):
        cmd = generate_inference_command(DS, cfg, folds=(0,),
                                         save_probabilities=True)
        argv = shlex.split(cmd)
        assert argv[0] == "fast_nnunet_predict_torch"
        out = str(tmp_path / cfg)
        subst = {"INPUT_FOLDER": join(raw, "imagesTs"), "OUTPUT_FOLDER": out}
        predict_entry_point([subst.get(a, a) for a in argv[1:]]
                            + ["--disable_tta", "-device", "cpu"])
        for f in ("plans.json", "dataset.json"):
            assert os.path.isfile(join(out, f))
        outs.append(out)
    ens = str(tmp_path / "ens")
    ensemble_entry(["-i", *outs, "-o", ens, "-np", "1"])
    probs = [np.load(join(o, "ts_000.npz"))["probabilities"].astype(
        np.float32) for o in outs]
    mask = NiftiIO().read_seg(join(ens, "ts_000.nii.gz"))[0][0]
    np.testing.assert_array_equal(mask, ((probs[0] + probs[1]) / 2).argmax(0))


def test_2d_sampler_batches_match_jax(trained):
    """The 2d plan's training sampler (pseudo-3D (1, *patch) crops of the
    3D cases, squeezed) with its augmenter and deep-supervision targets:
    three batches from one seed, bit-equal to the JAX package's."""
    from fast_nnunet_tpu.training import augment as jaug
    from fast_nnunet_tpu.training.dataloader import PatchSampler as JS
    from fast_nnunet_tpu.training.dataset import NpyCaseDataset as JD
    from fast_nnunet_tpu_torch.training import augment as paug
    from fast_nnunet_tpu_torch.training.dataloader import PatchSampler as PS
    from fast_nnunet_tpu_torch.training.dataset import NpyCaseDataset as PD
    from fast_nnunet_tpu_torch.utils.io import join, load_json
    root, _ = trained
    pre = join(root, "preprocessed", DS)
    cfg = load_json(join(pre, "nnUNetPlans.json"))["configurations"]["2d"]
    patch = cfg["patch_size"]
    store = join(pre, cfg["data_identifier"])
    rotation, dummy, initial, mirror = \
        jaug.configure_rotation_dummyDA_mirroring_and_initial_patch_size(
            patch)
    assert len(initial) == 2 and not dummy
    scales = [(1.0, 1.0), (0.5, 0.5)]
    kw = dict(use_mask_for_norm=[False], ds_scales=scales)
    keys = PD.get_identifiers(store)
    sj = JS(JD(store, keys), 2, initial, patch, 0.5,
            transform=jaug.TrainingAugmenter(patch, rotation, mirror, **kw))
    sp = PS(PD(store, keys), 2, initial, patch, 0.5,
            transform=paug.TrainingAugmenter(patch, rotation, mirror, **kw))
    for seed in range(3):
        bj = sj.generate_batch(np.random.RandomState(seed))
        bp = sp.generate_batch(np.random.RandomState(seed))
        assert bp["keys"] == bj["keys"]
        assert bp["data"].shape == (2, 1, *patch)
        np.testing.assert_array_equal(bp["data"], bj["data"])
        assert len(bp["target"]) == len(bj["target"]) == 2
        for a, b in zip(bp["target"], bj["target"]):
            np.testing.assert_array_equal(a, b)


def test_2d_distillation_waits(trained):
    from fast_nnunet_tpu_torch.training.distill import \
        NNUNetDistillationTrainer
    from fast_nnunet_tpu_torch.utils.io import join, load_json
    root, _ = trained
    pre = join(root, "preprocessed", DS)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NNUNetDistillationTrainer(load_json(join(pre, "nnUNetPlans.json")),
                                  "2d", 0,
                                  load_json(join(pre, "dataset.json")),
                                  device="cpu")
