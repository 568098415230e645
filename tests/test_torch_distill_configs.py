"""Distillation of the 2d and 3d_cascade_fullres configurations in the port
(training/distill.py, run/distillation_train.py) against the JAX package's,
on the CPU:
- one distillation step of a 2D student (r = 2) and two 2D teachers on
  64^2 slices (the one-pass norms at 64^2 through kernel A's plain version
  on 4-D input), and of a cascade student and teachers on the image plus
  the previous stage's one-hot channels, float32, deep supervision, two
  steps each: losses and the student's parameters within 1e-5 of the JAX
  distillation step's (tests/test_torch_train_step.py's tolerance);
- ``fast_nnunet_distill_torch -c 2d`` and ``-c 3d_cascade_fullres -device
  cpu`` end to end on a tiny planned dataset (teachers trained by
  ``NNUNetTrainer``; the cascade student reads the previous stage's
  deposits from its own trainer's lowres folder, the reference's
  ``predicted_next_stage`` convention, copied there from the teachers'
  3d_lowres);
- the predictor on both students (the 2d one 2D-over-slices, the cascade
  one with the lowres predictions as its previous stage) against the JAX
  predictor on the same checkpoints, float32 networks on both sides: equal
  masks;
- ``NNUNetDistillationTrainerDA5`` on the 2d plan transforms a sample as
  the JAX one does (both run, equal arrays), and the distillation exporter
  exports the 2d student as the JAX exporter does."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.models.factory import get_network_from_plans as jax_net
from fast_nnunet_tpu.training import distill as jdistill
from fast_nnunet_tpu.training import optimizers as jopt
from fast_nnunet_tpu.training import schedules as jsched
from fast_nnunet_tpu.training import train_step as jstep
from fast_nnunet_tpu_torch.models import factory as pfactory
from fast_nnunet_tpu_torch.models.students import build_student_arch_kwargs
from fast_nnunet_tpu_torch.models.unet import params_from_jax, params_to_jax
from fast_nnunet_tpu_torch.training import distill as pdistill
from fast_nnunet_tpu_torch.training import optimizers as popt
from fast_nnunet_tpu_torch.training import schedules as psched

from .helpers import make_synthetic_dataset
from .test_torch_2d import tree_2d
from .torch_port_common import K, no_persistent_compile_cache  # noqa: F401

TOL = 1e-5
ARCH = {
    "2d": {"n_stages": 3, "features_per_stage": [8, 16, 32],
           "kernel_sizes": [[3, 3]] * 3, "strides": [[1, 1], [2, 2], [2, 2]],
           "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [2, 2],
           "conv_op": "torch.nn.modules.conv.Conv2d",
           "nonlin": "torch.nn.LeakyReLU"},
    "3d_cascade_fullres": {
        "n_stages": 3, "features_per_stage": [8, 16, 32],
        "kernel_sizes": [[3, 3, 3]] * 3,
        "strides": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
        "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [2, 2],
        "nonlin": "torch.nn.LeakyReLU"}}
PATCH = {"2d": (64, 64), "3d_cascade_fullres": (16, 16, 16)}


def _batch(cfg, seed):
    """Channels-last JAX batch (image, and for the cascade the one-hot of a
    previous stage's labels) and its channels-first port twin."""
    rng = np.random.RandomState(seed)
    patch = PATCH[cfg]
    lab = rng.randint(0, K, (2, *patch)).astype(np.int32)
    x = rng.randn(2, *patch, 1).astype(np.float32) + lab[..., None]
    if cfg == "3d_cascade_fullres":
        prev = rng.randint(0, K, (2, *patch))
        x = np.concatenate([x] + [(prev == c)[..., None].astype(np.float32)
                                  for c in range(1, K)], -1)
    half = lab[(slice(None),) + (slice(None, None, 2),) * len(patch)]
    pt = tuple(torch.from_numpy(t.astype(np.int64)) for t in (lab, half))
    return (x, (lab, half),
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))), pt)


@pytest.mark.parametrize("cfg", ["2d", "3d_cascade_fullres"])
def test_distill_step_matches_jax(cfg):
    in_ch = 1 if cfg == "2d" else K   # the image + K - 1 one-hot channels
    arch = ARCH[cfg]
    student_arch = build_student_arch_kwargs(arch, 2)
    s_tree = tree_2d("PlainConvUNet", 3, in_ch, arch=student_arch)
    t_trees = [tree_2d("PlainConvUNet", 10 + f, in_ch, arch=arch)
               for f in range(2)]
    alpha, temp = 0.3, 3.0

    snet_j = jax_net("PlainConvUNet", student_arch, (), in_ch, K,
                     dtype=jnp.float32, norm_onepass=True)
    tnet_j = jax_net("PlainConvUNet", arch, (), in_ch, K, dtype=jnp.float32,
                     norm_onepass=True)
    opt_j = jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 10))
    state = jstep.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, s_tree), opt_j)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *t_trees)
    jdstep = jax.jit(jdistill.make_distill_train_step(
        snet_j, tnet_j, opt_j, alpha=alpha, temperature=temp, n_ds_levels=2,
        n_teachers=2, compute_dtype=jnp.float32))

    snet = params_from_jax(pfactory.get_network_from_plans(
        "PlainConvUNet", student_arch, (), in_ch, K,
        compute_dtype=torch.float32, norm_onepass=True, trainable=True),
        s_tree)
    teachers = [params_from_jax(pfactory.get_network_from_plans(
        "PlainConvUNet", arch, (), in_ch, K, compute_dtype=torch.float32,
        norm_onepass=True), t) for t in t_trees]
    assert snet.dim == len(PATCH[cfg]) and snet.input_channels == in_ch
    opt = popt.nnunet_sgd(snet.parameters(), psched.poly_lr(1e-2, 10))
    pdstep = pdistill.make_distill_train_step(
        snet, teachers, opt, alpha=alpha, temperature=temp, n_ds_levels=2)
    for s in range(2):
        x, jt, px, pt = _batch(cfg, 20 + s)
        state, jtot, jseg, jd = jdstep(state, stacked, jnp.asarray(x),
                                       tuple(map(jnp.asarray, jt)))
        ptot, pseg, pd = pdstep(px, pt)
        for a, b in ((ptot, jtot), (pseg, jseg), (pd, jd)):
            np.testing.assert_allclose(float(a), float(b), rtol=TOL,
                                       atol=1e-7)
    flat_p = jax.tree_util.tree_leaves_with_path(params_to_jax(snet))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, state.params)))
    assert len(flat_p) == len(flat_j)
    for path, v in flat_p:
        np.testing.assert_allclose(v, flat_j[path], atol=TOL, rtol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------ end to end
DS_ID = "984"
DS = "Dataset984_DistilCfg"
STUDENT = "NNUNetDistillationTrainer__nnUNetPlans__"


@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    """Plan 2d and 3d_fullres with the port, add the cascade, train the
    teachers (2d fold 0, 3d_lowres fold all, 3d_cascade_fullres fold 0; 2
    iterations, float32), then ``fast_nnunet_distill_torch -c 2d`` and
    ``-c 3d_cascade_fullres`` with one teacher fold each."""
    from fast_nnunet_tpu_torch.run.distillation_train import \
        distillation_train_entry
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import \
        plan_and_preprocess_entry
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer
    from fast_nnunet_tpu_torch.utils.io import join, load_json, save_json
    root = str(tmp_path_factory.mktemp("distill_cfgs"))
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
    plan_and_preprocess_entry(["-d", DS_ID, "-c", "2d", "3d_fullres",
                               "-npfp", "1", "-np", "1"])
    pre = join(root, "preprocessed", DS)
    plans = load_json(join(pre, "nnUNetPlans.json"))
    cfgs = plans["configurations"]
    cfgs["2d"]["batch_size"] = 2
    for c in ("2d", "3d_fullres"):
        arch = cfgs[c]["architecture"]["arch_kwargs"]
        arch["features_per_stage"] = [min(8 * 2 ** i, 32)
                                      for i in range(arch["n_stages"])]
    cfgs["3d_lowres"] = {"inherits_from": "3d_fullres",
                         "next_stage": "3d_cascade_fullres"}
    cfgs["3d_cascade_fullres"] = {"inherits_from": "3d_fullres",
                                  "previous_stage": "3d_lowres"}
    save_json(plans, join(pre, "nnUNetPlans.json"), sort_keys=False)
    dj = load_json(join(raw, "dataset.json"))
    teachers = {}
    for cfg, fold in (("2d", 0), ("3d_lowres", "all"),
                      ("3d_cascade_fullres", 0)):
        t = NNUNetTrainer(plans, cfg, fold, dj, device="cpu")
        t.num_epochs, t.num_iterations_per_epoch = 1, 2
        t.num_val_iterations_per_epoch = 1
        t.compute_dtype = torch.float32
        t.run_training()
        t.perform_actual_validation()
        teachers[cfg] = t.output_folder_base
    # the cascade student reads the previous stage's deposits from its own
    # trainer's lowres folder (the reference's convention)
    shutil.copytree(join(teachers["3d_lowres"], "predicted_next_stage"),
                    join(root, "results", DS, STUDENT + "3d_lowres",
                         "predicted_next_stage"))
    for cfg in ("2d", "3d_cascade_fullres"):
        distillation_train_entry([
            "-d", DS_ID, "-c", cfg, "-f", "0", "-t", teachers[cfg], "-tf",
            "0", "-r", "2", "-a", "0.3", "-temp", "3.0", "-device", "cpu"])
    ts = join(raw, "imagesTs")
    os.makedirs(ts)
    for i in range(2):
        shutil.copy(join(raw, "imagesTr", f"case_{i:03d}_0000.nii.gz"),
                    join(ts, f"ts_{i:03d}_0000.nii.gz"))
    yield root, raw, plans, teachers
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _student(root, cfg):
    return os.path.join(root, "results", DS, STUDENT + cfg)


def test_distill_cli_runs_2d_and_cascade(distilled):
    from fast_nnunet_tpu_torch.training.checkpoint import load_checkpoint
    from fast_nnunet_tpu_torch.utils.io import join, load_json
    root, _, plans, _ = distilled
    for cfg, in_ch, kernel_ndim in (("2d", 1, 4),
                                    ("3d_cascade_fullres", 3, 5)):
        fold = join(_student(root, cfg), "fold_0")
        ckpt = load_checkpoint(join(fold, "checkpoint_final.fnnx"))
        assert ckpt["trainer_name"] == "NNUNetDistillationTrainer"
        ia = ckpt["init_args"]
        assert (ia["configuration"], ia["teacher_fold"],
                ia["feature_reduction_factor"], ia["alpha"],
                ia["temperature"]) == (cfg, [0], 2, 0.3, 3.0)
        first = ckpt["network_weights"]["params"]["encoder"]["stage_0"][
            "block_0"]["conv"]["kernel"]
        assert first.ndim == kernel_ndim and first.shape[-2] == in_ch
        assert first.shape[-1] == 8          # max(8 // 2, 8)
        lg = ckpt["logging"]
        assert np.isfinite(lg["train_seg_losses"]).all()
        assert np.isfinite(lg["train_distill_losses"]).all()
        summary = load_json(join(fold, "validation", "summary.json"))
        assert np.isfinite(summary["foreground_mean"]["Dice"])


def _jax_student_predictor_f32(model_folder, fold=0):
    """The JAX predictor on a distilled student with the student network in
    float32 and a float32 sliding window (its own build is bfloat16),
    mirroring off."""
    from fast_nnunet_tpu.inference.predictor import NNUNetPredictor
    jp = NNUNetPredictor(use_mirroring=False)
    jp.initialize_from_trained_model_folder(model_folder, use_folds=(fold,))
    jp.manual_initialization(
        jp.network.clone(dtype=jnp.float32), jp.plans_manager,
        jp.configuration_manager, jp.list_of_parameters, jp.dataset_json,
        jp.trainer_name, jp.allowed_mirroring_axes)
    jp.engine.compute_dtype = jnp.float32
    return jp


def test_students_predict_like_jax(distilled, tmp_path):
    from fast_nnunet_tpu.imageio.nifti import NiftiIO as JIO
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor
    from fast_nnunet_tpu_torch.utils.io import join
    root, raw, _, teachers = distilled
    ts = join(raw, "imagesTs")
    low = str(tmp_path / "low")
    p = NNUNetPredictor(use_mirroring=False, device="cpu")
    p.initialize_from_trained_model_folder(teachers["3d_lowres"],
                                           use_folds=("all",))
    p.predict_from_files(ts, low)
    for cfg, prev in (("2d", None), ("3d_cascade_fullres", low)):
        tp = NNUNetPredictor(use_mirroring=False, device="cpu",
                             compute_dtype=torch.float32)
        tp.initialize_from_trained_model_folder(_student(root, cfg),
                                                use_folds=(0,))
        assert tp.network.dim == (2 if cfg == "2d" else 3)
        assert tp.network.input_channels == (1 if cfg == "2d" else 3)
        out, jout = str(tmp_path / f"p_{cfg}"), str(tmp_path / f"j_{cfg}")
        tp.predict_from_files(ts, out, folder_with_segs_from_prev_stage=prev)
        jp = _jax_student_predictor_f32(_student(root, cfg))
        jp.predict_from_files(ts, jout, folder_with_segs_from_prev_stage=prev)
        for i in range(2):
            img, iprops = JIO().read_images([join(ts,
                                                  f"ts_{i:03d}_0000.nii.gz")])
            got, props = JIO().read_seg(join(out, f"ts_{i:03d}.nii.gz"))
            ref, _ = JIO().read_seg(join(jout, f"ts_{i:03d}.nii.gz"))
            assert got.shape == img.shape
            assert props["spacing"] == iprops["spacing"]
            np.testing.assert_array_equal(got, ref, err_msg=cfg)
            assert len(np.unique(ref)) > 1


def test_da5_distillation_on_the_2d_plan_transforms_like_jax(distilled):
    import copy
    from fast_nnunet_tpu.training.distill import \
        NNUNetDistillationTrainerDA5 as JDA5
    from fast_nnunet_tpu_torch.training.distill import \
        NNUNetDistillationTrainerDA5 as PDA5
    from fast_nnunet_tpu_torch.utils.io import join, load_json
    root, raw, plans, teachers = distilled
    dj = load_json(join(raw, "dataset.json"))
    jt = JDA5(copy.deepcopy(plans), "2d", 0, dj,
              teacher_model_folder=teachers["2d"], teacher_fold=0)
    pt = PDA5(copy.deepcopy(plans), "2d", 0, dj, device="cpu",
              teacher_model_folder=teachers["2d"], teacher_fold=0)
    patch = pt.configuration_manager.patch_size
    assert len(patch) == 2
    env = pt._configure_rotation_dummyDA_mirroring_and_initial_patch_size(
        patch)
    assert repr(env) == repr(
        jt._configure_rotation_dummyDA_mirroring_and_initial_patch_size(
            patch))
    rotation, dummy_2d, initial, mirror = env
    ds = pt._get_deep_supervision_scales()
    jaug = jt._make_training_transform(patch, rotation, mirror, dummy_2d,
                                       jt.label_manager, ds)
    paug = pt._make_training_transform(patch, rotation, mirror, dummy_2d,
                                       pt.label_manager, ds)
    assert type(paug).__name__ == type(jaug).__name__ == \
        "DA5TrainingAugmenter"
    rng = np.random.RandomState(3)
    data = rng.randn(1, *initial).astype(np.float32)
    seg = rng.randint(0, 3, (1, *initial)).astype(np.int16)
    outs = []
    for aug in (jaug, paug):
        try:
            outs.append(aug(data.copy(), seg.copy(),
                            np.random.RandomState(7)))
        except Exception as e:   # noqa: BLE001 (compared below)
            outs.append(e)
    j, p = outs
    if isinstance(j, Exception) or isinstance(p, Exception):
        assert type(j) is type(p), (j, p)
    assert not isinstance(j, Exception), j    # both run on the 2d plan
    np.testing.assert_array_equal(p[0], j[0])
    assert len(p[1]) == len(j[1])
    for a, b in zip(p[1], j[1]):
        np.testing.assert_array_equal(a, b)


def test_distillation_exporter_on_the_2d_student(distilled, tmp_path):
    from fast_nnunet_tpu.export.export_model import \
        export_model_folder_to_artifact as jexport
    from fast_nnunet_tpu_torch.export.export_model import \
        export_model_folder_to_artifact
    from fast_nnunet_tpu_torch.utils.io import load_json
    root = distilled[0]
    model = _student(root, "2d")
    # float32: each exporter validates its artifact against its own
    # forward at 1e-2, which a bf16 forward of a trained net can exceed in
    # either package (one XLA compile against another)
    jexport(model, 0, str(tmp_path / "j"), batch_size=2, dtype="float32")
    stats = {}
    path = export_model_folder_to_artifact(model, 0, str(tmp_path / "p"),
                                           batch_size=2, dtype="float32",
                                           device="cpu", stats=stats)
    assert os.path.isfile(path) and stats["max_rel"] <= 1e-2
    meta = load_json(str(tmp_path / "p" / "model_config.json"))
    jmeta = load_json(str(tmp_path / "j" / "model_config.json"))
    assert meta["configuration"] == jmeta["configuration"] == "2d"
    assert meta["patch_size"] == jmeta["patch_size"]
    assert len(meta["patch_size"]) == 2
