"""End to end on the CPU: the port's ``run_training`` and the
``fast_nnunet_distill_torch`` entry on a synthetic NIfTI dataset
(tests/helpers.make_synthetic_dataset) preprocessed by the port's
``DefaultPreprocessor.run_case``, a 3-stage [8, 16, 32] net, 16^3
patches. Checks that the trainer writes checkpoint_final.fnnx, debug.json
and validation/summary.json, that the JAX package reads the final
checkpoint, that a resumed trainer keeps the momentum, and that the entry
points default to the card."""
import os

import numpy as np
import pytest
import torch

from .helpers import make_synthetic_dataset
from .torch_port_common import no_persistent_compile_cache  # noqa: F401

DS = "Dataset995_Synth"
ARCH = {
    "network_class_name":
        "dynamic_network_architectures.architectures.unet.PlainConvUNet",
    "arch_kwargs": {
        "n_stages": 3, "features_per_stage": [8, 16, 32],
        "conv_op": "torch.nn.modules.conv.Conv3d",
        "kernel_sizes": [[3, 3, 3]] * 3,
        "strides": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
        "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [2, 2],
        "conv_bias": True,
        "norm_op": "torch.nn.modules.instancenorm.InstanceNorm3d",
        "norm_op_kwargs": {"eps": 1e-5, "affine": True},
        "dropout_op": None, "dropout_op_kwargs": None,
        "nonlin": "torch.nn.LeakyReLU", "nonlin_kwargs": {"inplace": True}},
    "_kw_requires_import": ["conv_op", "norm_op", "dropout_op", "nonlin"],
}


def _plans(spacing):
    rs = "resample_data_or_seg_to_shape"
    return {
        "dataset_name": DS, "plans_name": "nnUNetPlans",
        "image_reader_writer": "NiftiIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel": {},
        "configurations": {"3d_fullres": {
            "data_identifier": "nnUNetPlans_3d_fullres", "batch_size": 2,
            "patch_size": [16, 16, 16], "spacing": list(spacing),
            "normalization_schemes": ["ZScoreNormalization"],
            "use_mask_for_norm": [False],
            "resampling_fn_data": rs,
            "resampling_fn_data_kwargs": {"is_seg": False, "order": 3},
            "resampling_fn_seg": rs,
            "resampling_fn_seg_kwargs": {"is_seg": True, "order": 1},
            "resampling_fn_probabilities": rs,
            "resampling_fn_probabilities_kwargs": {"is_seg": False,
                                                   "order": 1},
            "architecture": ARCH, "batch_dice": False}}}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """nnUNet_raw / preprocessed / results under a temporary root, with the
    synthetic dataset preprocessed into the .npy store."""
    from fast_nnunet_tpu_torch.core.plans import PlansManager
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    from fast_nnunet_tpu_torch.training.dataset import NpyCaseDataset
    from fast_nnunet_tpu_torch.utils.io import join, load_json, save_json

    root = str(tmp_path_factory.mktemp("train_e2e"))
    paths = {k: join(root, k) for k in ("raw", "preprocessed", "results")}
    for p in paths.values():
        os.makedirs(p)
    old = {k: os.environ.get(k) for k in
           ("nnUNet_raw", "nnUNet_preprocessed", "nnUNet_results")}
    os.environ["nnUNet_raw"] = paths["raw"]
    os.environ["nnUNet_preprocessed"] = paths["preprocessed"]
    os.environ["nnUNet_results"] = paths["results"]

    raw = make_synthetic_dataset(paths["raw"], DS, n_cases=5,
                                 shape=(20, 22, 18))
    dataset_json = load_json(join(raw, "dataset.json"))
    pre = join(paths["preprocessed"], DS)
    os.makedirs(join(pre, "nnUNetPlans_3d_fullres"))
    rw = None
    plans = None
    for i in range(5):
        case = f"case_{i:03d}"
        imgs = [join(raw, "imagesTr", f"{case}_0000.nii.gz")]
        if plans is None:
            from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
            rw = NiftiIO()
            plans = _plans(rw.read_images(imgs)[1]["spacing"])
            save_json(plans, join(pre, "nnUNetPlans.json"))
            save_json(dataset_json, join(pre, "dataset.json"))
        pm = PlansManager(plans)
        data, seg, props = DefaultPreprocessor().run_case(
            imgs, join(raw, "labelsTr", f"{case}.nii.gz"), pm,
            pm.get_configuration("3d_fullres"), dataset_json)
        NpyCaseDataset.save_case(data, seg, props,
                                 join(pre, "nnUNetPlans_3d_fullres", case))
    yield paths
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture
def short(monkeypatch):
    monkeypatch.setenv("FNNT_ITERS_PER_EPOCH", "3")
    monkeypatch.setenv("FNNT_VAL_ITERS_PER_EPOCH", "2")
    monkeypatch.setenv("FNNT_NUM_EPOCHS", "2")
    monkeypatch.setenv("nnUNet_n_proc_DA", "2")


@pytest.fixture(scope="module")
def trained(env):
    """One short training run through run_training (module-scoped: the
    tests below read its results folder)."""
    mp = pytest.MonkeyPatch()
    for k, v in (("FNNT_ITERS_PER_EPOCH", "3"),
                 ("FNNT_VAL_ITERS_PER_EPOCH", "2"),
                 ("FNNT_NUM_EPOCHS", "2"), ("nnUNet_n_proc_DA", "2")):
        mp.setenv(k, v)
    from fast_nnunet_tpu_torch.run.run_training import run_training
    try:
        trainer = run_training(DS, "3d_fullres", 0, device="cpu")
    finally:
        mp.undo()
    return trainer


def test_run_training_writes_checkpoint_and_summary(trained):
    from fast_nnunet_tpu_torch.utils.io import isfile, join, load_json
    out = trained.output_folder
    for f in ("checkpoint_final.fnnx", "checkpoint_best.fnnx", "debug.json",
              join("validation", "summary.json")):
        assert isfile(join(out, f)), f
    assert not isfile(join(out, "checkpoint_latest.fnnx"))
    assert isfile(join(trained.output_folder_base, "plans.json"))
    losses = trained.logger.logging["train_losses"]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    summary = load_json(join(out, "validation", "summary.json"))
    assert set(summary["mean"]) == {"1", "2"}
    debug = load_json(join(out, "debug.json"))
    assert debug["torch"] == torch.__version__ and debug["device"] == "cpu"
    assert debug["remat"] is False     # 2 x 16^3 voxels: under the rule
    assert isfile(join(trained.preprocessed_dataset_folder_base,
                       "splits_final.json"))


def test_jax_reads_trainer_checkpoint(trained):
    """The JAX trainer's restore path on the port's final checkpoint."""
    import jax
    import jax.numpy as jnp
    from fast_nnunet_tpu.training import checkpoint as jckpt
    from fast_nnunet_tpu.training.optimizers import nnunet_sgd
    from fast_nnunet_tpu.training.schedules import poly_lr_jax
    from fast_nnunet_tpu_torch.models.s2d import random_plain_params
    from fast_nnunet_tpu_torch.models.unet import params_to_jax
    from fast_nnunet_tpu_torch.utils.io import join

    ckpt = jckpt.load_checkpoint(join(trained.output_folder,
                                      "checkpoint_final.fnnx"))
    # the flax tree of a 3-class PlainConvUNet (the layout flax init gives)
    template = jax.tree_util.tree_map(jnp.asarray, random_plain_params(
        ARCH["arch_kwargs"], 1, 3, seed=0))
    params = jckpt.restore_params(template, ckpt["network_weights"])
    opt_state = jckpt.restore_params(
        nnunet_sgd(poly_lr_jax(1e-2, 6)).init(template),
        ckpt["optimizer_state"])
    assert int(opt_state[3].count) == 6 == ckpt["train_step"]
    assert ckpt["trainer_name"] == "NNUNetTrainer"
    assert ckpt["current_epoch"] == 2
    mine = params_to_jax(trained.network)
    for path, v in jax.tree_util.tree_leaves_with_path(params):
        want = mine
        for k in path:
            want = want[k.key]
        np.testing.assert_array_equal(np.asarray(v), want)


def test_resume_keeps_momentum(trained, short):
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer
    from fast_nnunet_tpu_torch.utils.io import join
    t2 = NNUNetTrainer(trained.plans_manager.plans, "3d_fullres", 0,
                       trained.dataset_json, device="cpu")
    t2.load_checkpoint(join(trained.output_folder, "checkpoint_final.fnnx"))
    assert t2.current_epoch == 2 and t2.optimizer.count == 6
    assert t2._best_ema == trained._best_ema
    for p_a, p_b in zip(trained.network.parameters(),
                        t2.network.parameters()):
        torch.testing.assert_close(p_a, p_b, rtol=0, atol=0)
        torch.testing.assert_close(
            trained.optimizer.inner.state[p_a]["momentum_buffer"],
            t2.optimizer.inner.state[p_b]["momentum_buffer"], rtol=0, atol=0)


def test_distill_cli_end_to_end(trained, short, tmp_path):
    """fast_nnunet_distill_torch on two teacher folds (copies of the
    trained teacher), r = 2, on the CPU."""
    import shutil
    from fast_nnunet_tpu_torch.run.distillation_train import \
        distillation_train_entry
    from fast_nnunet_tpu_torch.utils.io import isfile, join, load_json
    teacher = str(tmp_path / "teacher")
    shutil.copytree(trained.output_folder_base, teacher)
    shutil.copytree(join(teacher, "fold_0"), join(teacher, "fold_3"))
    distillation_train_entry(["-d", "995", "-t", teacher, "-f", "1",
                              "-device", "cpu"])
    out = join(os.environ["nnUNet_results"], DS,
               "NNUNetDistillationTrainer__nnUNetPlans__3d_fullres",
               "fold_1")
    assert isfile(join(out, "checkpoint_final.fnnx"))
    assert isfile(join(out, "validation", "summary.json"))
    from fast_nnunet_tpu_torch.training.checkpoint import load_checkpoint
    ckpt = load_checkpoint(join(out, "checkpoint_final.fnnx"))
    assert ckpt["init_args"]["teacher_fold"] == [0, 3]
    k = ckpt["network_weights"]["params"]["encoder"]["stage_0"]["block_0"][
        "conv"]["kernel"]
    assert k.shape == (3, 3, 3, 1, 8)   # max(8 // 2, 8) student features
    logs = ckpt["logging"]
    assert len(logs["train_distill_losses"]) == 2
    assert np.all(np.isfinite(logs["train_seg_losses"]))
    assert load_json(join(out, "debug.json"))["trainer"] == \
        "NNUNetDistillationTrainer"


def test_entry_points_default_to_the_card(env, short):
    from fast_nnunet_tpu_torch.run.run_training import (find_trainer_class,
                                                        run_training_entry)
    from fast_nnunet_tpu_torch.training.distill import \
        NNUNetDistillationTrainer
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer
    assert find_trainer_class("nnUNetTrainer") is NNUNetTrainer
    assert find_trainer_class("nnUNetDistillationTrainer") is \
        NNUNetDistillationTrainer
    assert find_trainer_class("nnUNetTrainerDA5").__name__ == \
        "NNUNetTrainerDA5"
    with pytest.raises(NotImplementedError):
        find_trainer_class("nnUNetTrainerDoesNotExist")
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default is taken")
    from fast_nnunet_tpu_torch.run.distillation_train import \
        run_distillation_training
    from fast_nnunet_tpu_torch.utils.io import join, load_json
    pre = join(os.environ["nnUNet_preprocessed"], DS)
    plans = load_json(join(pre, "nnUNetPlans.json"))
    dataset_json = load_json(join(pre, "dataset.json"))
    for cls in (NNUNetTrainer, NNUNetDistillationTrainer):
        with pytest.raises(RuntimeError, match="cuda"):
            cls(plans, "3d_fullres", 0, dataset_json)
    with pytest.raises(RuntimeError, match="cuda"):
        run_training_entry([DS, "3d_fullres", "0"])
    with pytest.raises(RuntimeError, match="cuda"):
        run_distillation_training(DS, teacher_folder=pre, teacher_folds=[0])
    from fast_nnunet_tpu_torch.run.distillation_train import \
        resenc_distillation_train_entry
    with pytest.raises(RuntimeError, match="cuda"):
        resenc_distillation_train_entry(["-d", DS, "-t", pre, "-tf", "0"])
    # -num_gpus spawns one rank per card: without a card it raises too
    with pytest.raises(RuntimeError, match="cuda"):
        run_training_entry([DS, "3d_fullres", "0", "-num_gpus", "2"])
