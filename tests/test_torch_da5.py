"""DA5 in the port (training/augment_da5.py, ``NNUNetTrainerDA5``,
``NNUNetDistillationTrainerDA5``) against the JAX package's: the DA5
training augmenter and its condensed variant give the same samples, bit for
bit, from one ``np.random.RandomState`` (two seeds, eight draws each, with
and without regions and dummy 2D), the DA5 geometry envelope is the same;
and nnU-Net's ResEnc workflow on the CPU through the port's entry points:
``fast_nnunet_train_torch -p nnUNetResEncUNetLPlans`` (a residual-encoder
teacher), ``fast_nnunet_resenc_distill_torch --use_da5`` (a
LiteResEncStudent under DA5) and ``fast_nnunet_predict_torch`` with both."""
import os

import numpy as np
import pytest

from fast_nnunet_tpu.training import augment_da5 as jda5
from fast_nnunet_tpu_torch.training import augment_da5 as pda5

from .test_torch_train_e2e import DS, env  # noqa: F401 (fixture)
from .torch_port_common import no_persistent_compile_cache  # noqa: F401

PATCH = (16, 16, 16)
DS_SCALES = [(1.0, 1.0, 1.0), (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)]


def _case(seed, shape):
    rng = np.random.RandomState(100 + seed)
    data = rng.randn(1, *shape).astype(np.float32)
    seg = np.zeros((1, *shape), np.int8)
    for c in (1, 2):
        lo = [rng.randint(0, s - 6) for s in shape]
        seg[(0,) + tuple(slice(v, v + 5) for v in lo)] = c
    seg[0, :2] = -1
    return data, seg


@pytest.mark.parametrize("variant", ["da5", "da5_regions", "da5_dummy2d",
                                     "condensed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_da5_augmenter_bit_equal(seed, variant):
    patch = (8, 16, 16) if variant == "da5_dummy2d" else PATCH
    name = "configure_da5_rotation_dummyDA_mirroring_and_initial_patch_size"
    env_j = getattr(jda5, name)(patch)
    assert repr(getattr(pda5, name)(patch)) == repr(env_j)
    rotation, dummy, initial, mirror = env_j
    if variant == "da5_dummy2d":
        dummy = True
    kw = dict(use_mask_for_norm=[False], dummy_2d=dummy,
              regions=[1, (1, 2)] if variant == "da5_regions" else None,
              ds_scales=DS_SCALES)
    cls = "DA5CondensedAugmenter" if variant == "condensed" \
        else "DA5TrainingAugmenter"
    aug_j = getattr(jda5, cls)(patch, rotation, mirror, **kw)
    aug_p = getattr(pda5, cls)(patch, rotation, mirror, **kw)
    rng_j, rng_p = (np.random.RandomState(seed) for _ in range(2))
    for draw in range(8):
        data, seg = _case(draw, tuple(int(s) for s in initial))
        dj, tj = aug_j(data.copy(), seg.copy(), rng_j)
        dp, tp = aug_p(data.copy(), seg.copy(), rng_p)
        np.testing.assert_array_equal(dp, dj, err_msg=f"draw {draw}")
        assert len(tp) == len(tj) == len(DS_SCALES)
        for a, b in zip(tp, tj):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert rng_p.randint(1 << 30) == rng_j.randint(1 << 30)


RESENC_PLANS = "nnUNetResEncUNetLPlans"


def _write_resenc_plans():
    """The dataset's plans with the residual-encoder U-Net (a ResEnc
    preset's shape at 3 stages), over the same preprocessed cases."""
    from fast_nnunet_tpu_torch.utils.io import join, load_json, save_json
    pre = join(os.environ["nnUNet_preprocessed"], DS)
    plans = load_json(join(pre, "nnUNetPlans.json"))
    plans["plans_name"] = RESENC_PLANS
    arch = plans["configurations"]["3d_fullres"]["architecture"]
    arch["network_class_name"] = \
        "dynamic_network_architectures.architectures.unet.ResidualEncoderUNet"
    kw = arch["arch_kwargs"]
    kw["n_blocks_per_stage"] = [1, 2, 2]
    kw["n_conv_per_stage_decoder"] = [1, 1]
    kw.pop("n_conv_per_stage")
    save_json(plans, join(pre, RESENC_PLANS + ".json"))


def test_resenc_workflow_on_cpu(env, monkeypatch, tmp_path):  # noqa: F811
    from fast_nnunet_tpu_torch.run.distillation_train import \
        resenc_distillation_train_entry
    from fast_nnunet_tpu_torch.run.predict import predict_entry_point
    from fast_nnunet_tpu_torch.run.run_training import run_training_entry
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.training.checkpoint import load_checkpoint
    from fast_nnunet_tpu_torch.utils.io import isfile, join, load_json
    for k, v in (("FNNT_ITERS_PER_EPOCH", "2"),
                 ("FNNT_VAL_ITERS_PER_EPOCH", "1"),
                 ("FNNT_NUM_EPOCHS", "1"), ("nnUNet_n_proc_DA", "2")):
        monkeypatch.setenv(k, v)
    _write_resenc_plans()
    results = join(os.environ["nnUNet_results"], DS)

    run_training_entry(["995", "3d_fullres", "0", "-p", RESENC_PLANS,
                        "-device", "cpu"])
    teacher = join(results, f"NNUNetTrainer__{RESENC_PLANS}__3d_fullres")
    tw = load_checkpoint(join(teacher, "fold_0", "checkpoint_final.fnnx"))[
        "network_weights"]["params"]["encoder"]
    assert "stem" in tw and "stage_2_block_1" in tw

    resenc_distillation_train_entry([
        "-d", "995", "-spl", RESENC_PLANS, "-f", "1", "--use_da5",
        "-device", "cpu"])
    student = join(results,
                   f"NNUNetDistillationTrainerDA5__{RESENC_PLANS}__3d_fullres")
    ck = load_checkpoint(join(student, "fold_1", "checkpoint_final.fnnx"))
    assert ck["init_args"]["teacher_fold"] == [0]
    enc = ck["network_weights"]["params"]["encoder"]
    # LiteResEncStudent: features max(f // 2, 8), blocks [1, 2, 2] -> [1, 1, 1]
    assert sorted(k for k in enc if k.startswith("stage")) == [
        "stage_0_block_0", "stage_1_block_0", "stage_2_block_0"]
    assert enc["stage_2_block_0"]["conv1"]["kernel"].shape[-1] == 16
    assert isfile(join(student, "fold_1", "validation", "summary.json"))
    assert load_json(join(student, "fold_1", "debug.json"))["trainer"] == \
        "NNUNetDistillationTrainerDA5"

    images = join(os.environ["nnUNet_raw"], DS, "imagesTr")
    src = str(tmp_path / "in")
    os.makedirs(src)
    os.symlink(join(images, "case_004_0000.nii.gz"),
               join(src, "case_004_0000.nii.gz"))
    label = NiftiIO().read_seg(join(os.environ["nnUNet_raw"], DS, "labelsTr",
                                    "case_004.nii.gz"))[0][0]
    for model, fold in ((teacher, "0"), (student, "1")):
        out = str(tmp_path / os.path.basename(model))
        predict_entry_point(["-i", src, "-o", out, "-m", model, "-f", fold,
                             "--disable_tta", "-device", "cpu"])
        mask = NiftiIO().read_seg(join(out, "case_004.nii.gz"))[0][0]
        assert mask.shape == label.shape and mask.max() < 3
