"""nnU-Net's whole workflow through the port's entry points on the CPU, and
the planned (anisotropic) topology held against the JAX trainer.

- The planner's kernels (1, 3, 3) and strides (1, 2, 2) / (2, 1, 1) in the
  port's train and validation steps against the JAX package's jitted steps
  on the same seeded weights and batch (float32, one-pass InstanceNorm,
  deep supervision; with and without remat): loss, parameters and tp/fp/fn
  within 1e-5, as tests/test_torch_train_step.py holds the isotropic net.
- Deep supervision's targets for those strides equal the JAX augmenter's,
  and both trainers pick the same scales and remat for chip_smoke.py's
  planned teacher.
- End to end (chip_smoke.py phase 11 at a small size): a raw CT dataset ->
  ``fast_nnunet_plan_and_preprocess_torch`` -> 2 training iterations of the
  planned topology (features cut to 4-16) -> validation with probabilities
  -> ``fast_nnunet_find_best_configuration_torch -f 0`` -> predict twice
  (mirror TTA on and off) -> ensemble -> postprocess -> evaluate."""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fast_nnunet_tpu.models.factory import get_network_from_plans as jax_net
from fast_nnunet_tpu.training import augment as jaug
from fast_nnunet_tpu.training import optimizers as jopt
from fast_nnunet_tpu.training import schedules as jsched
from fast_nnunet_tpu.training import train_step as jstep
from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
from fast_nnunet_tpu_torch.models.s2d import random_plain_params
from fast_nnunet_tpu_torch.models.unet import params_from_jax, params_to_jax
from fast_nnunet_tpu_torch.training import augment as paug
from fast_nnunet_tpu_torch.training import optimizers as popt
from fast_nnunet_tpu_torch.training import schedules as psched
from fast_nnunet_tpu_torch.training import train_step as pstep

from .test_torch_train_step import _assert_trees_close, _jax_tree
from .torch_port_common import no_persistent_compile_cache  # noqa: F401

K = 3
TOL = 1e-5
ANISO = {
    # the planner's first stages for 3 mm slices: in-plane pooling first
    "z_late": {"n_stages": 3, "features_per_stage": [4, 8, 16],
               "kernel_sizes": [[1, 3, 3], [3, 3, 3], [3, 3, 3]],
               "strides": [[1, 1, 1], [1, 2, 2], [2, 2, 2]],
               "n_conv_per_stage": [2, 2, 2],
               "n_conv_per_stage_decoder": [2, 2]},
    # chip_smoke.py's planned teacher ends with a (2, 1, 1) stride
    "z_last": {"n_stages": 3, "features_per_stage": [4, 8, 8],
               "kernel_sizes": [[1, 3, 3], [3, 3, 3], [3, 3, 3]],
               "strides": [[1, 1, 1], [1, 2, 2], [2, 1, 1]],
               "n_conv_per_stage": [2, 2, 2],
               "n_conv_per_stage_decoder": [2, 2]},
}
PATCH = (8, 16, 16)


def _ds_scales(strides):
    return [list(s) for s in
            1 / np.cumprod(np.vstack(strides), axis=0)][:-1]


def _batch(seed, arch):
    """A channels-last JAX batch with deep-supervision targets made by the
    JAX augmenter's downsampling, and its NCDHW port twin."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *PATCH, 1).astype(np.float32)
    lab = rng.randint(0, K, (2, 1, *PATCH)).astype(np.int32)
    lab[:, :, 2:6, 4:12, 4:12] = 1
    x[..., 0] += lab[:, 0]
    scales = _ds_scales(arch["strides"])
    jt = tuple(np.stack([jaug.downsample_seg_for_ds(lab[b], scales)[i][0]
                         for b in range(2)]) for i in range(len(scales)))
    pt = tuple(torch.from_numpy(t.astype(np.int64)) for t in jt)
    return x, jt, torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, -1, 1))), pt


@pytest.mark.parametrize("name, remat", [("z_late", False),
                                         ("z_last", True)])
def test_planned_topology_train_step_matches_jax(name, remat):
    arch = ANISO[name]
    tree = random_plain_params(arch, 1, K, seed=11)
    n_ds = len(_ds_scales(arch["strides"]))
    jnet = jax_net("PlainConvUNet", arch, (), 1, K, dtype=jnp.float32,
                   norm_onepass=True, remat=remat)
    opt_j = jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 10))
    state = jstep.create_train_state(_jax_tree(tree), opt_j)
    jtrain = jax.jit(jstep.make_train_step(jnet, opt_j, n_ds_levels=n_ds,
                                           compute_dtype=jnp.float32))
    jval = jax.jit(jstep.make_val_step(jnet, num_heads=K, n_ds_levels=n_ds,
                                       compute_dtype=jnp.float32))
    net = params_from_jax(get_network_from_plans(
        "PlainConvUNet", arch, (), 1, K, compute_dtype=torch.float32,
        norm_onepass=True, trainable=True, remat=remat), tree)
    opt = popt.nnunet_sgd(net.parameters(), psched.poly_lr(1e-2, 10))
    ptrain = pstep.make_train_step(net, opt, n_ds_levels=n_ds)
    pval = pstep.make_val_step(net, num_heads=K, n_ds_levels=n_ds)
    for s in range(2):
        x, jt, px, pt = _batch(s, arch)
        state, jloss = jtrain(state, jnp.asarray(x),
                              tuple(map(jnp.asarray, jt)))
        np.testing.assert_allclose(float(ptrain(px, pt)), float(jloss),
                                   rtol=TOL)
    _assert_trees_close(params_to_jax(net), state.params)
    x, jt, px, pt = _batch(5, arch)
    jl, jtp, jfp, jfn = jval(state.params, jnp.asarray(x),
                             tuple(map(jnp.asarray, jt)))
    pl, ptp, pfp, pfn = pval(px, pt)
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL)
    for a, b in ((ptp, jtp), (pfp, jfp), (pfn, jfn)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


def test_planned_teacher_targets_scales_and_remat_match_jax():
    from fast_nnunet_tpu.training.trainer import NNUNetTrainer as JT
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer as PT
    cfg = chip_smoke.PIPELINE_3D_FULLRES
    stub = types.SimpleNamespace(
        enable_deep_supervision=True,
        configuration_manager=types.SimpleNamespace(
            pool_op_kernel_sizes=cfg["strides"],
            batch_size=cfg["batch_size"], patch_size=cfg["patch_size"]))
    scales = PT._get_deep_supervision_scales(stub)
    assert np.array_equal(scales, JT._get_deep_supervision_scales(stub))
    assert [list(s) for s in scales[:3]] == [[1, 1, 1], [1, .5, .5],
                                             [.5, .25, .25]]
    assert PT._use_remat(stub) is True
    assert PT._use_remat(stub) == JT._use_remat(stub)
    seg = np.random.RandomState(0).randint(0, 61, (1, 40, 24, 24)).astype(
        np.int8)
    got = paug.downsample_seg_for_ds(seg, scales)
    assert [t.shape[1:] for t in got] == [(40, 24, 24), (40, 12, 12),
                                          (20, 6, 6), (10, 3, 3), (5, 2, 2)]
    for a, b in zip(got, jaug.downsample_seg_for_ds(seg, scales)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture()
def nnunet_env(tmp_path, monkeypatch):
    for k in ("raw", "preprocessed", "results"):
        os.makedirs(tmp_path / k)
        monkeypatch.setenv(f"nnUNet_{k}", str(tmp_path / k))
    monkeypatch.setenv("FNNT_ITERS_PER_EPOCH", "2")
    monkeypatch.setenv("FNNT_VAL_ITERS_PER_EPOCH", "1")
    monkeypatch.setenv("FNNT_NUM_EPOCHS", "1")
    monkeypatch.setenv("nnUNet_n_proc_DA", "2")
    return tmp_path


def test_pipeline_end_to_end_on_cpu(nnunet_env):
    from fast_nnunet_tpu_torch.ensembling.ensemble import ensemble_entry
    from fast_nnunet_tpu_torch.evaluation.find_best_configuration import \
        find_best_configuration_entry
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.postprocessing.connected_components import \
        apply_postprocessing
    from fast_nnunet_tpu_torch.run.evaluate import (apply_postprocessing_entry,
                                                    evaluate_simple_entry)
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import \
        plan_and_preprocess_entry
    from fast_nnunet_tpu_torch.run.predict import predict_entry_point
    from fast_nnunet_tpu_torch.run.run_training import run_training_entry
    from fast_nnunet_tpu_torch.utils.io import join, load_json, save_json

    root = str(nnunet_env)
    ds = "Dataset989_TinyCT"
    raw = chip_smoke.write_raw_ct_dataset(join(root, "raw"), dataset=ds,
                                          shape=(12, 32, 32),
                                          spacing=(3.0, 1.0, 1.0),
                                          n_classes=K, seed=2)
    plan_and_preprocess_entry(["-d", "989", "-c", "3d_fullres", "-npfp", "1",
                               "-np", "1", "--verify_dataset_integrity"])
    pre = join(root, "preprocessed", ds)
    plans = load_json(join(pre, "nnUNetPlans.json"))
    arch = plans["configurations"]["3d_fullres"]["architecture"][
        "arch_kwargs"]
    assert arch["kernel_sizes"][0] == [1, 3, 3]
    assert [1, 2, 2] in arch["strides"]
    n = arch["n_stages"]
    arch["features_per_stage"] = [min(4 * 2 ** i, 16) for i in range(n)]
    save_json(plans, join(pre, "nnUNetPlans.json"), sort_keys=False)

    run_training_entry(["989", "3d_fullres", "0", "--npz", "-device", "cpu"])
    model = join(root, "results", ds, "NNUNetTrainer__nnUNetPlans__3d_fullres")
    val = join(model, "fold_0", "validation")
    assert len([f for f in os.listdir(val) if f.endswith(".npz")]) == 1

    find_best_configuration_entry(["989", "-c", "3d_fullres", "-f", "0",
                                   "-np", "1"])
    cv = join(root, "results", ds, "crossval_results_folds_0",
              "NNUNetTrainer__nnUNetPlans__3d_fullres")
    summary = load_json(join(cv, "summary.json"))
    dice = [summary["foreground_mean"]["Dice"]] + [
        m["Dice"] for m in summary["mean"].values()]
    assert all(np.isfinite(dice)), dice
    pp = load_json(join(cv, "postprocessing.json"))
    info = load_json(join(root, "results", ds, "inference_information.json"))
    assert info["best_model_or_ensemble"]["postprocessing_fns"] == \
        pp["pp_fns"]
    assert "fast_nnunet_predict_torch" in open(join(
        root, "results", ds, "inference_report.md")).read()

    outs = []
    for tta in ([], ["--disable_tta"]):
        out = join(root, f"pred{len(tta)}")
        predict_entry_point(["-i", join(raw, "imagesTs"), "-o", out, "-d",
                             ds, "-c", "3d_fullres", "-f", "0",
                             "--save_probabilities", "-device", "cpu"] + tta)
        outs.append(out)
    ens = join(root, "ensemble")
    ensemble_entry(["-i", *outs, "-o", ens, "-np", "1"])
    probs = [np.load(join(o, "case_005.npz"))["probabilities"].astype(
        np.float32) for o in outs]
    mask = NiftiIO().read_seg(join(ens, "case_005.nii.gz"))[0][0]
    np.testing.assert_array_equal(mask, ((probs[0] + probs[1]) / 2).argmax(0))

    pp_out = join(root, "ensemble_pp")
    apply_postprocessing_entry(["-i", ens, "-o", pp_out, "-pp_json",
                                join(cv, "postprocessing.json"), "-djfile",
                                join(model, "dataset.json"), "-pfile",
                                join(model, "plans.json"), "-np", "1"])
    np.testing.assert_array_equal(
        NiftiIO().read_seg(join(pp_out, "case_005.nii.gz"))[0][0],
        apply_postprocessing(mask, pp["pp_fns"], pp["pp_fn_kwargs"]))
    evaluate_simple_entry([join(raw, "labelsTs"), pp_out, "-l", "1", "2",
                           "-np", "1"])
    test_dice = load_json(join(pp_out, "summary.json"))["foreground_mean"][
        "Dice"]
    assert np.isfinite(test_dice)
    json.dumps(info)  # the instructions are plain JSON
