"""The port's NNUNetPredictor file path on the committed golden checkpoint
(tests/fixtures/golden_ckpt/, a trained 3d_fullres PlainConvUNet): array,
sweep, file and CLI routes reproduce the frozen mask bit for bit, on the CPU,
as tests/test_golden_checkpoint.py pins it for the JAX package. The copied
host stages (preprocess, export) and the logits are held against the JAX
package on the same input."""
import os
import shutil

import numpy as np
import pytest
import torch

from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
from fast_nnunet_tpu_torch.inference.export import \
    convert_predicted_logits_to_segmentation_with_correct_shape
from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor
from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
    DefaultPreprocessor
from fast_nnunet_tpu_torch.run.predict import predict_entry_point

from .torch_port_common import (GOLDEN,  # noqa: F401  (fixture)
                                no_persistent_compile_cache)

MODEL = os.path.join(GOLDEN, "model")
INPUT = os.path.join(GOLDEN, "input_0000.nii.gz")
EXPECTED = os.path.join(GOLDEN, "expected_mask.nii.gz")


@pytest.fixture(scope="module")
def expected_mask():
    return NiftiIO().read_seg(EXPECTED)[0][0].astype(np.uint8)


@pytest.fixture(scope="module")
def predictor():
    """Fold 0, no mirroring, bf16 network (as the JAX predictor builds it),
    on the CPU."""
    p = NNUNetPredictor(use_mirroring=False, device="cpu")
    p.initialize_from_trained_model_folder(MODEL, use_folds=[0])
    return p


def _case_folder(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    shutil.copy(INPUT, src / "case_0000.nii.gz")
    return str(src)


def test_predict_single_npy_array_reproduces_golden_mask(predictor,
                                                         expected_mask):
    data, props = NiftiIO().read_images([INPUT])
    seg = predictor.predict_single_npy_array(data, props)
    np.testing.assert_array_equal(seg.astype(np.uint8), expected_mask)


def test_sweep_route_reproduces_golden_mask(predictor, expected_mask):
    """The rolling sweep (f32 accumulator) through the same export as the
    logits path, via one-hot 'logits' of its label map."""
    data, props = NiftiIO().read_images([INPUT])
    pre, _, pre_props = DefaultPreprocessor().run_case_npy(
        data, None, dict(props), predictor.plans_manager,
        predictor.configuration_manager, predictor.dataset_json)
    eng = predictor.engine
    old = eng.sweep_acc_dtype
    eng.sweep_acc_dtype = torch.float32
    try:
        seg_res = eng.predict_segmentation_sweep(
            predictor.list_of_parameters, pre)
    finally:
        eng.sweep_acc_dtype = old
    onehot = np.eye(predictor.label_manager.num_segmentation_heads,
                    dtype=np.float32)[seg_res].transpose(3, 0, 1, 2)
    seg = convert_predicted_logits_to_segmentation_with_correct_shape(
        onehot, predictor.plans_manager, predictor.configuration_manager,
        predictor.label_manager, dict(pre_props))
    np.testing.assert_array_equal(seg.astype(np.uint8), expected_mask)


def test_predict_from_files_writes_golden_mask(predictor, expected_mask,
                                               tmp_path):
    out = str(tmp_path / "out")
    predictor.predict_from_files(_case_folder(tmp_path), out,
                                 num_processes_segmentation_export=1)
    got = NiftiIO().read_seg(os.path.join(out, "case.nii.gz"))[0][0]
    np.testing.assert_array_equal(got.astype(np.uint8), expected_mask)
    assert os.path.isfile(os.path.join(out,
                                       "predict_from_raw_data_args.json"))


def test_cli_writes_golden_mask(expected_mask, tmp_path):
    out = str(tmp_path / "cli")
    predict_entry_point(["-i", _case_folder(tmp_path), "-o", out, "-m",
                         MODEL, "-f", "0", "--disable_tta", "-device",
                         "cpu"])
    got = NiftiIO().read_seg(os.path.join(out, "case.nii.gz"))[0][0]
    np.testing.assert_array_equal(got.astype(np.uint8), expected_mask)


def test_host_stages_and_logits_match_jax(predictor):
    """Preprocessing (transpose, crop, CT normalization, resampling) and the
    export's geometry revert equal the JAX package's; with float32 networks
    on both sides and mirror TTA on, the predictors' logits agree within
    atol 3e-4 (the plain-net tolerance; the trained net's logits reach
    O(20), so f32 summation order shows at ~1e-4)."""
    import jax.numpy as jnp
    from fast_nnunet_tpu.inference import export as jexport
    from fast_nnunet_tpu.inference.predictor import \
        NNUNetPredictor as JaxPredictor
    from fast_nnunet_tpu.models.factory import build_network_from_arch_dict
    from fast_nnunet_tpu.preprocessing.preprocessor import \
        DefaultPreprocessor as JaxPre
    jp = JaxPredictor()
    jp.initialize_from_trained_model_folder(MODEL, use_folds=[0])
    arch = jp.configuration_manager.configuration["architecture"]
    jp.manual_initialization(
        build_network_from_arch_dict(arch, 1, 3, dtype=jnp.float32),
        jp.plans_manager, jp.configuration_manager, jp.list_of_parameters,
        jp.dataset_json, jp.trainer_name, jp.allowed_mirroring_axes)
    jp.engine.compute_dtype = jnp.float32
    tp = NNUNetPredictor(device="cpu", compute_dtype=torch.float32)
    tp.initialize_from_trained_model_folder(MODEL, use_folds=[0])
    assert tp.engine.mirror_axes == jp.engine.mirror_axes != ()

    data, props = NiftiIO().read_images([INPUT])
    pre, seg, pp = DefaultPreprocessor().run_case_npy(
        data, None, dict(props), tp.plans_manager, tp.configuration_manager,
        tp.dataset_json)
    jpre, jseg, jpp = JaxPre().run_case_npy(
        data, None, dict(props), jp.plans_manager, jp.configuration_manager,
        jp.dataset_json)
    np.testing.assert_array_equal(pre, jpre)
    np.testing.assert_array_equal(seg, jseg)
    for key in ("shape_before_cropping", "bbox_used_for_cropping",
                "shape_after_cropping_and_before_resampling"):
        assert np.array_equal(pp[key], jpp[key]), key
    logits = tp.predict_logits_from_preprocessed_data(pre)
    jlogits = np.asarray(jp.predict_logits_from_preprocessed_data(jpre))
    assert logits.shape == jlogits.shape and logits.dtype == np.float32
    np.testing.assert_allclose(logits, jlogits, atol=3e-4)
    for probs in (False, True):
        got = convert_predicted_logits_to_segmentation_with_correct_shape(
            jlogits, tp.plans_manager, tp.configuration_manager,
            tp.label_manager, dict(pp), return_probabilities=probs)
        ref = jexport.convert_predicted_logits_to_segmentation_with_correct_shape(
            jlogits, jp.plans_manager, jp.configuration_manager,
            jp.label_manager, dict(jpp), return_probabilities=probs)
        for g, r in zip(got if probs else [got], ref if probs else [ref]):
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


def test_not_ported_inputs_raise(predictor, tmp_path):
    """A checkpoint whose init_args carry ``primus_arch`` is rebuilt as that
    Primus (the plans' patch, the checkpoint's dims) and predicts a mask of
    the input's shape, while a CNN tree given to it raises; a previous
    stage's segmentation given to a configuration that is not a cascade
    stage, or missing for one that is, raises ValueError (the cascade stage
    itself is rebuilt with 1 + K - 1 input channels); with no card, the
    default device raises instead of falling back."""
    import json
    import pickle
    from fast_nnunet_tpu_torch.models.primus import Primus, init_primus_
    from fast_nnunet_tpu_torch.models.unet import params_to_jax
    from fast_nnunet_tpu_torch.training.checkpoint import load_checkpoint
    data, props = NiftiIO().read_images([INPUT])
    with pytest.raises(ValueError, match="previous stage"):
        predictor.predict_single_npy_array(data, props,
                                           segmentation_previous_stage=data)
    model = tmp_path / "model"
    shutil.copytree(MODEL, model)
    ckpt_path = model / "fold_0" / "checkpoint_final.fnnx"
    ckpt = load_checkpoint(str(ckpt_path))
    arch = {"embed_dim": 96, "depth": 2, "num_heads": 3,
            "patch_embed_size": [8, 8, 8]}
    k = predictor.label_manager.num_segmentation_heads
    net = init_primus_(Primus(1, 96, (8, 8, 8), k, 2, 3, (16, 16, 16)), 3)
    for weights in (ckpt["network_weights"], params_to_jax(net)):
        with open(ckpt_path, "wb") as f:
            pickle.dump(dict(ckpt, network_weights=weights, init_args=dict(
                ckpt["init_args"], primus_arch=arch)), f)
        p = NNUNetPredictor(device="cpu", use_mirroring=False)
        p.initialize_from_trained_model_folder(str(model), use_folds=[0])
        assert isinstance(p.network, Primus)
        assert (p.network.embed_dim, p.network.depth, p.network.num_heads,
                p.network.patch_size) == (96, 2, 3, (16, 16, 16))
        if weights is ckpt["network_weights"]:    # the golden CNN's tree
            with pytest.raises(ValueError, match="tree and module differ"):
                p.predict_single_npy_array(data, props)
    seg = p.predict_single_npy_array(data, props)
    assert seg.shape == data.shape[1:] and seg.max() < k
    plans = json.loads((model / "plans.json").read_text())
    plans["configurations"]["3d_fullres"]["previous_stage"] = "3d_lowres"
    (model / "plans.json").write_text(json.dumps(plans))
    with open(ckpt_path, "wb") as f:
        pickle.dump(ckpt, f)
    p.initialize_from_trained_model_folder(str(model), use_folds=[0])
    assert p.network.input_channels == p.label_manager.num_segmentation_heads
    with pytest.raises(ValueError, match="previous stage"):  # cascade stage
        p.predict_single_npy_array(data, props)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the card is the default device
            NNUNetPredictor()
