"""The port's s2d sweep and TurboPipeline against the JAX package on CPU
(fp32, kernels through their plain versions): mask agreement >= 0.999 with
the JAX sweep and the JAX device-preprocess turbo route, air skipping
confined to air, resize parity with jax.image.resize, and the golden trained
model end to end through from_model_folder + predict_file."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.inference.engine import SlidingWindowEngine as JaxEngine
from fast_nnunet_tpu.inference.turbo import TurboConfig as JaxConfig
from fast_nnunet_tpu.inference.turbo import TurboPipeline as JaxPipeline
from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
from fast_nnunet_tpu_torch.inference.turbo import (TurboConfig, TurboPipeline,
                                                   air_flags, resize_nearest,
                                                   resize_trilinear)

from .torch_port_common import (K, PATCH,  # noqa: F401  (fixture)
                                no_persistent_compile_cache, s2d_pair)

CFG = dict(patch_size=(16, 8, 8), target_spacing=(1.0, 1.2, 1.1),
           mean=40.0, std=100.0, lower_bound=-60.0, upper_bound=400.0,
           num_classes=K)
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_ckpt")


@pytest.fixture(scope="module")
def pair():
    jnet, tnet, tree = s2d_pair(seed=0)
    jeng = JaxEngine(jnet, PATCH, K, tile_step_size=0.5, shape_bucket=4,
                     compute_dtype=jnp.float32, sweep_acc_dtype=jnp.float32,
                     tile_batch=2, use_s2d_sweep=True)
    teng = SlidingWindowEngine(tnet, PATCH, K, shape_bucket=4,
                               compute_dtype=torch.float32,
                               sweep_acc_dtype=torch.float32, tile_batch=2,
                               device="cpu")
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    return jeng, teng, jtree, tree


def _ct(shape, body, seed):
    rng = np.random.RandomState(seed)
    vol = np.full(shape, -1000.0, np.float32)
    sl = tuple(slice(a, b) for a, b in body)
    vol[sl] = rng.rand(*[b - a for a, b in body]) * 400 - 60
    return vol


def test_sweep_matches_jax(pair):
    jeng, teng, jtree, tree = pair
    v = np.random.RandomState(2).randn(1, 20, 18, 24).astype(np.float32)
    ref = jeng.predict_segmentation_sweep_s2d(jtree, v)
    got = teng.predict_segmentation_sweep_s2d(tree, v)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert (got == ref).mean() >= 0.999


def test_turbo_matches_jax_device_route(pair):
    jeng, teng, jtree, tree = pair
    vol = _ct((30, 26, 22), [(6, 24), (5, 21), (4, 18)], seed=5)
    spacing = (1.0, 1.0, 1.5)
    ref = JaxPipeline(jeng, JaxConfig(**CFG), host_preprocess=False
                      ).predict_volume(jtree, vol, spacing)
    got = TurboPipeline(teng, TurboConfig(**CFG)).predict_volume(
        tree, vol, spacing)
    assert got.shape == vol.shape and got.dtype == np.uint8
    assert (got == ref).mean() >= 0.999


def test_turbo_air_skip_confined_to_air(pair):
    _, teng, _, tree = pair
    vol = np.full((48, 40, 36), -1000.0, np.float32)
    vol[2:14, 2:14, 2:14] = 300.0 + np.random.RandomState(7).rand(12, 12, 12) * 100
    spacing = (1.0, 1.0, 1.0)
    base = TurboPipeline(teng, TurboConfig(**CFG)).predict_volume(
        tree, vol, spacing)
    none = TurboPipeline(teng, TurboConfig(**CFG), air_skip=True,
                         air_margin_hu=-1e6).predict_volume(tree, vol, spacing)
    np.testing.assert_array_equal(none, base)  # nothing skipped
    skip = TurboPipeline(teng, TurboConfig(**CFG), air_skip=True
                         ).predict_volume(tree, vol, spacing)
    diff = skip != base
    assert diff.any(), "the far all-air region must have been skipped"
    assert (vol[diff] == -1000.0).all(), "air skipping changed body voxels"
    assert skip[-8:, -8:, -8:].max() == 0


def test_air_flags_exact_x_extent():
    """A body voxel lights exactly the chunks whose x extent holds it."""
    x = torch.full((20, 16, 16), -2.0)
    x[13, 3, 3] = 1.0
    coords_b = np.array([[[0, 0, 0], [0, 8, 8]]], np.int32)
    flags = air_flags(x, [0, 4, 12], (8, 8, 8), coords_b, -2.0, 0.0)
    assert flags.shape == (3, 1, 2)
    np.testing.assert_array_equal(flags[:, 0, 0], [0, 0, 1])
    assert flags[:, 0, 1].sum() == 0  # window blocks 1..2 miss block 0


@pytest.mark.parametrize("in_shape,out_shape", [
    ((13, 9, 7), (7, 9, 7)), ((13, 9, 7), (13, 20, 7)),
    ((13, 9, 7), (13, 9, 3)), ((6, 11, 5), (15, 4, 9))])
def test_resize_parity_with_jax(in_shape, out_shape):
    x = np.random.RandomState(3).randn(2, *in_shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out_shape),
                                      method="trilinear", antialias=False))
    got = resize_trilinear(torch.from_numpy(x), out_shape).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=1e-5)
    seg = np.random.RandomState(4).randint(0, 61, in_shape).astype(np.uint8)
    ref_n = np.asarray(jax.image.resize(jnp.asarray(seg), out_shape,
                                        method="nearest"))
    got_n = resize_nearest(torch.from_numpy(seg), out_shape).numpy()
    np.testing.assert_array_equal(got_n, ref_n)


def test_golden_model_end_to_end(tmp_path):
    """from_model_folder + predict_file on the committed trained model:
    > 0.95 with the expected mask (the JAX turbo test's contract) and
    >= 0.999 with the JAX turbo mask on the same route."""
    from fast_nnunet_tpu.inference.turbo import TurboPipeline as JaxTurbo
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO

    model = os.path.join(FIX, "model")
    pipe, params = TurboPipeline.from_model_folder(
        model, 0, compute_dtype=torch.float32, air_skip=False, device="cpu")
    out = str(tmp_path / "seg.nii.gz")
    stats = pipe.predict_file(params, os.path.join(FIX, "input_0000.nii.gz"),
                              out)
    assert stats["seconds_total"] > 0
    seg = NiftiIO().read_seg(out)[0][0]
    expected = NiftiIO().read_seg(
        os.path.join(FIX, "expected_mask.nii.gz"))[0][0]
    assert seg.shape == expected.shape
    assert (seg == expected).mean() > 0.95

    jpipe, jparams = JaxTurbo.from_model_folder(
        model, 0, compute_dtype=jnp.float32, air_skip=False,
        host_preprocess=False)
    out_j = str(tmp_path / "seg_jax.nii.gz")
    jpipe.predict_file(jparams, os.path.join(FIX, "input_0000.nii.gz"), out_j)
    seg_j = NiftiIO().read_seg(out_j)[0][0]
    assert (seg == seg_j).mean() >= 0.999


def test_host_route_argument_errors(pair):
    """The host route takes CT channels only; host_revert and fold
    ensembles, raising before they were ported, now run."""
    _, teng, _, tree = pair
    zscore = dict(CFG, channels=[{"scheme": "zscore"}])
    with pytest.raises(ValueError):
        TurboPipeline(teng, TurboConfig(**zscore), host_preprocess=True)
    pipe = TurboPipeline(teng, TurboConfig(**CFG), host_revert=True)
    vol = np.zeros((16, 8, 8), np.float32)
    assert pipe.predict_volume(tree, vol, (1, 1, 1)).shape == vol.shape
    seg = TurboPipeline(teng, TurboConfig(**CFG)).predict_volume(
        [tree, tree], vol, (1, 1, 1))
    assert seg.shape == vol.shape and seg.dtype == np.uint8


def test_bone_turbo_ini():
    cfg = TurboConfig.from_ini("engine/config/fast_nnunet_bone_turbo.ini")
    assert cfg.patch_size == (96, 96, 160)
    assert cfg.transpose_forward == [1, 2, 0]
    assert cfg.num_classes == 61 and cfg.lower_bound == -60.0
