"""The port's plain-network engine routes against the JAX package's
SlidingWindowEngine on CPU, fp32, same seeded weights: both sweep grids
(the fused one with kernel D's plain version on the port's side and the
Pallas kernel in interpret mode on the JAX side) with mask agreement
>= 0.999, ``predict_logits`` whole, chunked and host-memmapped within atol
1e-4, and mirror TTA with two folds likewise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.inference.engine import SlidingWindowEngine as JaxEngine
from fast_nnunet_tpu.models.factory import get_network_from_plans as jax_net
from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
from fast_nnunet_tpu_torch.ops import scatter_accumulate

from .torch_port_common import (ARCH, K, PATCH,  # noqa: F401  (fixture)
                                no_persistent_compile_cache, plain_params)

PATCH_FUSED = (16, 32, 32)  # y/z strides of 16: the fused grid applies


def _engines(patch=PATCH, **kw):
    jnet = jax_net("PlainConvUNet", ARCH, (), 1, K, dtype=jnp.float32)
    tnet = get_network_from_plans("PlainConvUNet", ARCH, (), 1, K,
                                  compute_dtype=torch.float32)
    jkw = dict(kw)
    if "use_fused_accumulate" in jkw:
        jkw["use_pallas_accumulate"] = jkw.pop("use_fused_accumulate")
    common = dict(shape_bucket=16, tile_batch=2)
    jeng = JaxEngine(jnet, patch, K, compute_dtype=jnp.float32,
                     acc_dtype=jnp.float32, sweep_acc_dtype=jnp.float32,
                     **common, **jkw)
    teng = SlidingWindowEngine(tnet, patch, K, compute_dtype=torch.float32,
                               acc_dtype=torch.float32,
                               sweep_acc_dtype=torch.float32, device="cpu",
                               **common, **kw)
    return jeng, teng


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _vol(shape, seed):
    return np.random.RandomState(seed).randn(1, *shape).astype(np.float32)


def test_sweep_plain_grid_matches_jax():
    jeng, teng = _engines()
    tree = plain_params(0)
    v = _vol((21, 18, 35), 1)
    ref = jeng.predict_segmentation_sweep(_jtree(tree), v)
    got = teng.predict_segmentation_sweep(tree, v)
    assert got.shape == ref.shape == v.shape[1:] and got.dtype == np.uint8
    assert (got == ref).mean() >= 0.999
    # grid-exact: the sweep equals the logits path's argmax
    assert (got == teng.predict_logits(tree, v).argmax(0)).mean() >= 0.999


def test_sweep_fused_grid_matches_jax_pallas():
    """Quantised 16-aligned grid, same-coset batches, kernel D (plain
    version) vs the Pallas kernel in interpret mode."""
    jeng, teng = _engines(PATCH_FUSED, use_fused_accumulate=True)
    tree = plain_params(1)
    v = _vol((24, 40, 44), 2)
    n0 = scatter_accumulate.fused_scatter_accumulate.launches
    ref = jeng.predict_segmentation_sweep(_jtree(tree), v)
    got = teng.predict_segmentation_sweep(tree, v)
    assert got.shape == ref.shape and (got == ref).mean() >= 0.999
    # on the CPU the plain version runs: nothing is counted as a launch
    assert scatter_accumulate.fused_scatter_accumulate.launches == n0
    vol_shape, starts_x, coords_b, n_real, fused = teng._sweep_grid(
        v.shape[1:])
    assert fused and vol_shape == (32, 48, 48) and list(starts_x) == [0, 16]
    assert (coords_b[..., 1:] % 16 == 0).all() and n_real.sum() == 4


def test_sweep_fused_on_reference_grid_matches_jax():
    """A patch too small for 16-aligned strides: kernel D (plain version)
    runs on the reference grid, each batch's n_real its count of valid
    slots; JAX falls back to its XLA accumulate on the same grid."""
    jeng, teng = _engines(use_fused_accumulate=True)
    tree = plain_params(7)
    v = _vol((21, 18, 35), 7)
    ref = jeng.predict_segmentation_sweep(_jtree(tree), v)
    got = teng.predict_segmentation_sweep(tree, v)
    assert got.shape == ref.shape and (got == ref).mean() >= 0.999
    # grid-exact like the plain route: equal to the logits path's argmax
    assert (got == teng.predict_logits(tree, v).argmax(0)).mean() >= 0.999
    _, _, coords_b, n_real, fused = teng._sweep_grid(v.shape[1:])
    _, ref_coords, valid = _engines()[1]._sweep_grid(v.shape[1:])[1:4]
    assert fused and n_real.dtype == np.int32
    np.testing.assert_array_equal(coords_b, ref_coords)
    np.testing.assert_array_equal(n_real, valid.sum(1))
    with pytest.raises(ValueError):  # more tiles than one launch takes
        SlidingWindowEngine(torch.nn.Identity(), PATCH, K, tile_batch=33,
                            use_fused_accumulate=True, device="cpu")


def test_fused_grid_at_the_bone_turbo_shape():
    """The plan kernel D gets on a 512^3 volume with the bone_turbo patch:
    10 chunks x 8 same-coset batches of 8 or 7 disjoint tiles, 80 launches,
    600 real tiles, accumulator (96, 544, 576, 64)."""
    teng = SlidingWindowEngine(torch.nn.Identity(), (96, 96, 160), 61,
                               use_fused_accumulate=True, device="cpu")
    vol_shape, starts_x, coords_b, n_real, fused = teng._sweep_grid(
        (512, 512, 512))
    assert fused and vol_shape == (528, 544, 576)
    assert len(starts_x) == 10 and len(coords_b) == 8
    assert sorted(set(n_real.tolist())) == [7, 8]
    assert len(starts_x) * len(coords_b) == 80
    assert len(starts_x) * int(n_real.sum()) == 600
    assert teng._acc_channels() == 64
    for b, n in zip(coords_b, n_real):  # pairwise disjoint real tiles
        occ = np.zeros(vol_shape[1:], np.int32)
        for _, y, z in b[:n]:
            occ[y:y + 96, z:z + 160] += 1
        assert occ.max() == 1


def test_predict_logits_matches_jax():
    jeng, teng = _engines()
    tree = plain_params(2)
    v = _vol((13, 19, 30), 3)
    ref = np.asarray(jeng.predict_logits(_jtree(tree), v))
    got = teng.predict_logits(tree, v)
    assert got.shape == (K, *v.shape[1:]) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_predict_logits_chunked_and_memmapped_match_jax(monkeypatch):
    """A tiny accumulator budget forces the chunk grid on both sides; a
    1-byte host budget backs the port's merged logits onto a memmap."""
    jeng, teng = _engines(max_accumulator_bytes=60_000)
    tree = plain_params(3)
    v = _vol((20, 22, 40), 4)
    ref = np.asarray(jeng.predict_logits(_jtree(tree), v))
    assert teng._acc_bytes(v.shape[1:]) > teng.max_accumulator_bytes
    got = teng.predict_logits(tree, v)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    monkeypatch.setenv("FNN_LOGITS_HOST_BYTES", "1")
    mm = teng.predict_logits(tree, v)
    assert isinstance(mm, np.memmap)
    np.testing.assert_allclose(np.asarray(mm), ref, atol=1e-4)
    import os
    os.remove(teng._logits_memmap_path)


def test_mirror_tta_and_two_folds_match_jax():
    jeng, teng = _engines(mirror_axes=(0, 1, 2))
    trees = [plain_params(4), plain_params(5)]
    v = _vol((10, 12, 20), 5)
    ref = np.asarray(jeng.predict_logits([_jtree(t) for t in trees], v))
    got = teng.predict_logits(trees, v)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert len(teng.load_params(trees)) == 2  # cached fold modules
    one = teng.predict_logits(trees[:1], v)
    assert np.abs(one - got).max() > 1e-3  # the second fold counts


def test_predict_segmentation_dispatch():
    _, teng = _engines(max_accumulator_bytes=1)
    tree = plain_params(6)
    v = _vol((17, 16, 26), 6)
    seg = teng.predict_segmentation(tree, v)
    np.testing.assert_array_equal(seg,
                                  teng.predict_segmentation_sweep(tree, v))
    teng.max_accumulator_bytes = 1 << 40
    logits_seg = teng.predict_segmentation(tree, v)
    assert (logits_seg == seg).mean() >= 0.999
    with pytest.raises(ValueError):  # a 3D patch on a 2D image
        teng.predict_logits(tree, v[:, 0])
