"""The port's plain-network engine routes against the JAX package's
SlidingWindowEngine on CPU, fp32, same seeded weights: both sweep grids
(the fused one with kernel D's plain version on the port's side and the
Pallas kernel in interpret mode on the JAX side) with mask agreement
>= 0.999, at several geometries and for fold ensembles; the reference-grid
sweep against a naive accumulation; ``predict_logits`` whole, chunked and
host-memmapped within atol 1e-4, and mirror TTA with two folds likewise;
and the route ``predict_segmentation`` takes above the accumulator
budget."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.inference.engine import SlidingWindowEngine as JaxEngine
from fast_nnunet_tpu.models.factory import get_network_from_plans as jax_net
from fast_nnunet_tpu.ops.sliding_window import (
    compute_gaussian, compute_steps_for_sliding_window)
from fast_nnunet_tpu_torch.inference import engine as engine_module
from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
from fast_nnunet_tpu_torch.models.s2d import make_s2d_engine_net
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


# one x start (7), even and uneven rolls, extents on and off the half-patch
# grid, and plane extents below and above the shape bucket
SWEEP_SHAPES = [(21, 18, 35), (26, 13, 18), (7, 13, 18), (16, 16, 32),
                (21, 13, 18)]


@pytest.mark.parametrize("shape", SWEEP_SHAPES)
def test_sweep_plain_grid_matches_jax(shape):
    jeng, teng = _engines()
    tree = plain_params(0)
    v = _vol(shape, 1)
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


@pytest.mark.parametrize("shape", [(21, 18, 35), (7, 13, 18),
                                   (26, 13, 18)])
def test_sweep_fused_on_reference_grid_matches_jax(shape):
    """A patch too small for 16-aligned strides: kernel D (plain version)
    runs on the reference grid, each batch's n_real its count of valid
    slots; JAX falls back to its XLA accumulate on the same grid."""
    jeng, teng = _engines(use_fused_accumulate=True)
    tree = plain_params(7)
    v = _vol(shape, 7)
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


@pytest.mark.parametrize("fused", [False, True])
def test_sweep_fold_ensembles_match_jax(fused):
    """Two folds through the rolling sweep, plain and with kernel D: the
    logits are averaged over the folds before they are accumulated."""
    kw = {"use_fused_accumulate": True} if fused else {}
    jeng, teng = _engines(**kw)
    trees = [plain_params(5), plain_params(6)]
    v = _vol((26, 13, 18), 15)
    got = teng.predict_segmentation_sweep(trees, v)
    ref = jeng.predict_segmentation_sweep([_jtree(t) for t in trees], v)
    assert got.shape == ref.shape == v.shape[1:]
    assert (got == ref).mean() >= 0.999
    assert (got == teng.predict_logits(trees, v).argmax(0)).mean() >= 0.999


def test_reference_grid_sweep_matches_naive_accumulation():
    """Odd extents, uneven rolls in x and a plane below the patch in y and
    z (padded up to one tile, then cropped; no other sweep case has it):
    against a plain python accumulation of every tile of the reference
    grid (compute_steps_for_sliding_window's) into a whole-volume buffer."""
    _, teng = _engines()
    tree = plain_params(4)
    shape = (23, 5, 11)
    assert all(e < p_ for e, p_ in zip(shape[1:], PATCH[1:]))
    v = _vol(shape, 13)
    seg = teng.predict_segmentation_sweep(tree, v)
    assert seg.shape == shape

    p = PATCH
    tight = [max(e, p_) for e, p_ in zip(shape, p)]
    starts = compute_steps_for_sliding_window(tight, p, 0.5)
    assert len(set(np.diff(starts[0]).tolist())) == 2  # uneven rolls
    volp = np.zeros((1, *tight), np.float32)
    volp[(slice(None),) + tuple(slice(0, e) for e in shape)] = v
    g = compute_gaussian(tuple(p)).astype(np.float32)
    acc = np.zeros((K, *tight), np.float32)
    w = np.zeros(tight, np.float32)
    net = teng.load_params(tree)[0]
    with torch.no_grad():
        for x0 in starts[0]:
            for y0 in starts[1]:
                for z0 in starts[2]:
                    sl = (slice(x0, x0 + p[0]), slice(y0, y0 + p[1]),
                          slice(z0, z0 + p[2]))
                    tile = torch.from_numpy(volp[(slice(None),) + sl][None])
                    out = net(tile).float().numpy()[0]
                    acc[(slice(None),) + sl] += out * g
                    w[sl] += g
    ref = (acc / w).argmax(0)[tuple(slice(0, e) for e in shape)]
    assert (seg == ref).mean() >= 0.999


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


def _s2d_engine(**kw):
    net = make_s2d_engine_net(ARCH, K, 1, compute_dtype=torch.float32)
    return SlidingWindowEngine(net, PATCH, K, compute_dtype=torch.float32,
                               device="cpu", **kw)


@pytest.mark.parametrize("make,kw,expected", [
    (lambda **kw: _engines(**kw)[1], {}, "predict_segmentation_sweep"),
    (lambda **kw: _engines(**kw)[1], {"use_fused_accumulate": True},
     "predict_segmentation_sweep"),
    (_s2d_engine, {}, "predict_segmentation_sweep_s2d"),
    (_s2d_engine, {"mirror_axes": (0, 1, 2)}, "predict_segmentation_sweep"),
], ids=["plain", "fused", "s2d", "s2d-mirrored"])
def test_predict_segmentation_dispatch_above_budget(monkeypatch, make, kw,
                                                    expected):
    """Above the accumulator budget: the s2d sweep for an s2d network
    without mirroring, else the rolling sweep, whose accumulate
    ``use_fused_accumulate`` chooses."""
    teng = make(max_accumulator_bytes=1, **kw)
    taken = []
    for name in ("predict_segmentation_sweep",
                 "predict_segmentation_sweep_s2d", "predict_logits"):
        monkeypatch.setattr(
            engine_module.SlidingWindowEngine, name,
            lambda self, params, volume, name=name: taken.append(name))
    teng.predict_segmentation(plain_params(0), _vol((16, 16, 32), 0))
    assert taken == [expected]
