"""The port's 2D networks (models/unet.py at ``dim=2``, models/blocks.py's
2D convs) and its 2D-over-slices engine route against the JAX package's, on
the same seeded weights (carried by ``params_from_jax``) and inputs, fp32 on
the CPU:
- PlainConvUNet and ResidualEncoderUNet forwards in the inference and the
  one-pass training forms, deep supervision on and off: logits within atol
  3e-4 (the tolerance of tests/test_torch_plain_net.py);
- the weight carrier both ways, bit for bit, with anisotropic transposed
  convs;
- one-pass norm statistics through kernel A's plain version on a 4-D
  (B, C, H, W) input, and its gradient;
- two train steps and a validation step against JAX's (losses rtol 1e-5,
  parameters 1e-5, as tests/test_torch_train_step.py);
- ``predict_logits`` / ``predict_segmentation`` of a 2D engine on a
  (1, D, Y, X) volume and on a (1, Y, X) image, with and without mirror TTA,
  with two folds and through the chunk grid: atol 1e-4, as
  tests/test_torch_plain_engine.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.inference.engine import SlidingWindowEngine as JaxEngine
from fast_nnunet_tpu.models.factory import get_network_from_plans as jax_net
from fast_nnunet_tpu.training import optimizers as jopt
from fast_nnunet_tpu.training import schedules as jsched
from fast_nnunet_tpu.training import train_step as jstep
from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
from fast_nnunet_tpu_torch.models import factory as pfactory
from fast_nnunet_tpu_torch.models.blocks import (Conv2d, ConvTranspose2d,
                                                 instance_norm_onepass)
from fast_nnunet_tpu_torch.models.unet import (init_he_normal_,
                                               params_from_jax,
                                               params_to_jax)
from fast_nnunet_tpu_torch.ops import stats
from fast_nnunet_tpu_torch.training import optimizers as popt
from fast_nnunet_tpu_torch.training import schedules as psched
from fast_nnunet_tpu_torch.training import train_step as pstep

from .torch_port_common import K, no_persistent_compile_cache  # noqa: F401

CONV2D = "torch.nn.modules.conv.Conv2d"
# 3 stages with an anisotropic stride (the 2d plans' kind of thing)
ARCH2D = {"n_stages": 3, "features_per_stage": [8, 16, 32],
          "kernel_sizes": [[3, 3]] * 3, "strides": [[1, 1], [2, 2], [2, 1]],
          "n_conv_per_stage": [2, 2, 2], "n_blocks_per_stage": [1, 2, 2],
          "n_conv_per_stage_decoder": [2, 1], "conv_op": CONV2D,
          "nonlin": "torch.nn.LeakyReLU"}
CLASSES = ("PlainConvUNet", "ResidualEncoderUNet")
PATCH2D = (64, 64)      # 4096 voxels: stage 0's one-pass norms use kernel A
TOL = 1e-5


def tree_2d(cls, seed, in_ch=1, k=K, arch=ARCH2D):
    """Seeded weights of a 2D ``cls`` in the flax tree layout, norm
    affines perturbed so that they matter."""
    net = pfactory.get_network_from_plans(cls, arch, (), in_ch, k,
                                          compute_dtype=torch.float32)
    init_he_normal_(net, seed)
    tree = params_to_jax(net)
    rng = np.random.RandomState(seed)

    def perturb(d):
        for key, v in d.items():
            if isinstance(v, dict):
                perturb(v)
            elif key in ("scale", "bias") and v.ndim == 1:
                d[key] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    perturb(tree)
    return tree


def _port(cls, tree, in_ch=1, **kw):
    net = pfactory.get_network_from_plans(cls, ARCH2D, (), in_ch, K,
                                          compute_dtype=torch.float32, **kw)
    return params_from_jax(net, tree)


def _jax(cls, in_ch=1, **kw):
    return jax_net(cls, ARCH2D, (), in_ch, K, dtype=jnp.float32, **kw)


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _nchw(x):
    """(B, *S, C) numpy -> (B, C, *S) tensor with the standard strides (a
    one-channel input moved from channels-last keeps channels-last strides,
    which crash torch's CPU backward of a strided 1x1 2D conv)."""
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy()).clone(
        memory_format=torch.contiguous_format)


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("onepass", [False, True])
def test_2d_forward_matches_jax(cls, onepass):
    """Inference (two-pass) and training (one-pass) norm forms, the
    full-resolution head and every deep-supervision head."""
    tree = tree_2d(cls, 3, in_ch=2)
    jnet = _jax(cls, in_ch=2, norm_onepass=onepass)
    tnet = _port(cls, tree, in_ch=2, norm_onepass=onepass,
                 trainable=onepass)
    assert tnet.dim == 2
    x = np.random.RandomState(1).randn(2, *PATCH2D, 2).astype(np.float32)
    for ds in (False, True):
        ref = jnet.apply(_jt(tree), jnp.asarray(x), deep_supervision=ds)
        with torch.no_grad():
            got = tnet(_nchw(x), deep_supervision=ds)
        if not ds:
            ref, got = (ref,), (got,)
        assert len(got) == len(ref) == (2 if ds else 1)
        for g, r in zip(got, ref):
            assert g.dim() == 4
            np.testing.assert_allclose(np.moveaxis(g.numpy(), 1, -1),
                                       np.asarray(r), atol=3e-4)


@pytest.mark.parametrize("cls", CLASSES)
def test_2d_carrier_round_trips_bit_equal(cls):
    """params_to_jax(params_from_jax(tree)) == tree, and the layout equals
    the flax module's own tree (2D transposed-conv kernels included)."""
    tree = tree_2d(cls, 5)
    net = _port(cls, tree)
    back = params_to_jax(net)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(v, flat_b[path])
    flax = _jax(cls).init(jax.random.PRNGKey(0), jnp.zeros((1, *PATCH2D, 1)))
    assert {k: v.shape for k, v in flat_b.items()} == {
        k: tuple(v.shape)
        for k, v in jax.tree_util.tree_leaves_with_path(flax)}
    assert isinstance(net.decoder.mods["transpconv_0"], ConvTranspose2d)
    assert isinstance(net.decoder.mods["seg_head_1"], Conv2d)
    # the anisotropic (2, 1) stride's transposed conv: (I, O, 2, 1)
    assert tuple(net.decoder.mods["transpconv_0"].weight.shape) == \
        (32, 16, 2, 1)


def test_onepass_norm_4d_takes_kernel_a_and_its_gradient(monkeypatch):
    """A (B, C, H, W) activation of >= 4096 voxels takes its statistics
    from kernel A's wrapper (the plain version on the CPU); values and the
    gradient equal the float64 formula's."""
    calls = []
    real = stats.spatial_sum_sumsq
    monkeypatch.setattr(stats, "spatial_sum_sumsq",
                        lambda x: calls.append(tuple(x.shape)) or real(x))
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.randn(2, 3, 64, 64), dtype=torch.float32,
                     requires_grad=True)
    scale = torch.tensor(1 + 0.1 * rng.randn(3), dtype=torch.float32)
    bias = torch.tensor(0.1 * rng.randn(3), dtype=torch.float32)
    y = instance_norm_onepass(x, scale, bias, 1e-5)
    assert calls == [(2, 3, 64, 64)]
    x64 = x.detach().double().requires_grad_(True)
    mean = x64.mean((2, 3), keepdim=True)
    var = (x64 * x64).mean((2, 3), keepdim=True) - mean * mean
    ref = (x64 - mean) / torch.sqrt(var + 1e-5) * \
        scale.double()[:, None, None] + bias.double()[:, None, None]
    np.testing.assert_allclose(y.detach().numpy(), ref.detach().numpy(),
                               atol=1e-5)
    g = torch.tensor(rng.randn(*x.shape), dtype=torch.float32)
    (y * g).sum().backward()
    (ref * g.double()).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), x64.grad.numpy(), atol=1e-4)


def _batch(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *PATCH2D, 1).astype(np.float32)
    lab = rng.randint(0, K, (2, *PATCH2D)).astype(np.int32)
    lab[:, 10:30, 20:40] = 1
    x[..., 0] += lab
    half = lab[:, ::2, ::2]
    jt = (lab, half)
    pt = tuple(torch.from_numpy(t.astype(np.int64)) for t in jt)
    return x, jt, _nchw(x), pt


@pytest.mark.parametrize("cls", CLASSES)
def test_2d_train_step_matches_jax(cls):
    """Two SGD steps (deep supervision over two levels, the one-pass norm
    with kernel A's plain version at 64x64) and a validation step."""
    tree = tree_2d(cls, 7)
    jnet = _jax(cls, norm_onepass=True)
    opt_j = jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 10))
    state = jstep.create_train_state(_jt(tree), opt_j)
    jtrain = jax.jit(jstep.make_train_step(jnet, opt_j, n_ds_levels=2,
                                           compute_dtype=jnp.float32))
    jval = jax.jit(jstep.make_val_step(jnet, num_heads=K, n_ds_levels=2,
                                       compute_dtype=jnp.float32))
    net = _port(cls, tree, norm_onepass=True, trainable=True)
    opt = popt.nnunet_sgd(net.parameters(), psched.poly_lr(1e-2, 10))
    ptrain = pstep.make_train_step(net, opt, n_ds_levels=2)
    pval = pstep.make_val_step(net, num_heads=K, n_ds_levels=2)
    for s in range(2):
        x, jt, px, pt = _batch(s)
        state, jloss = jtrain(state, jnp.asarray(x),
                              tuple(map(jnp.asarray, jt)))
        np.testing.assert_allclose(float(ptrain(px, pt)), float(jloss),
                                   rtol=TOL)
    flat_p = jax.tree_util.tree_leaves_with_path(params_to_jax(net))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, state.params)))
    assert len(flat_p) == len(flat_j)
    for path, v in flat_p:
        np.testing.assert_allclose(v, flat_j[path], atol=TOL, rtol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
    x, jt, px, pt = _batch(9)
    jl, jtp, _, _ = jval(state.params, jnp.asarray(x),
                         tuple(map(jnp.asarray, jt)))
    pl, ptp, _, _ = pval(px, pt)
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL)
    np.testing.assert_allclose(ptp.numpy(), np.asarray(jtp), atol=TOL)


# ------------------------------------------------------------ 2D engine
PATCH_E = (16, 24)


def _engines(mirror=(), **kw):
    jnet = jax_net("PlainConvUNet", ARCH2D, (), 1, K, dtype=jnp.float32)
    tnet = pfactory.get_network_from_plans("PlainConvUNet", ARCH2D, (), 1,
                                           K, compute_dtype=torch.float32)
    common = dict(shape_bucket=16, tile_batch=3, mirror_axes=mirror, **kw)
    jeng = JaxEngine(jnet, PATCH_E, K, compute_dtype=jnp.float32,
                     acc_dtype=jnp.float32, **common)
    teng = SlidingWindowEngine(tnet, PATCH_E, K, compute_dtype=torch.float32,
                               acc_dtype=torch.float32, device="cpu",
                               **common)
    return jeng, teng


def _vol(shape, seed):
    return np.random.RandomState(seed).randn(1, *shape).astype(np.float32)


@pytest.mark.parametrize("mirror", [(), (0, 1)])
def test_2d_over_slices_logits_match_jax(mirror):
    """(1, D, Y, X) volume, no TTA and mirror TTA over both in-plane axes;
    the segmentation is the logits' argmax."""
    jeng, teng = _engines(mirror)
    tree = tree_2d("PlainConvUNet", 2)
    v = _vol((5, 30, 41), 3)
    ref = jeng.predict_logits(_jt(tree), v)
    got = teng.predict_logits(tree, v)
    assert got.shape == ref.shape == (K, 5, 30, 41)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    seg = teng.predict_segmentation(tree, v)
    np.testing.assert_array_equal(seg, got.argmax(0))
    assert (seg == jeng.predict_segmentation(_jt(tree), v)).mean() >= 0.999
    assert teng._slicewise_engine().mirror_axes == tuple(a + 1
                                                         for a in mirror)


def test_2d_over_slices_two_folds_and_chunk_grid_match_jax():
    """Two folds through a budget that forces the chunk grid on both
    sides."""
    jeng, teng = _engines(max_accumulator_bytes=40_000)
    trees = [tree_2d("PlainConvUNet", s) for s in (11, 12)]
    v = _vol((7, 37, 29), 4)
    ref = jeng.predict_logits([_jt(t) for t in trees], v)
    got = teng.predict_logits(trees, v)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_2d_engine_on_a_2d_image_is_one_slice():
    """A (1, Y, X) image gives the JAX 2D engine's logits, which are those
    of the same image as a one-slice volume."""
    jeng, teng = _engines()
    tree = tree_2d("PlainConvUNet", 6)
    img = _vol((33, 20), 5)
    got = teng.predict_logits(tree, img)
    np.testing.assert_allclose(got, jeng.predict_logits(_jt(tree), img),
                               atol=1e-4)
    np.testing.assert_allclose(got, teng.predict_logits(tree, img[:, None])
                               [:, 0], atol=1e-6)
    with pytest.raises(ValueError):
        teng.predict_segmentation_sweep(tree, img[:, None])
