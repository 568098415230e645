"""The port's S2DPlainConvUNet and weight carrier against the JAX package:
same seeded weights, fp32 on CPU, features and logits within the JAX s2d
tests' own atol (3e-4), both InstanceNorm moment paths, and the flax ->
torch parameter hazards (kernel transposes, the transposed-conv flip, the
asymmetric downsample pad) pinned one by one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.models import s2d as jax_s2d
from fast_nnunet_tpu.models.factory import get_network_from_plans
from fast_nnunet_tpu_torch.models import s2d as port_s2d
from fast_nnunet_tpu_torch.models import unet as port_unet

from .torch_port_common import (ARCH, K, PATCH,  # noqa: F401  (fixture)
                                ncdhw, no_persistent_compile_cache,
                                plain_params, s2d_pair)


def _jax_apply(jnet, tree, x, **kw):
    fn = jax.jit(lambda p, v: jnet.apply(p, v, **kw))
    return np.asarray(fn(jax.tree_util.tree_map(jnp.asarray, tree),
                         jnp.asarray(x)))


@pytest.mark.parametrize("stats_path", [False, True])
def test_net_matches_jax_fp32(stats_path):
    """Features (the sweep's contract) and full-res logits; with
    stats_path the port takes kernel A's one-pass moments at this size."""
    jnet, tnet, tree = s2d_pair(seed=0)
    if stats_path:
        tnet.set_stats_min_voxels(0)
    x = np.random.RandomState(1).randn(2, *PATCH, 1).astype(np.float32)
    with torch.no_grad():
        feats = tnet(ncdhw(x), return_features=True).numpy()
        logits = tnet(ncdhw(x)).numpy()
    ref_f = _jax_apply(jnet, tree, x, s2d_output=True, return_features=True)
    ref_l = _jax_apply(jnet, tree, x)
    np.testing.assert_allclose(np.moveaxis(feats, 1, -1), ref_f, atol=3e-4)
    np.testing.assert_allclose(np.moveaxis(logits, 1, -1), ref_l, atol=3e-4)


def test_net_matches_jax_pallas_stats():
    """32^3 input -> 16^3 = 4096 half-res voxels: the stage-0 and decoder
    norms cross the gate on both sides (JAX through the Pallas stats kernel
    in interpret mode, the port through kernel A's plain version)."""
    jnet, tnet, tree = s2d_pair(seed=2)
    jnet.use_pallas_stats = True
    x = np.random.RandomState(3).randn(1, 32, 32, 32, 1).astype(np.float32)
    with torch.no_grad():
        got = tnet(ncdhw(x)).numpy()
    ref = _jax_apply(jnet, tree, x)
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), ref, atol=3e-4)


def test_space_to_depth_matches_jax():
    x = np.random.RandomState(0).rand(2, 8, 6, 4, 5).astype(np.float32)
    ref = np.asarray(jax_s2d.space_to_depth(jnp.asarray(x)))
    got = port_s2d.space_to_depth(ncdhw(x))
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), 1, -1), ref)
    np.testing.assert_array_equal(port_s2d.depth_to_space(got).numpy(),
                                  ncdhw(x).numpy())


def _to_jax_tree(net: port_s2d.S2DPlainConvUNet) -> dict:
    """Inverse of params_from_jax, for the round trip: torch weights back
    into the flax s2d layout."""
    def conv(w):
        return np.transpose(w.float().numpy(), (2, 3, 4, 1, 0))

    def tconv(w):
        return np.transpose(w.float().numpy(), (2, 3, 4, 0, 1))[::-1, ::-1, ::-1]

    out = {}
    for side in ("encoder", "decoder"):
        sub = {}
        for name, mod in getattr(net, side).items():
            if name.startswith("stage_"):
                sub[name] = {b: {"conv": {"kernel": conv(blk.conv.weight),
                                          "bias": blk.conv.bias.float().numpy()},
                                 "norm": {"scale": blk.norm.weight.numpy(),
                                          "bias": blk.norm.bias.numpy()}}
                             for b, blk in mod.items()}
            elif isinstance(mod, torch.nn.ConvTranspose3d):
                sub[name] = {"kernel": tconv(mod.weight),
                             "bias": mod.bias.float().numpy()}
            elif isinstance(mod, torch.nn.Conv3d):
                sub[name] = {"kernel": conv(mod.weight),
                             "bias": mod.bias.float().numpy()}
            else:
                sub[name] = {"kernel": mod.weight.float().numpy(),
                             "bias": mod.bias.float().numpy()}
        out[side] = sub
    return {"params": out}


def test_params_from_jax_round_trip():
    """Every leaf survives tree -> module -> tree, including the plain
    transposed conv (flip) and the converted 1^3 one; only the full-res
    seg head is carried (deep-supervision heads are dropped)."""
    _, tnet, tree = s2d_pair(seed=4)
    back = _to_jax_tree(tnet)
    flat_in = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    dropped = {k for k in flat_in if k not in flat_back}
    assert all("seg_head_0" in jax.tree_util.keystr(k) for k in dropped)
    assert dropped and set(flat_back) <= set(flat_in)
    for k, v in flat_back.items():
        np.testing.assert_array_equal(v, flat_in[k],
                                      err_msg=jax.tree_util.keystr(k))


def test_transposed_conv_flip_matches_lax():
    """flax's conv_transpose applies its kernel mirrored; the torch weight
    from params_from_jax's mapping must give the same output."""
    rng = np.random.RandomState(5)
    kern = rng.randn(2, 2, 2, 3, 4).astype(np.float32)
    x = rng.randn(1, 3, 5, 4, 3).astype(np.float32)
    ref = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(kern),
                                 (2, 2, 2), "VALID",
                                 dimension_numbers=("NHWDC", "HWDIO", "NHWDC"))
    w = torch.from_numpy(port_unet.from_flax_layout("transpconv", kern))
    got = torch.nn.functional.conv_transpose3d(ncdhw(x), w, stride=2)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1),
                               np.asarray(ref), atol=1e-5)


def test_downsample_pad_matches_lax():
    """The s2d downsample's ((1,0),(1,0),(1,0)) pad: F.pad (last dim first)
    then a VALID conv equals lax's asymmetric padding."""
    rng = np.random.RandomState(6)
    kern = rng.randn(2, 2, 2, 16, 3).astype(np.float32)
    x = rng.randn(1, 4, 6, 5, 16).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kern), (1, 1, 1),
        ((1, 0), (1, 0), (1, 0)), dimension_numbers=("NHWDC", "HWDIO", "NHWDC"))
    w = torch.from_numpy(port_unet.from_flax_layout("conv", kern))
    got = torch.nn.functional.conv3d(
        torch.nn.functional.pad(ncdhw(x), (1, 0, 1, 0, 1, 0)), w)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_random_params_have_the_flax_layout():
    """The seeded weights chip_smoke.py loads have exactly the tree paths
    and shapes of a flax PlainConvUNet init."""
    net = get_network_from_plans("PlainConvUNet", ARCH, (), 1, K,
                                 dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: net.init(k, jnp.zeros((1, *PATCH, 1)),
                           deep_supervision=False), jax.random.PRNGKey(0))
    ref = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
           jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {jax.tree_util.keystr(k): tuple(np.shape(v)) for k, v in
           jax.tree_util.tree_flatten_with_path(plain_params())[0]}
    assert got == ref
