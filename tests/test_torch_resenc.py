"""The port's residual-encoder U-Net (models/unet.py ``ResidualEncoderUNet``,
models/blocks.py ``BasicResBlockD``) and its LiteResEncStudent against the
JAX package's (fast_nnunet_tpu/models/{unet,students}.py), on the same
seeded weights (through the weight carrier) and inputs:
- forwards with deep supervision on and off, with the inference (two-pass)
  and the training (one-pass; kernel A's plain version at 16^3) norms:
  float32 logits within 1e-5 of the logits' scale (max |logit|; the two sum
  each convolution in another order), bfloat16 logits within 1e-2 of it in
  the mean (each side rounds every activation to bfloat16 and adds conv
  biases in its own order: single logits differ by up to ~2% of the scale,
  as the plain U-Net's do, and at most 5% is allowed; the argmax agrees on
  >= 98% of voxels);
- the carrier both ways, the skip rule, the block strategies;
- the train, validation and distillation steps against the JAX steps
  (losses 1e-4, parameters 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.models import students as jstudents
from fast_nnunet_tpu.models.factory import get_network_from_plans as jax_net
from fast_nnunet_tpu.training import distill as jdistill
from fast_nnunet_tpu.training import optimizers as jopt
from fast_nnunet_tpu.training import schedules as jsched
from fast_nnunet_tpu.training import train_step as jstep
from fast_nnunet_tpu_torch.models import factory as pfactory
from fast_nnunet_tpu_torch.models import students as pstudents
from fast_nnunet_tpu_torch.models.blocks import BasicResBlockD
from fast_nnunet_tpu_torch.models.unet import (ResidualEncoderUNet,
                                               init_he_normal_,
                                               params_from_jax,
                                               params_from_jax_partial,
                                               params_to_jax, remat_modules)
from fast_nnunet_tpu_torch.training import distill as pdistill
from fast_nnunet_tpu_torch.training import optimizers as popt
from fast_nnunet_tpu_torch.training import schedules as psched
from fast_nnunet_tpu_torch.training import train_step as pstep

from .torch_port_common import (K, ncdhw,  # noqa: F401 (fixture)
                                no_persistent_compile_cache)

# a 3-stage ResEnc with the L preset's shape of things: an anisotropic
# first kernel, a strided first block per stage, 1 / 2 / 2 blocks
RESENC = {"n_stages": 3, "features_per_stage": [8, 16, 32],
          "kernel_sizes": [[1, 3, 3], [3, 3, 3], [3, 3, 3]],
          "strides": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
          "n_blocks_per_stage": [1, 2, 2], "n_conv_per_stage": [1, 2, 2],
          "n_conv_per_stage_decoder": [1, 1], "nonlin": "torch.nn.LeakyReLU"}
PATCH = (16, 16, 16)    # 4096 voxels: stage 0's norms take kernel A's route
N_DS = 2
TOL = 1e-5


def resenc_tree(arch, seed, k=K):
    """Seeded weights of the ResEnc ``arch`` in the flax tree layout."""
    net = pfactory.get_network_from_plans("ResidualEncoderUNet", arch, (), 1,
                                          k, compute_dtype=torch.float32)
    init_he_normal_(net, seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():   # non-trivial norm affines and biases
        for name, p in net.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return params_to_jax(net)


def _port(arch, tree, k=K, **kw):
    net = pfactory.get_network_from_plans("ResidualEncoderUNet", arch, (), 1,
                                          k, **kw)
    return params_from_jax(net, tree)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _lite():
    return jstudents.build_student_arch_kwargs(RESENC, 2, "reduce")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("onepass", [False, True])
@pytest.mark.parametrize("ds", [False, True])
@pytest.mark.parametrize("which", ["resenc", "lite"])
def test_forward_matches_jax(which, ds, onepass, dtype):
    arch = RESENC if which == "resenc" else _lite()
    tree = resenc_tree(arch, 1)
    jnet = jax_net("ResidualEncoderUNet", arch, (), 1, K,
                   dtype=getattr(jnp, dtype), norm_onepass=onepass)
    tnet = _port(arch, tree, compute_dtype=getattr(torch, dtype),
                 norm_onepass=onepass)
    x = np.random.RandomState(2).randn(2, *PATCH, 1).astype(np.float32)
    ref = jnet.apply(_jtree(tree), jnp.asarray(x), deep_supervision=ds)
    with torch.no_grad():
        got = tnet(ncdhw(x), deep_supervision=ds)
    ref, got = (ref, got) if ds else ((ref,), (got,))
    assert len(got) == len(ref) == (N_DS if ds else 1)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        g, r = np.moveaxis(g.numpy(), 1, -1), np.asarray(r)
        if dtype == "float32":
            assert np.abs(g - r).max() <= TOL * np.abs(r).max()
        else:
            scale = np.abs(r).max()
            assert np.abs(g - r).mean() <= 1e-2 * scale
            assert np.abs(g - r).max() <= 5e-2 * scale
            assert (g.argmax(-1) == r.argmax(-1)).mean() >= 0.98


@pytest.mark.parametrize("norm_op", ["torch.nn.InstanceNorm3d",
                                     "torch.nn.BatchNorm3d"])
def test_params_to_jax_inverts_params_from_jax(norm_op):
    arch = dict(RESENC, norm_op=norm_op)
    jnet = jax_net("ResidualEncoderUNet", arch, (), 1, K)
    jvars = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, *PATCH, 1)))
    tree = jax.tree_util.tree_map(np.asarray, jvars)
    if "batch_stats" in tree:
        rng = np.random.RandomState(0)
        tree["batch_stats"] = jax.tree_util.tree_map(
            lambda v: (rng.rand(*v.shape) + 0.5).astype(np.float32),
            tree["batch_stats"])
    tnet = _port(arch, tree, trainable=True)
    back = params_to_jax(tnet)
    assert sorted(back) == sorted(tree)
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    for path, v in jax.tree_util.tree_leaves_with_path(back):
        np.testing.assert_array_equal(v, flat[path],
                                      err_msg=jax.tree_util.keystr(path))
    assert len(flat) == len(jax.tree_util.tree_leaves(back))


def test_carrier_rejects_a_mismatched_tree_and_partial_load_counts():
    tree = resenc_tree(RESENC, 0)
    net = _port(RESENC, tree, trainable=True)
    bad = resenc_tree(dict(RESENC, n_blocks_per_stage=[1, 1, 2]), 0)
    with pytest.raises(ValueError):
        params_from_jax(net, bad)
    n_loaded, n_total = params_from_jax_partial(net, bad)
    assert n_total == len(jax.tree_util.tree_leaves(tree)) > n_loaded > 0
    assert n_total - n_loaded == 8   # stage_1_block_1's 2 convs + 2 norms


def test_skip_path_and_stem_follow_the_jax_rule():
    """A 1x1 bias-free skip conv exactly where the stride or the channel
    count changes; the stem is one conv block at stride 1."""
    net = _port(RESENC, resenc_tree(RESENC, 0))
    enc = net.encoder
    assert tuple(enc.stem.conv.stride) == (1, 1, 1)
    skips = {n: b.skip_conv is not None for n, b in enc.blocks.items()}
    assert skips == {"stage_0_block_0": False, "stage_1_block_0": True,
                     "stage_1_block_1": False, "stage_2_block_0": True,
                     "stage_2_block_1": False}
    conv = enc.blocks["stage_1_block_0"].skip_conv
    assert conv.bias is None and conv.kernel_size == (1, 1, 1)
    assert conv.stride == (2, 2, 2)


@pytest.mark.parametrize("strategy", ["reduce", "keep", "increase",
                                      "adaptive"])
def test_block_strategies_give_jax_student_kwargs(strategy):
    teacher = dict(RESENC, n_blocks_per_stage=[1, 3, 4, 6, 6, 6],
                   n_stages=6, features_per_stage=[32, 64, 128, 256, 320,
                                                   320])
    for r in (2, 3):
        assert pstudents.build_student_arch_kwargs(teacher, r, strategy) \
            == jstudents.build_student_arch_kwargs(teacher, r, strategy)
    small = dict(RESENC, n_blocks_per_stage=[2, 2, 3])
    jnet = jstudents.build_lite_student("LiteResEncStudent", small, 1, K, 2,
                                        strategy)
    tnet = pstudents.build_lite_student("LiteResEncStudent", small, 1, K, 2,
                                        strategy)
    assert isinstance(tnet, ResidualEncoderUNet)
    jvars = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, *PATCH, 1)))
    shapes = {jax.tree_util.keystr(p): np.shape(v) for p, v in
              jax.tree_util.tree_leaves_with_path(jvars)}
    assert shapes == {jax.tree_util.keystr(p): np.shape(v) for p, v in
                      jax.tree_util.tree_leaves_with_path(
                          params_to_jax(tnet))}


def test_factory_falls_back_to_n_conv_per_stage_and_remats_per_block():
    arch = {k: v for k, v in RESENC.items() if k != "n_blocks_per_stage"}
    net = pfactory.get_network_from_plans("ResidualEncoderUNet", arch, (), 1,
                                          K, remat=True, trainable=True)
    assert list(net.encoder.blocks) == [
        "stage_0_block_0", "stage_1_block_0", "stage_1_block_1",
        "stage_2_block_0", "stage_2_block_1"]
    mods = remat_modules(net)
    assert sum(isinstance(m, BasicResBlockD) for m in mods) == 5
    assert net.encoder.stem not in mods
    assert len(mods) == 5 + 2     # and both decoder stacks (remat=True)


def _batch(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *PATCH, 1).astype(np.float32)
    lab = rng.randint(0, K, (2, *PATCH)).astype(np.int32)
    lab[:, 4:10, 4:10, 4:10] = 1
    x[..., 0] += lab
    jt = (lab, lab[:, ::2, ::2, ::2])
    return (x, jt, ncdhw(x),
            tuple(torch.from_numpy(t.astype(np.int64)) for t in jt))


def _assert_trees_close(port_tree, jax_tree, tol=TOL):
    flat_j = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jax_tree)))
    flat_p = jax.tree_util.tree_leaves_with_path(port_tree)
    assert len(flat_p) == len(flat_j)
    for path, v in flat_p:
        np.testing.assert_allclose(v, flat_j[path], atol=tol, rtol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("remat", [False, True])
def test_train_and_val_steps_match_jax(remat):
    tree = resenc_tree(RESENC, 7)
    jnet = jax_net("ResidualEncoderUNet", RESENC, (), 1, K,
                   dtype=jnp.float32, norm_onepass=True, remat=remat)
    opt_j = jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 10))
    state = jstep.create_train_state(_jtree(tree), opt_j)
    jtrain = jax.jit(jstep.make_train_step(jnet, opt_j, n_ds_levels=N_DS,
                                           compute_dtype=jnp.float32))
    jval = jax.jit(jstep.make_val_step(jnet, num_heads=K, n_ds_levels=N_DS,
                                       compute_dtype=jnp.float32))
    net = _port(RESENC, tree, compute_dtype=torch.float32, norm_onepass=True,
                remat=remat, trainable=True)
    opt = popt.nnunet_sgd(net.parameters(), psched.poly_lr(1e-2, 10))
    ptrain = pstep.make_train_step(net, opt, n_ds_levels=N_DS)
    pval = pstep.make_val_step(net, num_heads=K, n_ds_levels=N_DS)
    for s in range(2):
        x, jt, px, pt = _batch(s)
        state, jloss = jtrain(state, jnp.asarray(x),
                              tuple(map(jnp.asarray, jt)))
        np.testing.assert_allclose(float(ptrain(px, pt)), float(jloss),
                                   rtol=1e-4)
    _assert_trees_close(params_to_jax(net), state.params)
    x, jt, px, pt = _batch(9)
    jl, *jm = jval(state.params, jnp.asarray(x), tuple(map(jnp.asarray, jt)))
    pl, *pm = pval(px, pt)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-4)
    for a, b in zip(pm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


def test_resenc_distill_step_matches_jax():
    """Two ResEnc teacher folds into a LiteResEncStudent (r = 2, reduce)."""
    lite = _lite()
    s_tree = resenc_tree(lite, 3)
    t_trees = [resenc_tree(RESENC, 10 + f) for f in range(2)]
    snet_j = jax_net("LiteResEncStudent", lite, (), 1, K, dtype=jnp.float32,
                     norm_onepass=True)
    tnet_j = jax_net("ResidualEncoderUNet", RESENC, (), 1, K,
                     dtype=jnp.float32, norm_onepass=True)
    opt_j = jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 10))
    state = jstep.create_train_state(_jtree(s_tree), opt_j)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                     *[_jtree(t) for t in t_trees])
    jdstep = jax.jit(jdistill.make_distill_train_step(
        snet_j, tnet_j, opt_j, alpha=0.3, temperature=3.0, n_ds_levels=N_DS,
        n_teachers=2, compute_dtype=jnp.float32))
    snet = pfactory.get_network_from_plans(
        "LiteResEncStudent", lite, (), 1, K, compute_dtype=torch.float32,
        norm_onepass=True, trainable=True)
    params_from_jax(snet, s_tree)
    teachers = [_port(RESENC, t, compute_dtype=torch.float32,
                      norm_onepass=True).eval() for t in t_trees]
    opt = popt.nnunet_sgd(snet.parameters(), psched.poly_lr(1e-2, 10))
    pdstep = pdistill.make_distill_train_step(
        snet, teachers, opt, alpha=0.3, temperature=3.0, n_ds_levels=N_DS)
    for s in range(2):
        x, jt, px, pt = _batch(20 + s)
        state, *jl = jdstep(state, stacked, jnp.asarray(x),
                            tuple(map(jnp.asarray, jt)))
        for a, b in zip(pdstep(px, pt), jl):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-4,
                                       atol=1e-7)
    _assert_trees_close(params_to_jax(snet), state.params)
