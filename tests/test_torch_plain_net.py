"""The port's PlainConvUNet, factory and weight carrier against the JAX
package's flax PlainConvUNet: same seeded weights, fp32 on CPU, logits
within atol 3e-4 (the tolerance of the JAX s2d tests) — the transposed
convs and every seg head included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.models.factory import get_network_from_plans as jax_net
from fast_nnunet_tpu_torch.models import factory as port_factory
from fast_nnunet_tpu_torch.models.blocks import BatchStatsNorm
from fast_nnunet_tpu_torch.models.unet import (PlainConvUNet,
                                               ResidualEncoderUNet,
                                               params_from_jax, restore)

from .torch_port_common import (ARCH, GOLDEN, K,  # noqa: F401  (fixture)
                                ncdhw, no_persistent_compile_cache,
                                plain_params)

ARCH_ODD = {"n_stages": 3, "features_per_stage": [4, 8, 8],
            "kernel_sizes": [[3, 3, 3], [1, 3, 3], [3, 3, 3]],
            "strides": [[1, 1, 1], [1, 2, 2], [2, 2, 2]],
            "n_conv_per_stage": [1, 2, 1], "n_conv_per_stage_decoder": [2, 1],
            "nonlin": "torch.nn.LeakyReLU",
            "nonlin_kwargs": {"negative_slope": 0.02},
            "norm_op_kwargs": {"eps": 1e-4}}


def _pair(arch, k=K, seed=0, in_ch=1):
    jnet = jax_net("PlainConvUNet", arch, (), in_ch, k, dtype=jnp.float32)
    tnet = port_factory.get_network_from_plans(
        "PlainConvUNet", arch, (), in_ch, k, compute_dtype=torch.float32)
    tree = plain_params(seed, in_ch=in_ch, arch=arch, k=k)
    params_from_jax(tnet, tree)
    return jnet, tnet, tree


def _jax_apply(jnet, tree, x, ds=False):
    fn = jax.jit(lambda p, v: jnet.apply(p, v, deep_supervision=ds))
    out = fn(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("arch,shape", [(ARCH, (2, 8, 8, 16, 1)),
                                        (ARCH_ODD, (1, 6, 12, 8, 2))])
def test_plain_net_matches_jax_fp32(arch, shape):
    """Logits of the full-res head; ARCH_ODD adds anisotropic kernels and
    strides, 2 input channels, a custom slope and eps."""
    jnet, tnet, tree = _pair(arch, in_ch=shape[-1])
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    with torch.no_grad():
        got = tnet(ncdhw(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1),
                               _jax_apply(jnet, tree, x), atol=3e-4)


def test_deep_supervision_heads_match_jax():
    jnet, tnet, tree = _pair(ARCH, seed=3)
    x = np.random.RandomState(2).randn(1, 8, 8, 16, 1).astype(np.float32)
    with torch.no_grad():
        got = tnet(ncdhw(x), deep_supervision=True)
    ref = _jax_apply(jnet, tree, x, ds=True)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.moveaxis(g.numpy(), 1, -1), r,
                                   atol=3e-4)


def test_carrier_rejects_a_mismatched_tree():
    _, tnet, tree = _pair(ARCH)
    bad = plain_params(0, arch={**ARCH, "features_per_stage": [8, 16, 16]})
    with pytest.raises(ValueError):
        params_from_jax(tnet, bad)
    del tree["params"]["decoder"]["seg_head_1"]
    with pytest.raises(ValueError):
        params_from_jax(tnet, tree)


def test_factory_resolves_reference_names_and_raises_for_the_rest():
    kw = dict(ARCH, conv_op="torch.nn.modules.conv.Conv3d",
              norm_op="torch.nn.modules.instancenorm.InstanceNorm3d")
    for name in ("dynamic_network_architectures.architectures.unet."
                 "PlainConvUNet", "LiteNNUNetStudent"):
        net = port_factory.get_network_from_plans(name, kw, (), 1, 3)
        assert isinstance(net, PlainConvUNet)
        assert net.compute_dtype == torch.bfloat16
        assert net.decoder.mods["seg_head_1"].weight.dtype == torch.bfloat16
        assert net.encoder.stages["stage_0"].blocks["block_0"].norm.weight \
            .dtype == torch.float32
    for name in ("ResidualEncoderUNet", "LiteResEncStudent"):
        assert isinstance(port_factory.get_network_from_plans(
            name, kw, (), 1, 3), ResidualEncoderUNet)
    with pytest.raises(NotImplementedError):
        port_factory.get_network_from_plans(
            "PlainConvUNet", dict(kw, conv_op="torch.nn.Conv2d",
                                  kernel_sizes=[[3, 3]] * 3,
                                  strides=[[1, 1]] + [[2, 2]] * 2), (), 1, 3)
    bn = port_factory.get_network_from_plans(
        "PlainConvUNet", dict(kw, norm_op="torch.nn.BatchNorm3d"), (), 1, 3)
    assert isinstance(bn.encoder.stages["stage_0"].blocks["block_0"].norm,
                      BatchStatsNorm)
    with pytest.raises(ValueError):
        port_factory.get_network_from_plans(
            "PlainConvUNet", dict(kw, norm_op="torch.nn.GroupNorm"), (), 1, 3)
    with pytest.raises(ValueError):
        port_factory.get_network_from_plans("UNetPlusPlus", kw, (), 1, 3)


def test_restore_golden_checkpoint_matches_jax():
    """The committed trained checkpoint through restore (numpy-only
    unpickler) gives the JAX network's logits."""
    import os
    from fast_nnunet_tpu.core.plans import PlansManager
    from fast_nnunet_tpu.training.checkpoint import load_checkpoint
    model = os.path.join(GOLDEN, "model")
    arch = PlansManager(os.path.join(model, "plans.json")).get_configuration(
        "3d_fullres").configuration["architecture"]
    tnet = port_factory.build_network_from_arch_dict(arch, 1, 3,
                                                     torch.float32)
    ckpt_path = os.path.join(model, "fold_0", "checkpoint_final.fnnx")
    ckpt = restore(tnet, ckpt_path)
    assert ckpt["trainer_name"]
    jnet = jax_net(arch["network_class_name"], arch["arch_kwargs"], (), 1, 3,
                   dtype=jnp.float32)
    tree = load_checkpoint(ckpt_path)["network_weights"]
    x = np.random.RandomState(4).randn(1, 16, 16, 16, 1).astype(np.float32)
    with torch.no_grad():
        got = tnet(ncdhw(x)).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1),
                               _jax_apply(jnet, tree, x), atol=3e-4)
