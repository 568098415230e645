"""The training form of the port's network pieces: the one-pass InstanceNorm
(kernel A's statistics under ``SpatialSumSumsq``, plain version on the CPU)
against the JAX block's ``onepass=True`` form, forward and gradient (float32,
1e-5); ``torch.autograd.gradcheck`` of ``SpatialSumSumsq`` in float64;
``remat`` (torch.utils.checkpoint per stack) changing no value; the
trainable network's float32 master weights; ``params_to_jax`` inverting
``params_from_jax``; and the He-normal initialisation's statistics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.models.blocks import InstanceNorm as JaxInstanceNorm
from fast_nnunet_tpu_torch.models import factory as pfactory
from fast_nnunet_tpu_torch.models.blocks import (InstanceNorm,
                                                 instance_norm_onepass)
from fast_nnunet_tpu_torch.models.s2d import STATS_MIN_VOXELS
from fast_nnunet_tpu_torch.models.unet import (REMAT_MODES, init_he_normal_,
                                               params_from_jax,
                                               params_to_jax)
from fast_nnunet_tpu_torch.ops import stats

from .torch_port_common import (ARCH, K,  # noqa: F401  (fixture)
                                no_persistent_compile_cache, plain_params)

TOL = 1e-5


@pytest.mark.parametrize("spatial", [(4, 4, 4), (16, 16, 16), (8, 24, 32)])
def test_onepass_instance_norm_matches_jax(spatial):
    """Below the 4096-voxel gate the statistics come from torch, at and above
    it from SpatialSumSumsq; both match the JAX one-pass form, values and
    gradients with respect to the input, scale and bias."""
    rng = np.random.RandomState(sum(spatial))
    C = 3
    x = (rng.randn(2, *spatial, C) * 2 + 0.5).astype(np.float32)
    scale = rng.rand(C).astype(np.float32) + 0.5
    bias = rng.randn(C).astype(np.float32)
    w = rng.randn(2, *spatial, C).astype(np.float32)

    mod = JaxInstanceNorm(onepass=True)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}

    def jloss(p, xx):
        return jnp.sum(mod.apply(p, xx) * w)

    jy = np.asarray(mod.apply(params, jnp.asarray(x)))
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    px = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))
                          ).requires_grad_()
    ps = torch.from_numpy(scale).requires_grad_()
    pb = torch.from_numpy(bias).requires_grad_()
    n0 = stats.spatial_sum_sumsq.launches
    y = instance_norm_onepass(px, ps, pb, 1e-5)
    (y * torch.from_numpy(np.ascontiguousarray(np.moveaxis(w, -1, 1)))
     ).sum().backward()
    assert stats.spatial_sum_sumsq.launches == n0  # CPU: plain version only
    np.testing.assert_allclose(np.moveaxis(y.detach().numpy(), 1, -1), jy,
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(np.moveaxis(px.grad.numpy(), 1, -1),
                               np.asarray(gx), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ps.grad.numpy(),
                               np.asarray(gp["params"]["scale"]), rtol=TOL,
                               atol=1e-4)
    np.testing.assert_allclose(pb.grad.numpy(),
                               np.asarray(gp["params"]["bias"]), rtol=TOL,
                               atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 6), (1, 2, 7, 3)])
def test_spatial_sum_sumsq_gradcheck(shape):
    """The autograd Function's backward (g_sum + 2 x g_sumsq) in float64."""
    x = torch.randn(shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    assert torch.autograd.gradcheck(stats.SpatialSumSumsq.apply,
                                    (x.requires_grad_(),))


def test_spatial_sum_sumsq_backward_keeps_dtype():
    """bf16 input: the gradient is computed in float32 and returned in
    bf16, equal to the float32 formula rounded once."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 5, 6, 7, generator=g).bfloat16().requires_grad_()
    gs, gq = torch.randn(2, 3, generator=g), torch.randn(2, 3, generator=g)
    s, q = stats.SpatialSumSumsq.apply(x)
    assert s.dtype == q.dtype == torch.float32
    (s * gs + q * gq).sum().backward()
    want = (gs[..., None, None, None]
            + 2 * x.detach().float() * gq[..., None, None, None]).bfloat16()
    assert x.grad.dtype == torch.bfloat16
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)


def test_norm_gate_is_kernel_a_gate():
    """The training norm switches to SpatialSumSumsq at the s2d gate."""
    norm = InstanceNorm(2, onepass=True)
    assert STATS_MIN_VOXELS == 4096
    calls = []
    real = stats.SpatialSumSumsq.apply

    def spy(x):
        calls.append(tuple(x.shape))
        return real(x)

    stats.SpatialSumSumsq.apply = spy
    try:
        norm(torch.randn(1, 2, 16, 16, 15))   # 3840 voxels: torch mean
        norm(torch.randn(1, 2, 16, 16, 16))   # 4096: kernel A's contract
    finally:
        stats.SpatialSumSumsq.apply = real
    assert calls == [(1, 2, 16, 16, 16)]


def _train_net(remat, tree, dtype=torch.float32, onepass=True):
    net = pfactory.get_network_from_plans(
        "PlainConvUNet", ARCH, (), 1, K, compute_dtype=dtype,
        norm_onepass=onepass, remat=remat, trainable=True)
    return params_from_jax(net, tree)


@pytest.mark.parametrize("remat", [m for m in REMAT_MODES if m is not False])
def test_remat_changes_no_value(remat):
    """Checkpointed stacks recompute the same forward: loss and gradients
    equal the remat-off network's bit for bit."""
    tree = plain_params(5)
    x = torch.from_numpy(np.random.RandomState(6).randn(
        2, 1, 16, 16, 16).astype(np.float32))
    grads = []
    for mode in (False, remat):
        net = _train_net(mode, tree)
        out = net(x, deep_supervision=True)
        (out[0].square().mean() + out[1].mean()).backward()
        grads.append([p.grad.clone() for p in net.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_rule_per_stack():
    """True checkpoints every stack, "encoder" the encoder's, "light" the
    encoder's and the full-resolution decoder stack (``stage_1`` of a
    3-stage net); False none."""
    tree = plain_params(5)
    for mode, dec in ((False, [False, False]), (True, [True, True]),
                      ("encoder", [False, False]), ("light", [False, True])):
        net = _train_net(mode, tree)
        enc = [s.remat for s in net.encoder.stages.values()]
        assert enc == [bool(mode)] * 3
        assert [net.decoder.mods[f"stage_{d}"].remat for d in (0, 1)] == dec
    with pytest.raises(ValueError):
        _train_net("full", tree)


def test_trainable_net_keeps_float32_masters():
    """bf16 compute with float32 parameters that take gradients; the
    inference form holds its conv weights in bf16 and no gradients; both
    give the same logits (cast to float32 at the heads) for the same
    weights and the same (two-pass) norm."""
    tree = plain_params(8)
    train = _train_net(False, tree, torch.bfloat16, onepass=False)
    infer = params_from_jax(pfactory.get_network_from_plans(
        "PlainConvUNet", ARCH, (), 1, K, compute_dtype=torch.bfloat16), tree)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train.parameters())
    assert train.encoder.stages["stage_0"].blocks["block_0"].conv.weight \
        .dtype == torch.float32
    assert infer.encoder.stages["stage_0"].blocks["block_0"].conv.weight \
        .dtype == torch.bfloat16
    assert not any(p.requires_grad for p in infer.parameters())
    x = torch.randn(1, 1, 16, 16, 16)
    with torch.no_grad():
        a, b = train(x), infer(x)
    assert a.dtype == b.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_params_to_jax_inverts_params_from_jax():
    tree = plain_params(9)
    back = params_to_jax(_train_net(True, tree))
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(v, flat_b[path])


def test_he_normal_init_statistics():
    """Kernels N(0, 2 / ((1 + 0.01^2) fan_in)), biases 0, norm scales 1,
    as the JAX package's he_normal_init; seeded, device-independent."""
    net = _train_net(False, plain_params(0))
    init_he_normal_(net, 3)
    w = net.encoder.stages["stage_1"].blocks["block_1"].conv.weight.detach()
    fan_in = 16 * 27
    assert abs(float(w.std()) / np.sqrt(2 / 1.0001 / fan_in) - 1) < 0.05
    assert float(net.decoder.mods["seg_head_0"].bias.detach().abs().max()) \
        == 0
    assert float(net.encoder.stages["stage_0"].blocks["block_0"].norm
                 .weight.detach().min()) == 1.0
    again = init_he_normal_(_train_net(False, plain_params(0)), 3)
    torch.testing.assert_close(again.encoder.stages["stage_1"].blocks[
        "block_1"].conv.weight.detach(), w, rtol=0, atol=0)
