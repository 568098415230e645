"""Kernel A (fast_nnunet_tpu_torch/ops/stats.py) and the port's InstanceNorm:
the plain version against the Pallas spatial_sum_sumsq in interpret mode,
the norm against fast_nnunet_tpu.models.s2d._instance_norm (both moment
paths). The CUDA kernel is held against the plain version in
tests/test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.models.s2d import _instance_norm as jax_instance_norm
from fast_nnunet_tpu.ops.pallas_stats import spatial_sum_sumsq as jax_stats
from fast_nnunet_tpu_torch.models.s2d import instance_norm
from fast_nnunet_tpu_torch.ops.stats import spatial_sum_sumsq

from .torch_port_common import ncdhw


@pytest.mark.parametrize("shape", [(2, 8, 10, 12, 16),   # S = 960
                                   (1, 16, 16, 8, 24),   # S = 2048
                                   (3, 5, 7, 3, 130)])   # odd sizes, C > 128
def test_plain_matches_pallas_f32(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32) * 3 + 1.5
    s_j, q_j = jax_stats(jnp.asarray(x), interpret=True)
    s_t, q_t = spatial_sum_sumsq(ncdhw(x))
    # f32 sums of a few thousand terms in two summation orders
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=2e-5,
                               atol=1e-3)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=2e-5)


def test_plain_matches_pallas_bf16():
    rng = np.random.RandomState(1)
    xj = jnp.asarray(rng.randn(1, 64, 64, 4, 8), jnp.bfloat16)
    s_j, q_j = jax_stats(xj, interpret=True)
    xt = ncdhw(np.asarray(xj, np.float32)).bfloat16()
    s_t, q_t = spatial_sum_sumsq(xt)
    assert s_t.dtype == torch.float32 and q_t.dtype == torch.float32
    # same bf16 inputs summed in f32: the order differs, nothing else
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-5)


@pytest.mark.parametrize("groups,stats", [(8, False), (8, True),
                                          (1, False), (1, True)])
def test_instance_norm_matches_jax(groups, stats):
    """Both moment paths of the port (kernel A above the 4096-voxel gate,
    two-pass below) against the JAX norm (Pallas moments and default)."""
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 16, 16, 32, 16) * 2 + 1).astype(np.float32)  # S=8192
    scale = (rng.rand(16 // groups) + 0.5).astype(np.float32)
    bias = rng.randn(16 // groups).astype(np.float32)
    ref = np.asarray(jax_instance_norm(jnp.asarray(x), jnp.asarray(scale),
                                       jnp.asarray(bias), 1e-5,
                                       groups=groups, pallas_stats=stats))
    got = instance_norm(ncdhw(x), torch.from_numpy(scale),
                        torch.from_numpy(bias), 1e-5, groups=groups,
                        stats_min_voxels=4096 if stats else 1 << 30)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), ref,
                               rtol=2e-4, atol=2e-5)
