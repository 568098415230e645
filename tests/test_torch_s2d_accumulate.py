"""Kernel C (fast_nnunet_tpu_torch/ops/s2d_accumulate.py): the plain version
in f32 mode against the Pallas fused_head_gauss_accumulate in interpret mode,
in bf16 mode against a jitted replica of the JAX sweep's XLA accumulate_batch
(overlapping tiles, padded slots). The CUDA kernel is held bit-exact against
the plain version in tests/test_torch_kernels_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.models.s2d import _seg_head_grouped
from fast_nnunet_tpu.ops.pallas_s2d import fused_head_gauss_accumulate
from fast_nnunet_tpu_torch.ops.s2d_accumulate import (s2d_accumulate,
                                                      s2d_accumulate_plain,
                                                      seg_head_blocks)

from .torch_port_common import bf16_ulp


def _mk(B=3, p0h=4, pyh=4, pzh=8, K=3, F=2, Yh=16, Zh=24, seed=0):
    """acc, channels-last feats (the JAX layout), gaussian, block-diagonal
    head (8F, 8K), bias."""
    rng = np.random.RandomState(seed)
    acc = rng.randn(p0h, Yh, Zh, 8 * K).astype(np.float32)
    feats = rng.randn(B, p0h, pyh, pzh, 8 * F).astype(np.float32)
    g = np.abs(rng.randn(p0h, pyh, pzh, 8)).astype(np.float32)
    w = np.zeros((8 * F, 8 * K), np.float32)
    for o in range(8):
        w[o * F:(o + 1) * F, o * K:(o + 1) * K] = rng.randn(F, K) * 0.3
    b = (rng.randn(8 * K) * 0.1).astype(np.float32)
    return acc, feats, g, w, b


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _port_args(feats, w, b, dtype=torch.float32):
    f = torch.from_numpy(np.ascontiguousarray(feats.transpose(0, 4, 1, 2, 3)))
    return (f.to(dtype), seg_head_blocks(torch.from_numpy(w)),
            torch.from_numpy(b))


def test_f32_mode_matches_pallas():
    acc, feats, g, w, b = _mk()
    feats, w, b = _bf16(feats), _bf16(w), _bf16(b)
    coords = np.array([[0, 8], [4, 8], [0, 8]], np.int32)  # slot 2 padded
    ref = fused_head_gauss_accumulate(
        jnp.asarray(acc), jnp.asarray(feats, jnp.bfloat16), jnp.asarray(g),
        jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        jnp.asarray(coords), jnp.int32(2), interpret=True)
    f, wb, bb = _port_args(feats, w, b, torch.bfloat16)
    got = s2d_accumulate(torch.from_numpy(acc.copy()), f,
                         torch.from_numpy(g), wb, bb, coords, [1, 1, 0])
    # the Pallas kernel fuses multiply-add; f32 rounding apart, equal
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@jax.jit
def _xla_accumulate_batch(a, feats, g_s2d, w, b, coords, valid):
    """The JAX sweep's bf16 accumulate_batch (fast_nnunet_tpu/inference/
    turbo.py:653-671), op for op, on explicit per-tile (yh0, zh0)."""
    B, p0h, pyh, pzh, _ = feats.shape
    C8 = w.shape[1]
    K = C8 // 8
    for t in range(B):
        y = _seg_head_grouped(feats[t], w, b, K).astype(jnp.float32)
        y = y.reshape(p0h, pyh, pzh, 8, K)
        gw = (g_s2d * valid[t])[..., None]
        contrib = (y * gw).astype(a.dtype).reshape(p0h, pyh, pzh, C8)
        start = (0, coords[t, 0], coords[t, 1], 0)
        cur = jax.lax.dynamic_slice(a, start, (p0h, pyh, pzh, C8))
        a = jax.lax.dynamic_update_slice(a, cur + contrib, start)
    return a


def test_bf16_mode_matches_xla_sequence():
    """Overlapping tiles in one batch plus a padded slot (validity 0).

    Compiled with XLA's nominal bf16 roundings (excess precision off) the
    JAX sequence and the port agree bit for bit. XLA's default CPU build
    keeps some bf16 intermediates in f32 (allow_excess_precision), which
    moves ~3% of the elements by up to 16 bf16 ulps of the accumulator's
    magnitude on this input; that is the tolerance against the default."""
    acc, feats, g, w, b = _mk(B=4, seed=1)
    g = g * 10.0  # the sweep's x10 gaussian for 16-bit accumulators
    acc, feats, w, b = _bf16(acc), _bf16(feats), _bf16(w), _bf16(b)
    coords = np.array([[0, 0], [2, 4], [3, 8], [3, 8]], np.int32)
    valid = np.array([1, 1, 1, 0], np.float32)
    args = (jnp.asarray(acc, jnp.bfloat16), jnp.asarray(feats, jnp.bfloat16),
            jnp.asarray(g), jnp.asarray(w, jnp.bfloat16),
            jnp.asarray(b, jnp.bfloat16), jnp.asarray(coords),
            jnp.asarray(valid))
    nominal = _xla_accumulate_batch.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    ref = np.asarray(nominal(*args), np.float32)
    f, wb, bb = _port_args(feats, w, b, torch.bfloat16)
    got = s2d_accumulate(torch.from_numpy(acc).bfloat16(), f,
                         torch.from_numpy(g), wb, bb, coords,
                         valid).float().numpy()
    np.testing.assert_array_equal(got, ref)

    default = np.asarray(_xla_accumulate_batch(*args), np.float32)
    ulps = np.abs(got - default) / bf16_ulp(np.maximum(np.abs(acc),
                                                       np.abs(default)))
    assert ulps.max() <= 16, ulps.max()
    assert (ulps > 0).mean() < 0.05, (ulps > 0).mean()


def test_row_base_is_a_rotation():
    acc, feats, g, w, b = _mk(seed=2)
    coords = np.array([[0, 0], [6, 12], [2, 4]], np.int32)
    f, wb, bb = _port_args(feats, w, b)
    ref = s2d_accumulate_plain(torch.from_numpy(acc.copy()), f,
                               torch.from_numpy(g), wb, bb, coords, [1, 1, 1])
    rolled = torch.from_numpy(np.roll(acc, 3, axis=0).copy())
    got = s2d_accumulate_plain(rolled, f, torch.from_numpy(g), wb, bb,
                               coords, [1, 1, 1], row_base=3)
    np.testing.assert_array_equal(np.roll(got.numpy(), -3, axis=0),
                                  ref.numpy())


def test_bad_coords_raise():
    acc, feats, g, w, b = _mk()
    f, wb, bb = _port_args(feats, w, b)
    with pytest.raises(ValueError):
        s2d_accumulate(torch.from_numpy(acc), f, torch.from_numpy(g), wb, bb,
                       [[0, 20], [0, 0], [0, 0]], [1, 1, 1])


def test_seg_head_blocks_round_trip():
    w = torch.zeros(8 * 3, 8 * 5)
    blocks = torch.randn(8, 3, 5)
    for o in range(8):
        w[o * 3:(o + 1) * 3, o * 5:(o + 1) * 5] = blocks[o]
    assert torch.equal(seg_head_blocks(w), blocks)
