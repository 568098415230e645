"""Kernel D's plain version (the function the CUDA kernel is held to on the
card) against the JAX package's Pallas ``fused_scatter_accumulate`` in
interpret mode, on the four cases of tests/test_pallas_kernels.py, plus the
port's wider contract: overlapping tiles applied in batch order, checked
against a numpy loop. Tolerances: float32 rtol 1e-6; bfloat16 within one
bf16 ulp of the result's magnitude (XLA may round the product and the sum
at other points than the port's one rounding per add)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.ops.pallas_kernels import \
    fused_scatter_accumulate as jax_fused
from fast_nnunet_tpu_torch.ops.scatter_accumulate import (
    fused_scatter_accumulate, fused_scatter_accumulate_plain)

from .torch_port_common import (bf16_ulp,  # noqa: F401  (fixture)
                                no_persistent_compile_cache)


def _gauss_flat(gauss, C):
    px, py, pz = gauss.shape
    return np.ascontiguousarray(np.broadcast_to(
        gauss[..., None], (px, py, pz, C)).reshape(px, py, pz * C))


def _weight_channel_case():
    rng = np.random.RandomState(2)
    K, C = 5, 8
    logits_k = rng.rand(2, 16, 16, 16, K).astype(np.float32)
    lg = np.concatenate(
        [logits_k, np.ones((2, 16, 16, 16, 1), np.float32),
         np.zeros((2, 16, 16, 16, C - K - 1), np.float32)], -1)
    gauss = (rng.rand(16, 16, 16) + 0.5).astype(np.float32)
    return (np.zeros((32, 32, 32, C), np.float32), lg, gauss,
            np.array([[0, 0, 0], [0, 16, 16]], np.int32), 2)


def _cases():
    r0 = np.random.RandomState(0)
    r3 = np.random.RandomState(3)
    return {
        "matches_reference": (
            r0.rand(48, 48, 48, 8).astype(np.float32),
            r0.rand(3, 16, 16, 16, 8).astype(np.float32),
            r0.rand(16, 16, 16).astype(np.float32),
            np.array([[0, 0, 0], [16, 16, 16], [32, 32, 32]], np.int32), 3),
        "respects_n_real": (
            np.zeros((32, 32, 32, 8), np.float32),
            np.ones((4, 16, 16, 16, 8), np.float32),
            np.ones((16, 16, 16), np.float32),
            np.array([[0, 0, 0], [16, 16, 16], [16, 16, 16], [16, 16, 16]],
                     np.int32), 2),
        "bf16_weight_channel": _weight_channel_case(),
        "single_item": (
            r3.rand(16, 16, 16, 8).astype(np.float32),
            r3.rand(1, 16, 16, 16, 8).astype(np.float32),
            r3.rand(16, 16, 16).astype(np.float32),
            np.zeros((1, 3), np.int32), 1),
    }


@pytest.mark.parametrize("case", ["matches_reference", "respects_n_real",
                                  "bf16_weight_channel", "single_item"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(case, dtype):
    acc, lg, gauss, coords, n_real = _cases()[case]
    C = lg.shape[-1]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    gf = _gauss_flat(gauss, C)
    ref = np.asarray(jax_fused(
        jnp.asarray(acc, jdt), jnp.asarray(lg, jdt), jnp.asarray(gf, jdt),
        jnp.asarray(coords), n_real, interpret=True)).astype(np.float32)
    a = torch.from_numpy(acc).to(tdt)
    out = fused_scatter_accumulate(a, torch.from_numpy(lg).to(tdt),
                                   torch.from_numpy(gf).to(tdt), coords,
                                   n_real)
    assert out is a  # updated in place
    got = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    else:
        assert (np.abs(got - ref) <= bf16_ulp(ref)).all()
    if case == "respects_n_real":
        assert got.sum() == 2 * 16 ** 3 * 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overlapping_tiles_apply_in_batch_order(dtype):
    """Tiles that overlap (the JAX kernel forbids them; the port takes
    them) equal a numpy loop that applies them one after the other with the
    port's rounding, bit for bit."""
    rng = np.random.RandomState(5)
    C = 16
    acc = rng.randn(20, 24, 40, C).astype(np.float32)
    lg = rng.randn(4, 8, 12, 16, C).astype(np.float32)
    gauss = (rng.rand(8, 12, 16) * 10).astype(np.float32)
    coords = np.array([[0, 0, 0], [4, 6, 8], [4, 6, 8], [12, 12, 24]],
                      np.int32)
    tdt = getattr(torch, dtype)
    a = torch.from_numpy(acc.copy()).to(tdt)
    want = a.float().numpy().copy()
    lg_t = torch.from_numpy(lg).to(tdt)
    gf = torch.from_numpy(_gauss_flat(gauss, C)).to(tdt)
    got = fused_scatter_accumulate(a, lg_t, gf, coords, 4).float().numpy()

    lq = lg_t.float().numpy()
    gq = gf.float().numpy().reshape(8, 12, 16, C)
    for b in range(4):
        x, y, z = coords[b]
        sl = (slice(x, x + 8), slice(y, y + 12), slice(z, z + 16))
        s = want[sl] + lq[b] * gq  # f32 product exact for bf16 inputs
        want[sl] = torch.from_numpy(s).to(tdt).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    acc = torch.zeros(16, 16, 16, 8)
    lg = torch.zeros(2, 8, 8, 8, 8)
    gf = torch.zeros(8, 8, 64)
    ok = np.zeros((2, 3), np.int32)
    with pytest.raises(ValueError):  # C not a multiple of 8
        fused_scatter_accumulate_plain(torch.zeros(16, 16, 16, 6),
                                       torch.zeros(2, 8, 8, 8, 6),
                                       torch.zeros(8, 8, 48), ok, 2)
    with pytest.raises(ValueError):  # tile outside the accumulator
        fused_scatter_accumulate(acc, lg, gf, np.array([[0, 0, 0], [9, 0, 0]],
                                                       np.int32), 2)
    with pytest.raises(ValueError):  # n_real beyond the batch
        fused_scatter_accumulate(acc, lg, gf, ok, 3)
    with pytest.raises(TypeError):  # logits not in acc's dtype
        fused_scatter_accumulate(acc, lg.bfloat16(), gf, ok, 2)
    with pytest.raises(ValueError):  # wrong gaussian shape
        fused_scatter_accumulate(acc, lg, torch.zeros(8, 8, 8), ok, 2)
    # a padded slot may lie anywhere: it is never read
    fused_scatter_accumulate(acc, lg, gf, np.array([[0, 0, 0], [99, 0, 0]],
                                                   np.int32), 1)
