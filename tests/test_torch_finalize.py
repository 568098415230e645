"""Kernel B (fast_nnunet_tpu_torch/ops/finalize.py): the plain version is
held bit-exact against the Pallas grouped_argmax in interpret mode (the CUDA
kernel against the plain version: tests/test_torch_kernels_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.ops.pallas_finalize import grouped_argmax as jax_argmax
from fast_nnunet_tpu_torch.ops.finalize import (grouped_argmax,
                                                grouped_argmax_plain)

from . import torch_port_common  # noqa: F401  (caps torch threads)


def _acc(shape, K, seed, c8p):
    rng = np.random.RandomState(seed)
    acc = np.zeros(shape[:3] + (c8p,), np.float32)
    acc[..., :8 * K] = rng.randn(*shape[:3], 8 * K)
    return acc


@pytest.mark.parametrize("dtype,c8p", [("float32", 128),   # padded lanes
                                       ("bfloat16", 40)])  # exact 8K
def test_plain_matches_pallas(dtype, c8p):
    K = 5
    acc = _acc((4, 16, 16), K, 0, c8p)
    jacc = jnp.asarray(acc, getattr(jnp, dtype))
    tacc = torch.from_numpy(np.asarray(jacc, np.float32)).to(
        getattr(torch, dtype))
    for n_rows in (2, 4):
        ref = np.asarray(jax_argmax(jacc, K, n_rows, y_block=8,
                                    interpret=True))
        got = grouped_argmax(tacc, K, n_rows).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


def test_plain_ties_take_first():
    K = 3
    acc = np.zeros((1, 8, 8, 24), np.float32)
    acc[0, :4, :, 1 * K + 2] = 1.0  # offset 1: tie between classes ... 2 wins
    acc[0, :4, :, 1 * K + 0] = 1.0  # ... unless 0 ties it: lowest index wins
    ref = np.asarray(jax_argmax(jnp.asarray(acc), K, 1, y_block=8,
                                interpret=True))
    got = grouped_argmax_plain(torch.from_numpy(acc), K, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got == 0).all()


def test_plain_cyclic_zero_and_rebase():
    K = 3
    acc = np.random.RandomState(5).randn(4, 8, 8, 24).astype(np.float32)
    cls_j, acc_j = jax_argmax(jnp.asarray(acc), K, 3, row_base=1, n_zero=2,
                              y_block=8, interpret=True)
    tacc = torch.from_numpy(acc.copy())
    cls_t = grouped_argmax(tacc, K, 3, row_base=1, n_zero=2)
    np.testing.assert_array_equal(cls_t.numpy(), np.asarray(cls_j))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(acc_j))
    # wrap-around: base 3 reads physical rows 3, 0
    cls_j = jax_argmax(jnp.asarray(acc), K, 2, row_base=3, y_block=8,
                       interpret=True)
    np.testing.assert_array_equal(
        grouped_argmax(torch.from_numpy(acc.copy()), K, 2, row_base=3).numpy(),
        np.asarray(cls_j))


def test_bad_geometry_raises():
    acc = torch.zeros(2, 8, 8, 24)
    with pytest.raises(ValueError):
        grouped_argmax(acc, 4, 1)       # 8K = 32 > 24 lanes
    with pytest.raises(ValueError):
        grouped_argmax(acc, 3, 1, n_zero=2)
