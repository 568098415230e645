"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs an NVIDIA GPU and skips without one; the
file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from fast_nnunet_tpu_torch.ops.finalize import (grouped_argmax,
                                                grouped_argmax_plain)
from fast_nnunet_tpu_torch.ops.s2d_accumulate import (s2d_accumulate,
                                                      s2d_accumulate_plain)
from fast_nnunet_tpu_torch.ops.stats import (spatial_sum_sumsq,
                                             spatial_sum_sumsq_plain)

from .torch_port_common import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


# ------------------------------------------------------------ kernel A: stats
@pytest.mark.parametrize("dtype,shape", [("bfloat16", (2, 16, 24, 24, 40)),
                                         ("float32", (2, 8, 9, 7, 5))])
def test_stats_matches_plain(cuda_device, dtype, shape):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=g) * 2 + 1).to(getattr(torch, dtype))
    n0 = spatial_sum_sumsq.launches
    s, q = spatial_sum_sumsq(x.to(cuda_device))
    assert spatial_sum_sumsq.launches == n0 + 1
    s_ref, q_ref = spatial_sum_sumsq_plain(x)
    scale = x.float().abs().reshape(shape[0], shape[1], -1).sum(-1)
    # f32 sums in two orders: within 1e-5 of the row's absolute sum
    assert ((s.cpu() - s_ref).abs() <= 1e-5 * scale + 1e-6).all()
    assert ((q.cpu() - q_ref).abs() <= 1e-5 * q_ref + 1e-6).all()


def test_stats_layout_is_checked(cuda_device):
    x = torch.zeros(1, 4, 4, 4, 4, device=cuda_device)
    with pytest.raises(ValueError):
        spatial_sum_sumsq(x.to(memory_format=torch.channels_last_3d))


# ---------------------------------------------------------- kernel B: argmax
@pytest.mark.parametrize("dtype,c8p", [("float32", 128), ("bfloat16", 40)])
def test_finalize_bit_equals_plain(cuda_device, dtype, c8p):
    K = 5
    rng = np.random.RandomState(1)
    acc = np.zeros((6, 16, 24, c8p), np.float32)
    acc[..., :8 * K] = rng.randn(6, 16, 24, 8 * K)
    acc[0, 0, 0, :K] = 0.0  # a tie inside offset 0
    acc = torch.from_numpy(acc).to(getattr(torch, dtype))
    a_gpu = acc.to(cuda_device)
    n0 = grouped_argmax.launches
    got = grouped_argmax(a_gpu, K, 4, row_base=3, n_zero=2).cpu()
    assert grouped_argmax.launches == n0 + 1
    a_cpu = acc.clone()
    ref = grouped_argmax_plain(a_cpu, K, 4, row_base=3, n_zero=2)
    assert torch.equal(got, ref)
    assert torch.equal(a_gpu.cpu(), a_cpu)  # the same rows zeroed


# ------------------------------------------------------ kernel C: accumulate
@pytest.mark.parametrize("feat_dtype,acc_dtype", [
    ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
    ("float32", "float32")])
def test_accumulate_bit_equals_plain(cuda_device, feat_dtype, acc_dtype):
    B, p0h, pyh, pzh, K, F, Yh, Zh = 5, 6, 8, 16, 7, 4, 24, 40
    rng = np.random.RandomState(4)
    acc = rng.randn(p0h, Yh, Zh, 8 * K).astype(np.float32)
    feats = rng.randn(B, 8 * F, p0h, pyh, pzh).astype(np.float32)
    g = np.abs(rng.randn(p0h, pyh, pzh, 8)).astype(np.float32) * 10
    w = torch.from_numpy((rng.randn(8, F, K) * 0.3).astype(np.float32))
    b = torch.from_numpy((rng.randn(8 * K) * 0.1).astype(np.float32))
    coords = np.array([[0, 0], [4, 8], [8, 24], [16, 20], [16, 20]],
                      np.int32)  # overlapping tiles; the last slot padded
    valid = np.array([1, 1, 1, 1, 0], np.float32)
    f = torch.from_numpy(feats).to(getattr(torch, feat_dtype))
    a0 = torch.from_numpy(acc).to(getattr(torch, acc_dtype))
    gt = torch.from_numpy(g)
    ref = s2d_accumulate_plain(a0.clone(), f, gt, w, b, coords, valid,
                               row_base=4)
    n0 = s2d_accumulate.launches
    got = s2d_accumulate(a0.to(cuda_device), f.to(cuda_device),
                         gt.to(cuda_device), w.to(cuda_device),
                         b.to(cuda_device), coords, valid, row_base=4).cpu()
    assert s2d_accumulate.launches == n0 + 1
    assert torch.equal(got, ref)

