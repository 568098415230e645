"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs an NVIDIA GPU and skips without one; the
file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
from fast_nnunet_tpu_torch.ops.finalize import (grouped_argmax,
                                                grouped_argmax_plain)
from fast_nnunet_tpu_torch.ops.s2d_accumulate import (s2d_accumulate,
                                                      s2d_accumulate_plain)
from fast_nnunet_tpu_torch.ops.scatter_accumulate import (
    fused_scatter_accumulate, fused_scatter_accumulate_plain)
from fast_nnunet_tpu_torch.ops.stats import (spatial_sum_sumsq,
                                             spatial_sum_sumsq_plain)

from .torch_port_common import (ARCH, K,  # noqa: F401  (fixture)
                                cuda_device, plain_params)

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


# --------------------------------------------- kernel D: scatter-accumulate
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("coords,n_real", [
    # disjoint same-coset tiles at 16-aligned starts, one padded slot
    ([[0, 0, 0], [0, 16, 32], [0, 32, 0], [0, 32, 0]], 3),
    # overlapping tiles, applied in batch order; odd starts
    ([[0, 0, 0], [3, 5, 7], [3, 5, 7], [8, 19, 40]], 4)])
def test_scatter_accumulate_bit_equals_plain(cuda_device, dtype, coords,
                                             n_real):
    B, px, py, pz, C = 4, 12, 16, 32, 16
    rng = np.random.RandomState(6)
    tdt = getattr(torch, dtype)
    acc = torch.from_numpy(rng.randn(24, 48, 72, C).astype(np.float32)
                           ).to(tdt)
    lg = torch.from_numpy(rng.randn(B, px, py, pz, C).astype(np.float32)
                          ).to(tdt)
    g = np.abs(rng.randn(px, py, pz)).astype(np.float32) * 10
    gf = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        g[..., None], (px, py, pz, C)).reshape(px, py, pz * C))).to(tdt)
    coords = np.array(coords, np.int32)
    ref = fused_scatter_accumulate_plain(acc.clone(), lg, gf, coords, n_real)
    n0 = fused_scatter_accumulate.launches
    got = fused_scatter_accumulate(acc.to(cuda_device), lg.to(cuda_device),
                                   gf.to(cuda_device), coords, n_real).cpu()
    assert fused_scatter_accumulate.launches == n0 + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("patch", [(16, 32, 32), (8, 8, 16)])
def test_fused_sweep_launches_kernel_d_on_every_batch(cuda_device, patch):
    """The fused plain sweep on the card, on the quantised grid (y/z
    strides 16) and on the reference grid (a patch under 32, strides under
    16): one kernel D launch per tile batch and x-chunk, and the mask of
    the CPU (plain-version) run, fp32 with TF32 off, agreement >= 0.999."""
    tree = plain_params(8)
    vol = np.random.RandomState(8).randn(1, 24, 40, 44).astype(np.float32)
    masks, n_k = {}, 0
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in (cuda_device, torch.device("cpu")):
            net = get_network_from_plans("PlainConvUNet", ARCH, (), 1, K,
                                         compute_dtype=torch.float32).to(dev)
            eng = SlidingWindowEngine(net, patch, K,
                                      compute_dtype=torch.float32,
                                      sweep_acc_dtype=torch.float32,
                                      shape_bucket=16, tile_batch=2,
                                      use_fused_accumulate=True, device=dev)
            n0 = fused_scatter_accumulate.launches
            masks[dev.type] = eng.predict_segmentation_sweep(tree, vol)
            if dev.type == "cuda":
                n_k = fused_scatter_accumulate.launches - n0
                _, starts_x, coords_b, _, fused = eng._sweep_grid(
                    vol.shape[1:])
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    assert fused and n_k == len(starts_x) * len(coords_b) > 0
    assert (masks["cuda"] == masks["cpu"]).mean() >= 0.999


def test_scatter_accumulate_rejects_what_it_cannot_take(cuda_device):
    acc = torch.zeros(16, 16, 16, 8, device=cuda_device)
    lg = torch.zeros(2, 8, 8, 8, 8, device=cuda_device)
    gf = torch.zeros(8, 8, 64, device=cuda_device)
    ok = np.zeros((2, 3), np.int32)
    with pytest.raises(ValueError):  # gaussian left on the host
        fused_scatter_accumulate(acc, lg, gf.cpu(), ok, 2)
    with pytest.raises(ValueError):  # a strided view of the accumulator
        fused_scatter_accumulate(acc[:, :, ::2], lg, gf, ok, 2)
    n0 = fused_scatter_accumulate.launches
    fused_scatter_accumulate(acc, lg, gf, ok, 0)  # nothing to launch
    assert fused_scatter_accumulate.launches == n0

