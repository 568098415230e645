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


def _stats_within_tolerance(got, x):
    s, q = got
    s_ref, q_ref = spatial_sum_sumsq_plain(x)
    scale = x.float().abs().reshape(x.shape[0], x.shape[1], -1).sum(-1)
    return bool(((s - s_ref).abs() <= 1e-5 * scale + 1e-6).all()
                and ((q - q_ref).abs() <= 1e-5 * q_ref + 1e-6).all())


@pytest.mark.parametrize("B,C,S,dtype,k,offset", [
    (1, 1, 300000, "bfloat16", None, 0),   # one row, the plan splits it
    (1, 1, 300001, "bfloat16", None, 0),   # ... rows not whole 16 B units
    (1, 1, 300000, "bfloat16", None, 1),   # ... a view 2 bytes off alignment
    (1, 2, 70001, "float32", 8, 0),        # 2 rows, 8 blocks each, ragged
    (2, 1, 4099, "bfloat16", 2, 0),
    (2, 16, 65536, "float32", None, 0),    # 32 rows (split by the plan)
    (2, 16, 160 * 96 * 96, "bfloat16", None, 0),  # the student's stage 0
    (2, 32, 40000, "bfloat16", 8, 0),      # 64 rows, 8 blocks each
    (2, 32, 4097, "bfloat16", 4, 0),       # ... ragged
    (2, 32, 100, "float32", 8, 0),         # S under one block's stride
])
def test_stats_split_matches_plain(cuda_device, B, C, S, dtype, k, offset):
    """The cluster split (k blocks per row, rank 0 combining the partials
    through distributed shared memory) against the plain version, on the
    16-byte and the element path; k None is the wrapper's own plan."""
    from fast_nnunet_tpu_torch.ops import _build
    from fast_nnunet_tpu_torch.ops.stats import _launch, _split_plan
    g = torch.Generator(device=cuda_device).manual_seed(1)
    n = B * C * S
    base = torch.randn(n + offset, generator=g, device=cuda_device) * 2 + 1
    x = base.to(getattr(torch, dtype))[offset:].view(B, C, S)
    if k is None:
        n0 = spatial_sum_sumsq.launches
        got = spatial_sum_sumsq(x)
        assert spatial_sum_sumsq.launches == n0 + 1
    else:
        out = torch.empty((2, B, C), device=cuda_device)
        plan = _split_plan(B * C, S, x.element_size(), k,
                           x.data_ptr() % 16 == 0)
        _launch(x, _build.dtype_code(x), B * C, S, plan, out)
        got = (out[0], out[1])
    assert _stats_within_tolerance(got, x)


def test_stats_near_constant_row_at_the_training_shape(cuda_device):
    """A nearly constant bf16 activation (air: 0.7 + 1e-3 noise) at the
    teacher's widest training call: each thread's partials all round the
    same way, which the per-thread compensation holds off."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = (0.7 + 1e-3 * torch.randn((2, 32, 160, 96, 96), generator=g,
                                  device=cuda_device)).bfloat16()
    assert _stats_within_tolerance(spatial_sum_sumsq(x), x)


@pytest.mark.parametrize("shape", [(2, 32, 160, 96, 96), (2, 64, 80, 48, 48),
                                   (8, 128, 80, 48, 48)])
def test_stats_two_calls_bit_equal(cuda_device, shape):
    """Split (the plan's k = 4 and k = 2) and unsplit (the serving call): a
    fixed reduction order, so two calls give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(shape, generator=g, device=cuda_device).bfloat16()
    a, b = spatial_sum_sumsq(x), spatial_sum_sumsq(x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert _stats_within_tolerance(a, x)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,k", [
    ((12, 32, 512, 512), None),     # a 2d configuration's stage 0 (k = 1)
    ((12, 64, 256, 256), None),
    ((2, 3, 64, 64), None),         # few rows: the plan splits them
    ((2, 8, 128, 96), 4),           # a forced split of 4-D rows
    ((3, 5, 67, 61), 2),            # ... ragged rows on the element path
])
def test_stats_4d_matches_plain(cuda_device, dtype, shape, k):
    """Kernel A on (B, C, H, W) activations (the 2D networks' norms):
    against the plain version within the kernel's tolerance, and bit-equal
    over two calls; k None is the wrapper's own plan."""
    from fast_nnunet_tpu_torch.ops import _build
    from fast_nnunet_tpu_torch.ops.stats import _launch, _split_plan
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 1).to(
        getattr(torch, dtype))
    rows, S = shape[0] * shape[1], shape[2] * shape[3]

    def call():
        if k is None:
            n0 = spatial_sum_sumsq.launches
            got = spatial_sum_sumsq(x)
            assert spatial_sum_sumsq.launches == n0 + 1
            return got
        out = torch.empty((2, shape[0], shape[1]), device=cuda_device)
        _launch(x, _build.dtype_code(x), rows, S,
                _split_plan(rows, S, x.element_size(), k), out)
        return out[0], out[1]

    a, b = call(), call()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert _stats_within_tolerance(a, x)


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


def _c_case(B, K, F, feat_dtype, acc_dtype, coords, valid, p0h=4, pyh=12,
            pzh=40, Yh=40, Zh=72, c8p=None, w_kind="bf16", seed=11):
    rng = np.random.RandomState(seed)
    c8p = c8p or 8 * K
    acc = np.zeros((p0h, Yh, Zh, c8p), np.float32)
    acc[..., :8 * K] = rng.randn(p0h, Yh, Zh, 8 * K)
    w = torch.from_numpy((rng.randn(8, F, K) * 0.3).astype(np.float32))
    if w_kind == "bf16":  # the main path's head: bf16 (the fused dot)
        w = w.bfloat16()
    elif w_kind == "bf16_values":  # the same values as f32: not fused
        w = w.bfloat16().float()
    b = torch.from_numpy((rng.randn(8 * K) * 0.1).astype(np.float32))
    feats = torch.from_numpy(rng.randn(B, 8 * F, p0h, pyh, pzh).astype(
        np.float32)).to(getattr(torch, feat_dtype))
    g = torch.from_numpy(np.abs(rng.randn(p0h, pyh, pzh, 8)).astype(
        np.float32) * 10)
    a0 = torch.from_numpy(acc).to(getattr(torch, acc_dtype))
    args = (feats, g, w, b, np.array(coords, np.int32),
            np.array(valid, np.float32))
    return a0, args


@pytest.mark.parametrize("case", [
    # bf16 features, bf16 weights (FMA branch); overlapping tiles whose
    # z-spans start off the 16-voxel segment grid; one invalid slot inside
    dict(B=6, K=61, F=16, feat_dtype="bfloat16", acc_dtype="bfloat16",
         coords=[[0, 0], [6, 20], [6, 20], [14, 32], [28, 5], [20, 27]],
         valid=[1, 1, 0, 1, 1, 1], row_base=3),
    dict(B=6, K=61, F=16, feat_dtype="bfloat16", acc_dtype="float32",
         coords=[[0, 0], [6, 20], [6, 20], [14, 32], [28, 5], [20, 27]],
         valid=[1, 1, 0, 1, 1, 1], row_base=3),
    # tile z-spans on the 8-z grid (16-byte feature runs), overlapping
    dict(B=5, K=61, F=16, feat_dtype="bfloat16", acc_dtype="bfloat16",
         coords=[[0, 0], [6, 8], [6, 24], [14, 32], [20, 16]],
         valid=[1, 1, 1, 0, 1], row_base=1),
    # pzh = 36: z-rows not whole 16-byte chunks, features loaded z by z
    dict(B=3, K=7, F=8, feat_dtype="bfloat16", acc_dtype="bfloat16",
         coords=[[0, 0], [4, 17], [10, 36]], valid=[1, 1, 1], row_base=1,
         pzh=36),
    # B = 1, the segment grid not starting at 0
    dict(B=1, K=61, F=16, feat_dtype="bfloat16", acc_dtype="bfloat16",
         coords=[[9, 17]], valid=[1], row_base=0),
    # B = 32 (kMaxTiles), heavy overlap, row_base wrap
    dict(B=32, K=7, F=8, feat_dtype="bfloat16", acc_dtype="bfloat16",
         coords=[[(3 * t) % 28, (5 * t) % 32] for t in range(32)],
         valid=[float(t % 5 != 2) for t in range(32)], row_base=2),
    # f32 features: the unfused branch
    dict(B=4, K=5, F=4, feat_dtype="float32", acc_dtype="float32",
         coords=[[0, 0], [4, 8], [8, 24], [16, 20]], valid=[1, 1, 1, 1],
         row_base=1),
    # bf16 features but f32 weights bf16 cannot hold: the unfused branch
    dict(B=3, K=61, F=16, feat_dtype="bfloat16", acc_dtype="bfloat16",
         coords=[[0, 0], [4, 30], [2, 13]], valid=[1, 1, 1], row_base=0,
         w_kind="f32"),
    # bf16 weight values given as f32: the unfused branch, same bits
    dict(B=3, K=61, F=16, feat_dtype="bfloat16", acc_dtype="float32",
         coords=[[0, 0], [4, 30], [2, 13]], valid=[1, 1, 1], row_base=0,
         w_kind="bf16_values"),
    # F = 32 (the second register budget), K = 70 (two lane passes)
    dict(B=3, K=70, F=32, feat_dtype="bfloat16", acc_dtype="bfloat16",
         coords=[[0, 3], [5, 30], [20, 16]], valid=[1, 1, 1], row_base=2),
    # F = 48: weights past 32 through L1, channels past 256 staged unfetched
    dict(B=3, K=13, F=48, feat_dtype="bfloat16", acc_dtype="bfloat16",
         coords=[[0, 3], [5, 30], [20, 16]], valid=[1, 1, 1], row_base=2),
    dict(B=2, K=7, F=40, feat_dtype="float32", acc_dtype="float32",
         coords=[[0, 0], [6, 12]], valid=[1, 1], row_base=1, pzh=36),
    # c8p lanes not a whole number of 16-byte units: element-wise copies
    dict(B=3, K=5, F=2, feat_dtype="bfloat16", acc_dtype="bfloat16",
         coords=[[0, 0], [3, 9], [10, 31]], valid=[1, 1, 1], row_base=1,
         c8p=41),
    # f32 accumulator, K = 150: 16-z pieces would not fit, 8-z pieces do
    dict(B=3, K=150, F=8, feat_dtype="bfloat16", acc_dtype="float32",
         coords=[[0, 8], [5, 24], [20, 0]], valid=[1, 1, 1], row_base=2),
])
def test_accumulate_redesign_bit_equals_plain(cuda_device, case):
    """The redesigned kernel C (pieces of 16 z, tiles in batch order) equals
    the plain version bit for bit, in both accumulator modes and both
    branches of the head dot."""
    case = dict(case)
    row_base = case.pop("row_base")
    a0, args = _c_case(**case)
    ref = s2d_accumulate_plain(a0.clone(), *args, row_base=row_base)
    n0 = s2d_accumulate.launches
    dev = [x.to(cuda_device) if torch.is_tensor(x) else x for x in args]
    got = s2d_accumulate(a0.to(cuda_device), *dev, row_base=row_base).cpu()
    assert s2d_accumulate.launches == n0 + 1
    assert torch.equal(got, ref)


def test_accumulate_fused_dot_below_normal_range(cuda_device):
    """Where head products fall under f32's normal range (features and
    weights near 1e-21) the fused dot rounds them where the plain version
    does not: the documented exception, bounded by one unit of 2^-149 per
    multiply-add after the first (f32 accumulator at 0, zero bias, unit
    gaussian, so the dot reaches the accumulator unchanged)."""
    F = 16
    a0, (feats, g, w, b, coords, valid) = _c_case(
        B=2, K=5, F=F, feat_dtype="bfloat16", acc_dtype="float32",
        coords=[[0, 0], [20, 24]], valid=[1, 1])
    a0.zero_()
    feats = (feats.float() * 1e-21).bfloat16()
    w = (w.float() * 1e-21).bfloat16()
    args = (feats, torch.ones_like(g), w, torch.zeros_like(b), coords, valid)
    ref = s2d_accumulate_plain(a0.clone(), *args)
    dev = [x.to(cuda_device) if torch.is_tensor(x) else x for x in args]
    got = s2d_accumulate(a0.to(cuda_device), *dev).cpu()
    assert ref.abs().max() < 2.0 ** -126  # the range under test
    assert ref.abs().max() > 0
    assert (got - ref).abs().max() <= (F - 1) * 2.0 ** -149


def test_accumulate_all_invalid_batch_is_untouched(cuda_device):
    a0, args = _c_case(B=4, K=61, F=16, feat_dtype="bfloat16",
                       acc_dtype="bfloat16",
                       coords=[[0, 0], [4, 8], [8, 24], [16, 20]],
                       valid=[0, 0, 0, 0])  # no live tile: no launch
    dev = [x.to(cuda_device) if torch.is_tensor(x) else x for x in args]
    n0 = s2d_accumulate.launches
    got = s2d_accumulate(a0.to(cuda_device), *dev, row_base=1).cpu()
    assert s2d_accumulate.launches == n0  # nothing to launch
    assert torch.equal(got, a0)


@pytest.mark.parametrize("dtype,K,c8p,Zh", [
    ("bfloat16", 61, 488, 40),   # the main path's lanes; a run of 8 voxels
    ("float32", 61, 488, 72),    # f32 rows padded to an odd unit count
    ("bfloat16", 5, 41, 37),     # c8p not whole units: element-wise copies
])
def test_finalize_redesign_bit_equals_plain(cuda_device, dtype, K, c8p, Zh):
    """Redesigned kernel B: NaN lanes and ties, also across an offset group
    boundary, all rows retired (n_zero = n_rows) with a wrapping row_base,
    and a line length that does not fill the last block."""
    rng = np.random.RandomState(12)
    p0h, Yh = 5, 6
    acc = np.zeros((p0h, Yh, Zh, c8p), np.float32)
    acc[..., :8 * K] = np.round(rng.randn(p0h, Yh, Zh, 8 * K) * 2) / 2
    acc[:, 0, 0, K - 1:K + 1] = 7.0       # tie across the o=0 / o=1 boundary
    acc[:, 0, 1, 2 * K:3 * K] = 3.0       # a whole group tied
    acc[:, 1, 2, K + 3] = np.nan          # NaN wins its group ...
    acc[:, 1, 2, K + 1] = np.nan          # ... the first NaN does
    acc[:, 2, 3, 3 * K:4 * K] = np.nan    # an all-NaN group
    acc[:, 3, 4, :8 * K] = -np.inf
    acc = torch.from_numpy(acc).to(getattr(torch, dtype))
    n_rows = 4
    a_gpu = acc.to(cuda_device)
    n0 = grouped_argmax.launches
    got = grouped_argmax(a_gpu, K, n_rows, row_base=3, n_zero=n_rows).cpu()
    assert grouped_argmax.launches == n0 + 1
    a_cpu = acc.clone()
    ref = grouped_argmax_plain(a_cpu, K, n_rows, row_base=3, n_zero=n_rows)
    assert torch.equal(got, ref)
    bits = torch.int16 if dtype == "bfloat16" else torch.int32  # NaN-safe
    assert torch.equal(a_gpu.cpu().view(bits), a_cpu.view(bits))


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



# ------------------------------------------- kernel A under the training norm
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_spatial_sum_sumsq_autograd_on_card(cuda_device, dtype):
    """SpatialSumSumsq: the forward is one kernel A launch within its f32
    bound; the backward (plain torch) equals the plain version's autograd,
    within 1e-5 relative in float32 and one bf16 rounding in bfloat16."""
    from fast_nnunet_tpu_torch.ops.stats import SpatialSumSumsq
    g = torch.Generator().manual_seed(3)
    shape = (2, 8, 20, 24, 32)
    x = (torch.randn(shape, generator=g) * 2 + 1).to(getattr(torch, dtype))
    gs, gq = torch.randn(2, 8, generator=g), torch.randn(2, 8, generator=g)
    xk = x.to(cuda_device).requires_grad_()
    n0 = spatial_sum_sumsq.launches
    s, q = SpatialSumSumsq.apply(xk)
    assert spatial_sum_sumsq.launches == n0 + 1
    (dk,) = torch.autograd.grad((s * gs.to(cuda_device)
                                 + q * gq.to(cuda_device)).sum(), xk)
    xp = x.clone().requires_grad_()
    sp, qp = spatial_sum_sumsq_plain(xp)
    (dp,) = torch.autograd.grad((sp * gs + qp * gq).sum(), xp)
    scale = x.float().abs().reshape(2, 8, -1).sum(-1)
    assert ((s.detach().cpu() - sp.detach()).abs()
            <= 1e-5 * scale + 1e-6).all()
    rel = 1e-5 if dtype == "float32" else 2.0 ** -7  # one bf16 ulp
    torch.testing.assert_close(dk.cpu().float(), dp.float(), rtol=rel,
                               atol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_training_norms_launch_kernel_a(cuda_device, remat):
    """A training network on the card: every one-pass norm at >= 4096
    voxels launches kernel A in the forward, and again in the backward's
    recompute when its stack is checkpointed; none falls back."""
    net = get_network_from_plans("PlainConvUNet", ARCH, (), 1, K,
                                 compute_dtype=torch.bfloat16,
                                 norm_onepass=True, remat=remat,
                                 trainable=True).to(cuda_device)
    x = torch.randn(2, 1, 32, 32, 32, device=cuda_device)
    n0 = spatial_sum_sumsq.launches
    out = net(x, deep_supervision=True)
    n_fwd = spatial_sum_sumsq.launches - n0
    # 32^3 full-res stacks (encoder 0, decoder 1) and 16^3 (encoder 1,
    # decoder 0): 8 norms; 8^3 = 512 voxels is under the gate
    assert n_fwd == 8
    sum(o.float().mean() for o in out).backward()
    assert spatial_sum_sumsq.launches - n0 == n_fwd * (2 if remat else 1)
    assert all(torch.isfinite(p.grad).all() for p in net.parameters()
               if p.grad is not None)


@pytest.mark.parametrize("remat", [False, True])
def test_resenc_training_norms_launch_kernel_a(cuda_device, remat):
    """A residual-encoder training network on the card: the stem, every
    residual block (skip norms included) and decoder norm at >= 4096 voxels
    launch kernel A; under remat each block and decoder stack launches it
    again in the backward, the stem does not."""
    resenc = dict(ARCH, kernel_sizes=[[1, 3, 3], [3, 3, 3], [3, 3, 3]],
                  n_blocks_per_stage=[1, 2, 2], n_conv_per_stage_decoder=[1, 1])
    net = get_network_from_plans("ResidualEncoderUNet", resenc, (), 1, K,
                                 compute_dtype=torch.bfloat16,
                                 norm_onepass=True, remat=remat,
                                 trainable=True).to(cuda_device)
    x = torch.randn(2, 1, 32, 32, 32, device=cuda_device)
    n0 = spatial_sum_sumsq.launches
    out = net(x, deep_supervision=True)
    # 32^3: stem + stage 0's block (2); 16^3: stage 1's blocks (3 + 2);
    # both decoder stacks (1 + 1); 8^3 is under the gate
    assert spatial_sum_sumsq.launches - n0 == 10
    sum(o.float().mean() for o in out).backward()
    assert spatial_sum_sumsq.launches - n0 == (19 if remat else 10)


@pytest.mark.parametrize("cls", ["PlainConvUNet", "ResidualEncoderUNet"])
def test_2d_training_norms_launch_kernel_a(cuda_device, cls):
    """A 2D training network on the card: every one-pass norm at >= 4096
    in-plane voxels (64^2 here) launches kernel A on its 4-D activation."""
    arch = {"n_stages": 3, "features_per_stage": [8, 16, 32],
            "kernel_sizes": [[3, 3]] * 3, "strides": [[1, 1], [2, 2], [2, 2]],
            "n_conv_per_stage": [2, 2, 2], "n_blocks_per_stage": [1, 2, 2],
            "n_conv_per_stage_decoder": [2, 2],
            "conv_op": "torch.nn.modules.conv.Conv2d"}
    net = get_network_from_plans(cls, arch, (), 1, K,
                                 compute_dtype=torch.bfloat16,
                                 norm_onepass=True,
                                 trainable=True).to(cuda_device)
    x = torch.randn(2, 1, 64, 64, device=cuda_device)
    n0 = spatial_sum_sumsq.launches
    out = net(x, deep_supervision=True)
    # 64^2 only: encoder stage 0 and the last decoder stack
    want = (2 + 2) if cls == "PlainConvUNet" else (1 + 2 + 2)
    assert spatial_sum_sumsq.launches - n0 == want
    sum(o.float().mean() for o in out).backward()
    assert all(torch.isfinite(p.grad).all() for p in net.parameters()
               if p.grad is not None)


def test_2d_distillation_step_launches_kernel_a_at_4d(cuda_device):
    """A 2d distillation step on the card (a student at r = 2 and two
    teachers, bf16): every one-pass norm at >= 4096 in-plane voxels of the
    student and of each teacher launches kernel A on its 4-D activation,
    the student's under autograd and the teachers' without."""
    from fast_nnunet_tpu_torch.models.students import build_lite_student
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.training.distill import \
        make_distill_train_step
    from fast_nnunet_tpu_torch.training.optimizers import nnunet_sgd
    arch = {"n_stages": 3, "features_per_stage": [16, 32, 64],
            "kernel_sizes": [[3, 3]] * 3, "strides": [[1, 1], [2, 2], [2, 2]],
            "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [2, 2],
            "conv_op": "torch.nn.modules.conv.Conv2d"}
    student = build_lite_student("PlainConvUNet", arch, 1, K, 2,
                                 compute_dtype=torch.bfloat16,
                                 norm_onepass=True,
                                 trainable=True).to(cuda_device)
    teachers = [get_network_from_plans("PlainConvUNet", arch, (), 1, K,
                                       compute_dtype=torch.bfloat16,
                                       norm_onepass=True).to(cuda_device)
                for _ in range(2)]
    step = make_distill_train_step(
        student, teachers, nnunet_sgd(student.parameters(), 1e-2),
        alpha=0.3, temperature=3.0, n_ds_levels=2)
    x = torch.randn(2, 1, 64, 64, device=cuda_device)
    lab = torch.randint(0, K, (2, 64, 64), device=cuda_device)
    shapes = []
    real = ka.SpatialSumSumsq.apply

    def recording(t):
        shapes.append(tuple(t.shape))
        return real(t)
    ka.SpatialSumSumsq.apply = recording
    n0 = spatial_sum_sumsq.launches
    try:
        total, seg, dist = step(x, (lab, lab[:, ::2, ::2]))
    finally:
        del ka.SpatialSumSumsq.apply   # the inherited classmethod again
    # 64^2 only: encoder stage 0 and the last decoder stack, each 2 norms
    assert spatial_sum_sumsq.launches - n0 == 4 + 2 * 4 == len(shapes)
    assert all(len(sh) == 4 and sh[2:] == (64, 64) for sh in shapes)
    assert sorted({sh[1] for sh in shapes}) == [8, 16]   # student, teachers
    assert all(torch.isfinite(v) for v in (total, seg, dist))


def test_train_step_cuda_matches_cpu(cuda_device):
    """Three SGD steps of a small training network, fp32 with TF32 off and
    deterministic cuDNN, on the card (kernel A) and on the CPU (plain
    version): losses within 1e-4 relative, parameters within 1e-5."""
    from fast_nnunet_tpu_torch.models.unet import params_from_jax
    from fast_nnunet_tpu_torch.training.optimizers import nnunet_sgd
    from fast_nnunet_tpu_torch.training.schedules import poly_lr
    from fast_nnunet_tpu_torch.training.train_step import make_train_step
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(5)
    batches = []
    for _ in range(3):
        x = rng.randn(2, 1, 32, 32, 32).astype(np.float32)
        lab = rng.randint(0, K, (2, 32, 32, 32))
        batches.append((torch.from_numpy(x), (torch.from_numpy(lab),
                        torch.from_numpy(lab[:, ::2, ::2, ::2].copy()))))
    res = {}
    try:
        for dev in (cuda_device, torch.device("cpu")):
            net = get_network_from_plans(
                "PlainConvUNet", ARCH, (), 1, K, compute_dtype=torch.float32,
                norm_onepass=True, trainable=True)
            net = params_from_jax(net, plain_params(6)).to(dev)
            opt = nnunet_sgd(net.parameters(), poly_lr(1e-2, 10))
            step = make_train_step(net, opt, n_ds_levels=2)
            n0 = spatial_sum_sumsq.launches
            losses = [float(step(x.to(dev), tuple(t.to(dev) for t in tg)))
                      for x, tg in batches]
            res[dev.type] = (losses, [p.detach().cpu() for p in
                                      net.parameters()],
                             spatial_sum_sumsq.launches - n0)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic \
            = prev
    assert res["cuda"][2] > 0 and res["cpu"][2] == 0
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-4)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


# ------------------------------------------- turbo host route: streamed
@pytest.mark.parametrize("folds", [1, 2])
def test_streamed_host_route_launches_kernels_from_pinned_buffers(
        cuda_device, monkeypatch, folds):
    """The streamed host route on the card: kernels A, B and C launch (C
    with one fold; the fold route accumulates with torch ops, as JAX
    does), every strip is staged in pinned memory and every row piece
    lands in pinned memory, and the mask equals the fused host route's
    (bit for bit: one set of kernels on one card) and the CPU run's
    (fp32, TF32 off, >= 0.999)."""
    from fast_nnunet_tpu_torch.inference import engine as engine_module
    from fast_nnunet_tpu_torch.inference.turbo import (TurboConfig,
                                                       TurboPipeline)
    from fast_nnunet_tpu_torch.models.s2d import (make_s2d_engine_net,
                                                  random_plain_params)
    pinned = {"strips": [], "rows": []}
    put_strip = engine_module.StripUploader.put
    put_rows = engine_module.RowFetcher.put

    def strip(self, shape, dtype, fill):
        out = put_strip(self, shape, dtype, fill)
        pinned["strips"] += [b.is_pinned() for b in self._bufs
                             if b is not None]
        return out

    def rows(self, t):
        put_rows(self, t)
        if self.cuda:
            pinned["rows"].append(self._pieces[-1][0].is_pinned())
    monkeypatch.setattr(engine_module.StripUploader, "put", strip)
    monkeypatch.setattr(engine_module.RowFetcher, "put", rows)

    cfg = TurboConfig(patch_size=(32, 32, 32), target_spacing=(1.0, 1.1, 1.05),
                      mean=127.475, std=318.463, lower_bound=-1024.0,
                      upper_bound=3071.0, num_classes=K)
    vol = np.full((40, 120, 44), -1024, np.int16)
    vol[4:36, 10:110, 6:40] = (np.random.RandomState(9).rand(32, 100, 34)
                               * 900 - 100).astype(np.int16)
    trees = [random_plain_params(ARCH, 1, K, seed=s) for s in range(folds)]
    masks, counts = {}, {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in (cuda_device, torch.device("cpu")):
            net = make_s2d_engine_net(ARCH, K, 1,
                                      compute_dtype=torch.float32).to(dev)
            net.set_stats_min_voxels(1)
            s2d = [net.convert_params(t) for t in trees]
            eng = SlidingWindowEngine(net, cfg.patch_size, K,
                                      compute_dtype=torch.float32,
                                      sweep_acc_dtype=torch.float32,
                                      tile_batch=4, device=dev)
            pipe = TurboPipeline(eng, cfg, host_preprocess=True, air_skip=True)
            n0 = [f.launches for f in (spatial_sum_sumsq, grouped_argmax,
                                       s2d_accumulate)]
            masks[dev.type] = pipe.predict_volume(s2d, vol, (1.0, 1.0, 1.0))
            assert pipe.route == "streamed"
            counts[dev.type] = [f.launches - n for f, n in zip(
                (spatial_sum_sumsq, grouped_argmax, s2d_accumulate), n0)]
            if dev.type == "cuda":
                monkeypatch.setenv("FNN_TURBO_STREAM", "0")
                fused = pipe.predict_volume(s2d, vol, (1.0, 1.0, 1.0))
                monkeypatch.delenv("FNN_TURBO_STREAM")
                assert pipe.route == "host"
                np.testing.assert_array_equal(fused, masks["cuda"])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    a, b, c = counts["cuda"]
    assert a > 0 and b > 0 and (c > 0 if folds == 1 else c == 0)
    assert counts["cpu"] == [0, 0, 0]
    assert pinned["strips"] and all(pinned["strips"])
    assert pinned["rows"] and all(pinned["rows"])
    assert (masks["cuda"] == masks["cpu"]).mean() >= 0.999


# ------------------------------------------- the tracer on the device route
def test_served_study_keeps_the_tracer_totals(cuda_device):
    """A served study on the device route with the tracer installed: the
    CUDA-event phases the benchmark reads keep their names, each with its
    host time, the host-only "predict_volume" holds them, and the counters
    read the tiles and the mask's pageable copy."""
    from fast_nnunet_tpu_torch.inference.engine import PhaseTimer
    from fast_nnunet_tpu_torch.inference.turbo import (TurboConfig,
                                                       TurboPipeline)
    from fast_nnunet_tpu_torch.models.s2d import (make_s2d_engine_net,
                                                  random_plain_params)
    cfg = TurboConfig(patch_size=(32, 32, 32), target_spacing=(1.0, 1.1, 1.05),
                      mean=127.475, std=318.463, lower_bound=-1024.0,
                      upper_bound=3071.0, num_classes=K)
    vol = np.full((40, 120, 44), -1024, np.int16)
    vol[4:36, 10:60, 6:40] = (np.random.RandomState(9).rand(32, 50, 34)
                              * 900 - 100).astype(np.int16)
    net = make_s2d_engine_net(ARCH, K, 1, compute_dtype=torch.bfloat16).to(
        cuda_device)
    s2d = net.convert_params(random_plain_params(ARCH, 1, K, seed=0))
    eng = SlidingWindowEngine(net, cfg.patch_size, K,
                              sweep_acc_dtype=torch.bfloat16, tile_batch=4,
                              device=cuda_device)
    pipe = TurboPipeline(eng, cfg, air_skip=True)
    pipe.predict_volume(s2d, vol, (1.0, 1.0, 1.0))          # warm
    eng.timer = PhaseTimer()
    try:
        mask = pipe.predict_volume(s2d, vol, (1.0, 1.0, 1.0))
        totals = eng.timer.totals()
    finally:
        eng.timer = None
    phases = ("upload", "preprocess", "forward", "accumulate", "finalize",
              "revert", "d2h")
    device = {k for k in totals if ":" not in k}
    assert device == set(phases)
    assert all(totals[k] > 0 and totals["host:" + k] > 0 for k in phases)
    assert sum(totals["host:" + k] for k in phases) <= \
        totals["host:predict_volume"]
    assert totals["count:d2h_pageable_bytes"] == mask.nbytes
    assert 0 < totals["count:tiles_kept"] <= totals["count:tiles_forwarded"]
    assert totals["count:tiles_forwarded"] % 4 == 0
    # one kernel E launch per norm of every forward
    assert totals["count:norms_fused"] == totals["count:norms"] > 0


# ------------------------------------------- slab-parallel sweeps (sharded)
@pytest.mark.parametrize("acc_dtype", ["bfloat16", "float32"])
def test_kernels_c_b_d_at_slab_local_origins(cuda_device, acc_dtype):
    """inference/sharded.py drives kernel C on a p0/2-row view of the slab
    accumulator at a tile's half-res row, kernel B on the owned rows, and
    kernel D with slab-local x origins on an (owned + halo)-row
    accumulator: each against its plain version on the same views."""
    tdt = getattr(torch, acc_dtype)
    rng = np.random.RandomState(21)
    B, p0h, pyh, pzh, Kc, F, Yh, Zh, ext_h, row0 = 3, 4, 8, 16, 5, 4, 24, \
        40, 13, 6
    slab = torch.from_numpy(rng.randn(ext_h, Yh, Zh, 8 * Kc).astype(
        np.float32)).to(tdt)
    feats = torch.from_numpy(rng.randn(B, 8 * F, p0h, pyh, pzh).astype(
        np.float32)).bfloat16()
    g = torch.from_numpy(np.abs(rng.randn(p0h, pyh, pzh, 8)).astype(
        np.float32))
    w = torch.from_numpy((rng.randn(8, F, Kc) * 0.3).astype(np.float32)
                         ).bfloat16()
    b = torch.from_numpy((rng.randn(8 * Kc) * 0.1).astype(np.float32))
    coords = np.array([[0, 0], [4, 8], [16, 24]], np.int32)
    valid = np.ones(3, np.float32)
    ref = slab.clone()
    s2d_accumulate_plain(ref[row0:row0 + p0h], feats, g, w, b, coords, valid)
    got = slab.to(cuda_device)
    s2d_accumulate(got[row0:row0 + p0h], feats.to(cuda_device),
                   g.to(cuda_device), w.to(cuda_device), b.to(cuda_device),
                   coords, valid)
    assert torch.equal(got.cpu(), ref)
    owned_h = 8
    assert torch.equal(grouped_argmax(got[:owned_h], Kc, owned_h).cpu(),
                       grouped_argmax_plain(ref[:owned_h], Kc, owned_h))

    px, py, pz, C, owned = 8, 16, 16, 8, 12
    acc = torch.from_numpy(rng.randn(owned + px, 32, 40, C).astype(
        np.float32)).to(tdt)
    lg = torch.from_numpy(rng.randn(2, px, py, pz, C).astype(np.float32)
                          ).to(tdt)
    gf = torch.from_numpy(np.abs(rng.randn(px, py, pz * C)).astype(
        np.float32)).to(tdt)
    xy = np.array([[owned - 2, 0, 8], [owned - 2, 16, 24]], np.int32)
    ref = fused_scatter_accumulate_plain(acc.clone(), lg, gf, xy, 2)
    got = fused_scatter_accumulate(acc.to(cuda_device), lg.to(cuda_device),
                                   gf.to(cuda_device), xy, 2).cpu()
    assert torch.equal(got, ref)


def test_sharded_s2d_sweep_nccl_world_1_bit_equal(cuda_device):
    """The s2d slab sweep on one NCCL rank (the world the one-card machine
    allows) is the single-card sweep, kernels A, B and C launched."""
    from fast_nnunet_tpu_torch.models.s2d import random_plain_params
    from fast_nnunet_tpu_torch.parallel import spawn

    from . import torch_parallel_ranks as ranks
    tree = random_plain_params(ranks.S2D_ARCH, 1, ranks.K, 2)
    vol = np.random.RandomState(0).rand(1, 40, 24, 24).astype(np.float32)
    (single, multi, n), = spawn(ranks.sweep_pair, 1, device="cuda",
                                backend="nccl",
                                args=("s2d", 4, tree, vol, False))
    np.testing.assert_array_equal(multi, single)
    assert n[0] > 0 and n[1] > 0 and n[2] > 0


def test_sharded_sweeps_two_gloo_ranks_on_one_card(cuda_device):
    """Two gloo ranks sharing the card (host-staged halo rows): the plain
    sweep with kernel D and the s2d sweep with kernels C and B, in the
    wavefront mode, equal their single-card sweeps bit for bit."""
    from fast_nnunet_tpu_torch.models.s2d import random_plain_params
    from fast_nnunet_tpu_torch.parallel import spawn

    from . import torch_parallel_ranks as ranks
    vol = np.random.RandomState(0).rand(1, 40, 24, 24).astype(np.float32)
    for kind, arch in (("fused", ranks.SHARD_ARCH), ("s2d", ranks.S2D_ARCH)):
        tree = random_plain_params(arch, 1, ranks.K, 2)
        out = spawn(ranks.sweep_pair, 2, device="cuda", backend="gloo",
                    args=(kind, 4, tree, vol, True))
        single, multi, n = out[0]
        np.testing.assert_array_equal(multi, single)
        assert out[1][1] is None
        for r in out:
            assert (r[2][3] > 0) if kind == "fused" else \
                (r[2][1] > 0 and r[2][2] > 0)


# ------------------------------------ the norm ops, packages, the engine
@pytest.mark.parametrize("shape", [(8, 128, 80, 48, 48), (2, 16, 24, 24, 40)])
def test_s2d_norm_op_bit_equals_the_eager_norm(cuda_device, shape):
    """``torch.ops.fnn_torch.s2d_instance_norm`` on the card launches kernel
    A once (counted) and gives the eager norm bit for bit."""
    from fast_nnunet_tpu_torch.models.s2d import (instance_norm,
                                                  instance_norm_op)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=g).to(cuda_device, torch.bfloat16)
    c = shape[1] // 8
    scale = (torch.rand(c, generator=g) + 0.5).to(cuda_device)
    bias = torch.randn(c, generator=g).to(cuda_device)
    n0 = spatial_sum_sumsq.launches
    got = instance_norm_op(x, scale, bias, 1e-5, 8, 4096)
    assert spatial_sum_sumsq.launches == n0 + 1
    want = instance_norm(x, scale, bias, 1e-5, 8, 4096)
    assert torch.equal(got, want) and got.dtype == torch.bfloat16


# ------------------------------------------- kernel E: the norm's apply
# the bone_turbo student's norms at tile batch 8: (B, C8, *spatial), groups
E_SHAPES = [
    ((8, 128, 80, 48, 48), 8),   # stage 0 and the last decoder stage
    ((8, 128, 80, 48, 48), 1),
    ((8, 32, 80, 48, 48), 1),
    ((8, 64, 40, 24, 24), 1),
    ((8, 128, 20, 12, 12), 1),   # 2880-voxel rows, below kernel A's gate
    ((8, 160, 10, 6, 6), 1),     # 360
    ((8, 160, 5, 3, 3), 1),      # 45: not whole 16-byte units
    ((8, 16, 5, 3, 3), 8),
    ((2, 16, 7, 5, 3), 8),       # 105
]


def _e_inputs(shape, groups, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    B, C8 = shape[:2]
    c = C8 // groups
    x = (torch.randn(shape, generator=g) * 3 + 0.7).to(device, torch.bfloat16)
    mean = (torch.randn(B, c, generator=g) + 0.7).to(device)
    rstd = (torch.rand(B, c, generator=g) * 0.5 + 0.2).to(device)
    scale = (torch.rand(c, generator=g) + 0.5).to(device)
    bias = (torch.randn(c, generator=g) * 0.3).to(device)
    return x, mean, rstd, scale, bias


@pytest.mark.parametrize("shape,groups", E_SHAPES)
def test_norm_apply_bit_equals_plain(cuda_device, shape, groups):
    """Kernel E against its plain version bit for bit at every serving norm
    shape, with and without the LeakyReLU, out of place and in place."""
    from fast_nnunet_tpu_torch.ops import norm_apply as ke
    x, mean, rstd, scale, bias = _e_inputs(shape, groups, cuda_device)
    for slope in (None, 0.01):
        want = ke.norm_apply_plain(x, mean, rstd, scale, bias, groups, slope)
        n0 = ke.norm_apply.launches
        got = ke.norm_apply(x, mean, rstd, scale, bias, groups, slope)
        assert ke.norm_apply.launches == n0 + 1
        assert torch.equal(got, want)
    xi = x.clone()
    got = ke.norm_apply(xi, mean, rstd, scale, bias, groups, 0.01, out=xi)
    assert got is xi and torch.equal(xi, want)
    assert (want < 0).any() and (want > 0).any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_norm_apply_misaligned_and_f32(cuda_device, dtype):
    """A base off 16 bytes takes the element path, f32 the 4-wide one; both
    bit for bit."""
    from fast_nnunet_tpu_torch.ops import norm_apply as ke
    x, mean, rstd, scale, bias = _e_inputs((2, 16, 8, 8, 8), 8, cuda_device)
    x = x.to(getattr(torch, dtype))
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
    xm = flat[1:].view(x.shape).copy_(x)
    assert xm.is_contiguous() and xm.data_ptr() % 16 != 0
    for v in (x, xm):
        want = ke.norm_apply_plain(v, mean, rstd, scale, bias, 8, 0.01)
        assert torch.equal(ke.norm_apply(v, mean, rstd, scale, bias, 8,
                                         0.01), want)


STUDENT_ARCH = {"n_stages": 6, "features_per_stage": [16, 32, 64, 128, 160,
                                                      160],
                "kernel_sizes": [[3, 3, 3]] * 6,
                "strides": [[1, 1, 1]] + [[2, 2, 2]] * 5,
                "n_conv_per_stage": [2] * 6,
                "n_conv_per_stage_decoder": [2] * 5}


def test_s2d_forward_bit_equals_the_former_eager_norms(cuda_device,
                                                      monkeypatch):
    """The bone_turbo student's s2d forward at its tile batch and patch
    (every serving norm shape): kernel E launched once per block, features
    bit for bit those of the former eager block (conv, the norm's torch
    passes, LeakyReLU)."""
    import torch.nn.functional as F
    from fast_nnunet_tpu_torch.models import s2d
    from fast_nnunet_tpu_torch.ops import norm_apply as ke
    from .test_torch_norm_apply import former_norm
    net = s2d.make_s2d_engine_net(STUDENT_ARCH, K, 1,
                                  compute_dtype=torch.bfloat16)
    s2d.params_from_jax(net, net.convert_params(
        s2d.random_plain_params(STUDENT_ARCH, 1, K, seed=0)))
    net.to(cuda_device).eval()
    x = torch.randn(8, 1, 160, 96, 96, generator=torch.Generator(
        ).manual_seed(1)).to(cuda_device, torch.bfloat16)
    with torch.no_grad():
        n0 = ke.norm_apply.launches
        got = net(x, return_features=True)
        assert ke.norm_apply.launches - n0 == net.norm_count() == 22

        def former_forward(self, v):
            if self.pre_pad is not None:
                v = F.pad(v, self.pre_pad)
            v = self.conv(v)
            v = former_norm(v, self.norm.weight, self.norm.bias, self.eps,
                            self.groups, self.stats_min_voxels)
            return F.leaky_relu_(v, self.slope)

        monkeypatch.setattr(s2d._Block, "forward", former_forward)
        n0 = ke.norm_apply.launches
        want = net(x, return_features=True)
        assert ke.norm_apply.launches == n0
    assert torch.equal(got, want)


def test_packaged_s2d_forward_launches_kernel_a(cuda_device, tmp_path):
    """An AOTInductor package of an s2d forward calls kernel A through the
    dispatcher (never an Inductor reduction in its place): the same launch
    count as the eager forward, features within bf16 fusion noise."""
    from fast_nnunet_tpu_torch.inference import aot
    from fast_nnunet_tpu_torch.models.s2d import (make_s2d_engine_net,
                                                  params_from_jax)
    net = make_s2d_engine_net(ARCH, K, 1, compute_dtype=torch.bfloat16)
    params_from_jax(net, net.convert_params(plain_params(0)))
    net.to(cuda_device).eval()
    net.set_stats_min_voxels(0)

    class Features(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.network = net

        def forward(self, x):
            return self.network(x, return_features=True)

    x = torch.randn(2, 1, 16, 16, 32, device=cuda_device,
                    dtype=torch.bfloat16)
    fn = aot.aot_compile(Features(), (x,), str(tmp_path / "cache"))
    with torch.no_grad():
        n0 = spatial_sum_sumsq.launches
        want = net(x, return_features=True)
        eager = spatial_sum_sumsq.launches - n0
        got = fn(x)
        packaged = spatial_sum_sumsq.launches - n0 - eager
    assert eager > 0 and packaged == eager
    rel = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert rel <= 2e-2, rel


def test_engine_binary_links_libtorch_cuda(cuda_device):
    import subprocess
    from fast_nnunet_tpu_torch.ops import _build
    binary = _build.engine_binary()
    ldd = subprocess.run(["ldd", binary], capture_output=True, text=True)
    assert "libtorch_cuda.so" in ldd.stdout, ldd.stdout
    r = subprocess.run([binary, "--help"], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "--aoti" in r.stderr


# ------------------------------------------------ kernels F and G: attention
def _attention_inputs(shape, dev, seed=0):
    """Unit-norm q (times a temperature of 10) and k, v read in place from
    a (B, T, 3, H, hd) qkv output, and dO, all bf16, as Primus gives them."""
    from torch.nn.functional import normalize
    B, T, H, hd = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q = normalize(torch.randn(shape, device=dev, generator=g), dim=-1) * 10
    k = normalize(torch.randn(shape, device=dev, generator=g), dim=-1)
    v = torch.randn(B, T, 3, H, hd, device=dev, generator=g).unbind(2)[2]
    do = torch.randn(shape, device=dev, generator=g)
    return [t.bfloat16() for t in (q, k, v, do)]


@pytest.mark.parametrize("shape", [(2, 8000, 12, 72), (2, 1037, 12, 72),
                                   (1, 130, 2, 66), (1, 45, 2, 72),
                                   (1, 128, 2, 72), (1, 129, 2, 72)])
def test_attention_kernels_match_plain(cuda_device, shape):
    """F and G against their plain version at Primus M's 160^3 shape, a
    ragged token count, head dim 66 (padded to 72), and token counts below,
    at and across one of G's 128-row key blocks: O, dq, dk and dv within
    1.5e-2 of each plain tensor's largest magnitude (the kernel rounds the
    unnormalised probabilities to bf16, the plain version the normalised
    ones; measured 0 to 6.9e-3 on an H100), lse within 1e-4 (measured
    1.9e-6); one launch of F, two of G."""
    from fast_nnunet_tpu_torch.ops import attention as fa
    q, k, v, do = _attention_inputs(shape, cuda_device)
    n0, m0 = fa.attention_forward.launches, fa.attention_backward.launches
    o, lse = fa.attention_forward(q, k, v)
    grads = fa.attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert fa.attention_forward.launches == n0 + 1
    assert fa.attention_backward.launches == m0 + 2
    op, lp = fa.attention_forward_plain(q, k, v, block=500)
    want = fa.attention_backward_plain(q, k, v, op, lp, do, block=500)
    assert (lse - lp).abs().max() <= 1e-4
    for got, ref in zip((o,) + tuple(grads), (op,) + tuple(want)):
        assert got.shape == ref.shape and not torch.isnan(got).any()
        err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert err <= 1.5e-2, err


@pytest.mark.parametrize("shape", [(2, 8000, 12, 72), (2, 1037, 12, 72)])
def test_attention_backward_twice_on_the_same_inputs(cuda_device, shape):
    """G run twice: dk and dv bit for bit (each summed in registers in a
    fixed order); dq's f32 sums arrive by reduce-adds in an order that
    changes from run to run, and it is rounded to bf16 once, so each
    element lies within one bf16 rounding step of the other run's (2^-7 of
    its magnitude, plus 1e-6 of the largest for sums that cancel; measured
    up to 2.3e-3 of the largest at 160^3 on an H100)."""
    from fast_nnunet_tpu_torch.ops import attention as fa
    q, k, v, do = _attention_inputs(shape, cuda_device)
    o, lse = fa.attention_forward(q, k, v)
    a = fa.attention_backward(q, k, v, o, lse, do)
    b = fa.attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    x, y = a[0].float(), b[0].float()
    assert ((x - y).abs() <= y.abs() * 2 ** -7 + 1e-6 * y.abs().max()).all()


def test_attention_kernels_reject_what_they_cannot_take(cuda_device):
    from fast_nnunet_tpu_torch.ops import attention as fa
    q, k, v, _ = _attention_inputs((1, 64, 2, 72), cuda_device)
    with pytest.raises(TypeError):
        fa.attention_forward(q.float(), k, v)
    with pytest.raises(ValueError):
        fa.attention_forward(q[:, :32], k, v)
    big = torch.zeros(1, 64, 2, 80, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        fa.attention_forward(big, big, big)


def test_primus_step_launches_f_and_g(cuda_device):
    """A bf16 Primus of Primus M's depth and head dim through one NaN-guarded
    AdamW train step: F launches once a block (16), G's two kernels once a
    block each (2 x 16), and the timer counts 16 calls, all fused."""
    from fast_nnunet_tpu_torch.models.primus import Primus, init_primus_
    from fast_nnunet_tpu_torch.ops import attention as fa
    from fast_nnunet_tpu_torch.training.optimizers import nnunet_adamw
    from fast_nnunet_tpu_torch.training.train_step import make_train_step
    from fast_nnunet_tpu_torch.utils.profiling import PhaseTimer
    net = init_primus_(Primus(1, 144, (8, 8, 8), 4, 16, 2, (32, 32, 32),
                              trainable=True), 3).to(cuda_device)
    net.timer = timer = PhaseTimer()
    step = make_train_step(net, nnunet_adamw(net.parameters(), 3e-4),
                           skip_nonfinite=True)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 1, 32, 32, 32, generator=g).to(cuda_device)
    lab = torch.randint(0, 4, (2, 32, 32, 32), generator=g).to(cuda_device)
    n0, m0 = fa.attention_forward.launches, fa.attention_backward.launches
    loss = step(x, (lab,))
    assert torch.isfinite(loss)
    assert fa.attention_forward.launches - n0 == 16
    assert fa.attention_backward.launches - m0 == 2 * 16
    tot = timer.totals()
    assert tot["count:attn_calls"] == tot["count:attn_fused"] == 16
    assert tot["attention"] > 0 and tot["attention_backward"] > 0
