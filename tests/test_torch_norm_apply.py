"""Kernel E's contract (fast_nnunet_tpu_torch/ops/norm_apply.py) on the CPU:
the plain version, the s2d norm that calls it and the s2d block's eager
forward give the former torch sequence (f32 affine op by op, the cast, the
in-place LeakyReLU) bit for bit, for groups 1 and 8 on either side of
kernel A's gate, with and without a conv bias folded in (the sequence then
runs on ``x.float() + b``); the moments of the biased activation; the block
against the former conv + bias -> norm order; and the launch plan at every
serving shape. The kernel is held against the plain version on the card
(tests/test_torch_kernels_cuda.py).
"""
import math

import pytest
import torch
import torch.nn.functional as F

from fast_nnunet_tpu_torch.models import s2d
from fast_nnunet_tpu_torch.ops import norm_apply as ke
from fast_nnunet_tpu_torch.ops.stats import spatial_sum_sumsq


def former_norm(x, scale, bias, eps, groups, stats_min_voxels,
                conv_bias=None):
    """The s2d InstanceNorm as it was before kernel E, kept as the
    yardstick: moments as today, then the affine as seven torch passes.
    With ``conv_bias`` (C8,) it is the norm of ``x + conv_bias``: kernel A's
    sums of x shifted row by row (sum + S b, sumsq + b (2 sum + S b)), or
    the two passes over ``x.float() + b``, and the affine on
    ``x.float() + b``."""
    B, C8 = x.shape[0], x.shape[1]
    c = C8 // groups
    n_spatial = math.prod(x.shape[2:])
    cb = None if conv_bias is None else conv_bias.float()
    if n_spatial >= stats_min_voxels:
        s, q = spatial_sum_sumsq(x)
        if cb is not None:
            s, q = s + n_spatial * cb, q + cb * (2 * s + n_spatial * cb)
        n = n_spatial * groups
        mean = s.reshape(B, groups, c).sum(1) / n
        var = torch.clamp(q.reshape(B, groups, c).sum(1) / n - mean * mean,
                          min=0.0)
    else:
        x32 = x.float().reshape(B, C8, -1)
        if cb is not None:
            x32 = x32 + cb.reshape(1, C8, 1)
        mean_c = x32.mean(-1)
        var_c = x32.var(-1, correction=0)
        if groups == 1:
            mean, var = mean_c, var_c
        else:
            mean = mean_c.reshape(B, groups, c).mean(1)
            var = ((var_c + mean_c * mean_c).reshape(B, groups, c).mean(1)
                   - mean * mean)
    v = x if cb is None else x.float() + cb.reshape(
        (1, C8) + (1,) * (x.dim() - 2))
    return former_apply(v, mean, torch.rsqrt(var + eps), scale, bias,
                        groups).to(x.dtype)


def former_apply(v, mean, rstd, scale, bias, groups):
    """The former affine on moments given: seven torch passes over v, the
    f32 result (the caller casts)."""
    B, C8 = v.shape[0], v.shape[1]
    shape = (B, C8) + (1,) * (v.dim() - 2)
    m = mean.repeat(1, groups).reshape(shape)
    r = rstd.repeat(1, groups).reshape(shape)
    sc = scale.float().repeat(groups).reshape((1, C8) + (1,) * (v.dim() - 2))
    bi = bias.float().repeat(groups).reshape(sc.shape)
    y = v.to(torch.float32, copy=True)
    y.sub_(m).mul_(r).mul_(sc).add_(bi)
    return y


def _inputs(shape, groups, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    # a conv output's spread, off centre: both signs after the norm
    x = (torch.randn(shape, generator=g) * 3 + 0.7).to(dtype)
    c = shape[1] // groups
    scale = torch.rand(c, generator=g) + 0.5
    bias = torch.randn(c, generator=g) * 0.3
    return x, scale, bias


# spatial sizes on either side of STATS_MIN_VOXELS (4096)
SIZES = {"below_gate": (5, 3, 3), "at_gate": (16, 16, 16),
         "above_gate": (10, 24, 24)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("groups", [1, 8])
def test_plain_bit_equals_the_former_norm_and_activation(groups, size, dtype):
    """norm_apply_plain on the moments, the s2d norm (out of place, the
    dispatcher op's body) and the fused call in place all give the former
    ``F.leaky_relu_(instance_norm(...))`` bit for bit."""
    shape = (2, 16) + SIZES[size]
    x, scale, bias = _inputs(shape, groups, dtype, seed=11)
    gate = s2d.STATS_MIN_VOXELS
    assert (math.prod(SIZES[size]) >= gate) == (size != "below_gate")
    want_norm = former_norm(x, scale, bias, 1e-5, groups, gate)
    want = F.leaky_relu_(want_norm.clone(), 0.01)
    got_norm = s2d.instance_norm(x, scale, bias, 1e-5, groups, gate)
    assert got_norm.dtype == dtype and torch.equal(got_norm, want_norm)
    xi = x.clone()
    got = s2d.instance_norm(xi, scale, bias, 1e-5, groups, gate, slope=0.01)
    assert got.data_ptr() == xi.data_ptr() and torch.equal(got, want)
    assert (want < 0).any() and (want > 0).any()


def _conv_bias(C8, seed):
    """A conv bias of C8 channels; with groups=8 each offset's copy of a
    logical channel carries its own value, so the pooled variance moves."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(C8, generator=g) * 2


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("groups", [1, 8])
def test_plain_apply_with_and_without_conv_bias(groups, size, dtype, folded):
    """norm_apply_plain on the moments of the activation: without a conv
    bias the former sequence on x, with one the former sequence on
    ``x.float() + b``, bit for bit; the s2d norm in place gives the same."""
    shape = (2, 16) + SIZES[size]
    x, scale, bias = _inputs(shape, groups, dtype, seed=13)
    cb = _conv_bias(16, seed=14) if folded else None
    gate = s2d.STATS_MIN_VOXELS
    mean, var = s2d.norm_moments(x, groups, gate, cb)
    rstd = torch.rsqrt(var + 1e-5)
    v = x if cb is None else x.float() + cb.reshape(1, 16, 1, 1, 1)
    want = F.leaky_relu_(former_apply(v, mean, rstd, scale, bias,
                                      groups).to(dtype), 0.01)
    got = ke.norm_apply_plain(x, mean, rstd, scale, bias, groups, 0.01,
                              conv_bias=cb)
    assert got.dtype == dtype and torch.equal(got, want)
    xi = x.clone()
    got = s2d.instance_norm(xi, scale, bias, 1e-5, groups, gate, slope=0.01,
                            conv_bias=cb)
    assert got.data_ptr() == xi.data_ptr() and torch.equal(got, want)
    assert torch.equal(got, F.leaky_relu_(former_norm(
        x, scale, bias, 1e-5, groups, gate, cb), 0.01))
    assert (want < 0).any() and (want > 0).any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_moments_of_the_biased_activation(size, dtype):
    """groups=8, the 8 offsets of each logical channel under different conv
    biases: the moments (kernel A's sums shifted, or two passes) are the
    biased activation's, computed directly in float64, to f32 rounding; and
    they differ from the bias-free ones by far more, so the bias cannot be
    dropped."""
    shape = (2, 16) + SIZES[size]
    x, _, _ = _inputs(shape, 8, dtype, seed=21)
    cb = _conv_bias(16, seed=22)
    mean, var = s2d.norm_moments(x, 8, s2d.STATS_MIN_VOXELS, cb)
    v = (x.double() + cb.double().reshape(1, 16, 1, 1, 1)).reshape(
        2, 8, 2, -1).transpose(1, 2).reshape(2, 2, -1)
    m64, v64 = v.mean(-1), v.var(-1, correction=0)
    sq = (v * v).mean(-1)          # the scale of the one-pass formula
    assert mean.dtype == var.dtype == torch.float32
    assert ((mean.double() - m64).abs() <= 1e-6 * sq.sqrt()).all()
    assert ((var.double() - v64).abs() <= 1e-5 * sq).all()
    mean0, var0 = s2d.norm_moments(x, 8, s2d.STATS_MIN_VOXELS)
    assert ((var0.double() - v64).abs() > 0.1 * v64).any()
    assert ((mean0.double() - m64).abs() > 0.05).any()


def _block(groups, dtype, gate):
    torch.manual_seed(5)
    blk = s2d._Block(16, 16, (3, 3, 3), (1, 1, 1), (1, 1, 1), groups=groups,
                     eps=1e-5, slope=0.01).eval()
    blk.norm.weight.data = torch.rand(16 // groups) + 0.5
    blk.norm.bias.data = torch.randn(16 // groups)
    blk.conv.bias.data = torch.randn(16)
    blk.stats_min_voxels = gate
    return blk.to(dtype)


@pytest.mark.parametrize("groups", [1, 8])
def test_block_forward_bit_equals_the_former_sequence(groups):
    """An s2d block's eager forward: the conv without its bias, then the
    fused norm with the conv bias folded in, in place, equals conv (no
    bias) -> former norm of the biased activation -> F.leaky_relu_."""
    blk = _block(groups, torch.float32, s2d.STATS_MIN_VOXELS)
    x = torch.randn(2, 16, 6, 8, 10)
    with torch.no_grad():
        got = blk(x)
        conv = F.conv3d(x, blk.conv.weight, None, 1, 1)
        want = F.leaky_relu_(former_norm(
            conv, blk.norm.weight, blk.norm.bias, 1e-5, groups,
            blk.stats_min_voxels, blk.conv.bias), 0.01)
    assert torch.equal(got, want)


# (rtol, atol) of the folded block against conv + bias -> norm: f32 rounding
# alone, and in bf16 the one rounding of conv + bias that folding removes
# (half a bf16 step of the biased value, 2^-9 relative, times rstd * scale
# after the norm) plus one bf16 step of the output
FOLD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 2 ** -5)}


@pytest.mark.parametrize("gate", [0, 1 << 30], ids=["kernel_a", "two_pass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 8])
def test_block_forward_matches_the_conv_bias_then_norm_order(groups, dtype,
                                                            gate):
    """The folded block against the former order, the conv with its bias
    (rounded to the compute dtype), then the norm, then LeakyReLU: the same
    function, within FOLD_TOL."""
    blk = _block(groups, dtype, gate)
    x = torch.randn(2, 16, 6, 8, 10).to(dtype)
    with torch.no_grad():
        got = blk(x).float()
        want = F.leaky_relu_(former_norm(
            blk.conv(x), blk.norm.weight, blk.norm.bias, 1e-5, groups,
            gate), 0.01).float()
    rtol, atol = FOLD_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    assert (want.abs() > 1).any()


def test_plain_writes_out_and_leaves_x_out_of_place():
    x, scale, bias = _inputs((2, 8, 4, 4, 6), 8, torch.bfloat16, seed=2)
    mean, rstd = torch.randn(2, 1), torch.rand(2, 1) + 0.5
    x0 = x.clone()
    y = ke.norm_apply(x, mean, rstd, scale, bias, 8, slope=0.01)
    assert torch.equal(x, x0) and y.data_ptr() != x.data_ptr()
    out = torch.empty_like(x)
    assert ke.norm_apply(x, mean, rstd, scale, bias, 8, 0.01, out=out) \
        is out and torch.equal(out, y)


# serving norms of the bone_turbo student at tile batch 8: (rows, S)
SERVING = {
    "stage0_and_last_decoder": (8 * 128, 80 * 48 * 48),
    "stage1_32ch": (8 * 32, 80 * 48 * 48),
    "stage2_64ch": (8 * 64, 40 * 24 * 24),
    "stage3_2880": (8 * 128, 20 * 12 * 12),
    "stage4_360": (8 * 160, 10 * 6 * 6),
    "stage5_45": (8 * 160, 5 * 3 * 3),
}


@pytest.mark.parametrize("name", sorted(SERVING))
def test_launch_plan_covers_every_row_once(name):
    """Each row's units, split into ``chunks`` blocks of ``threads`` x 4,
    are covered once, no block lies past its row, and the 16-byte path is
    taken exactly where a row is whole 16-byte units."""
    rows, S = SERVING[name]
    plan = ke.launch_plan(rows, S, 2)
    assert plan["vec"] == (S * 2 % 16 == 0)
    units = S // 8 if plan["vec"] else S
    span = ke.UNROLL * plan["threads"]
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 256
    assert (plan["chunks"] - 1) * span < units <= plan["chunks"] * span
    assert plan["blocks"] == rows * plan["chunks"]


def test_launch_plan_edges():
    assert ke.launch_plan(1280, 45, 2) == {"vec": False, "threads": 32,
                                           "chunks": 1, "blocks": 1280}
    # the serving stage-0 rows: 23,040 units, 23 blocks of 1024 a row
    big = ke.launch_plan(1024, 184320, 2)
    assert (big["vec"], big["threads"], big["chunks"]) == (True, 256, 23)
    # a misaligned base takes the element path whatever S is
    assert not ke.launch_plan(4, 4096, 2, aligned=False)["vec"]
    assert ke.launch_plan(4, 4096, 4)["vec"]
