"""Kernels C and B (fast_nnunet_tpu_torch/ops/{s2d_accumulate,finalize}.py)
on the CPU, at the geometries their CUDA designs must get right: the plain
versions against the JAX package (Pallas in interpret mode, the nominal-
precision XLA replica of the bf16 sweep), and the host-side launch plans and
choices the kernels follow. The kernels themselves are held bit-exact against
the plain versions on the card (tests/test_torch_kernels_cuda.py)."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.ops.pallas_finalize import grouped_argmax as jax_argmax
from fast_nnunet_tpu.ops.pallas_s2d import fused_head_gauss_accumulate
from fast_nnunet_tpu_torch.ops import _build
from fast_nnunet_tpu_torch.ops import finalize as kb
from fast_nnunet_tpu_torch.ops import s2d_accumulate as kc
from tools.ablate_s2d_accumulate import VARIANTS as ABLATIONS

from .test_torch_s2d_accumulate import _bf16, _port_args, _xla_accumulate_batch
from .torch_port_common import no_persistent_compile_cache  # noqa: F401

# the main path's captured call: accumulator (p0h, Yh, Zh, 8K), features
# (B, 8F, p0h, pyh, pzh), a full batch of 8 live tiles of a 512 x 512 x 500
# CT at step 0.5 (the y- and z-starts chip_smoke.py captures)
MAIN = {"acc": (48, 256, 112, 488), "F": 16, "K": 61, "pyh": 48, "pzh": 80,
        "coords": np.array([[y, z] for y in (92, 115, 138, 162)
                            for z in (0, 23)], np.int32)}


def _case(B, p0h, pyh, pzh, K, F, Yh, Zh, seed):
    """acc, channels-last feats (the JAX layout), gaussian, block-diagonal
    head (8F, 8K), bias — all bf16-representable."""
    rng = np.random.RandomState(seed)
    acc = rng.randn(p0h, Yh, Zh, 8 * K).astype(np.float32)
    feats = rng.randn(B, p0h, pyh, pzh, 8 * F).astype(np.float32)
    g = np.abs(rng.randn(p0h, pyh, pzh, 8)).astype(np.float32)
    w = np.zeros((8 * F, 8 * K), np.float32)
    for o in range(8):
        w[o * F:(o + 1) * F, o * K:(o + 1) * K] = rng.randn(F, K) * 0.3
    b = (rng.randn(8 * K) * 0.1).astype(np.float32)
    return acc, _bf16(feats), g, _bf16(w), _bf16(b)


# ----------------------------------------------------- kernel C, plain: f32
@pytest.mark.parametrize("geo", [
    # K = 61 (odd), pzh = 24 (not a multiple of the 16-z segment), tiles on
    # the plane's far y and z edges
    dict(B=3, p0h=2, pyh=4, pzh=24, K=61, F=2, Yh=8, Zh=48,
         coords=[[4, 24], [0, 0], [4, 0]], valid=[1, 1, 1]),
    # pzh = 40 crossing segments; the last slot is padding
    dict(B=3, p0h=3, pyh=4, pzh=40, K=3, F=4, Yh=12, Zh=80,
         coords=[[8, 40], [0, 8], [0, 8]], valid=[1, 1, 0]),
    # one tile covering the whole plane
    dict(B=1, p0h=2, pyh=6, pzh=16, K=5, F=2, Yh=6, Zh=16,
         coords=[[0, 0]], valid=[1]),
])
def test_plain_c_f32_matches_pallas(geo):
    acc, feats, g, w, b = _case(geo["B"], geo["p0h"], geo["pyh"],
                                geo["pzh"], geo["K"], geo["F"], geo["Yh"],
                                geo["Zh"], seed=3)
    coords = np.array(geo["coords"], np.int32)
    ref = fused_head_gauss_accumulate(
        jnp.asarray(acc), jnp.asarray(feats, jnp.bfloat16), jnp.asarray(g),
        jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        jnp.asarray(coords), jnp.int32(int(sum(geo["valid"]))),
        interpret=True)
    f, wb, bb = _port_args(feats, w, b, torch.bfloat16)
    got = kc.s2d_accumulate_plain(torch.from_numpy(acc.copy()), f,
                                  torch.from_numpy(g), wb, bb, coords,
                                  geo["valid"])
    # the Pallas kernel fuses multiply-add; f32 rounding apart, equal
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------- kernel C, plain: bf16
@pytest.mark.parametrize("geo", [
    # overlapping tiles whose z-spans cross 16-z segment boundaries, an
    # invalid slot in the middle
    dict(B=5, row_base=0, coords=[[0, 3], [2, 13], [2, 13], [1, 21], [3, 0]],
         valid=[1, 1, 0, 1, 1]),
    # B = 32, the kernel's largest batch: heavy overlap, every 5th slot off
    dict(B=32, row_base=0, coords=[[(3 * t) % 5, (7 * t) % 25]
                                   for t in range(32)],
         valid=[float(t % 5 != 2) for t in range(32)]),
    # a rotated row origin
    dict(B=4, row_base=3, coords=[[0, 0], [2, 17], [4, 9], [1, 24]],
         valid=[1, 1, 1, 1]),
])
def test_plain_c_bf16_matches_nominal_xla(geo):
    """Bit for bit against the JAX sweep's bf16 accumulate_batch compiled
    with XLA's nominal bf16 roundings (see test_torch_s2d_accumulate.py for
    the default build's excess-precision difference)."""
    B, p0h, K, r = geo["B"], 4, 3, geo["row_base"]
    acc, feats, g, w, b = _case(B, p0h, 4, 16, K, 2, 8, 41, seed=4)
    g = g * 10.0
    acc = _bf16(acc)
    coords = np.array(geo["coords"], np.int32)
    valid = np.array(geo["valid"], np.float32)
    base = np.roll(acc, -r, axis=0)  # the replica writes rows from 0
    args = (jnp.asarray(base, jnp.bfloat16), jnp.asarray(feats, jnp.bfloat16),
            jnp.asarray(g), jnp.asarray(w, jnp.bfloat16),
            jnp.asarray(b, jnp.bfloat16), jnp.asarray(coords),
            jnp.asarray(valid))
    nominal = _xla_accumulate_batch.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    ref = np.roll(np.asarray(nominal(*args), np.float32), r, axis=0)
    f, wb, bb = _port_args(feats, w, b, torch.bfloat16)
    got = kc.s2d_accumulate_plain(torch.from_numpy(acc).bfloat16(), f,
                                  torch.from_numpy(g), wb, bb, coords, valid,
                                  row_base=r).float().numpy()
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------ kernel B, plain
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rows,row_base", [(3, 2), (4, 1)])
def test_plain_b_matches_pallas_all_rows_retired(dtype, n_rows, row_base):
    """c8p = 8K = 488 (K = 61, the main path's lanes), every finalized row
    retired (n_zero = n_rows) and a row origin that wraps."""
    K, p0h = 61, 4
    rng = np.random.RandomState(5)
    acc = (np.round(rng.randn(p0h, 8, 12, 8 * K) * 2) / 2).astype(np.float32)
    jacc = jnp.asarray(acc, getattr(jnp, dtype))
    cls_j, acc_j = jax_argmax(jacc, K, n_rows, row_base=row_base,
                              n_zero=n_rows, y_block=8, interpret=True)
    # a writable copy: the plain version zeroes rows in place
    tacc = torch.from_numpy(np.array(jacc, np.float32)).to(
        getattr(torch, dtype))
    cls_t = kb.grouped_argmax(tacc, K, n_rows, row_base=row_base,
                              n_zero=n_rows)
    np.testing.assert_array_equal(cls_t.numpy(), np.asarray(cls_j))
    np.testing.assert_array_equal(tacc.float().numpy(),
                                  np.asarray(acc_j, np.float32))


# ------------------------------------------------ kernel C's fused head dot
@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("feat_dtype", ["bfloat16", "float32"])
def test_plain_c_takes_bf16_weights_as_their_f32_values(acc_dtype,
                                                        feat_dtype):
    """The engine passes the head in its bf16 compute dtype (kernel C fuses
    its dot for bf16 features and bf16 weights); the plain version reads
    those weights as the f32 values they convert to exactly."""
    acc, feats, g, w, b = _case(3, 2, 4, 24, 61, 16, 8, 48, seed=8)
    coords = np.array([[4, 24], [0, 0], [2, 13]], np.int32)
    f, wb, bb = _port_args(feats, w, b, getattr(torch, feat_dtype))
    a0 = torch.from_numpy(acc).to(getattr(torch, acc_dtype))
    got = kc.s2d_accumulate_plain(a0.clone(), f, torch.from_numpy(g),
                                  wb.bfloat16(), bb, coords, [1, 1, 1])
    ref = kc.s2d_accumulate_plain(a0.clone(), f, torch.from_numpy(g),
                                  wb.float(), bb, coords, [1, 1, 1])
    assert torch.equal(got, ref)


@pytest.mark.parametrize("exponents,exact", [
    ((-20, 20), True),     # products in f32's normal range
    ((-70, -60), False),   # products under it: the documented exception
])
def test_fma_premise_bf16_products_exact_in_f32(exponents, exact):
    """bf16 x bf16 products in the normal range are exact in f32 (8 + 8
    significant bits), so one FMA rounds where multiply-then-add does; a
    product under 2^-126 may not be, and there the fused dot may differ."""
    rng = np.random.RandomState(7)
    lo, hi = exponents
    x = torch.from_numpy((rng.randn(4096) * 2.0 ** rng.randint(
        lo, hi, 4096)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.randn(4096) * 2.0 ** rng.randint(
        lo, hi, 4096)).astype(np.float32)).bfloat16()
    p32 = x.float() * w.float()
    assert torch.equal(p32.double(), x.double() * w.double()) is exact


@pytest.mark.parametrize("shape,seg", [("main", 16), ("small", 16),
                                       ("f32_edge", 8), ("wide_head", 16)])
def test_c_launch_plan(shape, seg):
    if shape == "main":
        acc, F, K, pyh, pzh = MAIN["acc"], MAIN["F"], MAIN["K"], \
            MAIN["pyh"], MAIN["pzh"]
        coords, itemsize = MAIN["coords"], 2
    elif shape == "small":
        acc, F, K, pyh, pzh = (4, 40, 72, 56), 8, 7, 12, 40
        coords = np.array([[0, 3], [6, 20], [28, 32]], np.int32)
        itemsize = 2
    elif shape == "wide_head":  # F = 48: weights past 32 read through L1
        acc, F, K, pyh, pzh = MAIN["acc"], 48, MAIN["K"], MAIN["pyh"], \
            MAIN["pzh"]
        coords, itemsize = MAIN["coords"], 2
    else:  # f32 accumulator, K = 255 (uint8's largest), F = 32
        acc, F, K, pyh, pzh = (4, 40, 72, 2040), 32, 255, 12, 40
        coords = np.array([[0, 0], [28, 32]], np.int32)
        itemsize = 4
    plan = kc.launch_plan(acc, itemsize, F, K, pyh, pzh, coords)
    Zh = acc[2]
    assert plan["seg"] == seg  # 16 z, or 8 where 16 does not fit
    assert plan["smem"] <= kc.SMEM_LIMIT
    assert plan["y_lo"] == coords[:, 0].min()
    assert plan["y_hi"] == coords[:, 0].max() + pyh
    # segments tile the live z-span: each covered z in exactly one segment
    segs = [(s * seg, min((s + 1) * seg, Zh))
            for s in range(plan["seg_lo"], plan["seg_hi"])]
    covered = np.zeros(Zh, int)
    for lo, hi in segs:
        covered[lo:hi] += 1
    for z0 in coords[:, 1]:
        assert (covered[z0:z0 + pzh] == 1).all()
    assert covered.max() == 1
    # every lane pair has a thread in some pass
    assert plan["n_pass"] * kc.THREADS >= 8 * plan["lane_pairs"] >= 4 * K
    # buffers in order, 16-byte aligned, step list sized for the worst line
    offs = [plan["piece_off"], plan["fb_off"], plan["gb_off"],
            plan["steps_off"], plan["segs_off"]]
    assert offs == sorted(offs) and all(o % 16 == 0 for o in offs)
    assert plan["piece_off"] >= seg * acc[3] * itemsize
    assert plan["segs_off"] - plan["steps_off"] == \
        16 * len(segs) * len(coords)


@pytest.mark.parametrize("dtype,pzh,offset,expect", [
    ("bfloat16", 80, 0, True),    # the main path (any tile z-start)
    ("float32", 80, 0, False),    # f32 features: z by z
    ("bfloat16", 44, 0, False),   # rows not whole 16-byte chunks
    ("bfloat16", 80, 1, False),   # a view 2 bytes off alignment
])
def test_feature_runs_16b(dtype, pzh, offset, expect):
    base = torch.zeros(2 * 8 * 2 * 2 * pzh + 8, dtype=getattr(torch, dtype))
    feats = base[offset:offset + 2 * 8 * 2 * 2 * pzh].view(2, 8, 2, 2, pzh)
    assert kc.feature_runs_16b(feats) is expect


@pytest.mark.parametrize("acc,itemsize,K,run", [
    (MAIN["acc"], 2, 61, 32),        # the main path: 61 units, odd
    ((48, 256, 112, 488), 4, 61, 32),  # f32: 122 units, padded to 123
    ((4, 8, 37, 2040), 4, 255, 16),    # uint8's largest K in f32
])
def test_b_launch_plan(acc, itemsize, K, run):
    plan = kb.launch_plan(acc, itemsize, K)
    assert plan["run"] == run and plan["threads"] == 8 * run <= 256
    assert plan["stride16"] % 2 == 1                   # distinct bank groups
    assert plan["stride16"] * 16 >= 8 * K * itemsize   # holds lanes [0, 8K)
    assert plan["smem"] == run * plan["stride16"] * 16 <= kb.SMEM_LIMIT
    assert plan["n_runs"] * run >= acc[2] > (plan["n_runs"] - 1) * run


def test_parse_ptxas():
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_121grouped_argmax_kernelIfEEvPT_iiiiiiiiiiPh' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_121grouped_argmax_kernelIfEEvPT_iiiiiiiiiiPh\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 28 registers, used 1 barriers, 8 bytes smem, "
        "416 bytes cmem[0]\n")
    (name, info), = _build.parse_ptxas(log).items()
    assert "grouped_argmax_kernel" in name
    assert info == {"registers": 28, "static_smem": 8, "stack": 0,
                    "spill_stores": 8, "spill_loads": 4}


@pytest.mark.parametrize("macro", sorted({
    d.split("=")[0] for ds in ABLATIONS.values() for d in ds}))
def test_ablation_switches_are_kernel_macros(macro):
    """Every switch tools/ablate_s2d_accumulate.py builds with is a macro
    kernel C defaults to 0 and reads, so no ablated build is the full
    kernel under another name."""
    with open(os.path.join(_build.CSRC, "s2d_accumulate.cu")) as f:
        src = f.read()
    assert re.search(rf"#ifndef {macro}\b.*\n#define {macro} 0\n", src)
    assert src.count(macro) >= 3
