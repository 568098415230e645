"""Kernel A's launch plan (fast_nnunet_tpu_torch/ops/stats.py launch_plan) on
the CPU, at every shape the port launches the kernel with and at the edges
its CUDA design must get right: the per-block voxel ranges cover each row
exactly once, the split stays within the cluster limit, the serving calls
keep one block per row, and summing each block's range and then the
partials in rank order (what the cluster does) agrees with the plain
version. The kernel itself is held against the plain version on the card
(tests/test_torch_kernels_cuda.py)."""
import glob
import os
import re

import numpy as np
import pytest
import torch

from fast_nnunet_tpu_torch.ops import _build
from fast_nnunet_tpu_torch.ops import stats as ka

# name: (rows, S, itemsize, forced k or None)
CASES = {
    # s2d serving: tile batch 8, 8 offsets x 16 / 32 features
    "serving_stage0": (1024, 80 * 48 * 48, 2, None),
    "serving_stage1": (2048, 40 * 24 * 24, 2, None),
    # the teacher's training calls (features 32, 64, 128; batch 2)
    "teacher_stage0": (64, 160 * 96 * 96, 2, None),
    "teacher_stage1": (128, 80 * 48 * 48, 2, None),
    "teacher_stage2": (256, 40 * 24 * 24, 2, None),
    # the distillation student's (r = 2: features 16, 32, 64)
    "student_stage0": (32, 160 * 96 * 96, 2, None),
    "student_stage1": (64, 80 * 48 * 48, 2, None),
    "student_stage2": (128, 40 * 24 * 24, 2, None),
    # ragged: rows not whole 16-byte units (the element path)
    "ragged_f32": (2, 4097, 4, None),
    "ragged_bf16": (3, 4099, 2, None),
    "ragged_split": (2, 300001, 2, 8),
    # a single row, split by the plan's own rule
    "single_row": (1, 300000, 2, None),
    # S under one block's stride (256 threads x 16 bytes), split or not
    "tiny_vec": (4, 100, 4, None),
    "tiny_split": (2, 100, 4, 8),
    "tiny_ragged": (2, 37, 2, 2),
}
SERVING = ("serving_stage0", "serving_stage1")


def _plan(name):
    rows, S, itemsize, k = CASES[name]
    plan = ka.launch_plan(rows, S, itemsize) if k is None else \
        ka._split_plan(rows, S, itemsize, k)
    return rows, S, itemsize, plan


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_covers_every_voxel_once(name):
    rows, S, itemsize, plan = _plan(name)
    k, chunk = plan["k"], plan["chunk"]
    assert 1 <= k <= plan["cluster_limit"] == ka.CLUSTER_MAX == 8
    assert plan["blocks"] == rows * k
    if name in SERVING:
        assert k == 1            # rows enough to fill the card: no cluster
    # block r of a row: the kernel's [min(r * chunk, S), min(... + chunk, S))
    assert plan["ranges"] == tuple(
        (min(r * chunk, S), min(min(r * chunk, S) + chunk, S))
        for r in range(k))
    covered = np.zeros(S, np.int64)
    for start, end in plan["ranges"]:
        covered[start:end] += 1
    assert (covered == 1).all()
    assert k * chunk >= S > (k - 1) * chunk or CASES[name][3] is not None
    assert plan["vec"] == (S * itemsize % 16 == 0)
    if plan["vec"]:  # every block starts on 16 bytes (rows are whole units)
        assert all(start * itemsize % 16 == 0 for start, _ in plan["ranges"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_sum_in_rank_order_matches_plain(name):
    """Each block's range summed in f32, then the k partials in rank order
    (the cluster's combine), against the plain version's f64 sums, within
    the kernel's tolerance; two rows of the call's row length."""
    rows, S, itemsize, plan = _plan(name)
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    rng = np.random.RandomState(len(name))
    x = torch.from_numpy((rng.randn(1, 2, S) * 2 + 1).astype(np.float32)
                         ).to(dtype)
    xs = x.float().numpy()[0]
    s_ref, q_ref = ka.spatial_sum_sumsq_plain(x)
    for row in range(2):
        s = q = np.float32(0)
        for start, end in plan["ranges"]:
            part = xs[row, start:end]
            s = np.float32(s + part.sum(dtype=np.float32))
            q = np.float32(q + (part * part).sum(dtype=np.float32))
        scale = float(np.abs(xs[row]).sum())
        assert abs(float(s) - float(s_ref[0, row])) <= 1e-5 * scale + 1e-6
        assert abs(float(q) - float(q_ref[0, row])) <= \
            1e-5 * float(q_ref[0, row]) + 1e-6


def test_plan_rule_at_training_shapes():
    """The training calls split while the call keeps at most 2 blocks per
    SM, never below 64 KB a block (the measured best on an H100); deeper,
    smaller rows split less."""
    k = {name: _plan(name)[3]["k"] for name in CASES}
    assert k["teacher_stage0"] == 4 and k["student_stage0"] == 8
    assert k["teacher_stage1"] == 2 and k["student_stage1"] == 4
    assert k["teacher_stage2"] == k["student_stage2"] == 1
    for name, (rows, S, itemsize, forced) in CASES.items():
        if forced is None and k[name] > 1:
            assert S * itemsize / k[name] >= ka.MIN_BLOCK_BYTES
            assert rows * k[name] <= ka.BLOCKS_PER_SM * 132


def test_plan_rejects_a_split_past_the_cluster_limit():
    """The portable cluster size is the limit: no plan splits a row over
    more blocks, forced or chosen (one row of the largest call, 1024 SMs)."""
    with pytest.raises(ValueError):
        ka._split_plan(1, 4096, 2, 16)
    assert ka.launch_plan(1, 160 * 96 * 96, 2, 1024)["k"] == ka.CLUSTER_MAX


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_the_c_entry_point(name):
    """Each entry point's ctypes argument list has as many arguments as its
    extern "C" definition in csrc/*.cu (a mismatch would pass garbage)."""
    src = "".join(open(p).read()
                  for p in glob.glob(os.path.join(_build.CSRC, "*.cu")))
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m is not None
    assert len(m.group(1).split(",")) == len(_build.SIGNATURES[name])
