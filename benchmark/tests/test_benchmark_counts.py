"""The yardstick's arithmetic: bytes per launch against the kernel
table's pins, FLOPs against a hand count, the frozen grid, air rule and
phantom against the port's own, and the plain reference against the
port's network at float32."""
import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark.harness import common, grid, phantom, weights
from benchmark.reference import serve as ref_serve
from benchmark.reference.unet import PlainUNet
from benchmark.tests import tiny


def config(name):
    with open(os.path.join(common.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_bytes_match_the_kernel_table():
    # PERF.md: A serving (8, 128, 80, 48, 48) bf16; B 23 owned rows of a
    # (48, 256, 112, 488) accumulator, retired; C 8 live tiles of a batch
    assert grid.bytes_a((8, 128, 80, 48, 48)) == 377_495_552
    assert grid.bytes_b(23, (256, 112), 61, zeroes=True) == 1_292_533_760
    coords = np.array([[y, z] for y in (92, 115, 138, 162) for z in (0, 23)])
    assert grid.bytes_c(coords, np.ones(8), 48, (48, 80), (256, 112), 16,
                        61) == 1_522_199_968


@pytest.mark.parametrize("shape,launches,nbytes", [
    # PERF.md's rows of kernel E, the s2d student's norms a forward
    ((8, 128, 80, 48, 48), 4, 754_974_720),
    ((8, 32, 80, 48, 48), 4, 188_743_680),
    ((8, 64, 40, 24, 24), 4, 47_185_920),
    ((8, 128, 20, 12, 12), 4, 11_796_480),
    ((8, 160, 10, 6, 6), 4, 1_843_200),
    ((8, 160, 5, 3, 3), 2, 230_400),
])
def test_kernel_e_bytes_match_the_kernel_table(shape, launches, nbytes):
    assert grid.bytes_e(shape) == nbytes
    c = config("bone_turbo")
    shapes = grid.gated_norm_shapes(c["network"], (96, 96, 160), 8, s2d=True,
                                    min_voxels=0)
    # engine order (the patch sorted by extent): the table's axes turned
    engine = shape[:2] + (shape[3], shape[4], shape[2])
    assert shapes.count(engine) == launches
    assert len(shapes) == 22


def test_conv_stage_flops_by_hand():
    # the teacher's stage 0 at 160x96x96, 1x3x3: 1 -> 32, 32 -> 32; its
    # stage 1 (stride 1x2x2) at 160x48x48, 3x3x3: 32 -> 64, 64 -> 64
    t = config("teacher_3d_fullres")["network"]
    v0, v1 = 160 * 96 * 96, 160 * 48 * 48
    by_hand = 2 * 9 * (32 + 32 * 32) * v0 + 2 * 27 * (32 * 64 + 64 * 64) * v1
    assert grid.conv_flops(1, 32, t["kernel_sizes"][0], v0) + \
        grid.conv_flops(32, 32, t["kernel_sizes"][0], v0) + \
        grid.conv_flops(32, 64, t["kernel_sizes"][1], v1) + \
        grid.conv_flops(64, 64, t["kernel_sizes"][1], v1) == by_hand
    assert grid.unet_stages(t, (160, 96, 96))[:2] == [
        (32, (160, 96, 96)), (64, (160, 48, 48))]
    arch = tiny.arch([4, 8])
    p = (8, 8, 8)
    # enc: 1->4, 4->4 at 512 voxels; 4->8, 8->8 at 64; transp 8->4 over
    # 64 inputs x 8; dec 8->4, 4->4 at 512; head 4->5 at 512
    want = 2 * (27 * (4 + 16) * 512 + 27 * (32 + 64) * 64 + 8 * 32 * 64
                + 27 * (32 + 16) * 512 + 4 * 5 * 512)
    assert grid.unet_forward_flops(arch, 1, 5, p, False) == want


def test_teacher_step_flops():
    t = config("teacher_3d_fullres")
    f = grid.unet_forward_flops(t["network"], 1, 61, (160, 96, 96), True)
    assert 7.9e11 < f < 8.1e11
    # PERF.md's planned-teacher row: 4 shapes, 8 launches each a train step
    # (the forward's 4 and remat's 4)
    shapes = grid.gated_norm_shapes(t["network"], (160, 96, 96), 2,
                                    s2d=False)
    assert sorted(set(shapes)) == [(2, 32, 160, 96, 96),
                                   (2, 64, 160, 48, 48), (2, 128, 80, 24, 24),
                                   (2, 256, 40, 12, 12)]
    assert len(shapes) == 16


def test_serving_kernel_a_launches_per_forward():
    c = config("bone_turbo")
    shapes = grid.gated_norm_shapes(c["network"], (96, 96, 160), 8, s2d=True)
    assert len(shapes) == 12 and shapes[0] == (8, 128, 48, 48, 80)


@pytest.mark.parametrize("new", [(140, 170, 200), (96, 96, 160),
                                 (301, 287, 163)])
def test_grid_matches_the_engine(new):
    from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
    net = torch.nn.Identity()
    eng = SlidingWindowEngine(net, (96, 96, 160), 5, device="cpu")
    vol, steps = grid.sweep_plan(new, (96, 96, 160), 0.5)
    assert (vol, steps) == eng.s2d_sweep_plan(new)
    sx, cb, vb = eng.sweep_tiles(steps)
    coords, valid = grid.plane_batches(steps, 8)
    assert np.array_equal(cb[..., 1:], coords) and np.array_equal(vb, valid)


def test_air_rule_matches_the_pipeline():
    from fast_nnunet_tpu_torch.inference.turbo import air_flags
    files = tiny.serve_files()
    cfg = files["config"]
    gen = torch.Generator().manual_seed(3)
    ct = phantom.make_ct((120, 120, 60), gen, "cpu").numpy()
    vol, geo, fill, thr = ref_serve.preprocess(cfg, ct, (2.5, 2.5, 2.5),
                                               torch.device("cpu"))
    flags, coords, valid = ref_serve.body_tiles(cfg, vol, geo, fill, thr)
    tf, _, _, _, steps = geo
    patch = [cfg["serving"]["patch_size"][a] for a in tf]
    full = np.concatenate([np.zeros(coords.shape[:2] + (1,), np.int64),
                           coords], -1)
    theirs = air_flags(vol.to(torch.bfloat16), steps[0], patch, full, fill,
                       thr)
    assert np.array_equal(flags, (theirs * valid[None]) > 0)
    assert flags.any() and not flags.all()


def test_phantom_matches_the_port():
    from fast_nnunet_tpu_torch.utils.synthetic_ct import make_synthetic_ct
    ct, _ = make_synthetic_ct((24, 20, 16), seed=0)
    ours = phantom.make_ct((24, 20, 16), torch.Generator().manual_seed(0),
                           "cpu").permute(2, 1, 0).numpy()
    body = ct > -900
    # the same anatomy; the noise comes from another generator
    assert np.array_equal(body, ours > -900)
    assert abs(int(ct[~body].mean()) - int(ours[~body].mean())) == 0


@pytest.mark.parametrize("topology", ["isotropic", "planned"])
def test_reference_matches_the_port_network(topology):
    from fast_nnunet_tpu_torch.models.factory import \
        build_network_from_arch_dict
    from fast_nnunet_tpu_torch.models.unet import params_from_jax
    arch = (tiny.arch if topology == "isotropic" else tiny.planned_arch)(
        [4, 8, 16])
    t_dev, t_np = weights.make_tree(arch, 1, 5, 7, "cpu")
    from benchmark.harness.train import _arch
    net = build_network_from_arch_dict(_arch({"network": arch}), 1, 5,
                                       compute_dtype=torch.float32)
    params_from_jax(net, t_np)
    x = torch.randn(2, 1, 16, 16, 16, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        theirs = net(x, deep_supervision=True)
        ours = PlainUNet(arch, t_dev)(x, deep_supervision=True)
    assert len(theirs) == len(ours) == 2
    for a, b in zip(theirs, ours):
        assert torch.allclose(a.float(), b, atol=1e-4, rtol=1e-4)


def test_weights_are_seeded():
    arch = tiny.arch([4, 8])
    a, an = weights.make_tree(arch, 1, 3, 2 ** 40 + 5, "cpu")
    b, _ = weights.make_tree(arch, 1, 3, 2 ** 40 + 5, "cpu")
    k = ("params", "encoder", "stage_0", "block_0", "conv", "kernel")
    va, vb = a, b
    for p in k:
        va, vb = va[p], vb[p]
    assert torch.equal(va, vb)
    assert math.isclose(float(va.std()), math.sqrt(2 / 27), rel_tol=0.5)


def test_trace_reading():
    from benchmark.harness import trace
    ev = [{"ph": "X", "cat": "kernel", "name": "spatial_sum_sumsq_kernel<bf16>",
           "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 40,
           "dur": 20},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 12,
           "dur": 30},
          {"ph": "X", "cat": "user_annotation", "name": "serve.predict_volume",
           "ts": 0, "dur": 70}]
    r = trace.read({"traceEvents": ev})
    assert r["busy_s"] == 35e-6 and r["window_s"] == 60e-6
    assert r["kernels"] == {"A": (10e-6, 1)}
    assert r["idle_gaps"] == [["aten::copy_", 25e-6]]
    assert r["device_ops"][0] == ["Memcpy DtoH", 20e-6]


def test_ds_targets_take_voxel_centres():
    # nnU-Net v2's DownsampleSegForDSTransform: nearest-exact, so a level
    # at half the size takes voxels 1, 3, 5, ... of each axis
    from benchmark.reference.train import ds_targets
    x = torch.arange(8).view(1, 1, 1, 8).expand(2, 4, 8, 8).contiguous()
    levels = ds_targets(x, [[1, 1, 1], [2, 2, 2], [1, 2, 2]])
    assert [tuple(t.shape) for t in levels] == [(2, 4, 8, 8), (2, 2, 4, 4)]
    assert torch.equal(levels[0], x)
    assert levels[1][0, 0, 0].tolist() == [1, 3, 5, 7]


def test_split_metrics_share_a_reader():
    assert common.metric_reader("idle.serve")({"trace": {
        "busy_s": 3.0, "window_s": 4.0}}) == 25.0
    assert common.metric_reader("idle.train")({}) is None
    with pytest.raises(FileNotFoundError):
        common.metric_reader("no_such.metric")
