#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fast_nnunet_tpu_torch) on one NVIDIA
GPU — the quickest proof that the port's serving path starts and is right on
the card. Run from the repository root:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), builds the
   hand-written kernels from fast_nnunet_tpu_torch/csrc (timed) and prints
   what ptxas reports for kernels B and C (registers, static shared memory,
   spills, stack).
2. s2d main path at full width: the bone_turbo r=2 distilled student (6
   stages, features 16..160, 61 classes; seeded random weights in the JAX
   package's tree layout, loaded through params_from_jax) over a 512x512x500
   synthetic CT at 0.8x0.8x1.0 mm through ``TurboPipeline.predict_volume``
   with the engine INI's settings (bf16 compute and accumulator, tile batch
   8, air skipping on). One warm run, then timed runs; the first timed run
   is split into phases by CUDA events and its kernel launch counts are read
   (kernels A, B and C must have launched).
3. Kernels A, B, C at that path's shapes, on tensors taken from it, against
   their plain PyTorch versions (A within f32 summation tolerance, B and C
   bit for bit, C in both accumulator modes), timed beside their bound, their
   plain version and, where one exists, a library call; B and C with their
   launch plans, C with whether its features took the 16-byte path.
4. Plain full-res path at full width (bench.py's plain contract): the same
   student as a PlainConvUNet through ``SlidingWindowEngine.
   predict_segmentation`` on a 512^3 (rand - 0.5) * 2 volume, patch
   96x96x160, bf16 compute and sweep accumulator, tile batch 8, 4 GiB
   budget, ``use_fused_accumulate=True``: every accumulate is kernel D. One
   warm run and two timed runs; the first timed run is phased and counted.
5. Kernel D on a batch captured from that path against its plain version,
   bit for bit in bf16 and f32, timed likewise (library yardstick: one
   ``addcmul_`` per tile).
6. Small checks, fp32 with TF32 off: the s2d pipeline and the fused plain
   sweep on a narrow net (on the quantised grid and, with a patch too small
   for 16-aligned strides, on the reference grid; one kernel D launch per
   tile batch), cuda (kernels) vs cpu (plain versions), mask agreement
   >= 0.999; ``NNUNetPredictor`` on the committed golden
   checkpoint reproduces its frozen mask on the card.

7. Training at full width (``train:``): 4 synthetic bone_turbo-scale cases
   (1, 200, 140, 140) written with the port's case store and the plans of
   experiments/bench_train.py (the teacher-width PlainConvUNet, 61 classes,
   patch 160x96x96, batch 2, deep supervision, bf16 compute with float32
   parameters, SGD nesterov 0.99 + poly, the JAX remat rule) through
   ``run_training``: one epoch of 12 iterations and 2 validation iterations,
   then ``perform_actual_validation`` of the fold's one validation case.
   Prints warm seconds per iteration fed (dataloader) and cached (one
   device batch through the step function), CUDA-event phases, peak memory
   with the remat rule and with remat off, kernel A launches per step
   against the count the 4096-voxel gate predicts, FLOPs per step and
   ``mfu``; the loss must be finite and fall over 10 cached steps.
8. Kernel A at the widest training call (captured from the run), forward
   against its plain version and ``autograd.grad`` through
   ``SpatialSumSumsq`` against the plain version's autograd (float32, 1e-5
   relative); the result is A's row's ``train`` fields.
9. Distillation (``distill:``): 5 teacher folds of seeded random teacher
   weights written with the port's ``save_checkpoint``, then
   ``run_distillation_training`` (student r = 2, alpha 0.3, T 3.0) for 8
   iterations: seconds per iteration, kernel A launches per step, seg and
   distill losses (finite).
10. A small training step cuda vs cpu (fp32, TF32 off, deterministic cuDNN,
   3 steps): losses within 1e-4 relative, parameters within 1e-5.

Prints the kernels JSON on its own line (every row with ``bound_share`` =
bound_ms / ms), then last ``{"ok": true, "device": {...}}``. Any failure
exits non-zero without it.
"""
import configparser
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_OPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores

# the bone_turbo teacher (nnU-Net 3d_fullres PlainConvUNet for the bone
# dataset); the served student halves its features (r = 2)
TEACHER_ARCH = {
    "n_stages": 6,
    "features_per_stage": [32, 64, 128, 256, 320, 320],
    "kernel_sizes": [[3, 3, 3]] * 6,
    "strides": [[1, 1, 1]] + [[2, 2, 2]] * 5,
    "n_conv_per_stage": [2] * 6,
    "n_conv_per_stage_decoder": [2] * 5,
    "conv_bias": True,
    "norm_op_kwargs": {"eps": 1e-5, "affine": True},
    "nonlin_kwargs": {"inplace": True},
}
# experiments/bench_train.py's bone_turbo training contract
TRAIN_ARCH = {
    "network_class_name":
        "dynamic_network_architectures.architectures.unet.PlainConvUNet",
    "arch_kwargs": dict(
        TEACHER_ARCH, conv_op="torch.nn.modules.conv.Conv3d",
        norm_op="torch.nn.modules.instancenorm.InstanceNorm3d",
        dropout_op=None, dropout_op_kwargs=None, nonlin="torch.nn.LeakyReLU"),
    "_kw_requires_import": ["conv_op", "norm_op", "dropout_op", "nonlin"],
}
TRAIN_K = 61
TRAIN_PATCH = [160, 96, 96]
TRAIN_CASE = (200, 140, 140)
TRAIN_SPACING = [2.0, 0.9765625, 0.9765625]
TRAIN_DS = "Dataset987_TrainBench"
SMALL_ARCH = {
    "n_stages": 3, "features_per_stage": [8, 16, 32],
    "kernel_sizes": [[3, 3, 3]] * 3, "strides": [[1, 1, 1]] + [[2, 2, 2]] * 2,
    "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [2, 2],
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, n=10, warmup=2):
    """Mean device milliseconds of fn over n calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "fast_nnunet_tpu_torch")):
        print("chip_smoke: fast_nnunet_tpu_torch/ not found next to "
              "chip_smoke.py; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    dev = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from fast_nnunet_tpu_torch.inference.engine import (PhaseTimer,
                                                        SlidingWindowEngine)
    from fast_nnunet_tpu_torch.inference.turbo import (TurboConfig,
                                                       TurboPipeline)
    from fast_nnunet_tpu_torch.models.s2d import (make_s2d_engine_net,
                                                  random_plain_params)
    from fast_nnunet_tpu_torch.models.students import \
        build_student_arch_kwargs
    from fast_nnunet_tpu_torch.ops import _build
    from fast_nnunet_tpu_torch.ops import finalize as kb
    from fast_nnunet_tpu_torch.ops import s2d_accumulate as kc
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.utils.synthetic_ct import make_synthetic_ct

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: kernels built and loaded in "
          f"{time.perf_counter() - t0:.3f} s (nvcc {_build.nvcc_path()})")
    for fn, v in sorted(_build.ptxas_report("_kernel").items()):
        if "s2d_accumulate" in fn or "grouped_argmax" in fn:
            print(f"build: ptxas {fn}: {v.get('registers')} registers, "
                  f"{v.get('static_smem')} B static shared memory, "
                  f"{v.get('spill_stores')} B spill stores, "
                  f"{v.get('spill_loads')} B spill loads, "
                  f"{v.get('stack')} B stack")

    # ------------------------------------------------------------ main path
    ini = os.path.join(HERE, "engine", "config", "fast_nnunet_bone_turbo.ini")
    cfg = TurboConfig.from_ini(ini)
    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    cp.read(ini)
    inf = cp["inference"]
    K = cfg.num_classes
    arch = build_student_arch_kwargs(TEACHER_ARCH, 2)
    net = make_s2d_engine_net(arch, K, 1, compute_dtype=torch.bfloat16)
    net.to(dev)
    tree = net.convert_params(random_plain_params(arch, 1, K, seed=0))
    engine = SlidingWindowEngine(
        net, cfg.patch_size, K, tile_step_size=cfg.step_size,
        use_gaussian=cfg.use_gaussian, compute_dtype=torch.bfloat16,
        sweep_acc_dtype=torch.bfloat16, shape_bucket=32,
        tile_batch=inf.getint("tile_batch", 8), device=dev)
    pipe = TurboPipeline(engine, cfg,
                         air_skip=inf.getboolean("skip_air_tiles", True),
                         air_margin_hu=inf.getfloat("air_margin_hu", 200.0))
    t0 = time.perf_counter()
    ct, spacing = make_synthetic_ct((512, 512, 500), (0.8, 0.8, 1.0), seed=0)
    print(f"main: student features {arch['features_per_stage']}, {K} "
          f"classes, patch {cfg.patch_size}, CT {ct.shape} {ct.dtype} "
          f"(phantom made in {time.perf_counter() - t0:.3f} s)")

    import fast_nnunet_tpu_torch.inference.engine as engine_module
    t0 = time.perf_counter()
    seg0, cap = capture_inputs(
        engine_module, net, lambda: pipe.predict_volume(tree, ct, spacing))
    print(f"main: warm-up run {time.perf_counter() - t0:.3f} s (kernel "
          f"inputs captured from it)")

    kernels = {"spatial_sum_sumsq": ka.spatial_sum_sumsq,
               "grouped_argmax": kb.grouped_argmax,
               "s2d_accumulate": kc.s2d_accumulate}
    for fn in kernels.values():
        fn.launches = 0
    engine.timer = PhaseTimer()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seg = pipe.predict_volume(tree, ct, spacing)
    wall = [time.perf_counter() - t0]
    launches = {name: fn.launches for name, fn in kernels.items()}
    phases = engine.timer.totals()
    engine.timer = None
    peak = torch.cuda.max_memory_allocated()
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.predict_volume(tree, ct, spacing)
        wall.append(time.perf_counter() - t0)
    print("main: launches per CT " + json.dumps(launches))
    print("main: phase ms (CUDA events, counted run) " + json.dumps(
        {k: round(v, 3) for k, v in phases.items()}))
    print(f"main: seconds per CT {[round(w, 4) for w in wall]} "
          f"(best {min(wall):.4f}, first is the counted + event-timed run); "
          f"peak device memory {peak / 2**30:.2f} GiB")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    check(seg.shape == ct.shape and str(seg.dtype) == "uint8",
          f"mask {seg.shape} {seg.dtype} for CT {ct.shape}")
    labels = sorted(int(v) for v in set(seg[::4, ::4, ::4].ravel().tolist()))
    check(max(labels) < K and len(labels) > 1, f"mask labels {labels}")
    repeat = float((seg == seg0).mean())
    print(f"main: mask {seg.shape} uint8, {len(labels)} labels on a 1/64 "
          f"sample; agreement with the warm-up run's mask {repeat:.6f}")
    check(repeat >= 0.999, f"warm-up and counted runs agree only {repeat}")

    # --------------------------------------- kernels at the main path's shapes
    rows = kernel_checks(torch, cap, engine, launches, ka, kb, kc)
    del cap, engine, pipe, net
    torch.cuda.empty_cache()

    # ------------------------------------------- plain full-res path, kernel D
    cap_d, launches_d = plain_main_path(torch, dev, engine_module, K, arch)
    rows.append(kernel_d_check(torch, cap_d, launches_d))
    del cap_d
    torch.cuda.empty_cache()

    # ------------------------------------------- training and distillation
    training_paths(torch, dev, next(r for r in rows
                                    if r["name"] == "spatial_sum_sumsq"))

    # ------------------------------------------- small model: cuda vs cpu
    small_train_step(torch, dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_s = TurboConfig(patch_size=(32, 32, 32),
                        target_spacing=(2.0, 1.6, 1.6), mean=cfg.mean,
                        std=cfg.std, lower_bound=cfg.lower_bound,
                        upper_bound=cfg.upper_bound, num_classes=4)
    ct_s, sp_s = make_synthetic_ct((96, 96, 64), (0.8, 0.8, 1.0), seed=1)
    masks = {}
    for d in ("cuda", "cpu"):
        net_s = make_s2d_engine_net(SMALL_ARCH, 4, 1,
                                    compute_dtype=torch.float32).to(d)
        tree_s = net_s.convert_params(
            random_plain_params(SMALL_ARCH, 1, 4, seed=1))
        eng_s = SlidingWindowEngine(net_s, cfg_s.patch_size, 4,
                                    compute_dtype=torch.float32,
                                    sweep_acc_dtype=torch.float32,
                                    tile_batch=4, device=d)
        masks[d] = TurboPipeline(eng_s, cfg_s, air_skip=True).predict_volume(
            tree_s, ct_s, sp_s)
    agree = float((masks["cuda"] == masks["cpu"]).mean())
    n_lab = len(set(masks["cpu"].ravel().tolist()))
    print(f"small: fp32 whole pipeline cuda (kernels) vs cpu (plain): "
          f"agreement {agree:.6f} on {masks['cpu'].shape}, {n_lab} labels")
    check(agree >= 0.999, f"small cuda/cpu mask agreement {agree} < 0.999")
    check(n_lab > 1, "small check produced a single label")
    small_plain_sweep(torch)
    golden_predictor(torch)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def capture_inputs(engine_module, net, run, c_call=8, b_call=4):
    """Run one main-path call with the sweep's kernel wrappers wrapped, and
    record real inputs: the c_call-th accumulate (the accumulator cloned
    before it), the b_call-th finalize (likewise), and the first stage-0
    conv output (the largest InstanceNorm input). The wrappers are restored
    afterwards. Returns (run's result, captured inputs)."""
    cap = {"c_n": 0, "b_n": 0}
    real_c = engine_module.s2d_accumulate
    real_b = engine_module.grouped_argmax

    def c(acc, feats, g, w, b, coords, valid, row_base=0):
        cap["c_n"] += 1
        if cap["c_n"] <= c_call:
            cap["c"] = (acc.clone(), feats, g, w, b, coords.copy(),
                        valid.copy(), row_base)
        return real_c(acc, feats, g, w, b, coords, valid, row_base)

    def b(acc, num_classes, n_rows, row_base=0, n_zero=0):
        cap["b_n"] += 1
        if cap["b_n"] <= b_call:
            cap["b"] = (acc.clone(), num_classes, n_rows, row_base, n_zero)
        return real_b(acc, num_classes, n_rows, row_base, n_zero)

    def grab(module, inputs, output):  # returns None: output unchanged
        cap.setdefault("a", output)

    hook = net.encoder["stage_0"]["block_0"].conv.register_forward_hook(grab)
    engine_module.s2d_accumulate, engine_module.grouped_argmax = c, b
    try:
        out = run()
    finally:
        engine_module.s2d_accumulate = real_c
        engine_module.grouped_argmax = real_b
        hook.remove()
    check("a" in cap and "b" in cap and "c" in cap,
          f"main path made too few kernel calls to capture: {cap.keys()}")
    return out, cap


def kernel_checks(torch, cap, engine, launches, ka, kb, kc):
    """Each kernel against its plain version on inputs captured from the
    main path's warm-up run."""
    import numpy as np

    K = engine.num_classes
    pyh, pzh = engine.patch_size[1] // 2, engine.patch_size[2] // 2
    acc, feat, g16, w, b, coords, vk, row_base = cap["c"]
    plane_h = tuple(acc.shape[1:3])
    rows = []

    # ---------------------------------------------------- kernel C (both modes)
    def c_pair(acc_in, g):
        a_k, a_p = acc_in.clone(), acc_in.clone()
        kc.s2d_accumulate(a_k, feat, g, w, b, coords, vk, row_base)
        kc.s2d_accumulate_plain(a_p, feat, g, w, b, coords, vk, row_base)
        err = float((a_k.float() - a_p.float()).abs().max())
        scratch = acc_in.clone()
        ms = time_ms(torch, lambda: kc.s2d_accumulate(
            scratch, feat, g, w, b, coords, vk, row_base))
        plain_ms = time_ms(torch, lambda: kc.s2d_accumulate_plain(
            scratch, feat, g, w, b, coords, vk, row_base), n=2, warmup=1)
        return err, ms, plain_ms

    err16, ms16, plain16 = c_pair(acc, g16)
    err32, ms32, plain32 = c_pair(acc.float(),
                                  engine.gaussian_s2d(torch.float32))
    check(err16 == 0.0 and err32 == 0.0,
          f"s2d_accumulate differs from its plain version (bf16 {err16}, "
          f"f32 {err32})")
    n_live = int((vk != 0).sum())
    union = np.zeros(plane_h, bool)
    for (yh, zh), v in zip(coords, vk):
        if v:
            union[yh:yh + pyh, zh:zh + pzh] = True
    S = acc.shape[0] * pyh * pzh
    F = feat.shape[1] // 8
    c_bytes = (2 * int(union.sum()) * acc.shape[0] * 8 * K * 2  # acc RMW
               + n_live * 8 * F * S * feat.element_size()  # features
               + S * 8 * 4 + w.numel() * 4 + b.numel() * 4)
    c_ops = n_live * S * 8 * K * (2 * F + 3)
    bms, bby = bound(c_bytes, c_ops)
    rows.append({
        "name": "s2d_accumulate", "route": "cuda",
        "source": "fast_nnunet_tpu_torch/csrc/s2d_accumulate.cu",
        "replaces": "fast_nnunet_tpu/ops/pallas_s2d.py:167",
        "launches": launches["s2d_accumulate"], "max_abs_err": err16,
        "ms": ms16, "plain_ms": plain16, "bound_ms": bms, "bound_by": bby,
        "library_ms": None, "tolerance": "bit-exact",
        "bytes": c_bytes, "ops": c_ops,
        "shape": f"acc {tuple(acc.shape)} bf16, feats {tuple(feat.shape)}, "
                 f"{n_live} live tiles at (yh0, zh0) "
                 f"{coords[vk != 0].tolist()}, row_base {row_base}",
        "plan": kc.launch_plan(acc.shape, acc.element_size(), F, K, pyh,
                               pzh, coords[vk != 0]),
        "feature_chunks_16B": kc.feature_runs_16b(feat),
        "f32_mode": {"max_abs_err": err32, "ms": ms32, "plain_ms": plain32}})

    # ---------------------------------------------------------- kernel B
    acc_b, _, n_rows, base_b, n_zero = cap["b"]
    a_k, a_p = acc_b.clone(), acc_b.clone()
    cls_k = kb.grouped_argmax(a_k, K, n_rows, base_b, n_zero)
    cls_p = kb.grouped_argmax_plain(a_p, K, n_rows, base_b, n_zero)
    err_b = float((cls_k.int() - cls_p.int()).abs().max())
    check(err_b == 0 and torch.equal(a_k, a_p),
          "grouped_argmax differs from its plain version")
    ms_b = time_ms(torch, lambda: kb.grouped_argmax(a_k, K, n_rows, base_b,
                                                    n_zero))
    plain_b = time_ms(torch, lambda: kb.grouped_argmax_plain(
        a_p, K, n_rows, base_b, n_zero), n=3, warmup=1)
    grouped = acc_b[:n_rows].view(n_rows, *plane_h, 8, K)
    lib_b = time_ms(torch, lambda: torch.argmax(grouped, -1))
    vox = n_rows * plane_h[0] * plane_h[1]
    b_bytes = vox * 8 * K * 2 + vox * 8 + (vox * 8 * K * 2 if n_zero else 0)
    bms, bby = bound(b_bytes, vox * 8 * K)
    rows.append({
        "name": "grouped_argmax", "route": "cuda",
        "source": "fast_nnunet_tpu_torch/csrc/finalize.cu",
        "replaces": "fast_nnunet_tpu/ops/pallas_finalize.py:78",
        "launches": launches["grouped_argmax"], "max_abs_err": err_b,
        "ms": ms_b, "plain_ms": plain_b, "bound_ms": bms, "bound_by": bby,
        "library_ms": lib_b, "tolerance": "bit-exact",
        "plan": kb.launch_plan(acc_b.shape, acc_b.element_size(), K),
        "bytes": b_bytes, "ops": vox * 8 * K,
        "shape": f"acc {tuple(acc_b.shape)} bf16, {n_rows} rows from "
                 f"row_base {base_b}"})

    # ---------------------------------------------------------- kernel A
    x = cap["a"]
    s_k, q_k = ka.spatial_sum_sumsq(x)
    s_p, q_p = ka.spatial_sum_sumsq_plain(x)
    absum = x.float().abs().reshape(x.shape[0], x.shape[1], -1).sum(-1)
    ok = bool(((s_k - s_p).abs() <= 1e-5 * absum + 1e-6).all()
              and ((q_k - q_p).abs() <= 1e-5 * q_p + 1e-6).all())
    err_a = float(max((s_k - s_p).abs().max(), (q_k - q_p).abs().max()))
    check(ok, f"spatial_sum_sumsq outside tolerance (max abs err {err_a})")
    ms_a = time_ms(torch, lambda: ka.spatial_sum_sumsq(x))
    plain_a = time_ms(torch, lambda: ka.spatial_sum_sumsq_plain(x))
    dims = tuple(range(2, x.dim()))
    lib_a = time_ms(torch, lambda: (x.float().sum(dims),
                                    x.float().square().sum(dims)))
    a_bytes = x.numel() * x.element_size() + 2 * x.shape[0] * x.shape[1] * 4
    bms, bby = bound(a_bytes, 3 * x.numel())
    rows.append({
        "name": "spatial_sum_sumsq", "route": "cuda",
        "source": "fast_nnunet_tpu_torch/csrc/stats.cu",
        "replaces": "fast_nnunet_tpu/ops/pallas_stats.py:58",
        "launches": launches["spatial_sum_sumsq"], "max_abs_err": err_a,
        "ms": ms_a, "plain_ms": plain_a, "bound_ms": bms, "bound_by": bby,
        "library_ms": lib_a,
        "tolerance": "|d| <= 1e-5 * sum|x| (sum), 1e-5 * sumsq (sumsq)",
        "bytes": a_bytes, "ops": 3 * x.numel(),
        "shape": f"x {tuple(x.shape)} {str(x.dtype).split('.')[-1]}"})
    for r in rows:
        r["bound_share"] = r["bound_ms"] / r["ms"]
        print(f"kernel {r['name']}: err {r['max_abs_err']} ({r['tolerance']})"
              f", {r['ms']:.4f} ms vs bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, share {r['bound_share']:.3f}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, "
              f"{r['launches']} launches per CT; {r['shape']}")
    return rows


def plain_main_path(torch, dev, engine_module, K, arch, d_call=3, size=512):
    """The plain full-res sweep at full width through
    ``SlidingWindowEngine.predict_segmentation`` (bench.py's plain contract
    with kernel D on). A warm-up run that also captures the d_call-th kernel
    D call (the accumulator cloned before it), then a counted, phased run
    and one more timed run. Returns (captured inputs, launches)."""
    import numpy as np
    from fast_nnunet_tpu_torch.inference.engine import (PhaseTimer,
                                                        SlidingWindowEngine)
    from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
    from fast_nnunet_tpu_torch.models.s2d import random_plain_params
    from fast_nnunet_tpu_torch.ops import scatter_accumulate as kd

    net = get_network_from_plans("PlainConvUNet", arch, (), 1, K,
                                 compute_dtype=torch.bfloat16).to(dev)
    tree = random_plain_params(arch, 1, K, seed=0)
    engine = SlidingWindowEngine(
        net, (96, 96, 160), K, tile_step_size=0.5, use_gaussian=True,
        compute_dtype=torch.bfloat16, sweep_acc_dtype=torch.bfloat16,
        shape_bucket=32, tile_batch=8, max_accumulator_bytes=4 * 1024 ** 3,
        use_fused_accumulate=True, device=dev)
    t0 = time.perf_counter()
    vol = (np.random.RandomState(0).rand(1, size, size, size).astype(
        np.float32) - 0.5) * 2
    vol_shape, starts_x, coords_b, n_real, fused = engine._sweep_grid(
        vol.shape[1:])
    print(f"plain: PlainConvUNet features {arch['features_per_stage']}, {K} "
          f"classes, patch {engine.patch_size}, volume {vol.shape} "
          f"(made in {time.perf_counter() - t0:.3f} s); fused grid {fused}, "
          f"vol_shape {vol_shape}, {len(starts_x)} chunks x "
          f"{len(coords_b)} batches, {len(starts_x) * int(n_real.sum())} "
          f"real tiles")
    check(fused, "the plain path did not take kernel D's grid")

    cap = {"n": 0}
    real_d = engine_module.fused_scatter_accumulate

    def d(acc, logits, gauss_flat, coords, n):
        cap["n"] += 1
        if cap["n"] == d_call:
            cap["d"] = (acc.clone(), logits, gauss_flat, coords.copy(), n)
        return real_d(acc, logits, gauss_flat, coords, n)

    engine_module.fused_scatter_accumulate = d
    t0 = time.perf_counter()
    try:
        seg0 = engine.predict_segmentation(tree, vol)
    finally:
        engine_module.fused_scatter_accumulate = real_d
    print(f"plain: warm-up run {time.perf_counter() - t0:.3f} s (kernel D "
          f"input captured from it)")
    check("d" in cap, f"only {cap['n']} kernel D calls on the plain path")

    kd.fused_scatter_accumulate.launches = 0
    engine.timer = PhaseTimer()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seg = engine.predict_segmentation(tree, vol)
    wall = [time.perf_counter() - t0]
    launches = kd.fused_scatter_accumulate.launches
    phases = engine.timer.totals()
    engine.timer = None
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    engine.predict_segmentation(tree, vol)
    wall.append(time.perf_counter() - t0)
    print(f"plain: kernel D launches per volume {launches} (predicted 80)")
    print("plain: phase ms (CUDA events, counted run) " + json.dumps(
        {k: round(v, 3) for k, v in phases.items()}))
    print(f"plain: seconds per volume {[round(w, 4) for w in wall]} (first "
          f"is the counted + event-timed run); peak device memory "
          f"{peak / 2**30:.2f} GiB (the captured kernel D input included)")
    check(launches > 0, "kernel D was not launched on the plain path")
    check(seg.shape == (size,) * 3 and str(seg.dtype) == "uint8",
          f"plain mask {seg.shape} {seg.dtype}")
    labels = sorted(int(v) for v in set(seg[::4, ::4, ::4].ravel().tolist()))
    check(max(labels) < K and len(labels) > 1, f"plain mask labels {labels}")
    repeat = float((seg == seg0).mean())
    print(f"plain: mask {seg.shape} uint8, {len(labels)} labels on a 1/64 "
          f"sample; agreement with the warm-up run's mask {repeat:.6f}")
    check(repeat >= 0.999, f"plain warm-up and counted runs agree only "
          f"{repeat}")
    return cap["d"], launches


def kernel_d_check(torch, cap, launches):
    """Kernel D against its plain version on the captured batch, in the
    path's bf16 mode and in f32, bit for bit; timed beside its byte bound,
    the plain version and one addcmul_ per tile."""
    import numpy as np
    from fast_nnunet_tpu_torch.ops import scatter_accumulate as kd

    acc, lg, gf, coords, n = cap
    _, px, py, pz, C = lg.shape

    def pair(a_in, l_in, g_in):
        a_k, a_p = a_in.clone(), a_in.clone()
        kd.fused_scatter_accumulate(a_k, l_in, g_in, coords, n)
        kd.fused_scatter_accumulate_plain(a_p, l_in, g_in, coords, n)
        err = float((a_k.float() - a_p.float()).abs().max())
        same = torch.equal(a_k, a_p)
        del a_p
        ms = time_ms(torch, lambda: kd.fused_scatter_accumulate(
            a_k, l_in, g_in, coords, n))
        plain_ms = time_ms(torch, lambda: kd.fused_scatter_accumulate_plain(
            a_k, l_in, g_in, coords, n), n=2, warmup=1)
        g4 = g_in.view(px, py, pz, C)

        def library():
            for b in range(n):
                x, y, z = (int(v) for v in coords[b])
                a_k[x:x + px, y:y + py, z:z + pz].addcmul_(l_in[b], g4)

        lib_ms = time_ms(torch, library, n=3, warmup=1)
        return err, same, ms, plain_ms, lib_ms

    err16, same16, ms16, plain16, lib16 = pair(acc, lg, gf)
    acc32 = acc.float()
    del acc
    err32, same32, ms32, plain32, lib32 = pair(acc32, lg.float(), gf.float())
    check(same16 and same32, f"fused_scatter_accumulate differs from its "
          f"plain version (bf16 {err16}, f32 {err32})")
    occ = np.zeros(acc32.shape[:3], bool)
    for x, y, z in coords[:n]:
        occ[x:x + px, y:y + py, z:z + pz] = True
    union = int(occ.sum()) * C
    tile = px * py * pz * C
    d_bytes = (2 * union + n * tile + gf.numel()) * lg.element_size()
    d_ops = 2 * n * tile
    bms, bby = bound(d_bytes, d_ops)
    row = {
        "name": "fused_scatter_accumulate", "route": "cuda",
        "source": "fast_nnunet_tpu_torch/csrc/scatter_accumulate.cu",
        "replaces": "fast_nnunet_tpu/ops/pallas_kernels.py:143",
        "launches": launches, "max_abs_err": err16,
        "ms": ms16, "plain_ms": plain16, "bound_ms": bms, "bound_by": bby,
        "library_ms": lib16, "tolerance": "bit-exact",
        "bytes": d_bytes, "ops": d_ops,
        "shape": f"acc {tuple(acc32.shape)} bf16, logits {tuple(lg.shape)}, "
                 f"{n} real tiles at {coords[:n].tolist()}",
        "f32_mode": {"max_abs_err": err32, "ms": ms32, "plain_ms": plain32,
                     "library_ms": lib32}}
    row["bound_share"] = bms / ms16
    print(f"kernel {row['name']}: err {err16} (bf16), {err32} (f32), "
          f"{ms16:.4f} ms vs bound {bms:.4f} ms ({bby}, {d_bytes} bytes, "
          f"share {row['bound_share']:.3f}), "
          f"plain {plain16:.4f} ms, library {lib16:.4f} ms, {launches} "
          f"launches per volume; f32: {ms32:.4f} ms, plain {plain32:.4f}, "
          f"library {lib32:.4f}; {row['shape']}")
    return row


def small_plain_sweep(torch):
    """A narrow PlainConvUNet through the fused plain sweep, cuda (kernel D)
    vs cpu (its plain version), fp32: mask agreement >= 0.999. Patch
    (16, 32, 32) takes the quantised grid, (16, 24, 24) (y/z strides under
    16) the reference grid; on both, every tile batch is one launch."""
    import numpy as np
    from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
    from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
    from fast_nnunet_tpu_torch.models.s2d import random_plain_params
    from fast_nnunet_tpu_torch.ops import scatter_accumulate as kd

    vol = np.random.RandomState(2).randn(1, 40, 72, 88).astype(np.float32)
    tree = random_plain_params(SMALL_ARCH, 1, 4, seed=2)
    for patch in ((16, 32, 32), (16, 24, 24)):
        masks, n_k = {}, 0
        for d in ("cuda", "cpu"):
            net = get_network_from_plans("PlainConvUNet", SMALL_ARCH, (), 1,
                                         4, compute_dtype=torch.float32).to(d)
            eng = SlidingWindowEngine(net, patch, 4,
                                      compute_dtype=torch.float32,
                                      sweep_acc_dtype=torch.float32,
                                      tile_batch=2, use_fused_accumulate=True,
                                      device=d)
            n0 = kd.fused_scatter_accumulate.launches
            masks[d] = eng.predict_segmentation_sweep(tree, vol)
            if d == "cuda":
                n_k = kd.fused_scatter_accumulate.launches - n0
                _, starts_x, coords_b, _, _ = eng._sweep_grid(vol.shape[1:])
        n_batches = len(starts_x) * len(coords_b)
        agree = float((masks["cuda"] == masks["cpu"]).mean())
        n_lab = len(set(masks["cpu"].ravel().tolist()))
        print(f"small: patch {patch} fp32 fused plain sweep cuda ({n_k} "
              f"kernel D launches for {n_batches} tile batches) vs cpu "
              f"(plain): agreement {agree:.6f} on {masks['cpu'].shape}, "
              f"{n_lab} labels")
        check(n_k == n_batches > 0,
              f"patch {patch}: {n_k} kernel D launches for {n_batches} "
              f"tile batches")
        check(agree >= 0.999,
              f"patch {patch}: cuda/cpu agreement {agree} < 0.999")
        check(n_lab > 1, f"patch {patch}: a single label")


def golden_predictor(torch):
    """NNUNetPredictor on the committed trained checkpoint, fp32 on the
    card: the frozen golden mask, bit for bit."""
    import numpy as np
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor

    gold = os.path.join(HERE, "tests", "fixtures", "golden_ckpt")
    expected = NiftiIO().read_seg(os.path.join(gold, "expected_mask.nii.gz")
                                  )[0][0].astype(np.uint8)
    p = NNUNetPredictor(use_mirroring=False, device="cuda",
                        compute_dtype=torch.float32)
    p.initialize_from_trained_model_folder(os.path.join(gold, "model"),
                                           use_folds=[0])
    data, props = NiftiIO().read_images([os.path.join(gold,
                                                      "input_0000.nii.gz")])
    seg = p.predict_single_npy_array(data, props).astype(np.uint8)
    same = float((seg == expected).mean())
    print(f"golden: NNUNetPredictor fp32 on the card vs the frozen mask "
          f"{expected.shape}: agreement {same:.6f}")
    check(seg.shape == expected.shape and same == 1.0,
          f"golden mask differs on the card (agreement {same})")


# ------------------------------------------------------------------ training
def write_train_dataset(root, n_cases=4, seed=0):
    """bench_train's synthetic preprocessed cases (one cuboid per class,
    data correlated with the label), with the properties the final
    validation's export needs, and their labels as nnUNet_raw NIfTIs."""
    import numpy as np
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    from fast_nnunet_tpu_torch.training.dataset import NpyCaseDataset
    from fast_nnunet_tpu_torch.utils.io import maybe_mkdir_p, save_json

    pre = os.path.join(root, "preprocessed", TRAIN_DS)
    folder = os.path.join(pre, "nnUNetPlans_3d_fullres")
    labels = os.path.join(root, "raw", TRAIN_DS, "labelsTr")
    for d in (folder, labels, os.path.join(root, "results")):
        maybe_mkdir_p(d)
    rng = np.random.RandomState(seed)
    shape = TRAIN_CASE
    for i in range(n_cases):
        data = rng.randn(1, *shape).astype(np.float32)
        seg = np.zeros((1, *shape), np.int8)
        for c in range(1, TRAIN_K):
            sz = rng.randint(6, 16, size=3)
            lo = [rng.randint(0, shape[d] - sz[d]) for d in range(3)]
            sl = (0,) + tuple(slice(lo[d], lo[d] + sz[d]) for d in range(3))
            seg[sl] = c
            data[sl] += 0.05 * c
        props = {
            "class_locations": DefaultPreprocessor._sample_foreground_locations(
                seg, list(range(1, TRAIN_K))),
            "spacing": TRAIN_SPACING, "shape_before_cropping": shape,
            "bbox_used_for_cropping": [[0, s] for s in shape],
            "shape_after_cropping_and_before_resampling": shape}
        NpyCaseDataset.save_case(data, seg, props,
                                 os.path.join(folder, f"case_{i:03d}"))
        NiftiIO().write_seg(seg[0], os.path.join(labels, f"case_{i:03d}.nii.gz"),
                            {"spacing": TRAIN_SPACING})
    rs = "resample_data_or_seg_to_shape"
    plans = {
        "dataset_name": TRAIN_DS, "plans_name": "nnUNetPlans",
        "image_reader_writer": "NiftiIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel": {},
        "configurations": {"3d_fullres": {
            "data_identifier": "nnUNetPlans_3d_fullres", "batch_size": 2,
            "patch_size": TRAIN_PATCH, "spacing": TRAIN_SPACING,
            "normalization_schemes": ["CTNormalization"],
            "use_mask_for_norm": [False],
            "resampling_fn_data": rs,
            "resampling_fn_data_kwargs": {"is_seg": False, "order": 3},
            "resampling_fn_seg": rs,
            "resampling_fn_seg_kwargs": {"is_seg": True, "order": 1},
            "resampling_fn_probabilities": rs,
            "resampling_fn_probabilities_kwargs": {"is_seg": False,
                                                   "order": 1},
            "architecture": TRAIN_ARCH, "batch_dice": False}}}
    dataset_json = {
        "name": TRAIN_DS, "numTraining": n_cases, "file_ending": ".nii.gz",
        "channel_names": {"0": "CT"},
        "labels": {"background": 0,
                   **{f"struct_{c}": c for c in range(1, TRAIN_K)}}}
    save_json(plans, os.path.join(pre, "nnUNetPlans.json"))
    save_json(dataset_json, os.path.join(pre, "dataset.json"))
    return plans


def conv_flops(torch, net, x):
    """(forward FLOPs, FLOPs of the convolutions inside checkpointed stacks)
    of one forward of ``net`` on ``x``: 2 k^3 Cin Cout per output voxel of a
    convolution, per input voxel of a transposed convolution."""
    from torch import nn
    from fast_nnunet_tpu_torch.models.blocks import StackedConvBlocks
    remat_convs = {id(m) for st in net.modules()
                   if isinstance(st, StackedConvBlocks) and st.remat
                   for m in st.modules() if isinstance(m, nn.Conv3d)}
    tot = {"all": 0, "remat": 0}

    def hook(mod, inp, out):
        if isinstance(mod, nn.ConvTranspose3d):
            f = 2 * mod.weight.numel() * inp[0].numel() // inp[0].shape[1]
        else:
            f = 2 * mod.weight.numel() * out.numel() // out.shape[1]
        tot["all"] += f
        if id(mod) in remat_convs:
            tot["remat"] += f

    hs = [m.register_forward_hook(hook) for m in net.modules()
          if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d))]
    try:
        with torch.no_grad():
            net(x, deep_supervision=True)
    finally:
        for h in hs:
            h.remove()
    return tot["all"], tot["remat"]


def gated_norms(torch, net, x):
    """(norms at >= the kernel A gate in one forward, of those inside
    checkpointed stacks): the kernel A launches one training step should
    make are their sum."""
    from fast_nnunet_tpu_torch.models.blocks import (InstanceNorm,
                                                     StackedConvBlocks)
    from fast_nnunet_tpu_torch.models.s2d import STATS_MIN_VOXELS
    remat_norms = {id(m) for st in net.modules()
                   if isinstance(st, StackedConvBlocks) and st.remat
                   for m in st.modules() if isinstance(m, InstanceNorm)}
    n = {"all": 0, "remat": 0}

    def hook(mod, inp, out):
        if inp[0][0, 0].numel() >= STATS_MIN_VOXELS:
            n["all"] += 1
            n["remat"] += id(mod) in remat_norms

    hs = [m.register_forward_hook(hook) for m in net.modules()
          if isinstance(m, InstanceNorm)]
    try:
        with torch.no_grad():
            net(x, deep_supervision=True)
    finally:
        for h in hs:
            h.remove()
    return n["all"], n["remat"]


def stamp_iterations(cls, attr, cap, warm, timer=None):
    """Wrap ``cls.run_train_iterations`` so that every call of the
    trainer's step ``attr`` is stamped on the host clock and its kernel A
    launches are counted; from iteration ``warm`` on the trainer and the
    step bracket their phases with ``timer``. The wrapped loop ends in a
    device sync (the epoch's loss mean), stamped last. Returns the
    original method."""
    from fast_nnunet_tpu_torch.ops import stats as ka
    orig = cls.run_train_iterations

    def timed(self, epoch):
        step = getattr(self, attr)
        stamps, launches = [], []

        def stamped(*args):
            if timer is not None and len(stamps) == warm:
                self.timer = step.timer = timer
            stamps.append(time.perf_counter())
            n0 = ka.spatial_sum_sumsq.launches
            out = step(*args)
            launches.append(ka.spatial_sum_sumsq.launches - n0)
            return out

        setattr(self, attr, stamped)
        try:
            orig(self, epoch)
        finally:
            setattr(self, attr, step)
            self.timer = step.timer = None
        stamps.append(time.perf_counter())
        cap.update(trainer=self, stamps=stamps, step_launches=launches)

    cls.run_train_iterations = timed
    return orig


def training_paths(torch, dev, a_row):
    """The trainer and the distillation trainer at full width (docstring
    steps 7-9); adds the training-shape fields to kernel A's row."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="fnn_chip_smoke_train_")
    env = {"nnUNet_raw": os.path.join(root, "raw"),
           "nnUNet_preprocessed": os.path.join(root, "preprocessed"),
           "nnUNet_results": os.path.join(root, "results")}
    old = {k: os.environ.get(k) for k in list(env) + [
        "FNNT_ITERS_PER_EPOCH", "FNNT_VAL_ITERS_PER_EPOCH",
        "FNNT_NUM_EPOCHS"]}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        plans = write_train_dataset(root)
        print(f"train: 4 synthetic cases (1, {', '.join(map(str, TRAIN_CASE))})"
              f" and plans written in {time.perf_counter() - t0:.3f} s")
        train_main_path(torch, dev, a_row)
        torch.cuda.empty_cache()
        distill_main_path(torch, dev, root, plans)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def train_main_path(torch, dev, a_row, iters=12, warm=3):
    import numpy as np
    from fast_nnunet_tpu_torch.inference.engine import PhaseTimer
    from fast_nnunet_tpu_torch.models.blocks import StackedConvBlocks
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.run.run_training import run_training
    from fast_nnunet_tpu_torch.training.optimizers import nnunet_sgd
    from fast_nnunet_tpu_torch.training.schedules import poly_lr
    from fast_nnunet_tpu_torch.training.train_step import make_train_step
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer

    os.environ.update(FNNT_ITERS_PER_EPOCH=str(iters),
                      FNNT_VAL_ITERS_PER_EPOCH="2", FNNT_NUM_EPOCHS="1")
    cap = {}
    timer = PhaseTimer()
    orig = stamp_iterations(NNUNetTrainer, "train_step", cap, warm, timer)
    orig_init = NNUNetTrainer.initialize

    def init_and_hook(self):
        orig_init(self)
        conv = self.network.encoder.stages["stage_0"].blocks["block_0"].conv

        def grab(module, inputs, output):  # returns None: output unchanged
            cap.setdefault("a", output.detach())

        cap["hook"] = conv.register_forward_hook(grab)

    NNUNetTrainer.initialize = init_and_hook
    ka.spatial_sum_sumsq.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = run_training(TRAIN_DS, "3d_fullres", 0, device=dev)
    finally:
        NNUNetTrainer.run_train_iterations = orig
        NNUNetTrainer.initialize = orig_init
    wall = time.perf_counter() - t0
    run_launches = ka.spatial_sum_sumsq.launches
    cap["hook"].remove()
    net = trainer.network
    st = cap["stamps"]
    fed = (st[-1] - st[warm]) / (iters - warm)
    phases = {k: v / (iters - warm) for k, v in timer.totals().items()}
    with open(os.path.join(trainer.output_folder, "validation",
                           "summary.json")) as f:
        summary = json.load(f)
    remat = trainer._use_remat()
    x1 = torch.zeros((1, 1, *TRAIN_PATCH), device=dev)
    n_gate, n_gate_remat = gated_norms(torch, net, x1)
    predicted = n_gate + n_gate_remat
    print(f"train: teacher PlainConvUNet features "
          f"{TEACHER_ARCH['features_per_stage']}, {TRAIN_K} classes, patch "
          f"{TRAIN_PATCH}, batch 2, bf16 compute / f32 parameters, remat "
          f"{remat!r}; run_training ({iters} iterations, 2 validation "
          f"iterations, final validation of 1 case) {wall:.3f} s")
    print(f"train: kernel A launches per train step {cap['step_launches']} "
          f"(predicted {predicted}: {n_gate} norms at >= 4096 voxels per "
          f"forward, {n_gate_remat} recomputed by remat); {run_launches} in "
          f"the whole run")
    check(all(n == predicted for n in cap["step_launches"]),
          f"kernel A launches per step {cap['step_launches']} != {predicted}")
    tl = trainer.logger.logging
    check(np.isfinite(tl["train_losses"][0]) and
          np.isfinite(tl["val_losses"][0]),
          f"non-finite losses {tl['train_losses']} {tl['val_losses']}")
    dice = summary["foreground_mean"]["Dice"]
    print(f"train: epoch train loss {tl['train_losses'][0]:.4f}, val loss "
          f"{tl['val_losses'][0]:.4f}, pseudo-Dice {tl['mean_fg_dice'][0]:.4f}"
          f"; final validation summary.json foreground Dice {dice}")

    # ---- cached: one pinned device batch through the step function
    batch = trainer.dataloader_train.sampler.generate_batch(
        np.random.RandomState(0))
    data, targets = trainer.batch_to_device(batch)
    opt = nnunet_sgd(net.parameters(), poly_lr(trainer.initial_lr, 1000))
    step = make_train_step(net, opt, **trainer._step_kwargs())
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(10):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(data, targets))
    torch.cuda.synchronize()
    cached = (time.perf_counter() - t0) / (10 - warm)
    peak_remat = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"non-finite cached losses {losses}")
    check(losses[-1] < losses[0], f"cached-batch loss did not fall: {losses}")

    # remat off on the same network, optimizer and batch, so that both peaks
    # hold the same resident tensors
    stacks = [m for m in net.modules()
              if isinstance(m, StackedConvBlocks) and m.remat]
    for m in stacks:
        m.remat = False
    try:
        step(data, targets)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            step(data, targets)
        torch.cuda.synchronize()
        cached_off = (time.perf_counter() - t0) / 3
        peak_off = torch.cuda.max_memory_allocated()
    finally:
        for m in stacks:
            m.remat = True
    f_fwd, f_remat = conv_flops(torch, net, data[:1])
    flops = 2 * (3 * f_fwd + f_remat)   # batch 2; the hook ran batch 1
    mfu = flops / cached / BF16_TENSOR_OPS_PER_S
    mfu_fed = flops / fed / BF16_TENSOR_OPS_PER_S
    print(f"train: warm seconds per iteration fed {fed:.4f} (iterations "
          f"{warm}-{iters - 1}, dataloader), cached {cached:.4f} (one device "
          f"batch, {10 - warm} steps), cached with remat off "
          f"{cached_off:.4f}")
    print("train: phase ms per fed iteration (CUDA events) " + json.dumps(
        {k: round(v, 3) for k, v in phases.items()}))
    print(f"train: peak device memory {peak_remat / 2**30:.2f} GiB with remat "
          f"{remat!r}, {peak_off / 2**30:.2f} GiB with remat off")
    print(f"train: FLOPs per step {flops:.4e} (3 x {2 * f_fwd:.4e} forward + "
          f"{2 * f_remat:.4e} recomputed); mfu {mfu:.4f} cached, {mfu_fed:.4f}"
          f" fed (of 989 TFLOP/s dense bf16)")
    print(f"train: cached-batch losses {[round(v, 4) for v in losses]}")
    train_json = {"fed_s_per_iter": fed, "cached_s_per_iter": cached,
                  "cached_s_per_iter_remat_off": cached_off,
                  "phases_ms": phases, "peak_gib_remat": peak_remat / 2**30,
                  "peak_gib_remat_off": peak_off / 2**30,
                  "flops_per_step": flops, "mfu": mfu, "mfu_fed": mfu_fed,
                  "launches_per_step": cap["step_launches"],
                  "predicted_launches": predicted}
    del opt, step
    torch.cuda.empty_cache()
    kernel_a_train_check(torch, cap["a"], cap["step_launches"][0], a_row)
    print(json.dumps({"train": train_json}))
    trainer.network = None
    cap.clear()


def kernel_a_train_check(torch, x, launches_per_step, a_row):
    """Kernel A at the widest training call: forward against the plain
    version (A's f32 bound), the backward through SpatialSumSumsq against
    the plain version's autograd on the same values in float32 (1e-5
    relative to the largest gradient), timed beside its bound and the
    library reductions."""
    from fast_nnunet_tpu_torch.ops import stats as ka
    s_k, q_k = ka.spatial_sum_sumsq(x)
    s_p, q_p = ka.spatial_sum_sumsq_plain(x)
    absum = x.float().abs().reshape(x.shape[0], x.shape[1], -1).sum(-1)
    ok = bool(((s_k - s_p).abs() <= 1e-5 * absum + 1e-6).all()
              and ((q_k - q_p).abs() <= 1e-5 * q_p + 1e-6).all())
    err = float(max((s_k - s_p).abs().max(), (q_k - q_p).abs().max()))
    check(ok, f"kernel A at the training shape outside tolerance ({err})")

    g = torch.Generator(device=x.device).manual_seed(0)
    gs = torch.randn(x.shape[:2], generator=g, device=x.device)
    gq = torch.randn(x.shape[:2], generator=g, device=x.device)
    xk = x.float().requires_grad_()
    s, q = ka.SpatialSumSumsq.apply(xk)
    (dk,) = torch.autograd.grad((s * gs + q * gq).sum(), xk)
    del s, q, xk
    xp = x.float().requires_grad_()
    sp, qp = ka.spatial_sum_sumsq_plain(xp)
    (dp,) = torch.autograd.grad((sp * gs + qp * gq).sum(), xp)
    del sp, qp, xp
    grad_err = float((dk - dp).abs().max() / dp.abs().max())
    check(grad_err <= 1e-5, f"SpatialSumSumsq backward differs from the "
          f"plain version's autograd: {grad_err} relative")
    del dk, dp
    torch.cuda.empty_cache()

    ms = time_ms(torch, lambda: ka.spatial_sum_sumsq(x))
    plain_ms = time_ms(torch, lambda: ka.spatial_sum_sumsq_plain(x), n=3,
                       warmup=1)
    dims = tuple(range(2, x.dim()))
    lib_ms = time_ms(torch, lambda: (x.float().sum(dims),
                                     x.float().square().sum(dims)))
    nbytes = x.numel() * x.element_size() + 2 * x.shape[0] * x.shape[1] * 4
    bms, bby = bound(nbytes, 3 * x.numel())
    a_row["train"] = {
        "launches_per_step": launches_per_step, "max_abs_err": err,
        "grad_max_rel_err": grad_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": bby, "bound_share": bms / ms,
        "library_ms": lib_ms, "bytes": nbytes, "rows": x.shape[0] * x.shape[1],
        "shape": f"x {tuple(x.shape)} {str(x.dtype).split('.')[-1]}"}
    print(f"kernel spatial_sum_sumsq (training shape): err {err}, backward "
          f"rel err {grad_err:.3e}, {ms:.4f} ms vs bound {bms:.4f} ms "
          f"({bby}, {nbytes} bytes, share {bms / ms:.3f}), plain "
          f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, {launches_per_step} "
          f"launches per train step; {a_row['train']['shape']}, "
          f"{a_row['train']['rows']} rows")


def distill_main_path(torch, dev, root, plans, iters=8, warm=2):
    import numpy as np
    from fast_nnunet_tpu_torch.models.factory import \
        build_network_from_arch_dict
    from fast_nnunet_tpu_torch.models.unet import (init_he_normal_,
                                                   params_to_jax)
    from fast_nnunet_tpu_torch.run.distillation_train import \
        run_distillation_training
    from fast_nnunet_tpu_torch.training.checkpoint import save_checkpoint
    from fast_nnunet_tpu_torch.training.distill import \
        NNUNetDistillationTrainer
    from fast_nnunet_tpu_torch.utils.io import maybe_mkdir_p, save_json

    t0 = time.perf_counter()
    teacher = os.path.join(root, "teacher")
    maybe_mkdir_p(teacher)
    save_json(plans, os.path.join(teacher, "plans.json"))
    net = build_network_from_arch_dict(TRAIN_ARCH, 1, TRAIN_K,
                                       trainable=True)
    for f in range(5):
        maybe_mkdir_p(os.path.join(teacher, f"fold_{f}"))
        save_checkpoint(os.path.join(teacher, f"fold_{f}",
                                     "checkpoint_final.fnnx"),
                        network_weights=params_to_jax(
                            init_he_normal_(net, 100 + f)),
                        init_args={"fold": f})
    del net
    print(f"distill: 5 teacher folds of seeded random teacher weights "
          f"written in {time.perf_counter() - t0:.3f} s")
    os.environ.update(FNNT_ITERS_PER_EPOCH=str(iters),
                      FNNT_VAL_ITERS_PER_EPOCH="1", FNNT_NUM_EPOCHS="1")
    cap = {}
    orig = stamp_iterations(NNUNetDistillationTrainer, "distill_step", cap,
                            warm)
    t0 = time.perf_counter()
    try:
        trainer = run_distillation_training(TRAIN_DS, "3d_fullres", 0,
                                            teacher_folder=teacher,
                                            device=dev)
    finally:
        NNUNetDistillationTrainer.run_train_iterations = orig
    wall = time.perf_counter() - t0
    st = cap["stamps"]
    per_iter = (st[-1] - st[warm]) / (iters - warm)
    lg = trainer.logger.logging
    seg, dist = lg["train_seg_losses"][0], lg["train_distill_losses"][0]
    feats = [st.blocks["block_0"].conv.out_channels
             for st in trainer.network.encoder.stages.values()]
    print(f"distill: student features {feats}, {len(trainer.teachers)} teacher "
          f"folds {trainer.teacher_fold}, alpha {trainer.alpha}, T "
          f"{trainer.temperature}; run_distillation_training ({iters} "
          f"iterations, 1 validation iteration, final validation) "
          f"{wall:.3f} s")
    print(f"distill: warm seconds per iteration {per_iter:.4f} (iterations "
          f"{warm}-{iters - 1}); kernel A launches per step "
          f"{cap['step_launches']}; epoch seg loss {seg:.4f}, distill loss "
          f"{dist:.4f}, total {lg['train_losses'][0]:.4f}")
    check(len(trainer.teachers) == 5, "not 5 teacher folds")
    check(np.isfinite(seg) and np.isfinite(dist) and dist > 0,
          f"distillation losses seg {seg} distill {dist}")
    x1 = torch.zeros((1, 1, *TRAIN_PATCH), device=dev)
    s_gate, s_remat = gated_norms(torch, trainer.network, x1)
    t_gate, _ = gated_norms(torch, trainer.teachers[0], x1)
    predicted = s_gate + s_remat + len(trainer.teachers) * t_gate
    print(f"distill: predicted kernel A launches per step {predicted} "
          f"(student {s_gate} + {s_remat} recomputed, "
          f"{len(trainer.teachers)} teachers x {t_gate})")
    check(all(n == predicted for n in cap["step_launches"]),
          f"kernel A launches per distillation step {cap['step_launches']}"
          f" != {predicted}")
    print(json.dumps({"distill": {"s_per_iter": per_iter, "seg_loss": seg,
                                  "distill_loss": dist,
                                  "launches_per_step": cap["step_launches"],
                                  "predicted_launches": predicted}}))
    trainer.teachers = []
    trainer.network = None


def small_train_step(torch, dev):
    """Three SGD steps of a narrow training network, fp32 with TF32 off and
    deterministic cuDNN, cuda (kernel A) vs cpu (plain version): losses
    within 1e-4 relative, parameters within 1e-5 absolute."""
    import numpy as np
    from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
    from fast_nnunet_tpu_torch.models.s2d import random_plain_params
    from fast_nnunet_tpu_torch.models.unet import params_from_jax
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.training.optimizers import nnunet_sgd
    from fast_nnunet_tpu_torch.training.schedules import poly_lr
    from fast_nnunet_tpu_torch.training.train_step import make_train_step

    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(5)
    batches = []
    for _ in range(3):
        x = rng.randn(2, 1, 32, 32, 32).astype(np.float32)
        lab = rng.randint(0, 4, (2, 32, 32, 32))
        batches.append((torch.from_numpy(x), (
            torch.from_numpy(lab), torch.from_numpy(lab[:, ::2, ::2, ::2]
                                                    .copy()))))
    tree = random_plain_params(SMALL_ARCH, 1, 4, seed=6)
    res = []
    try:
        for d in (dev, torch.device("cpu")):
            net = params_from_jax(get_network_from_plans(
                "PlainConvUNet", SMALL_ARCH, (), 1, 4,
                compute_dtype=torch.float32, norm_onepass=True,
                trainable=True), tree).to(d)
            opt = nnunet_sgd(net.parameters(), poly_lr(1e-2, 10))
            step = make_train_step(net, opt, n_ds_levels=2)
            n0 = ka.spatial_sum_sumsq.launches
            losses = [float(step(x.to(d), tuple(t.to(d) for t in tg)))
                      for x, tg in batches]
            res.append((losses, [p.detach().cpu() for p in
                                 net.parameters()],
                        ka.spatial_sum_sumsq.launches - n0))
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cudnn.deterministic = prev
    (lc, pc, n_k), (lp, pp, _) = res
    lc, lp = np.array(lc), np.array(lp)
    loss_rel = float(np.abs(lc - lp).max() / np.abs(lp).max())
    p_err = max(float((a - b).abs().max()) for a, b in zip(pc, pp))
    print(f"small: fp32 train step x3 cuda ({n_k} kernel A "
          f"launches) vs cpu: losses {lc.round(6).tolist()} vs "
          f"{lp.round(6).tolist()}, max loss rel diff {loss_rel:.3e} "
          f"(bound 1e-4), max parameter diff {p_err:.3e} (bound 1e-5)")
    check(n_k > 0, "kernel A not launched in the small step")
    check(loss_rel <= 1e-4 and p_err <= 1e-5,
          f"small train step cuda vs cpu: loss {loss_rel}, params {p_err}")


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
