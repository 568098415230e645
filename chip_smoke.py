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

    # ------------------------------------------- small model: cuda vs cpu
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


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
