#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fast_nnunet_tpu_torch) on one NVIDIA
GPU — the quickest proof that the port's serving path starts and is right on
the card. Run from the repository root:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   hand-written kernels from fast_nnunet_tpu_torch/csrc (timed).
2. Main path at full width: the bone_turbo r=2 distilled student (6 stages,
   features 16..160, 61 classes; seeded random weights in the JAX package's
   tree layout, loaded through params_from_jax) over a 512x512x500 synthetic
   CT at 0.8x0.8x1.0 mm through ``TurboPipeline.predict_volume`` with the
   engine INI's settings (bf16 compute and accumulator, tile batch 8, air
   skipping on). One warm run, then timed runs; the first timed run is split
   into phases by CUDA events and its kernel launch counts are read (each
   kernel of the path must have launched).
3. Each kernel at the main path's shapes, on tensors taken from that
   workload, against its plain PyTorch version (A within f32 summation
   tolerance, B and C bit for bit, C in both accumulator modes), timed beside
   its bound, its plain version and, where one exists, a library call.
4. A small model through the whole pipeline on the card (kernels) and on the
   CPU (plain versions), fp32 with TF32 off: mask agreement >= 0.999.

Prints the kernels JSON on its own line, then last
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
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
    del cap

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
                 f"{n_live} live tiles, row_base {row_base}",
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
        print(f"kernel {r['name']}: err {r['max_abs_err']} ({r['tolerance']})"
              f", {r['ms']:.4f} ms vs bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']}, {r['launches']} launches per CT; "
              f"{r['shape']}")
    return rows


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
