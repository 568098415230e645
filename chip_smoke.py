#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fast_nnunet_tpu_torch) on one NVIDIA
GPU — the quickest proof that the port's serving path starts and is right on
the card. Run from the repository root:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), builds the
   hand-written kernels from fast_nnunet_tpu_torch/csrc (timed) and prints
   what ptxas reports for kernels A, B and C (registers, static shared
   memory, spills, stack).
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
   plain version and, where one exists, a library call; A, B and C with
   their launch plans, C with whether its features took the 16-byte path.
   Every ``ms`` is CUDA events around calls launched from Python; kernel A
   adds ``device_ms``, the same calls replayed from a CUDA graph (its
   smaller calls take less than their Python launch), both over copies of
   its input that together exceed the L2.
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
   against its plain version, a nearly constant bf16 row (0.7 + 1e-3 noise)
   at that shape, and ``autograd.grad`` through ``SpatialSumSumsq`` against
   the plain version's autograd (float32, 1e-5 relative); the result is A's
   row's ``train`` fields. Every distinct (shape, dtype) A is launched with
   in one train step (captured from iteration 1) is checked against its
   plain version, for bit-equality of two calls, and timed: A's row's
   ``train_shapes``.
9. Distillation (``distill:``): 5 teacher folds of seeded random teacher
   weights written with the port's ``save_checkpoint``, then
   ``run_distillation_training`` (student r = 2, alpha 0.3, T 3.0) for 8
   iterations: seconds per iteration, kernel A launches per step, seg and
   distill losses (finite); A's calls of one distillation step go into
   ``train_shapes`` as in 8.
10. A small training step cuda vs cpu (fp32, TF32 off, deterministic cuDNN,
   3 steps): losses within 1e-4 relative, parameters within 1e-5.
11. nnU-Net's workflow from a raw dataset (``pipeline:``), all through the
   port's entry points in this process: 5 training cases and 1 test case
   of (200, 140, 140) int16 CT at (2.0, 0.9765625, 0.9765625) mm with 61
   labels, written as .nii.gz; ``fast_nnunet_plan_and_preprocess_torch -d
   988 -c 3d_fullres --verify_dataset_integrity`` (host seconds for the
   integrity check, the fingerprint, the plan and preprocessing per case),
   whose 3d_fullres must equal PIPELINE_3D_FULLRES (the planner's
   anisotropic 6-stage teacher: (1, 3, 3) first kernels, (1, 2, 2) and
   (2, 1, 1) strides); ``fast_nnunet_train_torch 988 3d_fullres 0``
   with the trainer's defaults, cut to one epoch of 10 iterations and 2
   validation iterations: fed seconds per iteration, peak memory, kernel A
   launches per step against the gate's count, every (shape, dtype) A
   takes in one step checked and timed into A's ``train_shapes``;
   ``fast_nnunet_find_best_configuration_torch 988 -c 3d_fullres -f 0``
   (summary Dice finite, postprocessing.json, the instructions);
   ``fast_nnunet_predict_torch`` on imagesTs with ``--save_probabilities``,
   with mirror TTA and with ``--disable_tta``; ``fast_nnunet_ensemble_torch``
   of the two (the mask must equal the argmax of the mean of the two .npz,
   recomputed with numpy); ``fast_nnunet_apply_postprocessing_torch`` (must
   equal ``apply_postprocessing`` in memory); ``fast_nnunet_evaluate_simple
   _torch`` against the test label. One ``{"pipeline": ...}`` JSON line.
12. nnU-Net's residual-encoder presets (``resenc:``), in phase 11's dataset
   before it is removed: ``fast_nnunet_plan_and_preprocess_torch -d 988
   -pl nnUNetPlannerResEncL -c 3d_fullres`` (the fingerprint reused), whose
   3d_fullres must equal PIPELINE_RESENC_L (patch 160^3, batch 2, blocks
   1/3/4/6/6/6, single-conv decoder stages); ``fast_nnunet_train_torch 988
   3d_fullres 0 -p nnUNetResEncUNetLPlans`` (one epoch of 10 iterations, 2
   validation iterations, the final validation): fed seconds per
   iteration, FLOPs and mfu, peak memory, kernel A launches per step
   against the gate's count over the residual blocks (recomputed under
   remat, the stem not), every (shape, dtype) A takes in one step checked
   and timed into A's ``train_shapes``; 4 seeded random ResEnc L folds
   beside the trained fold 0 and ``fast_nnunet_resenc_distill_torch -tpl
   nnUNetResEncUNetLPlans -spl nnUNetResEncUNetLPlans`` (the
   LiteResEncStudent, 6 iterations, 5 teachers): seconds per iteration,
   launches per step against the count, A's shapes of one step;
   ``fast_nnunet_predict_torch`` on imagesTs with the teacher and with the
   student; a small ResEnc and a small BatchNorm (``NNUNetTrainerBN``'s
   network) train step cuda vs cpu as in 10; and ``--use_da5``
   distillation at small size on the card. One ``{"resenc": ...}`` line.

Prints the kernels JSON on its own line (every row with ``bound_share`` =
bound_ms / ms), then last ``{"ok": true, "device": {...}}``. Any failure
exits non-zero without it.
"""
import configparser
import contextlib
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
# phase 11: a raw CT dataset at the train phase's case geometry, planned by
# the port's own ExperimentPlanner; its 3d_fullres topology, frozen (a CPU
# test, tests/test_torch_planning.py, holds it against the JAX planner)
PIPELINE_DS_ID = 988
PIPELINE_DS = "Dataset988_PipelineCT"
PIPELINE_N_TRAIN = 5
PIPELINE_3D_FULLRES = {
    "patch_size": [160, 96, 96], "batch_size": 2,
    "spacing": [2.0, 0.9765625, 0.9765625],
    "normalization_schemes": ["CTNormalization"], "n_stages": 6,
    "features_per_stage": [32, 64, 128, 256, 320, 320],
    "kernel_sizes": [[1, 3, 3]] + [[3, 3, 3]] * 5,
    "strides": [[1, 1, 1], [1, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2],
                [2, 1, 1]],
}


# phase 12: nnU-Net's ResEnc L preset on phase 11's dataset, frozen like
# PIPELINE_3D_FULLRES (tests/test_torch_planning.py holds it against the JAX
# planner), and its LiteResEncStudent (r = 2, "reduce")
RESENC_PLANS = "nnUNetResEncUNetLPlans"
RESENC_KEYS = ("n_blocks_per_stage", "n_conv_per_stage_decoder")
PIPELINE_RESENC_L = {
    "patch_size": [160, 160, 160], "batch_size": 2,
    "spacing": [2.0, 0.9765625, 0.9765625],
    "normalization_schemes": ["CTNormalization"], "n_stages": 6,
    "features_per_stage": [32, 64, 128, 256, 320, 320],
    "kernel_sizes": [[1, 3, 3]] + [[3, 3, 3]] * 5,
    "strides": [[1, 1, 1], [1, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2],
                [2, 2, 2]],
    "n_blocks_per_stage": [1, 3, 4, 6, 6, 6],
    "n_conv_per_stage_decoder": [1, 1, 1, 1, 1],
}


def plan_topology(configuration: dict, extra=()) -> dict:
    """The keys of PIPELINE_3D_FULLRES (and the architecture keys
    ``extra``) from a plans configuration."""
    arch = configuration["architecture"]["arch_kwargs"]
    out = {k: configuration[k] for k in ("patch_size", "batch_size",
                                         "spacing", "normalization_schemes")}
    out.update({k: json.loads(json.dumps(arch[k])) for k in (
        "n_stages", "features_per_stage", "kernel_sizes", "strides",
        *extra)})
    return out


SMALL_ARCH = {
    "n_stages": 3, "features_per_stage": [8, 16, 32],
    "kernel_sizes": [[3, 3, 3]] * 3, "strides": [[1, 1, 1]] + [[2, 2, 2]] * 2,
    "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [2, 2],
}
SMALL_RESENC = dict(SMALL_ARCH, kernel_sizes=[[1, 3, 3]] + [[3, 3, 3]] * 2,
                    n_blocks_per_stage=[1, 2, 2],
                    n_conv_per_stage_decoder=[1, 1])


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


def time_graph_ms(torch, fn, n=20):
    """Mean device milliseconds of fn over n calls captured in one CUDA
    graph and replayed once: device time without the host's launch cost
    between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stats_error(torch, got, ref, x):
    """(max abs error, within kernel A's tolerance) of (sum, sumsq) ``got``
    against the plain version's ``ref`` for input x: |d sum| <= 1e-5 *
    sum|x| + 1e-6 and |d sumsq| <= 1e-5 * sumsq + 1e-6 per row."""
    (s_k, q_k), (s_p, q_p) = got, ref
    absum = x.float().abs().reshape(x.shape[0], x.shape[1], -1).sum(-1)
    ok = bool(((s_k - s_p).abs() <= 1e-5 * absum + 1e-6).all()
              and ((q_k - q_p).abs() <= 1e-5 * q_p + 1e-6).all())
    return float(max((s_k - s_p).abs().max(), (q_k - q_p).abs().max())), ok


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

    t_start = time.perf_counter()
    last = [t_start]

    def mark(phase):
        """The command's wall clock after each phase (the run's time
        budget is the driver's limit)."""
        now = time.perf_counter()
        print(f"wall: {phase} done at {now - t_start:.1f} s "
              f"({now - last[0]:.1f} s)")
        last[0] = now

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: kernels built and loaded in "
          f"{time.perf_counter() - t0:.3f} s (nvcc {_build.nvcc_path()})")
    for fn, v in sorted(_build.ptxas_report("_kernel").items()):
        if any(k in fn for k in ("s2d_accumulate", "grouped_argmax",
                                 "spatial_sum_sumsq")):
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
    rows = kernel_checks(torch, cap, engine, launches, kb, kc)
    del cap, engine, pipe, net
    torch.cuda.empty_cache()
    mark("build, s2d main path and its kernels (phases 1-3)")

    # ------------------------------------------- plain full-res path, kernel D
    cap_d, launches_d = plain_main_path(torch, dev, engine_module, K, arch)
    rows.append(kernel_d_check(torch, cap_d, launches_d))
    del cap_d
    torch.cuda.empty_cache()
    mark("plain path and kernel D (phases 4-5)")

    # ------------------------------------------- training and distillation
    training_paths(torch, dev, next(r for r in rows
                                    if r["name"] == "spatial_sum_sumsq"))
    mark("training and distillation (phases 7-9)")

    # ------------------------------------------- small model: cuda vs cpu
    small_train_step(torch, dev)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
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
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    mark("small checks (phases 6, 10)")

    # ------------------------------------------- raw dataset -> evaluation
    pipeline_path(torch, dev, next(r for r in rows
                                   if r["name"] == "spatial_sum_sumsq"))
    mark("raw dataset workflow and ResEnc presets (phases 11-12)")

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


def kernel_checks(torch, cap, engine, launches, kb, kc):
    """Each kernel against its plain version on inputs captured from the
    main path's warm-up run."""
    import numpy as np

    K = engine.num_classes
    pyh, pzh = engine.patch_size[1] // 2, engine.patch_size[2] // 2
    acc, feat, g16, w, b, coords, vk, row_base = cap["c"]
    plane_h = tuple(acc.shape[1:3])
    rows = []

    # ------------------------------------- kernel A (first, as in the forward)
    a = kernel_a_at(torch, cap["a"], launches["spatial_sum_sumsq"])
    rows.append({
        "name": "spatial_sum_sumsq", "route": "cuda",
        "source": "fast_nnunet_tpu_torch/csrc/stats.cu",
        "replaces": "fast_nnunet_tpu/ops/pallas_stats.py:58",
        "launches": launches["spatial_sum_sumsq"],
        "tolerance": "|d| <= 1e-5 * sum|x| + 1e-6 (sum), 1e-5 * sumsq + 1e-6 "
                     "(sumsq)", **a})

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

    for r in rows:
        r["bound_share"] = r["bound_ms"] / r["ms"]
        dev_ms = f" (device {r['device_ms']:.4f})" if "device_ms" in r else ""
        print(f"kernel {r['name']}: err {r['max_abs_err']} ({r['tolerance']})"
              f", {r['ms']:.4f} ms{dev_ms} vs bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, share {r['bound_share']:.3f}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, "
              f"{r['launches']} launches per CT; {r['shape']}")
    return rows


def l2_cold_copies(torch, x, l2_passes=2):
    """x and enough clones of it that between two reads of one of them the
    others move at least ``l2_passes`` times the card's L2: calls that
    cycle through them read their input from HBM, as the byte bound
    assumes, even when one input fits in L2 (50 MB on the H100)."""
    l2 = getattr(torch.cuda.get_device_properties(x.device), "L2_cache_size",
                 0) or 50 << 20
    nbytes = x.numel() * x.element_size()
    n = 1 + max(1, -(-l2_passes * l2 // nbytes))
    return [x] + [x.clone() for _ in range(n - 1)]


def kernel_a_at(torch, x, launches):
    """Kernel A on x, timed beside its byte bound first (before the checks'
    temporaries), then against its plain version (A's f32 tolerance) and
    against itself (two calls bit for bit), with its launch plan, the plain
    version's and the library reductions' times. ``ms``: 20 calls launched
    from Python (the yardstick of every kernel row);
    ``device_ms``: the same 20 calls replayed from a CUDA graph, so without
    the host's launch cost. Both cycle through :func:`l2_cold_copies`.
    ``launches``: the count this shape had on its path, for the message."""
    import itertools
    from fast_nnunet_tpu_torch.ops import stats as ka
    xs = l2_cold_copies(torch, x)
    cyc = itertools.cycle(xs)

    def run():
        return ka.spatial_sum_sumsq(next(cyc))

    ms = time_ms(torch, run, n=20)
    device_ms = time_graph_ms(torch, run)
    del xs, cyc
    torch.cuda.empty_cache()
    got = ka.spatial_sum_sumsq(x)
    again = ka.spatial_sum_sumsq(x)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    err, ok = stats_error(torch, got, ka.spatial_sum_sumsq_plain(x), x)
    what = f"kernel A at {tuple(x.shape)} {x.dtype} ({launches} launches)"
    check(ok, f"{what} outside tolerance (max abs err {err})")
    check(same, f"{what}: two calls differ")
    plain = time_ms(torch, lambda: ka.spatial_sum_sumsq_plain(x), n=3,
                    warmup=1)
    dims = tuple(range(2, x.dim()))
    lib = time_ms(torch, lambda: (x.float().sum(dims),
                                  x.float().square().sum(dims)))
    rows = x.shape[0] * x.shape[1]
    nbytes = x.numel() * x.element_size() + 2 * rows * 4
    bms, bby = bound(nbytes, 3 * x.numel())
    plan = ka.launch_plan(rows, x.numel() // rows, x.element_size(),
                          torch.cuda.get_device_properties(x.device)
                          .multi_processor_count, x.data_ptr() % 16 == 0)
    return {"max_abs_err": err, "bit_equal_repeat": same, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": bby, "bound_share": bms / ms,
            "device_bound_share": bms / device_ms, "library_ms": lib,
            "bytes": nbytes, "ops": 3 * x.numel(), "rows": rows,
            "shape": f"x {tuple(x.shape)} {str(x.dtype).split('.')[-1]}",
            "plan": {k: plan[k] for k in ("k", "chunk", "vec", "blocks")}}


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
def write_train_dataset(root, n_cases=4, seed=0, ds=TRAIN_DS,
                        shape=TRAIN_CASE, k=TRAIN_K, arch=TRAIN_ARCH,
                        patch=TRAIN_PATCH, plans_name="nnUNetPlans"):
    """bench_train's synthetic preprocessed cases (one cuboid per class,
    data correlated with the label), with the properties the final
    validation's export needs, and their labels as nnUNet_raw NIfTIs; the
    keyword arguments make a smaller dataset under other plans."""
    import numpy as np
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    from fast_nnunet_tpu_torch.training.dataset import NpyCaseDataset
    from fast_nnunet_tpu_torch.utils.io import maybe_mkdir_p, save_json

    pre = os.path.join(root, "preprocessed", ds)
    folder = os.path.join(pre, plans_name + "_3d_fullres")
    labels = os.path.join(root, "raw", ds, "labelsTr")
    for d in (folder, labels, os.path.join(root, "results")):
        maybe_mkdir_p(d)
    rng = np.random.RandomState(seed)
    for i in range(n_cases):
        data = rng.randn(1, *shape).astype(np.float32)
        seg = np.zeros((1, *shape), np.int8)
        for c in range(1, k):
            sz = rng.randint(6, 16, size=3)
            lo = [rng.randint(0, shape[d] - sz[d]) for d in range(3)]
            sl = (0,) + tuple(slice(lo[d], lo[d] + sz[d]) for d in range(3))
            seg[sl] = c
            data[sl] += 0.05 * c
        props = {
            "class_locations": DefaultPreprocessor._sample_foreground_locations(
                seg, list(range(1, k))),
            "spacing": TRAIN_SPACING, "shape_before_cropping": shape,
            "bbox_used_for_cropping": [[0, s] for s in shape],
            "shape_after_cropping_and_before_resampling": shape}
        NpyCaseDataset.save_case(data, seg, props,
                                 os.path.join(folder, f"case_{i:03d}"))
        NiftiIO().write_seg(seg[0], os.path.join(labels, f"case_{i:03d}.nii.gz"),
                            {"spacing": TRAIN_SPACING})
    rs = "resample_data_or_seg_to_shape"
    plans = {
        "dataset_name": ds, "plans_name": plans_name,
        "image_reader_writer": "NiftiIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel": {},
        "configurations": {"3d_fullres": {
            "data_identifier": plans_name + "_3d_fullres", "batch_size": 2,
            "patch_size": list(patch), "spacing": TRAIN_SPACING,
            "normalization_schemes": ["CTNormalization"],
            "use_mask_for_norm": [False],
            "resampling_fn_data": rs,
            "resampling_fn_data_kwargs": {"is_seg": False, "order": 3},
            "resampling_fn_seg": rs,
            "resampling_fn_seg_kwargs": {"is_seg": True, "order": 1},
            "resampling_fn_probabilities": rs,
            "resampling_fn_probabilities_kwargs": {"is_seg": False,
                                                   "order": 1},
            "architecture": arch, "batch_dice": False}}}
    dataset_json = {
        "name": ds, "numTraining": n_cases, "file_ending": ".nii.gz",
        "channel_names": {"0": "CT"},
        "labels": {"background": 0,
                   **{f"struct_{c}": c for c in range(1, k)}}}
    save_json(plans, os.path.join(pre, plans_name + ".json"))
    save_json(dataset_json, os.path.join(pre, "dataset.json"))
    return plans


def write_raw_ct_dataset(raw_root, dataset=PIPELINE_DS, shape=TRAIN_CASE,
                         spacing=TRAIN_SPACING, n_train=PIPELINE_N_TRAIN,
                         n_classes=TRAIN_K, seed=0):
    """A raw nnU-Net dataset of int16 CTs written as .nii.gz through the
    port's NIfTI writer: ``n_train`` cases in imagesTr/labelsTr and one
    more in imagesTs/labelsTs, dataset.json with a CT channel. Air is
    -1024 HU (no voxel is 0, so crop_to_nonzero keeps the whole volume), a
    soft-tissue ellipsoid 20-60 HU, and one bone cuboid per foreground class
    (300 + 10 c HU), each in its own cell of a grid, so every class is in
    every case."""
    import math
    import numpy as np
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO, write_nifti
    from fast_nnunet_tpu_torch.utils.dataset_io import generate_dataset_json
    from fast_nnunet_tpu_torch.utils.io import maybe_mkdir_p

    folder = os.path.join(raw_root, dataset)
    rng = np.random.RandomState(seed)
    g = math.ceil((n_classes - 1) ** (1 / 3) - 1e-9)
    cell = [s // g for s in shape]
    xs, ys, zs = np.ogrid[tuple(slice(0, s) for s in shape)]
    body = sum(((c - s / 2) / (0.45 * s)) ** 2
               for c, s in zip((xs, ys, zs), shape)) <= 1
    for i in range(n_train + 1):
        split = "Tr" if i < n_train else "Ts"
        img = np.where(body, 40, -1024).astype(np.int16)
        img += rng.randint(-20, 21, shape).astype(np.int16)
        seg = np.zeros(shape, np.uint8)
        for c in range(1, n_classes):
            origin = np.unravel_index(c - 1, (g, g, g))
            sl = []
            for d in range(3):
                size = rng.randint(max(2, cell[d] // 4),
                                   max(3, cell[d] // 2 + 1))
                lo = origin[d] * cell[d] + rng.randint(0, cell[d] - size + 1)
                sl.append(slice(lo, lo + size))
            seg[tuple(sl)] = c
            img[tuple(sl)] += 260 + 10 * c
        for sub in ("images", "labels"):
            maybe_mkdir_p(os.path.join(folder, sub + split))
        case = f"case_{i:03d}"
        write_nifti(os.path.join(folder, "images" + split,
                                 f"{case}_0000.nii.gz"),
                    img.transpose(2, 1, 0), spacing=list(spacing)[::-1])
        NiftiIO().write_seg(seg, os.path.join(folder, "labels" + split,
                                              case + ".nii.gz"),
                            {"spacing": list(spacing)})
    generate_dataset_json(
        folder, {0: "CT"},
        {"background": 0, **{f"bone_{c}": c for c in range(1, n_classes)}},
        n_train, ".nii.gz", dataset_name=dataset)
    return folder


def conv_flops(torch, net, x):
    """(forward FLOPs, FLOPs of the convolutions inside checkpointed stacks)
    of one forward of ``net`` on ``x``: 2 k^3 Cin Cout per output voxel of a
    convolution, per input voxel of a transposed convolution."""
    from torch import nn
    from fast_nnunet_tpu_torch.models.unet import remat_modules
    remat_convs = {id(m) for st in remat_modules(net)
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


def stage_features(net):
    """Output channels of each encoder stage, plain or residual."""
    enc = net.encoder
    if hasattr(enc, "stages"):
        return [st.blocks["block_0"].conv.out_channels
                for st in enc.stages.values()]
    return [enc.blocks[f"stage_{s}_block_0"].conv1.out_channels
            for s in range(len(enc.stage_ends))]


def gated_norms(torch, net, x):
    """(norms at >= the kernel A gate in one forward, of those inside
    modules a training step recomputes: checkpointed stacks, residual
    blocks): the kernel A launches one training step should make are their
    sum."""
    from fast_nnunet_tpu_torch.models.blocks import InstanceNorm
    from fast_nnunet_tpu_torch.models.s2d import STATS_MIN_VOXELS
    from fast_nnunet_tpu_torch.models.unet import remat_modules
    remat_norms = {id(m) for st in remat_modules(net)
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


@contextlib.contextmanager
def kernel_a_calls():
    """Record kernel A's calls under autograd (``SpatialSumSumsq.apply``,
    the training norms' route to the kernel): yields {(shape, dtype):
    [calls, first input]}."""
    from fast_nnunet_tpu_torch.ops import stats as ka
    fn = ka.SpatialSumSumsq
    calls = {}
    real = fn.apply

    def apply(x):
        key = (tuple(x.shape), str(x.dtype).split(".")[-1])
        calls.setdefault(key, [0, x.detach()])[0] += 1
        return real(x)

    fn.apply = apply
    try:
        yield calls
    finally:
        del fn.apply  # the inherited classmethod again


def stamp_iterations(cls, attr, cap, warm, timer=None):
    """Wrap ``cls.run_train_iterations`` so that every call of the
    trainer's step ``attr`` is stamped on the host clock and its kernel A
    launches are counted; kernel A's calls of iteration 1 are recorded in
    ``cap["a_calls"]`` (:func:`kernel_a_calls`); from iteration ``warm`` on
    the trainer and the step bracket their phases with ``timer``. The
    wrapped loop ends in a device sync (the epoch's loss mean), stamped
    last; ``cap["peak_bytes"]`` is the peak device memory then. Returns the
    original method."""
    import torch
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
            if len(stamps) == 2:
                with kernel_a_calls() as calls:
                    out = step(*args)
                cap["a_calls"] = calls
            else:
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
        cap.update(trainer=self, stamps=stamps, step_launches=launches,
                   peak_bytes=torch.cuda.max_memory_allocated())

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
        distill_main_path(torch, dev, root, plans, a_row)
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
    ka.spatial_sum_sumsq.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = run_training(TRAIN_DS, "3d_fullres", 0, device=dev)
    finally:
        NNUNetTrainer.run_train_iterations = orig
    wall = time.perf_counter() - t0
    run_launches = ka.spatial_sum_sumsq.launches
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
    # kernel A at this run's shapes, before the peaks below are read
    widest = max(cap["a_calls"].values(), key=lambda v: v[1].numel())[1]
    kernel_a_train_check(torch, widest, cap["step_launches"][0], a_row)
    del widest
    kernel_a_step_shapes(torch, "train", cap["a_calls"],
                         cap["step_launches"][1], a_row)

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
    print(json.dumps({"train": train_json}))
    trainer.network = None
    cap.clear()


def kernel_a_train_check(torch, x, launches_per_step, a_row):
    """Kernel A at the widest training call: forward against the plain
    version (A's f32 bound), a nearly constant bf16 input of the same shape
    (0.7 + 1e-3 noise: the drift the per-thread compensation holds off),
    and the backward through SpatialSumSumsq against the plain version's
    autograd on the same values in float32 (1e-5 relative to the largest
    gradient)."""
    from fast_nnunet_tpu_torch.ops import stats as ka
    a = kernel_a_at(torch, x, launches_per_step)
    g = torch.Generator(device=x.device).manual_seed(0)
    flat = (0.7 + 1e-3 * torch.randn(x.shape, generator=g, device=x.device)
            ).bfloat16()
    flat_err, ok = stats_error(torch, ka.spatial_sum_sumsq(flat),
                               ka.spatial_sum_sumsq_plain(flat), flat)
    check(ok, f"kernel A on a nearly constant row outside tolerance "
          f"({flat_err})")
    del flat

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
    a_row["train"] = dict(a, launches_per_step=launches_per_step,
                          grad_max_rel_err=grad_err,
                          near_constant_max_abs_err=flat_err)
    print(f"kernel spatial_sum_sumsq (widest training call): err "
          f"{a['max_abs_err']}, near-constant row err {flat_err}, backward "
          f"rel err {grad_err:.3e}, {a['ms']:.4f} ms (device "
          f"{a['device_ms']:.4f}) vs bound "
          f"{a['bound_ms']:.4f} ms ({a['bound_by']}, {a['bytes']} bytes, "
          f"share {a['bound_share']:.3f}), plain {a['plain_ms']:.4f} ms, "
          f"library {a['library_ms']:.4f} ms, {launches_per_step} launches "
          f"per train step; {a['shape']}, {a['rows']} rows, plan "
          f"{a['plan']}")


def kernel_a_step_shapes(torch, path, calls, step_launches, a_row):
    """Every distinct (shape, dtype) kernel A was launched with in one step
    of ``path`` (``calls`` from :func:`kernel_a_calls`), checked and timed
    by :func:`kernel_a_at` unless an earlier path of this run did so
    (``checked_on`` names it); appended to A's row's ``train_shapes``."""
    n = sum(v[0] for v in calls.values())
    check(n == step_launches, f"{path}: {n} kernel A calls recorded in one "
          f"step, {step_launches} launches counted")
    out = a_row.setdefault("train_shapes", [])
    for (shape, dtype), (count, x) in sorted(calls.items(),
                                             key=lambda kv: -kv[1][1].numel()):
        seen = next((r for r in out if r["shape"] == f"x {shape} {dtype}"),
                    None)
        if seen is not None:   # checked and timed earlier in this run
            out.append(dict(seen, path=path, launches_per_step=count,
                            checked_on=seen.get("checked_on", seen["path"])))
            print(f"kernel spatial_sum_sumsq ({path}, {count} per step): "
                  f"x {shape} {dtype}, checked and timed on the "
                  f"{out[-1]['checked_on']} path above")
            continue
        a = kernel_a_at(torch, x, count)
        out.append(dict(a, path=path, launches_per_step=count))
        print(f"kernel spatial_sum_sumsq ({path}, {count} per step): "
              f"{a['shape']}, k {a['plan']['k']}, {a['ms']:.4f} ms (device "
              f"{a['device_ms']:.4f}) vs bound {a['bound_ms']:.4f} ms, share "
              f"{a['bound_share']:.3f} (device {a['device_bound_share']:.3f})"
              f", err {a['max_abs_err']:.3e}, repeat "
              f"bit-equal {a['bit_equal_repeat']}, plain "
              f"{a['plain_ms']:.4f} ms, library {a['library_ms']:.4f} ms")
    calls.clear()
    torch.cuda.empty_cache()


def distill_main_path(torch, dev, root, plans, a_row, iters=8, warm=2):
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
    feats = stage_features(trainer.network)
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
    kernel_a_step_shapes(torch, "distill", cap["a_calls"],
                         cap["step_launches"][1], a_row)


# ------------------------------------------------------------------ pipeline
@contextlib.contextmanager
def host_seconds(targets):
    """Time calls on the host clock: ``targets`` maps a name to (owner,
    attribute); yields {name: [seconds of each call]}."""
    spent = {name: [] for name in targets}
    saved = []
    for name, (owner, attr) in targets.items():
        real = getattr(owner, attr)
        saved.append((owner, attr, real))

        def timed(*args, _real=real, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _real(*args, **kwargs)
            finally:
                spent[_name].append(time.perf_counter() - t0)

        setattr(owner, attr, timed)
    try:
        yield spent
    finally:
        for owner, attr, real in saved:
            setattr(owner, attr, real)


def pipeline_path(torch, dev, a_row, iters=10, warm=3):
    """Phase 11 (``pipeline:``): nnU-Net's workflow from a raw dataset
    through the port's entry points, in process (docstring step 11)."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="fnn_chip_smoke_pipeline_")
    env = {f"nnUNet_{k}": os.path.join(root, k)
           for k in ("raw", "preprocessed", "results")}
    old = {k: os.environ.get(k) for k in list(env) + [
        "FNNT_ITERS_PER_EPOCH", "FNNT_VAL_ITERS_PER_EPOCH",
        "FNNT_NUM_EPOCHS"]}
    os.environ.update(env)
    try:
        _pipeline(torch, dev, a_row, root, iters, warm)
        resenc_path(torch, dev, a_row)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _pipeline(torch, dev, a_row, root, iters, warm):
    import shutil
    import numpy as np
    from fast_nnunet_tpu_torch.ensembling.ensemble import ensemble_entry
    from fast_nnunet_tpu_torch.evaluation.find_best_configuration import \
        find_best_configuration_entry
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.planning import verify
    from fast_nnunet_tpu_torch.planning.fingerprint import \
        DatasetFingerprintExtractor
    from fast_nnunet_tpu_torch.planning.planner import ExperimentPlanner
    from fast_nnunet_tpu_torch.postprocessing.connected_components import \
        apply_postprocessing
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    from fast_nnunet_tpu_torch.run.evaluate import (
        apply_postprocessing_entry, evaluate_simple_entry)
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import \
        plan_and_preprocess_entry
    from fast_nnunet_tpu_torch.run.predict import predict_entry_point
    from fast_nnunet_tpu_torch.run.run_training import run_training_entry
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer
    from fast_nnunet_tpu_torch.utils.io import join, load_json

    ds, n = PIPELINE_DS, PIPELINE_N_TRAIN
    t0 = time.perf_counter()
    raw = write_raw_ct_dataset(os.environ["nnUNet_raw"])
    host = {"write_raw_s": time.perf_counter() - t0}
    print(f"pipeline: raw dataset {ds}: {n} training cases and 1 test case "
          f"{TRAIN_CASE} int16 at {TRAIN_SPACING} mm, {TRAIN_K} labels, "
          f"written as .nii.gz in {host['write_raw_s']:.3f} s")

    # ---- fast_nnunet_plan_and_preprocess_torch
    with host_seconds({
            "verify": (verify, "verify_dataset_integrity"),
            "fingerprint": (DatasetFingerprintExtractor, "run"),
            "plan": (ExperimentPlanner, "plan_experiment"),
            "preprocess": (DefaultPreprocessor, "run")}) as spent:
        t0 = time.perf_counter()
        plan_and_preprocess_entry(["-d", str(PIPELINE_DS_ID), "-c",
                                   "3d_fullres",
                                   "--verify_dataset_integrity"])
        host["plan_and_preprocess_s"] = time.perf_counter() - t0
    for k, v in spent.items():
        check(len(v) == 1, f"{k} ran {len(v)} times")
        host[k + "_s"] = v[0]
    host["preprocess_s_per_case"] = host["preprocess_s"] / n
    pre = join(os.environ["nnUNet_preprocessed"], ds)
    plans = load_json(join(pre, "nnUNetPlans.json"))
    topo = plan_topology(plans["configurations"]["3d_fullres"])
    print(f"pipeline: fast_nnunet_plan_and_preprocess_torch "
          f"{host['plan_and_preprocess_s']:.3f} s: verify "
          f"{host['verify_s']:.3f}, fingerprint {host['fingerprint_s']:.3f},"
          f" plan {host['plan_s']:.3f}, preprocess {host['preprocess_s']:.3f}"
          f" s ({host['preprocess_s_per_case']:.3f} s per case); "
          f"configurations {sorted(plans['configurations'])}")
    print("pipeline: planned 3d_fullres " + json.dumps(topo))
    check(topo == PIPELINE_3D_FULLRES, f"planned 3d_fullres {topo} is not "
          f"the frozen {PIPELINE_3D_FULLRES}")
    check("3d_lowres" not in plans["configurations"], "a 3d_lowres was planned")
    stored = sorted(os.listdir(join(pre, "nnUNetPlans_3d_fullres")))
    check(len(stored) == 3 * n, f"preprocessed store holds {stored}")

    # ---- fast_nnunet_train_torch DATASET 3d_fullres 0
    os.environ.update(FNNT_ITERS_PER_EPOCH=str(iters),
                      FNNT_VAL_ITERS_PER_EPOCH="2", FNNT_NUM_EPOCHS="1")
    cap = {}
    orig = stamp_iterations(NNUNetTrainer, "train_step", cap, warm)
    torch.cuda.reset_peak_memory_stats()
    ka.spatial_sum_sumsq.launches = 0
    t0 = time.perf_counter()
    try:
        run_training_entry([str(PIPELINE_DS_ID), "3d_fullres", "0"])
    finally:
        NNUNetTrainer.run_train_iterations = orig
    train_wall = time.perf_counter() - t0
    run_launches = ka.spatial_sum_sumsq.launches
    peak = torch.cuda.max_memory_allocated()
    peak_train = cap["peak_bytes"]
    trainer = cap["trainer"]
    st = cap["stamps"]
    fed = (st[-1] - st[warm]) / (iters - warm)
    x1 = torch.zeros((1, 1, *PIPELINE_3D_FULLRES["patch_size"]), device=dev)
    n_gate, n_gate_remat = gated_norms(torch, trainer.network, x1)
    predicted = n_gate + n_gate_remat
    tl = trainer.logger.logging
    print(f"pipeline: fast_nnunet_train_torch fold 0 ({iters} iterations, 2 "
          f"validation iterations, final validation) "
          f"{train_wall:.3f} s; remat {trainer._use_remat()!r}; fed seconds "
          f"per iteration {fed:.4f} (iterations {warm}-{iters - 1}); peak "
          f"device memory {peak_train / 2**30:.2f} GiB over the training "
          f"iterations, {peak / 2**30:.2f} GiB over the whole run (final "
          f"validation included)")
    print(f"pipeline: kernel A launches per train step "
          f"{cap['step_launches']} (predicted {predicted}: {n_gate} norms at "
          f">= 4096 voxels per forward, {n_gate_remat} recomputed by remat);"
          f" {run_launches} in the whole run; epoch train loss "
          f"{tl['train_losses'][0]:.4f}, val loss {tl['val_losses'][0]:.4f}")
    check(all(k == predicted for k in cap["step_launches"]),
          f"kernel A launches per step {cap['step_launches']} != {predicted}")
    check(predicted > 0, "the planned teacher launched no kernel A")
    check(np.isfinite(tl["train_losses"][0]) and
          np.isfinite(tl["val_losses"][0]),
          f"non-finite losses {tl['train_losses']} {tl['val_losses']}")
    a_shapes = sorted(cap["a_calls"])
    step_launches = cap["step_launches"]
    kernel_a_step_shapes(torch, "pipeline", cap["a_calls"],
                         cap["step_launches"][1], a_row)
    trainer.network = None
    del trainer, x1
    cap.clear()
    torch.cuda.empty_cache()

    # ---- fast_nnunet_find_best_configuration_torch DATASET -c 3d_fullres -f 0
    t0 = time.perf_counter()
    find_best_configuration_entry([str(PIPELINE_DS_ID), "-c", "3d_fullres",
                                   "-f", "0"])
    host["find_best_s"] = time.perf_counter() - t0
    results = join(os.environ["nnUNet_results"], ds)
    ident = "NNUNetTrainer__nnUNetPlans__3d_fullres"
    cv = join(results, "crossval_results_folds_0", ident)
    for f in (join(cv, "summary.json"), join(cv, "postprocessing.json"),
              join(results, "inference_information.json"),
              join(results, "inference_report.md"),
              join(results, "inference_report.html")):
        check(os.path.isfile(f), f"find-best did not write {f}")
    summary = load_json(join(cv, "summary.json"))
    dice = [summary["foreground_mean"]["Dice"]] + [
        m["Dice"] for m in summary["mean"].values()]
    check(all(isinstance(d, float) and np.isfinite(d) for d in dice),
          "cross-validation Dice not finite")
    pp = load_json(join(cv, "postprocessing.json"))
    print(f"pipeline: find-best {host['find_best_s']:.3f} s; cross-validation"
          f" foreground Dice {dice[0]:.4f} over {len(dice) - 1} labels; "
          f"postprocessing {pp['pp_fns']}")

    # ---- fast_nnunet_predict_torch twice, ensemble, postprocess, evaluate
    model = join(results, ident)
    outs = []
    for tta in ([], ["--disable_tta"]):
        out = join(os.environ["nnUNet_results"], f"imagesTs_pred{len(tta)}")
        t0 = time.perf_counter()
        predict_entry_point(["-i", join(raw, "imagesTs"), "-o", out, "-d",
                             ds, "-c", "3d_fullres", "-f", "0",
                             "--save_probabilities"] + tta)
        host["predict_tta_s" if not tta else "predict_s"] = \
            time.perf_counter() - t0
        for f in ("plans.json", "dataset.json"):  # what the ensemble reads
            shutil.copy(join(model, f), join(out, f))
        outs.append(out)
    ens = join(os.environ["nnUNet_results"], "imagesTs_ensemble")
    t0 = time.perf_counter()
    ensemble_entry(["-i", *outs, "-o", ens])
    host["ensemble_s"] = time.perf_counter() - t0
    case = f"case_{n:03d}"
    probs = [np.load(join(o, case + ".npz"))["probabilities"].astype(
        np.float32) for o in outs]
    expected = ((probs[0] + probs[1]) / 2).argmax(0)
    del probs
    mask = NiftiIO().read_seg(join(ens, case + ".nii.gz"))[0][0]
    check(mask.shape == TRAIN_CASE and np.array_equal(mask, expected),
          "ensembled mask is not the argmax of the mean probabilities")
    pp_out = join(os.environ["nnUNet_results"], "imagesTs_ensemble_pp")
    apply_postprocessing_entry([
        "-i", ens, "-o", pp_out, "-pp_json", join(cv, "postprocessing.json"),
        "-djfile", join(model, "dataset.json"), "-pfile",
        join(model, "plans.json")])
    pp_mask = NiftiIO().read_seg(join(pp_out, case + ".nii.gz"))[0][0]
    check(np.array_equal(pp_mask, apply_postprocessing(
        mask, pp["pp_fns"], pp["pp_fn_kwargs"])),
        "postprocessed file differs from apply_postprocessing in memory")
    evaluate_simple_entry([join(raw, "labelsTs"), pp_out, "-l",
                           *map(str, range(1, TRAIN_K))])
    test_dice = load_json(join(pp_out, "summary.json"))["foreground_mean"][
        "Dice"]
    check(np.isfinite(test_dice), f"test Dice {test_dice}")
    print(f"pipeline: predict imagesTs {host['predict_tta_s']:.3f} s with "
          f"mirror TTA, {host['predict_s']:.3f} s without; ensemble "
          f"{host['ensemble_s']:.3f} s, equal to the argmax of the mean "
          f"probabilities; postprocessed file equals apply_postprocessing; "
          f"test foreground Dice {test_dice:.4f} (seeded random start, "
          f"{iters} iterations)")
    print(json.dumps({"pipeline": {
        "host_s": host, "fed_s_per_iter": fed,
        "peak_gib_train": peak_train / 2**30, "peak_gib_run": peak / 2**30,
        "kernel_a_launches_per_step": step_launches,
        "kernel_a_predicted_per_step": predicted,
        "kernel_a_run_launches": run_launches,
        "kernel_a_shapes": [f"{shape} {dtype}" for shape, dtype in a_shapes],
        "topology": topo, "cv_fg_dice": dice[0], "test_fg_dice": test_dice}}))


# ------------------------------------------------------------------ resenc
def resenc_path(torch, dev, a_row, iters=10, warm=3, d_iters=6, d_warm=2):
    """Phase 12 (``resenc:``): nnU-Net's ResEnc L workflow on phase 11's
    dataset through the port's entry points, in process (docstring step
    12)."""
    import numpy as np
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.models.factory import \
        build_network_from_arch_dict
    from fast_nnunet_tpu_torch.models.unet import (init_he_normal_,
                                                   params_to_jax)
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.planning.planner import ExperimentPlanner
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    from fast_nnunet_tpu_torch.run.distillation_train import \
        resenc_distillation_train_entry
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import \
        plan_and_preprocess_entry
    from fast_nnunet_tpu_torch.run.predict import predict_entry_point
    from fast_nnunet_tpu_torch.run.run_training import run_training_entry
    from fast_nnunet_tpu_torch.training.checkpoint import save_checkpoint
    from fast_nnunet_tpu_torch.training.distill import \
        NNUNetDistillationTrainer
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer
    from fast_nnunet_tpu_torch.utils.io import join, load_json, maybe_mkdir_p

    t_phase = time.perf_counter()
    ds, plans_id, n = PIPELINE_DS, RESENC_PLANS, PIPELINE_N_TRAIN
    ident = str(PIPELINE_DS_ID)
    # ---- fast_nnunet_plan_and_preprocess_torch -pl nnUNetPlannerResEncL
    with host_seconds({"plan": (ExperimentPlanner, "plan_experiment"),
                       "preprocess": (DefaultPreprocessor, "run")}) as spent:
        t0 = time.perf_counter()
        plan_and_preprocess_entry(["-d", ident, "-pl", "nnUNetPlannerResEncL",
                                   "-c", "3d_fullres"])
        host = {"plan_and_preprocess_s": time.perf_counter() - t0}
    for k, v in spent.items():
        check(len(v) == 1, f"{k} ran {len(v)} times")
        host[k + "_s"] = v[0]
    pre = join(os.environ["nnUNet_preprocessed"], ds)
    plans = load_json(join(pre, plans_id + ".json"))
    topo = plan_topology(plans["configurations"]["3d_fullres"], RESENC_KEYS)
    print(f"resenc: fast_nnunet_plan_and_preprocess_torch -pl "
          f"nnUNetPlannerResEncL {host['plan_and_preprocess_s']:.3f} s "
          f"(fingerprint of phase 11 reused): plan {host['plan_s']:.3f}, "
          f"preprocess {host['preprocess_s']:.3f} s")
    print("resenc: planned 3d_fullres " + json.dumps(topo))
    check(topo == PIPELINE_RESENC_L, f"planned ResEnc L {topo} is not the "
          f"frozen {PIPELINE_RESENC_L}")
    stored = os.listdir(join(pre, plans_id + "_3d_fullres"))
    check(len(stored) == 3 * n, f"preprocessed store holds {stored}")

    # ---- fast_nnunet_train_torch 988 3d_fullres 0 -p nnUNetResEncUNetLPlans
    os.environ.update(FNNT_ITERS_PER_EPOCH=str(iters),
                      FNNT_VAL_ITERS_PER_EPOCH="2", FNNT_NUM_EPOCHS="1")
    cap = {}
    orig = stamp_iterations(NNUNetTrainer, "train_step", cap, warm)
    torch.cuda.reset_peak_memory_stats()
    ka.spatial_sum_sumsq.launches = 0
    t0 = time.perf_counter()
    try:
        run_training_entry([ident, "3d_fullres", "0", "-p", plans_id])
    finally:
        NNUNetTrainer.run_train_iterations = orig
    train_wall = time.perf_counter() - t0
    run_launches = ka.spatial_sum_sumsq.launches
    peak, peak_train = torch.cuda.max_memory_allocated(), cap["peak_bytes"]
    trainer = cap["trainer"]
    st = cap["stamps"]
    fed = (st[-1] - st[warm]) / (iters - warm)
    x1 = torch.zeros((1, 1, *topo["patch_size"]), device=dev)
    n_gate, n_remat = gated_norms(torch, trainer.network, x1)
    f_fwd, f_remat = conv_flops(torch, trainer.network, x1)
    flops = topo["batch_size"] * (3 * f_fwd + f_remat)   # hooks: batch 1
    predicted = n_gate + n_remat
    tl = trainer.logger.logging
    print(f"resenc: teacher ResidualEncoderUNet features "
          f"{stage_features(trainer.network)}, blocks "
          f"{topo['n_blocks_per_stage']}, {TRAIN_K} classes, patch "
          f"{topo['patch_size']}, batch {topo['batch_size']}, remat "
          f"{trainer._use_remat()!r}; fast_nnunet_train_torch fold 0 ({iters}"
          f" iterations, 2 validation iterations, final validation) "
          f"{train_wall:.3f} s; fed seconds per iteration {fed:.4f} "
          f"(iterations {warm}-{iters - 1}); FLOPs per step {flops:.4e}, mfu"
          f" fed {flops / fed / BF16_TENSOR_OPS_PER_S:.4f}; peak device "
          f"memory {peak_train / 2**30:.2f} GiB over the training "
          f"iterations, {peak / 2**30:.2f} GiB over the whole run")
    print(f"resenc: kernel A launches per train step {cap['step_launches']} "
          f"(predicted {predicted}: {n_gate} norms at >= 4096 voxels per "
          f"forward, {n_remat} recomputed by remat); {run_launches} in the "
          f"whole run; epoch train loss {tl['train_losses'][0]:.4f}, val "
          f"loss {tl['val_losses'][0]:.4f}")
    check(all(k == predicted for k in cap["step_launches"]),
          f"kernel A launches per step {cap['step_launches']} != {predicted}")
    check(np.isfinite(tl["train_losses"][0]) and
          np.isfinite(tl["val_losses"][0]),
          f"non-finite losses {tl['train_losses']} {tl['val_losses']}")
    a_shapes = sorted(cap["a_calls"])
    out = {"host_s": host, "topology": topo, "fed_s_per_iter": fed,
           "flops_per_step": flops, "peak_gib_train": peak_train / 2**30,
           "peak_gib_run": peak / 2**30,
           "kernel_a_launches_per_step": cap["step_launches"],
           "kernel_a_predicted_per_step": predicted,
           "kernel_a_shapes": [f"{sh} {dt}" for sh, dt in a_shapes],
           "train_loss": tl["train_losses"][0]}
    step_launches = cap["step_launches"][1]
    calls = cap["a_calls"]
    arch = plans["configurations"]["3d_fullres"]["architecture"]
    trainer.network = None
    del trainer, x1
    cap.clear()
    torch.cuda.empty_cache()
    kernel_a_step_shapes(torch, "resenc", calls, step_launches, a_row)

    # ---- 4 seeded random ResEnc L folds beside the trained fold 0
    t0 = time.perf_counter()
    results = join(os.environ["nnUNet_results"], ds)
    model = join(results, f"NNUNetTrainer__{plans_id}__3d_fullres")
    net = build_network_from_arch_dict(arch, 1, TRAIN_K, trainable=True)
    for f in range(1, 5):
        maybe_mkdir_p(join(model, f"fold_{f}"))
        save_checkpoint(join(model, f"fold_{f}", "checkpoint_final.fnnx"),
                        network_weights=params_to_jax(
                            init_he_normal_(net, 100 + f)),
                        init_args={"fold": f, "configuration": "3d_fullres"})
    del net
    print(f"resenc: 4 teacher folds of seeded random ResEnc L weights "
          f"written in {time.perf_counter() - t0:.3f} s")

    # ---- fast_nnunet_resenc_distill_torch -tpl L -spl L (5 teachers)
    os.environ.update(FNNT_ITERS_PER_EPOCH=str(d_iters),
                      FNNT_VAL_ITERS_PER_EPOCH="1")
    cap = {}
    orig = stamp_iterations(NNUNetDistillationTrainer, "distill_step", cap,
                            d_warm)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        resenc_distillation_train_entry(["-d", ident, "-tpl", plans_id,
                                         "-spl", plans_id])
    finally:
        NNUNetDistillationTrainer.run_train_iterations = orig
    d_wall = time.perf_counter() - t0
    trainer = cap["trainer"]
    st = cap["stamps"]
    d_iter = (st[-1] - st[d_warm]) / (d_iters - d_warm)
    lg = trainer.logger.logging
    seg, dist = lg["train_seg_losses"][0], lg["train_distill_losses"][0]
    x1 = torch.zeros((1, 1, *topo["patch_size"]), device=dev)
    s_gate, s_remat = gated_norms(torch, trainer.network, x1)
    t_gate, _ = gated_norms(torch, trainer.teachers[0], x1)
    d_predicted = s_gate + s_remat + len(trainer.teachers) * t_gate
    print(f"resenc: LiteResEncStudent features "
          f"{stage_features(trainer.network)}, "
          f"{len(trainer.teachers)} teacher folds {trainer.teacher_fold}; "
          f"fast_nnunet_resenc_distill_torch ({d_iters} iterations, 1 "
          f"validation iteration, final validation) {d_wall:.3f} s; warm "
          f"seconds per iteration {d_iter:.4f}; peak device memory "
          f"{cap['peak_bytes'] / 2**30:.2f} GiB over the iterations; seg "
          f"loss {seg:.4f}, distill loss {dist:.4f}")
    print(f"resenc: kernel A launches per distillation step "
          f"{cap['step_launches']} (predicted {d_predicted}: student "
          f"{s_gate} + {s_remat} recomputed, {len(trainer.teachers)} "
          f"teachers x {t_gate})")
    check(len(trainer.teachers) == 5, "not 5 teacher folds")
    check(np.isfinite(seg) and np.isfinite(dist) and dist > 0,
          f"distillation losses seg {seg} distill {dist}")
    check(all(k == d_predicted for k in cap["step_launches"]),
          f"kernel A launches per distillation step {cap['step_launches']}"
          f" != {d_predicted}")
    out.update(distill_s_per_iter=d_iter, distill_seg_loss=seg,
               distill_loss=dist,
               distill_peak_gib=cap["peak_bytes"] / 2**30,
               distill_launches_per_step=cap["step_launches"],
               distill_predicted_per_step=d_predicted)
    calls, step_launches = cap["a_calls"], cap["step_launches"][1]
    trainer.teachers, trainer.network = [], None
    del trainer, x1
    cap.clear()
    torch.cuda.empty_cache()
    kernel_a_step_shapes(torch, "resenc_distill", calls, step_launches, a_row)

    # ---- fast_nnunet_predict_torch on imagesTs with the teacher and student
    raw = join(os.environ["nnUNet_raw"], ds)
    case = f"case_{n:03d}"
    for who, trainer_name in (("teacher", "NNUNetTrainer"),
                              ("student", "NNUNetDistillationTrainer")):
        o = join(os.environ["nnUNet_results"], f"imagesTs_resenc_{who}")
        t0 = time.perf_counter()
        predict_entry_point(["-i", join(raw, "imagesTs"), "-o", o, "-d", ds,
                             "-p", plans_id, "-tr", trainer_name, "-c",
                             "3d_fullres", "-f", "0", "--disable_tta"])
        host[f"predict_{who}_s"] = time.perf_counter() - t0
        mask = NiftiIO().read_seg(join(o, case + ".nii.gz"))[0][0]
        labels = np.unique(mask)
        check(mask.shape == TRAIN_CASE and labels.max() < TRAIN_K,
              f"{who} mask {mask.shape} labels {labels[:8]}")
        print(f"resenc: fast_nnunet_predict_torch with the {who} "
              f"{host[f'predict_{who}_s']:.3f} s: mask {mask.shape}, "
              f"{len(labels)} labels")

    # ---- small: ResEnc and BatchNorm steps cuda vs cpu; DA5 distillation
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["small_resenc"] = small_train_step(
            torch, dev, "ResidualEncoderUNet", SMALL_RESENC,
            "ResEnc train step")
        out["small_bn"] = small_train_step(
            torch, dev, "PlainConvUNet",
            dict(SMALL_ARCH, norm_op="torch.nn.BatchNorm3d"),
            "NNUNetTrainerBN train step", kernel_a=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["small_da5"] = small_da5_distill(torch)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"resenc: phase wall {out['wall_s']:.3f} s")
    print(json.dumps({"resenc": out}))


def small_da5_distill(torch, iters=4):
    """``fast_nnunet_resenc_distill_torch --use_da5`` at small size on the
    card: 4 synthetic cases (1, 40, 48, 48), a 3-stage ResEnc (patch 32^3,
    4 classes), 2 seeded random teacher folds, ``iters`` iterations under
    the DA5 augmentation."""
    import numpy as np
    from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
    from fast_nnunet_tpu_torch.models.unet import (init_he_normal_,
                                                   params_to_jax)
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.run.distillation_train import \
        resenc_distillation_train_entry
    from fast_nnunet_tpu_torch.training.checkpoint import load_checkpoint
    from fast_nnunet_tpu_torch.training.checkpoint import save_checkpoint
    from fast_nnunet_tpu_torch.utils.io import join, maybe_mkdir_p, save_json

    ds, plans_id, k = "Dataset989_SmallResEnc", RESENC_PLANS, 4
    arch = {"network_class_name": "dynamic_network_architectures."
                                  "architectures.unet.ResidualEncoderUNet",
            "arch_kwargs": dict(SMALL_RESENC,
                                conv_op="torch.nn.modules.conv.Conv3d",
                                norm_op="torch.nn.modules.instancenorm."
                                        "InstanceNorm3d"),
            "_kw_requires_import": ["conv_op", "norm_op"]}
    root = os.path.dirname(os.environ["nnUNet_raw"])
    plans = write_train_dataset(root, 4, 1, ds, (40, 48, 48), k, arch,
                                (32, 32, 32), plans_id)
    teacher = join(os.environ["nnUNet_results"], ds,
                   f"NNUNetTrainer__{plans_id}__3d_fullres")
    maybe_mkdir_p(teacher)
    save_json(plans, join(teacher, "plans.json"))
    net = get_network_from_plans(arch["network_class_name"],
                                 arch["arch_kwargs"], (), 1, k,
                                 trainable=True)
    for f in range(2):
        maybe_mkdir_p(join(teacher, f"fold_{f}"))
        save_checkpoint(join(teacher, f"fold_{f}", "checkpoint_final.fnnx"),
                        network_weights=params_to_jax(
                            init_he_normal_(net, 200 + f)))
    os.environ.update(FNNT_ITERS_PER_EPOCH=str(iters),
                      FNNT_VAL_ITERS_PER_EPOCH="1", FNNT_NUM_EPOCHS="1")
    n0 = ka.spatial_sum_sumsq.launches
    t0 = time.perf_counter()
    resenc_distillation_train_entry(["-d", ds, "-tpl", plans_id, "-spl",
                                     plans_id, "--use_da5"])
    wall = time.perf_counter() - t0
    launches = ka.spatial_sum_sumsq.launches - n0
    ck = load_checkpoint(join(
        os.environ["nnUNet_results"], ds,
        f"NNUNetDistillationTrainerDA5__{plans_id}__3d_fullres", "fold_0",
        "checkpoint_final.fnnx"))
    lg = ck["logging"]
    seg, dist = lg["train_seg_losses"][0], lg["train_distill_losses"][0]
    print(f"small: fast_nnunet_resenc_distill_torch --use_da5 "
          f"({ck['trainer_name']}, 2 teacher folds, {iters} iterations, "
          f"patch 32^3) {wall:.3f} s on the card, {launches} kernel A "
          f"launches; seg loss {seg:.4f}, distill loss {dist:.4f}")
    check(ck["trainer_name"] == "NNUNetDistillationTrainerDA5",
          f"trainer {ck['trainer_name']}")
    check(np.isfinite(seg) and np.isfinite(dist), "DA5 distillation losses")
    check(launches > 0, "the DA5 distillation launched no kernel A")
    return {"wall_s": wall, "a_launches": launches, "seg_loss": seg,
            "distill_loss": dist}


def small_train_step(torch, dev, cls="PlainConvUNet", arch=SMALL_ARCH,
                     name="train step", kernel_a=True):
    """Three SGD steps of a narrow training network ``cls`` at ``arch``,
    fp32 with TF32 off and deterministic cuDNN, cuda (kernel A, unless
    ``kernel_a`` is False: a BatchNorm network has no InstanceNorm) vs cpu
    (plain version): losses within 1e-4 relative, parameters (and a
    BatchNorm network's running averages) within 1e-5 absolute."""
    import numpy as np
    from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
    from fast_nnunet_tpu_torch.models.s2d import random_plain_params
    from fast_nnunet_tpu_torch.models.unet import (init_he_normal_,
                                                   params_from_jax,
                                                   params_to_jax)
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

    def build():
        return get_network_from_plans(
            cls, arch, (), 1, 4, compute_dtype=torch.float32,
            norm_onepass=True, trainable=True)

    tree = random_plain_params(arch, 1, 4, seed=6) \
        if cls == "PlainConvUNet" and "norm_op" not in arch \
        else params_to_jax(init_he_normal_(build(), 6))
    res = []
    try:
        for d in (dev, torch.device("cpu")):
            net = params_from_jax(build(), tree).to(d)
            opt = nnunet_sgd(net.parameters(), poly_lr(1e-2, 10))
            step = make_train_step(net, opt, n_ds_levels=2)
            n0 = ka.spatial_sum_sumsq.launches
            losses = [float(step(x.to(d), tuple(t.to(d) for t in tg)))
                      for x, tg in batches]
            res.append((losses, params_to_jax(net),
                        ka.spatial_sum_sumsq.launches - n0))
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cudnn.deterministic = prev
    (lc, pc, n_k), (lp, pp, _) = res
    lc, lp = np.array(lc), np.array(lp)
    loss_rel = float(np.abs(lc - lp).max() / np.abs(lp).max())

    def leaves(t):
        return [v for x in t.values() for v in (
            leaves(x) if isinstance(x, dict) else [x])]
    p_err = max(float(np.abs(a - b).max())
                for a, b in zip(leaves(pc), leaves(pp)))
    print(f"small: fp32 {name} x3 cuda ({n_k} kernel A "
          f"launches) vs cpu: losses {lc.round(6).tolist()} vs "
          f"{lp.round(6).tolist()}, max loss rel diff {loss_rel:.3e} "
          f"(bound 1e-4), max parameter diff {p_err:.3e} (bound 1e-5)")
    check((n_k > 0) == kernel_a, f"small {name}: {n_k} kernel A launches")
    check(loss_rel <= 1e-4 and p_err <= 1e-5,
          f"small {name} cuda vs cpu: loss {loss_rel}, params {p_err}")
    return {"loss_rel": loss_rel, "param_err": p_err, "a_launches": n_k}


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
