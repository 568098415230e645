#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fast_nnunet_tpu_torch) on one NVIDIA
GPU — the quickest proof that the port's serving path starts and is right on
the card. Run from the repository root:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), builds the
   hand-written kernels from fast_nnunet_tpu_torch/csrc (timed) and prints
   what ptxas reports for kernels A, B, C and E (registers, static shared
   memory, spills, stack).
2. s2d main path at full width: the bone_turbo r=2 distilled student (6
   stages, features 16..160, 61 classes; seeded random weights in the JAX
   package's tree layout, loaded through params_from_jax) over a 512x512x500
   synthetic CT at 0.8x0.8x1.0 mm through ``TurboPipeline.predict_volume``
   with the engine INI's settings (bf16 compute and accumulator, tile batch
   8, air skipping on). One warm run, then timed runs; the first timed run
   is split into phases by CUDA events and its kernel launch counts are read
   (kernels A, B, C and E must have launched).
3. Kernels A, B, C and E at that path's shapes, on tensors taken from it,
   against their plain PyTorch versions (A within f32 summation tolerance,
   B, C and E bit for bit, C in both accumulator modes; E on the stage-0
   conv output with groups 8), timed beside their bound, their
   plain version and, where one exists, a library call; A, B and C with
   their launch plans, C with whether its features took the 16-byte path.
   Every ``ms`` is CUDA events around calls launched from Python; kernels A
   and E add ``device_ms``, the same calls replayed from a CUDA graph (its
   smaller calls take less than their Python launch), both over copies of
   its input that together exceed the L2.
4. Plain full-res path at full width (bench.py's plain contract): the same
   student as a PlainConvUNet through ``SlidingWindowEngine.
   predict_segmentation`` on a 512^3 (rand - 0.5) * 2 volume, patch
   96x96x160, bf16 compute and sweep accumulator, tile batch 8, 4 GiB
   budget, ``use_fused_accumulate=True``: every accumulate is kernel D. One
   warm run and two timed runs; the first timed run is phased and counted.
   Then the plain engine's default route, the same engine without kernel D
   (the reference grid, torch's per-tile accumulate): one timed, phased
   run at 512^3; and at (200, 128, 192) (uneven x rolls), fp32 with TF32
   off, its ``predict_segmentation_sweep`` held (>= 0.999) to a tile-by-
   tile accumulation of the reference grid written out in torch.
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
   ``fast_nnunet_predict_torch`` on imagesTs with mirror TTA and
   ``--save_probabilities``, and with ``--disable_tta`` (no probabilities:
   a second 478 MB export costs ~38 s, PERF.md §4);
   ``fast_nnunet_ensemble_torch`` of the TTA folder given twice (the mask
   must equal the argmax of the mean of the .npz, recomputed with numpy);
   ``fast_nnunet_apply_postprocessing_torch`` (must
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
13. nnU-Net's 2d and 3d_lowres -> 3d_cascade_fullres configurations
   (``cascade:``), all through the port's entry points in this process:
   CASCADE_N_TRAIN (2) training cases and 1 test case of (48, 512, 512)
   int16 CT at (2.5, 0.8, 0.8) mm (the serving workload's in-plane grid)
   with 61 labels;
   ``fast_nnunet_plan_and_preprocess_torch -d 990 -c 2d 3d_fullres
   3d_lowres`` (host seconds per step and per configuration), whose four
   configurations must equal CASCADE_PLANS (the 2d: 512^2 patch, batch 5,
   8 stages up to 512 features); a ``splits_final.json`` with fold 0
   (train case_001, validate case_000); ``fast_nnunet_train_torch 990 2d 0``,
   ``... 3d_lowres all`` and ``... 3d_cascade_fullres 0``, each one epoch of
   10 iterations, 2 validation iterations and the final validation (the 2d
   one 2D-over-slices, the lowres one leaving 2 ``predicted_next_stage``
   deposits on the 3d_fullres grid, the cascade one with the one-hot
   previous-stage channels; its host seconds split into sliding window,
   export, deposits and metrics): fed seconds per iteration, CUDA-event
   phases (the cascade's ``data`` and ``h2d`` apart), peak memory, FLOPs and
   ``mfu``, a finite and falling loss, kernel A launches per step against
   the gate's count (the 2D networks' first 4-D calls), every (shape, dtype)
   A takes in one step checked and timed into A's ``train_shapes``; the
   cascade network takes 1 + 60 input channels;
   ``fast_nnunet_predict_torch -c 2d``, ``-c 3d_lowres -f all`` and ``-c
   3d_cascade_fullres -prev_stage_predictions <lowres output>``, each
   ``--disable_tta``, on imagesTs (sliding window and export seconds apart; each
   mask the image's shape and spacing, labels in 0..60), each evaluated
   by ``fast_nnunet_evaluate_simple_torch`` (finite
   Dice); a narrow 2D PlainConvUNet, a narrow 2D ResidualEncoderUNet and a
   narrow cascade step with one-hot input, cuda vs cpu as in 10. One
   ``{"cascade": ...}`` line. Then the distillation of both: the 3d_lowres
   deposits copied to the distillation trainer's lowres folder (the
   reference's ``predicted_next_stage`` convention), ``fast_nnunet_distill_
   torch -d 990 -c 2d`` and ``-c 3d_cascade_fullres``, each ``-t <its
   NNUNetTrainer model folder> -tf 0 -r 2 -a 0.3 -temp 3.0`` for
   DISTILL_ITERS iterations and the final validation: seconds per
   iteration, peak memory, finite losses, kernel A launches per step
   against the gate's count (the 2D student and teacher at 4-D, the
   cascade student and teacher on 1 + 60 channels), A's calls of one step
   checked and timed into A's ``train_shapes``; each student predicts the
   test case (``-tr NNUNetDistillationTrainer --disable_tta``, the cascade
   one from the 3d_lowres predictions).
14. Export and the fast-inference module (``fast_inference:``): the
   bone_turbo r = 2 student (features 16..160, 61 classes, seeded random
   weights) as a ``NNUNetDistillationTrainer`` fold-0 checkpoint with its
   plans (patch 160x96x96, the INI's spacing and CT normalisation);
   ``export_model_folder_to_artifact`` on the card, bf16, B = 8, validated
   (max relative deviation <= 1e-2), and the ``--tta`` artifact (validated);
   ``FastnnUNetAPI`` over the artifact on 127.0.0.1 (``/health`` polled):
   ``/model_info``; ``/predict`` of a 512x512xN int16 CT at 0.8x0.8x1.0 mm
   (N = FAST_CT_SLICES) with postprocessing, split into host steps and
   device phases, its mask of the input's shape, spacing and affine with
   labels in 0..60, and before postprocessing in >= 0.999 agreement with
   the model-folder route's (``FastnnUNetInferencer(model_folder=...)``);
   ``/predict_array`` of a 160x192x192 f32 volume (1.44 GB of logits
   back), bit-equal to ``predict_logits_from_preprocessed`` in process;
   ``/predict`` with VTK on a 48^3 CT; ``/predict_batch`` over two;
   ``fast_nnunet_jhu_predict_torch`` on one case (60 class files). Prints
   seconds per request, peak device memory, whether libdeflate loaded, and
   one ``{"fast_inference": ...}`` line.

15. The turbo pipeline's host route and the other serving routes
   (``host:``), on phase 2's student and CT, right after phase 3: the host
   library (csrc/host_ops.cpp) built with the host compiler (seconds);
   ``TurboPipeline(host_preprocess=True, host_revert=True)`` with the INI's
   settings on its lazy streamed route, a warm run and 3 timed runs (s/CT
   beside phase 2's), the first counted (kernels A, B and C each launched)
   and phased (host preprocess seconds over the strips, upload, forward,
   accumulate, finalize, pack, d2h, unpack + revert), peak memory; the
   host-preprocessed grid against the device route's (within one bf16 ulp,
   ulps floored at magnitude 1); the streamed against the fused host route
   with air skipping off (>= 0.999, differing voxels printed); the host
   route's mask against phase 2's (>= 0.99); the device route with
   ``host_revert=True`` (s/CT, the packed mask's d2h beside phase 2's, the
   card's and the host's revert of one target-grid mask bit-equal); two
   seeded folds on the device route (s/CT, peak memory, launches: C none,
   as in JAX) and the tree twice against the tree (>= 0.999).
16. The reference's data (``formats:``), in phase 11's root after phase
   12: phase 11's raw dataset written again as ``.mha`` (zlib;
   Dataset987_FormatsCT, the same voxels and seed; the test label also
   through NRRD), its fingerprint, phase 11's plans moved over with
   ``fast_nnunet_move_plans_torch`` (reader MhaIO, the same topology),
   ``fast_nnunet_preprocess_torch -store fnnz`` (seconds, bytes against
   phase 11's ``.npy`` store, the zstd backend), every case decoded
   bit-equal to phase 11's store (data, seg, properties); one case through
   ``write_b2nd`` and ``fast_nnunet_convert_b2nd_torch``, bit-equal; a
   seeded reference-named ``.pth`` of the planned topology;
   ``fast_nnunet_train_torch 987 3d_fullres 0 -pretrained_weights`` 10 + 2
   iterations fed from the ``.fnnz`` store with its final validation (the
   import report: every non-seg tensor converted; the first conv equal to
   the ``.pth`` before step 1; kernel A's launches per step against the
   gate's count; fed s/iteration beside phase 11's ``.npy`` figure and the
   loader threads' BrickReader seconds); ``fast_nnunet_predict_torch`` on
   the ``.mha`` test case, the same CT as a DICOM series
   (``write_dicom_series``) through ``fast_nnunet_dicom_to_nifti_torch``
   (voxels and spacing equal) and through ``DicomIO`` and
   ``predict_single_npy_array``: its mask equal to the ``.mha`` one. One
   ``{"formats": ...}`` line.
17. The Primus transformer (``primus:``), in phase 11's root after phase
   16: ``fast_nnunet_train_torch 988 3d_fullres_primus 0 -tr
   nnUNet_Primus_M_Trainer`` at full width (embed 864, depth 16, 12 heads,
   8^3 tokens) at Primus M's 160^3 plan (a configuration of the plans that
   inherits 3d_fullres with patch 160^3: 8,000 tokens, batch 2, 61
   classes, bf16 compute / f32 parameters, AdamW, the fused attention,
   kernels F and G), one epoch of 10 iterations, 2 validation iterations
   and the final validation: fed and cached seconds per iteration,
   CUDA-event phases (the attention's among them), peak memory, FLOPs per
   step from the shapes and ``mfu``, kernel A launches per step (0: no
   InstanceNorm), F's and G's launches (16 and 2 x 16 a train step), a
   finite loss falling over 10 cached steps; a NaN batch
   through the NaN-guarded step leaves the parameters, the AdamW moments
   and the schedule count bit-equal; ``fast_nnunet_predict_torch -c
   3d_fullres_primus -tr nnUNet_Primus_M_Trainer`` on the test case
   through a rebuilt
   ``Primus``; a small Primus cuda vs cpu in fp32 (logits 1e-4 of their
   scale, one AdamW step's parameters 1e-5). One ``{"primus": ...}``
   line.
18. Several GPUs (``multi:``), in phase 11's root after phase 17, on the
   one card: (a) the slab-parallel s2d sweep
   (``inference.sharded.predict_segmentation_multigpu_s2d``) of phase 2's
   CT, preprocessed, with phase 2's student (61 classes, bf16, patch
   160x96x96, tile batch 8) on 2 gloo ranks sharing cuda:0, parallel and
   ``halo_exact``, against the single-card ``predict_segmentation_sweep_
   s2d``: rows outside the halo bit-equal and >= 0.999 overall, the exact
   mode bit-equal; each rank launched A, B and C, and its captured C and B
   calls (its slab's shapes) equal the plain versions bit for bit; (b) the
   plain sweep with kernel D the same way on a MULTI_PLAIN_SIZE^3 volume;
   (c) NCCL at world 1: the s2d sweep bit-equal, and one ``run_training``
   iteration through the launcher (``num_gpus=1, backend="nccl"``); (d)
   ``run_training`` of phase 11's planned teacher on 2 gloo ranks through
   the launcher (global batch 2, fold all, NoMirroring, 6 + 1
   iterations): per-iteration losses identical on both ranks, the final
   parameters equal, 32 kernel A launches a step on each, only rank 0
   wrote checkpoints and summary.json, the 5 validation cases split over
   the ranks; the first update on a fixed batch against one process on
   the global batch (float32, 1e-5); (e) a small BatchNorm network with
   batch Dice, two steps on 2 gloo ranks against one process on the
   global batch (1e-5, running averages included). Sweep seconds and peak
   memory per rank beside the single card's (a record: the ranks share
   one card). One ``{"multi": ...}`` line.
19. The JAX package's last modules. A worker process (``chip_smoke.py
   --phase19-build``), started after phase 3 at a lower priority, does
   the phase's host work while the phases after phase 3 run (15, 4-5, 7-9,
   6, 10, then 11-12 if it is still compiling): it builds the native
   engine (``ops._build.engine_binary()``), compiles phase 2's student at
   its tile batch into a fresh package cache
   (``SlidingWindowEngine.fold_forward``, inference/aot.py) and exports
   phase 14's student with ``--aoti`` (bf16, B = 8) on the card, unvalidated.
   Its only work on the card is what compiling needs (weights uploaded,
   Inductor's constant folding and compile-time benchmarks, one forward of
   8 zero tiles); all that phase 19 times on the card runs in this process
   after joining it. After phases 11-12: (a, ``aot:``) the worker's compile
   and export seconds and the package's MB; ``TurboPipeline`` on the
   device route with that ``aot_cache`` on phase 2's CT in this process, a
   fresh interpreter to the package: compiling switched off, the package
   loaded (its mtime unchanged, the log says loaded); its launches per CT
   equal phase 2's (A 180, B 8, C 15: kernel A is not compiled away) and
   its mask phase 2's eager mask (>= 0.999); warm s/CT eager and aot in
   turns (a record). (b, ``trace:``) one warm CT of phase 2 inside
   ``utils.profiling.maybe_trace``, attributed by
   ``utils.trace_analysis.attribute_trace``: kernels A, B and C by symbol
   with phase 2's launch counts, the busy time beside the CUDA-event phase
   sum, the idle share; then phase 6's small fused plain sweep in a second
   trace, kernel D by symbol with its wrapper's count. (c, ``engine:``,
   after phase 14) the package validated against ``model.pt2`` run eagerly
   (1e-2), then the port's C++ engine with ``--aoti`` on a 192 x 192 x 160
   CT at the INI's target spacing against the port's Python engine over
   the same INI pipeline on ``model.pt2`` (the eager network, >= 0.995) and
   on the package (>= 0.995); its seconds beside the Python engine's and
   phase 14's ``/predict``. (d, ``share:``, in phase 11's root after phase
   11) the planned teacher's fold 0 zipped with
   ``fast_nnunet_export_model_to_zip_torch`` and installed with
   ``fast_nnunet_install_pretrained_model_from_zip_torch`` into a fresh
   results root: every file equal byte for byte.

Prints the kernels JSON on its own line (every row with ``bound_share`` =
bound_ms / ms), then last ``{"ok": true, "device": {...}}``. Any failure
exits non-zero without it.
"""
import configparser
import contextlib
import json
import math
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


# phase 13: nnU-Net's 2d and 3d_lowres -> 3d_cascade_fullres configurations,
# on a raw CT dataset at the serving workload's in-plane grid (512 x 512 at
# 0.8 mm) with 48 slices at 2.5 mm: the fewest at which the default planner
# still writes a 3d_lowres (the host resampling of 61 classes at 512^2 costs
# its time per slice); the four planned topologies, frozen like
# PIPELINE_3D_FULLRES (tests/test_torch_planning.py holds them against the
# JAX planner)
CASCADE_DS_ID = 990
CASCADE_DS = "Dataset990_CascadeCT"
CASCADE_CASE = (48, 512, 512)
CASCADE_SPACING = [2.5, 0.800000011920929, 0.800000011920929]  # 0.8 in f32,
# as a NIfTI header stores it
CASCADE_CONFIGS = ("2d", "3d_fullres", "3d_lowres", "3d_cascade_fullres")
# two training cases (+ the test case) and one fold-0 split written by the
# phase (train case_001, validate case_000): the 3d_lowres final validation
# resamples each case's 61 classes twice on the host, 36 s a case. The 2d
# batch follows the count (nnU-Net's planner caps a batch at 5% of the
# dataset's voxels: 5 slices of 512^2 for 2 cases, 10 for 5)
CASCADE_N_TRAIN = 2
_CASCADE_FULLRES = {
    "patch_size": [24, 256, 256], "batch_size": 2,
    "spacing": CASCADE_SPACING, "normalization_schemes": ["CTNormalization"],
    "n_stages": 7, "features_per_stage": [32, 64, 128, 256, 320, 320, 320],
    "kernel_sizes": [[1, 3, 3]] + [[3, 3, 3]] * 6,
    "strides": [[1, 1, 1], [1, 2, 2], [2, 2, 2], [2, 2, 2], [1, 2, 2],
                [1, 2, 2], [1, 2, 2]],
}
CASCADE_PLANS = {
    "2d": {
        "patch_size": [512, 512], "batch_size": 5,
        "spacing": CASCADE_SPACING[1:],
        "normalization_schemes": ["CTNormalization"], "n_stages": 8,
        "features_per_stage": [32, 64, 128, 256, 512, 512, 512, 512],
        "kernel_sizes": [[3, 3]] * 8, "strides": [[1, 1]] + [[2, 2]] * 7},
    "3d_fullres": _CASCADE_FULLRES,
    "3d_lowres": {
        "patch_size": [32, 224, 224], "batch_size": 2,
        "spacing": [2.5, 1.1406087264733378, 1.1406087264733378],
        "normalization_schemes": ["CTNormalization"], "n_stages": 6,
        "features_per_stage": [32, 64, 128, 256, 320, 320],
        "kernel_sizes": [[1, 3, 3]] + [[3, 3, 3]] * 5,
        "strides": [[1, 1, 1], [1, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2],
                    [1, 2, 2]]},
    "3d_cascade_fullres": _CASCADE_FULLRES,
}


def cascade_topologies(plans: dict) -> dict:
    """:func:`plan_topology` of each configuration of ``plans`` (inherited
    keys resolved)."""
    from fast_nnunet_tpu_torch.core.plans import PlansManager
    pm = PlansManager(plans)
    return {c: plan_topology(pm.get_configuration(c).configuration)
            for c in plans["configurations"]}


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


def device_ms(totals: dict) -> dict:
    """A timer's CUDA-event phases (its totals without the host: and
    count: keys)."""
    return {k: v for k, v in totals.items() if ":" not in k}


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

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from fast_nnunet_tpu_torch.inference.engine import (PhaseTimer,
                                                        SlidingWindowEngine)
    from fast_nnunet_tpu_torch.inference.turbo import (TurboConfig,
                                                       TurboPipeline)
    from fast_nnunet_tpu_torch.models.s2d import (make_s2d_engine_net,
                                                  random_plain_params)
    from fast_nnunet_tpu_torch.ops import _build
    from fast_nnunet_tpu_torch.ops import finalize as kb
    from fast_nnunet_tpu_torch.ops import s2d_accumulate as kc
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
                                 "spatial_sum_sumsq", "norm_apply",
                                 "attention")):
            print(f"build: ptxas {fn}: {v.get('registers')} registers, "
                  f"{v.get('static_smem')} B static shared memory, "
                  f"{v.get('spill_stores')} B spill stores, "
                  f"{v.get('spill_loads')} B spill loads, "
                  f"{v.get('stack')} B stack")

    # ------------------------------------------------------------ main path
    make_pipe, tree, p2 = phase2_pipeline(torch, dev)
    net, cfg, K, arch = p2["net"], p2["cfg"], p2["K"], p2["arch"]
    engine, pipe = make_pipe("")
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

    kernels = phase2_kernels()
    for fn in kernels.values():
        fn.launches = 0
    engine.timer = PhaseTimer()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seg = pipe.predict_volume(tree, ct, spacing)
    wall = [time.perf_counter() - t0]
    launches = {name: fn.launches for name, fn in kernels.items()}
    phases = device_ms(engine.timer.totals())
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
    rows += attention_rows(torch)
    del cap
    torch.cuda.empty_cache()
    mark("build, s2d main path and its kernels (phases 1-3)")
    worker = start_phase19_worker()  # joined by phase 19

    # ------------------------------------------- the host route, folds
    tree2 = net.convert_params(random_plain_params(arch, 1, K, seed=1))
    host_route_path(torch, pipe, tree, tree2, ct, spacing, seg, wall, phases,
                    kernels)
    mark("host route, host revert and folds (phase 15)")

    del engine, pipe
    torch.cuda.empty_cache()

    # ------------------------------------------- plain full-res path, kernel D
    cap_d, launches_d = plain_main_path(torch, dev, engine_module, K, arch)
    rows.append(kernel_d_check(torch, cap_d, launches_d))
    del cap_d
    torch.cuda.empty_cache()
    plain_reference_sweep(torch, dev, K, arch)
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
    a_row = next(r for r in rows if r["name"] == "spatial_sum_sumsq")
    pipeline_path(torch, dev, a_row)
    mark("raw dataset workflow and ResEnc presets (phases 11-12)")

    # ------------------------------------------- package cache and trace
    built = aot_path(torch, dev, make_pipe, tree, ct, spacing, seg, launches,
                     wall, kernels, worker)
    del make_pipe, net, ct, seg
    torch.cuda.empty_cache()
    mark("package cache and trace attribution (phase 19 a-b)")

    # ------------------------------------------- 2d, lowres and the cascade
    cascade_path(torch, dev, a_row)
    mark("2d and 3d_lowres -> 3d_cascade_fullres (phase 13)")

    # ------------------------------------------- export and fast inference
    fast = fast_inference_path(torch, dev)
    mark("export and the fast-inference module (phase 14)")

    # ------------------------------------------- the native engine
    native_engine_path(torch, dev, worker, built, fast["walls_s"]["predict"])
    mark("the native artifact and the C++ engine (phase 19 c)")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase2_pipeline(torch, dev):
    """Phase 2's student and a factory of its pipeline: (make_pipe, tree,
    {"net", "cfg", "K", "arch"}); ``make_pipe(aot_cache)`` -> (engine,
    TurboPipeline) with the engine INI's settings on the shared network
    (``aot_cache`` "" is eager, a directory the package cache)."""
    from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
    from fast_nnunet_tpu_torch.inference.turbo import (TurboConfig,
                                                       TurboPipeline)
    from fast_nnunet_tpu_torch.models.s2d import (make_s2d_engine_net,
                                                  random_plain_params)
    from fast_nnunet_tpu_torch.models.students import \
        build_student_arch_kwargs
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

    def make_pipe(aot_cache=""):
        engine = SlidingWindowEngine(
            net, cfg.patch_size, K, tile_step_size=cfg.step_size,
            use_gaussian=cfg.use_gaussian, compute_dtype=torch.bfloat16,
            sweep_acc_dtype=torch.bfloat16, shape_bucket=32,
            tile_batch=inf.getint("tile_batch", 8), device=dev,
            aot_cache=aot_cache)
        return engine, TurboPipeline(
            engine, cfg, air_skip=inf.getboolean("skip_air_tiles", True),
            air_margin_hu=inf.getfloat("air_margin_hu", 200.0))
    return make_pipe, tree, {"net": net, "cfg": cfg, "K": K, "arch": arch}


def phase2_kernels():
    """The s2d path's kernel wrappers by name (their ``launches`` count)."""
    from fast_nnunet_tpu_torch.ops import finalize as kb
    from fast_nnunet_tpu_torch.ops import s2d_accumulate as kc
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.ops import norm_apply as ke
    return {"spatial_sum_sumsq": ka.spatial_sum_sumsq,
            "grouped_argmax": kb.grouped_argmax,
            "s2d_accumulate": kc.s2d_accumulate,
            "norm_apply": ke.norm_apply}


def capture_inputs(engine_module, net, run, c_call=8, b_call=4):
    """Run one main-path call with the sweep's kernel wrappers wrapped, and
    record real inputs: the c_call-th accumulate (the accumulator cloned
    before it), the b_call-th finalize (likewise), and the first stage-0
    conv output (the largest InstanceNorm input, without its bias, as the
    block's norm takes it) with that conv's bias. The wrappers are restored
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

    def grab(block, inputs, output):  # returns None: output unchanged
        if "a" not in cap:  # the block's conv again: E overwrote its output
            from torch.nn.functional import conv3d
            conv = block.conv
            cap["a"] = conv3d(
                inputs[0], conv.weight, None, conv.stride, conv.padding)
            cap["a_bias"] = conv.bias.float().clone()

    hook = net.encoder["stage_0"]["block_0"].register_forward_hook(grab)
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

    # ----------------------------- kernel E on the same stage-0 conv output
    rows.append({
        "name": "norm_apply", "route": "cuda",
        "source": "fast_nnunet_tpu_torch/csrc/norm_apply.cu",
        "replaces": None, "launches": launches["norm_apply"],
        "tolerance": "bit-exact",
        **kernel_e_at(torch, cap["a"], 8, conv_bias=cap["a_bias"])})

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


PRIMUS_ATTENTION = (2, 8000, 12, 72)   # Primus M at 160^3: B, T, H, hd


def attention_rows(torch, shape=PRIMUS_ATTENTION):
    """Kernels F and G (Primus's fused attention) at Primus M's 160^3 shape
    on inputs as the network gives them (unit-norm q times a temperature of
    10, unit-norm k, v read in place from a (B, T, 3, H, hd) qkv output),
    against their plain version (O and each gradient within 1.5e-2 of the
    plain tensor's largest, lse within 1e-4), timed with CUDA events (a
    call takes milliseconds: the launch is no part of it), beside the bf16
    bound of their useful FLOPs (4 B H T^2 hd for F, 10 for G), the plain
    version's time and ``scaled_dot_product_attention``'s (forward; its
    backward for G), which the port never calls."""
    from torch.nn.functional import normalize, scaled_dot_product_attention
    from fast_nnunet_tpu_torch.ops import attention as fa
    B, T, H, hd = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    q = (normalize(torch.randn(shape, device="cuda", generator=g), dim=-1)
         * 10).bfloat16()
    k = normalize(torch.randn(shape, device="cuda", generator=g),
                  dim=-1).bfloat16()
    v = torch.randn(B, T, 3, H, hd, device="cuda",
                    generator=g).bfloat16().unbind(2)[2]
    do = torch.randn(shape, device="cuda", generator=g).bfloat16()
    n0, m0 = fa.attention_forward.launches, fa.attention_backward.launches
    o, lse = fa.attention_forward(q, k, v)
    grads = fa.attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    launches = (fa.attention_forward.launches - n0,
                fa.attention_backward.launches - m0)
    op, lp = fa.attention_forward_plain(q, k, v, block=500)
    want = fa.attention_backward_plain(q, k, v, op, lp, do, block=500)
    errs = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
            for a, b in zip((o,) + tuple(grads), (op,) + tuple(want))]
    lse_err = float((lse - lp).abs().max())
    check(max(errs) <= 1.5e-2 and lse_err <= 1e-4 and launches == (1, 2),
          f"kernels F / G against plain: O, dq, dk, dv {errs}, lse "
          f"{lse_err}, launches {launches}")
    f_ms = time_ms(torch, lambda: fa.attention_forward(q, k, v))
    g_ms = time_ms(torch, lambda: fa.attention_backward(q, k, v, o, lse, do))
    plain_f = time_ms(torch, lambda: fa.attention_forward_plain(
        q, k, v, block=500), n=2, warmup=1)
    plain_g = time_ms(torch, lambda: fa.attention_backward_plain(
        q, k, v, op, lp, do, block=500), n=2, warmup=1)
    del op, lp, want
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))

    def sdpa():
        return scaled_dot_product_attention(qt, kt, vt, scale=1.0)
    lib_f = time_ms(torch, lambda: sdpa().detach())
    dot = do.transpose(1, 2)
    lib_fg = time_ms(torch, lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot))
    flops = 4 * B * H * T * T * hd
    rows = []
    for name, ms, plain, lib, work, n in (
            ("attention_fwd", f_ms, plain_f, lib_f, flops, launches[0]),
            ("attention_bwd", g_ms, plain_g, lib_fg - lib_f, 2.5 * flops,
             launches[1])):
        bms = work / BF16_TENSOR_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "fast_nnunet_tpu_torch/csrc/attention.cu",
            "replaces": None, "launches": n,
            "tolerance": "1.5e-2 of each plain tensor's largest, lse 1e-4",
            "max_rel_err": errs[0] if name == "attention_fwd" else
            max(errs[1:]), "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bms, "bound_by": "bf16 FLOPs",
            "bound_share": bms / ms, "ops": work,
            "shape": f"q, k, v {shape} bf16 (B, T, H, hd), v strided"})
        print(f"kernels: {name} {ms:.4f} ms ({100 * bms / ms:.1f}% of the "
              f"bf16 bound {bms:.4f} ms), plain {plain:.2f} ms, "
              f"scaled_dot_product_attention {lib:.4f} ms; launches {n}; "
              f"errors O, dq, dk, dv {errs}, lse {lse_err:.2e}")
    del q, k, v, do, o, lse, grads, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def kernel_e_at(torch, x, groups, slope=0.01, conv_bias=None):
    """Kernel E on x (an s2d conv output, without its bias ``conv_bias``,
    which E folds in) with its norm's moments from kernel A (shifted by the
    bias as the s2d norm shifts them), seeded scale and bias and the
    LeakyReLU, timed as kernel A is (``ms`` from Python, ``device_ms`` from
    a CUDA graph, over copies beyond the L2, out of place) and held against
    its plain version bit for bit. The plain version is the torch sequence
    the s2d forward ran before the kernel, so it is the ``library_ms`` too.
    Bytes: 2 B in and 2 B out per bf16 element, the bias or not."""
    import itertools
    from fast_nnunet_tpu_torch.models.s2d import norm_moments
    from fast_nnunet_tpu_torch.ops import norm_apply as ke
    B, C8 = x.shape[0], x.shape[1]
    c = C8 // groups
    mean, var = norm_moments(x, groups, 0, conv_bias)
    rstd = torch.rsqrt(var + 1e-5)
    g = torch.Generator().manual_seed(0)
    scale = (torch.rand(c, generator=g) + 0.5).to(x.device)
    bias = (torch.randn(c, generator=g) * 0.3).to(x.device)
    xs = l2_cold_copies(torch, x)
    out = torch.empty_like(x)
    cyc = itertools.cycle(xs)

    def run():
        return ke.norm_apply(next(cyc), mean, rstd, scale, bias, groups,
                             slope, out=out, conv_bias=conv_bias)

    ms = time_ms(torch, run, n=20)
    device_ms = time_graph_ms(torch, run)
    del xs, cyc, out
    torch.cuda.empty_cache()
    got = ke.norm_apply(x, mean, rstd, scale, bias, groups, slope,
                        conv_bias=conv_bias)
    want = ke.norm_apply_plain(x, mean, rstd, scale, bias, groups, slope,
                               conv_bias=conv_bias)
    same = torch.equal(got, want)
    err = float((got.float() - want.float()).abs().max())
    del got
    check(same, f"kernel E at {tuple(x.shape)} differs from its plain "
          f"version (max abs err {err})")
    plain = time_ms(torch, lambda: ke.norm_apply_plain(
        x, mean, rstd, scale, bias, groups, slope, conv_bias=conv_bias),
        n=5, warmup=1)
    nbytes = 2 * x.numel() * x.element_size()
    ops = (5 if conv_bias is None else 6) * x.numel()
    bms, bby = bound(nbytes, ops)
    plan = ke.launch_plan(B * C8, x[0, 0].numel(), x.element_size(),
                          x.data_ptr() % 16 == 0)
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain, "library_ms": plain, "bound_ms": bms,
            "bound_by": bby, "bound_share": bms / ms,
            "device_bound_share": bms / device_ms, "bytes": nbytes,
            "ops": ops,
            "shape": f"x {tuple(x.shape)} {str(x.dtype).split('.')[-1]}, "
                     f"groups {groups}, LeakyReLU {slope}, conv bias "
                     f"{conv_bias is not None}",
            "plan": dict(plan)}


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
    phases = device_ms(engine.timer.totals())
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


def plain_reference_sweep(torch, dev, K, arch, size=512,
                          patch=(96, 96, 160), small=(200, 128, 192)):
    """Phase 4's contract without kernel D, the plain engine's default
    route: ``predict_segmentation`` on the reference grid with torch's
    per-tile accumulate, one timed, phased run at size^3 in bf16. Then, at
    ``small`` in fp32 with TF32 off, ``predict_segmentation_sweep`` against
    every tile of ``compute_steps_for_sliding_window``'s grid run alone and
    accumulated with the gaussian into a whole-volume buffer (agreement
    >= 0.999): what the rolling sweep's accumulate, rolls or finalize get
    wrong shows there."""
    import numpy as np
    from fast_nnunet_tpu_torch.inference.engine import (PhaseTimer,
                                                        SlidingWindowEngine)
    from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
    from fast_nnunet_tpu_torch.models.s2d import random_plain_params
    from fast_nnunet_tpu_torch.ops.sliding_window import (
        compute_gaussian, compute_steps_for_sliding_window)

    tree = random_plain_params(arch, 1, K, seed=0)

    def engine(dtype):
        net = get_network_from_plans("PlainConvUNet", arch, (), 1, K,
                                     compute_dtype=dtype).to(dev)
        return SlidingWindowEngine(
            net, patch, K, tile_step_size=0.5, use_gaussian=True,
            compute_dtype=dtype, sweep_acc_dtype=dtype, shape_bucket=32,
            tile_batch=8, max_accumulator_bytes=4 * 1024 ** 3, device=dev)

    eng = engine(torch.bfloat16)
    vol = (np.random.RandomState(0).rand(1, size, size, size).astype(
        np.float32) - 0.5) * 2
    check(not eng._sweep_grid(vol.shape[1:])[4],
          "the default plain route took kernel D's grid")
    eng.timer = PhaseTimer()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seg = eng.predict_segmentation(tree, vol)
    wall = time.perf_counter() - t0
    phases = device_ms(eng.timer.totals())
    print(f"plain: reference-grid sweep (no kernel D) {wall:.4f} s per "
          f"volume (one run, includes its first call's allocations); peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; phase ms "
          + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    labels = sorted(int(v) for v in set(seg[::4, ::4, ::4].ravel().tolist()))
    check(seg.shape == (size,) * 3 and str(seg.dtype) == "uint8"
          and max(labels) < K and len(labels) > 1,
          f"reference-grid mask {seg.shape} {seg.dtype}, labels {labels}")
    del eng, vol, seg
    torch.cuda.empty_cache()

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        eng = engine(torch.float32)
        vol = (np.random.RandomState(1).rand(1, *small).astype(np.float32)
               - 0.5) * 2
        seg = eng.predict_segmentation_sweep(tree, vol)
        starts = compute_steps_for_sliding_window(small, patch, 0.5)
        rolls = sorted(set(np.diff(starts[0]).tolist()))
        g = torch.as_tensor(compute_gaussian(patch), dtype=torch.float32,
                            device=dev)
        acc = torch.zeros((K, *small), dtype=torch.float32, device=dev)
        w = torch.zeros(small, dtype=torch.float32, device=dev)
        x = torch.as_tensor(vol, device=dev)
        net = eng.load_params(tree)[0]
        with torch.no_grad():
            for x0 in starts[0]:
                for y0 in starts[1]:
                    for z0 in starts[2]:
                        sl = (slice(x0, x0 + patch[0]),
                              slice(y0, y0 + patch[1]),
                              slice(z0, z0 + patch[2]))
                        out = net(x[(slice(None),) + sl][None]).float()[0]
                        acc[(slice(None),) + sl] += out * g
                        w[sl] += g
        ref = (acc / w).argmax(0).to(torch.uint8).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    agree = float((seg == ref).mean())
    n_lab = len(set(ref[::4, ::4, ::4].ravel().tolist()))
    print(f"plain: fp32 reference-grid sweep at {small} (x rolls {rolls}) "
          f"vs a tile-by-tile accumulation: agreement {agree:.6f}, {n_lab} "
          f"labels on a 1/64 sample")
    check(len(rolls) == 2, f"x rolls {rolls} are not uneven")
    check(agree >= 0.999, f"reference-grid sweep agrees only {agree} with "
          f"the tile-by-tile accumulation")
    check(n_lab > 1, "the reference-grid check produced a single label")


def host_route_path(torch, pipe, tree, tree2, ct, spacing, seg_dev,
                    walls_dev, phases_dev, kernels, runs=3):
    """Phase 15's serving routes on phase 2's student and CT (``pipe`` is
    phase 2's device-route pipeline, ``tree`` its weights and ``tree2`` a
    second fold's, ``seg_dev``, ``walls_dev`` and ``phases_dev`` its
    counted run's mask, its seconds per CT and its CUDA event phases,
    ``kernels`` the wrappers whose launches are counted)."""
    import numpy as np
    from fast_nnunet_tpu_torch.inference.engine import PhaseTimer
    from fast_nnunet_tpu_torch.inference.turbo import (TurboPipeline,
                                                       resize_nearest)
    from fast_nnunet_tpu_torch.ops import _build
    from fast_nnunet_tpu_torch.utils import hostops

    engine, cfg = pipe.engine, pipe.config
    t0 = time.perf_counter()
    _build.host_library()
    print(f"host: host library built and loaded in "
          f"{time.perf_counter() - t0:.3f} s ({_build.host_compiler()} "
          f"{' '.join(_build.HOST_FLAGS)})")

    def pipeline(**kw):
        return TurboPipeline(engine, cfg, air_skip=pipe.air_skip,
                             air_margin_hu=200.0, **kw)

    def timed(p, params, label):
        """A warm run, then ``runs`` timed runs, the first counted and
        phased. Returns (mask of the counted run, seconds, phases ms,
        launches, peak GiB)."""
        p.predict_volume(params, ct, spacing)
        for fn in kernels.values():
            fn.launches = 0
        engine.timer = PhaseTimer()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mask = p.predict_volume(params, ct, spacing)
        walls = [time.perf_counter() - t0]
        launches = {name: fn.launches for name, fn in kernels.items()}
        totals = engine.timer.totals()
        phases = device_ms(totals)
        host_s = {k: totals["host:host_" + k] / 1e3
                  for k in ("preprocess", "air", "revert")
                  if "host:host_" + k in totals}
        engine.timer = None
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for _ in range(runs - 1):
            t0 = time.perf_counter()
            p.predict_volume(params, ct, spacing)
            walls.append(time.perf_counter() - t0)
        print(f"host: {label}: route {p.route}, seconds per CT "
              f"{[round(w, 4) for w in walls]} (best {min(walls):.4f}; "
              f"phase 2's device route {[round(w, 4) for w in walls_dev]}, "
              f"best {min(walls_dev):.4f}); launches per CT "
              f"{json.dumps(launches)}; peak {peak:.2f} GiB")
        print(f"host: {label}: phase ms (CUDA events, counted run) "
              + json.dumps({k: round(v, 3) for k, v in phases.items()})
              + "; host s " + json.dumps({k: round(v, 4)
                                          for k, v in host_s.items()}))
        check(mask.shape == ct.shape and str(mask.dtype) == "uint8",
              f"{label}: mask {mask.shape} {mask.dtype}")
        return mask, walls, phases, launches, peak

    # ---- the host route: lazy, streamed, host revert
    host = pipeline(host_preprocess=True, host_revert=True)
    mask, _, _, launches, _ = timed(host, tree, "host route")
    check(host.route == "streamed", f"host route took {host.route}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the host route")
    agree = float((mask == seg_dev).mean())
    print(f"host: host route vs phase 2's device-route mask: agreement "
          f"{agree:.6f}")
    # JAX's own two routes agree no better at this compute: 0.988597 and
    # 0.995677 (seeds 0 and 1) on a 4-stage cut of this student in bf16 on
    # a 192 x 192 x 160 CT on the CPU (tools/route_agreement.py); its
    # > 0.995 pin is an f32 setting, which the port clears
    # (tests/test_torch_turbo_host.py)
    check(agree >= 0.99, f"host and device routes agree only {agree}")

    # ---- the preprocessed grid: host C++ against the device route
    in_shape, new_shape = pipe._geometry(ct[None], spacing)
    with torch.no_grad():
        vol, _, _, _ = pipe.preprocess(ct[None], spacing)
        dev_grid = vol[0][tuple(slice(0, n) for n in new_shape)].float()
        del vol
        inv = cfg.transpose_backward
        bits = hostops.preprocess_ct_i16(
            ct[None], tuple(new_shape[inv[p]] for p in range(3)),
            *pipe._ct_scalars())
        host_grid = torch.from_numpy(bits.view(np.int16)).to(
            dev_grid.device).view(torch.bfloat16)[0].permute(
            *cfg.transpose_forward).float()
        diff = (host_grid - dev_grid).abs()
        mag = torch.maximum(torch.maximum(host_grid.abs(), dev_grid.abs()),
                            torch.ones_like(diff))
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        n_diff = int((diff > 0).sum())
        worst = float((diff / ulp).max())
        del host_grid, dev_grid, diff, mag, ulp
    print(f"host: preprocessed grid {tuple(new_shape)} host C++ vs the "
          f"device route: {n_diff} voxels differ "
          f"({n_diff / math.prod(new_shape):.6f}), max {worst:.3f} bf16 ulp "
          f"(ulps floored at magnitude 1)")
    check(worst <= 1.0, f"host and device grids differ by {worst} ulp")

    # ---- streamed against fused host route, air skipping off
    masks = {}
    for stream in ("1", "0"):
        os.environ["FNN_TURBO_STREAM"] = stream
        try:
            p = TurboPipeline(engine, cfg, air_skip=False,
                              host_preprocess=True)
            t0 = time.perf_counter()
            masks[stream] = p.predict_volume(tree, ct, spacing)
            print(f"host: air skip off, route {p.route}: "
                  f"{time.perf_counter() - t0:.4f} s")
        finally:
            del os.environ["FNN_TURBO_STREAM"]
    n_diff = int((masks["1"] != masks["0"]).sum())
    agree = 1.0 - n_diff / masks["1"].size
    print(f"host: streamed vs fused host route (air skip off): {n_diff} "
          f"voxels differ, agreement {agree:.6f}")
    check(agree >= 0.999, f"streamed and fused host routes agree {agree}")
    del masks

    # ---- the device route with the host revert
    hrev = pipeline(host_revert=True)
    _, _, ph, _, _ = timed(hrev, tree, "device route + host revert")
    print(f"host: packed mask d2h {ph.get('d2h', 0.0):.3f} ms vs phase 2's "
          f"uint8 mask d2h {phases_dev.get('d2h', 0.0):.3f} ms")
    with torch.no_grad():
        vol, new_shape, in_shape, valid = pipe.preprocess(ct[None], spacing)
        s = engine.run_s2d_sweep(vol, new_shape, valid)[
            tuple(slice(0, n) for n in new_shape)]
        del vol
        on_card = resize_nearest(s, in_shape).cpu().numpy()
        on_host = hostops.nearest_revert_u8(s.cpu().numpy(), in_shape)
    same = bool(np.array_equal(on_card, on_host))
    print(f"host: revert of one {tuple(new_shape)} mask to {tuple(in_shape)}"
          f": card (resize_nearest) == host (nearest_revert_u8): {same}")
    check(same, "the card's and the host's reverts differ")

    # ---- two seeded folds on the device route
    folds = pipeline()
    _, _, _, launches, _ = timed(folds, [tree, tree2], "two folds")
    check(launches["grouped_argmax"] > 0 and launches["spatial_sum_sumsq"] > 0
          and launches["s2d_accumulate"] == 0,
          f"two folds launched {launches}")
    twice = folds.predict_volume([tree, tree], ct, spacing)
    agree = float((twice == seg_dev).mean())
    print(f"host: [tree, tree] vs tree (phase 2's mask): agreement "
          f"{agree:.6f}")
    check(agree >= 0.999, f"[tree, tree] agrees with tree only {agree}")
    engine.load_params(tree)


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
                         n_classes=TRAIN_K, seed=0, file_ending=".nii.gz"):
    """A raw nnU-Net dataset of int16 CTs written as ``file_ending``
    (``.nii.gz`` or ``.mha``) through the port's writers: ``n_train`` cases in imagesTr/labelsTr and one
    more in imagesTs/labelsTs, dataset.json with a CT channel. Air is
    -1024 HU (no voxel is 0, so crop_to_nonzero keeps the whole volume), a
    soft-tissue ellipsoid 20-60 HU, and one bone cuboid per foreground class
    (300 + 10 c HU), each in its own cell of a grid, so every class is in
    every case."""
    import math
    import numpy as np
    from fast_nnunet_tpu_torch.imageio.mha import MhaIO, write_mha
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
        rw = MhaIO if file_ending == ".mha" else NiftiIO
        image = os.path.join(folder, "images" + split,
                             f"{case}_0000{file_ending}")
        if file_ending == ".mha":
            write_mha(image, img.transpose(2, 1, 0), list(spacing)[::-1])
        else:
            write_nifti(image, img.transpose(2, 1, 0),
                        spacing=list(spacing)[::-1])
        rw().write_seg(seg, os.path.join(folder, "labels" + split,
                                         case + file_ending),
                       {"spacing": list(spacing)})
    generate_dataset_json(
        folder, {0: "CT"},
        {"background": 0, **{f"bone_{c}": c for c in range(1, n_classes)}},
        n_train, file_ending, dataset_name=dataset)
    return folder


def write_dicom_series(folder, vol, spacing, explicit=True, slope=1.0,
                       intercept=0.0, order=None):
    """An uncompressed DICOM series of an int16 (Z, Y, X) volume, one file
    per slice: a 128-byte preamble, ``DICM``, the meta group with the
    transfer syntax (explicit or implicit VR little endian), then slice
    thickness, instance number, ImagePositionPatient (z * dz),
    ImageOrientationPatient (identity), rows, columns, PixelSpacing
    (dy, dx), 16 signed bits, RescaleIntercept / RescaleSlope and the
    pixels. ``order`` permutes the files' names (a scanner's arbitrary
    file order)."""
    import struct
    import numpy as np

    def el(group, elem, vr, value):
        if len(value) % 2:
            value += b"\x00"
        if not explicit and group != 0x0002:
            return struct.pack("<HHI", group, elem, len(value)) + value
        if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
            return struct.pack("<HH2sHI", group, elem, vr, 0,
                               len(value)) + value
        return struct.pack("<HH2sH", group, elem, vr, len(value)) + value

    def ds(*xs):
        return "\\".join(repr(float(x)) for x in xs).encode()

    os.makedirs(folder, exist_ok=True)
    ts = b"1.2.840.10008.1.2.1" if explicit else b"1.2.840.10008.1.2"
    dz, dy, dx = (float(s) for s in spacing)
    rows, cols = vol.shape[1:]
    order = list(range(vol.shape[0])) if order is None else list(order)
    for i, z in enumerate(order):
        body = (el(0x0018, 0x0050, b"DS", ds(dz))
                + el(0x0020, 0x0013, b"IS", str(z + 1).encode())
                + el(0x0020, 0x0032, b"DS", ds(0.0, 0.0, z * dz))
                + el(0x0020, 0x0037, b"DS", ds(1, 0, 0, 0, 1, 0))
                + el(0x0028, 0x0002, b"US", struct.pack("<H", 1))
                + el(0x0028, 0x0010, b"US", struct.pack("<H", rows))
                + el(0x0028, 0x0011, b"US", struct.pack("<H", cols))
                + el(0x0028, 0x0030, b"DS", ds(dy, dx))
                + el(0x0028, 0x0100, b"US", struct.pack("<H", 16))
                + el(0x0028, 0x0103, b"US", struct.pack("<H", 1))
                + el(0x0028, 0x1052, b"DS", ds(intercept))
                + el(0x0028, 0x1053, b"DS", ds(slope))
                + el(0x7FE0, 0x0010, b"OW",
                     np.ascontiguousarray(vol[z], "<i2").tobytes()))
        with open(os.path.join(folder, f"slice_{i:04d}.dcm"), "wb") as f:
            f.write(b"\x00" * 128 + b"DICM")
            f.write(el(0x0002, 0x0010, b"UI", ts))
            f.write(body)


def reference_key(path):
    """The reference nnU-Net (dynamic-network-architectures) state_dict key
    of a JAX-package tree path under ``params``: the inverse of the port's
    ``utils/torch_import.translate_torch_key``."""
    import re
    p = path[1:]
    leaf = "bias" if p[-1] == "bias" else "weight"
    if p[1].startswith("transpconv_"):
        return f"decoder.transpconvs.{p[1][len('transpconv_'):]}.{leaf}"
    if p[1].startswith("seg_head_"):
        return f"decoder.seg_layers.{p[1][len('seg_head_'):]}.{leaf}"
    if p[1] == "stem":
        return f"encoder.stem.convs.0.{p[2]}.{leaf}"
    m = re.match(r"stage_(\d+)_block_(\d+)$", p[1])
    if m:
        blk = f"encoder.stages.{m.group(1)}.blocks.{m.group(2)}"
        if p[2] in ("skip_conv", "skip_norm"):
            return f"{blk}.skip.{0 if p[2] == 'skip_conv' else 1}.{leaf}"
        return f"{blk}.conv{p[2][-1]}.{p[2][:-1]}.{leaf}"
    return (f"{p[0]}.stages.{p[1][len('stage_'):]}.convs."
            f"{p[2][len('block_'):]}.{p[3]}.{leaf}")


def reference_state_dict(torch, net, seed):
    """A seeded state_dict of ``net``'s topology under the reference's key
    names and torch layouts (conv (O, I, *k), transposed conv (I, O, *k)),
    as a reference nnU-Net checkpoint's ``network_weights`` holds it:
    kernels with He-normal scale, norm scales near 1, small biases."""
    import math
    from fast_nnunet_tpu_torch.models.unet import jax_param_paths
    gen = torch.Generator().manual_seed(int(seed))
    sd = {}
    for path, prm, kind in jax_param_paths(net):
        if path[0] != "params":
            continue
        shape = tuple(prm.shape)
        if path[-1] == "kernel":
            cin = shape[0] if kind == "transpconv" else shape[1]
            std = math.sqrt(2.0 / (cin * math.prod(shape[2:])))
            v = torch.randn(shape, generator=gen) * std
        elif path[-1] == "scale":
            v = 1.0 + 0.1 * torch.randn(shape, generator=gen)
        else:
            v = 0.1 * torch.randn(shape, generator=gen)
        sd[reference_key(path)] = v
    return sd


def conv_flops(torch, net, x):
    """(forward FLOPs, FLOPs of the convolutions inside checkpointed stacks)
    of one forward of ``net`` on ``x``: 2 k^d Cin Cout per output voxel of a
    2D or 3D convolution, per input voxel of a transposed convolution."""
    from torch import nn
    from fast_nnunet_tpu_torch.models.unet import remat_modules
    convs = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)
    remat_convs = {id(m) for st in remat_modules(net)
                   for m in st.modules() if isinstance(m, convs)}
    tot = {"all": 0, "remat": 0}

    def hook(mod, inp, out):
        if isinstance(mod, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
            f = 2 * mod.weight.numel() * inp[0].numel() // inp[0].shape[1]
        else:
            f = 2 * mod.weight.numel() * out.numel() // out.shape[1]
        tot["all"] += f
        if id(mod) in remat_convs:
            tot["remat"] += f

    hs = [m.register_forward_hook(hook) for m in net.modules()
          if isinstance(m, convs)]
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
    last; ``cap["peak_bytes"]`` is the peak device memory then and
    ``cap["outs"]`` what each step returned. Returns the original method."""
    import torch
    from fast_nnunet_tpu_torch.ops import stats as ka
    orig = cls.run_train_iterations

    def timed(self, epoch):
        step = getattr(self, attr)
        stamps, launches, outs = [], [], []

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
            outs.append(out)
            return out

        setattr(self, attr, stamped)
        try:
            orig(self, epoch)
        finally:
            setattr(self, attr, step)
            self.timer = step.timer = None
        stamps.append(time.perf_counter())
        cap.update(trainer=self, stamps=stamps, step_launches=launches,
                   outs=outs, peak_bytes=torch.cuda.max_memory_allocated())

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
    phases = {k: v / (iters - warm)
              for k, v in device_ms(timer.totals()).items()}
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
    through the port's entry points, in process (docstring step 11); then
    phases 12, 16, 17 and 18 in the same temporary root."""
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
        fed_npy = _pipeline(torch, dev, a_row, root, iters, warm)
        share_path(torch, env["nnUNet_results"])
        resenc_path(torch, dev, a_row)
        formats_path(torch, dev, a_row, fed_npy)
        primus_path(torch, dev)
        multi_path(torch, dev, a_row)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _pipeline(torch, dev, a_row, root, iters, warm):
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
    # the second prediction exports no probabilities (cut for time), so the
    # ensemble takes the TTA folder twice
    outs = []
    for tta in ([], ["--disable_tta"]):
        out = join(os.environ["nnUNet_results"], f"imagesTs_pred{len(tta)}")
        t0 = time.perf_counter()
        predict_entry_point(["-i", join(raw, "imagesTs"), "-o", out, "-d",
                             ds, "-c", "3d_fullres", "-f", "0"] +
                            (tta or ["--save_probabilities"]))
        host["predict_tta_s" if not tta else "predict_s"] = \
            time.perf_counter() - t0
        outs.append(out)
    case = f"case_{n:03d}"
    mask = NiftiIO().read_seg(join(outs[1], case + ".nii.gz"))[0][0]
    check(mask.shape == TRAIN_CASE, f"--disable_tta mask {mask.shape}")
    ens = join(os.environ["nnUNet_results"], "imagesTs_ensemble")
    t0 = time.perf_counter()
    ensemble_entry(["-i", outs[0], outs[0], "-o", ens])
    host["ensemble_s"] = time.perf_counter() - t0
    probs = np.load(join(outs[0], case + ".npz"))["probabilities"].astype(
        np.float32)
    expected = ((probs + probs) / 2).argmax(0)
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
          f"mirror TTA and probabilities, {host['predict_s']:.3f} s without "
          f"either; ensemble of the TTA folder twice "
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
    return fed


# ------------------------------------------------------------------ primus
PRIMUS_TRAINER = "nnUNet_Primus_M_Trainer"
PRIMUS_M = {"embed_dim": 864, "depth": 16, "num_heads": 12}
#: Primus M's plan: 3d_fullres at a 160^3 patch (20^3 = 8,000 tokens)
PRIMUS_CONFIG = "3d_fullres_primus"
PRIMUS_PATCH = (160, 160, 160)


def primus_flops(net, batch):
    """FLOPs of one forward of a ``Primus`` on ``batch`` patches, from its
    shapes: the patch embedding, per block the qkv, proj and SwiGLU
    linears and the QK^T and AV products, the transposed convs and the seg
    head (2 per multiply-add)."""
    T, E = math.prod(net.grid), net.embed_dim
    hidden = net.blocks[0].mlp.w1.out_features
    block = 2 * T * E * (3 * E + E + 3 * hidden) + 2 * 2 * T * T * E
    f = 2 * T * net.patch_embed.weight.numel() + net.depth * block
    vox = T
    for up in net.ups:
        cin, cout = up.weight.shape[:2]
        f += 2 * vox * cin * up.weight[0, 0].numel() * cout
        vox *= up.weight[0, 0].numel()
    f += 2 * vox * net.seg_head.weight.numel()
    return batch * f


def primus_path(torch, dev, iters=10, warm=3):
    """Phase 17 (``primus:``): the Primus M trainer on phase 11's dataset
    at full width, its NaN watchdog, prediction through a rebuilt Primus,
    and a small Primus cuda vs cpu (docstring step 17)."""
    t_phase = time.perf_counter()
    try:
        out = _primus(torch, dev, iters, warm)
    finally:
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"primus: phase wall {out['wall_s']:.3f} s")
    print(json.dumps({"primus": out}))


def _primus(torch, dev, iters, warm):
    import numpy as np
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.inference import predictor
    from fast_nnunet_tpu_torch.inference.engine import PhaseTimer
    from fast_nnunet_tpu_torch.models.primus import Primus
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.run.predict import predict_entry_point
    from fast_nnunet_tpu_torch.run.run_training import run_training_entry
    from fast_nnunet_tpu_torch.training.optimizers import nnunet_adamw
    from fast_nnunet_tpu_torch.training.schedules import linear_warmup_poly
    from fast_nnunet_tpu_torch.training.train_step import make_train_step
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer
    from fast_nnunet_tpu_torch.utils.io import join

    from fast_nnunet_tpu_torch.ops import attention as fa
    from fast_nnunet_tpu_torch.utils.io import load_json, save_json

    ds, n = PIPELINE_DS, PIPELINE_N_TRAIN
    out = {}
    # ---- the plan's 160^3 configuration, inheriting 3d_fullres
    plans_file = join(os.environ["nnUNet_preprocessed"], ds,
                      "nnUNetPlans.json")
    plans = load_json(plans_file)
    plans["configurations"][PRIMUS_CONFIG] = {
        "inherits_from": "3d_fullres", "patch_size": list(PRIMUS_PATCH)}
    save_json(plans, plans_file)
    # ---- fast_nnunet_train_torch 988 3d_fullres_primus 0 -tr ...Primus_M...
    os.environ.update(FNNT_ITERS_PER_EPOCH=str(iters),
                      FNNT_VAL_ITERS_PER_EPOCH="2", FNNT_NUM_EPOCHS="1")
    cap = {}
    timer = PhaseTimer()
    orig = stamp_iterations(NNUNetTrainer, "train_step", cap, warm, timer)
    torch.cuda.reset_peak_memory_stats()
    ka.spatial_sum_sumsq.launches = 0
    f0, g0 = fa.attention_forward.launches, fa.attention_backward.launches
    t0 = time.perf_counter()
    try:
        run_training_entry([str(PIPELINE_DS_ID), PRIMUS_CONFIG, "0", "-tr",
                            PRIMUS_TRAINER])
    finally:
        NNUNetTrainer.run_train_iterations = orig
    train_wall = time.perf_counter() - t0
    run_launches = ka.spatial_sum_sumsq.launches
    f_run = fa.attention_forward.launches - f0
    g_run = fa.attention_backward.launches - g0
    trainer = cap["trainer"]
    net = trainer.network
    cm = trainer.configuration_manager
    st = cap["stamps"]
    fed = (st[-1] - st[warm]) / (iters - warm)
    phases = {k: v / (iters - warm)
              for k, v in device_ms(timer.totals()).items()}
    tl = trainer.logger.logging
    check(isinstance(net, Primus), f"the trainer built a {type(net)}")
    dims = {"embed_dim": net.embed_dim, "depth": net.depth,
            "num_heads": net.num_heads}
    check(dims == PRIMUS_M and net.patch_embed_size == (8, 8, 8)
          and net.patch_size == PRIMUS_PATCH
          and cm.batch_size == 2 and net.num_classes == TRAIN_K,
          f"Primus M at {dims}, tokens {net.patch_embed_size}, patch "
          f"{net.patch_size}, batch {cm.batch_size}, {net.num_classes} "
          "classes")
    n_params = sum(p.numel() for p in net.parameters())
    print(f"primus: {PRIMUS_TRAINER}: embed {net.embed_dim}, depth "
          f"{net.depth}, {net.num_heads} heads, tokens "
          f"{net.patch_embed_size} -> grid {net.grid} "
          f"({math.prod(net.grid)} tokens), patch {list(net.patch_size)}, "
          f"batch {cm.batch_size}, {TRAIN_K} classes, {n_params} "
          f"parameters, bf16 compute / f32 parameters; "
          f"fast_nnunet_train_torch ({iters} iterations, 2 validation "
          f"iterations, final validation) {train_wall:.3f} s; fed seconds "
          f"per iteration {fed:.4f} (iterations {warm}-{iters - 1}); peak "
          f"device memory {cap['peak_bytes'] / 2**30:.2f} GiB over the "
          f"training iterations")
    print("primus: phase ms per fed iteration (CUDA events) " + json.dumps(
        {k: round(v, 3) for k, v in phases.items()}))
    print(f"primus: kernel A launches per train step {cap['step_launches']} "
          f"(Primus has no InstanceNorm); {run_launches} in the whole run; "
          f"epoch train loss {tl['train_losses'][0]:.4f}, val loss "
          f"{tl['val_losses'][0]:.4f}")
    check(all(k == 0 for k in cap["step_launches"]) and run_launches == 0,
          f"Primus launched kernel A: {cap['step_launches']}")
    # every train step's 16 blocks run F forward and G's two passes
    # backward; validation and the final validation add F alone
    print(f"primus: kernel F launches {f_run}, kernel G launches {g_run} "
          f"over the run ({iters} train steps: G {2 * net.depth * iters})")
    check(g_run == 2 * net.depth * iters and f_run >= net.depth * iters,
          f"fused attention launches F {f_run}, G {g_run}")
    check(np.isfinite(tl["train_losses"][0]) and
          np.isfinite(tl["val_losses"][0]),
          f"non-finite losses {tl['train_losses']} {tl['val_losses']}")
    out.update(train_wall_s=train_wall, fed_s_per_iter=fed,
               phases_ms=phases, peak_gib_train=cap["peak_bytes"] / 2**30,
               kernel_a_launches_per_step=cap["step_launches"],
               attention_launches={"F": f_run, "G": g_run},
               parameters=n_params, tokens=math.prod(net.grid))

    # ---- cached: one device batch through the NaN-guarded step, lr 3e-4
    batch = trainer.dataloader_train.sampler.generate_batch(
        np.random.RandomState(0))
    data, targets = trainer.batch_to_device(batch)
    opt = nnunet_adamw(net.parameters(),
                       linear_warmup_poly(trainer.initial_lr, 1000, 1),
                       weight_decay=trainer.weight_decay, b1=0.9, b2=0.98,
                       grad_clip=1.0)
    step = make_train_step(net, opt, skip_nonfinite=True,
                           **trainer._step_kwargs())
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(10):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(data, targets))
    torch.cuda.synchronize()
    cached = (time.perf_counter() - t0) / (10 - warm)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"non-finite cached losses {losses}")
    check(losses[-1] < losses[0], f"cached-batch loss did not fall: {losses}")
    flops = 3 * primus_flops(net, cm.batch_size)
    mfu = flops / cached / BF16_TENSOR_OPS_PER_S
    mfu_fed = flops / fed / BF16_TENSOR_OPS_PER_S
    print(f"primus: warm seconds per iteration fed {fed:.4f}, cached "
          f"{cached:.4f} (one device batch, {10 - warm} steps); peak device "
          f"memory {peak / 2**30:.2f} GiB cached (the fused attention keeps "
          f"no ({cm.batch_size}, {net.num_heads}, {math.prod(net.grid)}, "
          f"{math.prod(net.grid)}) tensor)")
    print(f"primus: FLOPs per step {flops:.4e} (3 x forward: linears, "
          f"QK^T, AV, patch embedding, transposed convs, seg head); mfu "
          f"{mfu:.4f} cached, {mfu_fed:.4f} fed (of 989 TFLOP/s dense bf16)")
    print(f"primus: cached-batch losses {[round(v, 4) for v in losses]}")

    # ---- the NaN watchdog on the card: nothing moves
    def state():
        sd = opt.inner.state
        return ([p.detach().clone() for p in net.parameters()],
                [sd[p][k].clone() for p in net.parameters()
                 for k in ("exp_avg", "exp_avg_sq", "step")], opt.count)
    before = state()
    nan_loss = step(torch.full_like(data, float("nan")), targets)
    after = state()
    same = all(torch.equal(a, b) for a, b in zip(before[0] + before[1],
                                                 after[0] + after[1]))
    print(f"primus: NaN batch: loss {float(nan_loss)}, step skipped "
          f"{step.skipped} time(s); parameters, AdamW moments and steps "
          f"bit-equal before and after: {same}; schedule count "
          f"{before[2]} -> {after[2]}")
    check(not np.isfinite(float(nan_loss)) and step.skipped == 1 and same
          and before[2] == after[2], "the NaN watchdog let the step through")
    out.update(cached_s_per_iter=cached, peak_gib_cached=peak / 2**30,
               flops_per_step=flops, mfu=mfu, mfu_fed=mfu_fed,
               cached_losses=losses, nan_step_skipped=same)
    del opt, step, data, targets, before, after
    trainer.network = None
    del trainer, net
    cap.clear()
    torch.cuda.empty_cache()

    # ---- fast_nnunet_predict_torch -tr nnUNet_Primus_M_Trainer
    raw = join(os.environ["nnUNet_raw"], ds)
    o = join(os.environ["nnUNet_results"], "imagesTs_primus")
    held = []
    real_init = predictor.NNUNetPredictor.manual_initialization

    def init_and_look(self, network, *a, **kw):
        held.append(type(network).__name__)
        return real_init(self, network, *a, **kw)

    predictor.NNUNetPredictor.manual_initialization = init_and_look
    t0 = time.perf_counter()
    try:
        predict_entry_point(["-i", join(raw, "imagesTs"), "-o", o, "-d", ds,
                             "-c", PRIMUS_CONFIG, "-f", "0", "-tr",
                             PRIMUS_TRAINER])
    finally:
        predictor.NNUNetPredictor.manual_initialization = real_init
    predict_s = time.perf_counter() - t0
    case = f"case_{n:03d}"
    seg = NiftiIO().read_seg(join(o, case + ".nii.gz"))[0][0]
    labels = np.unique(seg)
    print(f"primus: fast_nnunet_predict_torch -tr {PRIMUS_TRAINER} (mirror "
          f"TTA) {predict_s:.3f} s on the host clock: the predictor held a "
          f"{held}; mask {seg.shape}, {len(labels)} labels "
          f"{labels[:8].tolist()}...")
    check(held == ["Primus"], f"the predictor held {held}")
    check(seg.shape == TRAIN_CASE and labels.min() >= 0
          and labels.max() < TRAIN_K, f"Primus mask {seg.shape} {labels}")
    out.update(predict_s=predict_s, predict_labels=len(labels))

    # ---- a small Primus, fp32 with TF32 off: cuda vs cpu
    out["small"] = small_primus(torch, dev)
    return out


def small_primus(torch, dev):
    """A small Primus (embed 96, depth 2, 3 heads, 8^3 tokens, patch 32^3,
    4 classes) in float32 with TF32 off, cuda vs cpu from the same seeded
    weights: logits within 1e-4 of their scale, and after one AdamW step
    (lr 3e-4, the trainer's b2 0.98, clip 1, NaN-guarded) the parameters
    within 1e-5, except where a gradient element is within float noise of
    zero (|g| < 1e-7 = 10 eps: Adam moves it by up to lr in a direction the
    noise gives; at most 5% of the elements), where the bound is 2 lr."""
    import copy
    import numpy as np
    from fast_nnunet_tpu_torch.models.primus import Primus, init_primus_
    from fast_nnunet_tpu_torch.training.optimizers import nnunet_adamw
    from fast_nnunet_tpu_torch.training.train_step import make_train_step

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        net_c = init_primus_(Primus(1, 96, (8, 8, 8), 4, 2, 3, (32, 32, 32),
                                    compute_dtype=torch.float32,
                                    trainable=True), 11)
        net_d = copy.deepcopy(net_c).to(dev)
        rng = np.random.RandomState(12)
        lab = rng.randint(0, 4, (2, 32, 32, 32))
        x = torch.from_numpy((rng.randn(2, 1, 32, 32, 32) + lab[:, None]
                              ).astype(np.float32))
        t = torch.from_numpy(lab)
        with torch.no_grad():
            lc, ld = net_c(x), net_d(x.to(dev)).cpu()
        logit_err = float((lc - ld).abs().max() / lc.abs().max())
        lr = 3e-4
        res = []
        for net, d in ((net_c, torch.device("cpu")), (net_d, dev)):
            opt = nnunet_adamw(net.parameters(), lr, b2=0.98, grad_clip=1.0)
            loss = make_train_step(net, opt, skip_nonfinite=True)(
                x.to(d), (t.to(d),))
            res.append((float(loss), opt))
        (loss_c, opt_c), (loss_d, _) = res
        worst, n_noisy = -math.inf, 0
        for pc, pd in zip(net_c.parameters(), net_d.parameters()):
            g = opt_c.inner.state[pc]["exp_avg"] / 0.1
            noisy = g.abs() < 1e-7
            n_noisy += int(noisy.sum())
            d = (pc.detach() - pd.detach().cpu()).abs()
            worst = max(worst, float((d - (noisy * 2 * lr + 1e-5)).max()))
        n = sum(p.numel() for p in net_c.parameters())
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    print(f"small: fp32 Primus (embed 96, depth 2, 3 heads, 32^3) cuda vs "
          f"cpu: logits max diff {logit_err:.3e} of their scale (bound "
          f"1e-4); one AdamW step: losses {loss_d:.6f} vs {loss_c:.6f}, "
          f"parameters within their bound with {-worst:.3e} to spare "
          f"(1e-5; 2 lr on {n_noisy} of {n} elements whose gradient is "
          f"within float noise of zero)")
    check(logit_err <= 1e-4, f"small Primus logits cuda vs cpu {logit_err}")
    check(worst <= 0 and n_noisy <= 0.05 * n,
          f"small Primus AdamW step cuda vs cpu: excess {worst}, "
          f"{n_noisy} noisy elements")
    return {"logit_rel": logit_err, "param_excess": worst,
            "noisy_elements": n_noisy, "loss_cuda": loss_d,
            "loss_cpu": loss_c}


# ------------------------------------------------------------------ formats
FORMATS_DS_ID = 987
FORMATS_DS = "Dataset987_FormatsCT"


def formats_path(torch, dev, a_row, fed_npy, iters=10, warm=3):
    """Phase 16 (``formats:``): the reference's data through the port, in
    phase 11's temporary root after phase 12 (docstring step 16)."""
    t_phase = time.perf_counter()
    try:
        out = _formats(torch, dev, a_row, fed_npy, iters, warm)
    finally:
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"formats: phase wall {out['wall_s']:.3f} s")
    print(json.dumps({"formats": out}))


def _store_bytes(folder, suffixes):
    return sum(os.path.getsize(os.path.join(folder, f))
               for f in os.listdir(folder) if f.endswith(suffixes))


def _same_properties(got, want, keys):
    import numpy as np
    for k in keys:
        a, b = got[k], want[k]
        if isinstance(a, dict):
            if sorted(a) != sorted(b) or not all(
                    np.array_equal(a[c], b[c]) for c in a):
                return False
        elif not np.array_equal(np.asarray(a), np.asarray(b)):
            return False
    return True


def _formats(torch, dev, a_row, fed_npy, iters, warm):
    import numpy as np
    from fast_nnunet_tpu_torch.imageio.dicom import (DicomIO,
                                                     convert_dicom_entry)
    from fast_nnunet_tpu_torch.imageio.mha import MhaIO
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.imageio.nrrd import NrrdIO
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor
    from fast_nnunet_tpu_torch.models.factory import \
        build_network_from_arch_dict
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.planning.plans_transfer import move_plans_entry
    from fast_nnunet_tpu_torch.run import run_training as rt
    from fast_nnunet_tpu_torch.run.convert_b2nd import convert_b2nd_entry
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import (
        extract_fingerprint_entry, preprocess_entry)
    from fast_nnunet_tpu_torch.run.predict import predict_entry_point
    from fast_nnunet_tpu_torch.training.dataset import NpyCaseDataset
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer
    from fast_nnunet_tpu_torch.training.zstd_store import (BrickReader,
                                                           ZstdCaseDataset)
    from fast_nnunet_tpu_torch.utils import zstd
    from fast_nnunet_tpu_torch.utils.b2nd import write_b2nd
    from fast_nnunet_tpu_torch.utils.io import join, load_json, save_pickle

    ds, n = FORMATS_DS, PIPELINE_N_TRAIN
    pre_root = os.environ["nnUNet_preprocessed"]
    host = {}
    # ---- the raw dataset again, as .mha (phase 11's voxels and seed)
    t0 = time.perf_counter()
    raw = write_raw_ct_dataset(os.environ["nnUNet_raw"], dataset=ds,
                               file_ending=".mha")
    host["write_raw_s"] = time.perf_counter() - t0
    case = f"case_{n:03d}"
    img, img_props = MhaIO().read_images([join(raw, "imagesTs",
                                               f"{case}_0000.mha")])
    ref, ref_props = NiftiIO().read_images([join(
        os.environ["nnUNet_raw"], PIPELINE_DS, "imagesTs",
        f"{case}_0000.nii.gz")])
    seg_mha = MhaIO().read_seg(join(raw, "labelsTs", case + ".mha"))[0]
    nrrd = join(raw, "labelsTs", case + ".nrrd")
    NrrdIO().write_seg(seg_mha[0], nrrd, img_props)
    seg_nrrd, nrrd_props = NrrdIO().read_seg(nrrd)
    check(np.array_equal(img, ref) and img_props["spacing"] ==
          list(ref_props["spacing"]), "the .mha test case differs from "
          "phase 11's .nii.gz")
    check(np.array_equal(seg_nrrd, seg_mha) and
          nrrd_props["spacing"] == img_props["spacing"],
          "the .nrrd label differs from the .mha label")
    print(f"formats: raw dataset {ds}: {n} + 1 cases {TRAIN_CASE} int16 as "
          f".mha (zlib) in {host['write_raw_s']:.3f} s, equal to phase 11's "
          f".nii.gz voxels and spacing; the test label through NRRD (gzip) "
          f"equal")

    # ---- fingerprint, phase 11's plans moved over, preprocess -store fnnz
    t0 = time.perf_counter()
    extract_fingerprint_entry(["-d", str(FORMATS_DS_ID)])
    host["fingerprint_s"] = time.perf_counter() - t0
    fp = load_json(join(pre_root, ds, "dataset_fingerprint.json"))
    fp11 = load_json(join(pre_root, PIPELINE_DS, "dataset_fingerprint.json"))
    check(fp["foreground_intensity_properties_per_channel"] ==
          fp11["foreground_intensity_properties_per_channel"],
          "the .mha fingerprint's intensities differ from phase 11's")
    move_plans_entry(["-s", str(PIPELINE_DS_ID), "-t", str(FORMATS_DS_ID),
                      "-sp", "nnUNetPlans"])
    plans = load_json(join(pre_root, ds, "nnUNetPlans.json"))
    check(plans["image_reader_writer"] == "MhaIO",
          f"moved plans read with {plans['image_reader_writer']}")
    check(plan_topology(plans["configurations"]["3d_fullres"]) ==
          PIPELINE_3D_FULLRES, "moved plans are not phase 11's topology")
    t0 = time.perf_counter()
    preprocess_entry(["-d", str(FORMATS_DS_ID), "-c", "3d_fullres", "-store",
                      "fnnz"])
    host["preprocess_fnnz_s"] = time.perf_counter() - t0
    store = join(pre_root, ds, "nnUNetPlans_3d_fullres")
    store11 = join(pre_root, PIPELINE_DS, "nnUNetPlans_3d_fullres")
    t0 = time.perf_counter()
    fnnz, npy = ZstdCaseDataset(store), NpyCaseDataset(store11)
    check(fnnz.keys() == npy.keys() and len(fnnz) == n,
          f".fnnz cases {fnnz.keys()} vs .npy {npy.keys()}")
    keys = ("spacing", "shape_before_cropping", "bbox_used_for_cropping",
            "shape_after_cropping_and_before_resampling", "class_locations")
    for k in npy.keys():
        d, s, p = fnnz.load_case(k, mmap=False)
        d11, s11, p11 = npy.load_case(k)
        check(d.dtype == d11.dtype and d.tobytes() == d11.tobytes(),
              f"{k}: .fnnz data differs from phase 11's .npy")
        check(s.dtype == s11.dtype and s.tobytes() == s11.tobytes(),
              f"{k}: .fnnz seg differs from phase 11's .npy")
        check(_same_properties(p, p11, keys),
              f"{k}: properties differ from phase 11's")
    host["decode_check_s"] = time.perf_counter() - t0
    b_fnnz = _store_bytes(store, (".fnnz",))
    b_npy = _store_bytes(store11, (".npy",))
    backend = zstd.backend()
    print(f"formats: fast_nnunet_extract_fingerprint_torch "
          f"{host['fingerprint_s']:.3f} s (intensities equal phase 11's); "
          f"fast_nnunet_move_plans_torch -s {PIPELINE_DS_ID} (reader MhaIO, "
          f"phase 11's topology); fast_nnunet_preprocess_torch -store fnnz "
          f"{host['preprocess_fnnz_s']:.3f} s; every case decodes bit-equal "
          f"to phase 11's .npy store (data, seg, properties; "
          f"{host['decode_check_s']:.3f} s); store {b_fnnz} bytes against "
          f"{b_npy} (.npy), ratio {b_npy / b_fnnz:.3f}; zstd backend "
          f"{backend}")

    # ---- one case through the reference's .b2nd and back
    t0 = time.perf_counter()
    ref_dir, mig = join(pre_root, "b2nd_ref"), join(pre_root, "b2nd_ours")
    os.makedirs(ref_dir, exist_ok=True)
    k0 = npy.keys()[0]
    d11, s11, p11 = npy.load_case(k0)
    write_b2nd(join(ref_dir, k0 + ".b2nd"), np.asarray(d11))
    write_b2nd(join(ref_dir, k0 + "_seg.b2nd"), np.asarray(s11))
    save_pickle(p11, join(ref_dir, k0 + ".pkl"))
    host["write_b2nd_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert_b2nd_entry(["-i", ref_dir, "-o", mig])
    host["convert_b2nd_s"] = time.perf_counter() - t0
    d, s, _ = NpyCaseDataset(mig).load_case(k0, mmap=False)
    check(d.tobytes() == np.asarray(d11).tobytes() and
          s.tobytes() == np.asarray(s11).tobytes(),
          "the .b2nd round trip is not bit-equal")
    print(f"formats: {k0} as .b2nd (write_b2nd {host['write_b2nd_s']:.3f} s,"
          f" {_store_bytes(ref_dir, ('.b2nd',))} bytes) -> "
          f"fast_nnunet_convert_b2nd_torch {host['convert_b2nd_s']:.3f} s -> "
          f".npy, bit-equal")

    # ---- a reference .pth of the planned topology
    arch = plans["configurations"]["3d_fullres"]["architecture"]
    net = build_network_from_arch_dict(arch, 1, TRAIN_K,
                                       compute_dtype=torch.float32)
    sd = reference_state_dict(torch, net, seed=16)
    del net
    pth = join(pre_root, "pretrained_reference.pth")
    torch.save({"network_weights": sd, "trainer_name": "nnUNetTrainer",
                "init_args": {"configuration": "3d_fullres", "fold": 0},
                "current_epoch": 1000}, pth)
    n_seg = sum(".seg_layers." in k for k in sd)
    first = "encoder.stages.0.convs.0.conv.weight"

    # ---- fast_nnunet_train_torch 987 3d_fullres 0 -pretrained_weights
    loaded = {}
    real_load = rt.load_pretrained_weights

    def load_and_look(trainer, fname):
        report = real_load(trainer, fname)
        w = trainer.network.encoder.stages["stage_0"].blocks[
            "block_0"].conv.weight
        loaded.update(report=report, equal=bool(torch.equal(
            w.detach().cpu().float(), sd[first])))
        return report

    os.environ.update(FNNT_ITERS_PER_EPOCH=str(iters),
                      FNNT_VAL_ITERS_PER_EPOCH="2", FNNT_NUM_EPOCHS="1")
    cap = {}
    orig = stamp_iterations(NNUNetTrainer, "train_step", cap, warm)
    rt.load_pretrained_weights = load_and_look
    ka.spatial_sum_sumsq.launches = 0
    t0 = time.perf_counter()
    try:
        with host_seconds({"brick_read": (BrickReader,
                                          "__getitem__")}) as spent:
            rt.run_training_entry([str(FORMATS_DS_ID), "3d_fullres", "0",
                                   "-pretrained_weights", pth])
    finally:
        NNUNetTrainer.run_train_iterations = orig
        rt.load_pretrained_weights = real_load
    train_wall = time.perf_counter() - t0
    run_launches = ka.spatial_sum_sumsq.launches
    report = loaded["report"]
    check(len(report["converted"]) == len(sd) - n_seg and
          len(report["skipped_seg"]) == n_seg and not (
              report["unmatched"] or report["shape_mismatch"] or
              report["missing_in_template"]),
          f".pth import report {({k: len(v) for k, v in report.items()})}")
    check(loaded["equal"], "the first conv differs from the .pth tensor "
          "before step 1")
    trainer = cap["trainer"]
    st = cap["stamps"]
    fed = (st[-1] - st[warm]) / (iters - warm)
    x1 = torch.zeros((1, 1, *PIPELINE_3D_FULLRES["patch_size"]), device=dev)
    n_gate, n_gate_remat = gated_norms(torch, trainer.network, x1)
    predicted = n_gate + n_gate_remat
    tl = trainer.logger.logging
    reads = spent["brick_read"]
    print(f"formats: fast_nnunet_train_torch {FORMATS_DS_ID} 3d_fullres 0 "
          f"-pretrained_weights <.pth> ({iters} iterations from the .fnnz "
          f"store, final validation) {train_wall:.3f} s; .pth import: "
          f"{len(report['converted'])} tensors converted, {n_seg} seg "
          f"tensors skipped, first conv equal to the .pth before step 1; "
          f"fed seconds per iteration {fed:.4f} (.fnnz) against phase 11's "
          f"{fed_npy:.4f} (.npy); {len(reads)} BrickReader slices, "
          f"{sum(reads):.3f} s over the loader threads "
          f"({1e3 * sum(reads) / max(1, len(reads)):.3f} ms each)")
    print(f"formats: kernel A launches per train step {cap['step_launches']} "
          f"(predicted {predicted}); {run_launches} in the whole run; epoch "
          f"train loss {tl['train_losses'][0]:.4f}, val loss "
          f"{tl['val_losses'][0]:.4f}")
    check(all(k == predicted for k in cap["step_launches"]),
          f"kernel A launches per step {cap['step_launches']} != {predicted}")
    check(np.isfinite(tl["train_losses"][0]) and
          np.isfinite(tl["val_losses"][0]),
          f"non-finite losses {tl['train_losses']} {tl['val_losses']}")
    kernel_a_step_shapes(torch, "formats", cap["a_calls"],
                         cap["step_launches"][1], a_row)
    step_launches = cap["step_launches"]
    trainer.network = None
    del trainer, x1
    cap.clear()
    torch.cuda.empty_cache()

    # ---- predict the .mha test case; the same CT as a DICOM series
    results = join(os.environ["nnUNet_results"], ds)
    pred = join(os.environ["nnUNet_results"], "formats_pred")
    t0 = time.perf_counter()
    predict_entry_point(["-i", join(raw, "imagesTs"), "-o", pred, "-d", ds,
                         "-c", "3d_fullres", "-f", "0", "--disable_tta"])
    host["predict_mha_s"] = time.perf_counter() - t0
    mask_mha = MhaIO().read_seg(join(pred, case + ".mha"))[0][0]
    check(mask_mha.shape == TRAIN_CASE, f".mha mask {mask_mha.shape}")
    dcm = join(pre_root, "dicom_" + case)
    t0 = time.perf_counter()
    write_dicom_series(dcm, img[0].astype(np.int16), img_props["spacing"])
    host["write_dicom_s"] = time.perf_counter() - t0
    nii = join(pre_root, case + "_from_dicom.nii.gz")
    t0 = time.perf_counter()
    convert_dicom_entry([dcm, nii])
    host["dicom_to_nifti_s"] = time.perf_counter() - t0
    conv, conv_props = NiftiIO().read_images([nii])
    check(np.array_equal(conv, img) and np.allclose(
        conv_props["spacing"], img_props["spacing"], rtol=0, atol=1e-6),
        "fast_nnunet_dicom_to_nifti_torch changed the voxels or spacing")
    t0 = time.perf_counter()
    data, props = DicomIO().read_images([dcm])
    host["read_dicom_s"] = time.perf_counter() - t0
    check(np.array_equal(data, img) and props["spacing"] ==
          img_props["spacing"], "DicomIO differs from the .mha case")
    predictor = NNUNetPredictor(use_mirroring=False, device=dev)
    predictor.initialize_from_trained_model_folder(
        join(results, "NNUNetTrainer__nnUNetPlans__3d_fullres"),
        use_folds=[0])
    t0 = time.perf_counter()
    mask_dcm = predictor.predict_single_npy_array(data, props)
    host["predict_dicom_s"] = time.perf_counter() - t0
    same = float((np.asarray(mask_dcm) == mask_mha).mean())
    labels = len(np.unique(mask_mha))
    print(f"formats: fast_nnunet_predict_torch on the .mha test case "
          f"{host['predict_mha_s']:.3f} s (reader MhaIO), mask {mask_mha.shape}"
          f" with {labels} labels; the CT as {TRAIN_CASE[0]} DICOM slices "
          f"({host['write_dicom_s']:.3f} s), fast_nnunet_dicom_to_nifti_torch "
          f"{host['dicom_to_nifti_s']:.3f} s (voxels and spacing equal), "
          f"DicomIO {host['read_dicom_s']:.3f} s, predict_single_npy_array "
          f"{host['predict_dicom_s']:.3f} s; DICOM and .mha masks agree "
          f"{same:.6f}")
    check(mask_dcm.shape == mask_mha.shape and same == 1.0,
          f"DICOM and .mha masks differ ({same})")
    return {"host_s": host, "fed_s_per_iter": fed, "fed_s_per_iter_npy":
            fed_npy, "store_bytes_fnnz": b_fnnz, "store_bytes_npy": b_npy,
            "zstd_backend": backend, "brick_reads": len(reads),
            "brick_read_s": sum(reads), "train_wall_s": train_wall,
            "pth_converted": len(report["converted"]),
            "pth_skipped_seg": n_seg,
            "kernel_a_launches_per_step": step_launches,
            "kernel_a_predicted_per_step": predicted,
            "kernel_a_run_launches": run_launches,
            "dicom_vs_mha_mask": same}


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


# ----------------------------------------------------------------- cascade
SMALL_2D = dict(SMALL_ARCH, kernel_sizes=[[3, 3]] * 3,
                strides=[[1, 1]] + [[2, 2]] * 2,
                conv_op="torch.nn.modules.conv.Conv2d")
SMALL_2D_RESENC = dict(SMALL_2D, n_blocks_per_stage=[1, 2, 2],
                       n_conv_per_stage_decoder=[1, 1])


def cascade_path(torch, dev, a_row, iters=10, warm=3):
    """Phase 13 (``cascade:``): nnU-Net's 2d and 3d_lowres ->
    3d_cascade_fullres configurations through the port's entry points, in
    process (docstring step 13)."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="fnn_chip_smoke_cascade_")
    env = {f"nnUNet_{k}": os.path.join(root, k)
           for k in ("raw", "preprocessed", "results")}
    old = {k: os.environ.get(k) for k in list(env) + [
        "FNNT_ITERS_PER_EPOCH", "FNNT_VAL_ITERS_PER_EPOCH",
        "FNNT_NUM_EPOCHS"]}
    os.environ.update(env)
    try:
        _cascade(torch, dev, a_row, iters, warm)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _train_configuration(torch, dev, a_row, configuration, fold, iters,
                         warm):
    """``fast_nnunet_train_torch 990 CONFIGURATION FOLD`` (one epoch of
    ``iters`` iterations, 2 validation iterations, the final validation)
    with the iterations stamped and phased: prints and returns the
    configuration's numbers, checks kernel A's launches per step against
    the gate's count and a finite, falling loss, and puts A's calls of one
    step into A's ``train_shapes``."""
    import numpy as np
    from fast_nnunet_tpu_torch.evaluation import metrics
    from fast_nnunet_tpu_torch.inference import export
    from fast_nnunet_tpu_torch.inference.engine import (PhaseTimer,
                                                        SlidingWindowEngine)
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.run.run_training import run_training_entry
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer

    cap = {}
    timer = PhaseTimer()
    orig = stamp_iterations(NNUNetTrainer, "train_step", cap, warm, timer)
    torch.cuda.reset_peak_memory_stats()
    ka.spatial_sum_sumsq.launches = 0
    t0 = time.perf_counter()
    try:
        with host_seconds({
                "validation": (NNUNetTrainer, "perform_actual_validation"),
                "sliding_window": (SlidingWindowEngine, "_logits"),
                "export": (export, "export_prediction_from_logits"),
                "deposit": (export, "resample_and_save"),
                "metrics": (metrics, "compute_metrics_on_folder")}) as spent:
            run_training_entry([str(CASCADE_DS_ID), configuration,
                                str(fold)])
    finally:
        NNUNetTrainer.run_train_iterations = orig
    wall = time.perf_counter() - t0
    val = {k: sum(v) for k, v in spent.items()}
    val["cases"] = len(spent["export"])
    run_launches = ka.spatial_sum_sumsq.launches
    trainer = cap["trainer"]
    st = cap["stamps"]
    fed = (st[-1] - st[warm]) / (iters - warm)
    phases = {k: v / (iters - warm)
              for k, v in device_ms(timer.totals()).items()}
    cm = trainer.configuration_manager
    x1 = torch.zeros((1, trainer.num_input_channels, *cm.patch_size),
                     device=dev)
    n_gate, n_remat = gated_norms(torch, trainer.network, x1)
    f_fwd, f_remat = conv_flops(torch, trainer.network, x1)
    del x1
    flops = cm.batch_size * (3 * f_fwd + f_remat)   # hooks: batch 1
    predicted = n_gate + n_remat
    losses = [float(v) for v in cap["outs"]]
    tl = trainer.logger.logging
    first = trainer.network.encoder.stages["stage_0"].blocks["block_0"].conv
    out = {"fold": fold, "wall_s": wall, "fed_s_per_iter": fed,
           "phases_ms": phases, "flops_per_step": flops,
           "mfu_fed": flops / fed / BF16_TENSOR_OPS_PER_S,
           "peak_gib_train": cap["peak_bytes"] / 2**30,
           "remat": trainer._use_remat(), "input_channels": first.in_channels,
           "kernel_a_launches_per_step": cap["step_launches"],
           "kernel_a_predicted_per_step": predicted,
           "kernel_a_run_launches": run_launches, "losses": losses,
           "val_loss": tl["val_losses"][0], "final_validation_s": val}
    kind = type(trainer.network).__name__
    print(f"cascade: {configuration} fold {fold}: {kind} "
          f"{trainer.network.dim}D, features "
          f"{stage_features(trainer.network)}, {first.in_channels} input "
          f"channels, {TRAIN_K} classes, patch {cm.patch_size}, batch "
          f"{cm.batch_size}, remat {out['remat']!r}; fast_nnunet_train_torch"
          f" ({iters} iterations, 2 validation iterations, final validation)"
          f" {wall:.3f} s; fed seconds per iteration {fed:.4f} (iterations "
          f"{warm}-{iters - 1}); FLOPs per step {flops:.4e}, mfu fed "
          f"{out['mfu_fed']:.4f}; peak device memory "
          f"{out['peak_gib_train']:.2f} GiB over the training iterations")
    print(f"cascade: {configuration} final validation of {val['cases']} "
          f"case(s), serial on the host clock: {val['validation']:.3f} s, of "
          f"which sliding window {val['sliding_window']:.3f} s, export "
          f"{val['export']:.3f} s, next-stage deposits {val['deposit']:.3f} "
          f"s, metrics {val['metrics']:.3f} s")
    print(f"cascade: {configuration} phase ms per fed iteration (CUDA "
          f"events) " + json.dumps({k: round(v, 3)
                                    for k, v in phases.items()}))
    print(f"cascade: {configuration} kernel A launches per train step "
          f"{cap['step_launches']} (predicted {predicted}: {n_gate} norms at "
          f">= 4096 voxels per forward, {n_remat} recomputed by remat); "
          f"{run_launches} in the whole run; losses "
          f"{[round(v, 4) for v in losses]}, val loss {out['val_loss']:.4f}")
    check(all(k == predicted for k in cap["step_launches"]),
          f"{configuration}: kernel A launches per step "
          f"{cap['step_launches']} != {predicted}")
    check(predicted > 0, f"{configuration} launched no kernel A")
    check(all(np.isfinite(losses)) and np.isfinite(out["val_loss"]),
          f"{configuration}: non-finite losses {losses} {out['val_loss']}")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"{configuration}: the loss did not fall: {losses}")
    calls, step_launches = cap["a_calls"], cap["step_launches"][1]
    trainer.network = None
    del trainer
    cap.clear()
    torch.cuda.empty_cache()
    kernel_a_step_shapes(torch, configuration, calls, step_launches, a_row)
    return out


DISTILL_ITERS = 6


def _distill_configuration(torch, dev, a_row, cfg, outs, iters, warm):
    """``fast_nnunet_distill_torch -d 990 -c CFG -t <the NNUNetTrainer
    model folder of CFG> -tf 0 -r 2 -a 0.3 -temp 3.0`` (one epoch of
    ``iters`` iterations, 1 validation iteration, the final validation),
    kernel A's launches per distillation step against the gate's count
    (student, recomputed student norms, the teacher) and A's calls of one
    step into A's ``train_shapes``; then ``fast_nnunet_predict_torch -c CFG
    -tr NNUNetDistillationTrainer --disable_tta`` on imagesTs (the cascade
    student with the 3d_lowres predictions of ``outs``)."""
    import numpy as np
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.run.distillation_train import \
        distillation_train_entry
    from fast_nnunet_tpu_torch.run.predict import predict_entry_point
    from fast_nnunet_tpu_torch.training.distill import \
        NNUNetDistillationTrainer
    from fast_nnunet_tpu_torch.utils.io import join

    ds, n = CASCADE_DS, CASCADE_N_TRAIN
    results = join(os.environ["nnUNet_results"], ds)
    teacher = join(results, f"NNUNetTrainer__nnUNetPlans__{cfg}")
    os.environ.update(FNNT_ITERS_PER_EPOCH=str(iters),
                      FNNT_VAL_ITERS_PER_EPOCH="1", FNNT_NUM_EPOCHS="1")
    cap = {}
    orig = stamp_iterations(NNUNetDistillationTrainer, "distill_step", cap,
                            warm)
    torch.cuda.reset_peak_memory_stats()
    ka.spatial_sum_sumsq.launches = 0
    t0 = time.perf_counter()
    try:
        distillation_train_entry(["-d", str(CASCADE_DS_ID), "-c", cfg, "-f",
                                  "0", "-t", teacher, "-tf", "0", "-r", "2",
                                  "-a", "0.3", "-temp", "3.0"])
    finally:
        NNUNetDistillationTrainer.run_train_iterations = orig
    wall = time.perf_counter() - t0
    trainer = cap["trainer"]
    st = cap["stamps"]
    per_iter = (st[-1] - st[warm]) / (iters - warm)
    cm = trainer.configuration_manager
    x1 = torch.zeros((1, trainer.num_input_channels, *cm.patch_size),
                     device=dev)
    s_gate, s_remat = gated_norms(torch, trainer.network, x1)
    t_gate, _ = gated_norms(torch, trainer.teachers[0], x1)
    del x1
    predicted = s_gate + s_remat + len(trainer.teachers) * t_gate
    lg = trainer.logger.logging
    seg_l, dist_l = lg["train_seg_losses"][0], lg["train_distill_losses"][0]
    first = trainer.network.encoder.stages["stage_0"].blocks["block_0"].conv
    out = {"wall_s": wall, "s_per_iter": per_iter,
           "peak_gib_train": cap["peak_bytes"] / 2**30,
           "student_features": stage_features(trainer.network),
           "input_channels": first.in_channels, "seg_loss": seg_l,
           "distill_loss": dist_l,
           "kernel_a_launches_per_step": cap["step_launches"],
           "kernel_a_predicted_per_step": predicted}
    print(f"cascade: distill {cfg}: student {trainer.network.dim}D features "
          f"{out['student_features']}, {first.in_channels} input channels, "
          f"{len(trainer.teachers)} teacher fold {trainer.teacher_fold}, "
          f"alpha {trainer.alpha}, T {trainer.temperature}, patch "
          f"{cm.patch_size}, batch {cm.batch_size}; "
          f"fast_nnunet_distill_torch ({iters} iterations, 1 validation "
          f"iteration, final validation) {wall:.3f} s; seconds per "
          f"iteration {per_iter:.4f} (iterations {warm}-{iters - 1}); peak "
          f"device memory {out['peak_gib_train']:.2f} GiB over the training "
          f"iterations; epoch seg loss {seg_l:.4f}, distill loss "
          f"{dist_l:.4f}")
    print(f"cascade: distill {cfg} kernel A launches per step "
          f"{cap['step_launches']} (predicted {predicted}: student {s_gate} "
          f"+ {s_remat} recomputed, {len(trainer.teachers)} teacher x "
          f"{t_gate})")
    check(all(k == predicted for k in cap["step_launches"]),
          f"distill {cfg}: kernel A launches per step "
          f"{cap['step_launches']} != {predicted}")
    check(predicted > 0, f"distill {cfg} launched no kernel A")
    check(np.isfinite(seg_l) and np.isfinite(dist_l) and dist_l > 0,
          f"distill {cfg} losses seg {seg_l} distill {dist_l}")
    check(first.in_channels == (1 if cfg == "2d" else TRAIN_K),
          f"distill {cfg}: the student takes {first.in_channels} channels")
    calls, step_launches = cap["a_calls"], cap["step_launches"][1]
    trainer.teachers = []
    trainer.network = None
    del trainer
    cap.clear()
    torch.cuda.empty_cache()
    kernel_a_step_shapes(torch, f"distill_{cfg}", calls, step_launches,
                         a_row)

    raw = join(os.environ["nnUNet_raw"], ds)
    o = join(os.environ["nnUNet_results"], f"imagesTs_distill_{cfg}")
    extra = ["-prev_stage_predictions", outs["3d_lowres"]] \
        if cfg == "3d_cascade_fullres" else []
    t0 = time.perf_counter()
    predict_entry_point(["-i", join(raw, "imagesTs"), "-o", o, "-d", ds,
                         "-c", cfg, "-f", "0", "-tr",
                         "NNUNetDistillationTrainer", "--disable_tta"]
                        + extra)
    out["predict_s"] = time.perf_counter() - t0
    case = f"case_{n:03d}"
    seg = NiftiIO().read_seg(join(o, case + ".nii.gz"))[0][0]
    labels = np.unique(seg)
    check(seg.shape == CASCADE_CASE and labels.min() >= 0
          and labels.max() < TRAIN_K,
          f"distilled {cfg} mask {seg.shape} labels {labels[:8]}")
    out["predict_labels"] = len(labels)
    print(f"cascade: fast_nnunet_predict_torch -c {cfg} -tr "
          f"NNUNetDistillationTrainer --disable_tta {' '.join(extra)} "
          f"{out['predict_s']:.3f} s: mask {seg.shape}, {len(labels)} "
          f"labels")
    return out


def _cascade(torch, dev, a_row, iters, warm):
    import shutil
    import numpy as np
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.inference import predictor
    from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
    from fast_nnunet_tpu_torch.planning.fingerprint import \
        DatasetFingerprintExtractor
    from fast_nnunet_tpu_torch.planning.planner import ExperimentPlanner
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    from fast_nnunet_tpu_torch.run.evaluate import evaluate_simple_entry
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import \
        plan_and_preprocess_entry
    from fast_nnunet_tpu_torch.run.predict import predict_entry_point
    from fast_nnunet_tpu_torch.utils.io import (join, load_json, save_json,
                                                subfiles)

    t_phase = time.perf_counter()
    ds, n, ident = CASCADE_DS, CASCADE_N_TRAIN, str(CASCADE_DS_ID)
    t0 = time.perf_counter()
    raw = write_raw_ct_dataset(os.environ["nnUNet_raw"], dataset=ds,
                               shape=CASCADE_CASE, spacing=CASCADE_SPACING,
                               n_train=n)
    host = {"write_raw_s": time.perf_counter() - t0}
    print(f"cascade: raw dataset {ds}: {n} training cases and 1 test case "
          f"{CASCADE_CASE} int16 at {CASCADE_SPACING} mm, {TRAIN_K} labels, "
          f"written as .nii.gz in {host['write_raw_s']:.3f} s")

    # ---- fast_nnunet_plan_and_preprocess_torch -c 2d 3d_fullres 3d_lowres
    with host_seconds({
            "fingerprint": (DatasetFingerprintExtractor, "run"),
            "plan": (ExperimentPlanner, "plan_experiment"),
            "preprocess": (DefaultPreprocessor, "run")}) as spent:
        t0 = time.perf_counter()
        plan_and_preprocess_entry(["-d", ident, "-c", "2d", "3d_fullres",
                                   "3d_lowres"])
        host["plan_and_preprocess_s"] = time.perf_counter() - t0
    check([len(v) for v in spent.values()] == [1, 1, 3],
          f"plan and preprocess ran {spent}")
    host.update(fingerprint_s=spent["fingerprint"][0],
                plan_s=spent["plan"][0])
    for cfg, sec in zip(("2d", "3d_fullres", "3d_lowres"),
                        spent["preprocess"]):
        host[f"preprocess_{cfg}_s"] = sec
    pre = join(os.environ["nnUNet_preprocessed"], ds)
    plans = load_json(join(pre, "nnUNetPlans.json"))
    topo = cascade_topologies(plans)
    print(f"cascade: fast_nnunet_plan_and_preprocess_torch -c 2d 3d_fullres "
          f"3d_lowres {host['plan_and_preprocess_s']:.3f} s: fingerprint "
          f"{host['fingerprint_s']:.3f}, plan {host['plan_s']:.3f}, "
          f"preprocess 2d {host['preprocess_2d_s']:.3f}, 3d_fullres "
          f"{host['preprocess_3d_fullres_s']:.3f}, 3d_lowres "
          f"{host['preprocess_3d_lowres_s']:.3f} s")
    for cfg in CASCADE_CONFIGS:
        print(f"cascade: planned {cfg} " + json.dumps(topo.get(cfg)))
    check(topo == CASCADE_PLANS, f"planned {topo} are not the frozen "
          f"{CASCADE_PLANS}")
    for did in ("nnUNetPlans_2d", "nnUNetPlans_3d_fullres",
                "nnUNetPlans_3d_lowres"):
        stored = os.listdir(join(pre, did))
        check(len(stored) == 3 * n, f"{did} holds {stored}")
    # fold 0 of a dataset too small for 5 folds: the user's own split
    save_json([{"train": [f"case_{i:03d}" for i in range(1, n)],
                "val": ["case_000"]}], join(pre, "splits_final.json"))

    # ---- fast_nnunet_train_torch 990 2d 0 / 3d_lowres all /
    #      3d_cascade_fullres 0
    os.environ.update(FNNT_ITERS_PER_EPOCH=str(iters),
                      FNNT_VAL_ITERS_PER_EPOCH="2", FNNT_NUM_EPOCHS="1")
    out = {"host_s": host, "topology": topo}
    for cfg, fold in (("2d", 0), ("3d_lowres", "all"),
                      ("3d_cascade_fullres", 0)):
        out[cfg] = _train_configuration(torch, dev, a_row, cfg, fold, iters,
                                        warm)
        if cfg == "3d_lowres":
            folder = join(os.environ["nnUNet_results"], ds,
                          "NNUNetTrainer__nnUNetPlans__3d_lowres",
                          "predicted_next_stage", "3d_cascade_fullres")
            deposits = subfiles(folder, suffix=".npz", join_path=False)
            check(len(deposits) == n, f"{len(deposits)} deposits in "
                  f"{folder}, not {n}")
            for d in deposits:
                seg = np.load(join(folder, d))["seg"]
                grid = np.load(join(pre, "nnUNetPlans_3d_fullres",
                                    d[:-4] + ".npy"), mmap_mode="r").shape
                check(seg.dtype == np.uint8 and seg.shape == grid[1:]
                      and int(seg.max()) < TRAIN_K,
                      f"deposit {d}: {seg.dtype} {seg.shape}, the "
                      f"3d_fullres grid is {grid[1:]}")
            out["deposits"] = len(deposits)
            print(f"cascade: 3d_lowres fold all left {len(deposits)} "
                  f"predicted_next_stage deposits, each uint8 on its case's "
                  f"3d_fullres grid {grid[1:]}")
    check(out["3d_cascade_fullres"]["input_channels"] == TRAIN_K,
          f"the cascade network takes "
          f"{out['3d_cascade_fullres']['input_channels']} input channels, "
          f"not 1 + {TRAIN_K - 1}")
    ph = out["3d_cascade_fullres"]["phases_ms"]
    print(f"cascade: 3d_cascade_fullres fed iteration: data "
          f"{ph.get('data', 0.0):.3f} ms (the one-hot of {TRAIN_K - 1} "
          f"labels and its corruption on the host), h2d "
          f"{ph.get('h2d', 0.0):.3f} ms, forward_loss "
          f"{ph.get('forward_loss', 0.0):.3f}, backward "
          f"{ph.get('backward', 0.0):.3f}, optimizer "
          f"{ph.get('optimizer', 0.0):.3f} ms")

    # ---- fast_nnunet_predict_torch: 2d, 3d_lowres, then the cascade
    case = f"case_{n:03d}"
    img, iprops = NiftiIO().read_images([join(raw, "imagesTs",
                                              case + "_0000.nii.gz")])
    outs = {}
    for cfg, extra in (("2d", ["-f", "0", "--disable_tta"]),
                       ("3d_lowres", ["-f", "all", "--disable_tta"]),
                       ("3d_cascade_fullres", ["-f", "0", "--disable_tta"])):
        o = join(os.environ["nnUNet_results"], f"imagesTs_{cfg}")
        if cfg == "3d_cascade_fullres":
            extra = extra + ["-prev_stage_predictions", outs["3d_lowres"]]
        t0 = time.perf_counter()
        with host_seconds({
                "sliding_window": (SlidingWindowEngine, "_logits"),
                "export": (predictor, "export_prediction_from_logits")}
                ) as spent:
            predict_entry_point(["-i", join(raw, "imagesTs"), "-o", o, "-d",
                                 ds, "-c", cfg] + extra)
        host[f"predict_{cfg}_s"] = time.perf_counter() - t0
        for k, v in spent.items():
            host[f"predict_{cfg}_{k}_s"] = sum(v)
        seg, sprops = NiftiIO().read_seg(join(o, case + ".nii.gz"))
        labels = np.unique(seg)
        check(seg.shape == img.shape and
              list(sprops["spacing"]) == list(iprops["spacing"]) and
              labels.min() >= 0 and labels.max() < TRAIN_K,
              f"{cfg} mask {seg.shape} spacing {sprops['spacing']} labels "
              f"{labels[:8]} for image {img.shape} {iprops['spacing']}")
        evaluate_simple_entry([join(raw, "labelsTs"), o, "-l",
                               *map(str, range(1, TRAIN_K))])
        dice = load_json(join(o, "summary.json"))["foreground_mean"]["Dice"]
        check(np.isfinite(dice), f"{cfg} test Dice {dice}")
        out[f"test_fg_dice_{cfg}"] = dice
        outs[cfg] = o
        print(f"cascade: fast_nnunet_predict_torch -c {cfg} "
              f"{' '.join(extra[2:])} "
              f"{host[f'predict_{cfg}_s']:.3f} s (sliding window "
              f"{host[f'predict_{cfg}_sliding_window_s']:.3f}, export "
              f"{host[f'predict_{cfg}_export_s']:.3f} s): mask "
              f"{seg.shape[1:]} at "
              f"{list(sprops['spacing'])} mm, {len(labels)} labels; test "
              f"foreground Dice {dice:.4f}")

    # ---- fast_nnunet_distill_torch -c 2d / -c 3d_cascade_fullres, one
    #      teacher fold each, and their students predicted
    results = join(os.environ["nnUNet_results"], ds)
    shutil.copytree(
        join(results, "NNUNetTrainer__nnUNetPlans__3d_lowres",
             "predicted_next_stage"),
        join(results, "NNUNetDistillationTrainer__nnUNetPlans__3d_lowres",
             "predicted_next_stage"))
    for cfg in ("2d", "3d_cascade_fullres"):
        out[f"distill_{cfg}"] = _distill_configuration(
            torch, dev, a_row, cfg, outs, DISTILL_ITERS, 2)

    # ---- small: 2D and cascade steps cuda vs cpu
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["small_2d"] = small_train_step(
            torch, dev, "PlainConvUNet", SMALL_2D, "2D train step",
            patch=(64, 64))
        out["small_2d_resenc"] = small_train_step(
            torch, dev, "ResidualEncoderUNet", SMALL_2D_RESENC,
            "2D ResEnc train step", patch=(64, 64))
        out["small_cascade"] = small_train_step(
            torch, dev, "PlainConvUNet", SMALL_ARCH,
            "cascade train step (1 + 3 one-hot channels)", cascade=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"cascade: phase wall {out['wall_s']:.3f} s")
    print(json.dumps({"cascade": out}))


def small_train_step(torch, dev, cls="PlainConvUNet", arch=SMALL_ARCH,
                     name="train step", kernel_a=True, patch=(32, 32, 32),
                     cascade=False):
    """Three SGD steps of a narrow training network ``cls`` at ``arch`` on
    ``patch`` (2D or 3D), fp32 with TF32 off and deterministic cuDNN, cuda
    (kernel A, unless ``kernel_a`` is False: a BatchNorm network has no
    InstanceNorm) vs cpu (plain version): losses within 1e-4 relative,
    parameters (and a BatchNorm network's running averages) within 1e-5
    absolute. ``cascade``: the input is a cascade stage's, the image and the
    one-hot channels of a previous stage's labels (1 + 3 channels)."""
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
    in_ch = 4 if cascade else 1
    half = (slice(None),) + (slice(None, None, 2),) * len(patch)
    batches = []
    for _ in range(3):
        x = rng.randn(2, 1, *patch).astype(np.float32)
        lab = rng.randint(0, 4, (2, *patch))
        if cascade:
            prev_lab = rng.randint(0, 4, (2, *patch))
            x = np.concatenate([x, np.stack([prev_lab == c for c in (1, 2, 3)],
                                            1).astype(np.float32)], 1)
        batches.append((torch.from_numpy(x), (
            torch.from_numpy(lab), torch.from_numpy(lab[half].copy()))))

    def build():
        return get_network_from_plans(
            cls, arch, (), in_ch, 4, compute_dtype=torch.float32,
            norm_onepass=True, trainable=True)

    tree = random_plain_params(arch, in_ch, 4, seed=6) \
        if cls == "PlainConvUNet" and "norm_op" not in arch \
        and len(patch) == 3 else params_to_jax(init_he_normal_(build(), 6))
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


# ----------------------------------------------- export and fast inference
FAST_DS = "Dataset991_FastInference"
FAST_CT_SLICES = 24        # N of the 512 x 512 x N /predict case
FAST_ARRAY_SHAPE = (160, 192, 192)
FAST_SMALL_CT = (48, 48, 48)


def write_student_model_folder(folder, seed=0):
    """The bone_turbo r = 2 student as a ``NNUNetDistillationTrainer`` fold-0
    checkpoint (seeded random weights, written with the port's
    ``save_checkpoint``) with its plans.json (the teacher's architecture,
    patch 160x96x96, the INI's target spacing, CT normalisation with the
    INI's mean, std and bounds) and a 61-label dataset.json."""
    from fast_nnunet_tpu_torch.models.students import build_lite_student
    from fast_nnunet_tpu_torch.models.unet import (init_he_normal_,
                                                   params_to_jax)
    from fast_nnunet_tpu_torch.training.checkpoint import save_checkpoint
    from fast_nnunet_tpu_torch.utils.io import maybe_mkdir_p, save_json

    ini = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    ini.read(os.path.join(HERE, "engine", "config",
                          "fast_nnunet_bone_turbo.ini"))
    pp = ini["preprocessing"]
    rs = "resample_data_or_seg_to_shape"
    plans = {
        "dataset_name": FAST_DS, "plans_name": "nnUNetPlans",
        "image_reader_writer": "NiftiIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel": {"0": {
            "mean": pp.getfloat("mean"), "std": pp.getfloat("std"),
            "percentile_00_5": pp.getfloat("lower_bound"),
            "percentile_99_5": pp.getfloat("upper_bound")}},
        "configurations": {"3d_fullres": {
            "data_identifier": "nnUNetPlans_3d_fullres", "batch_size": 2,
            "patch_size": list(TRAIN_PATCH), "spacing": TRAIN_SPACING,
            "normalization_schemes": ["CTNormalization"],
            "use_mask_for_norm": [False],
            "resampling_fn_data": rs,
            "resampling_fn_data_kwargs": {"is_seg": False, "order": 3,
                                          "order_z": 0,
                                          "force_separate_z": None},
            "resampling_fn_seg": rs,
            "resampling_fn_seg_kwargs": {"is_seg": True, "order": 1,
                                         "order_z": 0,
                                         "force_separate_z": None},
            "resampling_fn_probabilities": rs,
            "resampling_fn_probabilities_kwargs": {
                "is_seg": False, "order": 1, "order_z": 0,
                "force_separate_z": None},
            "architecture": TRAIN_ARCH, "batch_dice": False}}}
    dataset_json = {
        "name": FAST_DS, "numTraining": 0, "file_ending": ".nii.gz",
        "channel_names": {"0": "CT"},
        "labels": {"background": 0,
                   **{f"bone_{c}": c for c in range(1, TRAIN_K)}}}
    net = build_lite_student(TRAIN_ARCH["network_class_name"],
                             TRAIN_ARCH["arch_kwargs"], 1, TRAIN_K, 2,
                             trainable=True)
    maybe_mkdir_p(os.path.join(folder, "fold_0"))
    save_json(plans, os.path.join(folder, "plans.json"))
    save_json(dataset_json, os.path.join(folder, "dataset.json"))
    save_checkpoint(os.path.join(folder, "fold_0", "checkpoint_final.fnnx"),
                    network_weights=params_to_jax(init_he_normal_(net, seed)),
                    init_args={"configuration": "3d_fullres", "fold": 0,
                               "feature_reduction_factor": 2},
                    trainer_name="NNUNetDistillationTrainer",
                    inference_allowed_mirroring_axes=[0, 1, 2])


def write_ct(fname, shape, seed):
    """A synthetic int16 CT (utils/synthetic_ct.py) of (i, j, k) ``shape``
    at 0.8 x 0.8 x 1.0 mm, written through the port's NIfTI writer."""
    from fast_nnunet_tpu_torch.imageio.nifti import write_nifti
    from fast_nnunet_tpu_torch.utils.synthetic_ct import make_synthetic_ct
    ct, spacing = make_synthetic_ct(shape, (0.8, 0.8, 1.0), seed=seed)
    write_nifti(fname, ct, spacing=spacing)


def fast_inference_path(torch, dev, n_slices=FAST_CT_SLICES):
    """Phase 14 (``fast_inference:``): export and the fast-inference module
    at full width (docstring step 14). Everything it starts it stops."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="fnn_chip_smoke_fast_inference_")
    try:
        return _fast_inference(torch, dev, root, n_slices)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _http(port, method, path, body=None, headers=None, timeout=900):
    """(status, headers, body bytes) of one request to the local server."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _fast_inference(torch, dev, root, n_slices):
    import shutil
    import socket
    import numpy as np
    from fast_nnunet_tpu_torch.device import resolve_device
    from fast_nnunet_tpu_torch.export.export_model import \
        export_model_folder_to_artifact
    from fast_nnunet_tpu_torch.fast_inference import \
        inferencer as inferencer_module
    from fast_nnunet_tpu_torch.fast_inference.inferencer import \
        FastnnUNetInferencer
    from fast_nnunet_tpu_torch.fast_inference.rest_api import FastnnUNetAPI
    from fast_nnunet_tpu_torch.imageio.nifti import (NiftiIOWithReorient,
                                                     read_nifti)
    from fast_nnunet_tpu_torch.inference.engine import PhaseTimer
    from fast_nnunet_tpu_torch.inference.jhu_predictor import \
        jhu_predict_entry
    from fast_nnunet_tpu_torch.utils import fastgz
    from fast_nnunet_tpu_torch.utils.io import join, load_json, maybe_mkdir_p

    t_phase = time.perf_counter()
    out = {"libdeflate": fastgz.available()}
    print(f"fast_inference: libdeflate loaded: {out['libdeflate']} (NIfTI "
          f"gzip through {'libdeflate' if out['libdeflate'] else 'stdlib'})")
    model = join(root, "model")
    t0 = time.perf_counter()
    write_student_model_folder(model)
    print(f"fast_inference: r = 2 student fold 0 (seeded random weights, "
          f"{TRAIN_K} classes, patch {TRAIN_PATCH}) written in "
          f"{time.perf_counter() - t0:.3f} s")

    # ---- export: bf16, B = 8, validated; and the --tta artifact
    exports = {}
    for name, tta in (("export", False), ("export_tta", True)):
        st = {}
        export_model_folder_to_artifact(model, 0, join(root, name),
                                        batch_size=8, dtype="bfloat16",
                                        bake_mirroring=tta, device=dev,
                                        stats=st)
        exports[name] = st
        print(f"fast_inference: {name} (bf16, B = 8, {str(dev)}): export "
              f"{st['export_s']:.3f} s, validation {st['validate_s']:.3f} s, "
              f"max relative deviation {st['max_rel']:.3e} (bound 1e-2)")
        check(st["max_rel"] <= 1e-2, f"{name} deviates {st['max_rel']}")
    meta = load_json(join(root, "export", "model_config.json"))
    check(meta["input_shape"] == [8, 1, *TRAIN_PATCH]
          and torch.device(meta["device"]) == resolve_device(dev)
          and meta["artifact"] == "model.pt2",
          f"sidecar {meta['input_shape']} {meta['device']}")
    check(load_json(join(root, "export_tta", "model_config.json"))[
        "mirroring_baked_into_artifact"] is True, "tta sidecar")
    out["exports"] = exports

    # ---- serve the artifact
    torch.cuda.reset_peak_memory_stats()
    inferencer = FastnnUNetInferencer(
        config_file=join(root, "export", "model_config.json"), device=dev)
    check(inferencer.engine.tile_batch == 8
          and inferencer.engine.pad_to_tile_batch
          and inferencer.engine.mirror_axes == (), "artifact engine")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    api = FastnnUNetAPI(inferencer, "127.0.0.1", port)
    thread = api.run(blocking=False)
    walls = {}
    try:
        t0 = time.perf_counter()
        while True:
            try:
                code, _, body = _http(port, "GET", "/health", timeout=5)
                if code == 200:
                    break
            except OSError:
                pass
            check(time.perf_counter() - t0 < 30, "server did not come up")
            time.sleep(0.05)
        walls["health"] = time.perf_counter() - t0
        check(json.loads(body) == {"status": "ok"}, f"/health {body!r}")
        t0 = time.perf_counter()
        code, _, body = _http(port, "GET", "/model_info")
        walls["model_info"] = time.perf_counter() - t0
        info = json.loads(body)
        check(code == 200 and info["source"] == "artifact"
              and info["num_classes"] == TRAIN_K, f"/model_info {info}")

        # /predict: a 512 x 512 x N CT with largest-component postprocessing
        big = join(root, "ct_big.nii.gz")
        write_ct(big, (512, 512, n_slices), seed=0)
        seg_art = join(root, "out_artifact", "ct_big.nii.gz")
        maybe_mkdir_p(os.path.dirname(seg_art))
        inferencer.engine.timer = PhaseTimer()
        pre_pp = []  # the artifact route's mask before postprocessing
        real_pp = inferencer_module.\
            remove_all_but_largest_component_from_segmentation

        def keep_input(seg, labels, *args, **kwargs):
            pre_pp.append(np.array(seg))
            return real_pp(seg, labels, *args, **kwargs)

        inferencer_module.remove_all_but_largest_component_from_segmentation \
            = keep_input
        t0 = time.perf_counter()
        try:
            code, _, body = _http(port, "POST", "/predict", json.dumps({
                "input_file": big, "output_file": seg_art,
                "postprocessing": True}).encode())
        finally:
            inferencer_module.\
                remove_all_but_largest_component_from_segmentation = real_pp
        walls["predict"] = time.perf_counter() - t0
        phases = device_ms(inferencer.engine.timer.totals())
        inferencer.engine.timer = None
        host = dict(inferencer.timings)
        check(code == 200, f"/predict {code} {body[:300]!r}")
        res = json.loads(body)
        print(f"fast_inference: /predict 512 x 512 x {n_slices} CT "
              f"(postprocessing) {walls['predict']:.3f} s wall, server "
              f"{res['seconds']} s; host steps "
              + json.dumps({k: round(v, 3) for k, v in host.items()})
              + "; device phases ms (CUDA events) "
              + json.dumps({k: round(v, 3) for k, v in phases.items()}))
        img, hdr_in = read_nifti(big)
        seg, hdr_out = read_nifti(seg_art)
        same_geometry = (seg.shape == img.shape and all(
            np.allclose(hdr_in[k], hdr_out[k]) for k in
            ("pixdim", "srow_x", "srow_y", "srow_z")))
        labels = np.unique(seg)
        check(same_geometry and labels.min() >= 0
              and labels.max() < TRAIN_K, f"/predict mask {seg.shape} "
              f"labels {labels.min()}..{labels.max()}")

        # the model-folder route on the same case, same bf16 network, held
        # against the artifact route's mask before postprocessing
        check(len(pre_pp) == 1, "postprocessing input not captured")
        t0 = time.perf_counter()
        folder_inf = FastnnUNetInferencer(model_folder=model, folds=(0,),
                                          device=dev)
        seg_fold = join(root, "out_folder", "ct_big.nii.gz")
        maybe_mkdir_p(os.path.dirname(seg_fold))
        folder_inf.predict_single_image(big, seg_fold)
        walls["model_folder"] = time.perf_counter() - t0
        fold_seg = NiftiIOWithReorient().read_seg(seg_fold)[0][0]
        agree = float((fold_seg == pre_pp[0]).mean())
        del folder_inf, fold_seg, pre_pp
        print(f"fast_inference: model-folder route (no postprocessing) "
              f"{walls['model_folder']:.3f} s; artifact vs model-folder "
              f"mask agreement {agree:.6f} on {seg.shape}, {len(labels)} "
              f"labels present after postprocessing")
        check(agree >= 0.999, f"artifact / model-folder agreement {agree}")
        out["agreement"] = agree
        del img, seg

        # /predict_array: one preprocessed f32 volume, logits back
        vol = np.random.RandomState(1).randn(*FAST_ARRAY_SHAPE).astype(
            np.float32)
        t0 = time.perf_counter()
        code, hdrs, body = _http(port, "POST", "/predict_array", vol.tobytes(),
                                 {"X-Shape": ",".join(map(str, vol.shape)),
                                  "Content-Type": "application/octet-stream"})
        walls["predict_array"] = time.perf_counter() - t0
        check(code == 200 and int(hdrs["X-Num-Class"]) == TRAIN_K,
              f"/predict_array {code} {hdrs}")
        served = np.frombuffer(body, np.float32).reshape(
            TRAIN_K, *FAST_ARRAY_SHAPE)
        t0 = time.perf_counter()
        local = inferencer.predict_logits_from_preprocessed(vol[None])
        walls["in_process_logits"] = time.perf_counter() - t0
        bit_equal = bool(np.array_equal(served.view(np.uint32),
                                        local.view(np.uint32)))
        print(f"fast_inference: /predict_array {FAST_ARRAY_SHAPE} f32 -> "
              f"{len(body) / 1e9:.3f} GB of logits in "
              f"{walls['predict_array']:.3f} s (in process "
              f"{walls['in_process_logits']:.3f} s); bit-equal to the "
              f"in-process logits: {bit_equal}")
        check(bit_equal and np.isfinite(local).all(),
              "/predict_array differs from predict_logits_from_preprocessed")
        del served, local, body

        # /predict with VTK on a small CT
        small = join(root, "ct_small.nii.gz")
        write_ct(small, FAST_SMALL_CT, seed=1)
        vtk_out = join(root, "out_vtk", "ct_small.nii.gz")
        maybe_mkdir_p(os.path.dirname(vtk_out))
        t0 = time.perf_counter()
        code, _, body = _http(port, "POST", "/predict", json.dumps({
            "input_file": small, "output_file": vtk_out,
            "generate_vtk": True}).encode())
        walls["predict_vtk"] = time.perf_counter() - t0
        res = json.loads(body)
        check(code == 200 and "vtk_model" in res, f"/predict vtk {res}")
        with open(res["vtk_model"]) as f:
            head = f.read(64)
        vtk_bytes = os.path.getsize(res["vtk_model"])
        print(f"fast_inference: /predict {FAST_SMALL_CT} CT with VTK "
              f"{walls['predict_vtk']:.3f} s (VTK "
              f"{inferencer.timings.get('vtk_s', float('nan')):.3f} s, "
              f"{vtk_bytes} B, {len(res['labels_present'])} labels)")
        check(head.startswith("# vtk DataFile"), f"vtk header {head!r}")

        # /predict_batch over a folder of two small CTs
        batch_in, batch_out = join(root, "batch_in"), join(root, "batch_out")
        maybe_mkdir_p(batch_in)
        for i in range(2):
            write_ct(join(batch_in, f"case_{i}.nii.gz"), FAST_SMALL_CT,
                     seed=2 + i)
        t0 = time.perf_counter()
        code, _, body = _http(port, "POST", "/predict_batch", json.dumps({
            "input_folder": batch_in, "output_folder": batch_out}).encode())
        walls["predict_batch"] = time.perf_counter() - t0
        results = json.loads(body).get("results", [])
        check(code == 200 and len(results) == 2 and all(
            os.path.isfile(r["output"]) for r in results),
            f"/predict_batch {code} {body[:300]!r}")
    finally:
        api.shutdown()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread still running")
    peak = torch.cuda.max_memory_allocated()
    del inferencer

    # ---- fast_nnunet_jhu_predict_torch on the same model folder, one case
    jhu_in, jhu_out = join(root, "jhu_in"), join(root, "jhu_out")
    maybe_mkdir_p(join(jhu_in, "case_0"))
    shutil.copyfile(small, join(jhu_in, "case_0", "ct.nii.gz"))
    t0 = time.perf_counter()
    jhu_predict_entry([jhu_in, jhu_out, "-model", model, "-f", "0",
                       "--device", str(dev)])
    walls["jhu"] = time.perf_counter() - t0
    files = sorted(os.listdir(join(jhu_out, "case_0", "predictions")))
    print(f"fast_inference: fast_nnunet_jhu_predict_torch (mirror TTA) on "
          f"one {FAST_SMALL_CT} case: {len(files)} class files in "
          f"{walls['jhu']:.3f} s")
    check(len(files) == TRAIN_K - 1, f"JHU wrote {len(files)} class files")

    out.update(walls_s=walls, predict_host_s=host, predict_device_ms=phases,
               peak_gib=peak / 2**30, n_slices=n_slices,
               wall_s=time.perf_counter() - t_phase)
    print(f"fast_inference: seconds per request "
          + json.dumps({k: round(v, 3) for k, v in walls.items()})
          + f"; peak device memory while serving {peak / 2**30:.2f} GiB; "
          f"phase wall {out['wall_s']:.3f} s")
    print(json.dumps({"fast_inference": out}))
    return out



# ------------------------------------------------------------------ aot
ENGINE_CT = (192, 192, 160)   # phase 19(c): the native engine's CT (i, j, k)


def _wrap_timed(module, name, log):
    """Replace ``module.name`` by a shim that appends its seconds to
    ``log``; returns the original (the caller restores it)."""
    real = getattr(module, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            log.append(time.perf_counter() - t0)
    setattr(module, name, timed)
    return real


def start_phase19_worker():
    """Start phase 19's worker (``chip_smoke.py --phase19-build ROOT``) in
    a process of its own at a lower priority, in a temporary root. It
    does phase 19's host work, which then overlaps the phases that run
    meanwhile: the native engine's build, the AOTInductor compile of phase
    2's student into the package cache ROOT/cache and the ``--aoti`` export
    of phase 14's student (:func:`phase19_build_main`). Its work on the
    card is what those compiles need: the weights uploaded, Inductor's
    constant folding and compile-time benchmarks, and one forward of 8
    zero tiles through the new package. Everything timed on the card in
    phase 19 (CTs, the engine, the Python sweeps) runs in the main process
    after it has joined the worker. Returns (process, root); the process
    is killed at exit if it still runs."""
    import atexit
    import tempfile
    root = tempfile.mkdtemp(prefix="fnn_chip_smoke_phase19_")
    log = open(os.path.join(root, "worker.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--phase19-build", root], stdout=log,
                            stderr=subprocess.STDOUT,
                            preexec_fn=lambda: os.nice(10))
    log.close()
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, root


def phase19_build_main(argv):
    """``chip_smoke.py --phase19-build ROOT``: (1) the kernels and the native
    engine built; (2) phase 2's student (its pipeline's engine, fold 0, the
    sweep's tile batch) compiled into the package cache ROOT/cache through
    ``SlidingWindowEngine.fold_forward``; (3) phase 14's student written to
    ROOT/model and exported with ``aoti=True`` (bf16, B = 8) on the card
    into ROOT/export, its validation left to phase 19(c). Results go to
    ROOT/build.json."""
    import torch
    sys.path.insert(0, HERE)
    from fast_nnunet_tpu_torch.export.export_model import \
        export_model_folder_to_artifact
    from fast_nnunet_tpu_torch.inference import aot
    from fast_nnunet_tpu_torch.ops import _build
    (root,) = argv
    dev = torch.device("cuda")
    out = {}
    t0 = time.perf_counter()
    _build.library()
    _build.engine_binary()
    out["engine_build_s"] = time.perf_counter() - t0

    make_pipe, tree, _ = phase2_pipeline(torch, dev)
    engine, _ = make_pipe(os.path.join(root, "cache"))
    engine.load_params(tree)
    compile_s, export_s = [], []
    _wrap_timed(aot, "compile_package", compile_s)
    _wrap_timed(aot, "export_program", export_s)
    tiles = torch.zeros((engine.tile_batch, 1, *engine.patch_size),
                        dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        engine.fold_forward(0, tiles, return_features=True)
    out.update(aot_export_s=sum(export_s), aot_compile_s=sum(compile_s),
               aot_compiles=len(compile_s))
    del engine, tiles
    torch.cuda.empty_cache()

    model = os.path.join(root, "model")
    write_student_model_folder(model)
    st = {}
    t0 = time.perf_counter()
    export_model_folder_to_artifact(model, 0, os.path.join(root, "export"),
                                    batch_size=8, dtype="bfloat16",
                                    device=dev, stats=st, aoti=True,
                                    validate=False)
    out["export"] = dict(st, wall_s=time.perf_counter() - t0)
    with open(os.path.join(root, "build.json"), "w") as f:
        json.dump(out, f)
    return 0


def join_phase19_worker(worker, timeout=1200):
    """Wait for the worker; returns (its build.json, seconds waited)."""
    proc, root = worker
    t0 = time.perf_counter()
    rc = proc.wait(timeout=timeout)
    waited = time.perf_counter() - t0
    with open(os.path.join(root, "worker.log")) as f:
        log = f.read()
    check(rc == 0, f"phase 19's worker failed (exit {rc}):\n" + log[-5000:])
    with open(os.path.join(root, "build.json")) as f:
        return json.load(f), waited


def aot_path(torch, dev, make_pipe, tree, ct, spacing, seg_eager, launches,
             wall_eager, kernels, worker):
    """Phase 19 (a, b; ``aot:``, ``trace:`` lines): the worker joined, its
    package cache loaded here on phase 2's route, and a trace of phase 2's
    CT attributed by utils/trace_analysis.py (docstring step 19). Returns
    the worker's results for phase 19(c)."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="fnn_chip_smoke_aot_")
    try:
        built, waited = join_phase19_worker(worker)
        out = {"aot": _aot_cache(torch, make_pipe, tree, ct, spacing,
                                 seg_eager, launches, wall_eager, kernels,
                                 worker[1], built, waited)}
        torch.cuda.empty_cache()
        out["trace"] = _trace(torch, make_pipe, tree, ct, spacing, launches,
                              kernels, root)
        print(json.dumps({"aot_phase": out}))
        return built
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _aot_cache(torch, make_pipe, tree, ct, spacing, seg_eager, launches,
               wall_eager, kernels, worker_root, built, waited):
    """Phase 19(a). The package was compiled by the worker, so this process
    is a fresh interpreter to it: compiling is switched off, and the load
    must leave the package's mtime unchanged and log ``loaded ... no
    compile``."""
    import logging
    from fast_nnunet_tpu_torch.inference import aot

    cache = os.path.join(worker_root, "cache")
    t_phase = time.perf_counter()
    pkgs = sorted(f for f in os.listdir(cache) if f.endswith(".pt2"))
    check(built["aot_compiles"] == 1 and len(pkgs) == 1,
          f"aot: the worker made {built['aot_compiles']} compiles, "
          f"packages {pkgs}")
    pkg = os.path.join(cache, pkgs[0])
    mb = os.path.getsize(pkg) / 2**20
    mode = oct(os.stat(cache).st_mode & 0o777)
    print(f"aot: the worker process (a fresh aot_cache, phase 2's student "
          f"at its tile batch; started after phase 3 at a lower priority, "
          f"{waited:.3f} s waited for here): export "
          f"{built['aot_export_s']:.3f} s, AOTInductor compile "
          f"{built['aot_compile_s']:.3f} s, package {pkgs[0]} {mb:.1f} MB "
          f"(cache dir {mode})")
    check(mode == "0o700", f"aot cache dir mode {mode}")
    _, pipe = make_pipe(cache)
    eager_pipe = make_pipe("")[1]
    messages, compiles, export_s, load_s = [], [], [], []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    def no_compile(*a, **k):
        compiles.append(1)
        raise SmokeFailure("aot: this process tried to compile")
    keep, level = Keep(), aot.logger.level
    aot.logger.addHandler(keep)
    aot.logger.setLevel(logging.INFO)
    real_c, aot.compile_package = aot.compile_package, no_compile
    real_e = _wrap_timed(aot, "export_program", export_s)
    real_l = _wrap_timed(aot, "load_package", load_s)
    mtime = os.stat(pkg).st_mtime_ns
    try:
        t0 = time.perf_counter()
        seg0 = pipe.predict_volume(tree, ct, spacing)
        first = time.perf_counter() - t0
    finally:
        aot.compile_package, aot.export_program = real_c, real_e
        aot.load_package = real_l
        aot.logger.removeHandler(keep)
        aot.logger.setLevel(level)
    logged = any("loaded" in m and "no compile" in m for m in messages)
    same = os.stat(pkg).st_mtime_ns == mtime
    print(f"aot: TurboPipeline (device route) on that cache in this "
          f"process, a fresh interpreter to the package (compiling switched "
          f"off): first CT {first:.3f} s with export {sum(export_s):.3f} s "
          f"and load {sum(load_s):.3f} s, {len(compiles)} compiles, log says "
          f"loaded: {logged}, package mtime unchanged: {same}")
    check(not compiles and len(load_s) == 1 and logged and same,
          f"aot: this process compiled {len(compiles)} times, loaded "
          f"{len(load_s)}, logged {logged}, mtime unchanged {same}")

    for fn in kernels.values():
        fn.launches = 0
    seg = pipe.predict_volume(tree, ct, spacing)
    got = {name: fn.launches for name, fn in kernels.items()}
    agree = float((seg == seg_eager).mean())
    repeat = float((seg == seg0).mean())
    print(f"aot: launches per CT {json.dumps(got)} (eager {json.dumps(launches)}"
          f"); mask vs phase 2's eager mask: agreement {agree:.6f}; vs the "
          f"first aot run {repeat:.6f}")
    check(got == launches, f"aot route launched {got}, eager {launches}: a "
          "kernel was compiled away or added")
    check(agree >= 0.999, f"aot vs eager mask agreement {agree} < 0.999")
    check(repeat >= 0.999, f"aot first vs second CT agreement {repeat}")

    walls = {"eager": [], "aot": []}
    for name in ("eager", "aot", "aot", "eager"):
        p = eager_pipe if name == "eager" else pipe
        t0 = time.perf_counter()
        p.predict_volume(tree, ct, spacing)
        walls[name].append(time.perf_counter() - t0)
    print(f"aot: warm seconds per CT, in turns (eager, aot, aot, eager): "
          f"eager {[round(w, 4) for w in walls['eager']]}, aot "
          f"{[round(w, 4) for w in walls['aot']]} (phase 2's eager "
          f"{[round(w, 4) for w in wall_eager]}; a record, not a claim)")
    return {"export_s": built["aot_export_s"],
            "compile_s": built["aot_compile_s"], "waited_s": waited,
            "package_mb": mb, "first_ct_s": first,
            "first_ct_export_s": sum(export_s), "load_s": sum(load_s),
            "compiles": len(compiles), "logged_loaded": logged,
            "mtime_same": same, "launches": got,
            "agreement_vs_eager": agree, "agreement_first_second": repeat,
            "walls_s": walls, "wall_s": time.perf_counter() - t_phase}


def _trace(torch, make_pipe, tree, ct, spacing, launches, kernels, root):
    """Phase 19(b): one warm CT of phase 2 inside ``maybe_trace``, then a
    small plain sweep through kernel D in a second trace; both attributed
    by ``attribute_trace``."""
    import numpy as np
    from fast_nnunet_tpu_torch.inference.engine import (PhaseTimer,
                                                        SlidingWindowEngine)
    from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
    from fast_nnunet_tpu_torch.models.s2d import random_plain_params
    from fast_nnunet_tpu_torch.ops import scatter_accumulate as kd
    from fast_nnunet_tpu_torch.utils.profiling import maybe_trace
    from fast_nnunet_tpu_torch.utils.trace_analysis import (
        HAND_KERNELS, attribute_trace, format_attribution)

    engine, pipe = make_pipe("")
    pipe.predict_volume(tree, ct, spacing)  # warm
    ct_dir = os.path.join(root, "trace_ct")
    for fn in kernels.values():
        fn.launches = 0
    engine.timer = PhaseTimer()
    t0 = time.perf_counter()
    with maybe_trace(ct_dir):
        pipe.predict_volume(tree, ct, spacing)
        torch.cuda.synchronize()
    traced = time.perf_counter() - t0
    phases = device_ms(engine.timer.totals())
    engine.timer = None
    counted = {n: fn.launches for n, fn in kernels.items()}
    att = attribute_trace(ct_dir)
    print(f"trace: one warm CT of phase 2 under torch.profiler "
          f"({traced:.3f} s wall with the profiler on)\n"
          + format_attribution(att))
    by_name = dict(zip((n for n, _ in HAND_KERNELS),
                       ("spatial_sum_sumsq", "grouped_argmax",
                        "s2d_accumulate", None)))
    for bucket, name in by_name.items():
        if name is None:
            continue
        n = att["launches"].get(bucket, 0)
        check(n == counted[name] == launches[name],
              f"trace: {bucket} {n} launches in the trace, wrapper "
              f"{counted[name]}, phase 2 {launches[name]}")
    phase_sum = sum(phases.values()) / 1e3
    print(f"trace: device busy {att['busy_s']:.4f} s (leaf sum "
          f"{att['total_s']:.4f} s) in a {att['window_s']:.4f} s device "
          f"window, idle share {att['idle_share']:.4f}; CUDA-event phase sum "
          f"{phase_sum:.4f} s " + json.dumps(
              {k: round(v, 3) for k, v in phases.items()}))

    d_dir = os.path.join(root, "trace_d")
    vol = np.random.RandomState(2).randn(1, 40, 72, 88).astype(np.float32)
    net = get_network_from_plans("PlainConvUNet", SMALL_ARCH, (), 1, 4,
                                 compute_dtype=torch.float32).to("cuda")
    eng = SlidingWindowEngine(net, (16, 32, 32), 4,
                              compute_dtype=torch.float32,
                              sweep_acc_dtype=torch.float32, tile_batch=2,
                              use_fused_accumulate=True, device="cuda")
    tree_s = random_plain_params(SMALL_ARCH, 1, 4, seed=2)
    eng.predict_segmentation_sweep(tree_s, vol)  # warm
    n0 = kd.fused_scatter_accumulate.launches
    with maybe_trace(d_dir):
        eng.predict_segmentation_sweep(tree_s, vol)
        torch.cuda.synchronize()
    n_d = kd.fused_scatter_accumulate.launches - n0
    att_d = attribute_trace(d_dir)
    d_bucket = HAND_KERNELS[3][0]
    print(f"trace: small fused plain sweep (phase 6's, patch (16, 32, 32)): "
          f"{d_bucket} {att_d['launches'].get(d_bucket, 0)} launches in the "
          f"trace, {n_d} counted by its wrapper, "
          f"{dict(att_d['buckets']).get(d_bucket, 0.0):.6f} s")
    check(att_d["launches"].get(d_bucket, 0) == n_d > 0,
          "trace: kernel D missing from its trace")
    return {"buckets": att["buckets"], "launches": att["launches"],
            "total_s": att["total_s"], "busy_s": att["busy_s"],
            "window_s": att["window_s"], "idle_share": att["idle_share"],
            "phase_sum_s": phase_sum, "traced_wall_s": traced,
            "d_launches": n_d}


def native_engine_path(torch, dev, worker, built, predict_s=None):
    """Phase 19(c) (``engine:`` lines), after phase 14: the worker's
    ``--aoti`` export of phase 14's student validated here (the package
    against ``model.pt2`` run eagerly, the exporter's 1e-2 bound); the C++
    engine's ``--aoti`` run on a CT at the INI's target spacing; the port's
    Python engine over the same INI pipeline on ``model.pt2`` (the eager
    network: the gate, >= 0.995) and on the package; their seconds beside
    phase 14's ``/predict``. The worker's root is removed afterwards."""
    import shutil
    import numpy as np
    from fast_nnunet_tpu_torch.export.export_model import (
        AOTI_ARTIFACT, ARTIFACT, validate_exported_artifact)
    from fast_nnunet_tpu_torch.imageio.nifti import read_nifti, write_nifti
    from fast_nnunet_tpu_torch.inference import aot
    from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
    from fast_nnunet_tpu_torch.ops import _build
    from fast_nnunet_tpu_torch.utils.io import join, load_json
    from fast_nnunet_tpu_torch.utils.synthetic_ct import make_synthetic_ct

    proc, root = worker
    try:
        st = built["export"]
        export = join(root, "export")
        meta = load_json(join(export, "model_config.json"))
        pkg = join(export, AOTI_ARTIFACT)
        mb = os.path.getsize(pkg) / 2**20
        nets = {"model.pt2": torch.export.load(join(export, ARTIFACT))
                .module(), "package": aot.load_package(pkg)}
        code = nets["model.pt2"].code
        in_shape = meta["input_shape"]
        t0 = time.perf_counter()
        rel = validate_exported_artifact(pkg, nets["model.pt2"], in_shape,
                                         torch.bfloat16, dev,
                                         load=lambda p: nets["package"])
        validate_s = time.perf_counter() - t0
        print(f"engine: student exported with --aoti on the card in the "
              f"worker process ({st['wall_s']:.3f} s): torch.export "
              f"{st['export_s']:.3f} s, AOTInductor compile "
              f"{st['aoti_s']:.3f} s ({AOTI_ARTIFACT} {mb:.1f} MB); here "
              f"the package against {ARTIFACT} run eagerly on a seeded "
              f"{tuple(in_shape)} batch: max relative deviation {rel:.3e} "
              f"(bound 1e-2; {validate_s:.3f} s); sidecar aoti_artifact "
              f"{meta.get('aoti_artifact')}, aoti_device "
              f"{meta.get('aoti_device')}; the exported graph holds "
              f"{code.count('fnn_torch.instance_norm')} norm ops")
        check(meta.get("aoti_artifact") == AOTI_ARTIFACT
              and str(meta.get("aoti_device")).startswith("cuda")
              and "fnn_torch.instance_norm" in code,
              f"engine: native artifact {meta}")
        print(f"engine: fast_nnunet_engine built against torch's libraries "
              f"with {os.path.basename(_build.torch_cxx())} in the worker "
              f"(with the kernels) in {built['engine_build_s']:.3f} s")

        ini = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
        ini.read(os.path.join(HERE, "engine", "config",
                              "fast_nnunet_bone_turbo.ini"))
        pp = ini["preprocessing"]
        lo, hi = pp.getfloat("lower_bound"), pp.getfloat("upper_bound")
        mean, std = pp.getfloat("mean"), pp.getfloat("std")
        # the CT at the target spacing: the engine's resampling is the
        # identity
        spacing = tuple(float(s) for s in TRAIN_SPACING)
        img, _ = make_synthetic_ct(ENGINE_CT, spacing, seed=3)
        ct = join(root, "engine_ct.nii.gz")
        write_nifti(ct, img, spacing=spacing)
        cfg = join(root, "engine.ini")
        with open(cfg, "w") as f:
            f.write(f"[model]\nnum_class={TRAIN_K}\n[input]\npatch_size="
                    f"{'x'.join(str(p) for p in TRAIN_PATCH)}\n"
                    f"target_spacing=({','.join(repr(s) for s in spacing)})"
                    f"\n[preprocessing]\nmean={mean!r}\nstd={std!r}\n"
                    f"lower_bound={lo!r}\nupper_bound={hi!r}\n[inference]\n"
                    f"step_size=0.5\nuse_gaussian=true\ntile_batch=8\n")
        mask_path = join(root, "engine_mask.nii.gz")
        t0 = time.perf_counter()
        run = subprocess.run([_build.engine_binary(), "--config", cfg,
                              "--input", ct, "--output", mask_path, "--aoti",
                              pkg], capture_output=True, text=True,
                             timeout=900)
        engine_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise SmokeFailure("engine: --aoti run failed:\n"
                               + run.stdout[-2000:] + run.stderr[-4000:])
        mask = np.asarray(read_nifti(mask_path)[0])

        # the port's Python engine on the same INI pipeline: on model.pt2
        # (the eager network), then on the package (the C++ engine's)
        pre = (np.clip(img.astype(np.float32), np.float32(lo),
                       np.float32(hi)) - np.float32(mean)) \
            * np.float32(1.0 / std)
        agree, python_s = {}, {}
        for name in ("model.pt2", "package"):
            eng = SlidingWindowEngine(nets[name], TRAIN_PATCH, TRAIN_K,
                                      tile_step_size=0.5, use_gaussian=True,
                                      compute_dtype=torch.bfloat16,
                                      acc_dtype=torch.float32, shape_bucket=1,
                                      tile_batch=8, pad_to_tile_batch=True,
                                      device=dev)
            t0 = time.perf_counter()  # one run each, cold (a record)
            want = eng.predict_segmentation([{}], pre[None])
            python_s[name] = time.perf_counter() - t0
            agree[name] = float((mask == want).mean())
        labels = len(set(np.unique(mask).tolist()))
        print(f"engine: --aoti on {tuple(img.shape)} int16 CT: "
              f"{engine_s:.3f} s process wall ({run.stdout.strip()}); the "
              f"port's Python engine, same grid: on {ARTIFACT} "
              f"{python_s['model.pt2']:.3f} s, on the package "
              f"{python_s['package']:.3f} s; phase 14's /predict (512 x 512 "
              f"x {FAST_CT_SLICES}, file to file): "
              f"{'not run' if predict_s is None else f'{predict_s:.3f} s'}; "
              f"mask agreement with the Python engine on {ARTIFACT} "
              f"{agree['model.pt2']:.6f}, on the package "
              f"{agree['package']:.6f} ({labels} labels)")
        check(rel <= 1e-2, f"engine: package vs {ARTIFACT} max rel {rel}")
        check(mask.shape == img.shape, f"engine mask {mask.shape}")
        check(agree["model.pt2"] >= 0.995,
              f"engine vs the eager network agreement {agree['model.pt2']}")
        check(agree["package"] >= 0.995,
              f"engine vs Python engine agreement {agree['package']}")
        check(labels > 1, "engine mask has a single label")
        out = {"export": dict(st, aoti_max_rel=rel,
                              aoti_validate_s=validate_s),
               "aoti_artifact": meta.get("aoti_artifact"),
               "aoti_device": meta.get("aoti_device"), "package_mb": mb,
               "engine_s": engine_s, "engine_stdout": run.stdout.strip(),
               "mask_shape": list(mask.shape), "ct_shape": list(img.shape),
               "labels": labels, "python_s": python_s, "agreement": agree,
               "engine_build_s": built["engine_build_s"],
               "predict_s": predict_s}
        print(json.dumps({"engine_phase": out}))
        return out
    finally:
        if proc.poll() is None:
            proc.kill()
        shutil.rmtree(root, ignore_errors=True)


def share_path(torch, results_root):
    """Phase 19(d) (``share:``), in phase 11's root: the planned teacher's
    fold 0 zipped with ``fast_nnunet_export_model_to_zip_torch``, installed
    with ``fast_nnunet_install_pretrained_model_from_zip_torch`` into a
    fresh results root, and every file compared byte for byte."""
    import filecmp
    import tempfile
    from fast_nnunet_tpu_torch.utils.model_sharing import (export_entry,
                                                           install_entry)
    folder = "NNUNetTrainer__nnUNetPlans__3d_fullres"
    t0 = time.perf_counter()
    fresh = tempfile.mkdtemp(prefix="fnn_chip_smoke_share_")
    old = os.environ["nnUNet_results"]
    try:
        zip_path = os.path.join(fresh, "model.zip")
        export_entry([str(PIPELINE_DS_ID), "-o", zip_path, "-c",
                      "3d_fullres", "-f", "0"])
        os.environ["nnUNet_results"] = os.path.join(fresh, "results")
        os.makedirs(os.environ["nnUNet_results"])
        install_entry([zip_path])
        names = []
        for rel in ("plans.json", "dataset.json",
                    os.path.join("fold_0", "checkpoint_final.fnnx")):
            a = os.path.join(results_root, PIPELINE_DS, folder, rel)
            b = os.path.join(os.environ["nnUNet_results"], PIPELINE_DS,
                             folder, rel)
            check(os.path.isfile(b) and filecmp.cmp(a, b, shallow=False),
                  f"share: {rel} differs after the zip round trip")
            names.append(rel)
        mb = os.path.getsize(zip_path) / 2**20
    finally:
        os.environ["nnUNet_results"] = old
        import shutil
        shutil.rmtree(fresh, ignore_errors=True)
    wall = time.perf_counter() - t0
    print(f"share: {PIPELINE_DS} {folder} fold 0 zipped ({mb:.1f} MB) and "
          f"installed into a fresh results root in {wall:.3f} s; "
          f"{len(names)} files equal byte for byte: {names}")
    return {"files": names, "zip_mb": mb, "wall_s": wall}


# ------------------------------------------------------------------ multi
MULTI_PLAIN_SIZE = 256   # phase 18(b): the plain slab sweep's volume edge
MULTI_ITERS, MULTI_WARM = 7, 1   # phase 18(d): 6 + 1 iterations


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def halo_rows(starts, owned, p0, D, x_extent):
    """Rows past each slab boundary that tiles starting left of it reach
    (their sums take a neighbour's subtotal last)."""
    import numpy as np
    rows = np.zeros(x_extent, bool)
    for d in range(1, D):
        b = d * owned
        spill = max((s + p0 for s in starts if s < b), default=0)
        rows[b:min(spill, x_extent)] = True
    return rows


def _multi_engine(torch, kind, dev):
    """Phase 2's student as the s2d engine (kind "s2d": bf16, patch
    160x96x96, tile batch 8) or phase 4's plain engine with kernel D
    ("plain"), on ``dev``, with its seed-0 weights."""
    from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
    from fast_nnunet_tpu_torch.inference.turbo import TurboConfig
    from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
    from fast_nnunet_tpu_torch.models.s2d import (make_s2d_engine_net,
                                                  random_plain_params)
    from fast_nnunet_tpu_torch.models.students import \
        build_student_arch_kwargs
    cfg = TurboConfig.from_ini(os.path.join(
        HERE, "engine", "config", "fast_nnunet_bone_turbo.ini"))
    K = cfg.num_classes
    arch = build_student_arch_kwargs(TEACHER_ARCH, 2)
    if kind == "s2d":
        net = make_s2d_engine_net(arch, K, 1, compute_dtype=torch.bfloat16)
        net.to(dev)
        tree = net.convert_params(random_plain_params(arch, 1, K, seed=0))
        return SlidingWindowEngine(
            net, cfg.patch_size, K, tile_step_size=cfg.step_size,
            use_gaussian=cfg.use_gaussian, compute_dtype=torch.bfloat16,
            sweep_acc_dtype=torch.bfloat16, shape_bucket=32, tile_batch=8,
            device=dev), tree, cfg
    net = get_network_from_plans("PlainConvUNet", arch, (), 1, K,
                                 compute_dtype=torch.bfloat16).to(dev)
    return SlidingWindowEngine(
        net, (96, 96, 160), K, tile_step_size=0.5, use_gaussian=True,
        compute_dtype=torch.bfloat16, sweep_acc_dtype=torch.bfloat16,
        shape_bucket=32, tile_batch=8, use_fused_accumulate=True,
        device=dev), random_plain_params(arch, 1, K, seed=0), cfg


def _single_sweep(torch, engine, tree, kind, vol):
    """(mask, seconds, peak GiB) of the single-card sweep, after a warm
    run."""
    run = engine.predict_segmentation_sweep_s2d if kind == "s2d" \
        else engine.predict_segmentation_sweep
    run(tree, vol)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seg = run(tree, vol)
    return (seg, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30)


def _multi_sweep_rank(kind, vol, modes):
    """One rank of the slab-parallel sweep of ``kind`` on its card: a warm
    run that captures one kernel call of each of the path's kernels at the
    rank's slab shapes, then one counted, timed run per mode (halo_exact
    False / True), then the captured calls against the plain versions."""
    import torch
    import fast_nnunet_tpu_torch.inference.engine as engine_module
    from fast_nnunet_tpu_torch.inference import sharded
    from fast_nnunet_tpu_torch.ops import finalize as kb
    from fast_nnunet_tpu_torch.ops import s2d_accumulate as kc
    from fast_nnunet_tpu_torch.ops import scatter_accumulate as kd
    from fast_nnunet_tpu_torch.ops import stats as ka
    from fast_nnunet_tpu_torch.parallel import rank
    dev = torch.device("cuda", torch.cuda.current_device())
    engine, tree, _ = _multi_engine(torch, kind, dev)
    fn = sharded.predict_segmentation_multigpu_s2d if kind == "s2d" \
        else sharded.predict_segmentation_multigpu
    cap = {}
    real = {"c": engine_module.s2d_accumulate, "b": sharded.grouped_argmax,
            "d": engine_module.fused_scatter_accumulate}

    def c(acc, feats, g, w, b, coords, valid, row_base=0):
        cap.setdefault("c", (acc.clone(), feats.clone(), g, w, b,
                             coords.copy(), valid.copy(), row_base))
        return real["c"](acc, feats, g, w, b, coords, valid, row_base)

    def b(acc, num_classes, n_rows, row_base=0, n_zero=0):
        cap.setdefault("b", (acc.clone(), num_classes, n_rows, row_base,
                             n_zero))
        return real["b"](acc, num_classes, n_rows, row_base, n_zero)

    def d(acc, logits, gauss_flat, coords, n):
        cap.setdefault("d", (acc.clone(), logits.clone(), gauss_flat,
                             coords.copy(), n))
        return real["d"](acc, logits, gauss_flat, coords, n)

    engine_module.s2d_accumulate, sharded.grouped_argmax = c, b
    engine_module.fused_scatter_accumulate = d
    try:
        fn(engine, tree, vol)
    finally:
        engine_module.s2d_accumulate = real["c"]
        sharded.grouped_argmax = real["b"]
        engine_module.fused_scatter_accumulate = real["d"]
    kernels = {"A": ka.spatial_sum_sumsq, "B": kb.grouped_argmax,
               "C": kc.s2d_accumulate, "D": kd.fused_scatter_accumulate}
    out = {"rank": rank(), "masks": {}, "launches": {}, "seconds": {},
           "peak_gib": {}}
    for exact in modes:
        for f in kernels.values():
            f.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        seg = fn(engine, tree, vol, halo_exact=exact)
        torch.cuda.synchronize()
        out["seconds"][exact] = time.perf_counter() - t0
        out["peak_gib"][exact] = torch.cuda.max_memory_allocated() / 2**30
        out["launches"][exact] = {k: f.launches for k, f in kernels.items()}
        out["masks"][exact] = seg
    K = engine.num_classes
    errs = {}
    if "c" in cap:
        acc, feats, g, w, bb, coords, valid, rb = cap["c"]
        a_k, a_p = acc.clone(), acc.clone()
        kc.s2d_accumulate(a_k, feats, g, w, bb, coords, valid, rb)
        kc.s2d_accumulate_plain(a_p, feats, g, w, bb, coords, valid, rb)
        errs["C"] = (float((a_k.float() - a_p.float()).abs().max()),
                     torch.equal(a_k, a_p), tuple(acc.shape))
    if "b" in cap:
        acc, _, n_rows, rb, nz = cap["b"]
        k1 = kb.grouped_argmax(acc.clone(), K, n_rows, rb, nz)
        p1 = kb.grouped_argmax_plain(acc.clone(), K, n_rows, rb, nz)
        errs["B"] = (float((k1.int() - p1.int()).abs().max()),
                     torch.equal(k1, p1), tuple(acc.shape))
    if "d" in cap:
        acc, lg, gf, coords, n = cap["d"]
        a_k, a_p = acc.clone(), acc.clone()
        kd.fused_scatter_accumulate(a_k, lg, gf, coords, n)
        kd.fused_scatter_accumulate_plain(a_p, lg, gf, coords, n)
        errs["D"] = (float((a_k.float() - a_p.float()).abs().max()),
                     torch.equal(a_k, a_p), tuple(acc.shape),
                     coords[:n, 0].tolist())
    out["captured"] = errs
    del cap, engine
    torch.cuda.empty_cache()
    return out


def _multi_sweep_checks(torch, kind, vol, card, backend, modes, single,
                        res):
    """Phase 18's sweep checks on the ranks' results ``res`` of
    :func:`_multi_sweep_rank` against the single-card sweep ``single`` =
    (mask, seconds, peak GiB): rows outside the halo bit-equal and >= 0.999
    overall in the parallel mode, every row in the exact mode (and at
    world 1); each rank launched its path's kernels and its captured calls
    equal the plain versions."""
    import numpy as np
    from fast_nnunet_tpu_torch.inference.engine import _round_up
    world = len(res)
    engine, _, _ = _multi_engine(torch, kind, torch.device("cpu"))
    spatial = vol.shape[1:]
    if kind == "s2d":
        vol_shape, steps = engine.s2d_sweep_plan(spatial)
        starts = steps[0]
        owned = _round_up(-(-vol_shape[0] // world), 2)
    else:
        vol_shape, starts, _, _, _ = engine._sweep_grid(spatial)
        owned = -(-vol_shape[0] // world)
    halo = halo_rows(starts, owned, engine.patch_size[0], world, spatial[0])
    seg1, s1, p1 = single
    out = {"world": world, "backend": backend, "volume": list(vol.shape),
           "owned_rows": owned, "halo_rows": int(halo.sum()),
           "single_s": s1, "single_peak_gib": p1, "ranks": []}
    path_kernels = ("A", "B", "C") if kind == "s2d" else ("D",)
    for r in res:
        check(all(r["launches"][m][k] > 0 for m in modes
                  for k in path_kernels),
              f"multi: {kind} rank {r['rank']} launches {r['launches']}")
        for k in ("B", "C") if kind == "s2d" else ("D",):
            check(k in r["captured"] and r["captured"][k][1],
                  f"multi: {kind} rank {r['rank']} captured kernel {k} "
                  f"differs from its plain version: {r['captured'].get(k)}")
        out["ranks"].append({k: r[k] for k in ("rank", "launches", "seconds",
                                               "peak_gib", "captured")})
        print(f"multi: {kind} rank {r['rank']}/{world} ({backend}): sweep s "
              + json.dumps({str(m): round(v, 4)
                            for m, v in r["seconds"].items()})
              + " peak GiB " + json.dumps({str(m): round(v, 2) for m, v in
                                           r["peak_gib"].items()})
              + " launches " + json.dumps({str(m): v for m, v in
                                           r["launches"].items()})
              + f"; captured calls vs plain {r['captured']}; single card "
              f"{s1:.4f} s, {p1:.2f} GiB; {card}")
    for m in modes:
        seg = res[0]["masks"][m]
        check(seg is not None and seg.shape == seg1.shape,
              f"multi: {kind} mask {None if seg is None else seg.shape}")
        check(all(r["masks"][m] is None for r in res[1:]),
              "multi: a rank other than 0 returned a mask")
        agree = float((seg == seg1).mean())
        outside = bool(np.array_equal(seg[~halo], seg1[~halo]))
        halo_agree = float((seg[halo] == seg1[halo]).mean()) \
            if halo.any() else 1.0
        out[f"agreement_{'exact' if m else 'parallel'}"] = agree
        print(f"multi: {kind} {world} ranks, halo_exact={m}: agreement with "
              f"the single-card sweep {agree:.6f}, rows outside the halo "
              f"({int((~halo).sum())} of {len(halo)}) bit-equal {outside}, "
              f"halo rows {halo_agree:.6f}")
        if m or world == 1:
            check(np.array_equal(seg, seg1), f"multi: {kind} halo_exact="
                  f"{m} on {world} ranks is not the single-card mask")
        else:
            check(outside and agree >= 0.999, f"multi: {kind} rows outside "
                  f"the halo bit-equal {outside}, agreement {agree}")
    return out


def _multi_rank(sweeps, batch, bn_cases):
    """Phase 18's first spawn, on each of two gloo ranks sharing the card:
    the slab-parallel sweeps of ``sweeps`` ((kind, volume, modes) each),
    then :func:`_multi_step_rank`."""
    out = {"sweeps": [_multi_sweep_rank(*job) for job in sweeps]}
    out["steps"] = _multi_step_rank(batch, bn_cases)
    return out


def _multi_train_rank(trainer_name, fold, iters, warm):
    """Phase 18(d)'s rank: ``run_training`` in the process group, its
    steps stamped and counted (``stamp_iterations``); what this rank
    wrote (checkpoints, the metrics summary) and predicted (validation
    cases); the final weights' digest."""
    import hashlib
    import torch
    import fast_nnunet_tpu_torch.evaluation.metrics as metrics
    import fast_nnunet_tpu_torch.inference.export as export
    from fast_nnunet_tpu_torch.run.run_training import run_training
    from fast_nnunet_tpu_torch.training import trainer as trainer_module
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer
    cap, wrote, cases = {}, [], []
    real = (trainer_module.save_checkpoint, metrics.compute_metrics_on_folder,
            export.export_prediction_from_logits)

    def save(fname, **kw):
        wrote.append(os.path.basename(fname))
        return real[0](fname, **kw)

    def summary(gt, pred, out_file, *a, **kw):
        wrote.append(os.path.basename(out_file))
        return real[1](gt, pred, out_file, *a, **kw)

    def export_case(logits, props, cm, pm, dj, ofile, *a, **kw):
        cases.append(os.path.basename(ofile))
        return real[2](logits, props, cm, pm, dj, ofile, *a, **kw)

    trainer_module.save_checkpoint = save
    metrics.compute_metrics_on_folder = summary
    export.export_prediction_from_logits = export_case
    orig = stamp_iterations(NNUNetTrainer, "train_step", cap, warm)
    try:
        trainer = run_training(str(PIPELINE_DS_ID), "3d_fullres", fold,
                               trainer_name=trainer_name, device="cuda")
    finally:
        NNUNetTrainer.run_train_iterations = orig
        (trainer_module.save_checkpoint, metrics.compute_metrics_on_folder,
         export.export_prediction_from_logits) = real
    h = hashlib.sha256()
    for p in trainer.network.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    st = cap["stamps"]
    return {"rank": trainer.rank, "world": trainer.world_size,
            "losses": [float(o) for o in cap["outs"]],
            "step_launches": cap["step_launches"],
            "fed_s": (st[-1] - st[warm]) / (iters - warm),
            "digest": h.hexdigest(), "wrote": wrote, "val_cases": cases,
            "output_folder": trainer.output_folder,
            "peak_gib": cap["peak_bytes"] / 2**30}


def _multi_step_rank(batch, bn_cases):
    """Phase 18(d)'s first update and 18(e)'s global statistics on this
    rank's slices: the planned teacher's trainer (fold all, float32, TF32
    off) steps once on its slice of ``batch``; each small case of
    ``bn_cases`` steps on its slices of its batches. Returns the weights."""
    import torch
    from fast_nnunet_tpu_torch.parallel import rank, world_size
    from fast_nnunet_tpu_torch.parallel.distributed import data_group
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    r, n = rank(), world_size()
    trainer = _fixed_step_trainer(torch)
    b = batch["data"].shape[0] // n
    local = {"data": batch["data"][r * b:(r + 1) * b],
             "target": [t[r * b:(r + 1) * b] for t in batch["target"]]}
    loss = float(trainer.train_step(*trainer.batch_to_device(local)))
    out = {"teacher": {"loss": loss, "params": _param_arrays(
        trainer.network)}}
    for name, case in bn_cases.items():
        out[name] = _small_steps(torch, case, data_group(), r, n)
    return out


def _fixed_step_trainer(torch):
    from fast_nnunet_tpu_torch.run.run_training import get_trainer_from_args
    trainer = get_trainer_from_args(
        str(PIPELINE_DS_ID), "3d_fullres", "all",
        "NNUNetTrainerNoMirroring", device="cuda")
    trainer.compute_dtype = torch.float32
    trainer.initialize()
    return trainer


def _param_arrays(net):
    return {k: v.detach().float().cpu().numpy()
            for k, v in net.state_dict().items()}


def _small_steps(torch, case, group, r, n):
    """Two SGD steps of the small BatchNorm network (batch Dice) on rank
    r's slices of the case's global batches (n = 1: the whole batch)."""
    from fast_nnunet_tpu_torch.models.blocks import sync_batch_stats
    from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
    from fast_nnunet_tpu_torch.models.unet import init_he_normal_
    from fast_nnunet_tpu_torch.training.optimizers import nnunet_sgd
    from fast_nnunet_tpu_torch.training.schedules import poly_lr
    from fast_nnunet_tpu_torch.training.train_step import make_train_step
    dev = torch.device("cuda", torch.cuda.current_device())
    net = get_network_from_plans(
        "PlainConvUNet",
        dict(SMALL_ARCH, norm_op="torch.nn.modules.batchnorm.BatchNorm3d"),
        (), 1, 4,
        compute_dtype=torch.float32, trainable=True)
    init_he_normal_(net, 0)
    net = sync_batch_stats(net.to(dev), group)
    opt = nnunet_sgd(net.parameters(), poly_lr(1e-2, 10))
    step = make_train_step(net, opt, n_ds_levels=2, batch_dice=True,
                           group=group)
    losses = []
    for x, lab in case["batches"]:
        b = x.shape[0] // n
        sl = slice(r * b, (r + 1) * b)
        t = torch.from_numpy(lab[sl]).long().to(dev)
        losses.append(float(step(torch.from_numpy(x[sl]).to(dev),
                                 (t, t[:, ::2, ::2, ::2]))))
    return {"losses": losses, "params": _param_arrays(net)}


def _allclose(got, want, tol=1e-5):
    """max |got - want| - tol * (1 + |want|) over every tensor (<= 0:
    within tolerance)."""
    import numpy as np
    return max(float((np.abs(got[k] - want[k])
                      - tol * (1 + np.abs(want[k]))).max()) for k in want)


def multi_path(torch, dev, a_row):
    """Phase 18 (``multi:``), in phase 11's root after phase 17: the
    slab-parallel sweeps, NCCL at world size 1, data-parallel training on
    two gloo ranks sharing the card, the global batch's Dice and
    BatchNorm (docstring step 18). Four spawns: two gloo ranks for the
    sweeps and the fixed-batch steps, one NCCL rank for the sweep, then
    ``run_training`` through the launcher under NCCL (1 rank) and gloo (2
    ranks)."""
    from fast_nnunet_tpu_torch.parallel import spawn
    t_phase = time.perf_counter()
    card = card_line()
    out = {"card": card}
    refs = _multi_references(torch, dev)
    torch.cuda.empty_cache()
    sweeps = [("s2d", refs["s2d_vol"], (False, True)),
              ("plain", refs["plain_vol"], (False, True))]
    t0 = time.perf_counter()
    res = spawn(_multi_rank, 2, device="cuda", backend="gloo",
                args=(sweeps, refs["batch"], refs["cases"]))
    out["gloo_spawn_wall_s"] = time.perf_counter() - t0
    for i, (kind, vol, modes) in enumerate(sweeps):
        out[kind] = _multi_sweep_checks(
            torch, kind, vol, card, "gloo", modes, refs[kind],
            [r["sweeps"][i] for r in res])
    out.update(_multi_step_checks(refs, [r["steps"] for r in res], card))
    del res
    # ---- (c) the s2d sweep on one NCCL rank
    t0 = time.perf_counter()
    res = spawn(_multi_sweep_rank, 1, device="cuda", backend="nccl",
                args=("s2d", refs["s2d_vol"], (False,)))
    out["nccl_spawn_wall_s"] = time.perf_counter() - t0
    out["s2d_nccl_world_1"] = _multi_sweep_checks(
        torch, "s2d", refs["s2d_vol"], card, "nccl", (False,), refs["s2d"],
        res)
    del res, refs
    out["train"] = _multi_training(torch, dev, card)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"multi: phase wall {out['wall_s']:.3f} s")
    print(json.dumps({"multi": out}, default=str))
    return out


def _multi_references(torch, dev):
    """What phase 18 holds its ranks against, from this one process: the
    s2d sweep of phase 2's CT preprocessed and the plain sweep with kernel
    D of a MULTI_PLAIN_SIZE^3 volume (mask, seconds, peak GiB), the
    planned teacher's first update on a fixed validation batch of 2
    (float32, TF32 off), two steps of a small BatchNorm network with batch
    Dice on a global batch of 4."""
    import numpy as np
    from fast_nnunet_tpu_torch.inference.turbo import TurboPipeline
    from fast_nnunet_tpu_torch.utils.synthetic_ct import make_synthetic_ct
    refs = {}
    engine, tree, cfg = _multi_engine(torch, "s2d", dev)
    ct, spacing = make_synthetic_ct((512, 512, 500), (0.8, 0.8, 1.0), seed=0)
    with torch.no_grad():
        vol_dev, new_shape, _, _ = TurboPipeline(engine, cfg).preprocess(
            ct[None], spacing)
        refs["s2d_vol"] = vol_dev[(slice(None),) + tuple(
            slice(0, n) for n in new_shape)].float().cpu().numpy()
    del vol_dev, ct
    refs["s2d"] = _single_sweep(torch, engine, tree, "s2d", refs["s2d_vol"])
    print(f"multi: s2d volume {refs['s2d_vol'].shape} (phase 2's CT "
          f"preprocessed), single-card sweep {refs['s2d'][1]:.4f} s, peak "
          f"{refs['s2d'][2]:.2f} GiB")
    del engine
    size = MULTI_PLAIN_SIZE
    engine, tree, _ = _multi_engine(torch, "plain", dev)
    refs["plain_vol"] = (np.random.RandomState(0).rand(
        1, size, size, size).astype(np.float32) - 0.5) * 2
    refs["plain"] = _single_sweep(torch, engine, tree, "plain",
                                  refs["plain_vol"])
    print(f"multi: plain volume {refs['plain_vol'].shape}, single-card sweep "
          f"{refs['plain'][1]:.4f} s, peak {refs['plain'][2]:.2f} GiB")
    del engine
    torch.cuda.empty_cache()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = _fixed_step_trainer(torch)
        ref.get_dataloaders()
        batch = next(ref.dataloader_val)
        for d in (ref.dataloader_train, ref.dataloader_val):
            d.shutdown()
        refs["batch"] = {"data": np.asarray(batch["data"]),
                         "target": [np.asarray(t) for t in batch["target"]]}
        refs["ref_loss"] = float(ref.train_step(*ref.batch_to_device(
            refs["batch"])))
        refs["ref_params"] = _param_arrays(ref.network)
        del ref
        rng = np.random.RandomState(5)
        batches = []
        for _ in range(2):
            x = rng.randn(4, 1, 32, 32, 32).astype(np.float32)
            lab = rng.randint(0, 4, (4, 32, 32, 32)).astype(np.int64)
            lab[:2][lab[:2] == 3] = 0   # rank 0's slice lacks class 3
            x[:, 0] += lab
            batches.append((x, lab))
        refs["cases"] = {"bn_batch_dice": {"batches": batches}}
        refs["small"] = _small_steps(torch, refs["cases"]["bn_batch_dice"],
                                     None, 0, 1)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.\
            allow_tf32 = tf32
    return refs


def _multi_training(torch, dev, card):
    import numpy as np
    from fast_nnunet_tpu_torch.run.run_training import run_training
    from fast_nnunet_tpu_torch.utils.io import join, load_json
    out = {}
    old = {k: os.environ.get(k) for k in (
        "FNNT_ITERS_PER_EPOCH", "FNNT_VAL_ITERS_PER_EPOCH",
        "FNNT_NUM_EPOCHS")}
    os.environ.update(FNNT_VAL_ITERS_PER_EPOCH="1", FNNT_NUM_EPOCHS="1")
    try:
        # ---- (c) one iteration through the -num_gpus 1 path under NCCL
        os.environ["FNNT_ITERS_PER_EPOCH"] = "1"
        t0 = time.perf_counter()
        (r1,) = run_training(str(PIPELINE_DS_ID), "3d_fullres", 0,
                             trainer_name="NNUNetTrainerNoMirroring",
                             device="cuda", num_gpus=1, backend="nccl")
        lg = r1["logging"]
        out["nccl_world_1"] = {"wall_s": time.perf_counter() - t0,
                               "train_step": r1["train_step"],
                               "train_loss": lg["train_losses"][0]}
        print(f"multi: run_training -num_gpus 1 (NCCL, world "
              f"{r1['world_size']}, {r1['device']}): 1 iteration, train "
              f"loss {lg['train_losses'][0]:.4f}, val loss "
              f"{lg['val_losses'][0]:.4f}, "
              f"{out['nccl_world_1']['wall_s']:.3f} s with the final "
              f"validation")
        check(r1["world_size"] == 1 and r1["train_step"] == 1 and
              np.isfinite(lg["train_losses"][0]), f"multi: NCCL run {r1}")

        # ---- (d) 2 gloo ranks on the card through the launcher
        os.environ["FNNT_ITERS_PER_EPOCH"] = str(MULTI_ITERS)
        from fast_nnunet_tpu_torch.parallel import spawn
        t0 = time.perf_counter()
        ranks = spawn(_multi_train_rank, 2, device="cuda", backend="gloo",
                      args=("NNUNetTrainerNoMirroring", "all", MULTI_ITERS,
                            MULTI_WARM))
        wall = time.perf_counter() - t0
        r0, r1 = ranks
        folder = r0["output_folder"]
        files = os.listdir(folder)
        summary = load_json(join(folder, "validation", "summary.json"))
        out["ddp"] = {"wall_s": wall, "ranks": [
            {k: r[k] for k in ("rank", "losses", "step_launches", "fed_s",
                               "wrote", "val_cases", "peak_gib")}
            for r in ranks]}
        for r in ranks:
            print(f"multi: DDP rank {r['rank']}/{r['world']} (gloo, cuda:0 "
                  f"shared): losses {[round(v, 6) for v in r['losses']]}, "
                  f"kernel A launches per step {r['step_launches']}, fed "
                  f"s/iteration {r['fed_s']:.4f} (iterations {MULTI_WARM}-"
                  f"{MULTI_ITERS - 1}), peak {r['peak_gib']:.2f} GiB; wrote "
                  f"{r['wrote']}; validation cases {r['val_cases']}; {card}")
        check(r0["losses"] == r1["losses"] and all(
            np.isfinite(r0["losses"])), f"multi: rank losses differ or are "
            f"not finite: {r0['losses']} {r1['losses']}")
        check(r0["digest"] == r1["digest"],
              "multi: the replicas' parameters differ after training")
        check(len(r0["losses"]) == MULTI_ITERS, f"multi: {r0['losses']}")
        check(r1["wrote"] == [] and "checkpoint_final.fnnx" in r0["wrote"]
              and "summary.json" in r0["wrote"],
              f"multi: writes rank 0 {r0['wrote']}, rank 1 {r1['wrote']}")
        check(sum(f.startswith("training_log_") for f in files) == 1 and
              "checkpoint_final.fnnx" in files, f"multi: folder {files}")
        cases = r0["val_cases"] + r1["val_cases"]
        check(r0["val_cases"] and r1["val_cases"] and
              len(set(cases)) == len(cases) == PIPELINE_N_TRAIN and
              len(summary["metric_per_case"]) == PIPELINE_N_TRAIN,
              f"multi: validation cases {r0['val_cases']} / "
              f"{r1['val_cases']}")
        out["ddp"]["gate"] = _multi_gate_check(torch, ranks)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def _multi_gate_check(torch, ranks):
    """Kernel A launches per step per rank against the 4096-voxel gate's
    count for the planned teacher (phase 11's)."""
    from fast_nnunet_tpu_torch.models.factory import \
        build_network_from_arch_dict
    from fast_nnunet_tpu_torch.utils.io import join, load_json
    plans = load_json(join(os.environ["nnUNet_preprocessed"], PIPELINE_DS,
                           "nnUNetPlans.json"))
    arch = plans["configurations"]["3d_fullres"]["architecture"]
    bs = plans["configurations"]["3d_fullres"]["batch_size"]
    patch = PIPELINE_3D_FULLRES["patch_size"]
    remat = bs * math.prod(patch) >= 2 ** 21
    net = build_network_from_arch_dict(arch, 1, TRAIN_K,
                                       compute_dtype=torch.bfloat16,
                                       remat=remat, norm_onepass=True,
                                       trainable=True)
    n_gate, n_remat = gated_norms(torch, net, torch.zeros((1, 1, *patch)))
    predicted = n_gate + n_remat
    for r in ranks:
        check(all(k == predicted for k in r["step_launches"]),
              f"multi: rank {r['rank']} kernel A launches per step "
              f"{r['step_launches']} != the gate's {predicted}")
    print(f"multi: kernel A launches per step on each rank {predicted} = "
          f"the gate's count ({n_gate} norms at >= 4096 voxels, {n_remat} "
          f"recomputed)")
    return predicted


def _multi_step_checks(refs, steps, card):
    """(d)'s first update and (e)'s BatchNorm + batch Dice steps of the two
    gloo ranks against one process on the global batch: within 1e-5 (abs +
    rel), the replicas bit-equal."""
    import numpy as np
    out = {}
    got0, got1 = (r["teacher"]["params"] for r in steps)
    same = all(np.array_equal(got0[k], got1[k]) for k in got0)
    margin = _allclose(got0, refs["ref_params"])
    losses = [r["teacher"]["loss"] for r in steps]
    out["first_update"] = {"rank_losses": losses,
                           "one_process_loss": refs["ref_loss"],
                           "margin": margin, "replicas_equal": same}
    print(f"multi: first update of the planned teacher (float32, TF32 off) "
          f"on 2 gloo ranks vs one process on the global batch of 2: "
          f"losses {losses} vs {refs['ref_loss']}, parameter margin "
          f"{margin:.3e} (<= 0: within 1e-5 abs + 1e-5 rel), replicas "
          f"bit-equal {same}; {card}")
    check(same and margin <= 0 and all(
        abs(v - refs["ref_loss"]) <= 1e-5 * abs(refs["ref_loss"])
        for v in losses), f"multi: first update {out['first_update']}")
    s0, s1 = (r["bn_batch_dice"] for r in steps)
    small = refs["small"]
    margin = _allclose(s0["params"], small["params"])
    same = all(np.array_equal(s0["params"][k], s1["params"][k])
               for k in s0["params"])
    out["bn_batch_dice"] = {"rank_losses": s0["losses"],
                            "one_process_losses": small["losses"],
                            "margin": margin, "replicas_equal": same}
    print(f"multi: BatchNorm + batch Dice on 2 gloo ranks vs one process on "
          f"the global batch of 4: losses {s0['losses']} vs "
          f"{small['losses']}, margin {margin:.3e} (running averages "
          f"included), replicas bit-equal {same}; {card}")
    check(np.allclose(s0["losses"], small["losses"], rtol=1e-5, atol=0)
          and margin <= 0 and same and s0["losses"] == s1["losses"],
          f"multi: BatchNorm / batch Dice {out['bn_batch_dice']}")
    return out


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--phase19-build"]:
            sys.exit(phase19_build_main(sys.argv[2:]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
