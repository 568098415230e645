#!/usr/bin/env python3
"""Where a training step's time goes on the card: the bone_turbo teacher
training step of chip_smoke.py's ``train:`` phase (PlainConvUNet [32..320],
batch 2, patch 160x96x96, 61 classes, bf16 compute, remat by the JAX rule),
fed by the dataloader and on one cached device batch, each over a short
``torch.profiler`` window after warm-up. Run from the repository root on a
machine with an NVIDIA GPU:

    python3 tools/profile_train_step.py [--steps 6] [--trace DIR] [--resenc]

``--resenc`` profiles chip_smoke.py's phase-12 teacher instead: nnU-Net's
ResEnc L preset as planned there (PIPELINE_RESENC_L: ResidualEncoderUNet,
blocks 1/3/4/6/6/6, patch 160^3, batch 2), on the same synthetic cases.

Prints, per mode: host ms per step without and with the profiler, the
device's busy time per step (the union of the kernels' intervals on the
timeline) and its idle share against the unprofiled wall of the same run,
and the device time per kernel group (convolutions, kernel A, normalisation
and activation elementwise work, loss, optimizer, copies) and for the top
kernels by name. ``--trace`` also writes a Chrome trace per mode.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("kernel A", ("spatial_sum_sumsq",)),
    ("convolution", ("conv", "dgrad", "wgrad", "xmma", "cudnn", "implicit",
                     "gemm", "sm90", "cutlass", "nhwc", "winograd")),
    ("copy / cast", ("copy", "memcpy", "cast", "memset")),
    ("reduction", ("reduce", "sum", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise",
                     "leaky", "addcmul", "mul", "add", "where")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for g, keys in GROUPS:
        if any(k in low for k in keys):
            return g
    return "other"


def busy_ms(events) -> float:
    """Union of the device kernels' [start, end) intervals, ms."""
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def timed_wall_ms(torch, run_step, steps) -> float:
    """Host ms per step over ``steps`` steps ending in a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run_step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def profile(torch, run_step, steps, trace_path):
    """The same steps timed without the profiler, then under it. The idle
    share divides the profiled device busy time by the unprofiled wall,
    both from this call; the profiler's own host overhead inflates its
    wall, so its idle share is reported apart."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    for _ in range(3):
        run_step()
    plain_wall = timed_wall_ms(torch, run_step, steps)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                  ) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    path = trace_path or os.path.join(tempfile.mkdtemp(), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    kernels = [e for e in trace.get("traceEvents", [])
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and "dur" in e]
    groups, names = {}, {}
    for e in kernels:
        g = group_of(e["name"])
        groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3 / steps
        names[e["name"]] = names.get(e["name"], 0.0) + e["dur"] / 1e3 / steps
    busy = busy_ms(kernels) / steps
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms_per_step": plain_wall,
            "profiled_wall_ms_per_step": wall,
            "device_busy_ms_per_step": busy,
            "idle_share": 1 - busy / plain_wall,
            "profiled_idle_share": 1 - busy / wall,
            "kernels_per_step": len(kernels) / steps,
            "groups_ms_per_step": dict(sorted(groups.items(),
                                              key=lambda kv: -kv[1])),
            "top_kernels_ms_per_step": [(n[:120], ms) for n, ms in top]}


def resenc_l(cs) -> dict:
    """write_train_dataset's arguments for chip_smoke.PIPELINE_RESENC_L."""
    t = cs.PIPELINE_RESENC_L
    kw = {k: t[k] for k in ("n_stages", "features_per_stage", "kernel_sizes",
                            "strides", "n_blocks_per_stage",
                            "n_conv_per_stage_decoder")}
    arch = dict(cs.TRAIN_ARCH, network_class_name=cs.TRAIN_ARCH[
        "network_class_name"].replace("PlainConvUNet", "ResidualEncoderUNet"),
        arch_kwargs=dict(cs.TRAIN_ARCH["arch_kwargs"], **kw))
    arch["arch_kwargs"].pop("n_conv_per_stage")
    return {"arch": arch, "patch": t["patch_size"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--trace", default=None,
                    help="directory for one Chrome trace per mode")
    ap.add_argument("--resenc", action="store_true",
                    help="the ResEnc L teacher of chip_smoke.py phase 12")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_train_step: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer
    from fast_nnunet_tpu_torch.utils.io import load_json

    root = tempfile.mkdtemp(prefix="fnn_profile_train_")
    os.environ.update(nnUNet_raw=os.path.join(root, "raw"),
                      nnUNet_preprocessed=os.path.join(root, "preprocessed"),
                      nnUNet_results=os.path.join(root, "results"))
    try:
        plans = cs.write_train_dataset(root, **(
            resenc_l(cs) if args.resenc else {}))
        dataset_json = load_json(os.path.join(
            root, "preprocessed", cs.TRAIN_DS, "dataset.json"))
        trainer = NNUNetTrainer(plans, "3d_fullres", 0, dataset_json)
        trainer.initialize()
        loader, _ = trainer.get_dataloaders()
        card = torch.cuda.get_device_name(0)
        out = {"device": card, "remat": trainer._use_remat()}

        def fed():
            trainer.train_step(*trainer.next_batch(loader))

        cached_batch = trainer.batch_to_device(
            loader.sampler.generate_batch(np.random.RandomState(0)))

        def cached():
            trainer.train_step(*cached_batch)

        for name, fn in (("cached", cached), ("fed", fed)):
            trace = os.path.join(args.trace, f"train_{name}.json") \
                if args.trace else None
            if args.trace:
                os.makedirs(args.trace, exist_ok=True)
            out[name] = profile(torch, fn, args.steps, trace)
            r = out[name]
            print(f"{name}: {r['wall_ms_per_step']:.2f} ms per step on the "
                  f"host clock ({r['profiled_wall_ms_per_step']:.2f} under the"
                  f" profiler), device busy {r['device_busy_ms_per_step']:.2f}"
                  f" ms (idle share {r['idle_share']:.3f}; "
                  f"{r['profiled_idle_share']:.3f} of the profiled wall), "
                  f"{r['kernels_per_step']:.0f} kernels per step")
            print(f"{name}: device ms per step by group " + json.dumps(
                {k: round(v, 3) for k, v in r["groups_ms_per_step"].items()}))
            for n, ms in r["top_kernels_ms_per_step"]:
                print(f"{name}:   {ms:8.3f} ms  {n}")
        loader.shutdown()
        trainer.dataloader_val.shutdown()
        print(json.dumps({"profile_train_step": out}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
