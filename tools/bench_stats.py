#!/usr/bin/env python3
"""Kernel A (InstanceNorm statistics, ``ops/stats.py``) at the shapes the
port launches it with, on the card: the s2d serving calls, and the teacher's
and the distillation student's training calls (stages 0-2 at batch 2; deeper
stages are under the 4096-voxel gate). Run from the repository root on a
machine with an NVIDIA GPU:

    python3 tools/bench_stats.py [--sweep] [--repo DIR] [--label NAME]

For each shape, on seeded random data, cycling through copies of the input
that together exceed the L2 (``chip_smoke.l2_cold_copies``): the time per
call of 20 calls launched from Python (``ms``), the device time per call of
the same 20 calls replayed from a CUDA graph (``device_ms``), the byte bound
(input read once, output written once, at 3.35 TB/s), and the error against
the plain version.

- ``--sweep`` also times every forced split k in 1, 2, 4, 8 (the rule of
  ``launch_plan`` picks one of them), each checked against the plain
  version and for bit-equality of two calls.
- ``--repo DIR`` times the wrapper of the package in another checkout (e.g.
  the parent commit unpacked with ``git archive``), so that two versions
  are compared on one card in one call.

Prints one line per shape and a JSON line last.
"""
import argparse
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# name: (shape, dtype); rows = B * C, S = the product of the spatial dims
SHAPES = {
    "serving stage 0": ((8, 128, 80, 48, 48), "bfloat16"),
    "serving stage 1": ((8, 256, 40, 24, 24), "bfloat16"),
    "teacher stage 0": ((2, 32, 160, 96, 96), "bfloat16"),
    "teacher stage 1": ((2, 64, 80, 48, 48), "bfloat16"),
    "teacher stage 2": ((2, 128, 40, 24, 24), "bfloat16"),
    "student stage 0": ((2, 16, 160, 96, 96), "bfloat16"),
    "student stage 1": ((2, 32, 80, 48, 48), "bfloat16"),
    "student stage 2": ((2, 64, 40, 24, 24), "bfloat16"),
}
SWEEP_K = (1, 2, 4, 8)


def times(torch, cs, fn, x):
    """(ms, device_ms) of fn(input) cycling through L2-cold copies of x."""
    xs = cs.l2_cold_copies(torch, x)
    cyc = itertools.cycle(xs)

    def run():
        return fn(next(cyc))

    out = cs.time_ms(torch, run, n=20), cs.time_graph_ms(torch, run)
    del xs, cyc
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true",
                    help="also time every forced split k")
    ap.add_argument("--repo", default=None,
                    help="time the wrapper of the package in this checkout")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_stats: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # timing, bound and tolerance helpers
    if args.repo:
        sys.path.insert(0, os.path.abspath(args.repo))
    from fast_nnunet_tpu_torch.ops import _build
    from fast_nnunet_tpu_torch.ops import stats as ka
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    label = args.label or args.repo or "this checkout"
    print(f"{card}; kernel A from {os.path.dirname(ka.__file__)} ({label})")
    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for name, (shape, dtype) in SHAPES.items():
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 1
             ).to(getattr(torch, dtype))
        rows = shape[0] * shape[1]
        S = x.numel() // rows
        nbytes = x.numel() * x.element_size() + 2 * rows * 4
        bms, bby = cs.bound(nbytes, 3 * x.numel())
        err, ok = cs.stats_error(torch, ka.spatial_sum_sumsq(x),
                                 ka.spatial_sum_sumsq_plain(x), x)
        ms, device_ms = times(torch, cs, ka.spatial_sum_sumsq, x)
        r = {"name": name, "shape": list(shape), "dtype": dtype,
             "rows": rows, "S": S, "bytes": nbytes, "bound_ms": bms,
             "bound_by": bby, "ms": ms, "device_ms": device_ms,
             "bound_share": bms / ms, "device_bound_share": bms / device_ms,
             "max_abs_err": err, "within_tolerance": ok}
        if hasattr(ka, "launch_plan"):
            r["k"] = ka.launch_plan(rows, S, x.element_size(), n_sms)["k"]
        print(f"{name} {tuple(shape)} {dtype}: k {r.get('k')}, {ms:.4f} ms "
              f"(device {device_ms:.4f}) vs bound {bms:.4f} ms, share "
              f"{bms / ms:.3f} (device {bms / device_ms:.3f}), err "
              f"{err:.3e} ok {ok}")
        if args.sweep:
            r["sweep"] = {}
            code = _build.dtype_code(x)
            o = torch.empty((2,) + shape[:2], dtype=torch.float32,
                            device=dev)
            for k in SWEEP_K:
                plan = ka._split_plan(rows, S, x.element_size(), k)

                def forced(xi):
                    ka._launch(xi, code, rows, S, plan, o)

                forced(x)
                first = o.clone()
                forced(x)
                same = bool(torch.equal(first, o))
                e, okk = cs.stats_error(torch, (o[0], o[1]),
                                        ka.spatial_sum_sumsq_plain(x), x)
                t, t_dev = times(torch, cs, forced, x)
                r["sweep"][k] = {"ms": t, "device_ms": t_dev,
                                 "device_bound_share": bms / t_dev,
                                 "max_abs_err": e, "within_tolerance": okk,
                                 "bit_equal_repeat": same}
                print(f"  k {k}: {t:.4f} ms (device {t_dev:.4f}, share "
                      f"{bms / t_dev:.3f}), err {e:.3e} ok {okk}, repeat "
                      f"bit-equal {same}")
        out.append(r)
        del x
        torch.cuda.empty_cache()
    print(json.dumps({"bench_stats": {"card": card, "label": label,
                                      "shapes": out}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
