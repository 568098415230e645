#!/usr/bin/env python3
"""Kernel E (the s2d InstanceNorm's affine and LeakyReLU, ``ops/norm_apply.py``)
at every norm shape of the bone_turbo student's serving forward (tile batch
8, patch 160 x 96 x 96), on the card. Run from the repository root on a
machine with an NVIDIA GPU:

    python3 tools/bench_norm_apply.py [--forward]

For each shape, on seeded random data and moments, without and with a conv
bias folded in (as the forward runs it): the kernel against its plain
version (the torch sequence the forward ran before the kernel) bit for bit,
with the LeakyReLU; the time per call of 20 calls launched from Python
(``ms``) and of the same calls replayed from a CUDA graph (``device_ms``),
both cycling through copies of the input that together exceed the L2
(``chip_smoke.l2_cold_copies``), each writing a separate output; the byte
bound (2 B read and 2 B written per bf16 element at 3.35 TB/s, the bias or
not); the plain version's time. Also what ptxas reported for the kernel.

``--forward`` also times the whole student forward (seeded weights, the
features the sweep takes) with each block's conv bias folded into kernel E
and with the bias added by the convolution (torch's separate add on cuDNN)
before kernel E, in turns (unfolded, folded, folded, unfolded), CUDA events
over 10 forwards each, and prints the largest gap between their features.

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

# name: (shape, groups); one row per norm shape of the serving forward
SHAPES = {
    "stage 0 / last decoder": ((8, 128, 80, 48, 48), 8),
    "stage 1 / decoder 3": ((8, 32, 80, 48, 48), 1),
    "stage 2 / decoder 2": ((8, 64, 40, 24, 24), 1),
    "stage 3 / decoder 1": ((8, 128, 20, 12, 12), 1),
    "stage 4 / decoder 0": ((8, 160, 10, 6, 6), 1),
    "stage 5": ((8, 160, 5, 3, 3), 1),
}
STUDENT_ARCH = {"n_stages": 6,
                "features_per_stage": [16, 32, 64, 128, 160, 160],
                "kernel_sizes": [[3, 3, 3]] * 6,
                "strides": [[1, 1, 1]] + [[2, 2, 2]] * 5,
                "n_conv_per_stage": [2] * 6,
                "n_conv_per_stage_decoder": [2] * 5}


def forward_turns(torch, cs):
    """(ms per forward {"unfolded": [..], "folded": [..]}, the largest
    absolute gap between their features)."""
    import torch.nn.functional as F
    from fast_nnunet_tpu_torch.models import s2d
    net = s2d.make_s2d_engine_net(STUDENT_ARCH, 61, 1,
                                  compute_dtype=torch.bfloat16)
    s2d.params_from_jax(net, net.convert_params(
        s2d.random_plain_params(STUDENT_ARCH, 1, 61, seed=0)))
    net.to("cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(8, 1, 160, 96, 96, generator=g, device="cuda").to(
        torch.bfloat16)
    folded = s2d._Block.forward

    def unfolded(self, v):
        if self.pre_pad is not None:
            v = F.pad(v, self.pre_pad)
        return s2d.instance_norm(self.conv(v), self.norm.weight,
                                 self.norm.bias, self.eps, self.groups,
                                 self.stats_min_voxels, self.slope)

    out, feats = {"unfolded": [], "folded": []}, {}
    try:
        with torch.no_grad():
            for name in ("unfolded", "folded", "folded", "unfolded"):
                s2d._Block.forward = unfolded if name == "unfolded" \
                    else folded
                feats[name] = net(x, return_features=True)
                out[name].append(cs.time_ms(
                    torch, lambda: net(x, return_features=True), n=10))
    finally:
        s2d._Block.forward = folded
    gap = float((feats["folded"].float() - feats["unfolded"].float()).abs()
                .max())
    return out, gap


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--forward", action="store_true",
                    help="also time the whole forward, the conv bias folded "
                    "into kernel E or added by the convolution")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_norm_apply: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # timing and bound helpers
    from fast_nnunet_tpu_torch.ops import _build
    from fast_nnunet_tpu_torch.ops import norm_apply as ke
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    ptxas = _build.ptxas_report("norm_apply")
    for fn, v in sorted(ptxas.items()):
        print(f"ptxas {fn}: {v.get('registers')} registers, "
              f"{v.get('spill_stores')} B spill stores, {v.get('stack')} B "
              "stack")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows_out = []
    for name, (shape, groups) in SHAPES.items():
        B, C8 = shape[:2]
        c = C8 // groups
        x = (torch.randn(shape, generator=g, device=dev) * 3 + 0.7).to(
            torch.bfloat16)
        mean = torch.randn(B, c, generator=g, device=dev) + 0.7
        rstd = torch.rand(B, c, generator=g, device=dev) * 0.5 + 0.2
        scale = torch.rand(c, generator=g, device=dev) + 0.5
        bias = torch.randn(c, generator=g, device=dev) * 0.3
        cb = torch.randn(C8, generator=g, device=dev) * 0.5
        args_ = (mean, rstd, scale, bias, groups, 0.01)
        for conv_bias in (None, cb):
            kw = {"conv_bias": conv_bias}
            same = torch.equal(ke.norm_apply(x, *args_, **kw),
                               ke.norm_apply_plain(x, *args_, **kw))
            xs = cs.l2_cold_copies(torch, x)
            outs = [torch.empty_like(x) for _ in xs]
            pairs = itertools.cycle(list(zip(xs, outs)))

            def run():
                xi, oi = next(pairs)
                return ke.norm_apply(xi, *args_, out=oi, **kw)

            ms = cs.time_ms(torch, run, n=20)
            device_ms = cs.time_graph_ms(torch, run)
            del xs, outs, pairs
            torch.cuda.empty_cache()
            plain = cs.time_ms(
                torch, lambda: ke.norm_apply_plain(x, *args_, **kw), n=5,
                warmup=1)
            folded = conv_bias is not None
            nbytes = 2 * x.numel() * x.element_size()
            bms, bby = cs.bound(nbytes, (6 if folded else 5) * x.numel())
            plan = ke.launch_plan(B * C8, x[0, 0].numel(), 2)
            r = {"name": name, "shape": list(shape), "groups": groups,
                 "conv_bias": folded, "plan": dict(plan), "bit_equal": same,
                 "ms": ms, "device_ms": device_ms, "plain_ms": plain,
                 "bound_ms": bms, "bound_by": bby, "bound_share": bms / ms,
                 "device_bound_share": bms / device_ms, "bytes": nbytes}
            rows_out.append(r)
            print(f"{name} {tuple(shape)} groups {groups} conv bias "
                  f"{folded}: bit-equal {same}, {ms:.4f} ms (device "
                  f"{device_ms:.4f}) vs bound {bms:.4f} ms, share "
                  f"{bms / ms:.3f} (device {bms / device_ms:.3f}), plain "
                  f"{plain:.4f} ms; plan {plan}")
        del x
        torch.cuda.empty_cache()
    result = {"card": card, "ptxas": ptxas, "shapes": rows_out}
    if args.forward:
        walls, gap = forward_turns(torch, cs)
        result["forward_ms"] = walls
        result["forward_max_abs_gap"] = gap
        print(f"forward (8, 1, 160, 96, 96) bf16, ms per forward in turns: "
              f"unfolded {walls['unfolded']}, folded {walls['folded']}; "
              f"largest feature gap {gap}")
    print(json.dumps({"bench_norm_apply": result}))
    return 0 if all(r["bit_equal"] for r in rows_out) else 1


if __name__ == "__main__":
    sys.exit(main())
