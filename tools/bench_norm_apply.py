#!/usr/bin/env python3
"""Kernel E (the s2d InstanceNorm's affine and LeakyReLU, ``ops/norm_apply.py``)
at every norm shape of the bone_turbo student's serving forward (tile batch
8, patch 160 x 96 x 96), on the card. Run from the repository root on a
machine with an NVIDIA GPU:

    python3 tools/bench_norm_apply.py [--forward]

For each shape, on seeded random data and moments: the kernel against its
plain version (the torch sequence the forward ran before the kernel) bit for
bit, with the LeakyReLU; the time per call of 20 calls launched from Python
(``ms``) and of the same calls replayed from a CUDA graph (``device_ms``),
both cycling through copies of the input that together exceed the L2
(``chip_smoke.l2_cold_copies``), each writing a separate output; the byte
bound (2 B read and 2 B written per bf16 element at 3.35 TB/s); the plain
version's time. Also what ptxas reported for the kernel.

``--forward`` also times the whole student forward (seeded weights, the
features the sweep takes) with kernel E and with the former eager norm, in
turns (former, E, E, former), CUDA events over 10 forwards each, and checks
that the two give the same features bit for bit.

Prints one line per shape and a JSON line last.
"""
import argparse
import itertools
import json
import math
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


def former_norm(torch, x, scale, bias, eps, groups, stats_min_voxels):
    """The s2d norm before kernel E: moments as the network takes them, then
    the affine as torch passes (the plain version's sequence)."""
    from fast_nnunet_tpu_torch.ops.stats import spatial_sum_sumsq
    B, C8 = x.shape[0], x.shape[1]
    c = C8 // groups
    n_spatial = math.prod(x.shape[2:])
    if n_spatial >= stats_min_voxels:
        s, q = spatial_sum_sumsq(x)
        n = n_spatial * groups
        mean = s.reshape(B, groups, c).sum(1) / n
        var = torch.clamp(q.reshape(B, groups, c).sum(1) / n - mean * mean,
                          min=0.0)
    else:
        x32 = x.float().reshape(B, C8, -1)
        mean_c = x32.mean(-1)
        var_c = x32.var(-1, correction=0)
        if groups == 1:
            mean, var = mean_c, var_c
        else:
            mean = mean_c.reshape(B, groups, c).mean(1)
            var = ((var_c + mean_c * mean_c).reshape(B, groups, c).mean(1)
                   - mean * mean)
    from fast_nnunet_tpu_torch.ops.norm_apply import norm_apply_plain
    return norm_apply_plain(x, mean, torch.rsqrt(var + eps), scale, bias,
                            groups)


def forward_turns(torch, cs):
    """(ms per forward {"former": [..], "kernel_e": [..]}, features equal)."""
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
    fused = s2d._Block.forward

    def former(self, v):
        if self.pre_pad is not None:
            v = F.pad(v, self.pre_pad)
        v = self.conv(v)
        v = former_norm(torch, v, self.norm.weight, self.norm.bias, self.eps,
                        self.groups, self.stats_min_voxels)
        return F.leaky_relu_(v, self.slope)

    out, feats = {"former": [], "kernel_e": []}, {}
    try:
        with torch.no_grad():
            for name in ("former", "kernel_e", "kernel_e", "former"):
                s2d._Block.forward = former if name == "former" else fused
                feats[name] = net(x, return_features=True)
                out[name].append(cs.time_ms(
                    torch, lambda: net(x, return_features=True), n=10))
    finally:
        s2d._Block.forward = fused
    return out, bool(torch.equal(feats["former"], feats["kernel_e"]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--forward", action="store_true",
                    help="also time the whole forward, kernel E vs former")
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
        args_ = (mean, rstd, scale, bias, groups, 0.01)
        same = torch.equal(ke.norm_apply(x, *args_),
                           ke.norm_apply_plain(x, *args_))
        xs = cs.l2_cold_copies(torch, x)
        outs = [torch.empty_like(x) for _ in xs]
        pairs = itertools.cycle(list(zip(xs, outs)))

        def run():
            xi, oi = next(pairs)
            return ke.norm_apply(xi, *args_, out=oi)

        ms = cs.time_ms(torch, run, n=20)
        device_ms = cs.time_graph_ms(torch, run)
        del xs, outs, pairs
        torch.cuda.empty_cache()
        plain = cs.time_ms(torch, lambda: ke.norm_apply_plain(x, *args_),
                           n=5, warmup=1)
        nbytes = 2 * x.numel() * x.element_size()
        bms, bby = cs.bound(nbytes, 5 * x.numel())
        plan = ke.launch_plan(B * C8, x[0, 0].numel(), 2)
        r = {"name": name, "shape": list(shape), "groups": groups,
             "plan": dict(plan), "bit_equal": same, "ms": ms,
             "device_ms": device_ms, "plain_ms": plain, "bound_ms": bms,
             "bound_by": bby, "bound_share": bms / ms,
             "device_bound_share": bms / device_ms, "bytes": nbytes}
        rows_out.append(r)
        print(f"{name} {tuple(shape)} groups {groups}: bit-equal {same}, "
              f"{ms:.4f} ms (device {device_ms:.4f}) vs bound {bms:.4f} ms, "
              f"share {bms / ms:.3f} (device {bms / device_ms:.3f}), plain "
              f"{plain:.4f} ms; plan {plan}")
        del x
        torch.cuda.empty_cache()
    result = {"card": card, "ptxas": ptxas, "shapes": rows_out}
    if args.forward:
        walls, same = forward_turns(torch, cs)
        result["forward_ms"] = walls
        result["forward_bit_equal"] = same
        print(f"forward (8, 1, 160, 96, 96) bf16, ms per forward in turns: "
              f"former {walls['former']}, kernel E {walls['kernel_e']}; "
              f"features bit-equal {same}")
    print(json.dumps({"bench_norm_apply": result}))
    ok = all(r["bit_equal"] for r in rows_out) and \
        result.get("forward_bit_equal", True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
