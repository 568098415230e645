#!/usr/bin/env python3
"""Kernel G (Primus's fused attention backward, ``ops/attention.py``
``attention_backward``) on the card. Run from the repository root on a
machine with an NVIDIA GPU:

    python3 tools/bench_attention.py [--check] [--smoke] [--repo PATH] [--n N]

Prints the card's name and power limit, what ptxas reported for the
attention kernels, and G's time per call at Primus M's 160^3 shape (2, 8000,
12, 72) with v read in place from a qkv output, as ``chip_smoke.py`` builds
its inputs: CUDA events around ``N`` calls after two warm-up calls, beside
the bf16 bound of its useful FLOPs (10 B H T^2 hd at 989 TFLOP/s).

``--check`` first holds F and G against their plain version at small and
ragged token counts (T = 45, 128, 129, 130 with head dim 66, 257, 1037)
and at the 160^3 shape (each output within 1.5e-2 of the plain tensor's
largest, lse within 1e-4), and runs G twice on the same inputs: each dq
element within one bf16 rounding step of the other run's (2^-7 of its
magnitude, plus 1e-6 of the largest: its f32 sums arrive in a run-dependent
order), dk and dv bit for bit.

``--smoke`` also runs ``chip_smoke.py``'s kernel rows of F and G (its
``attention_rows``: the plain version's and ``scaled_dot_product_attention``'s
times beside the kernels'), unchanged, from the checkout timed.

``--repo PATH`` times the wrapper of another checkout (its
``fast_nnunet_tpu_torch``) instead: parent and change in turns, one call.

Prints one line per measurement and a JSON line last.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPE = (2, 8000, 12, 72)
CHECK_SHAPES = [(1, 45, 2, 72), (1, 128, 2, 72), (1, 129, 2, 72),
                (1, 130, 2, 66), (2, 257, 3, 72), (2, 1037, 12, 72), SHAPE]
BF16_FLOPS = 989e12


def inputs(torch, shape, seed=0):
    """Unit-norm q times a temperature of 10, unit-norm k, v read in place
    from a (B, T, 3, H, hd) qkv output, dO; bf16, as Primus gives them."""
    from torch.nn.functional import normalize
    B, T, H, hd = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = normalize(torch.randn(shape, device="cuda", generator=g), dim=-1) * 10
    k = normalize(torch.randn(shape, device="cuda", generator=g), dim=-1)
    v = torch.randn(B, T, 3, H, hd, device="cuda", generator=g).unbind(2)[2]
    do = torch.randn(shape, device="cuda", generator=g)
    return [t.bfloat16() for t in (q, k, v, do)]


def rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def check(torch, fa):
    worst = 0.0
    for shape in CHECK_SHAPES:
        q, k, v, do = inputs(torch, shape)
        m0 = fa.attention_backward.launches
        o, lse = fa.attention_forward(q, k, v)
        grads = fa.attention_backward(q, k, v, o, lse, do)
        again = fa.attention_backward(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        op, lp = fa.attention_forward_plain(q, k, v, block=500)
        want = fa.attention_backward_plain(q, k, v, op, lp, do, block=500)
        errs = [rel(a, b) for a, b in zip((o,) + tuple(grads),
                                          (op,) + tuple(want))]
        nan = any(bool(torch.isnan(t).any()) for t in grads)
        rerun = rel(again[0], grads[0])
        a0, g0 = again[0].float(), grads[0].float()
        step = bool(((a0 - g0).abs() <= g0.abs() * 2 ** -7
                     + 1e-6 * g0.abs().max()).all())
        same = all(bool(torch.equal(a, b)) for a, b in zip(again[1:],
                                                           grads[1:]))
        ok = (max(errs) <= 1.5e-2 and float((lse - lp).abs().max()) <= 1e-4
              and not nan and step and same
              and fa.attention_backward.launches - m0 == 4)
        worst = max(worst, max(errs[1:]))
        print(f"check {shape}: O, dq, dk, dv {['%.2e' % e for e in errs]}, "
              f"lse {float((lse - lp).abs().max()):.1e}, nan {nan}, rerun dq "
              f"{rerun:.1e} (one step {step}), dk dv bit-equal {same}: "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise SystemExit(f"kernel G against plain failed at {shape}")
        del q, k, v, do, o, lse, grads, again, op, lp, want
        torch.cuda.empty_cache()
    return worst


def time_g(torch, fa, n):
    q, k, v, do = inputs(torch, SHAPE)
    o, lse = fa.attention_forward(q, k, v)
    for _ in range(2):
        fa.attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fa.attention_backward(q, k, v, o, lse, do)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    B, T, H, hd = SHAPE
    bound = 10 * B * H * T * T * hd / BF16_FLOPS * 1e3
    return ms, bound


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--repo", default=None)
    ap.add_argument("--n", type=int, default=20)
    args = ap.parse_args()
    repo = os.path.abspath(args.repo or os.path.dirname(HERE))
    sys.path.insert(0, repo)
    import torch
    from fast_nnunet_tpu_torch.ops import _build
    from fast_nnunet_tpu_torch.ops import attention as fa
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: kernel G runs on the card only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; repo {repo}", flush=True)
    lib = _build.library()
    ptxas = _build.ptxas_report("attention")
    with open(os.path.join(os.path.dirname(lib._name), _build.PTXAS_LOG)) as f:
        for line in f:
            if "wgmma" in line or "Performance" in line:
                print("ptxas says:", line.strip())
    for name, rep in ptxas.items():
        print(f"ptxas: {name}: {rep}")
    worst = check(torch, fa) if args.check else None
    if args.smoke:
        import chip_smoke
        for row in chip_smoke.attention_rows(torch):
            print("smoke row:", json.dumps(row))
    ms, bound = time_g(torch, fa, args.n)
    print(f"G {ms:.4f} ms a call at {SHAPE}, bound {bound:.4f} ms: "
          f"{100 * bound / ms:.2f}%", flush=True)
    print(json.dumps({"repo": repo, "card": card.strip(), "g_ms": ms,
                      "bound_ms": bound, "share": bound / ms,
                      "worst_rel_err": worst,
                      "ptxas": {k: str(v) for k, v in ptxas.items()}}))


if __name__ == "__main__":
    main()
