"""The serving runner: a closed loop of CT studies through
``TurboPipeline.predict_volume`` on its default (device) route, one study
at a time, as a worker drains a queue of studies.

Set-up builds the pipeline from the configuration with weights drawn on
the card from the seed, makes the cycle's phantoms on the card and moves
them to host memory (where the timed path takes them), and serves each
study once (every shape the window will see). The window serves the cycle
in order, again and again, and closes at the first completion at or after
``seconds``. A traced run keeps the engine's CUDA-event phases over the
window and then profiles a few studies. The reference judges a sample of
the served masks once the window has closed and the program is freed.
``readings`` gives the same judgement without a window (benchmark/
control.py)."""
import gc
import sys
import time

import numpy as np

from . import grid, phantom, traffic, weights
from .trace import profiled


def build(cfg: dict, seed: int, device):
    """(pipeline, the s2d parameter tree, the plain tree on the card)."""
    import torch
    from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
    from fast_nnunet_tpu_torch.inference.turbo import (TurboConfig,
                                                       TurboPipeline)
    from fast_nnunet_tpu_torch.models.s2d import make_s2d_engine_net
    sv, nm = cfg["serving"], cfg["serving"]["normalization"]
    K = cfg["num_classes"]
    tcfg = TurboConfig(patch_size=sv["patch_size"],
                       target_spacing=sv["target_spacing"], mean=nm["mean"],
                       std=nm["std"], lower_bound=nm["lower_bound"],
                       upper_bound=nm["upper_bound"], num_classes=K,
                       step_size=sv["step_size"],
                       use_gaussian=sv["use_gaussian"])
    net = make_s2d_engine_net(cfg["network"], K, cfg["input_channels"],
                              compute_dtype=torch.bfloat16).to(device)
    tree_dev, tree_np = weights.make_tree(cfg["network"],
                                          cfg["input_channels"], K, seed,
                                          device)
    s2d_tree = net.convert_params(tree_np)
    engine = SlidingWindowEngine(
        net, tcfg.patch_size, K, tile_step_size=sv["step_size"],
        use_gaussian=sv["use_gaussian"], compute_dtype=torch.bfloat16,
        sweep_acc_dtype=torch.bfloat16, shape_bucket=grid.SHAPE_BUCKET,
        tile_batch=sv["tile_batch"], device=device)
    pipe = TurboPipeline(engine, tcfg, air_skip=sv["skip_air_tiles"],
                         air_margin_hu=sv["air_margin_hu"])
    return pipe, s2d_tree, tree_dev


def studies(mix: dict, seed: int, device):
    """The cycle's CTs on the host: [(int16 (z, y, x), spacing)]."""
    import torch
    out = []
    for i, (shape, spacing) in enumerate(traffic.serve_studies(mix)):
        gen = torch.Generator(device=device).manual_seed(
            traffic.phantom_seed(seed, i))
        out.append((phantom.make_ct(shape, gen, device).cpu().numpy(),
                    spacing))
    return out


def work(cfg: dict, ct: np.ndarray, spacing, device) -> dict:
    """What one study asks of the network and of kernels A, B, C and E,
    counted from its geometry and the air rule: tiles kept, model FLOPs,
    and each kernel's launches and bytes (A and E per forward: the norms
    whose statistics A takes, and every norm, which E applies)."""
    from ..reference import serve as ref
    sv = cfg["serving"]
    vol, geo, fill, thr = ref.preprocess(cfg, ct, spacing, device)
    flags, coords, _ = ref.body_tiles(cfg, vol, geo, fill, thr)
    del vol
    tf, _, _, vol_shape, steps = geo
    patch = [sv["patch_size"][a] for a in tf]
    K, arch = cfg["num_classes"], cfg["network"]
    plane_h = (vol_shape[1] // 2, vol_shape[2] // 2)
    B = coords.shape[1]
    runs = flags.any(axis=2)                       # (chunks, nb)
    forwards = int(runs.sum())
    a_shapes = grid.gated_norm_shapes(arch, patch, B, s2d=True)
    e_shapes = grid.gated_norm_shapes(arch, patch, B, s2d=True, min_voxels=0)
    c_bytes = sum(
        grid.bytes_c(coords[b] // 2, flags[k, b], patch[0] // 2,
                     (patch[1] // 2, patch[2] // 2), plane_h,
                     arch["features_per_stage"][0], K)
        for k in range(flags.shape[0]) for b in range(flags.shape[1])
        if runs[k, b])
    last = len(steps[0]) - 1
    b_bytes = sum(grid.bytes_b(grid.owned_rows(steps[0], k, patch[0]),
                               plane_h, K, zeroes=k != last)
                  for k in range(len(steps[0])))
    kept = int(flags.sum())
    return {"tiles": kept,
            "flops": kept * grid.unet_forward_flops(
                arch, cfg["input_channels"], K, patch, False),
            "A": (forwards * len(a_shapes),
                  forwards * sum(grid.bytes_a(s) for s in a_shapes)),
            "B": (len(steps[0]), b_bytes),
            "C": (forwards, c_bytes),
            "E": (forwards * len(e_shapes),
                  forwards * sum(grid.bytes_e(s) for s in e_shapes))}


def run(ctx: dict) -> dict:
    import torch
    cfg, mix = ctx["config"], ctx["traffic"]
    dev, seed = ctx["device"], ctx["seed"]
    cuda = dev.type == "cuda"
    pipe, s2d_tree, tree_dev = build(cfg, seed, dev)
    cts = studies(mix, seed, dev)
    for ct, sp in cts:                       # every shape of the window
        pipe.predict_volume(s2d_tree, ct, sp)
    if cuda:
        torch.cuda.synchronize()
    timer = None
    if ctx["trace"] and cuda:
        from fast_nnunet_tpu_torch.inference.engine import PhaseTimer
        timer = pipe.engine.timer = PhaseTimer()

    n = len(cts)
    lat, kept, order = [], {}, []
    t_open = time.perf_counter()
    i = 0
    while True:
        j = i % n
        ct, sp = cts[j]
        ts = time.perf_counter()
        mask = pipe.predict_volume(s2d_tree, ct, sp)
        te = time.perf_counter()
        lat.append(te - ts)
        order.append(j)
        kept.setdefault(j, mask)
        i += 1
        if te - t_open >= ctx["seconds"]:
            break
    window = te - t_open
    out = {"setup_s": t_open - ctx["t0"], "attempted": len(lat), "failed": 0,
           "latencies": lat, "window_s": window}
    run_info = {"n": len(lat), "window_s": window}
    if cuda:
        torch.cuda.synchronize()
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    if timer is not None:
        run_info["phases_ms"] = timer.totals()
        pipe.engine.timer = None
    if ctx["trace"] and cuda:
        traced = list(range(min(int(mix.get("trace_cts", 3)), n)))
        sink: dict = {}
        with profiled(torch, sink):
            for j in traced:
                with torch.profiler.record_function("serve.predict_volume"):
                    pipe.predict_volume(s2d_tree, *cts[j])
        run_info["trace"] = sink
        w = {j: work(cfg, *cts[j], dev) for j in sorted(set(order))}
        run_info["flops"] = sum(w[j]["flops"] for j in order)
        run_info["work"] = {k: tuple(map(sum, zip(*(w[j][k] for j in traced))))
                            for k in ("A", "B", "C", "E")}
        out["busy_s"], out["trace_window_s"] = sink["busy_s"], \
            sink["window_s"]
        out["breakdown"] = {"device_ops": sink["device_ops"],
                            "idle_gaps": sink["idle_gaps"]}
    out["run"] = run_info

    # ------------------------------------------------ the reference's turn
    pick = sample(mix, seed, cts, kept)
    masks = {j: kept[j] for j in pick}
    del pipe, s2d_tree, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    out["readings"] = judge(cfg, [(cts[j], masks[j]) for j in pick],
                            tree_dev, dev)
    print(f"serve: {len(lat)} studies in {window:.3f} s after a "
          f"{out['setup_s']:.3f} s set-up; reference over studies {pick} "
          f"{time.perf_counter() - t_ref:.3f} s: {out['readings']}",
          file=sys.stderr)
    return out


def readings(files: dict, seed: int, mode: str, device) -> dict:
    """The compared numbers without a window: the program serves the
    sampled studies of one pass over the cycle (``mode`` "program"), or the
    control, the reference in float8, serves them in its place (any other
    mode)."""
    import torch
    cfg, mix = files["config"], files["traffic"]
    pipe, s2d_tree, tree_dev = build(cfg, seed, device)
    cts = studies(mix, seed, device)
    pick = sample(mix, seed, cts, range(len(cts)))
    masks = {j: (pipe.predict_volume(s2d_tree, *cts[j])
                 if mode == "program" else None) for j in pick}
    del pipe, s2d_tree
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return judge(cfg, [(cts[j], masks[j]) for j in pick], tree_dev, device)


def sample(mix: dict, seed: int, cts, done) -> list:
    """The studies the reference judges: the longest of those served, and
    ``check_cts - 1`` others drawn from the seed."""
    done = sorted(done)
    longest = max(done, key=lambda j: int(np.prod(cts[j][0].shape)))
    others = [j for j in done if j != longest]
    return [longest] + [int(j) for j in traffic.rng(seed, 3).permutation(
        others)[:max(0, int(mix.get("check_cts", 2)) - 1)]]


def judge(cfg: dict, cases, tree_dev, device) -> dict:
    """The widest gap and the exact mismatches over the sampled studies
    ((ct, spacing), mask). A mask of None puts the control in the
    program's place: the reference in float8 serves the study."""
    import torch
    from ..reference import serve as ref
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        gap, exact, dis = 0.0, 0, 0.0
        for (ct, sp), mask in cases:
            if mask is None:
                Lq, cov, geo = ref.logits(cfg, ct, sp, tree_dev, device,
                                          quant=True)
                mask = ref.served_like(Lq, cov, geo)
                del Lq, cov
            L, cov, geo = ref.logits(cfg, ct, sp, tree_dev, device)
            r = ref.judge(L, cov, geo, mask)
            gap, exact = max(gap, r["gap"]), exact + r["exact_mismatch"]
            dis = max(dis, r["disagree"])
            del L, cov
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    return {"gap": gap, "exact_mismatch": exact, "disagree_share": dis}
