"""The Primus training runner: fed iterations of the configuration's
Primus trainer (``nnUNet_Primus_M_Trainer``) with the port's own loader
threads and augmentation, on the preprocessed store of the configuration
that ``store_config`` names (written once per checkout by
benchmark/harness/train.py ``ensure_store``, whose helpers this runner
uses as they are).

Set-up checks that the program has its fused attention (a program without
it cannot train the model at this patch, and the run stops at once), sets
the host's threads as the traffic file says (the loader's capped at the
host's cores), builds the trainer from plans of the store at the
configuration's patch and batch, draws its weights with the port's
``init_primus_`` from a seed drawn from ``--seed``, sets the schedule's
count where the configuration says a resumed job stands, and drives the
first steps through the window's own call and feed, keeping their rows for
the reference, the first moments after the first and the parameters after
the last; then a few more steps, then the window, which ends in a device
sync. A traced run keeps the program's phases and counters over the window
(the trainer's, the network's attention spans), then profiles a few tens
of iterations. ``readings`` gives the first steps' judgement without a
window (benchmark/control.py).

Work counted from the shapes (the runner's, not the program's): the
model FLOPs of a forward (:func:`forward_flops`), kernel F's QK^T and PV
(4 B H T^2 hd a launch, one a block a forward) and kernel G's five useful
products (10 B H T^2 hd a backward, two launches a block).
"""
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time

from . import train as tr
from .common import HERE, load_json
from .trace import profiled
from .traffic import rng

G_LAUNCHES = 2      # kernel G's launches a backward call (dq, dkdv passes)


def store_config(cfg: dict) -> dict:
    """The configuration whose store (and plans' data) this one trains on:
    ``store_config`` names its file under benchmark/configs/ (or is that
    configuration itself)."""
    own = cfg["store_config"]
    if isinstance(own, dict):
        return own
    return load_json(os.path.join(HERE, "configs", own + ".json"))


def plans(cfg: dict, owner: dict) -> dict:
    """The store's plans with this configuration's patch and batch."""
    p = tr.plans_of(owner)
    c = p["configurations"]["3d_fullres"]
    c["patch_size"] = list(cfg["training"]["patch_size"])
    c["batch_size"] = int(cfg["training"]["batch_size"])
    return p


def weight_seed(seed: int) -> int:
    return int(rng(seed, 7).integers(0, 2 ** 62))


def tokens(cfg: dict) -> int:
    return math.prod(p // e for p, e in zip(
        cfg["training"]["patch_size"], cfg["network"]["patch_embed_size"]))


def forward_flops(cfg: dict) -> int:
    """Model FLOPs of one Primus forward on the configuration's batch,
    from the shapes (2 a multiply-add): the patch embedding; per block the
    qkv, proj and SwiGLU linears and the QK^T and PV products; the
    transposed convolutions and the seg head. Norms, the rotation and the
    softmax are a few operations an element and are left out."""
    net = cfg["network"]
    E, pe, T = net["embed_dim"], net["patch_embed_size"], tokens(cfg)
    f = 2 * T * E * cfg["input_channels"] * math.prod(pe)
    f += net["depth"] * (2 * T * E * (4 * E + 3 * net["mlp_hidden"])
                         + attention_flops(cfg, 1))
    ch, vox = E, T
    for _ in range(int(math.log2(max(pe)))):
        out = max(ch // 2, 32)
        f += 2 * vox * ch * out * 8
        ch, vox = out, vox * 8
    f += 2 * vox * ch * cfg["num_classes"]
    return cfg["training"]["batch_size"] * f


def attention_flops(cfg: dict, batch=None) -> int:
    """QK^T and PV of one attention call: 4 B H T^2 hd (kernel F's work;
    kernel G's useful work is 2.5 times this)."""
    net = cfg["network"]
    B = cfg["training"]["batch_size"] if batch is None else batch
    return 4 * B * net["num_heads"] * tokens(cfg) ** 2 * net["head_dim"]


def step_work(cfg: dict) -> dict:
    """One iteration's model FLOPs (3 x the forward, no recompute) and each
    kernel's (launches, FLOPs)."""
    depth = cfg["network"]["depth"]
    fa = attention_flops(cfg)
    return {"flops": 3 * forward_flops(cfg),
            "F": (depth, depth * fa),
            "G": (G_LAUNCHES * depth, depth * 5 * fa // 2)}


def build(cfg: dict, mix: dict, seed: int, device, root: str):
    """(trainer, its step, the initial parameters {name: float32 on the
    host}, the results folder)."""
    from fast_nnunet_tpu_torch.models.primus import init_primus_
    from fast_nnunet_tpu_torch.run.run_training import find_trainer_class
    owner = store_config(cfg)
    h = dict(mix["host_threads"])
    h["loader"] = min(int(h["loader"]), os.cpu_count() or 1)
    tr.host_threads(dict(mix, host_threads=h))
    os.environ["nnUNet_preprocessed"] = os.path.join(root, "preprocessed")
    results = tempfile.mkdtemp(prefix="bench_results_")
    os.environ["nnUNet_results"] = results
    trainer = find_trainer_class(cfg["trainer"])(
        plans(cfg, owner), "3d_fullres", mix["fold"],
        tr.dataset_json(owner), device=device)
    ws = weight_seed(seed)
    trainer.init_network_weights = lambda net, _: init_primus_(net, ws)
    trainer.initialize()
    net, want = trainer.network, cfg["network"]
    got = {"embed_dim": net.embed_dim, "depth": net.depth,
           "num_heads": net.num_heads,
           "patch_embed_size": list(net.patch_embed_size),
           "patch_size": list(net.patch_size),
           "batch_size": trainer.configuration_manager.batch_size}
    expect = {k: want[k] for k in ("embed_dim", "depth", "num_heads",
                                   "patch_embed_size")}
    expect.update(patch_size=cfg["training"]["patch_size"],
                  batch_size=cfg["training"]["batch_size"])
    if got != expect:
        raise RuntimeError(f"the trainer built {got}, not {expect}")
    trainer.optimizer.count = int(cfg["training"]["optimizer"]["start_count"])
    p0 = {k: p.detach().float().cpu().clone()
          for k, p in net.named_parameters()}
    trainer.get_dataloaders()
    return trainer, trainer.train_step, p0, results


def first_steps(trainer, step, mix: dict, p0: dict, fault=None):
    """The first ``check_steps`` steps through the window's own call and
    feed. Returns (their rows on the host, the program's readings: each
    step's loss, every leaf's first-moment norm after the first, its change
    norm after the last). ``fault`` (data, targets) -> (data, targets)
    plants a fault in what the step is given."""
    import torch
    rows, prog = [], {"losses": []}
    named = dict(trainer.network.named_parameters())
    for s in range(int(mix["check_steps"])):
        data, targets = trainer.next_batch(trainer.dataloader_train)
        rows.append((data.cpu(), [t.cpu() for t in targets]))
        if fault is not None:
            data, targets = fault(data, targets)
        prog["losses"].append(float(step(data, targets)))
        if s == 0:
            state = trainer.optimizer.inner.state
            prog["first_grad"] = {
                k: float(state[p]["exp_avg"].norm())
                if "exp_avg" in state.get(p, {}) else 0.0
                for k, p in named.items()}
    with torch.no_grad():
        prog["change"] = {k: float((p.detach().float().cpu() - p0[k]).norm())
                          for k, p in named.items()}
    return rows, prog


def _free(trainer, results):
    import torch
    trainer.dataloader_train.shutdown()
    trainer.dataloader_val.shutdown()
    trainer.network = trainer.optimizer = trainer.train_step = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    shutil.rmtree(results, ignore_errors=True)


def _require_fused_attention():
    try:
        from fast_nnunet_tpu_torch.ops import attention  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "the program has no fused attention (fast_nnunet_tpu_torch."
            "ops.attention): its plain attention keeps (B, H, T, T) float32 "
            "tensors a layer and cannot train Primus at this patch") from e


def run(ctx: dict) -> dict:
    import torch
    from fast_nnunet_tpu_torch.utils.profiling import PhaseTimer
    _require_fused_attention()
    cfg, mix = ctx["config"], ctx["traffic"]
    dev, seed = ctx["device"], ctx["seed"]
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    root = tr.ensure_store(store_config(cfg), dev)
    trainer, step, p0, results = build(cfg, mix, seed, dev, root)
    loader = trainer.dataloader_train

    rows, prog = first_steps(trainer, step, mix, p0)
    for _ in range(int(mix["warm_steps"])):
        step(*trainer.next_batch(loader))
    sync()

    timer = None
    if ctx["trace"] and cuda:
        timer = PhaseTimer()
        trainer.timer = step.timer = trainer.network.timer = timer
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_open = time.perf_counter()
    n = 0
    while True:
        step(*trainer.next_batch(loader))
        n += 1
        if time.perf_counter() - t_open >= ctx["seconds"]:
            sync()
            break
    window = time.perf_counter() - t_open
    out = {"setup_s": t_open - ctx["t0"], "attempted": n, "failed": 0,
           "window_s": window}
    if cuda:
        out["train_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["memory_peak_bytes"] = out["train_peak_bytes"]
    run_info = {"n": n, "window_s": window}
    if timer is not None:
        run_info["phases_ms"] = timer.totals()
        trainer.timer = step.timer = trainer.network.timer = None
    if ctx["trace"] and cuda:
        k = int(mix["trace_iters"])
        sink: dict = {}
        with profiled(torch, sink):
            for _ in range(k):
                with torch.profiler.record_function("train.next_batch"):
                    batch = trainer.next_batch(loader)
                with torch.profiler.record_function("train.step"):
                    step(*batch)
        run_info["trace"] = sink
        per = step_work(cfg)
        run_info["flops"] = n * per["flops"]
        run_info["work"] = {name: (k * per[name][0], k * per[name][1])
                            for name in ("F", "G")}
        out["busy_s"], out["trace_window_s"] = sink["busy_s"], \
            sink["window_s"]
        out["breakdown"] = {"device_ops": sink["device_ops"],
                            "idle_gaps": sink["idle_gaps"]}
    out["run"] = run_info

    # ------------------------------------------------ the reference's turn
    _free(trainer, results)
    del trainer, step, loader
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    out["readings"] = judge(cfg, p0, rows, prog, dev)
    print(f"primus_train: {n} iterations in {window:.3f} s after a "
          f"{out['setup_s']:.3f} s set-up; reference over {len(rows)} steps "
          f"{time.perf_counter() - t_ref:.3f} s: {out['readings']}; losses "
          f"{prog['losses']}", file=sys.stderr)
    if "phases_ms" in run_info:     # not compared: the traced window's split
        print("primus_train: ms per iteration " + json.dumps(
            {k: v / n for k, v in run_info["phases_ms"].items()
             if not k.startswith("count:")}), file=sys.stderr)
    return out


def readings(files: dict, seed: int, mode: str, device) -> dict:
    """The compared numbers without a window: the first steps of the
    program (``mode`` "program"), given half of each batch
    ("half_batch"), or with its update planted to leave the state
    unchanged ("unchanged"); or the control's ("control"), the reference
    in float8 following the same rows in the program's place."""
    _require_fused_attention()
    cfg, mix = files["config"], files["traffic"]
    root = tr.ensure_store(store_config(cfg), device)
    trainer, step, p0, results = build(cfg, mix, seed, device, root)
    if mode == "unchanged":
        trainer.optimizer.step = lambda: None

    def half(data, targets):
        n = data.shape[0] // 2
        return data[:n], [t[:n] for t in targets]

    rows, prog = first_steps(trainer, step, mix, p0,
                             fault=half if mode == "half_batch" else None)
    _free(trainer, results)
    del trainer, step
    gc.collect()
    return judge(cfg, p0, rows, prog, device, quant=mode == "control")


def judge(cfg: dict, p0: dict, rows, prog, device, quant: bool = False
          ) -> dict:
    """The reference follows the first steps from the same weights and the
    rows' patches and labels; the numbers compared (reference/train.py
    ``judge``: the widest relative loss gap, the median moved leaf's gap of
    the first moment's norm and of the change's). With ``quant`` the
    control's readings."""
    import torch
    from ..reference import primus as ref
    from ..reference import train as rt
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = {k: v.to(device) for k, v in p0.items()}
        r = ref.follow(cfg, params, rows, device)
        if quant:
            prog = ref.follow(cfg, params, rows, device, quant=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    out = rt.judge(prog, r)
    for what in ("first_grad", "change"):
        print(f"primus_train: widest {what} leaves (leaf, gap, program, "
              f"reference, reference's raw gradient): "
              f"{rt.worst_leaves(prog[what], r[what], r['raw_grad'])}",
              file=sys.stderr)
    print(f"primus_train: losses program {prog['losses']}, reference "
          f"{r['losses']}", file=sys.stderr)
    return out
