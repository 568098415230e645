"""The training runners: fed iterations of ``NNUNetTrainer`` (or, for a
distillation cell, ``NNUNetDistillationTrainer``) with the port's own
loader threads and augmentation, on a preprocessed store the benchmark
writes once per checkout into benchmark/_cache/.

Set-up sets the host's threads as the traffic file says, builds the
trainer from plans the benchmark writes for the configuration, loads
weights drawn on the card from the seed through the port's weight API (a
distillation's teacher folds are checkpoints the benchmark writes once per
checkout, which the trainer loads itself), and drives the first steps through the window's own
call and feed, ``train_step(*next_batch(dataloader_train))``, keeping
their rows for the reference, the momentum after the first and the
parameters after the last; then a few more steps, then the window, which
ends in a device sync. The peak is read over the window. A traced run
keeps the trainer's CUDA-event phases over the window, then profiles a
few tens of iterations. ``readings`` gives the first steps' judgement
without a window (benchmark/control.py)."""
import gc
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

from . import grid, phantom, weights
from .common import HERE
from .trace import profiled
from .traffic import rng

PLANS = "nnUNetPlans"
DATASET = "Dataset900_BenchTrain"


def _arch(cfg: dict) -> dict:
    return {"network_class_name":
            "dynamic_network_architectures.architectures.unet.PlainConvUNet",
            "arch_kwargs": dict(
                cfg["network"], conv_op="torch.nn.modules.conv.Conv3d",
                norm_op="torch.nn.modules.instancenorm.InstanceNorm3d",
                dropout_op=None, dropout_op_kwargs=None,
                nonlin="torch.nn.LeakyReLU"),
            "_kw_requires_import": ["conv_op", "norm_op", "dropout_op",
                                    "nonlin"]}


def plans_of(cfg: dict, network=None) -> dict:
    """nnU-Net plans of the configuration's training, with ``network``
    (default: the configuration's own) as the 3d_fullres architecture."""
    tr = cfg["training"]
    rs = "resample_data_or_seg_to_shape"
    return {
        "dataset_name": DATASET, "plans_name": PLANS,
        "image_reader_writer": "NiftiIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel": {},
        "configurations": {"3d_fullres": {
            "data_identifier": PLANS + "_3d_fullres",
            "batch_size": tr["batch_size"], "patch_size": tr["patch_size"],
            "spacing": tr["spacing"],
            "normalization_schemes": ["CTNormalization"],
            "use_mask_for_norm": [False],
            "resampling_fn_data": rs,
            "resampling_fn_data_kwargs": {"is_seg": False, "order": 3},
            "resampling_fn_seg": rs,
            "resampling_fn_seg_kwargs": {"is_seg": True, "order": 1},
            "resampling_fn_probabilities": rs,
            "resampling_fn_probabilities_kwargs": {"is_seg": False,
                                                   "order": 1},
            "architecture": _arch({"network": network or cfg["network"]}),
            "batch_dice": tr["batch_dice"]}}}


def dataset_json(cfg: dict) -> dict:
    K = cfg["num_classes"]
    return {"name": DATASET, "numTraining": cfg["num_training_cases"],
            "file_ending": ".nii.gz", "channel_names": {"0": "CT"},
            "labels": {"background": 0,
                       **{f"structure_{c}": c for c in range(1, K)}}}


def make_case(cfg: dict, i: int, device):
    """One preprocessed case made on the card: a phantom, clipped and
    z-scored, and its labels: the voxels above 150 HU (bone), in
    (K - 1) / 2 bands along z, each split into left and right."""
    import torch
    nm = cfg["training"]["normalization"]
    store = cfg["store"]
    z, y, x = cfg["case_shape"]
    gen = torch.Generator(device=device).manual_seed(
        int(store["seed"]) * 1000 + i)
    ct = phantom.make_ct((x, y, z), gen, device).float()
    data = (ct.clamp(nm["lower_bound"], nm["upper_bound"]) - nm["mean"]) \
        / nm["std"]
    bands = (cfg["num_classes"] - 1) // 2
    zi = torch.arange(z, device=device)[:, None, None] * bands // z
    right = (torch.arange(x, device=device) >= x // 2)[None, None, :]
    seg = torch.where(ct > 150, 1 + 2 * zi + right, torch.zeros_like(zi))
    return (data[None].cpu().numpy(),
            seg[None].to(torch.int8).cpu().numpy())


def store_root(cfg: dict) -> str:
    """benchmark/_cache/train-<key>: one store per configuration's store,
    written by the checkout's first run (a marker file is written last)."""
    key = hashlib.sha256(json.dumps(
        [cfg["store"], cfg["case_shape"], cfg["num_training_cases"],
         cfg["num_classes"], cfg["training"]],
        sort_keys=True).encode()).hexdigest()[:12]
    return os.path.join(HERE, "_cache", f"train-{key}")


def ensure_store(cfg: dict, device) -> str:
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    from fast_nnunet_tpu_torch.training.dataset import NpyCaseDataset
    root = store_root(cfg)
    pre = os.path.join(root, "preprocessed", DATASET)
    if os.path.isfile(os.path.join(root, "complete")):
        return root
    shutil.rmtree(root, ignore_errors=True)
    folder = os.path.join(pre, PLANS + "_3d_fullres")
    os.makedirs(folder)
    K = cfg["num_classes"]
    sp = cfg["training"]["spacing"]
    for i in range(cfg["num_training_cases"]):
        data, seg = make_case(cfg, i, device)
        shape = list(seg.shape[1:])
        props = {"class_locations":
                 DefaultPreprocessor._sample_foreground_locations(
                     seg, list(range(1, K))),
                 "spacing": sp, "shape_before_cropping": shape,
                 "bbox_used_for_cropping": [[0, s] for s in shape],
                 "shape_after_cropping_and_before_resampling": shape}
        NpyCaseDataset.save_case(data, seg, props,
                                 os.path.join(folder, f"case_{i:03d}"))
    for name, obj in ((PLANS + ".json", plans_of(cfg)),
                      ("dataset.json", dataset_json(cfg))):
        with open(os.path.join(pre, name), "w") as f:
            json.dump(obj, f)
    open(os.path.join(root, "complete"), "w").close()
    return root


def ensure_teachers(teacher: dict, dist: dict, device) -> str:
    """benchmark/_cache/teachers-<key>: the teacher configuration's plans
    (plans.json) and, for each fold f, fold_f/checkpoint_final.fnnx with
    weights drawn on the card from the fold's seed, written with the port's
    checkpoint writer by the checkout's first run (a marker file last)."""
    from fast_nnunet_tpu_torch.training.checkpoint import save_checkpoint
    K, C = teacher["num_classes"], teacher["input_channels"]
    key = hashlib.sha256(json.dumps(
        [teacher["network"], teacher["training"], K, C,
         dist["teacher_seed"], dist["teacher_folds"]],
        sort_keys=True).encode()).hexdigest()[:12]
    root = os.path.join(HERE, "_cache", f"teachers-{key}")
    if os.path.isfile(os.path.join(root, "complete")):
        return root
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    with open(os.path.join(root, "plans.json"), "w") as f:
        json.dump(plans_of(teacher), f)
    for fold, seed in enumerate(teacher_seeds(dist)):
        _, tree_np = weights.make_tree(teacher["network"], C, K, seed, device)
        os.makedirs(os.path.join(root, f"fold_{fold}"))
        save_checkpoint(os.path.join(root, f"fold_{fold}",
                                     "checkpoint_final.fnnx"),
                        network_weights=tree_np)
    open(os.path.join(root, "complete"), "w").close()
    return root


def teacher_seeds(dist: dict) -> list:
    """Each teacher fold's weight seed, drawn from ``teacher_seed``."""
    return [int(rng(dist["teacher_seed"], 4, f).integers(0, 2 ** 62))
            for f in range(int(dist["teacher_folds"]))]


def host_threads(mix: dict) -> None:
    """The host's threads as the mix states them: torch's intra- and
    inter-op pools (nnU-Net v2's run_training sets both to 1 on a GPU) and
    the loader's threads (``nnUNet_n_proc_DA``)."""
    import torch
    h = mix.get("host_threads", {})
    if "loader" in h:
        os.environ["nnUNet_n_proc_DA"] = str(int(h["loader"]))
    if "torch_intra_op" in h:
        torch.set_num_threads(int(h["torch_intra_op"]))
    if "torch_inter_op" in h:
        try:
            torch.set_num_interop_threads(int(h["torch_inter_op"]))
        except RuntimeError:      # set once per process; a test's later cell
            pass


def param_norms(net, fn):
    """{flax path: float(fn(tensor))} over the network's parameters."""
    from fast_nnunet_tpu_torch.models.unet import jax_param_paths
    return {"/".join(p): float(fn(t)) for p, t, _ in jax_param_paths(net)
            if p[0] == "params"}


def torch_layout(tree_dev: dict, net):
    """The plain tree's leaves in the network's own layout, by flax path
    (conv (O, I, *k); a transposed conv (I, O, *k), unmirrored)."""
    from fast_nnunet_tpu_torch.models.unet import jax_param_paths
    from ..reference.unet import conv_weight, transp_weight
    out = {}
    for p, t, kind in jax_param_paths(net):
        v = tree_dev
        for k in p:
            v = v[k]
        out["/".join(p)] = conv_weight(v) if kind == "conv" else \
            transp_weight(v) if kind == "transpconv" else v
    return out


def roles(cfg: dict, teacher):
    """(the configuration that owns the plans and the store, the trained
    network's configuration, the teachers' configuration or None). A
    distillation cell's configuration is the student's; its teachers,
    plans and store are those of ``distillation.teacher_config``."""
    if teacher is None:
        return cfg, cfg, None
    return teacher, dict(teacher, network=cfg["network"],
                         distillation=cfg["distillation"]), teacher


def build(cfg: dict, teacher_cfg, mix: dict, seed: int, device, root: str):
    """(trainer, its step, the trained network's plain tree (numpy), the
    results folder). A distillation trainer's plans hold the
    configuration's ``student_plans_network`` (the port builds its student
    from them, widths divided by ``feature_reduction_factor``)."""
    from fast_nnunet_tpu_torch.models.unet import params_from_jax
    owner, student, teacher = roles(cfg, teacher_cfg)
    host_threads(mix)
    os.environ["nnUNet_preprocessed"] = os.path.join(root, "preprocessed")
    results = tempfile.mkdtemp(prefix="bench_results_")
    os.environ["nnUNet_results"] = results
    dj = dataset_json(owner)
    K, C = cfg["num_classes"], cfg["input_channels"]
    if teacher is not None:
        dist = student["distillation"]
        plans = plans_of(owner, dist["student_plans_network"])
        trainer = _distill_trainer(dist, mix, device, plans, dj,
                                   ensure_teachers(teacher, dist, device))
    else:
        plans = plans_of(owner)
        from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer
        trainer = NNUNetTrainer(plans, "3d_fullres", mix["fold"], dj,
                                device=device)
        trainer.initialize()
    _, tree_np = weights.make_tree(student["network"], C, K, seed, device)
    params_from_jax(trainer.network, tree_np)
    trainer.get_dataloaders()
    step = trainer.distill_step if teacher is not None else \
        trainer.train_step
    return trainer, step, tree_np, results


def _distill_trainer(dist: dict, mix: dict, device, plans: dict, dj: dict,
                     teacher_folder: str):
    """A distillation trainer that loads its teacher folds from
    ``teacher_folder`` (:func:`ensure_teachers`) with its own
    ``load_teacher_model``."""
    from fast_nnunet_tpu_torch.training.distill import \
        NNUNetDistillationTrainer
    trainer = NNUNetDistillationTrainer(
        plans, "3d_fullres", mix["fold"], dj, device=device,
        teacher_model_folder=teacher_folder,
        teacher_fold=list(range(int(dist["teacher_folds"]))),
        alpha=dist["alpha"], temperature=dist["temperature"],
        feature_reduction_factor=dist["feature_reduction_factor"])
    trainer.initialize()
    return trainer


def run(ctx: dict) -> dict:
    import torch
    from fast_nnunet_tpu_torch.inference.engine import PhaseTimer
    cfg, mix = ctx["config"], ctx["traffic"]
    dev, seed = ctx["device"], ctx["seed"]
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    owner, student, teacher = roles(cfg, ctx.get("teacher"))
    root = ensure_store(owner, dev)
    trainer, step, tree_np, results = build(
        cfg, ctx.get("teacher"), mix, seed, dev, root)
    loader = trainer.dataloader_train

    rows, prog = first_steps(trainer, step, mix, tree_np, dev,
                             teacher is not None)
    for _ in range(int(mix["warm_steps"])):
        step(*trainer.next_batch(loader))
    sync()

    timer = None
    if ctx["trace"] and cuda:
        timer = PhaseTimer()
        trainer.timer = step.timer = timer
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
        trainer.timer = step.timer = None
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
        per = step_work(owner, student, teacher)
        run_info["flops"] = n * per["flops"]
        a_per_pass = per["A"]
        launches = sink["kernels"].get("A", (0, 0))[1]
        for r in (1, 2):          # remat recomputes each trained norm once
            want = k * (r * a_per_pass["train"][0] + a_per_pass["eval"][0])
            if launches == want:
                run_info["work"] = {"A": (want, k * (
                    r * a_per_pass["train"][1] + a_per_pass["eval"][1]))}
        out["busy_s"], out["trace_window_s"] = sink["busy_s"], \
            sink["window_s"]
        out["breakdown"] = {"device_ops": sink["device_ops"],
                            "idle_gaps": sink["idle_gaps"]}
    out["run"] = run_info

    # ------------------------------------------------ the reference's turn
    trainer.dataloader_train.shutdown()
    trainer.dataloader_val.shutdown()
    del trainer, step, loader
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    shutil.rmtree(results, ignore_errors=True)
    t_ref = time.perf_counter()
    out["readings"] = judge(student, teacher, tree_np, rows, prog, dev)
    print(f"train: {n} iterations in {window:.3f} s after a "
          f"{out['setup_s']:.3f} s set-up; reference over "
          f"{len(rows)} steps {time.perf_counter() - t_ref:.3f} s: "
          f"{out['readings']}; losses {prog['losses']}", file=sys.stderr)
    return out


def readings(files: dict, seed: int, mode: str, device) -> dict:
    """The compared numbers without a window: the first steps of the
    program (``mode`` "program"), given half of each batch
    ("half_batch"), or with its update planted to leave the state
    unchanged ("unchanged"); or the control's ("control"), the reference
    in float8 following the same rows in the program's place."""
    import torch
    cfg, mix = files["config"], files["traffic"]
    owner, student, teacher = roles(cfg, files.get("teacher"))
    root = ensure_store(owner, device)
    trainer, step, tree_np, results = build(
        cfg, files.get("teacher"), mix, seed, device, root)

    if mode == "unchanged":
        trainer.optimizer.step = lambda: None

    def half(data, targets):
        n = data.shape[0] // 2
        return data[:n], [t[:n] for t in targets]

    rows, prog = first_steps(
        trainer, step, mix, tree_np, device, teacher is not None,
        fault=half if mode == "half_batch" else None)
    trainer.dataloader_train.shutdown()
    trainer.dataloader_val.shutdown()
    del trainer, step
    shutil.rmtree(results, ignore_errors=True)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return judge(student, teacher, tree_np, rows, prog, device,
                 quant=mode == "control")


def first_steps(trainer, step, mix: dict, tree_np, device, distill: bool,
                fault=None):
    """The first ``check_steps`` steps through the window's own call and
    feed. Returns (their rows on the host, the program's readings: each
    step's loss, every leaf's momentum norm after the first, its change
    norm after the last). ``fault`` (data, targets) -> (data, targets)
    plants a fault in what the step is given."""
    import torch
    rows, prog = [], {"losses": []}
    p0 = torch_layout(weights.to_device(tree_np, device), trainer.network)
    for s in range(int(mix["check_steps"])):
        data, targets = trainer.next_batch(trainer.dataloader_train)
        rows.append((data.cpu(), [t.cpu() for t in targets]))
        if fault is not None:
            data, targets = fault(data, targets)
        loss = step(data, targets)
        prog["losses"].append(float(loss[0] if distill else loss))
        if s == 0:
            state = trainer.optimizer.inner.state
            prog["first_grad"] = param_norms(
                trainer.network,
                lambda t: state[t]["momentum_buffer"].norm()
                if "momentum_buffer" in state.get(t, {}) else torch.zeros(()))
    prog["change"] = {k: float((t - p0[k]).norm()) for k, t in
                      _named_params(trainer.network).items()}
    return rows, prog


def _named_params(net):
    from fast_nnunet_tpu_torch.models.unet import jax_param_paths
    return {"/".join(p): t.detach() for p, t, _ in jax_param_paths(net)
            if p[0] == "params"}


def step_work(owner: dict, student: dict, teacher) -> dict:
    """Model FLOPs of one iteration (3 x the trained network's forward
    with its heads, 1 x each teacher's, no recompute) and kernel A's
    launches and bytes per pass of the trained network ("train") and of
    the teachers together ("eval")."""
    tr = owner["training"]
    B, patch = tr["batch_size"], tr["patch_size"]
    K, C = owner["num_classes"], owner["input_channels"]
    flops = 3 * B * grid.unet_forward_flops(student["network"], C, K, patch,
                                            True)
    sh = grid.gated_norm_shapes(student["network"], patch, B, s2d=False)
    a = {"train": (len(sh), sum(grid.bytes_a(s) for s in sh)),
         "eval": (0, 0)}
    if teacher is not None:
        nt = int(student["distillation"]["teacher_folds"])
        flops += nt * B * grid.unet_forward_flops(teacher["network"], C, K,
                                                  patch, False)
        st = grid.gated_norm_shapes(teacher["network"], patch, B, s2d=False)
        a["eval"] = (nt * len(st), nt * sum(grid.bytes_a(s) for s in st))
    return {"flops": flops, "A": a}


def judge(student: dict, teacher, tree_np, rows, prog, device,
          quant: bool = False) -> dict:
    """The reference follows the first steps from the same weights (the
    teachers' drawn again from their seeds) and the rows' patches and
    full-resolution labels; the numbers compared (reference/train.py
    ``judge``). With ``quant`` the control's readings."""
    import torch
    from ..reference import train as ref
    from ..reference.unet import PlainUNet
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mean_teacher = None
        if teacher is not None:
            K, C = teacher["num_classes"], teacher["input_channels"]
            nets = [PlainUNet(teacher["network"], weights.make_tree(
                teacher["network"], C, K, s, device)[0])
                for s in teacher_seeds(student["distillation"])]

            def mean_teacher(x):
                return sum(n(x) for n in nets) / len(nets)
        tree = weights.to_device(tree_np, device)
        r = ref.follow(student, tree, rows, device, teacher=mean_teacher)
        if quant:
            prog = ref.follow(student, tree, rows, device, quant=True,
                              teacher=mean_teacher)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    readings = ref.judge(prog, r)
    # not compared: the share of a level's labels in which the program's
    # deep-supervision labels differ from nnU-Net's (PERF.md)
    readings["ds_targets_differ"] = ref.ds_mismatch(
        rows, student["network"]["strides"])
    for what in ("first_grad", "change"):
        print(f"train: widest {what} leaves (leaf, gap, program, "
              f"reference, reference's raw gradient): "
              f"{ref.worst_leaves(prog[what], r[what], r['raw_grad'])}",
              file=sys.stderr)
    excluded = sorted(set(r["raw_grad"]) - ref.moved_leaves(r["raw_grad"]))
    print(f"train: {len(excluded)} leaves unmoved by the reference's first "
          f"gradient: {excluded}", file=sys.stderr)
    return readings
