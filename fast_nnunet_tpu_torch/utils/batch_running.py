"""Batch-running utilities — the port of fast_nnunet_tpu/utils/batch_running.py
(the reference's batch_running/*: sweep commands and result harvests).

The functions read the same ``summary.json`` and ``benchmark_result.json``
trees and write the same CSVs as the JAX package's. The command lines name
the port's console script, ``fast_nnunet_train_torch ... [-num_gpus N]``,
where the JAX package writes ``nnUNetv2_train``."""
import os
from typing import List, Sequence

import numpy as np

from . import io as ffo
from .misc import get_output_folder, maybe_convert_to_dataset_name

TRAIN_SCRIPT = "fast_nnunet_train_torch"


def _train_command(d, c, f, tr, p, command_prefix: str, num_gpus: int) -> str:
    cmd = (f"{TRAIN_SCRIPT} {d} {c} {f} -tr {tr} -p {p}"
           + (f" -num_gpus {num_gpus}" if num_gpus > 1 else ""))
    return (command_prefix + " " + cmd).strip()


def generate_training_commands(datasets: Sequence, configurations=("3d_fullres",),
                               folds=(0, 1, 2, 3, 4),
                               trainers=("NNUNetTrainer",),
                               plans=("nnUNetPlans",),
                               command_prefix: str = "",
                               num_gpus: int = 1) -> List[str]:
    return [_train_command(d, c, f, tr, p, command_prefix, num_gpus)
            for d in datasets for tr in trainers for p in plans
            for c in configurations for f in folds]


def collect_results(datasets: Sequence, output_csv: str,
                    configurations=("3d_fullres",), folds=(0, 1, 2, 3, 4),
                    trainers=("NNUNetTrainer",), plans=("nnUNetPlans",)) -> None:
    """Harvest fold validation summaries into one CSV (ref batch_running/
    collect_results_custom_Decathlon.py)."""
    rows = ["dataset,trainer,plans,configuration,fold,mean_fg_dice"]
    for d in datasets:
        name = maybe_convert_to_dataset_name(d)
        for tr in trainers:
            for p in plans:
                for c in configurations:
                    for f in folds:
                        summary = ffo.join(get_output_folder(name, tr, p, c),
                                           f"fold_{f}", "validation",
                                           "summary.json")
                        if not ffo.isfile(summary):
                            continue
                        s = ffo.load_json(summary)
                        rows.append(f"{name},{tr},{p},{c},{f},"
                                    f"{s['foreground_mean']['Dice']:.6f}")
    with open(output_csv, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    print(f"Wrote {len(rows) - 1} result rows to {output_csv}")


def summarize_benchmark_results(datasets: Sequence,
                                trainers=("NNUNetTrainerBenchmark_5epochs",
                                          "NNUNetTrainerBenchmark_5epochs_noDataLoading"),
                                plans=("nnUNetPlans",),
                                configurations=("3d_fullres", "2d")) -> List[dict]:
    """Collect benchmark_result.json entries (ref batch_running/benchmarking/
    summarize_benchmark_results.py)."""
    out = []
    for d in datasets:
        name = maybe_convert_to_dataset_name(d)
        for tr in trainers:
            for p in plans:
                for c in configurations:
                    f = ffo.join(get_output_folder(name, tr, p, c), "fold_0",
                                 "benchmark_result.json")
                    if ffo.isfile(f):
                        for k, v in ffo.load_json(f).items():
                            out.append({"dataset": name, "trainer": tr,
                                        "plans": p, "configuration": c,
                                        "env": k, **v})
    return out


def collect_results_wide(trainers: dict, datasets: Sequence, output_file: str,
                         configurations=("2d", "3d_fullres", "3d_lowres",
                                         "3d_cascade_fullres"),
                         folds=(0, 1, 2, 3, 4)) -> None:
    """One row per (dataset, config, trainer, plans) with a column per fold
    and the fold mean (ref collect_results_custom_Decathlon.py:13-40).
    ``trainers`` maps a trainer name to its plans identifiers."""
    from ..paths import get_results_folder
    rows = []
    for d in datasets:
        name = maybe_convert_to_dataset_name(d)
        for c in configurations:
            for tr, plans in trainers.items():
                for p in plans:
                    folder = get_output_folder(name, tr, p, c)
                    if not os.path.isdir(folder):
                        continue
                    cells = [name, c, tr, p, get_results_folder()]
                    per_fold = []
                    for f in folds:
                        summary = ffo.join(folder, f"fold_{f}", "validation",
                                           "summary.json")
                        if ffo.isfile(summary):
                            v = ffo.load_json(summary)["foreground_mean"]["Dice"]
                            per_fold.append(v)
                            cells.append(f"{v:02.4f}")
                        else:
                            print("expected output file not found:", summary)
                            per_fold.append(np.nan)
                            cells.append("")
                    cells.append(f"{np.nanmean(per_fold):02.4f}")
                    rows.append(",".join(cells))
    with open(output_file, "w") as fh:
        fh.write("\n".join(rows) + ("\n" if rows else ""))


def summarize_wide(input_file: str, output_file: str, folds: Sequence[int],
                   configs: Sequence[str], datasets: Sequence,
                   trainers: dict) -> None:
    """Pivot a :func:`collect_results_wide` CSV into one row per
    trainer__plans with a column per (dataset, config) fold mean and a
    trailing grand mean (ref collect_results_custom_Decathlon.py:43-92);
    a missing cell prints a warning and becomes nan."""
    txt = np.loadtxt(input_file, dtype=str, delimiter=",", ndmin=2)
    names = [maybe_convert_to_dataset_name(d) for d in datasets]
    valid_configs = {
        d: [c for c in np.unique(txt[:, 1][txt[:, 0] == d]) if c in configs]
        for d in names}

    with open(output_file, "w") as f:
        f.write("name")
        for d, cs in valid_configs.items():
            for c in cs:
                f.write(f",{d.split('_')[0][len('Dataset'):]}_{c[:4]}")
        f.write(",mean\n")
        for t, plans in trainers.items():
            for pl in plans:
                f.write(f"{t}__{pl}")
                r = []
                sel_tp = (txt[:, 2] == t) & (txt[:, 3] == pl)
                for d, cs in valid_configs.items():
                    for c in cs:
                        sel = sel_tp & (txt[:, 0] == d) & (txt[:, 1] == c)
                        idx = np.argwhere(sel)
                        fold_vals = (txt[idx[0, 0]][[i + 5 for i in folds]]
                                     if len(idx) else [""])
                        if len(idx) == 0 or "" in fold_vals:
                            print("missing:", t, pl, d, c)
                            f.write(",nan")
                            r.append(np.nan)
                        else:
                            m = float(np.mean([float(v) for v in fold_vals]))
                            f.write(f",{m:02.4f}")
                            r.append(m)
                f.write(f",{np.mean(r):02.4f}\n")


def generate_benchmark_commands(datasets: Sequence,
                                trainers=("NNUNetTrainerBenchmark_5epochs",
                                          "NNUNetTrainerBenchmark_5epochs_noDataLoading"),
                                plans=("nnUNetPlans",),
                                configurations=("2d", "3d_fullres"),
                                folds=(0,), command_prefix: str = "",
                                num_gpus: int = 1) -> List[str]:
    """Benchmark sweep command lines (ref batch_running/benchmarking/
    generate_benchmarking_commands.py: there LSF bsub lines with GPU model
    constraints; here plain shell with an optional scheduler prefix)."""
    return [_train_command(d, c, f, tr, p, command_prefix, num_gpus)
            for tr in trainers for p in plans for d in datasets
            for c in configurations for f in folds]


def benchmark_results_csv(datasets: Sequence, output_csv: str,
                          trainers=("NNUNetTrainerBenchmark_5epochs",
                                    "NNUNetTrainerBenchmark_5epochs_noDataLoading"),
                          plans=("nnUNetPlans",),
                          configurations=("2d", "3d_fullres")) -> None:
    """Pivot benchmark_result.json entries into a CSV with one column per
    environment key (ref benchmarking/summarize_benchmark_results.py pivots
    by gpu_name)."""
    entries = summarize_benchmark_results(datasets, trainers, plans,
                                          configurations)
    devices = sorted({e["env"] for e in entries})
    seen = {}
    for e in entries:
        key = (e["dataset"], e["trainer"], e["plans"], e["configuration"])
        seen.setdefault(key, {})[e["env"]] = e.get("fastest_epoch")
    with open(output_csv, "w") as f:
        f.write("Dataset,Trainer,Plans,Config" +
                "".join(f",{g}" for g in devices) + "\n")
        for key, per_dev in seen.items():
            cells = [f"{per_dev[g]:.2f}" if per_dev.get(g) is not None
                     else "MISSING" for g in devices]
            f.write(",".join(key) + "," + ",".join(cells) + "\n")
