"""Readings of a cell's compared numbers without a measured window, for
setting its limits (PERF.md says which reading set which limit):

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        --mode program|control|half_batch|unchanged

- ``program``: the program's own readings (serving: one pass over the
  cycle, the sample a run judges; training: the first steps);
- ``control``: the reference computed in float8 e4m3 (the nearest
  precision below the configuration's bfloat16) in the program's place;
- ``half_batch`` (training): the program's steps given half of each
  batch, the mean taken over the rest;
- ``unchanged`` (training): the program's update planted to leave the
  state unchanged.

The benchmark's own runs never run this. It prints one JSON line per
seed."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"

from benchmark.harness import common  # noqa: E402


def serve_readings(files: dict, seed: int, mode: str, device) -> dict:
    import torch
    from benchmark.harness import serve
    cfg, mix = files["config"], files["traffic"]
    pipe, s2d_tree, tree_dev = serve.build(cfg, seed, device)
    cts = serve.studies(mix, seed, device)
    pick = serve.sample(mix, seed, cts, range(len(cts)))
    masks = {j: (pipe.predict_volume(s2d_tree, *cts[j])
                 if mode == "program" else None) for j in pick}
    del pipe, s2d_tree
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return serve.judge(cfg, [(cts[j], masks[j]) for j in pick], tree_dev,
                       device)


def train_readings(files: dict, seed: int, mode: str, device) -> dict:
    import torch
    from benchmark.harness import train
    cfg, mix = files["config"], files["traffic"]
    owner, student, teacher = train.roles(cfg, files.get("teacher"))
    root = train.ensure_store(owner, device)
    trainer, step, tree_np, results = train.build(
        cfg, files.get("teacher"), mix, seed, device, root)

    if mode == "unchanged":
        trainer.optimizer.step = lambda: None

    def half(data, targets):
        n = data.shape[0] // 2
        return data[:n], [t[:n] for t in targets]

    rows, prog = train.first_steps(
        trainer, step, mix, tree_np, device, teacher is not None,
        fault=half if mode == "half_batch" else None)
    trainer.dataloader_train.shutdown()
    trainer.dataloader_val.shutdown()
    del trainer, step
    shutil.rmtree(results, ignore_errors=True)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return train.judge(student, teacher, tree_np, rows, prog, device,
                       quant=mode == "control")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True, choices=(
        "program", "control", "half_batch", "unchanged"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    files = common.cell_files(common.benchmark_spec(), args.workload)
    dev = torch.device("cuda", 0)
    readings = serve_readings if files["traffic"]["runner"] == "serve" \
        else train_readings
    print("card: " + common.card_line(), flush=True)
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = readings(files, int(s), args.mode, dev)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": int(s), "readings": r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
