"""Readings of a cell's compared numbers without a measured window, for
setting its limits (PERF.md says which reading set which limit):

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        --mode program|control|half_batch|unchanged

The cell's runner computes them (benchmark/harness/<runner>.py
``readings``):

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
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"

from benchmark.harness import common  # noqa: E402


def readings(runner: str):
    """The cell's runner's ``readings(files, seed, mode, device)``:
    benchmark/harness/<runner>.py owns its controls, as it owns its
    ``run``."""
    mod = importlib.import_module("benchmark.harness." + runner)
    fn = getattr(mod, "readings", None)
    if not callable(fn):
        raise AttributeError(f"runner module {mod.__name__} defines no "
                             "readings(files, seed, mode, device)")
    return fn


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
    read = readings(files["traffic"]["runner"])
    print("card: " + common.card_line(), flush=True)
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = read(files, int(s), args.mode, dev)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": int(s), "readings": r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
