"""One run of one cell: ``benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``. Prints the card's name and power limit,
then, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, the numbers compared with their
limits (also the last lines of standard error)."""
import argparse
import importlib
import sys

from . import common


def runner(name: str):
    """The mix's runner: benchmark/harness/<name>.py's ``run(ctx)``."""
    return importlib.import_module("benchmark.harness." + name).run


def measure(files: dict, seed: int, seconds: float, trace: bool, device,
            t0: float) -> dict:
    """Set up, warm up, run the window (and with ``trace`` the traced
    slice), judge the outputs. Returns the runner's record with the
    cell's metrics (``metrics``) and compared numbers (``checks``)."""
    ctx = {"config": files["config"], "traffic": files["traffic"],
           "seed": int(seed), "seconds": float(seconds), "trace": bool(trace),
           "teacher": files.get("teacher"), "device": device, "t0": t0}
    out = runner(files["traffic"]["runner"])(ctx)
    run = dict(out, **out.get("run", {}))
    wanted = files["per_layer"] if trace else files["end_to_end"]
    metrics = {}
    for m in wanted:
        v = common.metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    out["checks"] = common.checks_of(out["readings"], files["limits"])
    return out


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    files = common.cell_files(common.benchmark_spec(), args.workload)
    chips = int(files["cell"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2
    print("card: " + common.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    out = measure(files, args.seed, args.seconds, bool(args.trace), dev, t0)
    found = common.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; the port must not",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": common.passed(out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": device}
    if args.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["trace_window_s"]
        result["breakdown"] = out["breakdown"]
    common.emit(result, out["checks"])
    return 0
