"""What every cell shares: the files it is made of, found by name, and the
run's result line."""
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "fast_nnunet_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_files(spec: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic mix, limits and metrics,
    each read from the file its name points at."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    out = {"cell": cell,
           "config": load_json(os.path.join(ROOT, conf["file"])),
           "traffic": load_json(os.path.join(HERE, "traffic",
                                             cell["traffic"] + ".json")),
           "limits": load_json(os.path.join(HERE, "limits",
                                            workload + ".json")),
           "end_to_end": [m for m in spec["end_to_end"]
                          if workload in m.get("workloads", [workload])],
           "per_layer": [m for m in spec["per_layer"]
                         if workload in m.get("workloads", [workload])]}
    if out["traffic"].get("distill"):
        out["teacher"] = load_json(os.path.join(
            HERE, "configs",
            out["config"]["distillation"]["teacher_config"] + ".json"))
    return out


def metric_reader(name: str):
    """The ``read(run)`` of the metric's reader: the metric's value from
    the run's record, or None where the run has nothing to read. The
    reader is benchmark/metrics/<name>.py, or, for a quantity split by the
    cells it is read in (``idle.serve``, ``idle.train``), the file of the
    name with its last dotted parts taken off (``idle.py``)."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = os.path.join(HERE, "metrics", ".".join(parts[:n]) + ".py")
        if os.path.isfile(path):
            break
    else:
        raise FileNotFoundError(f"no reader for metric {name!r} in "
                                f"{os.path.join(HERE, 'metrics')}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list:
    """The JAX modules loaded (by whole top-level names: the port's
    ``fast_nnunet_tpu_torch`` is not the JAX package)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out


def quantile(values, q: float) -> float:
    """The q-th quantile (0-100) with linear interpolation between ranks."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def checks_of(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number the cell compares."""
    return {k: {"value": readings[k], "limit": limits[k]["limit"]}
            for k in limits if not k.startswith("_")}


def passed(checks: dict) -> bool:
    return all(c["value"] == c["value"] and c["value"] <= c["limit"]
               for c in checks.values())


def emit(result: dict, checks: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output (checks last)."""
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
