"""Every cell's files load by the names BENCHMARK.json gives them (its
runner's module with ``run`` and ``readings``, which control.py reaches),
the kernel files register, and the file keeps to the run contract's
shape."""
import importlib
import json
import os
import re
import sys
import types

import pytest

from benchmark import control, kernels
from benchmark.harness import common, grid

SPEC = common.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_load(w):
    files = common.cell_files(SPEC, w)
    runner = files["traffic"]["runner"]
    assert os.path.isfile(os.path.join(common.HERE, "harness",
                                       runner + ".py"))
    mod = importlib.import_module("benchmark.harness." + runner)
    assert callable(mod.run) and callable(mod.readings)
    assert files["limits"]
    names = [m["name"] for m in files["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert files["per_layer"]
    for m in files["end_to_end"] + files["per_layer"]:
        assert callable(common.metric_reader(m["name"]))
    assert files["cell"]["chips"] == 1
    assert len(files["cell"]["why"]) <= 200


@pytest.mark.parametrize("c", SPEC["configs"])
def test_config_files(c):
    with open(os.path.join(common.ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"]
    assert cfg["reduced"] == c["reduced"]
    assert all(k in cfg for k in c["reduced"])


def test_names_and_moves():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"] + SPEC["workloads"] \
            + SPEC["configs"]:
        assert NAME.match(m["name"]), m["name"]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in cells and w in moved.get("workloads", cells)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("runner", ["serve", "train"])
def test_control_reaches_the_runners_readings(runner):
    mod = importlib.import_module("benchmark.harness." + runner)
    assert control.readings(runner) is mod.readings


def test_control_names_a_runner_without_readings(monkeypatch):
    toy = types.ModuleType("benchmark.harness.toy_runner")
    toy.run = lambda ctx: {}
    monkeypatch.setitem(sys.modules, toy.__name__, toy)
    with pytest.raises(AttributeError, match="benchmark.harness.toy_runner"):
        control.readings("toy_runner")


def test_kernel_files():
    reg = kernels.registry()
    assert {"A", "B", "C", "E"} <= set(reg)
    for name, (symbol, bound) in reg.items():
        assert NAME.match(name) and symbol and bound in grid.PEAKS, name
    symbols = [s for s, _ in reg.values()]
    # no symbol names another kernel's launches too
    assert not [a for a in symbols for b in symbols if a != b and a in b]
