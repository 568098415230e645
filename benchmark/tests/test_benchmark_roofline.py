"""Kernels registered by file (benchmark/kernels/) read their roofline
shares from a Chrome trace: a byte-bound and a FLOP-bound kernel give the
share their bound's peak sets, a kernel whose traced launches differ from
the shapes' count reads nothing, and the readers of A, B and C read what
the fixed table of symbols and the byte-only rule they replace read, on
synthetic traces and on the hand-written kernels' events of two traced
runs on an H100 (tests/data/)."""
import gzip
import json
import os

import pytest

from benchmark import kernels
from benchmark.harness import common, grid, trace

SYMBOLS = {
    "A": "void (anonymous namespace)::spatial_sum_sumsq_kernel"
         "<__nv_bfloat16>(__nv_bfloat16 const*, long long, int, float*)",
    "B": "void (anonymous namespace)::grouped_argmax_kernel<__nv_bfloat16>"
         "(__nv_bfloat16*, int, int, int, int, unsigned char*)",
    "C": "void (anonymous namespace)::s2d_accumulate_kernel<__nv_bfloat16, "
         "__nv_bfloat16, true, 16, true>(__nv_bfloat16*, __nv_bfloat16 "
         "const*)",
    "E": "void (anonymous namespace)::norm_apply_kernel<true, "
         "__nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16*, long long)",
    "E0": "void (anonymous namespace)::norm_apply_kernel<false, "
          "__nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16*, long long)",
}


def chrome_trace(launches: dict) -> dict:
    """{name: [(ts, dur) us]} -> a trace with those kernel events, a cuDNN
    kernel between them and a host op."""
    ev = [{"ph": "X", "cat": "kernel", "name": SYMBOLS.get(k, k), "ts": ts,
           "dur": dur} for k, spans in launches.items() for ts, dur in spans]
    ev += [{"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit",
            "ts": 1e6, "dur": 500.0},
           {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0,
            "dur": 10}]
    return {"traceEvents": ev}


def spans(n, dur, start=0.0):
    return [(start + 1000.0 * i, dur) for i in range(n)]


def test_byte_bound_share():
    # 4 launches of 0.1 ms moving 268 MB: 268e6 / 3.35e12 s = 0.08 ms each
    run = {"trace": trace.read(chrome_trace({"A": spans(4, 100.0)})),
           "work": {"A": (4, 4 * 268_000_000)}}
    assert run["trace"]["kernels"]["A"] == (pytest.approx(400e-6), 4)
    assert grid.roofline_percent(run, "A") == pytest.approx(80.0)


def test_flop_bound_share(monkeypatch):
    # a later compute-bound kernel is one file with BOUND "bf16": 2 launches
    # of 1 ms doing 692.3 GFLOP each, 70% of 989 TFLOP/s
    reg = dict(kernels.registry(), F=("toy_attention_fwd", "bf16"))
    monkeypatch.setattr(kernels, "registry", lambda: reg)
    run = {"trace": trace.read(chrome_trace(
        {"toy_attention_fwd<128>": spans(2, 1000.0)})),
        "work": {"F": (2, 2 * 0.7 * 989e12 * 1e-3)}}
    assert run["trace"]["kernels"] == {"F": (pytest.approx(2e-3), 2)}
    assert grid.roofline_percent(run, "F") == pytest.approx(70.0)


def test_both_instances_of_e_count():
    r = trace.read(chrome_trace({"E": spans(20, 50.0),
                                 "E0": spans(2, 50.0, 5e5)}))
    assert r["kernels"]["E"] == (pytest.approx(1.1e-3), 22)


@pytest.mark.parametrize("traced,counted", [(21, 22), (23, 22), (0, 22)])
def test_launch_count_differs_reads_none(traced, counted):
    run = {"trace": trace.read(chrome_trace({"E": spans(traced, 50.0)})),
           "work": {"E": (counted, counted * 754_974_720)}}
    assert common.metric_reader("roofline.E.serve")(run) is None


def test_no_trace_or_no_work_reads_none():
    read = common.metric_reader("roofline.E.serve")
    assert read({"n": 3}) is None
    assert read({"trace": trace.read(chrome_trace({"E": spans(2, 5.0)}))}) \
        is None


# ----------------------------------------- the readers the registry replaced
PARENT_KERNELS = {"A": "spatial_sum_sumsq_kernel",
                  "B": "grouped_argmax_kernel", "C": "s2d_accumulate_kernel"}


def parent_share(tr: dict, work: dict, letter: str):
    """The arithmetic of the readers before kernels had files: a fixed
    symbol table, every kernel byte-bound at 3.35 TB/s."""
    seconds, launches = 0.0, 0
    for e in tr["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "kernel" and \
                PARENT_KERNELS[letter] in e["name"]:
            seconds += float(e.get("dur", 0.0)) / 1e6
            launches += 1
    want, nbytes = work[letter]
    if not launches or launches != want or seconds <= 0:
        return None
    return 100.0 * nbytes / 3.35e12 / seconds


def saved(name):
    """A traced run's hand-written kernel events on an H100 and the
    runner's work (tests/data/<name>_trace.json.gz)."""
    with gzip.open(os.path.join(os.path.dirname(__file__), "data",
                                name + "_trace.json.gz")) as f:
        d = json.load(f)
    return d, {k: tuple(v) for k, v in d["work"].items()}


# synthetic slices: 45 forwards of serving, 20 iterations of training
SLICES = {
    "serve": (chrome_trace({"A": spans(540, 125.3), "B": spans(24, 447.9, 6e5),
                            "C": spans(45, 1655.7, 7e5),
                            "E": spans(990, 66.9, 8e5)}),
              {"A": (540, 45 * 12 * 377_495_552),
               "B": (24, 24 * 1_292_533_760), "C": (45, 45 * 1_522_199_968),
               "E": (990, 45 * 4_018_636_800)}),
    "train": (chrome_trace({"A": spans(640, 40.1)}),
              {"A": (640, 20 * 8 * (94_372_864 + 23_595_008 + 5_902_336
                                    + 188_744_192))}),
}


def slice_of(source, cell):
    return SLICES[cell] if source == "synthetic" else saved(cell)


@pytest.mark.parametrize("source", ["synthetic", "saved"])
@pytest.mark.parametrize("metric", ["roofline.A.serve", "roofline.B.serve",
                                    "roofline.C.serve", "roofline.A.train"])
def test_readers_read_what_they_read_before(metric, source):
    tr, work = slice_of(source, metric.split(".")[2])
    want = parent_share(tr, work, metric.split(".")[1])
    assert want is not None
    assert common.metric_reader(metric)(
        {"trace": trace.read(tr), "work": work}) == want


@pytest.mark.parametrize("source", ["synthetic", "saved"])
def test_e_reads_its_share_of_the_serving_slice(source):
    # every one of the forwards' 22 norms is one launch of E (the saved
    # slice: 3 studies, 52 forwards)
    tr, work = slice_of(source, "serve")
    r = trace.read(tr)
    seconds, launches = r["kernels"]["E"]
    assert launches == work["E"][0] == 22 * work["C"][0]
    assert common.metric_reader("roofline.E.serve")(
        {"trace": r, "work": work}) == pytest.approx(
        100.0 * work["E"][1] / grid.HBM_BYTES_PER_S / seconds)
