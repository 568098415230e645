"""A profiled slice and its reading: a frozen copy of the arithmetic of
``utils/trace_analysis.py`` (device leaves are the ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events of a torch.profiler Chrome trace;
busy time is the union of their intervals, the window runs from the first
start to the last end), plus the kernels' time by symbol, the top device
operations and the longest idle gaps named by what the host was doing."""
import collections
import contextlib
import json
import os
import shutil
import tempfile
from typing import Dict, List, Tuple

from .. import kernels

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")


def union_s(intervals: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


@contextlib.contextmanager
def profiled(torch, sink: dict):
    """Profile the enclosed work (CPU and CUDA activities); on exit the
    trace is written under ``TMPDIR``, read into ``sink`` (see
    :func:`read`) and deleted."""
    from torch.profiler import ProfilerActivity, profile
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            sink.update(read(json.load(f)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def read(tr: dict) -> Dict[str, object]:
    """{"busy_s", "window_s", "kernels": {name: (seconds, launches)} (the
    registered kernels, benchmark/kernels/, matched by symbol),
    "device_ops": [(name, s)] (top 10), "idle_gaps": [(name, s)] (the 10
    longest gaps, each named by the innermost host event open at its
    start)}."""
    events = [e for e in tr.get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES]
    spans, top = [], collections.Counter()
    symbols = {k: sym for k, (sym, _) in kernels.registry().items()}
    kern = {k: [0.0, 0] for k in symbols}
    for e in dev:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((ts, ts + dur))
        top[e["name"]] += dur
        for k, sym in symbols.items():
            if sym in e["name"]:
                kern[k][0] += dur / 1e6
                kern[k][1] += 1
    if not spans:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": {},
                "device_ops": [], "idle_gaps": []}
    t0 = min(a for a, _ in spans)
    t1 = max(b for _, b in spans)
    gaps, end = [], t0
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort(key=lambda e: float(e["ts"]))
    named = []
    for a, b in gaps[:10]:
        name = "idle"
        best = None
        for e in host:
            hs = float(e["ts"])
            if hs > a:
                break
            if hs + float(e.get("dur", 0.0)) >= a and \
                    (best is None or hs >= float(best["ts"])):
                best = e
        if best is not None:
            name = best["name"]
        named.append([name, (b - a) / 1e6])
    return {"busy_s": union_s(spans) / 1e6, "window_s": (t1 - t0) / 1e6,
            "kernels": {k: tuple(v) for k, v in kern.items() if v[1]},
            "device_ops": [[n, s / 1e6] for n, s in top.most_common(10)],
            "idle_gaps": named}
