"""Device-time attribution from a ``torch.profiler`` trace — the port of
fast_nnunet_tpu/utils/trace_analysis.py.

The JAX module reads a ``jax.profiler`` trace, whose XLA-op timeline is one
pid/tid and whose ``while``/``jit_*`` rows are containers. A torch.profiler
Chrome trace has no containers on the device: its device leaves are the GPU
events, ``cat == "kernel"`` plus ``gpu_memcpy`` / ``gpu_memset``, on a pid
per card and a tid per stream. Their summed durations are the device's leaf
time; the union of their intervals over the traced device window (first
start to last end) gives the busy time and the idle share.

Usage:
    with utils.profiling.maybe_trace(trace_dir):
        run_the_program()
    print(format_attribution(attribute_trace(trace_dir)))
"""
import collections
import glob
import gzip
import json
import os
from typing import Dict, List, Tuple

#: the device leaf events of a torch.profiler trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: the four hand-written kernels by their symbol names in csrc/*.cu
HAND_KERNELS = (
    ("A spatial_sum_sumsq", "spatial_sum_sumsq_kernel"),
    ("B grouped_argmax", "grouped_argmax_kernel"),
    ("C s2d_accumulate", "s2d_accumulate_kernel"),
    ("D scatter_accumulate", "scatter_accumulate_kernel"),
)


def _lower_has(*words):
    return lambda n: any(w in n.lower() for w in words)


_BUCKETS = [(name, lambda n, s=sym: s in n) for name, sym in HAND_KERNELS] + [
    ("memcpy/memset", lambda n: n.startswith(("Memcpy", "Memset"))),
    ("copy/transpose", _lower_has("nchwtonhwc", "nhwctonchw", "transpose",
                                  "copy", "catarray", "permute")),
    ("convolution(cuDNN/cuBLAS)", _lower_has(
        "conv", "cudnn", "xmma", "gemm", "cutlass", "sm90_", "sm80_",
        "fprop", "dgrad", "wgrad", "winograd", "nvjet")),
    ("reduction", _lower_has("reduce", "triton_red", "triton_per", "argmax",
                             "norm_kernel", "welford")),
    ("elementwise", _lower_has("elementwise", "triton_poi", "fill",
                               "index", "where", "cast")),
]


def _latest_trace_file(trace_dir: str) -> str:
    files = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json*"),
                      recursive=True)
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json(.gz) under {trace_dir}")
    return max(files, key=os.path.getmtime)


def _load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def bucket_of(name: str) -> str:
    for bname, pred in _BUCKETS:
        if pred(name):
            return bname
    return "other:" + name.split("(")[0].split("<")[0][:40]


def _union_s(intervals: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def attribute_trace(trace_dir: str) -> Dict[str, object]:
    """Parse the newest torch.profiler trace under trace_dir. Returns
    ``{"total_s", "busy_s", "window_s", "idle_share", "buckets": [(name,
    seconds)...], "launches": {bucket: count}, "top_ops": [(name,
    seconds)...]}``: ``total_s`` sums the device leaf durations, ``busy_s``
    is the union of their intervals, ``window_s`` the traced device window
    and ``idle_share`` = 1 - busy / window."""
    tr = _load(_latest_trace_file(trace_dir))
    leaves = [e for e in tr.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    buckets: collections.Counter = collections.Counter()
    launches: collections.Counter = collections.Counter()
    top: collections.Counter = collections.Counter()
    spans = []
    for e in leaves:
        n, ts, dur = e["name"], float(e["ts"]), float(e.get("dur", 0.0))
        b = bucket_of(n)
        buckets[b] += dur
        launches[b] += 1
        top[n] += dur
        spans.append((ts, ts + dur))
    total = sum(buckets.values())
    window = (max(b for _, b in spans) - min(a for a, _ in spans)) \
        if spans else 0.0
    busy = _union_s(spans)
    return {"total_s": total / 1e6, "busy_s": busy / 1e6,
            "window_s": window / 1e6,
            "idle_share": (1.0 - busy / window) if window > 0 else None,
            "buckets": [(k, v / 1e6) for k, v in buckets.most_common()],
            "launches": dict(launches),
            "top_ops": [(k, v / 1e6) for k, v in top.most_common(15)]}


def format_attribution(att: Dict[str, object]) -> str:
    idle = att.get("idle_share")
    lines = [f"device leaf total: {att['total_s']:.4f} s, busy "
             f"{att['busy_s']:.4f} s of a {att['window_s']:.4f} s window "
             f"(idle share {'n/a' if idle is None else f'{idle:.4f}'})"]
    for name, sec in att["buckets"]:
        lines.append(f"  {name:<32s} {sec:9.4f} s "
                     f"{100 * sec / max(att['total_s'], 1e-9):5.1f}% "
                     f"x{att['launches'].get(name, 0)}")
    lines.append("top ops:")
    for name, sec in att["top_ops"]:
        lines.append(f"  {name[:70]:<70s} {sec:8.4f} s")
    return "\n".join(lines)
