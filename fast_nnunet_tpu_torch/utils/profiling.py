"""Profiling hooks — the port of fast_nnunet_tpu/utils/profiling.py.

- :class:`PhaseTimer`: the program's one tracer. ``phase(name)`` adds the
  block's host time to its name and, on a CUDA device, records a CUDA-event
  pair on the current stream; ``count(name, n)`` adds to a counter;
  ``totals()`` sums them per name. JAX's ``summary`` and ``report`` read
  the host totals.
- :func:`phase`: what the program's layers call, ``phase(timer, name)``:
  the timer's span, or without a timer a ``torch.profiler.record_function``
  while a profiler records, else a shared null context. Counters are the
  timer's alone (``if timer is not None: timer.count(...)``).
- :func:`maybe_trace`: a ``torch.profiler`` trace (CPU and, where there is a
  card, CUDA activities) of a region when ``FNNT_PROFILE_DIR`` or the
  argument names a directory, the variable JAX's ``maybe_jax_trace`` reads.
  It writes a Chrome trace ``*.pt.trace.json.gz`` there, which
  ``utils.trace_analysis.attribute_trace`` reads. The program's phases show
  in it as ``user_annotation`` events, on the profiler's clock.
- :func:`environment_summary`: the debug.json environment dump (ref
  nnUNetTrainer.py:268-301), with the torch and CUDA versions and the
  card's name.
"""
import contextlib
import os
import platform
import socket
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

#: True while a torch profiler records (the autograd profiler's own flag)
_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


def phase(timer: Optional["PhaseTimer"], name: str, events: bool = True):
    """``timer.phase(name, events)``; without a timer, the phase's
    ``record_function`` while a torch profiler records, else a null
    context."""
    if timer is not None:
        return timer.phase(name, events)
    if _profiling():
        return torch.profiler.record_function(name)
    return _NULL


class PhaseTimer:
    """Phase times and counters, summed per name in memory, from one thread.

    ``phase(name)`` adds the block's host ``time.perf_counter_ns()`` time to
    its name. Where CUDA is available a phase also records a CUDA-event pair
    on the current stream, unless the call passes ``events=False`` (host
    work). While a torch profiler records, a phase also enters
    ``record_function(name)``. ``totals()`` synchronizes once and returns
    device-event ms per name, ``host:<name>`` host ms per name and
    ``count:<name>`` per counter."""

    def __init__(self):
        self.events = torch.cuda.is_available()
        #: {name: [host ms, phases]}
        self.host: Dict[str, list] = {}
        self.counters: Dict[str, int] = defaultdict(int)
        self._events: list = []

    @contextlib.contextmanager
    def phase(self, name: str, events: bool = True):
        t0 = time.perf_counter_ns()
        pair = None
        try:
            with torch.profiler.record_function(name) if _profiling() \
                    else _NULL:
                if events and self.events:
                    pair = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                    pair[0].record()
                try:
                    yield
                finally:
                    if pair is not None:
                        pair[1].record()
                        self._events.append((name, *pair))
        finally:
            acc = self.host.setdefault(name, [0.0, 0])
            acc[0] += (time.perf_counter_ns() - t0) / 1e6
            acc[1] += 1

    def count(self, name: str, n: int) -> None:
        self.counters[name] += int(n)

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.events:
            torch.cuda.synchronize()
        for name, s, e in self._events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        for name, (ms, _) in self.host.items():
            out["host:" + name] = ms
        for name, n in self.counters.items():
            out["count:" + name] = n
        return out

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(ms / 1e3, 4), "count": n,
                    "mean_ms": round(ms / max(n, 1), 3)}
                for k, (ms, n) in sorted(self.host.items(),
                                         key=lambda kv: -kv[1][0])}

    def report(self) -> str:
        return "\n".join(f"  {k:<24s} {v['total_s']:>9.2f}s  x{v['count']:<6d} "
                         f"{v['mean_ms']:>8.2f} ms/it"
                         for k, v in self.summary().items())


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str] = None):
    """Wrap a region in a ``torch.profiler`` trace written under
    ``trace_dir`` (else ``FNNT_PROFILE_DIR``); a no-op when neither is set.
    Yields the profiler, or None."""
    trace_dir = trace_dir or os.environ.get("FNNT_PROFILE_DIR")
    if not trace_dir:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(
                     trace_dir, use_gzip=True)) as prof:
        yield prof


def environment_summary(device=None) -> dict:
    """debug.json-style environment dump for a run on ``device``."""
    dev = torch.device(device) if device is not None else None
    info = {
        "hostname": socket.gethostname(),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": str(dev),
        "cudnn": torch.backends.cudnn.version()
        if torch.backends.cudnn.is_available() else None,
    }
    if dev is not None and dev.type == "cuda":
        info["gpu_name"] = torch.cuda.get_device_name(dev)
        info["gpu_count"] = torch.cuda.device_count()
    for var in ("nnUNet_raw", "nnUNet_preprocessed", "nnUNet_results",
                "CUDA_VISIBLE_DEVICES", "FNNT_ITERS_PER_EPOCH",
                "FNN_AOT_CACHE", "FNNT_PROFILE_DIR"):
        if var in os.environ:
            info.setdefault("env", {})[var] = os.environ[var]
    return info
