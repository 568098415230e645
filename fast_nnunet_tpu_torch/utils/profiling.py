"""Profiling hooks — the port of fast_nnunet_tpu/utils/profiling.py.

- :class:`PhaseTimer`: accumulating wall-clock timers per phase, JAX's API
  (``phase``, ``summary``, ``report``). Host time only: the sweeps' device
  phases are timed by ``inference.engine.PhaseTimer`` (CUDA events).
- :func:`maybe_trace`: a ``torch.profiler`` trace (CPU and, where there is a
  card, CUDA activities) of a region when ``FNNT_PROFILE_DIR`` or the
  argument names a directory, the variable JAX's ``maybe_jax_trace`` reads.
  It writes a Chrome trace ``*.pt.trace.json.gz`` there, which
  ``utils.trace_analysis.attribute_trace`` reads.
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


class PhaseTimer:
    """Accumulating per-phase wall timers: with timer.phase('fwd'): ..."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_ms": round(1000 * v / max(self.counts[k], 1), 3)}
                for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])}

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
