"""The port's hand-written kernels, one file each, found by file name:
benchmark/kernels/<name>.py holds ``SYMBOL``, a substring of the kernel's
device symbol as the profiler's trace names it (it matches every template
instance), and ``BOUND``, the resource whose peak bounds it: "hbm" (bytes
at ``grid.HBM_BYTES_PER_S``) or "bf16" (FLOPs at
``grid.BF16_FLOPS_PER_S``). A kernel is added by adding its file. The
trace reader gathers every registered kernel's time and launches; a runner
counts a kernel's work from shapes as ``work[name] = (launches, amount)``,
the amount in its bound's unit, and ``roofline.<name>.*`` reads the
share."""
import glob
import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def registry() -> dict:
    """{name: (symbol, bound)} of every kernel file."""
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "*.py"))):
        name = os.path.basename(path)[:-3]
        if name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            "benchmark_kernel_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = (mod.SYMBOL, mod.BOUND)
    return out
