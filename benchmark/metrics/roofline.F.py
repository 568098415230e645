"""Kernel F's share of the bf16 peak over the traced iterations: the QK^T
and PV FLOPs its launches need (4 B H T^2 hd each, counted from the shapes
by benchmark/harness/primus_train.py) at 989 TFLOP/s, over its kernel time
in the trace. Nothing is read where the trace's launches differ from the
count the shapes give, or where the trace holds no such kernel."""
from benchmark.harness.grid import roofline_percent


def read(run):
    return roofline_percent(run, "F")
