"""Kernel G's share of the bf16 peak over the traced iterations: the five
useful products of the attention backward (10 B H T^2 hd a call, counted
from the shapes by benchmark/harness/primus_train.py; the two passes
recompute two more, which the share does not count) at 989 TFLOP/s, over
the time of both passes in the trace. Nothing is read where the trace's
launches differ from the count the shapes give."""
from benchmark.harness.grid import roofline_percent


def read(run):
    return roofline_percent(run, "G")
