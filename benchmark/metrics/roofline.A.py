"""Kernel A's share of its byte bound over the traced studies or
iterations: the bytes its launches need (inputs read once, outputs written
once, counted from the shapes by benchmark/harness/grid.py) at 3.35 TB/s,
over its kernel time in the trace. Nothing is read where the trace's
launches differ from the count the shapes give."""
from benchmark.harness.grid import roofline_percent


def read(run):
    return roofline_percent(run, "A")
