"""Kernel E's share of its byte bound over the traced studies: the bytes
its launches need (each bf16 element read once and written once, counted
from the s2d network's norm shapes by benchmark/harness/grid.py) at 3.35
TB/s, over its kernel time in the trace. Nothing is read where the
trace's launches differ from the count the shapes give."""
from benchmark.harness.grid import roofline_percent


def read(run):
    return roofline_percent(run, "E")
