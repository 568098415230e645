"""The whole step's or CT's share of the card's dense bf16 peak: the model
FLOPs the runner counted from the shapes over the window, at 989 TFLOP/s.
Serving counts the tiles the air rule keeps; training 3 x the trained
network's forward and 1 x each teacher's; neither counts recomputation."""
from benchmark.harness.grid import BF16_FLOPS_PER_S


def read(run):
    if "flops" not in run:
        return None
    return 100.0 * run["flops"] / (run["window_s"] * BF16_FLOPS_PER_S)
