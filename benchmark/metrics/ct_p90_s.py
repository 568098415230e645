"""The 90th percentile of every study's latency in the window (volume in
host memory to its uint8 mask on the original grid in host memory)."""
from benchmark.harness.common import quantile


def read(run):
    return quantile(run["latencies"], 90)
