"""Seconds per CT: the whole window over the studies it completed."""


def read(run):
    return run["window_s"] / run["attempted"]
