"""Seconds per fed training iteration, data loader included: the whole
window, which ends in a device sync, over its iterations."""


def read(run):
    return run["window_s"] / run["attempted"]
