"""Set-up: process start to the first timed item (imports, weights and
inputs made from the seed, the program built and loaded, every shape of
the window warmed up; a checkout's first run also builds the kernels)."""


def read(run):
    return run["setup_s"]
