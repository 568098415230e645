"""The device's idle share of the traced window: 1 - busy / window."""


def read(run):
    t = run.get("trace")
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
