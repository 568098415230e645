"""training.dataloader: the device waiting for the loader, ms per
iteration (the trainer's "data" phase, CUDA events, traced run's
window)."""


def read(run):
    p = run.get("phases_ms")
    if not p or "data" not in p:
        return None
    return p["data"] / run["n"]
