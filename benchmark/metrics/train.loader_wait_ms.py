"""training.dataloader: the trainer blocked on the loader's queue, ms per
iteration (the host span "data")."""


def read(run):
    p = run.get("phases_ms")
    if not p or "host:data" not in p:
        return None
    return p["host:data"] / run["n"]
