"""training.dataloader: batches waiting in the loader's queue when the
trainer takes one, per iteration (the counter "loader_ready")."""


def read(run):
    p = run.get("phases_ms")
    if not p or "count:loader_ready" not in p:
        return None
    return p["count:loader_ready"] / run["n"]
