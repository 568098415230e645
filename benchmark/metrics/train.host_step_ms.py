"""training.train_step: the host's time in the step, ms per iteration
(host spans "forward_loss" + "backward" + "optimizer"): the dispatch of the
step's launches, and any wait on the device inside it."""


def read(run):
    p = run.get("phases_ms")
    if not p or "host:backward" not in p:
        return None
    return (p.get("host:forward_loss", 0.0) + p["host:backward"]
            + p.get("host:optimizer", 0.0)) / run["n"]
