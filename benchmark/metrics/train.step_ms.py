"""training.train_step / training.distill: forward with the loss (and
the teachers), backward and the update, ms per iteration (phases
"forward_loss" + "backward" + "optimizer")."""


def read(run):
    p = run.get("phases_ms")
    if not p or "backward" not in p:
        return None
    return (p.get("forward_loss", 0.0) + p["backward"]
            + p.get("optimizer", 0.0)) / run["n"]
