"""models.primus: the network's attention, forward and backward, ms per
iteration (the phases "attention", CUDA events around each forward call,
and "attention_backward", around each backward call on autograd's device
thread)."""


def read(run):
    p = run.get("phases_ms")
    if not p or "attention" not in p:
        return None
    return (p["attention"] + p.get("attention_backward", 0.0)) / run["n"]
