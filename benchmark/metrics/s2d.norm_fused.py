"""models.s2d: the share of the network's InstanceNorms that kernel E
applied, % (the engine's counters "norms_fused", kernel E's launches in the
forwards, over "norms", the network's blocks times its forwards). Below 100
the pass is being bypassed."""


def read(run):
    p = run.get("phases_ms")
    if not p or not p.get("count:norms"):
        return None
    return 100.0 * p.get("count:norms_fused", 0) / p["count:norms"]
