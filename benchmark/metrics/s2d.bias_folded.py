"""models.s2d: the share of the network's InstanceNorms whose conv bias
kernel E added in its pass, % (the engine's counters "conv_bias_folded",
kernel E's launches in the forwards that took a conv bias, over "norms",
the network's blocks times its forwards). Below 100 some block's bias went
through a separate add. None where the program does not count
"conv_bias_folded"."""


def read(run):
    p = run.get("phases_ms")
    if not p or not p.get("count:norms") or "count:conv_bias_folded" not in p:
        return None
    return 100.0 * p["count:conv_bias_folded"] / p["count:norms"]
