"""models.primus: the share of the network's attention calls that ran
kernel F, % (the counters "attn_fused", F's launches, over "attn_calls",
the calls). Below 100 the fused path is being bypassed."""


def read(run):
    p = run.get("phases_ms")
    if not p or not p.get("count:attn_calls"):
        return None
    return 100.0 * p.get("count:attn_fused", 0) / p["count:attn_calls"]
