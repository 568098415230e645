"""inference.turbo: the masks' copies to the host, GB/s (the counters
"d2h_pageable_bytes" + "d2h_pinned_bytes" over the "d2h" phase's CUDA-event
ms)."""


def read(run):
    p = run.get("phases_ms")
    keys = ("count:d2h_pageable_bytes", "count:d2h_pinned_bytes")
    if not p or not p.get("d2h") or not any(k in p for k in keys):
        return None
    return sum(p.get(k, 0) for k in keys) / 1e6 / p["d2h"]
