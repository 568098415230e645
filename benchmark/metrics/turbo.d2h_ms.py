"""inference.turbo revert and copy out, ms per CT (phases "revert" +
"d2h")."""


def read(run):
    p = run.get("phases_ms")
    if not p or "d2h" not in p:
        return None
    return (p.get("revert", 0.0) + p["d2h"]) / run["n"]
