"""models.s2d, the network's forwards, ms per CT (phase "forward")."""


def read(run):
    p = run.get("phases_ms")
    if not p or "forward" not in p:
        return None
    return p["forward"] / run["n"]
