"""models.s2d: the share of the tile slots the sweep forwards that the air
rule keeps, % (the engine's counters "tiles_kept" / "tiles_forwarded")."""


def read(run):
    p = run.get("phases_ms")
    if not p or not p.get("count:tiles_forwarded"):
        return None
    return 100.0 * p.get("count:tiles_kept", 0) / p["count:tiles_forwarded"]
