"""inference.turbo upload and preprocess, ms per CT (the engine's
CUDA-event phases "upload" + "preprocess" over the traced run's window)."""


def read(run):
    p = run.get("phases_ms")
    if not p or "preprocess" not in p:
        return None
    return (p.get("upload", 0.0) + p["preprocess"]) / run["n"]
