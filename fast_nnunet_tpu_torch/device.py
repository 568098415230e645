"""Device selection: the port runs on the card unless the caller asks for the
CPU, and never falls back to the CPU on its own. ``cuda`` without an index
is the process's current card: a rank of parallel/distributed.py
``spawn`` has set it to ``cuda:{local_rank}``, so every entry point of a
rank runs on that rank's card."""
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``; ``cuda`` without an index resolves to
    ``cuda:{torch.cuda.current_device()}``. Raises when CUDA is asked for
    and absent — there is no silent CPU fallback anywhere in the port."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
