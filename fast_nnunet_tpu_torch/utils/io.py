"""Small filesystem/JSON helpers (the subset of fast_nnunet_tpu/utils/io.py
the turbo loader uses, copied)."""
import json
import os
from typing import List, Optional


def join(*args) -> str:
    return os.path.join(*args)


def load_json(fname: str):
    with open(fname) as f:
        return json.load(f)


def subfiles(folder: str, prefix: Optional[str] = None,
             suffix: Optional[str] = None, sort: bool = True,
             join_path: bool = False) -> List[str]:
    res = [f for f in os.listdir(folder)
           if os.path.isfile(os.path.join(folder, f))
           and (prefix is None or f.startswith(prefix))
           and (suffix is None or f.endswith(suffix))]
    if sort:
        res.sort()
    return [os.path.join(folder, f) for f in res] if join_path else res
