"""Small filesystem/JSON/pickle helpers (the subset of
fast_nnunet_tpu/utils/io.py that the port uses, copied)."""
import gzip
import json
import os
import pickle
from typing import List, Optional

import numpy as np


def join(*args) -> str:
    return os.path.join(*args)


def isfile(p: str) -> bool:
    return os.path.isfile(p)


def isdir(p: str) -> bool:
    return os.path.isdir(p)


def maybe_mkdir_p(p: str) -> None:
    os.makedirs(p, exist_ok=True)


def load_json(fname: str):
    with open(fname) as f:
        return json.load(f)


class _NumpyJSONEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.bool_):
            return bool(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (set, tuple)):
            return list(o)
        return super().default(o)


def save_json(obj, fname: str, sort_keys: bool = True, indent: int = 4) -> None:
    with open(fname, "w") as f:
        json.dump(obj, f, sort_keys=sort_keys, indent=indent,
                  cls=_NumpyJSONEncoder)


def save_pickle(obj, fname: str) -> None:
    with open(fname, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(fname: str):
    opener = gzip.open if fname.endswith(".gz") else open
    with opener(fname, "rb") as f:
        return pickle.load(f)


def _entries(folder: str, test, prefix: Optional[str], suffix: Optional[str],
             sort: bool, join_path: bool) -> List[str]:
    res = [f for f in os.listdir(folder)
           if test(os.path.join(folder, f))
           and (prefix is None or f.startswith(prefix))
           and (suffix is None or f.endswith(suffix))]
    if sort:
        res.sort()
    return [os.path.join(folder, f) for f in res] if join_path else res


def subfiles(folder: str, prefix: Optional[str] = None,
             suffix: Optional[str] = None, sort: bool = True,
             join_path: bool = False) -> List[str]:
    return _entries(folder, os.path.isfile, prefix, suffix, sort, join_path)


def subdirs(folder: str, prefix: Optional[str] = None,
            suffix: Optional[str] = None, sort: bool = True,
            join_path: bool = False) -> List[str]:
    return _entries(folder, os.path.isdir, prefix, suffix, sort, join_path)


def recursive_fix_for_json_export(d: dict) -> None:
    """In-place conversion of numpy scalars/arrays (and tuples) to
    JSON-safe types."""
    for k in list(d.keys()):
        if isinstance(k, np.integer):
            d[int(k)] = d.pop(k)
            k = int(k)
        v = d[k]
        if isinstance(v, dict):
            recursive_fix_for_json_export(v)
        else:
            d[k] = _fix_seq_item(v)


def _fix_seq_item(v):
    if isinstance(v, dict):
        recursive_fix_for_json_export(v)
        return v
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, (list, tuple)):
        return [_fix_seq_item(i) for i in v]
    return v
