"""The chunked-zstd case store (``.fnnz``), a copy of
fast_nnunet_tpu/training/zstd_store.py whose files it reads and writes
byte for byte.

A case's (C, *spatial) array is cut into spatial bricks (channels never
split): each brick axis starts at the power of two at or above half the
patch axis (at least 8, at most the image), then the largest axis halves
until a brick holds at most 1 MiB. Each brick is byte-shuffled (the i-th
byte of every element together) and written as one zstd frame at level 3.
A file is ``FNNZ1\\n``, a little-endian uint32 header length, a JSON header
(shape, dtype, brick, frame offsets, shuffle) and the frames.
``BrickReader.__getitem__`` decompresses only the bricks a slice touches,
so a patch read costs at most ceil(patch / brick) + 1 bricks per axis.

Written by ``-store fnnz`` / ``FNNT_STORE=fnnz``; training finds the store
from the files present (``training/dataset.infer_dataset_class``). zstd
comes from ``utils/zstd.py`` (the ``zstandard`` package or the system
libzstd)."""
import json
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import zstd
from ..utils.io import load_pickle, save_pickle, subfiles

_MAGIC = b"FNNZ1\n"
_TARGET_BRICK_BYTES = 1 << 20
_COMPRESS_LEVEL = 3


def compute_brick_shape(image_shape: Sequence[int],
                        patch_size: Optional[Sequence[int]],
                        bytes_per_voxel: int,
                        target_bytes: int = _TARGET_BRICK_BYTES
                        ) -> Tuple[int, ...]:
    """Spatial brick dims for a (C, *spatial) array."""
    c = image_shape[0]
    spatial = list(image_shape[1:])
    if patch_size is None or len(patch_size) != len(spatial):
        patch_size = spatial
    brick = []
    for img, p in zip(spatial, patch_size):
        half = max(8, int(p) // 2)
        brick.append(int(min(img, 1 << max(3, (half - 1).bit_length()))))
    while int(np.prod(brick)) * c * bytes_per_voxel > target_bytes \
            and max(brick) > 8:
        brick[int(np.argmax(brick))] //= 2
    return tuple(max(1, b) for b in brick)


def _brick_grid(spatial: Sequence[int], brick: Sequence[int]) -> List[int]:
    return [(s + b - 1) // b for s, b in zip(spatial, brick)]


def _byte_shuffle(buf: np.ndarray) -> bytes:
    return buf.reshape(-1).view(np.uint8).reshape(-1, buf.itemsize).T.tobytes()


def _byte_unshuffle(raw: bytes, dtype: np.dtype) -> np.ndarray:
    u8 = np.frombuffer(raw, np.uint8).reshape(dtype.itemsize, -1)
    return np.ascontiguousarray(u8.T).reshape(-1).view(dtype)


def write_fnnz(path: str, array: np.ndarray,
               patch_size: Optional[Sequence[int]] = None) -> None:
    """Write ``array`` (C, *spatial) as one ``.fnnz`` file, atomically."""
    codec = zstd.codec()
    array = np.ascontiguousarray(array)
    brick = compute_brick_shape(array.shape, patch_size, array.itemsize)
    grid = _brick_grid(array.shape[1:], brick)
    frames, offsets, pos = [], [], 0
    for idx in np.ndindex(*grid):
        sl = (slice(None),) + tuple(
            slice(i * b, min((i + 1) * b, s))
            for i, b, s in zip(idx, brick, array.shape[1:]))
        frame = codec.compress(
            _byte_shuffle(np.ascontiguousarray(array[sl])), _COMPRESS_LEVEL)
        frames.append(frame)
        offsets.append([pos, len(frame)])
        pos += len(frame)
    header = json.dumps({
        "shape": list(array.shape), "dtype": np.dtype(array.dtype).str,
        "brick": list(brick), "offsets": offsets, "shuffle": True,
    }).encode()
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        for frame in frames:
            f.write(frame)
    os.replace(tmp, path)


class BrickReader:
    """Lazy numpy-like view of a ``.fnnz`` file: basic slicing decompresses
    only the bricks the region overlaps; ``np.asarray`` reads it all."""

    def __init__(self, path: str):
        self._path = path
        with open(path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"not a .fnnz file: {path}")
            (hlen,) = struct.unpack("<I", f.read(4))
            hdr = json.loads(f.read(hlen).decode())
            self._payload_start = f.tell()
        self.shape = tuple(hdr["shape"])
        self.dtype = np.dtype(hdr["dtype"])
        self._brick = tuple(hdr["brick"])
        self._offsets = hdr["offsets"]
        self._shuffle = bool(hdr.get("shuffle", False))
        self._grid = _brick_grid(self.shape[1:], self._brick)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __array__(self, dtype=None, copy=None):
        out = self[(slice(None),) * self.ndim]
        return out.astype(dtype) if dtype is not None else out

    def _frame(self, f, lin: int) -> np.ndarray:
        off, length = self._offsets[lin]
        f.seek(self._payload_start + off)
        raw = zstd.decompress(f.read(length))
        if self._shuffle:
            return _byte_unshuffle(raw, self.dtype)
        return np.frombuffer(raw, self.dtype)

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        if len(idx) > self.ndim or \
                not all(isinstance(i, slice) for i in idx):
            raise IndexError("BrickReader takes basic slices only")
        idx = idx + (slice(None),) * (self.ndim - len(idx))
        bounds = [i.indices(s) for i, s in zip(idx, self.shape)]
        if any(step != 1 for _, _, step in bounds):
            raise IndexError("BrickReader takes slices of step 1 only")
        lo = [b[0] for b in bounds]
        hi = [b[1] for b in bounds]
        out = np.empty([max(0, h - l) for l, h in zip(lo, hi)], self.dtype)
        if out.size == 0:
            return out
        c = self.shape[0]
        ranges = [range(l // b, (h - 1) // b + 1)
                  for l, h, b in zip(lo[1:], hi[1:], self._brick)]
        with open(self._path, "rb") as f:
            for idx_b in np.ndindex(*[len(r) for r in ranges]):
                bcoord = [r[i] for r, i in zip(ranges, idx_b)]
                bstart = [bc * b for bc, b in zip(bcoord, self._brick)]
                bshape = [min(b, s - st) for b, s, st in
                          zip(self._brick, self.shape[1:], bstart)]
                lin = int(np.ravel_multi_index(bcoord, self._grid))
                brick = self._frame(f, lin).reshape(c, *bshape)
                glo = [max(l, st) for l, st in zip(lo[1:], bstart)]
                ghi = [min(h, st + bs)
                       for h, st, bs in zip(hi[1:], bstart, bshape)]
                src = (slice(lo[0], hi[0]),) + tuple(
                    slice(a - st, b - st) for a, b, st in zip(glo, ghi,
                                                              bstart))
                dst = (slice(None),) + tuple(
                    slice(a - l, b - l) for a, b, l in zip(glo, ghi, lo[1:]))
                out[dst] = brick[src]
        return out


class ZstdCaseDataset:
    """The ``.fnnz`` sibling of ``training/dataset.NpyCaseDataset``:
    ``{id}.fnnz`` (float32 data), ``{id}_seg.fnnz`` (int8/int16) and
    ``{id}.pkl`` (properties) per case."""
    suffix_data = ".fnnz"
    suffix_seg = "_seg.fnnz"
    suffix_props = ".pkl"

    def __init__(self, folder: str, identifiers: Optional[List[str]] = None):
        self.folder = folder
        if identifiers is None:
            identifiers = self.get_identifiers(folder)
        self.identifiers = list(identifiers)

    @classmethod
    def get_identifiers(cls, folder: str) -> List[str]:
        files = subfiles(folder, suffix=cls.suffix_data, join_path=False)
        return sorted(f[: -len(cls.suffix_data)] for f in files
                      if not f.endswith(cls.suffix_seg))

    def __len__(self):
        return len(self.identifiers)

    def keys(self):
        return list(self.identifiers)

    @classmethod
    def save_case(cls, data: np.ndarray, seg: Optional[np.ndarray],
                  properties: dict, output_filename_truncated: str,
                  patch_size: Optional[Sequence[int]] = None) -> None:
        write_fnnz(output_filename_truncated + cls.suffix_data,
                   np.ascontiguousarray(data, dtype=np.float32), patch_size)
        if seg is not None:
            seg_dtype = np.int16 if (seg.max() > 127 or seg.min() < -128) \
                else np.int8
            write_fnnz(output_filename_truncated + cls.suffix_seg,
                       np.ascontiguousarray(seg, dtype=seg_dtype), patch_size)
        save_pickle(properties, output_filename_truncated + cls.suffix_props)

    def load_case(self, identifier: str, mmap: bool = True):
        """(data, seg, properties); data and seg are :class:`BrickReader`
        views, or arrays read whole with ``mmap=False``."""
        base = os.path.join(self.folder, identifier)
        data = BrickReader(base + self.suffix_data)
        seg_path = base + self.suffix_seg
        seg = BrickReader(seg_path) if os.path.isfile(seg_path) else None
        if not mmap:
            data = np.asarray(data)
            seg = np.asarray(seg) if seg is not None else None
        properties = load_pickle(base + self.suffix_props)
        return data, seg, properties

    def load_properties(self, identifier: str) -> dict:
        return load_pickle(os.path.join(self.folder, identifier)
                           + self.suffix_props)
