"""NRRD read and write in numpy — a copy of fast_nnunet_tpu/imageio/nrrd.py
(the reference reads NRRD through SimpleITK): raw and gzip encodings, the
common integer and float types, spacing from ``space directions`` (row
norms) or ``spacings``. ``NrrdIO`` returns (C, X, Y, Z) with the on-disk
axis order and spacing reversed, as the NIfTI reader does."""
import gzip
import zlib
from typing import Sequence, Tuple

import numpy as np

from .nifti import _check_all_same

_NRRD_DTYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "int16": np.int16,
    "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "int32": np.int32, "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "long long": np.int64, "int64": np.int64, "int64_t": np.int64,
    "float": np.float32, "double": np.float64,
}


def read_nrrd(fname: str) -> Tuple[np.ndarray, dict]:
    """Returns (data in on-disk index order (i fastest -> C array (k,j,i) after
    our transpose in the RW below), header fields)."""
    with open(fname, "rb") as f:
        raw = f.read()
    if not raw.startswith(b"NRRD"):
        raise ValueError(f"{fname}: not an NRRD file")
    header_end = raw.find(b"\n\n")
    sep = 2
    if header_end == -1:
        header_end = raw.find(b"\r\n\r\n")
        sep = 4
    if header_end == -1:
        raise ValueError(f"{fname}: malformed NRRD header")
    header_lines = raw[:header_end].decode("ascii", errors="replace").splitlines()

    fields = {}
    for line in header_lines[1:]:
        if line.startswith("#") or not line.strip():
            continue
        if ":=" in line:
            k, v = line.split(":=", 1)
        elif ":" in line:
            k, v = line.split(":", 1)
        else:
            continue
        fields[k.strip().lower()] = v.strip()

    dim = int(fields.get("dimension", 3))
    sizes = [int(x) for x in fields["sizes"].split()]
    dtype = _NRRD_DTYPES.get(fields.get("type", "float"))
    if dtype is None:
        raise ValueError(f"{fname}: unsupported NRRD type {fields.get('type')}")
    endian = "<" if fields.get("endian", "little") == "little" else ">"
    encoding = fields.get("encoding", "raw").lower()

    payload = raw[header_end + sep:]
    if encoding in ("gzip", "gz"):
        payload = zlib.decompress(payload, zlib.MAX_WBITS | 32)
    elif encoding != "raw":
        raise ValueError(f"{fname}: unsupported NRRD encoding {encoding}")

    count = int(np.prod(sizes))
    data = np.frombuffer(payload, dtype=np.dtype(dtype).newbyteorder(endian),
                         count=count)
    data = data.reshape(sizes, order="F")

    # spacing: 'space directions' row norms, or 'spacings'
    spacing = [1.0] * dim
    if "space directions" in fields:
        vecs = [v for v in fields["space directions"].split(")") if "(" in v]
        for i, v in enumerate(vecs[:dim]):
            nums = [float(x) for x in v[v.find("(") + 1:].split(",")]
            spacing[i] = float(np.linalg.norm(nums))
    elif "spacings" in fields:
        spacing = [float(x) for x in fields["spacings"].split()][:dim]
    fields["_spacing"] = spacing
    return np.ascontiguousarray(
        data.astype(np.dtype(dtype).newbyteorder("="))), fields


def write_nrrd(fname: str, data: np.ndarray, spacing: Sequence[float],
               compress: bool = True) -> None:
    dtype_name = {np.dtype(np.uint8): "uint8", np.dtype(np.int16): "int16",
                  np.dtype(np.uint16): "uint16", np.dtype(np.int32): "int32",
                  np.dtype(np.float32): "float",
                  np.dtype(np.float64): "double"}.get(data.dtype)
    if dtype_name is None:
        data = data.astype(np.float32)
        dtype_name = "float"
    # axis-aligned space directions
    vec_strs = []
    for i in range(data.ndim):
        v = [0.0] * data.ndim
        v[i] = float(spacing[i])
        vec_strs.append("(" + ",".join(str(x) for x in v) + ")")
    header = (
        "NRRD0004\n"
        f"type: {dtype_name}\n"
        f"dimension: {data.ndim}\n"
        "space: left-posterior-superior\n"
        f"sizes: {' '.join(str(s) for s in data.shape)}\n"
        f"space directions: {' '.join(vec_strs)}\n"
        "kinds: domain domain domain\n"
        "endian: little\n"
        f"encoding: {'gzip' if compress else 'raw'}\n"
        "space origin: (0,0,0)\n\n")
    payload = np.asfortranarray(data).tobytes(order="F")
    if compress:
        payload = gzip.compress(payload, 6)
    with open(fname, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(payload)


class NrrdIO:
    """(C, X, Y, Z) with reversed on-disk order + reversed spacing, matching the
    NIfTI reader's convention."""
    supported_file_endings = [".nrrd", ".nhdr"]

    def read_images(self, image_fnames: Sequence[str]):
        images, spacings = [], []
        hdr0 = None
        for f in image_fnames:
            data, hdr = read_nrrd(f)
            if data.ndim != 3:
                raise ValueError(f"{f}: only 3D NRRD supported (got {data.ndim}D)")
            images.append(data.transpose(2, 1, 0))
            spacings.append(list(reversed(hdr["_spacing"])))
            hdr0 = hdr0 or hdr
        if not _check_all_same([i.shape for i in images]):
            raise RuntimeError(f"shape mismatch: {[i.shape for i in images]}")
        return (np.stack(images).astype(np.float32),
                {"spacing": spacings[0], "nrrd_header": {
                    k: v for k, v in hdr0.items() if isinstance(v, str)}})

    def read_seg(self, seg_fname: str):
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict):
        spacing = list(reversed(properties["spacing"]))
        write_nrrd(output_fname, seg.transpose(2, 1, 0).astype(np.uint8), spacing)
