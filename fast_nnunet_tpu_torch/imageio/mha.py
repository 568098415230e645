"""MetaImage (``.mha``, ``.mhd`` + data file) read and write in numpy — a
copy of fast_nnunet_tpu/imageio/mha.py (the reference reads MHA through
SimpleITK): the MET_* element types, raw or zlib-compressed payloads,
either byte order. ``MhaIO`` returns (C, X, Y, Z) with the on-disk axis
order and spacing reversed, as the NIfTI reader does."""
import os
import zlib
from typing import Sequence, Tuple

import numpy as np

from .nifti import _check_all_same

_MET_DTYPES = {
    "MET_CHAR": np.int8, "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16, "MET_USHORT": np.uint16,
    "MET_INT": np.int32, "MET_UINT": np.uint32,
    "MET_LONG": np.int64, "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_DTYPE_TO_MET = {np.dtype(v): k for k, v in _MET_DTYPES.items()}


def read_mha(fname: str) -> Tuple[np.ndarray, dict]:
    """Returns (data (i,j,k) on-disk order as C array reshaped Fortran, fields)."""
    fields = {}
    header_len = 0
    with open(fname, "rb") as f:
        while True:
            line = f.readline()
            header_len += len(line)
            if not line:
                raise ValueError(f"{fname}: no ElementDataFile key found")
            text = line.decode("ascii", errors="replace").strip()
            if "=" not in text:
                continue
            k, v = (x.strip() for x in text.split("=", 1))
            fields[k] = v
            if k == "ElementDataFile":
                break
        payload = f.read()

    dims = int(fields.get("NDims", 3))
    sizes = [int(x) for x in fields["DimSize"].split()][:dims]
    dtype = _MET_DTYPES.get(fields.get("ElementType", "MET_FLOAT"))
    if dtype is None:
        raise ValueError(f"{fname}: unsupported ElementType "
                         f"{fields.get('ElementType')}")
    compressed = fields.get("CompressedData", "False").lower() == "true"
    byte_order_msb = fields.get("BinaryDataByteOrderMSB",
                                fields.get("ElementByteOrderMSB", "False")
                                ).lower() == "true"

    datafile = fields["ElementDataFile"]
    if datafile != "LOCAL":
        with open(os.path.join(os.path.dirname(fname), datafile), "rb") as df:
            payload = df.read()
    if compressed:
        payload = zlib.decompress(payload)

    endian = ">" if byte_order_msb else "<"
    count = int(np.prod(sizes))
    data = np.frombuffer(payload, np.dtype(dtype).newbyteorder(endian),
                         count=count).reshape(sizes, order="F")

    spacing = [1.0] * dims
    if "ElementSpacing" in fields:
        spacing = [float(x) for x in fields["ElementSpacing"].split()][:dims]
    elif "ElementSize" in fields:
        spacing = [float(x) for x in fields["ElementSize"].split()][:dims]
    fields["_spacing"] = spacing
    return np.ascontiguousarray(data.astype(data.dtype.newbyteorder("="))), fields


def write_mha(fname: str, data: np.ndarray, spacing: Sequence[float],
              compress: bool = True) -> None:
    dt = np.dtype(data.dtype)
    if dt not in _DTYPE_TO_MET:
        data = data.astype(np.float32)
        dt = np.dtype(np.float32)
    payload = np.asfortranarray(data).tobytes(order="F")
    if compress:
        compressed_payload = zlib.compress(payload, 6)
    header = [
        "ObjectType = Image",
        f"NDims = {data.ndim}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compress else 'False'}",
    ]
    if compress:
        header.append(f"CompressedDataSize = {len(compressed_payload)}")
    header += [
        "TransformMatrix = 1 0 0 0 1 0 0 0 1",
        "Offset = 0 0 0",
        "CenterOfRotation = 0 0 0",
        "AnatomicalOrientation = LPS",
        f"ElementSpacing = {' '.join(str(s) for s in spacing[:data.ndim])}",
        f"DimSize = {' '.join(str(s) for s in data.shape)}",
        f"ElementType = {_DTYPE_TO_MET[dt]}",
        "ElementDataFile = LOCAL",
    ]
    with open(fname, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(compressed_payload if compress else payload)


class MhaIO:
    """(C, X, Y, Z) with reversed on-disk order + reversed spacing (SimpleITK
    convention, like the NIfTI reader)."""
    supported_file_endings = [".mha", ".mhd"]

    def read_images(self, image_fnames: Sequence[str]):
        images, spacings = [], []
        for f in image_fnames:
            data, hdr = read_mha(f)
            if data.ndim != 3:
                raise ValueError(f"{f}: only 3D MHA supported (got {data.ndim}D)")
            images.append(data.transpose(2, 1, 0))
            spacings.append(list(reversed(hdr["_spacing"])))
        if not _check_all_same([i.shape for i in images]):
            raise RuntimeError(f"shape mismatch: {[i.shape for i in images]}")
        if not _check_all_same(spacings):
            raise RuntimeError(f"spacing mismatch: {spacings}")
        return (np.stack(images).astype(np.float32), {"spacing": spacings[0]})

    def read_seg(self, seg_fname: str):
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict):
        spacing = list(reversed(properties["spacing"]))
        write_mha(output_fname, seg.transpose(2, 1, 0).astype(np.uint8), spacing)
