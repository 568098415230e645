"""Self-contained NIfTI-1 I/O in pure numpy: the read/write pieces of
fast_nnunet_tpu/imageio/nifti.py that ``TurboPipeline.predict_file`` uses
(``NiftiIOWithReorient`` and what it builds on), copied, with the stdlib
``gzip``/``zlib`` in place of the JAX package's libdeflate binding.

Axis convention: on-disk NIfTI data is Fortran-ordered (i fastest). Arrays are
exposed as (k, j, i) with spacing (pixdim3, pixdim2, pixdim1) — the reversal
SimpleITK's GetArrayFromImage gives. The reorienting reader canonicalizes to
closest-RAS on read and restores the original orientation and header on
write.
"""
import gzip
import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

_DTYPE_BY_CODE = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODE_BY_DTYPE = {np.dtype(v): k for k, v in _DTYPE_BY_CODE.items()}

HEADER_SIZE = 348


def _read_payload(fname: str) -> np.ndarray:
    with open(fname, "rb") as f:
        raw = f.read()
    if fname.endswith(".gz"):
        raw = gzip.decompress(raw)
    return np.frombuffer(raw, np.uint8)


def read_nifti(fname: str) -> Tuple[np.ndarray, dict]:
    """Returns (data in on-disk (i, j, k[, t]) index order, header dict).
    The array is a Fortran-ordered, possibly read-only view over the
    decompressed buffer; callers that mutate must copy."""
    raw = _read_payload(fname)
    hdr = raw[:HEADER_SIZE].tobytes()
    if struct.unpack("<i", hdr[:4])[0] == 348:
        endian = "<"
    elif struct.unpack(">i", hdr[:4])[0] == 348:
        endian = ">"
    else:
        raise ValueError(f"{fname}: not a NIfTI-1 file (sizeof_hdr != 348). "
                         "NIfTI-2 is not supported yet.")

    def unpack(fmt, offset, count=1):
        size = struct.calcsize(endian + fmt * count)
        return struct.unpack(endian + fmt * count, hdr[offset:offset + size])

    dim = unpack("h", 40, 8)
    datatype = unpack("h", 70)[0]
    pixdim = unpack("f", 76, 8)
    vox_offset = int(unpack("f", 108)[0])
    scl_slope = unpack("f", 112)[0]
    scl_inter = unpack("f", 116)[0]
    qform_code = unpack("h", 252)[0]
    sform_code = unpack("h", 254)[0]
    quatern = unpack("f", 256, 6)
    srow_x = unpack("f", 280, 4)
    srow_y = unpack("f", 296, 4)
    srow_z = unpack("f", 312, 4)
    magic = hdr[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{fname}: bad NIfTI magic {magic!r}")

    ndim = dim[0]
    shape = tuple(max(1, d) for d in dim[1:1 + max(ndim, 3)])
    if datatype not in _DTYPE_BY_CODE:
        raise ValueError(f"{fname}: unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPE_BY_CODE[datatype]).newbyteorder(endian)
    count = int(np.prod(shape))
    offset = max(vox_offset,
                 HEADER_SIZE + 4 if magic[:2] == b"n+" else HEADER_SIZE)
    data = raw[offset:offset + count * dtype.itemsize].view(dtype)
    data = data.reshape(shape, order="F")
    if dtype != dtype.newbyteorder("="):
        data = data.astype(dtype.newbyteorder("="))
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        data = data * np.float32(slope) + np.float32(scl_inter)
    header = {
        "dim": list(dim), "datatype": int(datatype), "pixdim": list(pixdim),
        "scl_slope": float(scl_slope), "scl_inter": float(scl_inter),
        "qform_code": int(qform_code), "sform_code": int(sform_code),
        "quatern": list(quatern),
        "srow_x": list(srow_x), "srow_y": list(srow_y),
        "srow_z": list(srow_z), "endian": endian,
    }
    return data, header


def _affine_from_header(h: dict) -> np.ndarray:
    if h["sform_code"] > 0:
        return np.array([h["srow_x"], h["srow_y"], h["srow_z"], [0, 0, 0, 1]],
                        dtype=np.float64)
    b, c, d, ox, oy, oz = h["quatern"]
    a = np.sqrt(max(0.0, 1.0 - b * b - c * c - d * d))
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c]])
    qfac = -1.0 if h["pixdim"][0] < 0 else 1.0
    scales = np.array([h["pixdim"][1], h["pixdim"][2], h["pixdim"][3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R * scales
    aff[:3, 3] = [ox, oy, oz]
    return aff


def write_nifti(fname: str, data: np.ndarray, header: Optional[dict] = None,
                spacing: Optional[Sequence[float]] = None) -> None:
    """data in on-disk (i, j, k) index order. Either a header dict
    (round-trip) or a spacing (i, j, k order) for fresh files. ``.gz`` files
    are written at compresslevel 1 (FNN_GZIP_LEVEL overrides): masks and CT
    volumes are redundant enough that level 1 compresses nearly as well."""
    data = np.asarray(data)
    if data.dtype == bool:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _CODE_BY_DTYPE:
        data = data.astype(np.float32)
    code = _CODE_BY_DTYPE[np.dtype(data.dtype)]
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    if header is not None:
        pixdim = list(header["pixdim"])
        qform_code, sform_code = header["qform_code"], header["sform_code"]
        quatern = header["quatern"]
        srow_x, srow_y, srow_z = (header["srow_x"], header["srow_y"],
                                  header["srow_z"])
    else:
        spacing = list(spacing) if spacing is not None else [1.0] * 3
        pixdim = [1.0] + spacing[:3] + [1.0] * (7 - 3)
        qform_code, sform_code = 0, 1
        quatern = [0.0] * 6
        srow_x = [spacing[0], 0, 0, 0]
        srow_y = [0, spacing[1], 0, 0]
        srow_z = [0, 0, spacing[2], 0]

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 1.0)
    struct.pack_into("<f", hdr, 116, 0.0)
    struct.pack_into("<h", hdr, 252, qform_code)
    struct.pack_into("<h", hdr, 254, sform_code)
    struct.pack_into("<6f", hdr, 256, *quatern)
    struct.pack_into("<4f", hdr, 280, *srow_x)
    struct.pack_into("<4f", hdr, 296, *srow_y)
    struct.pack_into("<4f", hdr, 312, *srow_z)
    hdr[344:348] = b"n+1\x00"

    flat = np.asfortranarray(data).reshape(-1, order="F").view(np.uint8)
    if fname.endswith(".gz"):
        level = int(os.environ.get("FNN_GZIP_LEVEL", 1))
        with gzip.open(fname, "wb", compresslevel=level) as f:
            f.write(bytes(hdr) + b"\x00\x00\x00\x00")
            f.write(flat)
        return
    with open(fname, "wb") as f:
        f.write(bytes(hdr) + b"\x00\x00\x00\x00")
        f.write(flat.tobytes())


def _check_all_same(input_list) -> bool:
    first = input_list[0]
    return all(len(i) == len(first) and np.allclose(i, first)
               for i in input_list)


class NiftiIO:
    """(C, X, Y, Z) with X=k, Y=j, Z=i (reversed on-disk order) and spacing
    reversed to match."""
    supported_file_endings = [".nii", ".nii.gz"]

    def read_images(self, image_fnames: Sequence[str],
                    dtype=np.float32) -> Tuple[np.ndarray, dict]:
        """dtype=None keeps the on-disk dtype (e.g. int16 CT HU)."""
        images, spacings, headers = [], [], []
        for f in image_fnames:
            data, hdr = read_nifti(f)
            if data.ndim == 4:
                chans = [data[..., t].transpose(2, 1, 0)
                         for t in range(data.shape[3])]
                sp = hdr["pixdim"][1:4][::-1]
            elif data.ndim == 3:
                chans = [data.transpose(2, 1, 0)]
                sp = hdr["pixdim"][1:4][::-1]
            elif data.ndim == 2:
                chans = [data.transpose(1, 0)]
                sp = hdr["pixdim"][1:3][::-1]
            else:
                raise ValueError(f"{f}: unsupported ndim {data.ndim}")
            images.extend(chans)
            spacings.append([abs(s) if s != 0 else 1.0 for s in sp])
            headers.append(hdr)
        if not _check_all_same([i.shape for i in images]):
            raise RuntimeError(f"Image channels have mismatched shapes: "
                               f"{[i.shape for i in images]} ({image_fnames})")
        if not _check_all_same(spacings):
            raise RuntimeError(
                f"Image channels have mismatched spacings: {spacings}")
        data = np.stack(images)
        if dtype is not None:
            data = data.astype(dtype, copy=False)
        if data.ndim == 3:  # 2D natural case: (C, X, Y) -> fake Z
            data = data[:, None]
            spacing = [999.0] + list(spacings[0])[:2]
        else:
            spacing = list(spacings[0])
        props = {"spacing": spacing, "nifti_header": headers[0],
                 "affine": _affine_from_header(headers[0]).tolist()}
        return data, props

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str,
                  properties: dict) -> None:
        hdr = properties.get("nifti_header")
        if seg.ndim == 3 and seg.shape[0] == 1 and \
                len(properties.get("spacing", [])) == 3 and \
                properties["spacing"][0] == 999.0:
            seg = seg[0]
        seg_disk = seg.transpose(1, 0) if seg.ndim == 2 \
            else seg.transpose(2, 1, 0)
        dtype = np.uint8 if seg.max() < 255 else np.uint16
        if hdr is not None:
            hdr = dict(hdr)
            hdr["dim"] = [seg_disk.ndim] + list(seg_disk.shape) + \
                [1] * (7 - seg_disk.ndim)
            write_nifti(output_fname, seg_disk.astype(dtype), header=hdr)
        else:
            write_nifti(output_fname, seg_disk.astype(dtype),
                        spacing=properties["spacing"][::-1])


def io_orientation(affine: np.ndarray):
    """For each voxel axis (disk order i, j, k), the closest world axis and
    its sign (the nibabel io_orientation contract)."""
    R = np.asarray(affine, np.float64)[:3, :3]
    ornt = []
    used = set()
    for j in range(3):
        col = R[:, j]
        for ax in np.argsort(-np.abs(col)):
            if int(ax) not in used:
                break
        used.add(int(ax))
        ornt.append((int(ax), 1.0 if col[int(ax)] >= 0 else -1.0))
    return ornt


def apply_orientation(arr: np.ndarray, ornt) -> np.ndarray:
    """Disk-order (i, j, k) array -> RAS-ordered (r, a, s) array."""
    perm = [0, 0, 0]
    for j, (ax, _) in enumerate(ornt):
        perm[ax] = j
    out = np.transpose(arr, perm)
    for a in range(3):
        if ornt[perm[a]][1] < 0:
            out = np.flip(out, axis=a)
    return out


def invert_orientation(arr: np.ndarray, ornt) -> np.ndarray:
    """RAS-ordered array -> original disk order (inverse of
    apply_orientation)."""
    perm = [0, 0, 0]
    for j, (ax, _) in enumerate(ornt):
        perm[ax] = j
    for a in range(3):
        if ornt[perm[a]][1] < 0:
            arr = np.flip(arr, axis=a)
    return np.transpose(arr, np.argsort(perm))


class NiftiIOWithReorient(NiftiIO):
    """Reads with reorientation to closest-canonical RAS and restores the
    original orientation + header on write."""

    def read_images(self, image_fnames: Sequence[str],
                    dtype=np.float32) -> Tuple[np.ndarray, dict]:
        images, spacings, headers, ornts = [], [], [], []
        for f in image_fnames:
            data, hdr = read_nifti(f)
            if data.ndim != 3:
                return NiftiIO.read_images(self, image_fnames, dtype=dtype)
            ornt = io_orientation(_affine_from_header(hdr))
            ras = apply_orientation(data, ornt)
            # materialize now: stacking doubly-transposed views walks the
            # array in the worst stride order
            images.append(np.ascontiguousarray(ras.transpose(2, 1, 0)))
            perm = [0, 0, 0]
            for j, (ax, _) in enumerate(ornt):
                perm[ax] = j
            sp_ras = [abs(hdr["pixdim"][1 + perm[a]]) or 1.0
                      for a in range(3)]
            spacings.append(sp_ras[::-1])
            headers.append(hdr)
            ornts.append(ornt)
        if not _check_all_same([i.shape for i in images]):
            raise RuntimeError(
                f"Image channels have mismatched shapes after reorientation: "
                f"{[i.shape for i in images]} ({image_fnames})")
        if not _check_all_same(spacings):
            raise RuntimeError(
                f"Image channels have mismatched spacings: {spacings}")
        data = np.stack(images)
        if dtype is not None:
            data = data.astype(dtype, copy=False)
        props = {"spacing": list(spacings[0]), "nifti_header": headers[0],
                 "affine": _affine_from_header(headers[0]).tolist(),
                 "reorientation": [list(o) for o in ornts[0]]}
        return data, props

    def write_seg(self, seg: np.ndarray, output_fname: str,
                  properties: dict) -> None:
        ornt = properties.get("reorientation")
        if ornt is None:
            return NiftiIO.write_seg(self, seg, output_fname, properties)
        ornt = [(int(a), float(s)) for a, s in ornt]
        disk = invert_orientation(seg.transpose(2, 1, 0), ornt)
        hdr = dict(properties["nifti_header"])
        hdr["dim"] = [3] + list(disk.shape) + [1, 1, 1, 1]
        dtype = np.uint8 if seg.max() < 255 else np.uint16
        write_nifti(output_fname, np.ascontiguousarray(disk).astype(dtype),
                    header=hdr)


class SimpleITKIO(NiftiIO):
    pass


class NibabelIO(NiftiIO):
    pass


class SimpleITKIOWithReorient(NiftiIOWithReorient):
    pass


class NibabelIOWithReorient(NiftiIOWithReorient):
    pass


def find_reader_writer_by_name(name: str):
    """Kept for the earlier import path; see
    :func:`fast_nnunet_tpu_torch.imageio.registry.find_reader_writer_by_name`."""
    from .registry import find_reader_writer_by_name as find
    return find(name)
