"""DICOM series in pure Python — a copy of fast_nnunet_tpu/imageio/dicom.py,
the intake of the reference engine's DICOM converter
(engine/fast_nnunet.cpp:5-24), a parser written from the standard for what
CT scanners export:

- transfer syntaxes Implicit VR Little Endian (1.2.840.10008.1.2) and
  Explicit VR Little Endian (1.2.840.10008.1.2.1); a compressed syntax
  raises ``RuntimeError``;
- geometry from ImagePositionPatient / ImageOrientationPatient /
  PixelSpacing: slices sorted by their projection on the slice normal, the
  between-slice spacing the median of the position steps;
- pixels rescaled to HU by RescaleSlope / RescaleIntercept.

Volumes are (1, Z, Y, X) with spacing [dz, dy, dx], the axis order of the
other readers; ``read_images`` takes series folders or lists of slice
files. Masks are written as NIfTI. ``fast_nnunet_dicom_to_nifti_torch
SERIES_DIR OUT.nii.gz`` converts a series."""
import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .nifti import _check_all_same, write_nifti

_IMPLICIT_LE = "1.2.840.10008.1.2"
_EXPLICIT_LE = "1.2.840.10008.1.2.1"

# VRs with a 2-byte reserved field and 4-byte length in explicit VR
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT",
             b"UN"}

_TAGS = {
    (0x0008, 0x0018): "sop_instance_uid",
    (0x0018, 0x0050): "slice_thickness",
    (0x0018, 0x0088): "spacing_between_slices",
    (0x0020, 0x000E): "series_uid",
    (0x0020, 0x0013): "instance_number",
    (0x0020, 0x0032): "image_position",
    (0x0020, 0x0037): "image_orientation",
    (0x0028, 0x0002): "samples_per_pixel",
    (0x0028, 0x0010): "rows",
    (0x0028, 0x0011): "cols",
    (0x0028, 0x0030): "pixel_spacing",
    (0x0028, 0x0100): "bits_allocated",
    (0x0028, 0x0103): "pixel_representation",
    (0x0028, 0x1052): "rescale_intercept",
    (0x0028, 0x1053): "rescale_slope",
    (0x7FE0, 0x0010): "pixel_data",
}


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError("truncated DICOM element")
    return b


def _skip_undefined_sequence(f) -> None:
    """Skip an SQ/UN element with undefined length: walk items until the
    sequence delimitation item (FFFE,E0DD)."""
    while True:
        group, elem, length = struct.unpack("<HHI", _read_exact(f, 8))
        if (group, elem) == (0xFFFE, 0xE0DD):
            return
        if (group, elem) == (0xFFFE, 0xE000):
            if length == 0xFFFFFFFF:  # undefined-length item: walk its elements
                while True:
                    g2, e2, l2 = struct.unpack("<HHI", _read_exact(f, 8))
                    if (g2, e2) == (0xFFFE, 0xE00D):
                        break
                    f.seek(l2, os.SEEK_CUR)
            else:
                f.seek(length, os.SEEK_CUR)
        else:
            raise ValueError("malformed sequence in DICOM stream")


def _parse_elements(f, explicit: bool, stop_after_pixel_data: bool = True
                    ) -> Dict[str, bytes]:
    out: Dict[str, bytes] = {}
    while True:
        head = f.read(8)
        if len(head) < 8:
            break
        group, elem = struct.unpack("<HH", head[:4])
        if explicit and group != 0xFFFE:
            vr = head[4:6]
            if vr in _LONG_VRS:
                (length,) = struct.unpack("<I", _read_exact(f, 4))
            else:
                (length,) = struct.unpack("<H", head[6:8])
        else:
            vr = b""
            (length,) = struct.unpack("<I", head[4:8])
        if length == 0xFFFFFFFF:
            _skip_undefined_sequence(f)
            continue
        name = _TAGS.get((group, elem))
        if name is not None:
            out[name] = _read_exact(f, length)
            if name == "pixel_data" and stop_after_pixel_data:
                break
        else:
            f.seek(length, os.SEEK_CUR)
    return out


def _decode_floats(raw: bytes) -> List[float]:
    return [float(x) for x in raw.decode("ascii", "ignore").strip("\x00 ").split("\\") if x]


def _read_slice(fname: str) -> dict:
    with open(fname, "rb") as f:
        pre = f.read(132)
        if len(pre) == 132 and pre[128:132] == b"DICM":
            # file meta group: always explicit little endian
            meta = {}
            while True:
                pos = f.tell()
                head = f.read(8)
                if len(head) < 8:
                    break
                group, elem = struct.unpack("<HH", head[:4])
                if group != 0x0002:
                    f.seek(pos)
                    break
                vr = head[4:6]
                if vr in _LONG_VRS:
                    (length,) = struct.unpack("<I", _read_exact(f, 4))
                else:
                    (length,) = struct.unpack("<H", head[6:8])
                val = _read_exact(f, length)
                if (group, elem) == (0x0002, 0x0010):
                    meta["transfer_syntax"] = val.decode("ascii").strip("\x00 ")
            ts = meta.get("transfer_syntax", _EXPLICIT_LE)
        else:
            # no preamble: raw implicit-VR stream (some exporters do this)
            f.seek(0)
            ts = _IMPLICIT_LE
        if ts == _IMPLICIT_LE:
            explicit = False
        elif ts == _EXPLICIT_LE:
            explicit = True
        else:
            raise RuntimeError(
                f"Unsupported (compressed?) DICOM transfer syntax {ts} in "
                f"{fname}; decompress the series first")
        el = _parse_elements(f, explicit)

    rows = struct.unpack("<H", el["rows"])[0]
    cols = struct.unpack("<H", el["cols"])[0]
    bits = struct.unpack("<H", el.get("bits_allocated", b"\x10\x00"))[0]
    signed = struct.unpack("<H", el.get("pixel_representation", b"\x00\x00"))[0]
    if bits == 16:
        dtype = np.int16 if signed else np.uint16
    elif bits == 8:
        dtype = np.int8 if signed else np.uint8
    else:
        raise RuntimeError(f"unsupported BitsAllocated {bits} in {fname}")
    px = np.frombuffer(el["pixel_data"], dtype, count=rows * cols)
    px = px.reshape(rows, cols).astype(np.float32)
    slope = _decode_floats(el.get("rescale_slope", b"1"))[0]
    intercept = _decode_floats(el.get("rescale_intercept", b"0"))[0]
    px = px * slope + intercept

    ipp = _decode_floats(el.get("image_position", b"0\\0\\0"))
    iop = _decode_floats(el.get("image_orientation", b"1\\0\\0\\0\\1\\0"))
    ps = _decode_floats(el.get("pixel_spacing", b"1\\1"))
    inst = el.get("instance_number")
    return {
        "pixels": px, "position": np.array(ipp, float),
        "orientation": np.array(iop, float).reshape(2, 3),
        "pixel_spacing": ps,  # (row spacing = dy, col spacing = dx)
        "thickness": _decode_floats(el.get(
            "spacing_between_slices", el.get("slice_thickness", b"1")))[0],
        "instance": int(_decode_floats(inst)[0]) if inst else None,
    }


def read_dicom_series(fnames_or_dir) -> Tuple[np.ndarray, dict]:
    """Series directory or list of slice files -> ((Z, Y, X) float32 HU,
    properties)."""
    if isinstance(fnames_or_dir, str) and os.path.isdir(fnames_or_dir):
        fnames = [os.path.join(fnames_or_dir, f)
                  for f in sorted(os.listdir(fnames_or_dir))
                  if not f.startswith(".")]
    else:
        fnames = list(fnames_or_dir)
    slices = [_read_slice(f) for f in fnames]
    assert slices, "empty DICOM series"

    normal = np.cross(slices[0]["orientation"][0], slices[0]["orientation"][1])
    keys = [float(np.dot(s["position"], normal)) for s in slices]
    if len(set(keys)) != len(keys) and all(s["instance"] is not None
                                           for s in slices):
        keys = [s["instance"] for s in slices]
    order = np.argsort(keys)
    slices = [slices[i] for i in order]
    keys = [keys[i] for i in order]

    vol = np.stack([s["pixels"] for s in slices])  # (Z, Y, X)
    if len(slices) > 1:
        dz = float(np.median(np.diff(keys)))
        if not np.isfinite(dz) or dz <= 0:
            dz = slices[0]["thickness"]
    else:
        dz = slices[0]["thickness"]
    dy, dx = slices[0]["pixel_spacing"]
    props = {
        "spacing": [abs(dz), float(dy), float(dx)],
        "dicom_origin": slices[0]["position"].tolist(),
        "dicom_orientation": slices[0]["orientation"].tolist(),
    }
    return vol, props


def convert_dicom_to_nifti(series_dir: str, output_fname: str) -> None:
    """The fast_nnunet_dicom_convertor role: DICOM series -> .nii.gz."""
    vol, props = read_dicom_series(series_dir)
    # write_nifti takes on-disk (i, j, k) = (X, Y, Z) order; our volume is
    # (Z, Y, X) with spacing [dz, dy, dx]
    write_nifti(output_fname, np.ascontiguousarray(vol.transpose(2, 1, 0)),
                spacing=tuple(props["spacing"][::-1]))


class DicomIO:
    """Reader for DICOM series. Each entry of image_fnames may be a series
    directory or a single .dcm file; all entries must share geometry."""
    supported_file_endings = [".dcm", ".dicom"]

    def read_images(self, image_fnames: Sequence[str]) -> Tuple[np.ndarray, dict]:
        vols, props = [], None
        singles = [f for f in image_fnames if not os.path.isdir(f)]
        if singles and len(singles) == len(image_fnames) and len(singles) > 1:
            # a list of slice files = one series, one channel
            v, props = read_dicom_series(list(image_fnames))
            vols = [v]
        else:
            for f in image_fnames:
                v, p = read_dicom_series(f if os.path.isdir(f) else [f])
                if props is None:
                    props = p
                elif not np.allclose(p["spacing"], props["spacing"]):
                    raise RuntimeError("DICOM channels disagree on spacing")
                vols.append(v)
        shapes = [v.shape for v in vols]
        assert _check_all_same(shapes), f"shape mismatch: {shapes}"
        return np.stack(vols).astype(np.float32), props

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        v, p = read_dicom_series(seg_fname if os.path.isdir(seg_fname)
                                 else [seg_fname])
        return v[None].astype(np.float32), p

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        # masks are emitted as NIfTI (same behavior as the reference engine,
        # which writes .nii.gz next to DICOM input)
        if not output_fname.endswith((".nii", ".nii.gz")):
            output_fname = output_fname + ".nii.gz"
        write_nifti(output_fname,
                    np.ascontiguousarray(seg.astype(np.uint8).transpose(2, 1, 0)),
                    spacing=tuple(properties["spacing"][::-1]))


def convert_dicom_entry(argv=None) -> None:
    """``fast_nnunet_dicom_to_nifti_torch SERIES_DIR OUT.nii.gz``"""
    import argparse
    ap = argparse.ArgumentParser(description="DICOM series -> NIfTI")
    ap.add_argument("series_dir")
    ap.add_argument("output", help="output .nii.gz")
    args = ap.parse_args(argv)
    convert_dicom_to_nifti(args.series_dir, args.output)
