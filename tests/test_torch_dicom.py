"""The port's DICOM series reader (``imageio/dicom.py``) against the JAX
package's: explicit and implicit VR little-endian series, written in a
scrambled file order by two independent encoders (tests/test_dicom.py's
and chip_smoke.py's), read equal (volume, spacing, origin, orientation);
a compressed transfer syntax is refused with JAX's error type;
``DicomIO`` reads folders and slice lists and writes masks as NIfTI; and
``fast_nnunet_dicom_to_nifti_torch`` writes the volume and header JAX's
converter writes."""
import gzip
import os

import numpy as np
import pytest

import chip_smoke
from fast_nnunet_tpu.imageio import dicom as jd
from fast_nnunet_tpu_torch.imageio import dicom as pd
from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO

from .test_dicom import _el_explicit, _write_slice


def _series(path, explicit, writer, seed=0):
    rng = np.random.RandomState(seed)
    raw = rng.randint(-1024, 3000, (5, 12, 16)).astype(np.int16)
    os.makedirs(path)
    order = [3, 0, 4, 1, 2]
    if writer == "tests":
        for i, z in enumerate(order):
            _write_slice(os.path.join(path, f"im{i:03d}.dcm"), z, raw[z],
                         explicit)
        return raw * 2.0 - 1024.0, [2.5, 0.75, 0.5]
    chip_smoke.write_dicom_series(path, raw, [2.0, 0.9765625, 0.5],
                                  explicit=explicit, order=order)
    return raw.astype(np.float32), [2.0, 0.9765625, 0.5]


@pytest.mark.parametrize("writer", ["tests", "chip_smoke"])
@pytest.mark.parametrize("explicit", [True, False], ids=["explicit",
                                                         "implicit"])
def test_series_equals_jax(tmp_path, explicit, writer):
    d = str(tmp_path / "series")
    want, spacing = _series(d, explicit, writer)
    vol, props = pd.read_dicom_series(d)
    jvol, jprops = jd.read_dicom_series(d)
    assert vol.dtype == jvol.dtype and vol.shape == (5, 12, 16)
    np.testing.assert_array_equal(vol, jvol)
    np.testing.assert_array_equal(vol, want)
    assert props == jprops and props["spacing"] == spacing
    files = sorted(os.path.join(d, f) for f in os.listdir(d))
    for io in (pd.DicomIO(), jd.DicomIO()):
        data, p = io.read_images(files)
        np.testing.assert_array_equal(data[0], want)
        data, p = io.read_images([d, d])
        assert data.shape == (2, 5, 12, 16) and p["spacing"] == spacing
        seg, _ = io.read_seg(d)
        np.testing.assert_array_equal(seg[0], want)


def test_compressed_transfer_syntax_refused(tmp_path):
    path = str(tmp_path / "jpeg.dcm")
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM")
        f.write(_el_explicit(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.4.90"))
    with pytest.raises(RuntimeError, match="transfer syntax") as ep:
        pd.read_dicom_series([path])
    with pytest.raises(RuntimeError) as ej:
        jd.read_dicom_series([path])
    assert type(ep.value) is type(ej.value)


def _payload(fname):
    with gzip.open(fname, "rb") as f:
        return f.read()


def test_dicom_to_nifti_cli_equals_jax(tmp_path, monkeypatch):
    """The entry function's NIfTI holds JAX's header and voxels byte for
    byte (the gzip streams may differ: the port writes at level 1)."""
    d = str(tmp_path / "series")
    want, spacing = _series(d, True, "chip_smoke", seed=1)
    out, jout = str(tmp_path / "p.nii.gz"), str(tmp_path / "j.nii.gz")
    pd.convert_dicom_entry([d, out])
    monkeypatch.setattr("sys.argv", ["fnnUNet_dicom_to_nifti", d, jout])
    jd.convert_dicom_entry()
    assert _payload(out) == _payload(jout)
    img, props = NiftiIO().read_images([out])
    np.testing.assert_array_equal(img[0], want)
    assert np.allclose(props["spacing"], spacing)
    seg = (want > 0).astype(np.uint8)
    for io in (pd.DicomIO(), jd.DicomIO()):
        name = str(tmp_path / f"mask_{type(io).__module__.split('.')[0]}")
        io.write_seg(seg, name, {"spacing": spacing})
        m, mp = NiftiIO().read_seg(name + ".nii.gz")
        np.testing.assert_array_equal(m[0], seg)
        assert np.allclose(mp["spacing"], spacing)
