"""The port's NRRD, MHA/MHD, TIFF and natural-image readers and writers
against the JAX package's: a file written by either package reads through
both with equal arrays, spacing and properties (NRRD raw and gzip, MHA
raw and zlib, a detached MHD + raw pair, big-endian payloads, 3D TIFF
stacks with their spacing sidecar, grey and RGB PNGs); and the registry
resolves every name and file ending as JAX's does."""
import os

import numpy as np
import pytest

from fast_nnunet_tpu.imageio import mha as jmha
from fast_nnunet_tpu.imageio import natural_image as jnat
from fast_nnunet_tpu.imageio import nrrd as jnrrd
from fast_nnunet_tpu.imageio import registry as jreg
from fast_nnunet_tpu.imageio import tiff as jtiff
from fast_nnunet_tpu_torch.imageio import mha as pmha
from fast_nnunet_tpu_torch.imageio import natural_image as pnat
from fast_nnunet_tpu_torch.imageio import nrrd as pnrrd
from fast_nnunet_tpu_torch.imageio import registry as preg
from fast_nnunet_tpu_torch.imageio import tiff as ptiff

SPACING = (0.75, 1.25, 2.5)   # on-disk (i, j, k) order


def _vol(dtype, seed=0, shape=(13, 11, 7)):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * 200 - 50).astype(dtype)


def _same(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "gzip"])
@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_nrrd_cross_read(tmp_path, writer, dtype, compress):
    vol = _vol(dtype)
    f = str(tmp_path / "v.nrrd")
    (jnrrd if writer == "jax" else pnrrd).write_nrrd(f, vol, SPACING,
                                                     compress=compress)
    got, ref = pnrrd.read_nrrd(f), jnrrd.read_nrrd(f)
    _same(got, ref)
    np.testing.assert_array_equal(got[0], vol)
    assert got[1]["_spacing"] == list(SPACING)
    _same(pnrrd.NrrdIO().read_images([f, f]), jnrrd.NrrdIO().read_images(
        [f, f]))
    assert pnrrd.NrrdIO().read_seg(f)[0].shape == (1, 7, 11, 13)


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "zlib"])
@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32,
                                   np.float64])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mha_cross_read(tmp_path, writer, dtype, compress):
    vol = _vol(dtype, seed=1)
    f = str(tmp_path / "v.mha")
    (jmha if writer == "jax" else pmha).write_mha(f, vol, SPACING,
                                                  compress=compress)
    got, ref = pmha.read_mha(f), jmha.read_mha(f)
    _same(got, ref)
    np.testing.assert_array_equal(got[0], vol)
    _same(pmha.MhaIO().read_images([f]), jmha.MhaIO().read_images([f]))


def test_mha_writers_byte_equal(tmp_path):
    vol = _vol(np.int16, seed=2)
    for compress in (False, True):
        pmha.write_mha(str(tmp_path / "p.mha"), vol, SPACING, compress)
        jmha.write_mha(str(tmp_path / "j.mha"), vol, SPACING, compress)
        assert (tmp_path / "p.mha").read_bytes() == \
            (tmp_path / "j.mha").read_bytes()
        pnrrd.write_nrrd(str(tmp_path / "p.nrrd"), vol, SPACING, compress)
        jnrrd.write_nrrd(str(tmp_path / "j.nrrd"), vol, SPACING, compress)
        assert (tmp_path / "p.nrrd").read_bytes() == \
            (tmp_path / "j.nrrd").read_bytes()


@pytest.mark.parametrize("big_endian", [False, True])
def test_mhd_detached_and_byte_order(tmp_path, big_endian):
    """A detached header + data file (.mhd + .raw), as ITK writes it."""
    vol = _vol(np.int16, seed=3)
    dt = np.dtype(">i2" if big_endian else "<i2")
    (tmp_path / "v.raw").write_bytes(
        np.asfortranarray(vol.astype(dt)).tobytes(order="F"))
    (tmp_path / "v.mhd").write_text(
        "ObjectType = Image\nNDims = 3\nBinaryData = True\n"
        f"BinaryDataByteOrderMSB = {big_endian}\n"
        "ElementSpacing = 0.75 1.25 2.5\nDimSize = 13 11 7\n"
        "ElementType = MET_SHORT\nElementDataFile = v.raw\n")
    f = str(tmp_path / "v.mhd")
    got, ref = pmha.read_mha(f), jmha.read_mha(f)
    _same(got, ref)
    np.testing.assert_array_equal(got[0], vol)
    assert got[0].dtype == np.int16


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_seg_writers_cross_read(tmp_path, writer):
    """write_seg of NRRD and MHA (reversed axes and spacing) read back
    equal through both packages."""
    seg = np.random.RandomState(4).randint(0, 7, (6, 9, 5)).astype(np.uint8)
    props = {"spacing": [2.5, 1.25, 0.75]}
    for ext, (pm, jm) in ((".nrrd", (pnrrd.NrrdIO, jnrrd.NrrdIO)),
                          (".mha", (pmha.MhaIO, jmha.MhaIO))):
        f = str(tmp_path / f"s{ext}")
        (jm if writer == "jax" else pm)().write_seg(seg, f, props)
        got, ref = pm().read_seg(f), jm().read_seg(f)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[0][0], seg)
        assert got[1]["spacing"] == ref[1]["spacing"] == props["spacing"]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tiff_stack_cross_read(tmp_path, writer, dtype):
    vol = _vol(np.float32, seed=5, shape=(4, 9, 6))
    vol = (np.abs(vol) if dtype != np.float32 else vol).astype(dtype)
    f = str(tmp_path / "v.tif")
    (jtiff if writer == "jax" else ptiff)._write_tiff_stack(f, vol)
    (tmp_path / "v.json").write_text('{"spacing": [3.0, 0.5, 0.25]}')
    got, ref = ptiff.Tiff3DIO().read_images([f]), \
        jtiff.Tiff3DIO().read_images([f])
    _same(got, ref)
    np.testing.assert_array_equal(got[0][0], vol.astype(np.float32))
    assert got[1]["spacing"] == [3.0, 0.5, 0.25]
    seg = (vol > vol.mean()).astype(np.uint8)
    out = str(tmp_path / "s.tif")
    (jtiff.Tiff3DIO if writer == "jax" else ptiff.Tiff3DIO)().write_seg(
        seg, out, {"spacing": [3.0, 0.5, 0.25]})
    _same(ptiff.Tiff3DIO().read_seg(out), jtiff.Tiff3DIO().read_seg(out))
    np.testing.assert_array_equal(ptiff.Tiff3DIO().read_seg(out)[0][0], seg)


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_png_cross_read(tmp_path, writer, rgb):
    from PIL import Image
    rng = np.random.RandomState(6)
    img = rng.randint(0, 255, (12, 17, 3) if rgb else (12, 17)).astype(
        np.uint8)
    f = str(tmp_path / "i.png")
    Image.fromarray(img).save(f)
    got, ref = pnat.NaturalImage2DIO().read_images([f]), \
        jnat.NaturalImage2DIO().read_images([f])
    _same(got, ref)
    assert got[0].shape == ((3 if rgb else 1), 1, 12, 17)
    seg = rng.randint(0, 3, (1, 12, 17)).astype(np.uint8)
    out = str(tmp_path / "s.png")
    (jnat if writer == "jax" else pnat).NaturalImage2DIO().write_seg(
        seg, out, got[1])
    _same(pnat.NaturalImage2DIO().read_seg(out),
          jnat.NaturalImage2DIO().read_seg(out))
    np.testing.assert_array_equal(
        pnat.NaturalImage2DIO().read_seg(out)[0][0, 0], seg[0])


ENDINGS = (".nii.gz", ".nii", "nii.gz", ".gz", ".nrrd", ".NRRD", ".nhdr",
           ".mha", ".mhd", ".tif", ".tiff", ".png", ".bmp", ".jpg", ".jpeg",
           ".dcm", ".dicom")
NAMES = ("NiftiIO", "SimpleITKIO", "NibabelIO", "NiftiIOWithReorient",
         "SimpleITKIOWithReorient", "NibabelIOWithReorient",
         "NaturalImage2DIO", "NrrdIO", "MhaIO", "Tiff3DIO", "DicomIO")


@pytest.mark.parametrize("ending", ENDINGS)
def test_registry_ending_equals_jax(ending):
    got = preg.determine_reader_writer_from_file_ending(ending)
    assert got.__name__ == \
        jreg.determine_reader_writer_from_file_ending(ending).__name__
    dj = {"file_ending": ending}
    assert preg.determine_reader_writer_from_dataset_json(dj).__name__ == \
        jreg.determine_reader_writer_from_dataset_json(dj).__name__


def test_registry_names_equal_jax():
    assert sorted(preg._BY_NAME) == sorted(jreg._BY_NAME) == sorted(NAMES)
    for name in NAMES:
        assert preg.find_reader_writer_by_name(name).__name__ == \
            jreg.find_reader_writer_by_name(name).__name__
        dj = {"file_ending": ".nii.gz", "overwrite_image_reader_writer": name}
        assert preg.determine_reader_writer_from_dataset_json(dj).__name__ \
            == name
    assert preg.determine_reader_writer_from_dataset_json(
        {"file_ending": ".mha", "overwrite_image_reader_writer": "None"}
    ).__name__ == "MhaIO"
    assert preg.determine_reader_writer_from_dataset_json(
        {}, example_file="/x/case_0000.nrrd").__name__ == "NrrdIO"
    with pytest.raises(KeyError):
        preg.find_reader_writer_by_name("NoSuchIO")
    with pytest.raises(RuntimeError):
        preg.determine_reader_writer_from_file_ending(".xyz")
    assert preg.determine_reader_writer_from_file_ending(
        ".xyz", allow_nonmatching=True).__name__ == "NiftiIO"


def test_readers_refuse_bad_files(tmp_path):
    f = tmp_path / "bad.nrrd"
    f.write_bytes(b"P5 not nrrd")
    for read in (pnrrd.read_nrrd, jnrrd.read_nrrd):
        with pytest.raises(ValueError, match="not an NRRD"):
            read(str(f))
    g = tmp_path / "bad.mha"
    g.write_text("ObjectType = Image\nDimSize = 2 2 2\n")
    for read in (pmha.read_mha, jmha.read_mha):
        with pytest.raises(ValueError, match="ElementDataFile"):
            read(str(g))
    assert os.path.getsize(g) > 0
