"""The port's libdeflate codec (fast_nnunet_tpu_torch/utils/fastgz.py) and
its NIfTI reader and writer against the JAX package's: round trips through
one and several gzip members, interop with stdlib gzip both ways, `.nii.gz`
bytes equal to the JAX writer's where libdeflate loads, and the stdlib
fallback under FNN_NO_LIBDEFLATE=1 (each package then reads the other's
files to the same arrays)."""
import gzip

import numpy as np
import pytest

from fast_nnunet_tpu.imageio import nifti as jnifti
from fast_nnunet_tpu.utils import fastgz as jfastgz
from fast_nnunet_tpu_torch.imageio import nifti as pnifti
from fast_nnunet_tpu_torch.utils import fastgz

from . import torch_port_common  # noqa: F401  (caps torch threads)

needs_libdeflate = pytest.mark.skipif(
    not fastgz.available(), reason="no system libdeflate on this host")


def _payload(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "mask":      # few labels in runs: what a writer mostly sees
        return np.repeat(rng.randint(0, 61, 4096), 64).astype(np.uint8)
    if kind == "ct":
        return rng.randint(-1024, 3000, 100_000).astype(np.int16)
    return rng.randn(50_000).astype(np.float32)


def _volume(kind: str, seed: int = 0):
    rng = np.random.RandomState(seed)
    if kind == "mask":
        v = np.zeros((24, 20, 12), np.uint8)
        v[4:18, 3:15, 2:10] = rng.randint(0, 61, (14, 12, 8))
        return v
    if kind == "ct":
        return rng.randint(-1024, 3000, (24, 20, 12)).astype(np.int16)
    return rng.randn(24, 20, 12).astype(np.float32)


@pytest.fixture
def no_libdeflate(monkeypatch):
    """Both packages' codecs as on a host without the library."""
    monkeypatch.setenv("FNN_NO_LIBDEFLATE", "1")
    for mod in (fastgz, jfastgz):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", False)
    yield
    for mod in (fastgz, jfastgz):
        mod._TRIED = False  # reload on next use, with the env restored


@needs_libdeflate
@pytest.mark.parametrize("kind", ["mask", "ct", "float"])
@pytest.mark.parametrize("level", [1, 6])
def test_round_trip_and_stdlib_interop(kind, level):
    arr = _payload(kind)
    raw = arr.view(np.uint8)
    comp = fastgz.gzip_compress(arr, level)
    assert comp == jfastgz.gzip_compress(arr, level)  # same library, bytes
    assert gzip.decompress(comp) == raw.tobytes()
    np.testing.assert_array_equal(fastgz.gzip_decompress(comp), raw)
    np.testing.assert_array_equal(
        fastgz.gzip_decompress(gzip.compress(raw.tobytes(), level)), raw)
    # two members, as the NIfTI writer emits them
    two = fastgz.gzip_compress(b"header bytes", level) + comp
    np.testing.assert_array_equal(
        fastgz.gzip_decompress(two),
        np.frombuffer(b"header bytes" + raw.tobytes(), np.uint8))


@needs_libdeflate
def test_decompress_grows_past_a_wrong_size_hint():
    arr = _payload("ct")
    comp = fastgz.gzip_compress(arr, 1)
    got = fastgz.gzip_decompress(comp, expected_size=16)
    np.testing.assert_array_equal(got, arr.view(np.uint8))
    assert fastgz.gzip_decompress(b"not gzip at all, not at all") is None


@needs_libdeflate
@pytest.mark.parametrize("kind", ["mask", "ct", "float"])
def test_nii_gz_bytes_equal_jax_writer(tmp_path, kind):
    vol = _volume(kind)
    fp, fj = str(tmp_path / "p.nii.gz"), str(tmp_path / "j.nii.gz")
    pnifti.write_nifti(fp, vol, spacing=(0.8, 0.8, 1.0))
    jnifti.write_nifti(fj, vol, spacing=(0.8, 0.8, 1.0))
    with open(fp, "rb") as a, open(fj, "rb") as b:
        assert a.read() == b.read()
    for reader in (pnifti.read_nifti, jnifti.read_nifti):
        for f in (fp, fj):
            data, hdr = reader(f)
            np.testing.assert_array_equal(data, vol)
            assert data.dtype == vol.dtype


@pytest.mark.parametrize("kind", ["mask", "ct"])
def test_stdlib_fallback_without_libdeflate(tmp_path, no_libdeflate, kind):
    """FNN_NO_LIBDEFLATE=1: the codec declines, the writer and reader go
    through stdlib gzip, and each package reads the other's file."""
    assert not fastgz.available()
    assert fastgz.gzip_compress(b"x") is None
    assert fastgz.gzip_decompress(gzip.compress(b"x")) is None
    vol = _volume(kind, seed=1)
    fp, fj = str(tmp_path / "p.nii.gz"), str(tmp_path / "j.nii.gz")
    pnifti.write_nifti(fp, vol, spacing=(1.0, 1.0, 2.5))
    jnifti.write_nifti(fj, vol, spacing=(1.0, 1.0, 2.5))
    with open(fp, "rb") as f:
        one_member = gzip.decompress(f.read())
    assert len(one_member) == 352 + vol.nbytes
    for reader in (pnifti.read_nifti, jnifti.read_nifti):
        for f in (fp, fj):
            data, hdr = reader(f)
            np.testing.assert_array_equal(data, vol)
            assert list(hdr["pixdim"][1:4]) == [1.0, 1.0, 2.5]


@needs_libdeflate
def test_levels_follow_fnn_gzip_level(tmp_path, monkeypatch):
    vol = np.repeat(_volume("mask", seed=2), 4, axis=0)
    sizes = {}
    for level in ("1", "9"):
        monkeypatch.setenv("FNN_GZIP_LEVEL", level)
        f = str(tmp_path / f"l{level}.nii.gz")
        pnifti.write_nifti(f, vol, spacing=(1, 1, 1))
        fj = str(tmp_path / f"j{level}.nii.gz")
        jnifti.write_nifti(fj, vol, spacing=(1, 1, 1))
        with open(f, "rb") as a, open(fj, "rb") as b:
            body = a.read()
            assert body == b.read()
        sizes[level] = len(body)
        np.testing.assert_array_equal(pnifti.read_nifti(f)[0], vol)
    assert sizes["9"] != sizes["1"]  # the level reached the codec
