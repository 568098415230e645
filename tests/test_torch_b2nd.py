"""The port's blosc2 ``.b2nd`` reader and writer against the JAX package's
and against the real C library's output: the committed frame whose chunks
libblosc1 compressed (``tests/fixtures/real_chunks.b2nd``) and every
committed libblosc chunk (``blosc1_real.npz``) decode bit-equal; chunks and
frames round-trip over dtypes, shuffle and ragged edges; frames written by
either package read through the other; and ``fast_nnunet_convert_b2nd_torch``
migrates a reference-layout folder into the ``.npy`` and ``.fnnz``
stores."""
import os

import numpy as np
import pytest

from fast_nnunet_tpu.utils import b2nd as jb
from fast_nnunet_tpu_torch.utils import b2nd as pb

from .torch_port_common import only_libzstd

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def test_real_chunks_b2nd_frame():
    got = pb.read_b2nd(os.path.join(FIXTURES, "real_chunks.b2nd"))
    exp = np.load(os.path.join(FIXTURES, "real_chunks_expected.npy"))
    assert got.dtype == exp.dtype
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("backend", ["zstandard", "libzstd"])
def test_real_libblosc_chunks_decode(monkeypatch, backend):
    if backend == "libzstd":
        only_libzstd(monkeypatch)
    with np.load(os.path.join(FIXTURES, "blosc1_real.npz")) as z:
        names = sorted(set(k.rsplit("__", 1)[0] for k in z.files))
        assert len(names) >= 7
        for name in names:
            chunk = z[f"{name}__chunk"].tobytes()
            assert pb.decompress_chunk(chunk) == z[f"{name}__raw"].tobytes(), \
                name


@pytest.mark.parametrize("dtype,shuffle", [(np.float32, True),
                                           (np.float32, False),
                                           (np.int8, True),
                                           (np.uint16, True),
                                           (np.int16, False)])
def test_chunk_roundtrip_and_cross_decode(dtype, shuffle):
    rng = np.random.RandomState(0)
    data = (rng.rand(1000) * 100).astype(dtype).tobytes()
    size = np.dtype(dtype).itemsize
    for chunk in (pb.compress_chunk(data, size, 256, shuffle=shuffle),
                  jb.compress_chunk(data, size, 256, shuffle=shuffle)):
        assert pb.decompress_chunk(chunk) == data
        assert jb.decompress_chunk(chunk) == data


def test_chunk_incompressible_and_legacy_header():
    data = np.random.RandomState(4).bytes(4096)
    assert pb.decompress_chunk(pb.compress_chunk(data, 4, 1024)) == data
    chunk = bytearray(pb.compress_chunk(
        (np.random.RandomState(5).rand(600) * 9).astype(np.float32)
        .tobytes(), 4, 512))
    chunk[0] = 2  # the JAX package's pre-round-4 writer's version byte
    assert pb.decompress_chunk(bytes(chunk)) == jb.decompress_chunk(
        bytes(chunk))


@pytest.mark.parametrize("shape,chunks,dtype", [
    ((3, 20, 24, 16), (1, 8, 8, 8), np.float32),
    ((1, 13, 9, 7), (1, 8, 8, 8), np.float32),
    ((1, 18, 20, 16), (1, 8, 8, 8), np.int8),
    ((5, 6), None, np.float32),
    ((2, 11, 10), (1, 4, 4), np.int16),
])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_frame_cross_read(tmp_path, shape, chunks, dtype, writer):
    """A frame from either package reads bit-equal through both."""
    rng = np.random.RandomState(1)
    a = (rng.rand(*shape) * 50 - 5).astype(dtype)
    f = str(tmp_path / "a.b2nd")
    (jb if writer == "jax" else pb).write_b2nd(f, a, chunks=chunks)
    for read in (pb.read_b2nd, jb.read_b2nd):
        b = read(f)
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(a, b)


def test_port_frame_bytes_equal_jax(tmp_path):
    a = np.random.RandomState(2).rand(2, 14, 16, 12).astype(np.float32)
    pb.write_b2nd(str(tmp_path / "p.b2nd"), a, chunks=(1, 8, 8, 8))
    jb.write_b2nd(str(tmp_path / "j.b2nd"), a, chunks=(1, 8, 8, 8))
    assert (tmp_path / "p.b2nd").read_bytes() == \
        (tmp_path / "j.b2nd").read_bytes()


def _reference_folder(src):
    from fast_nnunet_tpu_torch.utils.io import save_pickle
    src.mkdir()
    rng = np.random.RandomState(3)
    cases = {}
    for ident in ("case_000", "case_001"):
        data = rng.rand(2, 14, 16, 12).astype(np.float32)
        seg = rng.randint(-1, 3, (1, 14, 16, 12)).astype(np.int8)
        pb.write_b2nd(str(src / f"{ident}.b2nd"), data, chunks=(2, 8, 8, 8))
        jb.write_b2nd(str(src / f"{ident}_seg.b2nd"), seg,
                      chunks=(1, 8, 8, 8))
        props = {"spacing": [1.0, 1.0, 2.0],
                 "class_locations": {1: np.zeros((0, 4), np.int64)}}
        save_pickle(props, str(src / f"{ident}.pkl"))
        cases[ident] = (data, seg, props)
    (src / "splits_final.json").write_text("[]")
    (src / "gt_segmentations").mkdir()
    (src / "gt_segmentations" / "x.txt").write_text("x")
    return cases


@pytest.mark.parametrize("fnnz", [False, True], ids=["npy", "fnnz"])
def test_convert_b2nd_cli(tmp_path, capsys, fnnz):
    """fast_nnunet_convert_b2nd_torch (its entry function) writes the case
    store the trainer finds, equal to the JAX converter's, and carries the
    folder's other files along."""
    from fast_nnunet_tpu.run.convert_b2nd import convert_folder as jconvert
    from fast_nnunet_tpu_torch.run.convert_b2nd import convert_b2nd_entry
    from fast_nnunet_tpu_torch.training.dataset import infer_dataset_class
    cases = _reference_folder(tmp_path / "ref")
    dst = tmp_path / "ours"
    convert_b2nd_entry(["-i", str(tmp_path / "ref"), "-o", str(dst)]
                       + (["--fnnz"] if fnnz else []))
    assert "converted 2 cases" in capsys.readouterr().out
    jconvert(str(tmp_path / "ref"), str(tmp_path / "jax"), use_fnnz=fnnz)
    assert sorted(os.listdir(dst)) == sorted(os.listdir(tmp_path / "jax"))
    assert (dst / "splits_final.json").read_text() == "[]"
    assert (dst / "gt_segmentations" / "x.txt").is_file()
    ds = infer_dataset_class(str(dst))(str(dst))
    assert type(ds).__name__ == ("ZstdCaseDataset" if fnnz
                                 else "NpyCaseDataset")
    assert ds.keys() == sorted(cases)
    for ident, (data, seg, props) in cases.items():
        d, s, p = ds.load_case(ident, mmap=False)
        assert d.dtype == np.float32 and s.dtype == np.int8
        np.testing.assert_array_equal(d, data)
        np.testing.assert_array_equal(s, seg)
        assert p["spacing"] == props["spacing"]
    for f in os.listdir(dst):
        if f.endswith((".npy", ".fnnz")):
            assert (dst / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def test_msgpack_missing_raises(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_msgpack(name, *a, **kw):
        if name == "msgpack":
            raise ImportError("no msgpack")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_msgpack)
    with pytest.raises(RuntimeError, match="msgpack"):
        pb.read_b2nd(os.path.join(FIXTURES, "real_chunks.b2nd"))
