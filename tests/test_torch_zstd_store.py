"""The port's chunked-zstd case store (``.fnnz``) against the JAX package's:
files written by either read bit-equal through the other (whole arrays and
patch slices across brick borders and the image edge), the brick shapes
equal, the two zstd backends (the ``zstandard`` package and the system
libzstd through ctypes) read each other's frames, the store is found from
the files present, the patch sampler reads bricks and never the whole
case, ``-store fnnz`` preprocessing writes JAX's store byte for byte, and
``fast_nnunet_train_torch -device cpu`` trains from it."""
import os
import pickle

import numpy as np
import pytest

import chip_smoke
from fast_nnunet_tpu.training import zstd_store as jz
from fast_nnunet_tpu.training.dataset import \
    infer_dataset_class as jax_infer
from fast_nnunet_tpu_torch.training import zstd_store as pz
from fast_nnunet_tpu_torch.training.dataset import (NpyCaseDataset,
                                                    infer_dataset_class)
from fast_nnunet_tpu_torch.utils import zstd

from .helpers import make_synthetic_dataset
from .test_torch_preprocess import _Paths, assert_equal_tree
from .torch_port_common import (no_persistent_compile_cache,  # noqa: F401
                                only_libzstd)

BACKENDS = ("zstandard", "libzstd")


@pytest.mark.parametrize("image,patch,bpv", [
    ((1, 512, 512, 512), (96, 96, 160), 4),
    ((2, 10, 12, 8), (96, 96, 160), 4),
    ((1, 200, 140, 140), (160, 48, 48), 4),
    ((1, 200, 140, 140), (160, 48, 48), 1),
    ((3, 64, 64, 64), None, 2),
    ((1, 48, 512, 512), (1, 512, 512), 4),
    ((1, 30, 7, 5), (20, 3), 4),
    ((4, 256, 256), (256, 256), 4),
])
def test_brick_shape_equals_jax(image, patch, bpv):
    got = pz.compute_brick_shape(image, patch, bpv)
    assert got == jz.compute_brick_shape(image, patch, bpv)
    assert int(np.prod(got)) * image[0] * bpv <= 1 << 20 or min(got) <= 8


def _slices(rng, shape, n=20):
    """Random boxes, plus boxes across brick borders and on the image
    edge."""
    out = [(slice(None),) + tuple(slice(0, s) for s in shape[1:]),
           (slice(None), slice(3, 19)),
           (slice(None),) + tuple(slice(7, 9) for _ in shape[1:]),
           (slice(None),) + tuple(slice(s - 5, s) for s in shape[1:]),
           (slice(0, 1),) + tuple(slice(15, 17) for _ in shape[1:])]
    for _ in range(n):
        lo = [rng.randint(0, s) for s in shape[1:]]
        hi = [rng.randint(l + 1, s + 1) for l, s in zip(lo, shape[1:])]
        out.append((slice(None),) + tuple(slice(l, h)
                                          for l, h in zip(lo, hi)))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_read_bit_equal(tmp_path, monkeypatch, writer, backend):
    """A file from one package reads bit-equal through the other (the
    port on either zstd backend), for float data and int8 labels."""
    if backend == "libzstd":
        only_libzstd(monkeypatch)
    rng = np.random.RandomState(0)
    arrays = {"data": rng.randn(2, 37, 53, 29).astype(np.float32),
              "seg": rng.randint(-1, 5, (1, 37, 53, 29)).astype(np.int8)}
    for name, arr in arrays.items():
        path = str(tmp_path / f"{name}.fnnz")
        (jz if writer == "jax" else pz).write_fnnz(path, arr, (16, 16, 16))
        readers = [pz.BrickReader(path), jz.BrickReader(path)]
        for r in readers:
            assert r.shape == arr.shape and r.dtype == arr.dtype
            np.testing.assert_array_equal(np.asarray(r), arr)
            for sl in _slices(rng, arr.shape):
                got = r[sl]
                assert got.dtype == arr.dtype
                np.testing.assert_array_equal(got, arr[sl])


def test_port_file_bytes_equal_jax(tmp_path):
    """Header and frames byte for byte, where both packages take the
    zstandard codec."""
    arr = np.random.RandomState(1).randn(1, 33, 20, 41).astype(np.float32)
    pz.write_fnnz(str(tmp_path / "p.fnnz"), arr, (32, 16, 16))
    jz.write_fnnz(str(tmp_path / "j.fnnz"), arr, (32, 16, 16))
    assert zstd.backend() == "zstandard"
    assert (tmp_path / "p.fnnz").read_bytes() == \
        (tmp_path / "j.fnnz").read_bytes()


@pytest.mark.parametrize("size", [0, 1, 4096, 1 << 20])
def test_zstd_backends_read_each_other(size):
    rng = np.random.RandomState(size)
    data = (np.cumsum(rng.randint(-2, 3, size)) % 251).astype(
        np.uint8).tobytes()
    a, b = zstd.codec("zstandard"), zstd.codec("libzstd")
    for level in (3, 8):
        for enc, dec in ((a, b), (b, a)):
            assert dec.decompress(enc.compress(data, level)) == data


def test_zstd_without_a_backend_raises(monkeypatch):
    monkeypatch.setattr(zstd, "_load", lambda name: None)
    with pytest.raises(RuntimeError, match="zstandard"):
        zstd.codec()
    with pytest.raises(RuntimeError, match="libzstd"):
        zstd.codec("libzstd")
    with pytest.raises(ValueError):
        zstd.codec("lz4")


def test_case_dataset_and_autodetect(tmp_path):
    rng = np.random.RandomState(1)
    data = rng.rand(1, 20, 22, 18).astype(np.float32)
    seg = (rng.rand(1, 20, 22, 18) * 3).astype(np.int8)
    props = {"spacing": [1.0, 1.0, 2.0], "class_locations": {1: []}}
    pz.ZstdCaseDataset.save_case(data, seg, props, str(tmp_path / "caseA"),
                                 patch_size=(16, 16, 16))
    assert infer_dataset_class(str(tmp_path)) is pz.ZstdCaseDataset
    assert jax_infer(str(tmp_path)) is jz.ZstdCaseDataset
    for ds in (pz.ZstdCaseDataset(str(tmp_path)),
               jz.ZstdCaseDataset(str(tmp_path))):
        assert ds.keys() == ["caseA"]
        d, s, p = ds.load_case("caseA", mmap=False)
        np.testing.assert_array_equal(d, data)
        np.testing.assert_array_equal(s, seg)
        assert p == props == ds.load_properties("caseA")
    lazy, lseg, _ = pz.ZstdCaseDataset(str(tmp_path)).load_case("caseA")
    assert isinstance(lazy, pz.BrickReader) and lazy.shape == data.shape
    np.testing.assert_array_equal(lazy[:, 2:9, 1:5, 0:7],
                                  data[:, 2:9, 1:5, 0:7])
    with pytest.raises(IndexError):
        lazy[0]
    npy = tmp_path / "npy"
    npy.mkdir()
    assert infer_dataset_class(str(npy)) is NpyCaseDataset
    (npy / "x.b2nd").write_bytes(b"")
    with pytest.raises(ValueError, match="fast_nnunet_convert_b2nd_torch"):
        infer_dataset_class(str(npy))


def test_patch_sampler_reads_bricks_like_npy(tmp_path, monkeypatch):
    """The sampler over the .fnnz store draws the batch it draws over the
    .npy store of the same cases (and JAX's sampler over its .fnnz
    reader), slicing bricks without a whole-case read."""
    from fast_nnunet_tpu.training import dataloader as jdl
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    from fast_nnunet_tpu_torch.training import dataloader as pdl
    rng = np.random.RandomState(3)
    (tmp_path / "z").mkdir()
    (tmp_path / "n").mkdir()
    for i in range(3):
        data = rng.randn(1, 21, 26, 19).astype(np.float32)
        seg = rng.randint(0, 3, (1, 21, 26, 19)).astype(np.int8)
        props = {"class_locations":
                 DefaultPreprocessor._sample_foreground_locations(seg, [1, 2]),
                 "spacing": [1.0, 1.0, 1.0]}
        pz.ZstdCaseDataset.save_case(data, seg, props,
                                     str(tmp_path / "z" / f"c{i}"), (8, 8, 8))
        NpyCaseDataset.save_case(data, seg, props,
                                 str(tmp_path / "n" / f"c{i}"))

    def no_whole_read(self, dtype=None, copy=None):
        raise AssertionError("the sampler read a whole case")

    monkeypatch.setattr(pz.BrickReader, "__array__", no_whole_read)
    batches = []
    for dl, ds in ((pdl, pz.ZstdCaseDataset(str(tmp_path / "z"))),
                   (pdl, NpyCaseDataset(str(tmp_path / "n"))),
                   (jdl, jz.ZstdCaseDataset(str(tmp_path / "z")))):
        sampler = dl.PatchSampler(ds, 4, (12, 14, 10), (12, 14, 10), 0.5)
        batches.append(sampler.generate_batch(np.random.RandomState(5)))
    for b in batches[1:]:
        assert b["keys"] == batches[0]["keys"]
        np.testing.assert_array_equal(b["data"], batches[0]["data"])
        np.testing.assert_array_equal(b["target"][0], batches[0]["target"][0])


DS = "Dataset995_Synth"


def _fnnz_pipeline(who):
    if who == "port":
        from fast_nnunet_tpu_torch.run.plan_and_preprocess import \
            plan_and_preprocess_entry
        plan_and_preprocess_entry(["-d", "995", "-npfp", "1", "-c",
                                   "3d_fullres", "-np", "1", "-store",
                                   "fnnz"])
    else:
        from fast_nnunet_tpu.run import plan_and_preprocess as jpp
        jpp.extract_fingerprints([995], 1, False)
        jpp.plan_experiments([995])
        jpp.preprocess([995], "nnUNetPlans", ["3d_fullres"], [1],
                       storage="fnnz")


def test_preprocess_fnnz_store_equals_jax(tmp_path):
    """``-store fnnz``: the port's .fnnz files are JAX's byte for byte
    (both on the zstandard codec), the pickles equal, and the arrays
    equal the .npy store's."""
    outs = {}
    for who in ("port", "jax"):
        with _Paths(tmp_path / who) as paths:
            make_synthetic_dataset(paths.env["nnUNet_raw"], DS, n_cases=3,
                                   shape=(20, 22, 18))
            _fnnz_pipeline(who)
            outs[who] = paths.pre(DS, "nnUNetPlans_3d_fullres")
    files = sorted(os.listdir(outs["port"]))
    assert files == sorted(os.listdir(outs["jax"]))
    assert sum(f.endswith(".fnnz") for f in files) == 6
    assert not any(f.endswith(".npy") for f in files)
    for f in files:
        a, b = (os.path.join(outs[w], f) for w in ("port", "jax"))
        if f.endswith(".fnnz"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert_equal_tree(pickle.load(fa), pickle.load(fb), f)
    with _Paths(tmp_path / "npy") as paths:
        make_synthetic_dataset(paths.env["nnUNet_raw"], DS, n_cases=3,
                               shape=(20, 22, 18))
        from fast_nnunet_tpu_torch.run.plan_and_preprocess import \
            plan_and_preprocess_entry
        plan_and_preprocess_entry(["-d", "995", "-npfp", "1", "-c",
                                   "3d_fullres", "-np", "1"])
        npy = NpyCaseDataset(paths.pre(DS, "nnUNetPlans_3d_fullres"))
    fnnz = pz.ZstdCaseDataset(outs["port"])
    assert fnnz.keys() == npy.keys()
    for k in npy.keys():
        for x, y in zip(fnnz.load_case(k, mmap=False)[:2],
                        npy.load_case(k)[:2]):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_train_from_fnnz_store_on_cpu(tmp_path, monkeypatch):
    """plan -> preprocess -store fnnz (FNNT_STORE) -> fast_nnunet_train_torch
    -device cpu: the trainer finds the .fnnz store and trains from it."""
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import \
        plan_and_preprocess_entry
    from fast_nnunet_tpu_torch.run.run_training import run_training_entry
    from fast_nnunet_tpu_torch.training.checkpoint import load_checkpoint
    from fast_nnunet_tpu_torch.utils.io import join, load_json, save_json
    for k in ("raw", "preprocessed", "results"):
        os.makedirs(tmp_path / k)
        monkeypatch.setenv(f"nnUNet_{k}", str(tmp_path / k))
    for k, v in (("FNNT_ITERS_PER_EPOCH", "2"),
                 ("FNNT_VAL_ITERS_PER_EPOCH", "1"),
                 ("FNNT_NUM_EPOCHS", "1"), ("nnUNet_n_proc_DA", "2"),
                 ("FNNT_STORE", "fnnz")):
        monkeypatch.setenv(k, v)
    ds = "Dataset987_FnnzCT"
    chip_smoke.write_raw_ct_dataset(str(tmp_path / "raw"), dataset=ds,
                                    shape=(12, 32, 32),
                                    spacing=(3.0, 1.0, 1.0), n_classes=4,
                                    seed=2)
    plan_and_preprocess_entry(["-d", "987", "-c", "3d_fullres", "-npfp",
                               "1", "-np", "1"])
    pre = join(str(tmp_path / "preprocessed"), ds)
    store = join(pre, "nnUNetPlans_3d_fullres")
    assert infer_dataset_class(store) is pz.ZstdCaseDataset
    plans = load_json(join(pre, "nnUNetPlans.json"))
    arch = plans["configurations"]["3d_fullres"]["architecture"][
        "arch_kwargs"]
    arch["features_per_stage"] = [min(4 * 2 ** i, 16)
                                  for i in range(arch["n_stages"])]
    save_json(plans, join(pre, "nnUNetPlans.json"), sort_keys=False)
    seen = []
    real = pz.BrickReader.__getitem__

    def counting(self, idx):
        seen.append(self._path)
        return real(self, idx)

    monkeypatch.setattr(pz.BrickReader, "__getitem__", counting)
    run_training_entry(["987", "3d_fullres", "0", "-device", "cpu"])
    assert any(p.endswith(".fnnz") for p in seen)
    ckpt = load_checkpoint(join(str(tmp_path / "results"), ds,
                                "NNUNetTrainer__nnUNetPlans__3d_fullres",
                                "fold_0", "checkpoint_final.fnnx"))
    assert np.isfinite(ckpt["logging"]["train_losses"][0])
