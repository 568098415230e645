"""The port's host data path against the JAX package's: the training and
validation augmenters, the patch sampler and the case store produce the same
batch, bit for bit, from one ``np.random.RandomState``; the cross-validation
splits (shared through splits_final.json), crop_and_pad_nd and the dataset
naming equal the originals; a dataloader worker's exception reaches the
training loop."""
import os

import numpy as np
import pytest

from fast_nnunet_tpu.ops import pad as jpad
from fast_nnunet_tpu.training import augment as jaug
from fast_nnunet_tpu.training import dataloader as jdl
from fast_nnunet_tpu.training import dataset as jds
from fast_nnunet_tpu.utils import misc as jmisc
from fast_nnunet_tpu_torch.ops import pad as ppad
from fast_nnunet_tpu_torch.training import augment as paug
from fast_nnunet_tpu_torch.training import dataloader as pdl
from fast_nnunet_tpu_torch.training import dataset as pds
from fast_nnunet_tpu_torch.utils import misc as pmisc

PATCH = (16, 16, 16)
DS = [(1.0, 1.0, 1.0), (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)]


def _case(seed, shape=(20, 18, 22), n_classes=3):
    rng = np.random.RandomState(seed)
    data = rng.randn(1, *shape).astype(np.float32)
    seg = np.zeros((1, *shape), np.int8)
    for c in range(1, n_classes):
        lo = [rng.randint(0, s - 6) for s in shape]
        seg[(0,) + tuple(slice(v, v + 5) for v in lo)] = c
    seg[0, :2] = -1
    return data, seg


def _equal_batches(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("regions", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_training_augmenter_bit_equal(seed, regions):
    """The full default pipeline (spatial, noise, blur, brightness,
    contrast, low resolution, gamma, mirroring, -1 removal, regions, deep
    supervision targets) from the same RandomState state."""
    rot, dummy, initial, mirror = \
        paug.configure_rotation_dummyDA_mirroring_and_initial_patch_size(
            PATCH)
    assert (rot, dummy, tuple(initial), mirror) == \
        (lambda r: (r[0], r[1], tuple(r[2]), r[3]))(
            jaug.configure_rotation_dummyDA_mirroring_and_initial_patch_size(
                PATCH))
    kw = dict(regions=[1, (1, 2)] if regions else None, ds_scales=DS)
    data, seg = _case(seed)
    sl = tuple(slice(0, s) for s in initial)
    d, s = data[(slice(None),) + sl[:3]], seg[(slice(None),) + sl[:3]]
    got = paug.TrainingAugmenter(PATCH, rot, mirror, **kw)(
        d, s, np.random.RandomState(seed + 100))
    want = jaug.TrainingAugmenter(PATCH, rot, mirror, **kw)(
        d, s, np.random.RandomState(seed + 100))
    _equal_batches(got, want)


def test_validation_augmenter_bit_equal():
    data, seg = _case(5, shape=(20, 20, 20))
    got = paug.ValidationAugmenter(PATCH, ds_scales=DS)(
        data, seg, np.random.RandomState(0))
    want = jaug.ValidationAugmenter(PATCH, ds_scales=DS)(
        data, seg, np.random.RandomState(0))
    _equal_batches(got, want)


@pytest.fixture
def store(tmp_path):
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    for i in range(3):
        data, seg = _case(10 + i)
        props = {"class_locations":
                 DefaultPreprocessor._sample_foreground_locations(
                     seg, [1, 2]), "spacing": [1.0, 1.0, 1.0]}
        pds.NpyCaseDataset.save_case(data, seg, props,
                                     str(tmp_path / f"case_{i:03d}"))
    return str(tmp_path)


@pytest.mark.parametrize("probabilistic", [False, True])
def test_patch_sampler_batch_bit_equal(store, probabilistic):
    """Case choice, foreground oversampling, bbox, crop-and-pad and the
    training transform from one RandomState: the same batch in both
    packages, NCDHW."""
    rot, _, initial, mirror = \
        paug.configure_rotation_dummyDA_mirroring_and_initial_patch_size(
            PATCH)
    batches = []
    for aug, dl, ds in ((paug, pdl, pds), (jaug, jdl, jds)):
        sampler = dl.PatchSampler(
            ds.NpyCaseDataset(store), 3, initial, PATCH, 0.33,
            transform=aug.TrainingAugmenter(PATCH, rot, mirror, ds_scales=DS),
            probabilistic_oversampling=probabilistic)
        batches.append(sampler.generate_batch(np.random.RandomState(7)))
    got, want = batches
    assert got["keys"] == want["keys"]
    assert got["data"].shape == (3, 1, *PATCH)
    _equal_batches((got["data"], got["target"]),
                   (want["data"], want["target"]))


def test_dataset_store_round_trip(store):
    ds = pds.NpyCaseDataset(store)
    assert ds.keys() == jds.NpyCaseDataset(store).keys() == \
        ["case_000", "case_001", "case_002"]
    d, s, p = ds.load_case("case_001")
    jd, js, jp = jds.NpyCaseDataset(store).load_case("case_001")
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(s, js)
    assert s.dtype == np.int8 and isinstance(d, np.memmap)
    assert pds.infer_dataset_class(store) is pds.NpyCaseDataset
    open(os.path.join(store, "case_009.fnnz"), "wb").close()
    with pytest.raises(NotImplementedError):
        pds.infer_dataset_class(store)


def test_async_iterator_surfaces_worker_errors(store):
    class Boom:
        def generate_batch(self, rng):
            raise ValueError("bad case")

    it = pdl.AsyncBatchIterator(Boom(), num_workers=1)
    with pytest.raises(RuntimeError, match="dataloader worker died") as e:
        next(it)
    assert isinstance(e.value.__cause__, ValueError)
    it.shutdown()


@pytest.mark.parametrize("n_keys,seed,n_splits", [(4, 12345, 5),
                                                  (10, 12345, 5),
                                                  (13, 7, 3)])
def test_crossval_split_equal(n_keys, seed, n_splits):
    keys = [f"case_{i:03d}" for i in np.random.RandomState(n_keys).permutation(
        n_keys)]
    assert pmisc.generate_crossval_split(keys, seed, n_splits) == \
        jmisc.generate_crossval_split(keys, seed, n_splits)


@pytest.mark.parametrize("bbox", [[[0, 5], [2, 9]], [[-3, 4], [5, 12]],
                                  [[-2, 9], [-1, 10]]])
def test_crop_and_pad_nd_equal(bbox):
    img = np.random.RandomState(0).randn(2, 6, 8).astype(np.float32)
    for pad_value in (0, -1):
        np.testing.assert_array_equal(
            ppad.crop_and_pad_nd(img, bbox, pad_value),
            jpad.crop_and_pad_nd(img, bbox, pad_value))


def test_dataset_naming(tmp_path, monkeypatch):
    for env in ("nnUNet_raw", "nnUNet_preprocessed", "nnUNet_results"):
        os.makedirs(tmp_path / env)
        monkeypatch.setenv(env, str(tmp_path / env))
    os.makedirs(tmp_path / "nnUNet_raw" / "Dataset042_Bones")
    for arg in (42, "42", "Dataset042_Bones"):
        assert pmisc.maybe_convert_to_dataset_name(arg) == \
            jmisc.maybe_convert_to_dataset_name(arg) == "Dataset042_Bones"
    with pytest.raises(RuntimeError):
        pmisc.convert_id_to_dataset_name(43)
    from fast_nnunet_tpu_torch import paths
    assert paths.get_results_folder() == str(tmp_path / "nnUNet_results")
    monkeypatch.delenv("nnUNet_results")
    with pytest.raises(RuntimeError):
        paths.get_results_folder()
