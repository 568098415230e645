"""The port's fingerprint, plan and preprocess against the JAX package's on
the same raw datasets (numpy only, no card): dataset_fingerprint.json and
nnUNetPlans.json byte-equal, every preprocessed ``.npy`` bit-equal (dtype
and shape too), every pickled properties dict equal (``class_locations``
included), with 1 and 2 worker processes. Also verify_dataset_integrity's
failures, the skipped configuration, the unported ``.fnnz`` store and the
``modify_seg_fn`` hook."""
import os
import pickle

import numpy as np
import pytest

import chip_smoke

from . import torch_port_common  # noqa: F401  (caps torch threads)
from .helpers import make_synthetic_dataset

DS = "Dataset995_Synth"
PATH_VARS = ("nnUNet_raw", "nnUNet_preprocessed", "nnUNet_results")


class _Paths:
    """nnUNet_raw / preprocessed / results under ``root``, set for the
    duration of a with-block and restored after."""

    def __init__(self, root):
        self.root = str(root)
        self.env = {v: os.path.join(self.root, v.split("_")[1])
                    for v in PATH_VARS}

    def __enter__(self):
        self.old = {v: os.environ.get(v) for v in PATH_VARS}
        for p in self.env.values():
            os.makedirs(p, exist_ok=True)
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        for v, old in self.old.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old

    def pre(self, *parts):
        return os.path.join(self.env["nnUNet_preprocessed"], *parts)


def assert_equal_tree(a, b, where="properties"):
    """Exact equality of nested dicts / lists / tuples / arrays, numpy
    dtypes included."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            assert_equal_tree(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_tree(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


def assert_same_preprocessed(pa: str, pb: str, configs) -> int:
    """Byte-equal fingerprint/plans/dataset JSON, bit-equal arrays, equal
    properties for every case of each configuration; returns the number
    of files compared."""
    n = 0
    for f in ("dataset_fingerprint.json", "nnUNetPlans.json",
              "dataset.json"):
        with open(os.path.join(pa, f)) as fa, open(os.path.join(pb, f)) as fb:
            assert fa.read() == fb.read(), f
    for cfg in configs:
        da, db = os.path.join(pa, cfg), os.path.join(pb, cfg)
        files = sorted(os.listdir(da))
        assert files == sorted(os.listdir(db)) and files
        for f in files:
            if f.endswith(".npy"):
                x, y = np.load(os.path.join(da, f)), np.load(os.path.join(db, f))
                assert x.dtype == y.dtype and x.shape == y.shape, f
                assert x.tobytes() == y.tobytes(), f
            else:
                with open(os.path.join(da, f), "rb") as fa, \
                        open(os.path.join(db, f), "rb") as fb:
                    assert_equal_tree(pickle.load(fa), pickle.load(fb), f)
            n += 1
    return n


def _jax_pipeline(ds_id, np_, configs):
    from fast_nnunet_tpu.run import plan_and_preprocess as jpp
    jpp.extract_fingerprints([ds_id], np_, True)
    jpp.plan_experiments([ds_id])
    jpp.preprocess([ds_id], "nnUNetPlans", configs, np_)


def _port_pipeline(ds_id, np_, configs):
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import \
        plan_and_preprocess_entry
    plan_and_preprocess_entry(["-d", str(ds_id), "-npfp", str(np_),
                               "--verify_dataset_integrity", "-c", *configs,
                               "-np", str(np_)])


#: configurations preprocessed per worker count (the pools are the slow part)
CONFIGS = {1: ["3d_fullres", "2d"], 2: ["3d_fullres"]}


@pytest.fixture(scope="module", params=[1, 2], ids=["np1", "np2"])
def synth(request, tmp_path_factory):
    """make_synthetic_dataset through both packages' pipelines with
    ``num_processes`` 1 or 2: (port preprocessed folder, JAX's, the
    worker count)."""
    np_ = request.param
    out = {}
    for who, run in (("port", _port_pipeline), ("jax", _jax_pipeline)):
        with _Paths(tmp_path_factory.mktemp(f"{who}{np_}")) as paths:
            make_synthetic_dataset(paths.env["nnUNet_raw"], DS, n_cases=4)
            run(995, np_, CONFIGS[np_] + ["3d_lowres"])
            out[who] = paths.pre(DS)
    return out["port"], out["jax"], np_


def test_fingerprint_and_plans_equal_jax(synth):
    pa, pb, _ = synth
    for f in ("dataset_fingerprint.json", "nnUNetPlans.json"):
        with open(os.path.join(pa, f)) as fa, open(os.path.join(pb, f)) as fb:
            assert fa.read() == fb.read(), f


def test_preprocessed_cases_bit_equal_jax(synth):
    pa, pb, np_ = synth
    n = assert_same_preprocessed(pa, pb, [f"nnUNetPlans_{c}"
                                          for c in CONFIGS[np_]])
    assert n == len(CONFIGS[np_]) * 4 * 3
    assert not os.path.isdir(os.path.join(pa, "nnUNetPlans_3d_lowres"))


def test_worker_pool_equals_one_process(tmp_path):
    """The spawned pool (num_processes 2) writes what one process writes."""
    outs = []
    for np_ in (1, 2):
        with _Paths(tmp_path / f"np{np_}") as paths:
            make_synthetic_dataset(paths.env["nnUNet_raw"], DS, n_cases=3,
                                   seed=3)
            _port_pipeline(995, np_, ["3d_fullres"])
            outs.append(paths.pre(DS))
    assert assert_same_preprocessed(*outs, ["nnUNetPlans_3d_fullres"]) == 9


def _write_ct_mixed_spacing(raw_root):
    """Three int16 CTs with 61 labels at different anisotropic spacings
    (resampling with the separate-z rule), through chip_smoke's writer."""
    from fast_nnunet_tpu_torch.utils.io import join
    import shutil
    spacings = [(3.5, 1.0, 1.0), (4.0, 1.2, 1.1), (3.0, 0.9, 1.0)]
    for i, sp in enumerate(spacings):
        f = chip_smoke.write_raw_ct_dataset(
            raw_root, dataset=f"Dataset99{i}_Tmp", shape=(12, 30, 26),
            spacing=sp, n_train=1, seed=i)
        dest = join(raw_root, "Dataset996_CT")
        for sub in ("imagesTr", "labelsTr"):
            os.makedirs(join(dest, sub), exist_ok=True)
        shutil.move(join(f, "imagesTr", "case_000_0000.nii.gz"),
                    join(dest, "imagesTr", f"case_{i:03d}_0000.nii.gz"))
        shutil.move(join(f, "labelsTr", "case_000.nii.gz"),
                    join(dest, "labelsTr", f"case_{i:03d}.nii.gz"))
        if i == 0:
            shutil.copy(join(f, "dataset.json"), join(dest, "dataset.json"))
        shutil.rmtree(f)
    from fast_nnunet_tpu_torch.utils.io import load_json, save_json
    dj = load_json(join(raw_root, "Dataset996_CT", "dataset.json"))
    dj["numTraining"] = len(spacings)
    save_json(dj, join(raw_root, "Dataset996_CT", "dataset.json"),
              sort_keys=False)


def test_ct_with_61_labels_and_resampling_bit_equal_jax(tmp_path):
    outs = []
    for who, run in (("port", _port_pipeline), ("jax", _jax_pipeline)):
        with _Paths(tmp_path / who) as paths:
            _write_ct_mixed_spacing(paths.env["nnUNet_raw"])
            run(996, 1, ["3d_fullres"])
            outs.append(paths.pre("Dataset996_CT"))
    assert assert_same_preprocessed(*outs, ["nnUNetPlans_3d_fullres"]) == 9
    seg = np.load(os.path.join(outs[0], "nnUNetPlans_3d_fullres",
                               "case_001_seg.npy"))
    with open(os.path.join(outs[0], "nnUNetPlans_3d_fullres",
                           "case_001.pkl"), "rb") as f:
        props = pickle.load(f)
    assert seg.dtype == np.int8 and seg.max() == 60
    assert len(props["class_locations"]) == 60
    assert list(props["shape_after_cropping_and_before_resampling"]) != \
        list(seg.shape[1:])  # the case was resampled


@pytest.fixture()
def raw_ds(tmp_path):
    with _Paths(tmp_path) as paths:
        make_synthetic_dataset(paths.env["nnUNet_raw"], DS, n_cases=3,
                               shape=(12, 14, 10))
        yield paths


def _break(raw, how):
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.utils.io import join, load_json, save_json
    folder = join(raw, DS)
    dj = load_json(join(folder, "dataset.json"))
    if how == "num_training":
        dj["numTraining"] = 5
    elif how == "missing_key":
        del dj["file_ending"]
    elif how == "missing_label":
        os.remove(join(folder, "labelsTr", "case_001.nii.gz"))
    elif how in ("bad_label", "shape"):
        seg, props = NiftiIO().read_seg(join(folder, "labelsTr",
                                             "case_002.nii.gz"))
        seg = seg[0].astype(np.uint8)
        if how == "bad_label":
            seg[0, 0, 0] = 7
        else:
            seg = seg[:, :-1]
        props = {"spacing": props["spacing"]}
        NiftiIO().write_seg(seg, join(folder, "labelsTr", "case_002.nii.gz"),
                            props)
    save_json(dj, join(folder, "dataset.json"), sort_keys=False)


@pytest.mark.parametrize("how", ["num_training", "missing_key",
                                 "missing_label", "bad_label", "shape"])
def test_verify_dataset_integrity_fails_like_jax(raw_ds, how):
    from fast_nnunet_tpu.planning.verify import verify_dataset_integrity as j
    from fast_nnunet_tpu_torch.planning.verify import \
        verify_dataset_integrity as p
    p(DS)  # the intact dataset passes
    _break(raw_ds.env["nnUNet_raw"], how)
    with pytest.raises(AssertionError) as ep:
        p(DS)
    with pytest.raises(AssertionError) as ej:
        j(DS)
    assert str(ep.value) == str(ej.value)


def test_fnnz_store_raises(raw_ds, monkeypatch):
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import (
        plan_and_preprocess_entry, preprocess_entry)
    plan_and_preprocess_entry(["-d", "995", "-npfp", "1", "--no_pp"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        preprocess_entry(["-d", "995", "-c", "3d_fullres", "-np", "1",
                          "-store", "fnnz"])
    monkeypatch.setenv("FNNT_STORE", "fnnz")
    with pytest.raises(NotImplementedError, match="fnnz"):
        preprocess_entry(["-d", "995", "-c", "3d_fullres", "-np", "1"])


def test_unplanned_configuration_is_skipped_like_jax(raw_ds, capsys):
    from fast_nnunet_tpu.run.plan_and_preprocess import preprocess as j
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import (
        extract_fingerprint_entry, plan_experiment_entry, preprocess)
    extract_fingerprint_entry(["-d", "995", "-np", "1"])
    plan_experiment_entry(["-d", "995"])
    capsys.readouterr()
    preprocess([995], configurations=["3d_lowres"], num_processes=1)
    port_out = capsys.readouterr().out
    j([995], configurations=["3d_lowres"], num_processes=1)
    assert port_out == capsys.readouterr().out
    assert "Configuration 3d_lowres not in plans of Dataset995_Synth" \
        in port_out


def test_modify_seg_fn_hook_runs_on_every_case(raw_ds):
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import \
        plan_and_preprocess_entry

    class Flip(DefaultPreprocessor):
        def modify_seg_fn(self, seg, plans_manager, dataset_json,
                          configuration_manager):
            return np.where(seg > 0, 2, seg)

    plan_and_preprocess_entry(["-d", "995", "-npfp", "1", "-c", "3d_fullres",
                               "-np", "1"])
    folder = raw_ds.pre(DS, "nnUNetPlans_3d_fullres")
    before = np.load(os.path.join(folder, "case_000_seg.npy"))
    Flip().run(995, "3d_fullres", num_processes=1)
    after = np.load(os.path.join(folder, "case_000_seg.npy"))
    assert set(np.unique(before)) >= {0, 1, 2}
    np.testing.assert_array_equal(after, np.where(before > 0, 2, before))


@pytest.mark.parametrize("is_seg,cur,new,shape", [
    (False, [2.5, 1.14, 1.14], [2.5, 1.14, 1.14], (9, 20, 20)),  # 3-D zoom
    (False, [2.5, 1.14, 1.14], [2.5, 0.8, 0.8], (9, 20, 20)),  # per plane
    (False, [4.0, 1.0, 1.0], [1.5, 1.0, 1.0], (24, 11, 13)),  # + z step
    (True, [4.0, 1.0, 1.0], [1.5, 0.8, 0.8], (24, 14, 16)),   # label-safe
])
def test_multichannel_resampling_bit_equal_jax(is_seg, cur, new, shape):
    """A prediction's classes resample in threads, one channel each: the
    result equals the JAX package's serial loop bit for bit, on the 3-D,
    the separate-z (with and without a z step) and the label-safe path."""
    from fast_nnunet_tpu.ops.resampling import \
        resample_data_or_seg_to_shape as jax_resample
    from fast_nnunet_tpu_torch.ops.resampling import \
        resample_data_or_seg_to_shape
    rng = np.random.RandomState(7)
    x = (rng.randint(0, 4, (7, 9, 10, 11)).astype(np.int16) if is_seg else
         rng.randn(7, 9, 10, 11).astype(np.float32))
    kw = dict(is_seg=is_seg, order=1, order_z=0, force_separate_z=None)
    got = resample_data_or_seg_to_shape(x, shape, cur, new, **kw)
    ref = jax_resample(x, shape, cur, new, **kw)
    assert got.dtype == ref.dtype and got.shape == (7, *shape)
    np.testing.assert_array_equal(got, ref)
