"""nnU-Net's cascade in the port against the JAX package, on the CPU:
- the host pieces, bit for bit from the same inputs and seeds:
  ``convert_labelmap_to_one_hot``, ``resample_and_save``,
  ``cascade_augment_prev_stage`` and the cascade paths of the default,
  validation and DA5 augmenters; the sampler's ``_load_prev_stage`` (the
  missing-deposit error, the shape check) and whole batches drawn with a
  previous stage;
- the predictor's previous-stage input (the JAX test
  ``test_prev_stage_seg_rides_seg_path``'s case): one-hot channels binary,
  non-empty and equal to JAX's preprocessed array;
- end to end at a tiny size (tests/test_cascade_e2e.py, which the JAX
  package marks slow, in tier-1 size): plan with the port, add
  ``3d_lowres`` / ``3d_cascade_fullres`` as the reference's
  add_lowres_and_cascade does, train ``3d_lowres`` on folds 0 and ``all``
  (5 ``predicted_next_stage`` deposits on the next stage's grid) and
  ``3d_cascade_fullres`` on fold 0 (1 + K - 1 input channels); the cascade
  predictor's mask equals the JAX predictor's on the same checkpoints
  with float32 networks on both sides, and their logits agree within
  atol 3e-4; and
  the command chain that find-best writes for the cascade runs as written
  through ``fast_nnunet_predict_torch``."""
import os
import shlex

import numpy as np
import pytest
import torch

from fast_nnunet_tpu.core import labels as jlabels
from fast_nnunet_tpu.training import augment as jaug
from fast_nnunet_tpu.training import augment_da5 as jda5
from fast_nnunet_tpu_torch.core import labels as plabels
from fast_nnunet_tpu_torch.training import augment as paug
from fast_nnunet_tpu_torch.training import augment_da5 as pda5

from .helpers import make_synthetic_dataset
from .torch_port_common import jax_predictor_f32
from .torch_port_common import no_persistent_compile_cache  # noqa: F401

LABELS = [1, 2, 3]
PATCH = (12, 16, 16)
DS_SCALES = [(1.0, 1.0, 1.0), (0.5, 0.5, 0.5)]


def _case(seed, shape, n_channels=1):
    """(data, seg) with seg channel 1 the previous stage's labels: blobs of
    several components per label, and -1 outside the nonzero region."""
    rng = np.random.RandomState(200 + seed)
    data = rng.randn(n_channels, *shape).astype(np.float32)
    seg = np.zeros((2, *shape), np.int16)
    for ch in (0, 1):
        for lbl in LABELS:
            for _ in range(3):
                lo = [rng.randint(0, s - 4) for s in shape]
                seg[(ch,) + tuple(slice(v, v + rng.randint(2, 5))
                                  for v in lo)] = lbl
    seg[:, :1] = -1
    return data, seg


def test_one_hot_and_input_channels_match_jax():
    seg = np.random.RandomState(0).randint(0, 5, (7, 9, 6)).astype(np.int16)
    for dt in (np.uint8, np.float32):
        got = plabels.convert_labelmap_to_one_hot(seg, LABELS, dt)
        ref = jlabels.convert_labelmap_to_one_hot(seg, LABELS, dt)
        assert got.dtype == ref.dtype and got.shape == (3, 7, 9, 6)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cascade_augment_prev_stage_bit_equal(seed):
    """Component removal and dilation / erosion from one seed, with the
    probabilities raised so that every branch runs."""
    _, seg = _case(seed, (14, 16, 12))
    onehot = np.stack([(seg[1] == lbl).astype(np.float32) for lbl in LABELS])
    for p in ((0.4, 0.2), (1.0, 1.0)):
        got = paug.cascade_augment_prev_stage(
            onehot.copy(), np.random.RandomState(seed), *p)
        ref = jaug.cascade_augment_prev_stage(
            onehot.copy(), np.random.RandomState(seed), *p)
        np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, onehot)


def _augmenters(kind):
    envelope = jaug.configure_rotation_dummyDA_mirroring_and_initial_patch_size
    rotation, dummy, initial, mirror = envelope(PATCH)
    kw = dict(regions=None, ignore_label=None, ds_scales=DS_SCALES,
              cascade_labels=LABELS)
    if kind == "validation":
        return (jaug.ValidationAugmenter(PATCH, **kw),
                paug.ValidationAugmenter(PATCH, **kw), PATCH)
    mod_j, mod_p = (jaug, paug) if kind == "default" else (jda5, pda5)
    cls = "TrainingAugmenter" if kind == "default" else \
        "DA5TrainingAugmenter"
    if kind == "da5":
        envelope = jda5.\
            configure_da5_rotation_dummyDA_mirroring_and_initial_patch_size
        rotation, dummy, initial, mirror = envelope(PATCH)
    kw.update(use_mask_for_norm=[False], dummy_2d=dummy)
    return (getattr(mod_j, cls)(PATCH, rotation, mirror, **kw),
            getattr(mod_p, cls)(PATCH, rotation, mirror, **kw),
            tuple(int(s) for s in initial))


@pytest.mark.parametrize("kind", ["default", "da5", "validation"])
def test_cascade_augmenters_bit_equal(kind):
    """Four draws from one seed: the data gain one one-hot channel per
    label (corrupted in training), the targets lose seg channel 1."""
    aug_j, aug_p, shape = _augmenters(kind)
    rng_j, rng_p = np.random.RandomState(7), np.random.RandomState(7)
    for draw in range(4):
        data, seg = _case(draw, shape)
        dj, tj = aug_j(data.copy(), seg.copy(), rng_j)
        dp, tp = aug_p(data.copy(), seg.copy(), rng_p)
        assert dp.shape == (1 + len(LABELS), *PATCH)
        np.testing.assert_array_equal(dp, dj, err_msg=f"draw {draw}")
        assert len(tp) == len(tj) == len(DS_SCALES)
        for a, b in zip(tp, tj):
            assert a.shape[0] == 1
            np.testing.assert_array_equal(a, b)
        assert set(np.unique(dp[1:]).tolist()) <= {0.0, 1.0}


def _store(tmp_path, n=3, shape=(10, 12, 9)):
    """A .npy case store (both packages read it) and a folder of
    previous-stage deposits for all but the last case."""
    from fast_nnunet_tpu_torch.training.dataset import NpyCaseDataset
    store, prev = tmp_path / "store", tmp_path / "prev"
    store.mkdir()
    prev.mkdir()
    rng = np.random.RandomState(3)
    for i in range(n):
        data, seg = _case(i, shape)
        NpyCaseDataset.save_case(data, seg[:1], {
            "class_locations": {lbl: np.argwhere(seg[0] == lbl)[:5]
                                for lbl in LABELS}}, str(store / f"c{i}"))
        if i < n - 1:
            np.savez_compressed(str(prev / f"c{i}.npz"), seg=rng.randint(
                0, 4, shape).astype(np.uint8))
    return str(store), str(prev)


def test_load_prev_stage_errors_and_batches_match_jax(tmp_path):
    from fast_nnunet_tpu.training.dataloader import PatchSampler as JS
    from fast_nnunet_tpu.training.dataset import NpyCaseDataset as JD
    from fast_nnunet_tpu_torch.training.dataloader import PatchSampler as PS
    from fast_nnunet_tpu_torch.training.dataset import NpyCaseDataset as PD
    store, prev = _store(tmp_path)
    keys = ["c0", "c1"]
    kw = dict(oversample_foreground_percent=0.5, prev_stage_folder=prev)
    aug = (jaug.ValidationAugmenter((8, 8, 8), cascade_labels=LABELS),
           paug.ValidationAugmenter((8, 8, 8), cascade_labels=LABELS))
    sj = JS(JD(store, keys), 2, (8, 8, 8), (8, 8, 8), transform=aug[0], **kw)
    sp = PS(PD(store, keys), 2, (8, 8, 8), (8, 8, 8), transform=aug[1], **kw)
    for seed in range(3):
        bj = sj.generate_batch(np.random.RandomState(seed))
        bp = sp.generate_batch(np.random.RandomState(seed))
        assert bp["keys"] == bj["keys"]
        assert bp["data"].shape == (2, 1 + len(LABELS), 8, 8, 8)
        np.testing.assert_array_equal(bp["data"], bj["data"])
        for a, b in zip(bp["target"], bj["target"]):
            np.testing.assert_array_equal(a, b)
    miss = PS(PD(store, ["c2"]), 1, (8, 8, 8), (8, 8, 8), **kw)
    with pytest.raises(FileNotFoundError, match="predict_next_stage"):
        miss.generate_batch(np.random.RandomState(0))
    np.savez_compressed(os.path.join(prev, "c2.npz"),
                        seg=np.zeros((3, 3, 3), np.uint8))
    with pytest.raises(AssertionError, match="prev-stage seg shape"):
        miss.generate_batch(np.random.RandomState(0))


def _plans_manager(spacing=(1.0, 1.0, 1.0)):
    from fast_nnunet_tpu_torch.core.plans import PlansManager
    from tests.test_plans import make_plans
    plans = make_plans()
    plans["configurations"]["3d_fullres"]["spacing"] = list(spacing)
    return plans, PlansManager(plans)


def test_resample_and_save_matches_jax(tmp_path):
    """Logits on a lowres grid resampled to the next stage's grid and saved
    as the uint8 segmentation: the same file content."""
    from fast_nnunet_tpu.core.plans import PlansManager as JPM
    from fast_nnunet_tpu.inference.export import resample_and_save as jrs
    from fast_nnunet_tpu_torch.inference.export import resample_and_save
    plans, pm = _plans_manager((2.0, 1.5, 1.5))
    dj = {"labels": {"background": 0, "a": 1, "b": 2},
          "file_ending": ".nii.gz"}
    logits = np.random.RandomState(1).randn(3, 9, 10, 8).astype(np.float32)
    props = {"spacing": [1.0, 1.0, 1.0]}
    target = (17, 15, 13)
    resample_and_save(logits, target, str(tmp_path / "p.npz"), pm,
                      pm.get_configuration("3d_fullres"), props, dj)
    jpm = JPM(plans)
    jrs(logits, target, str(tmp_path / "j.npz"), jpm,
        jpm.get_configuration("3d_fullres"), props, dj)
    got, ref = (np.load(str(tmp_path / f"{w}.npz"))["seg"] for w in "pj")
    assert got.dtype == np.uint8 and got.shape == target
    np.testing.assert_array_equal(got, ref)
    assert set(np.unique(got).tolist()) == {0, 1, 2}


def test_prev_stage_seg_rides_seg_path():
    """The previous stage's labelmap shares the image's crop, skips the
    intensity normalisation and is resampled label-safely: its one-hot
    channels are binary, non-empty and equal to the JAX package's."""
    from fast_nnunet_tpu.core.plans import PlansManager as JPM
    from fast_nnunet_tpu.inference.data_iterators import \
        preprocessing_iterator_fromnpy
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor
    from fast_nnunet_tpu_torch.models.factory import \
        build_network_from_arch_dict
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    plans, pm = _plans_manager()
    cm = pm.get_configuration("3d_fullres")
    dj = {"labels": {"background": 0, "a": 1, "b": 2},
          "file_ending": ".nii.gz"}
    rng = np.random.RandomState(0)
    img = rng.rand(1, 20, 22, 18).astype(np.float32) * 800 - 100
    prev = np.zeros((20, 22, 18), np.uint8)
    prev[5:10, 6:11, 4:9] = 1
    prev[12:15, 12:15, 10:13] = 2
    props = {"spacing": [1.0, 1.0, 1.0]}

    p = NNUNetPredictor(device="cpu")
    net = build_network_from_arch_dict(cm.configuration["architecture"], 3,
                                       3, torch.float32)
    p.manual_initialization(net, pm, cm, [], dj, "NNUNetTrainer", ())
    data, seg, _ = DefaultPreprocessor().run_case_npy(
        img, prev[None].astype(np.int16), dict(props), pm, cm, dj)
    data = p._stack_prev_stage_onehot(data, seg)
    assert data.shape[0] == 3
    for ch in (1, 2):
        assert set(np.unique(data[ch]).tolist()) <= {0.0, 1.0}
        assert data[ch].sum() > 0
    ref = list(preprocessing_iterator_fromnpy(
        [img], [prev], [props], None, JPM(plans), dj,
        JPM(plans).get_configuration("3d_fullres"), num_processes=1))
    np.testing.assert_array_equal(data, ref[0]["data"])


# ------------------------------------------------------------ end to end
DS = "Dataset991_CSC"


@pytest.fixture(scope="module")
def cascade(tmp_path_factory):
    """Plan with the port, add the cascade configurations, train 3d_lowres
    (folds 0 and all) and 3d_cascade_fullres (fold 0), 2 iterations each,
    on the CPU in float32."""
    from fast_nnunet_tpu_torch.run.plan_and_preprocess import \
        plan_and_preprocess_entry
    from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer
    from fast_nnunet_tpu_torch.utils.io import join, load_json, save_json
    root = str(tmp_path_factory.mktemp("cascade"))
    env = {f"nnUNet_{k}": join(root, k)
           for k in ("raw", "preprocessed", "results")}
    env.update(nnUNet_n_proc_DA="2")
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    for k in ("raw", "preprocessed", "results"):
        os.makedirs(join(root, k))
    raw = make_synthetic_dataset(join(root, "raw"), DS, n_cases=5,
                                 shape=(18, 20, 16))
    plan_and_preprocess_entry(["-d", "991", "-c", "3d_fullres", "-npfp",
                               "1", "-np", "1"])
    pre = join(root, "preprocessed", DS)
    plans = load_json(join(pre, "nnUNetPlans.json"))
    cfgs = plans["configurations"]
    arch = cfgs["3d_fullres"]["architecture"]["arch_kwargs"]
    arch["features_per_stage"] = [min(4 * 2 ** i, 16)
                                  for i in range(arch["n_stages"])]
    cfgs["3d_lowres"] = {"inherits_from": "3d_fullres",
                         "next_stage": "3d_cascade_fullres"}
    cfgs["3d_cascade_fullres"] = {"inherits_from": "3d_fullres",
                                  "previous_stage": "3d_lowres"}
    save_json(plans, join(pre, "nnUNetPlans.json"), sort_keys=False)
    dj = load_json(join(raw, "dataset.json"))

    def train(cfg, fold):
        t = NNUNetTrainer(plans, cfg, fold, dj, device="cpu")
        t.num_epochs, t.num_iterations_per_epoch = 1, 2
        t.num_val_iterations_per_epoch = 1
        t.compute_dtype = torch.float32
        t.run_training()
        t.perform_actual_validation()
        return t

    trainers = {"lowres0": train("3d_lowres", 0),
                "lowres": train("3d_lowres", "all"),
                "cascade": train("3d_cascade_fullres", 0)}
    ts = join(raw, "imagesTs")
    os.makedirs(ts)
    import shutil
    for i in range(2):
        shutil.copy(join(raw, "imagesTr", f"case_{i:03d}_0000.nii.gz"),
                    join(ts, f"ts_{i:03d}_0000.nii.gz"))
    yield root, raw, plans, trainers
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_lowres_fold_all_deposits_and_cascade_channels(cascade):
    from fast_nnunet_tpu_torch.training.dataset import NpyCaseDataset
    from fast_nnunet_tpu_torch.utils.io import join, subfiles
    root, _, plans, trainers = cascade
    t1, t2 = trainers["lowres"], trainers["cascade"]
    folder = join(t1.output_folder_base, "predicted_next_stage",
                  "3d_cascade_fullres")
    deposits = subfiles(folder, suffix=".npz", join_path=False)
    assert len(deposits) == 5
    assert folder == t2.folder_with_segs_from_previous_stage
    store = join(root, "preprocessed", DS, "nnUNetPlans_3d_fullres")
    for d in deposits:
        seg = np.load(join(folder, d))["seg"]
        data, _, _ = NpyCaseDataset(store).load_case(d[:-4])
        assert seg.dtype == np.uint8 and seg.shape == data.shape[1:]
        assert set(np.unique(seg).tolist()) <= {0, 1, 2}
    assert t2.is_cascaded and not t1.is_cascaded
    k = t2.label_manager.num_segmentation_heads
    assert t2.num_input_channels == 1 + (k - 1) == 3
    first = t2.network.encoder.stages["stage_0"].blocks["block_0"].conv
    assert first.in_channels == 3
    assert np.isfinite(t2.logger.logging["train_losses"][0])
    assert os.path.isfile(join(t2.output_folder, "validation",
                               "summary.json"))


def test_cascade_predictor_matches_jax(cascade, tmp_path):
    """Lowres then cascade prediction of two test cases with the port;
    with float32 networks on both sides, the JAX predictor on the same
    checkpoints and the same previous-stage folder writes the same cascade
    masks, and the logits of the cascade input (image + one-hot previous
    stage) agree within atol 3e-4 (the predictor tests' tolerance)."""
    from fast_nnunet_tpu.imageio.nifti import NiftiIO as JIO
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor
    from fast_nnunet_tpu_torch.preprocessing.preprocessor import \
        DefaultPreprocessor
    from fast_nnunet_tpu_torch.utils.io import join
    _, raw, _, trainers = cascade
    ts = join(raw, "imagesTs")
    low, out, jout = (str(tmp_path / n) for n in ("low", "casc", "jcasc"))
    p1 = NNUNetPredictor(use_mirroring=False, device="cpu")
    p1.initialize_from_trained_model_folder(
        trainers["lowres"].output_folder_base, use_folds=("all",))
    p1.predict_from_files(ts, low)
    p2 = NNUNetPredictor(use_mirroring=False, device="cpu",
                         compute_dtype=torch.float32)
    p2.initialize_from_trained_model_folder(
        trainers["cascade"].output_folder_base, use_folds=(0,))
    assert p2.network.input_channels == 3
    p2.predict_from_files(ts, out, folder_with_segs_from_prev_stage=low)
    jp = jax_predictor_f32(trainers["cascade"].output_folder_base, (0,), 3, 3)
    jp.predict_from_files(ts, jout, folder_with_segs_from_prev_stage=low)
    for i in range(2):
        img_file = join(ts, f"ts_{i:03d}_0000.nii.gz")
        img, iprops = JIO().read_images([img_file])
        seg, sprops = JIO().read_seg(join(out, f"ts_{i:03d}.nii.gz"))
        ref, _ = JIO().read_seg(join(jout, f"ts_{i:03d}.nii.gz"))
        assert seg.shape == img.shape
        assert sprops["spacing"] == iprops["spacing"]
        assert set(np.unique(seg).tolist()) <= {0, 1, 2}
        np.testing.assert_array_equal(seg, ref)
        data, prev, _ = DefaultPreprocessor().run_case(
            [img_file], join(low, f"ts_{i:03d}.nii.gz"), p2.plans_manager,
            p2.configuration_manager, p2.dataset_json)
        x = p2._stack_prev_stage_onehot(data, prev)
        assert x.shape[0] == 3
        np.testing.assert_allclose(
            p2.predict_logits_from_preprocessed_data(x),
            np.asarray(jp.predict_logits_from_preprocessed_data(x)),
            atol=3e-4)


def test_find_best_cascade_command_chain_runs(cascade, tmp_path):
    """The chain find-best writes for 3d_cascade_fullres (lowres into
    OUTPUT_FOLDER_PREV_STAGE, then the cascade with
    -prev_stage_predictions), run line by line through the port's predict
    entry; its mask equals the predictor's from the same folders."""
    from fast_nnunet_tpu_torch.evaluation.find_best_configuration import \
        generate_inference_command
    from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor
    from fast_nnunet_tpu_torch.run.predict import predict_entry_point
    from fast_nnunet_tpu_torch.utils.io import join
    _, raw, _, trainers = cascade
    chain = generate_inference_command(DS, "3d_cascade_fullres", folds=(0,))
    lines = chain.splitlines()
    assert len(lines) == 2 and "-c 3d_lowres" in lines[0]
    subst = {"INPUT_FOLDER": join(raw, "imagesTs"),
             "OUTPUT_FOLDER_PREV_STAGE": str(tmp_path / "prev"),
             "OUTPUT_FOLDER": str(tmp_path / "final")}
    for line in lines:
        argv = shlex.split(line)
        assert argv[0] == "fast_nnunet_predict_torch"
        predict_entry_point([subst.get(a, a) for a in argv[1:]]
                            + ["--disable_tta", "-device", "cpu"])
    ref = str(tmp_path / "ref")
    p = NNUNetPredictor(use_mirroring=False, device="cpu")
    p.initialize_from_trained_model_folder(
        trainers["cascade"].output_folder_base, use_folds=(0,))
    p.predict_from_files(join(raw, "imagesTs"), ref,
                         folder_with_segs_from_prev_stage=str(tmp_path /
                                                              "prev"))
    for i in range(2):
        got = NiftiIO().read_seg(str(tmp_path / "final" /
                                     f"ts_{i:03d}.nii.gz"))[0]
        np.testing.assert_array_equal(
            got, NiftiIO().read_seg(join(ref, f"ts_{i:03d}.nii.gz"))[0])
