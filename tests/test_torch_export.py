"""The port's exporter (fast_nnunet_tpu_torch/export/export_model.py,
``torch.export`` -> model.pt2 + model_config.json) against the JAX package's
StableHLO exporter on the committed golden checkpoint: the sidecar's keys
and values (only the listed differences), the artifact's logits against the
native forward and the JAX artifact's (f32 within 1e-5 relative; the bf16
``--tta`` artifact within JAX's 1e-2 of the JAX f32 flips-average), a
tampered artifact raising, the device an artifact is bound to, the golden
mask bit for bit through the artifact route, the export CLIs, and a
BatchNorm checkpoint exported as the port's predictor builds it."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.export import export_model as jexport
from fast_nnunet_tpu_torch.export import export_model as pexport
from fast_nnunet_tpu_torch.fast_inference.inferencer import \
    FastnnUNetInferencer
from fast_nnunet_tpu_torch.imageio.nifti import NiftiIO
from fast_nnunet_tpu_torch.utils.io import join, load_json, save_json

from .torch_port_common import (GOLDEN,  # noqa: F401  (fixture)
                                no_persistent_compile_cache)

MODEL = os.path.join(GOLDEN, "model")
INPUT = os.path.join(GOLDEN, "input_0000.nii.gz")
EXPECTED = os.path.join(GOLDEN, "expected_mask.nii.gz")
B = 8
PATCH = (16, 16, 16)
# the sidecar keys whose values differ by design; every other key and value
# is the JAX sidecar's
DIFFERENT = {"framework", "artifact", "input_layout", "input_shape",
             "device"}


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Port f32 (validated), port bf16 --tta and JAX f32
    exports of fold 0 of the golden model folder, all on the CPU."""
    root = tmp_path_factory.mktemp("export")
    out = {"root": root, "stats": {}}
    for name, kw in (("p32", dict(dtype="float32")),
                     ("ptta", dict(dtype="bfloat16", bake_mirroring=True,
                                   validate=False))):
        st = out["stats"][name] = {}
        out[name] = pexport.export_model_folder_to_artifact(
            MODEL, 0, str(root / name), device="cpu", stats=st, **kw)
    out["j32"] = jexport.export_model_folder_to_artifact(
        MODEL, 0, str(root / "j32"), dtype="float32", validate=False)
    return out


def _x(seed=0):
    return np.random.RandomState(seed).randn(B, *PATCH, 1).astype(np.float32)


def _port_artifact(path):
    return torch.export.load(path).module()


def _jax_artifact(path):
    import jax.export as je
    with open(path, "rb") as f:
        return je.deserialize(f.read())


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_sidecar_matches_jax_exporter(exports):
    p = load_json(join(os.path.dirname(exports["p32"]), "model_config.json"))
    j = load_json(join(os.path.dirname(exports["j32"]), "model_config.json"))
    assert set(p) == (set(j) - {"pjrt_artifact"}) | {"device"}
    for k in set(p) - DIFFERENT:
        assert p[k] == j[k], k
    assert p["framework"] == "fast-nnunet-tpu-torch"
    assert p["artifact"] == "model.pt2" and os.path.isfile(exports["p32"])
    assert p["input_layout"] == "B * C * spatial (channels-first)"
    assert p["input_shape"] == [B, 1, *PATCH]
    assert j["input_shape"] == [B, *PATCH, 1]
    assert p["device"] == "cpu"
    assert list(p)[:6] == ["framework", "artifact", "input_layout",
                           "input_shape", "compute_dtype", "device"]


def test_f32_artifact_matches_native_and_jax_artifact(exports):
    x = _x()
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    with torch.no_grad():
        got = _port_artifact(exports["p32"])(xt).numpy()
    want = np.moveaxis(np.asarray(_jax_artifact(exports["j32"]).call(
        jnp.asarray(x))), -1, 1)
    assert got.shape == (B, 3, *PATCH)
    assert _rel(got, want) <= 1e-5
    assert exports["stats"]["p32"]["max_rel"] <= 1e-5


def test_bf16_tta_artifact_serves_without_engine_mirroring(exports):
    """The bf16 --tta artifact: its sidecar says the flips are baked in,
    the serving engine mirrors nothing more, and its logits are within
    JAX's 1e-2 of the f32 flips-average over the training mirror axes
    (0, 1, 2) of the f32 artifact (itself within 1e-5 of JAX's)."""
    side = join(os.path.dirname(exports["ptta"]), "model_config.json")
    meta = load_json(side)
    assert meta["mirroring_baked_into_artifact"] is True
    assert meta["use_mirroring"] is True
    assert meta["compute_dtype"] == "bfloat16"
    inf = FastnnUNetInferencer(config_file=side, device="cpu")
    assert inf.engine.mirror_axes == ()  # no double TTA
    assert inf.engine.compute_dtype == torch.bfloat16
    assert inf.engine.tile_batch == B and inf.engine.pad_to_tile_batch

    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(_x(1), -1, 1)))
    f32 = _port_artifact(exports["p32"])
    combos = [(), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2)]
    with torch.no_grad():
        want = sum(torch.flip(f32(torch.flip(xt, [a + 2 for a in c])),
                              [a + 2 for a in c]) for c in combos) / 8
        got = inf.engine.network(xt).float()
    assert _rel(got.numpy(), want.numpy()) <= 1e-2
    assert exports["stats"]["ptta"]["export_s"] > 0


def test_tampered_artifact_raises(exports, tmp_path):
    """An artifact whose first convolution's weights were changed in the
    archive fails validation against the native forward; the untouched one
    passes exactly."""
    import zipfile
    path = str(tmp_path / "model.pt2")
    rng = np.random.RandomState(0)
    with zipfile.ZipFile(exports["p32"]) as zin, \
            zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename.endswith("/weights/weight_0"):
                w = np.frombuffer(data, np.float32)
                data = (w + rng.randn(w.size)).astype(np.float32).tobytes()
            zout.writestr(item, data)
    net = _port_artifact(exports["p32"])
    with pytest.raises(RuntimeError, match="deviates"):
        pexport.validate_exported_artifact(path, net, (B, 1, *PATCH),
                                           torch.float32, "cpu")
    assert pexport.validate_exported_artifact(
        exports["p32"], net, (B, 1, *PATCH), torch.float32, "cpu") == 0.0


def test_artifact_is_bound_to_its_device(exports, tmp_path):
    """A sidecar recording another device than the one asked for raises
    (the program's constants live there); so does a JAX sidecar."""
    d = tmp_path / "moved"
    shutil.copytree(os.path.dirname(exports["p32"]), d)
    meta = load_json(str(d / "model_config.json"))
    save_json(dict(meta, device="cuda"), str(d / "model_config.json"),
              sort_keys=False)
    with pytest.raises(ValueError, match="exported on 'cuda'"):
        FastnnUNetInferencer(config_file=str(d / "model_config.json"),
                             device="cpu")
    with pytest.raises(ValueError, match="fast_nnunet_export_model_torch"):
        FastnnUNetInferencer(config_file=join(
            os.path.dirname(exports["j32"]), "model_config.json"),
            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the default is the card
            FastnnUNetInferencer(config_file=join(
                os.path.dirname(exports["p32"]), "model_config.json"))


def test_artifact_route_reproduces_golden_mask(exports, tmp_path):
    """tests/test_golden_checkpoint.py's artifact-path pin, in the port:
    f32 export, B = 8, the frozen mask bit for bit."""
    inf = FastnnUNetInferencer(config_file=join(
        os.path.dirname(exports["p32"]), "model_config.json"), device="cpu")
    assert inf.get_model_info()["source"] == "artifact"
    out = str(tmp_path / "seg.nii.gz")
    inf.predict_single_image(INPUT, out)
    expected = NiftiIO().read_seg(EXPECTED)[0][0]
    np.testing.assert_array_equal(NiftiIO().read_seg(out)[0][0], expected)


def test_artifact_route_flipped_affine(exports, tmp_path):
    """tests/test_fast_inference.py's orientation pin, in the port: the same
    anatomy stored with a flipped affine segments identically in canonical
    orientation, and its mask is written in the input's disk layout."""
    from fast_nnunet_tpu_torch.imageio.nifti import (NiftiIOWithReorient,
                                                     read_nifti, write_nifti)
    inf = FastnnUNetInferencer(config_file=join(
        os.path.dirname(exports["p32"]), "model_config.json"), device="cpu")
    img, hdr = read_nifti(INPUT)
    hdr = dict(hdr)
    hdr["srow_x"] = [-float(hdr["srow_x"][0]), 0.0, 0.0,
                     float(hdr["srow_x"][0]) * (img.shape[0] - 1)]
    flipped = str(tmp_path / "flip_0000.nii.gz")
    write_nifti(flipped, np.ascontiguousarray(img[::-1]), header=hdr)
    out, out_flip = str(tmp_path / "seg.nii.gz"), str(tmp_path / "f.nii.gz")
    inf.predict_single_image(INPUT, out)
    inf.predict_single_image(flipped, out_flip)
    rw = NiftiIOWithReorient()
    np.testing.assert_array_equal(rw.read_seg(out)[0], rw.read_seg(out_flip)[0])
    np.testing.assert_array_equal(read_nifti(out_flip)[0],
                                  read_nifti(out)[0][::-1])


def test_export_clis(tmp_path, monkeypatch):
    """The three console names run one exporter; the CLI resolves the
    model folder under nnUNet_results and takes --device."""
    assert pexport.distillation_export_entry is pexport.export_entry
    assert pexport.resenc_distillation_export_entry is pexport.export_entry
    results = tmp_path / "results" / "Dataset988_GOLD"
    results.mkdir(parents=True)
    shutil.copytree(MODEL, results / "NNUNetTrainer__nnUNetPlans__3d_fullres")
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "results"))
    out = tmp_path / "cli_out"
    pexport.export_entry(["-d", "988", "-tr", "NNUNetTrainer", "-b", "2",
                          "-o", str(out), "--no_validate", "--device",
                          "cpu"])
    meta = load_json(str(out / "model_config.json"))
    if not torch.cuda.is_available():  # without --device: the card
        with pytest.raises(RuntimeError, match="cuda"):
            pexport.export_entry(["-d", "988", "-tr", "NNUNetTrainer", "-o",
                                  str(tmp_path / "x")])
    assert meta["input_shape"] == [2, 1, *PATCH]
    assert meta["compute_dtype"] == "bfloat16" and meta["fold"] == 0
    assert (out / "model.pt2").is_file()


def test_batchnorm_checkpoint_exports_the_predictors_network(tmp_path):
    """A NNUNetTrainerBN checkpoint exports the BatchNorm network with its
    running averages (what the port's predictor builds), against the JAX
    network's evaluation forward. The JAX exporter rebuilds such a
    checkpoint with InstanceNorm (ROADMAP §3), so it is not the reference
    here."""
    from fast_nnunet_tpu.models.factory import get_network_from_plans
    from fast_nnunet_tpu_torch.training.checkpoint import save_checkpoint
    bn = dict(load_json(join(MODEL, "plans.json"))["configurations"][
        "3d_fullres"]["architecture"]["arch_kwargs"],
        norm_op="torch.nn.modules.batchnorm.BatchNorm3d")
    jnet = get_network_from_plans("PlainConvUNet", bn, (), 1, 3)
    v = jax.tree_util.tree_map(np.asarray, jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *PATCH, 1))))
    rng = np.random.RandomState(0)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape) * (a + 0.5)).astype(np.float32),
        v["batch_stats"])
    folder = tmp_path / "bn"
    (folder / "fold_0").mkdir(parents=True)
    for f in ("plans.json", "dataset.json"):
        shutil.copy(join(MODEL, f), folder / f)
    save_checkpoint(str(folder / "fold_0" / "checkpoint_final.fnnx"),
                    network_weights=v, trainer_name="nnUNetTrainerBN",
                    init_args={"configuration": "3d_fullres"})
    path = pexport.export_model_folder_to_artifact(
        str(folder), 0, str(tmp_path / "out"), batch_size=2,
        dtype="float32", device="cpu")
    x = np.random.RandomState(2).randn(2, *PATCH, 1).astype(np.float32)
    want = np.moveaxis(np.asarray(jnet.apply(v, jnp.asarray(x),
                                             deep_supervision=False)), -1, 1)
    with torch.no_grad():
        got = _port_artifact(path)(torch.from_numpy(
            np.ascontiguousarray(np.moveaxis(x, -1, 1)))).numpy()
    assert _rel(got, want) <= 1e-5
