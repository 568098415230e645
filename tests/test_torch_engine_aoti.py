"""The port's native engine with its in-process AOTInductor backend
(fast_nnunet_tpu_torch/engine/, built by ``ops._build.engine_binary()``) on
the CPU, against the JAX package's Python engine: tests/test_engine_pjrt.py's
tiny PlainConvUNet (``KW``, patch 8^3, K = 3) with JAX-initialised weights,
written as a trained model folder, exported by the port's exporter with
``aoti=True`` (a float32 package of tile batch 2 on the CPU), then run by
the engine binary with ``--aoti ... --device cpu`` on the same 14 x 12 x 11
CT as test_engine_pjrt.py. The mask must agree > 0.995 with JAX's
``SlidingWindowEngine.predict_segmentation`` on the INI pipeline, JAX's own
pin for its PJRT backend. One AOTInductor compile and one engine build for
the file (module-scoped fixtures)."""
import os
import pickle
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.imageio.nifti import read_nifti, write_nifti
from fast_nnunet_tpu.inference.engine import SlidingWindowEngine as JaxEngine
from fast_nnunet_tpu.models.factory import get_network_from_plans
from fast_nnunet_tpu_torch.export import export_model as pexport
from fast_nnunet_tpu_torch.ops import _build
from fast_nnunet_tpu_torch.utils.io import join, load_json, save_json

from .torch_port_common import (GOLDEN,  # noqa: F401  (fixture)
                                no_persistent_compile_cache,
                                persistent_compile_cache_off)

KW = {"n_stages": 2, "features_per_stage": [4, 8],
      "kernel_sizes": [[3, 3, 3]] * 2, "strides": [[1, 1, 1], [2, 2, 2]],
      "n_conv_per_stage": [1, 1], "n_conv_per_stage_decoder": [1],
      "nonlin": "torch.nn.LeakyReLU"}
PATCH = (8, 8, 8)
K = 3
TILE_BATCH = 2
INI = ("[model]\nnum_class=3\n[input]\npatch_size=8x8x8\n"
       "target_spacing=(1.0,1.0,1.0)\n"
       "[preprocessing]\nmean=200\nstd=120\nlower_bound=0\nupper_bound=400\n"
       f"[inference]\nstep_size=0.5\nuse_gaussian=true\n"
       f"tile_batch={TILE_BATCH}\n")


def _jax_model():
    net = get_network_from_plans("PlainConvUNet", KW, (), 1, K,
                                 dtype=jnp.float32)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, *PATCH, 1)),
                      deep_supervision=False)
    return net, params


def _model_folder(root, params) -> str:
    """The golden model folder with test_engine_pjrt.py's architecture and
    the JAX weights as fold 0's checkpoint."""
    model = str(root / "model")
    shutil.copytree(os.path.join(GOLDEN, "model"), model)
    plans = load_json(join(model, "plans.json"))
    cfg = plans["configurations"]["3d_fullres"]
    cfg["patch_size"] = list(PATCH)
    cfg["architecture"]["arch_kwargs"].update(
        {k: v for k, v in KW.items() if k != "nonlin"})
    save_json(plans, join(model, "plans.json"), sort_keys=False)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    with open(join(model, "fold_0", "checkpoint_final.fnnx"), "wb") as f:
        pickle.dump({"network_weights": tree,
                     "init_args": {"configuration": "3d_fullres", "fold": 0},
                     "trainer_name": "NNUNetTrainer",
                     "inference_allowed_mirroring_axes": (0, 1, 2)}, f)
    return model


@pytest.fixture(scope="module")
def engine():
    return _build.engine_binary()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("aoti")
    with persistent_compile_cache_off():
        net, params = _jax_model()
    model = _model_folder(root, params)
    stats = {}
    pexport.export_model_folder_to_artifact(
        model, 0, str(root / "export"), batch_size=TILE_BATCH,
        dtype="float32", device="cpu", stats=stats, aoti=True)
    return {"root": root, "dir": str(root / "export"), "stats": stats,
            "net": net, "params": params}


def _run(engine, args, timeout=600):
    return subprocess.run([engine, *args], capture_output=True, text=True,
                          timeout=timeout)


def test_sidecar_names_the_native_artifact(exported):
    meta = load_json(join(exported["dir"], "model_config.json"))
    assert meta["aoti_artifact"] == pexport.AOTI_ARTIFACT == "model_aoti.pt2"
    assert meta["aoti_device"] == meta["device"] == "cpu"
    assert meta["input_shape"] == [TILE_BATCH, 1, *PATCH]
    assert os.path.isfile(join(exported["dir"], "model_aoti.pt2"))
    assert os.path.isfile(join(exported["dir"], "model.pt2"))
    st = exported["stats"]
    assert st["aoti_max_rel"] <= 1e-5 and st["max_rel"] <= 1e-5
    assert st["aoti_s"] > 0 and st["aoti_validate_s"] > 0


@pytest.fixture(scope="module")
def engine_mask(engine, exported):
    """The C++ engine's ``--aoti --device cpu`` mask of a 14x12x11 CT (the
    pjrt test's) and the CT."""
    img = (np.random.RandomState(1).rand(14, 12, 11) * 400).astype(np.float32)
    root = exported["root"]
    ct = str(root / "ct.nii.gz")
    write_nifti(ct, img, spacing=(1.0, 1.0, 1.0))
    ini = str(root / "model.ini")
    with open(ini, "w") as f:
        f.write(INI)
    out = str(root / "mask.nii.gz")
    r = _run(engine, ["--config", ini, "--input", ct, "--output", out,
                      "--aoti", join(exported["dir"], "model_aoti.pt2"),
                      "--device", "cpu", "--fp32-input"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "infer" in r.stdout
    mask, _ = read_nifti(out)
    assert mask.shape == img.shape
    return np.asarray(mask), img


def test_engine_aoti_matches_jax_engine(engine_mask, exported):
    """C++ AOTInductor sliding window (tile batch 2, the last batch padded
    by repeating a tile) against the JAX Python engine (tile batch 1), the
    same float32 network and weights, gaussian and tile grid."""
    mask, img = engine_mask
    pre = (np.clip(img, 0, 400) - 200.0) / 120.0
    eng = JaxEngine(exported["net"], PATCH, K, tile_step_size=0.5,
                    use_gaussian=True, mirror_axes=(),
                    compute_dtype=jnp.float32, acc_dtype=jnp.float32,
                    shape_bucket=1, tile_batch=1)
    want = np.asarray(eng.predict_segmentation(exported["params"], pre[None]))
    agreement = float((mask == want).mean())
    assert agreement > 0.995, f"only {agreement:.4f} voxel agreement"
    assert len(np.unique(mask)) >= 2


def test_engine_aoti_matches_port_engine_on_model_pt2(engine_mask,
                                                     exported):
    """The same C++ run against the port's Python engine on ``model.pt2``
    (the exported network run eagerly, tile batch 2 padded): the package
    computes each norm through ``fnn_torch::instance_norm``, which the
    engine registers in C++ with the eager ATen calls, so its logits follow
    the eager network's."""
    from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
    mask, img = engine_mask
    ep = torch.export.load(join(exported["dir"], "model.pt2"))
    assert "fnn_torch.instance_norm" in ep.graph_module.code
    eng = SlidingWindowEngine(ep.module(), PATCH, K, tile_step_size=0.5,
                              use_gaussian=True, compute_dtype=torch.float32,
                              acc_dtype=torch.float32, shape_bucket=1,
                              tile_batch=TILE_BATCH, pad_to_tile_batch=True,
                              device="cpu")
    pre = ((np.clip(img, 0, 400) - 200.0) / 120.0).astype(np.float32)
    want = eng.predict_segmentation([{}], pre[None])
    agreement = float((mask == want).mean())
    assert agreement > 0.995, f"only {agreement:.4f} voxel agreement"


def test_engine_refuses_a_package_on_another_device(engine, exported,
                                                    tmp_path):
    """A CPU package is not run on the card (nor a card's on the CPU): the
    engine exits 1 and says which device the package was compiled for."""
    img = np.zeros((10, 10, 10), np.float32)
    ct = str(tmp_path / "ct.nii.gz")
    write_nifti(ct, img, spacing=(1.0, 1.0, 1.0))
    ini = str(tmp_path / "model.ini")
    with open(ini, "w") as f:
        f.write(INI)
    r = _run(engine, ["--config", ini, "--input", ct, "--output",
                      str(tmp_path / "m.nii.gz"), "--aoti",
                      join(exported["dir"], "model_aoti.pt2"),
                      "--device", "cuda", "--fp32-input"], timeout=120)
    assert r.returncode == 1
    assert "compiled for 'cpu'" in r.stderr, r.stderr


def test_engine_missing_package_errors_cleanly(engine, tmp_path):
    img = np.zeros((10, 10, 10), np.float32)
    ct = str(tmp_path / "ct.nii.gz")
    write_nifti(ct, img, spacing=(1.0, 1.0, 1.0))
    ini = str(tmp_path / "model.ini")
    with open(ini, "w") as f:
        f.write(INI)
    r = _run(engine, ["--config", ini, "--input", ct, "--output",
                      str(tmp_path / "m.nii.gz"), "--aoti",
                      "/nonexistent/model_aoti.pt2", "--device", "cpu"],
             timeout=120)
    assert r.returncode == 1
    assert "loading /nonexistent/model_aoti.pt2" in r.stderr, r.stderr


def test_engine_binary_is_cached_and_prints_usage(engine):
    assert _build.engine_binary() == engine
    assert os.path.basename(os.path.dirname(engine)).startswith("engine-")
    r = _run(engine, ["--help"], timeout=60)
    assert r.returncode == 0 and "--aoti model_aoti.pt2" in r.stderr
