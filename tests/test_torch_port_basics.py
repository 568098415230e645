"""The PyTorch port's boundaries: it imports nothing of JAX or of the JAX
package, it asks for the card explicitly, its checkpoint reader admits only
numpy, and its copied numpy helpers equal the originals."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from . import torch_port_common  # noqa: F401  (caps torch threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import fast_nnunet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
banned = {"jax", "jaxlib", "flax", "optax", "ml_dtypes", "fast_nnunet_tpu",
          "zstandard", "msgpack", "blosc2", "PIL"}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in banned)
print(len(names), bad)
assert not bad, bad
for n in ("export.export_model", "fast_inference.inferencer",
          "fast_inference.rest_api", "fast_inference.main",
          "fast_inference.config_manager", "fast_inference.vtk_export",
          "inference.jhu_predictor", "inference.data_iterators",
          "inference.examples", "utils.fastgz", "utils.hostops",
          "training.zstd_store", "utils.zstd", "utils.b2nd",
          "utils.torch_import", "run.convert_b2nd", "imageio.nrrd",
          "imageio.mha", "imageio.tiff", "imageio.natural_image",
          "imageio.dicom", "dataset_conversion.convert_msd",
          "dataset_conversion.converters"):
    assert pkg.__name__ + "." + n in names, n
"""


def test_port_imports_no_jax():
    """Every module of the port loads without pulling in jax, flax, optax,
    ml_dtypes or fast_nnunet_tpu (compared by top-level name exactly:
    fast_nnunet_tpu is a prefix of the port's own name); the training,
    planning, preprocessing, postprocessing, ensembling and evaluation
    modules count too, and the export, fast-inference, JHU, data-iterator,
    examples and libdeflate modules, the host library's binding, and the
    case stores, readers, weight import and dataset converters; zstandard,
    msgpack, blosc2 and PIL stay unimported until a function needs them."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 100, res.stdout


def test_resolve_device_never_falls_back():
    from fast_nnunet_tpu_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            resolve_device(None)  # the default is the card


def test_checkpoint_reader_admits_only_numpy(tmp_path):
    from fast_nnunet_tpu_torch.training.checkpoint import load_checkpoint
    golden = os.path.join(REPO, "tests", "fixtures", "golden_ckpt", "model",
                          "fold_0", "checkpoint_final.fnnx")
    got = load_checkpoint(golden)
    with open(golden, "rb") as f:
        ref = pickle.load(f)
    k = ref["network_weights"]["params"]["encoder"]["stage_0"]["block_0"]
    g = got["network_weights"]["params"]["encoder"]["stage_0"]["block_0"]
    np.testing.assert_array_equal(g["conv"]["kernel"], k["conv"]["kernel"])
    assert got["init_args"] == ref["init_args"]

    import ml_dtypes  # the test may import it; the reader must refuse it
    bad = tmp_path / "bf16.fnnx"
    with open(bad, "wb") as f:
        pickle.dump({"network_weights": np.zeros(3, ml_dtypes.bfloat16)}, f)
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint(str(bad))


def test_copied_helpers_match_jax_package():
    from fast_nnunet_tpu.inference import turbo as jt
    from fast_nnunet_tpu_torch.inference import turbo as pt
    for spec in ({"scheme": "ct", "mean": 418.68, "std": 412.19,
                  "lower_bound": -60.0, "upper_bound": 3068.0},
                 {"scheme": "ct", "mean": 40.0, "std": 100.0,
                  "lower_bound": -60.0, "upper_bound": 400.0},
                 {"scheme": "ct", "mean": 0.9115816, "std": 0.1145903,
                  "lower_bound": 0.7031291, "upper_bound": 1.0985994}):
        assert pt._fill_bf16_bits(spec) == jt._fill_bf16_bits(spec)
        assert pt._fill_f64(spec) == jt._fill_f64(spec)
    seg = np.random.RandomState(0).randint(0, 61, (7, 9, 5)).astype(np.uint8)
    np.testing.assert_array_equal(pt._nearest_revert_host(seg, (13, 30, 2)),
                                  jt._nearest_revert_host(seg, (13, 30, 2)))
    from fast_nnunet_tpu.models.students import build_student_arch_kwargs as j
    from fast_nnunet_tpu_torch.models.students import \
        build_student_arch_kwargs as p
    kw = {"features_per_stage": [32, 64, 128, 256, 320, 320],
          "n_blocks_per_stage": [1, 3, 4, 6, 6, 6]}
    assert p(kw, 2, "adaptive") == j(kw, 2, "adaptive")


def test_nifti_round_trip(tmp_path):
    from fast_nnunet_tpu.imageio.nifti import NiftiIOWithReorient as JaxIO
    from fast_nnunet_tpu_torch.imageio.nifti import (NiftiIOWithReorient,
                                                     write_nifti)
    vol = np.random.RandomState(1).randint(-1000, 2000, (9, 7, 5)).astype(
        np.int16)
    f = str(tmp_path / "ct.nii.gz")
    write_nifti(f, vol, spacing=(0.8, 0.9, 1.5))
    data, props = NiftiIOWithReorient().read_images([f], dtype=None)
    ref, ref_props = JaxIO().read_images([f], dtype=None)
    np.testing.assert_array_equal(data, ref)
    assert props["spacing"] == ref_props["spacing"]
    seg = (data[0] > 0).astype(np.uint8)
    out = str(tmp_path / "seg.nii.gz")
    NiftiIOWithReorient().write_seg(seg, out, props)
    back, _ = JaxIO().read_seg(out)
    np.testing.assert_array_equal(back[0], seg)
