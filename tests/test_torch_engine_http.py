"""The native C++ engine (engine/, built here with cmake as
tests/test_engine_native.py builds it) against the port's REST server: its
HTTP backend posts ``/predict_array`` to ``FastnnUNetAPI`` over the port's
engine on the CPU, and the mask it writes equals the one the same binary
gets from the JAX package's server with the same f32 weights. The wire
format is the JAX server's, byte for byte."""
import os
import socket
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu_torch.imageio.nifti import read_nifti, write_nifti

from .torch_port_common import (no_persistent_compile_cache,  # noqa: F401
                                plain_params)

ENGINE_DIR = os.path.join(os.path.dirname(__file__), "..", "engine")
KW = {"n_stages": 2, "features_per_stage": [4, 8],
      "kernel_sizes": [[3, 3, 3]] * 2, "strides": [[1, 1, 1], [2, 2, 2]],
      "n_conv_per_stage": [1, 1], "n_conv_per_stage_decoder": [1],
      "nonlin": "torch.nn.LeakyReLU"}


@pytest.fixture(scope="module")
def engine_binary(tmp_path_factory):
    """fast_nnunet_engine built from engine/ into a build directory of this
    module's own (engine/build may be mid-build in another worker)."""
    build = str(tmp_path_factory.mktemp("engine_build"))
    for cmd in (["cmake", "-S", ENGINE_DIR, "-B", build, "-G", "Ninja"],
                ["cmake", "--build", build, "--target",
                 "fast_nnunet_engine"]):
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    return os.path.join(build, "fast_nnunet_engine")


def _inferencers():
    """(port, JAX) inferencers over the same seeded f32 PlainConvUNet."""
    from fast_nnunet_tpu.fast_inference.inferencer import \
        FastnnUNetInferencer as JaxInferencer
    from fast_nnunet_tpu.inference.engine import \
        SlidingWindowEngine as JaxEngine
    from fast_nnunet_tpu.models.factory import get_network_from_plans
    from fast_nnunet_tpu_torch.fast_inference.inferencer import \
        FastnnUNetInferencer
    from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
    from fast_nnunet_tpu_torch.models.factory import \
        get_network_from_plans as port_net
    jnet = get_network_from_plans("PlainConvUNet", KW, (), 1, 3,
                                  dtype=jnp.float32)
    params = plain_params(0, arch=KW, k=3)
    j = JaxInferencer()
    j.engine = JaxEngine(jnet, (8, 8, 8), 3, shape_bucket=4,
                         compute_dtype=jnp.float32, tile_batch=2)
    j._params = [params]
    p = FastnnUNetInferencer(device="cpu")
    p.engine = SlidingWindowEngine(
        port_net("PlainConvUNet", KW, (), 1, 3, compute_dtype=torch.float32),
        (8, 8, 8), 3, shape_bucket=4, compute_dtype=torch.float32,
        tile_batch=2, device="cpu")
    p._params = [params]
    return p, j


def _run_engine(binary, inferencer, api_cls, tmp_path, tag):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    api = api_cls(inferencer, "127.0.0.1", port)
    thread = api.run(blocking=False)
    try:
        out = str(tmp_path / f"mask_{tag}.nii.gz")
        r = subprocess.run(
            [binary, "--config", str(tmp_path / "model.ini"),
             "--input", str(tmp_path / "ct.nii.gz"), "--output", out,
             "--endpoint", f"127.0.0.1:{port}"],
            capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        return read_nifti(out)[0]
    finally:
        api.shutdown()
        thread.join(timeout=10)


def test_engine_mask_from_port_server_equals_jax_server(engine_binary,
                                                        tmp_path):
    from fast_nnunet_tpu.fast_inference.rest_api import FastnnUNetAPI as JAPI
    from fast_nnunet_tpu_torch.fast_inference.rest_api import FastnnUNetAPI
    img = (np.random.RandomState(1).rand(14, 12, 10) * 400).astype(
        np.float32)
    write_nifti(str(tmp_path / "ct.nii.gz"), img, spacing=(1.0, 1.0, 1.5))
    with open(tmp_path / "model.ini", "w") as f:
        f.write("[model]\nnum_class=3\n[input]\npatch_size=8x8x8\n"
                "target_spacing=(1.0,1.0,1.0)\n"
                "[preprocessing]\nmean=200\nstd=120\nlower_bound=0\n"
                "upper_bound=400\n")
    port_inf, jax_inf = _inferencers()
    got = _run_engine(engine_binary, port_inf, FastnnUNetAPI, tmp_path,
                      "port")
    want = _run_engine(engine_binary, jax_inf, JAPI, tmp_path, "jax")
    assert got.shape == img.shape
    assert set(np.unique(got)) <= {0, 1, 2} and len(np.unique(got)) > 1
    np.testing.assert_array_equal(got, want)
