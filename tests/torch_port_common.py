"""Shared pieces of the PyTorch-port tests (tests/test_torch_*.py): the small
architecture, seeded weights in the JAX tree layout, the fixture that skips
card-only tests on a host without CUDA, and the fixture that keeps the
persistent XLA compile cache out of the port's tests.

Inputs and weights are made with numpy from a seed and handed to both the
JAX package (the reference) and the port."""
import os

import numpy as np
import pytest
import torch

K = 4
ARCH = {"n_stages": 3, "features_per_stage": [8, 16, 32],
        "kernel_sizes": [[3, 3, 3]] * 3,
        "strides": [[1, 1, 1]] + [[2, 2, 2]] * 2,
        "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [2, 2],
        "nonlin": "torch.nn.LeakyReLU"}
PATCH = (8, 8, 16)  # engine order

torch.set_num_threads(2)  # the suite runs several xdist workers


def plain_params(seed: int = 0, in_ch: int = 1, arch=None, k: int = K):
    """Seeded PlainConvUNet weights in the flax tree layout (numpy)."""
    from fast_nnunet_tpu_torch.models.s2d import random_plain_params
    return random_plain_params(arch or ARCH, in_ch, k, seed)


def s2d_pair(seed: int = 0, arch=None, k: int = K, dtype="float32"):
    """(jax S2DPlainConvUNet, port S2DPlainConvUNet with weights loaded,
    s2d tree) on the same seeded weights."""
    import jax.numpy as jnp
    from fast_nnunet_tpu.models.s2d import S2DPlainConvUNet as JaxS2D
    from fast_nnunet_tpu_torch.models.s2d import (make_s2d_engine_net,
                                                  params_from_jax)
    arch = arch or ARCH
    jnet = JaxS2D(arch["n_stages"], arch["features_per_stage"],
                  arch["n_conv_per_stage"], arch["n_conv_per_stage_decoder"],
                  k, arch["strides"], arch["kernel_sizes"],
                  dtype=getattr(jnp, dtype))
    tree = jnet.convert_params(plain_params(seed, arch=arch, k=k))
    tnet = make_s2d_engine_net(arch, k, 1,
                               compute_dtype=getattr(torch, dtype))
    params_from_jax(tnet, tree)
    return jnet, tnet, tree


@pytest.fixture(autouse=True)
def no_persistent_compile_cache():
    """Compile every JAX function of the test afresh, as tests/test_aot.py
    does for itself. With a warm persistent cache, executables loaded from
    it earlier in the same process break test_aot.py's serialize round trip
    ('Buffer Definition Event ... not found'). Autouse only in the files
    that import it; JAX is imported here, not at module level, so files
    that run on the card without JAX can import this module."""
    import jax
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden_ckpt")


@pytest.fixture
def cuda_device():
    """The card, or a skip on a host without CUDA (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the hand-written kernels "
                    "run only on the card)")
    return torch.device("cuda")


def ncdhw(x: np.ndarray) -> torch.Tensor:
    """(B, X, Y, Z, C) numpy (the JAX layout) -> (B, C, X, Y, Z) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def jax_predictor_f32(model_folder: str, folds, num_input_channels: int,
                      num_classes: int):
    """The JAX package's predictor on a trained model folder with float32
    networks and a float32 sliding window (its own build is bfloat16),
    mirroring off: the reference that the port's float32 predictor is held
    to at atol 3e-4 on the logits."""
    import jax.numpy as jnp
    from fast_nnunet_tpu.inference.predictor import NNUNetPredictor
    from fast_nnunet_tpu.models.factory import build_network_from_arch_dict
    jp = NNUNetPredictor(use_mirroring=False)
    jp.initialize_from_trained_model_folder(model_folder, use_folds=folds)
    arch = jp.configuration_manager.configuration["architecture"]
    jp.manual_initialization(
        build_network_from_arch_dict(arch, num_input_channels, num_classes,
                                     dtype=jnp.float32),
        jp.plans_manager, jp.configuration_manager, jp.list_of_parameters,
        jp.dataset_json, jp.trainer_name, jp.allowed_mirroring_axes)
    jp.engine.compute_dtype = jnp.float32
    return jp


def only_libzstd(monkeypatch):
    """The port's zstd codec as on a host without the zstandard package
    (the card's machine): the system libzstd through ctypes."""
    from fast_nnunet_tpu_torch.utils import zstd
    real = zstd._load
    monkeypatch.setattr(zstd, "_load", lambda name: None
                        if name == "zstandard" else real(name))
    assert zstd.backend() == "libzstd"
