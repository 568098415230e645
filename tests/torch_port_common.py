"""Shared pieces of the PyTorch-port tests (tests/test_torch_*.py): the small
architecture, seeded weights in the JAX tree layout, and the fixture that
skips card-only tests on a host without CUDA.

Inputs and weights are made with numpy from a seed and handed to both the
JAX package (the reference) and the port."""
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
