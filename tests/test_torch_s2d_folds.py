"""Fold ensembles on the port's s2d sweep (CPU, fp32): the fold-averaged
f32 s2d logits accumulated with torch ops, kernel B finalizing, against the
JAX package's two-fold s2d sweep and two-fold TurboPipeline (mask agreement
>= 0.999), and an ensemble of one tree twice against the tree alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_nnunet_tpu.inference.turbo import TurboConfig as JaxConfig
from fast_nnunet_tpu.inference.turbo import TurboPipeline as JaxPipeline
from fast_nnunet_tpu_torch.inference.turbo import TurboConfig, TurboPipeline

from .test_torch_turbo import CFG, _ct, pair  # noqa: F401  (fixture)
from .torch_port_common import no_persistent_compile_cache  # noqa: F401
from .torch_port_common import s2d_pair


@pytest.fixture(scope="module")
def second_tree():
    return s2d_pair(seed=3)[2]


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_two_fold_sweep_matches_jax(pair, second_tree):
    jeng, teng, _, tree = pair
    trees = [tree, second_tree]
    v = np.random.RandomState(2).randn(1, 20, 18, 24).astype(np.float32)
    ref = jeng.predict_segmentation_sweep_s2d([_j(t) for t in trees], v)
    got = teng.predict_segmentation_sweep_s2d(trees, v)
    assert got.shape == ref.shape and (got == ref).mean() >= 0.999
    assert len(teng.load_params(trees)) == 2


def test_two_fold_turbo_matches_jax(pair, second_tree):
    jeng, teng, _, tree = pair
    trees = [tree, second_tree]
    vol = _ct((30, 26, 22), [(6, 24), (5, 21), (4, 18)], seed=5)
    spacing = (1.0, 1.0, 1.5)
    ref = JaxPipeline(jeng, JaxConfig(**CFG), host_preprocess=False
                      ).predict_volume([_j(t) for t in trees], vol, spacing)
    got = TurboPipeline(teng, TurboConfig(**CFG)).predict_volume(
        trees, vol, spacing)
    assert got.shape == vol.shape and (got == ref).mean() >= 0.999


def test_same_tree_twice_matches_the_tree(pair):
    _, teng, _, tree = pair
    vol = _ct((30, 26, 22), [(6, 24), (5, 21), (4, 18)], seed=6)
    spacing = (1.0, 1.0, 1.5)
    pipe = TurboPipeline(teng, TurboConfig(**CFG))
    two = pipe.predict_volume([tree, tree], vol, spacing)
    one = pipe.predict_volume(tree, vol, spacing)
    assert (two == one).mean() >= 0.999


def test_fold_accumulate_follows_the_cyclic_row_origin(pair, second_tree):
    """Two folds with air skipping over several chunks: the torch
    accumulate maps virtual rows through the row origin that kernel B
    advances, as the single-fold kernel C path does."""
    _, teng, _, tree = pair
    vol = np.full((48, 40, 36), -1000.0, np.float32)
    vol[2:30, 2:14, 2:14] = 300.0 + np.random.RandomState(7).rand(
        28, 12, 12) * 100
    spacing = (1.0, 1.0, 1.0)
    trees = [tree, second_tree]
    skip = TurboPipeline(teng, TurboConfig(**CFG), air_skip=True
                         ).predict_volume(trees, vol, spacing)
    base = TurboPipeline(teng, TurboConfig(**CFG)).predict_volume(
        trees, vol, spacing)
    diff = skip != base
    assert (vol[diff] == -1000.0).all()
    body = vol > -1000.0
    assert (skip[body] == base[body]).all()
