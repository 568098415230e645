"""The port's package cache (fast_nnunet_tpu_torch/inference/aot.py) on the
CPU: the key ignores comments and names but not weights or shapes, the
cache directory is private, ``cache_dir=None`` is eager, a second process
or engine loads without compiling, a corrupt package recompiles with a
warning, a failed compile raises, and the s2d sweep through a package gives
the eager sweep's mask and agrees >= 0.999 with the JAX package's sweep on
the same weights, kernel A's op called from inside the package.

One AOTInductor compile for the whole file (the module-scoped ``compiled``
fixture); the other cases reuse its package."""
import logging
import os
import shutil
import stat
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.inference.engine import SlidingWindowEngine as JaxEngine
from fast_nnunet_tpu_torch.inference import aot
from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
from fast_nnunet_tpu_torch.models import s2d as s2d_model

from .torch_port_common import (K, PATCH, REPO,  # noqa: F401  (fixture)
                                no_persistent_compile_cache,
                                persistent_compile_cache_off, s2d_pair)

VOL = np.random.RandomState(2).randn(1, 20, 18, 24).astype(np.float32)


class FeaturesA(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.network = net

    def forward(self, x):
        return self.network(x, return_features=True)


class RenamedWithComments(torch.nn.Module):
    """Same computation as FeaturesA, another class, another method body
    layout."""

    def __init__(self, net):
        super().__init__()
        self.network = net  # the same attribute name: the same node names

    def forward(self, tiles):
        # a comment the key must not see
        features = self.network(tiles, return_features=True)
        return features


def _net(seed=0):
    _, tnet, tree = s2d_pair(seed=seed)
    tnet.set_stats_min_voxels(0)  # every norm through kernel A's op
    return tnet.eval(), tree


def _engine(net, cache):
    return SlidingWindowEngine(net, PATCH, K, shape_bucket=4,
                               compute_dtype=torch.float32,
                               sweep_acc_dtype=torch.float32, tile_batch=2,
                               device="cpu", aot_cache=cache)


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """The s2d sweep of VOL with a fresh package cache (one compile), the
    eager sweep, the JAX sweep, and the op calls made by the package."""
    cache = str(tmp_path_factory.mktemp("aot") / "cache")
    net, tree = _net()
    eager = _engine(net, None).predict_segmentation_sweep_s2d(tree, VOL)
    calls = []
    real = s2d_model.spatial_sum_sumsq
    s2d_model.spatial_sum_sumsq = lambda x: calls.append(tuple(x.shape)) \
        or real(x)
    try:
        eng = _engine(net, cache)
        got = eng.predict_segmentation_sweep_s2d(tree, VOL)
    finally:
        s2d_model.spatial_sum_sumsq = real
    jnet, _, jtree = s2d_pair(seed=0)
    jeng = JaxEngine(jnet, PATCH, K, tile_step_size=0.5, shape_bucket=4,
                     compute_dtype=jnp.float32, sweep_acc_dtype=jnp.float32,
                     tile_batch=2, use_s2d_sweep=True)
    with persistent_compile_cache_off():
        ref = np.asarray(jeng.predict_segmentation_sweep_s2d(
            jax.tree_util.tree_map(jnp.asarray, jtree), VOL))
    (package,) = [f for f in os.listdir(cache) if f.endswith(".pt2")]
    return {"cache": cache, "package": os.path.join(cache, package),
            "aot": got, "eager": eager, "jax": ref, "calls": calls,
            "net": net, "tree": tree, "engine": eng}


def test_aot_sweep_equals_eager_and_agrees_with_jax(compiled):
    got, eager, ref = compiled["aot"], compiled["eager"], compiled["jax"]
    assert got.shape == eager.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, eager)
    assert (got == ref).mean() >= 0.999
    # kernel A ran inside the package, in the norm op the package calls
    # back through the dispatcher: every norm of every forward (10 a forward)
    assert compiled["calls"] and len(compiled["calls"]) % 10 == 0
    assert os.path.basename(compiled["package"]).startswith(
        "s2d_return_features-")


def test_cache_dir_is_private(compiled):
    mode = stat.S_IMODE(os.stat(compiled["cache"]).st_mode)
    assert mode == 0o700, oct(mode)


def test_cache_dir_none_is_eager():
    net, _ = _net()
    mod = FeaturesA(net)
    assert aot.aot_compile(mod, (torch.zeros(2, 1, *PATCH),), None) is mod
    assert aot.aot_compile(mod, (torch.zeros(2, 1, *PATCH),), "") is mod
    eng = _engine(net, None)
    x = torch.randn(2, 1, *PATCH)
    with torch.no_grad():
        torch.testing.assert_close(eng.fold_forward(0, x, return_features=True),
                                   net(x, return_features=True), rtol=0,
                                   atol=0)
    assert eng._aot_modules == {}


def test_program_key_ignores_comments_and_names_not_weights_or_shapes():
    net, _ = _net(seed=0)
    x = torch.zeros(2, 1, *PATCH)
    key = aot.program_key(aot.export_program(FeaturesA(net), (x,)))
    assert aot.program_key(aot.export_program(RenamedWithComments(net),
                                              (x,))) == key
    assert aot.program_key(aot.export_program(FeaturesA(net), (x,)),
                           extra="other") != key
    other, _ = _net(seed=1)
    assert aot.program_key(aot.export_program(FeaturesA(other), (x,))) != key
    x4 = torch.zeros(4, 1, *PATCH)
    assert aot.program_key(aot.export_program(FeaturesA(net), (x4,))) != key


def test_second_engine_loads_without_compiling(compiled, monkeypatch,
                                               caplog):
    """A new engine on the same cache loads the package: a compile that
    raises is never called, the package file is untouched."""
    def no_compile(*a, **k):
        raise AssertionError("compiled again")
    import torch._inductor
    monkeypatch.setattr(torch._inductor, "aoti_compile_and_package",
                        no_compile)
    mtime = os.stat(compiled["package"]).st_mtime_ns
    with caplog.at_level(logging.INFO, logger=aot.__name__):
        got = _engine(compiled["net"], compiled["cache"]) \
            .predict_segmentation_sweep_s2d(compiled["tree"], VOL)
    np.testing.assert_array_equal(got, compiled["aot"])
    assert any("loaded" in r.message and "no compile" in r.message
               for r in caplog.records)
    assert os.stat(compiled["package"]).st_mtime_ns == mtime


def test_short_plane_pads_to_the_package_batch(compiled, monkeypatch):
    """A volume with fewer tiles per plane than ``tile_batch`` pads its
    batches to the package's batch and loads the compiled package: one
    compile serves every volume. Its mask equals the eager sweep's."""
    def no_compile(*a, **k):
        raise AssertionError("a second package was compiled")
    import torch._inductor
    monkeypatch.setattr(torch._inductor, "aoti_compile_and_package",
                        no_compile)
    small = np.random.RandomState(5).randn(1, 20, PATCH[1], PATCH[2]) \
        .astype(np.float32)  # one tile per plane, tile_batch 2
    eng = _engine(compiled["net"], compiled["cache"])
    got = eng.predict_segmentation_sweep_s2d(compiled["tree"], small)
    want = _engine(compiled["net"], None).predict_segmentation_sweep_s2d(
        compiled["tree"], small)
    np.testing.assert_array_equal(got, want)
    assert [k[1][0] for k in eng._aot_modules] == [eng.tile_batch]
    assert os.listdir(compiled["cache"]) == [
        os.path.basename(compiled["package"])]


def test_corrupt_package_recompiles_with_warning(compiled, tmp_path,
                                                 monkeypatch, caplog):
    """A package that does not load is compiled again (here by a stand-in
    that writes the good package's bytes) with a warning."""
    cache = str(tmp_path / "cache")
    shutil.copytree(compiled["cache"], cache)
    bad = os.path.join(cache, os.path.basename(compiled["package"]))
    with open(bad, "wb") as f:
        f.write(b"not a package")
    made = []

    def stand_in(exported, package_path=None, inductor_configs=None):
        made.append(package_path)
        shutil.copyfile(compiled["package"], package_path)
        return package_path
    import torch._inductor
    monkeypatch.setattr(torch._inductor, "aoti_compile_and_package",
                        stand_in)
    x = torch.randn(2, 1, *PATCH)
    with caplog.at_level(logging.INFO, logger=aot.__name__):
        # the engine's key: FeaturesA traces the engine's graph
        fn = aot.aot_compile(FeaturesA(compiled["net"]), (x,), cache,
                             tag="s2d_return_features")
    assert len(made) == 1 and made[0].endswith(f".tmp{os.getpid()}.pt2")
    assert any(r.levelno == logging.WARNING and "recompiling" in r.message
               for r in caplog.records)
    assert not [f for f in os.listdir(cache) if ".tmp" in f]
    with torch.no_grad():
        torch.testing.assert_close(fn(x), compiled["net"](
            x, return_features=True), rtol=1e-5, atol=1e-5)


def test_failed_compile_raises(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("inductor failed")
    import torch._inductor
    monkeypatch.setattr(torch._inductor, "aoti_compile_and_package", broken)
    net, _ = _net()
    with pytest.raises(RuntimeError, match="inductor failed"):
        aot.aot_compile(FeaturesA(net), (torch.zeros(2, 1, *PATCH),),
                        str(tmp_path / "c"))
    assert os.listdir(tmp_path / "c") == []


_FRESH = r"""
import sys, numpy as np, torch
from fast_nnunet_tpu_torch.inference import aot
fn = aot.load_package(sys.argv[1])
x = torch.from_numpy(np.load(sys.argv[2]))
with torch.no_grad():
    np.save(sys.argv[3], fn(x).numpy())
"""


def test_fresh_process_runs_the_package(compiled, tmp_path):
    """A new interpreter that imports the port loads the package (the norm
    op registered by inference/aot.py's imports) and gives the eager
    features."""
    x = np.random.RandomState(3).randn(2, 1, *PATCH).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _FRESH, compiled["package"],
                          str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with torch.no_grad():
        want = compiled["net"](torch.from_numpy(x), return_features=True)
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"), want.numpy(),
                               rtol=1e-5, atol=1e-5)
