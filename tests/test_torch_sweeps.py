"""The port's streamed and coset sweeps of the plain engine against the JAX
package's (CPU, fp32, same seeded weights; mask agreement >= 0.999, the
plain-engine tests' tolerance) and against the port's own routes: the
streamed sweep equals the reference-grid sweep, the coset sweep the plain
sweep where the grids coincide, and a naive accumulation on the uniform
grid at odd extents; fold ensembles; and which sweep ``predict_segmentation``
takes for each option."""
import numpy as np
import pytest

from fast_nnunet_tpu.ops.sliding_window import compute_gaussian
from fast_nnunet_tpu_torch.inference import engine as engine_module

from .test_torch_plain_engine import _engines, _jtree, _vol
from .torch_port_common import (K, PATCH,  # noqa: F401  (fixture)
                                no_persistent_compile_cache, plain_params)


@pytest.mark.parametrize("shape", [(26, 13, 18), (21, 18, 35)])
def test_streamed_sweep_matches_jax(shape):
    jeng, teng = _engines()
    tree = plain_params(0)
    v = _vol(shape, 21)
    ref = jeng.predict_segmentation_sweep_streamed(_jtree(tree), v)
    got = teng.predict_segmentation_sweep_streamed(tree, v)
    assert got.shape == ref.shape == v.shape[1:] and got.dtype == np.uint8
    assert (got == ref).mean() >= 0.999


@pytest.mark.parametrize("shape", [(16, 16, 32), (21, 13, 18)])
def test_coset_sweep_matches_jax(shape):
    jeng, teng = _engines()
    tree = plain_params(1)
    v = _vol(shape, 11)
    ref = jeng.predict_segmentation_coset(_jtree(tree), v)
    got = teng.predict_segmentation_coset(tree, v)
    assert got.shape == ref.shape == v.shape[1:]
    assert (got == ref).mean() >= 0.999


@pytest.mark.parametrize("shape", [(26, 13, 18), (7, 13, 18), (21, 18, 35)])
def test_streamed_sweep_equals_reference_grid_sweep(shape):
    """Same reference grid, same batches: bit-equal to the rolling sweep
    (and so grid-exact); one x start falls back to it."""
    _, teng = _engines()
    tree = plain_params(2)
    v = _vol(shape, 24)
    np.testing.assert_array_equal(
        teng.predict_segmentation_sweep_streamed(tree, v),
        teng.predict_segmentation_sweep(tree, v))


def test_coset_sweep_equals_plain_sweep_where_grids_coincide():
    """Extents p + k * p / 2 on every axis: the reference grid is the
    uniform one, and the coset sweep reproduces the sweep (f32)."""
    _, teng = _engines()
    tree = plain_params(3)
    v = _vol((16, 16, 32), 12)
    np.testing.assert_array_equal(teng.predict_segmentation_coset(tree, v),
                                  teng.predict_segmentation_sweep(tree, v))


def test_coset_sweep_odd_extents_match_uniform_grid_accumulation():
    """Odd extents exercise the padding and cropping: against a plain
    python accumulation on the same uniform half-patch grid."""
    import torch
    _, teng = _engines()
    tree = plain_params(4)
    v = _vol((21, 13, 18), 13)
    seg = teng.predict_segmentation_coset(tree, v)
    assert seg.shape == (21, 13, 18)

    p = np.asarray(PATCH)
    s = p // 2

    def grid(extent, p_, s_):
        n = int(np.ceil((max(extent, p_) - p_) / s_)) + 1
        return [k * s_ for k in range(n)]

    starts = [grid(e, p_, s_) for e, p_, s_ in zip(v.shape[1:], p, s)]
    padded = [st[-1] + p_ for st, p_ in zip(starts, p)]
    volp = np.zeros((1, *padded), np.float32)
    volp[:, :21, :13, :18] = v
    g = compute_gaussian(tuple(PATCH)).astype(np.float32)
    acc = np.zeros((K, *padded), np.float32)
    w = np.zeros(padded, np.float32)
    net = teng.load_params(tree)[0]
    with torch.no_grad():
        for x0 in starts[0]:
            for y0 in starts[1]:
                for z0 in starts[2]:
                    sl = (slice(x0, x0 + p[0]), slice(y0, y0 + p[1]),
                          slice(z0, z0 + p[2]))
                    tile = torch.from_numpy(volp[(slice(None),) + sl][None])
                    out = net(tile).float().numpy()[0]
                    acc[(slice(None),) + sl] += out * g
                    w[sl] += g
    ref = (acc / np.maximum(w, 1e-30)).argmax(0)[:21, :13, :18]
    assert (seg == ref).mean() >= 0.999


@pytest.mark.parametrize("route", ["streamed", "coset"])
def test_sweeps_fold_ensembles(route):
    jeng, teng = _engines()
    trees = [plain_params(5), plain_params(6)]
    v = _vol((16, 16, 32) if route == "coset" else (26, 13, 18), 15)
    name = ("predict_segmentation_sweep_streamed" if route == "streamed"
            else "predict_segmentation_coset")
    got = getattr(teng, name)(trees, v)
    ref = getattr(jeng, name)([_jtree(t) for t in trees], v)
    assert (got == ref).mean() >= 0.999
    np.testing.assert_array_equal(got,
                                  teng.predict_segmentation_sweep(trees, v))


def test_coset_sweep_refuses_what_it_cannot_take():
    _, teng = _engines()
    teng.tile_step_size = 0.25
    with pytest.raises(ValueError):
        teng.predict_segmentation_coset(plain_params(0), _vol((16, 16, 32), 0))


@pytest.mark.parametrize("kw,expected", [
    ({}, "predict_segmentation_sweep"),
    ({"use_streamed_sweep": True}, "predict_segmentation_sweep_streamed"),
    ({"use_coset_sweep": True}, "predict_segmentation_coset"),
    ({"use_coset_sweep": True, "use_streamed_sweep": True},
     "predict_segmentation_coset"),
    ({"use_streamed_sweep": True, "use_fused_accumulate": True},
     "predict_segmentation_sweep"),
])
def test_predict_segmentation_dispatch(monkeypatch, kw, expected):
    """Above the accumulator budget: coset where its option and the grid
    allow, else streamed unless the fused accumulate is on, else the
    rolling sweep (the JAX engine's order)."""
    _, teng = _engines(**kw)
    teng.max_accumulator_bytes = 1
    taken = []
    for name in ("predict_segmentation_sweep",
                 "predict_segmentation_sweep_streamed",
                 "predict_segmentation_coset"):
        monkeypatch.setattr(
            engine_module.SlidingWindowEngine, name,
            lambda self, params, volume, name=name: taken.append(name))
    teng.predict_segmentation(plain_params(0), _vol((16, 16, 32), 0))
    assert taken == [expected]
