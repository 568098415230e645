"""The port's host library (csrc/host_ops.cpp, built here with the host C++
compiler by ops/_build.py ``host_library``) through utils/hostops.py: the
CT preprocess against the JAX chain (clip -> z-score -> jax.image.resize
trilinear -> bf16) to one bf16 ulp, its box form bit-equal to the whole
grid's region, the non-air bounding box and the nearest revert against
numpy and jax.image.resize, rejected boxes, a failed build's error, and
the turbo helpers the host route crops with."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from fast_nnunet_tpu_torch.inference.turbo import (_bucket_extent,
                                                   _crop_to_fill_bbox,
                                                   _source_range_to_target)
from fast_nnunet_tpu_torch.ops import _build
from fast_nnunet_tpu_torch.utils import hostops

from .torch_port_common import no_persistent_compile_cache  # noqa: F401

LB, UB = [-60.0, -200.0], [2500.0, 3000.0]
MEAN, STD = [400.0, 10.0], [500.0, 250.0]


def _bf16(bits: np.ndarray) -> np.ndarray:
    return bits.view(ml_dtypes.bfloat16).astype(np.float32)


def _volume(seed=0, shape=(2, 24, 31, 27)):
    rng = np.random.RandomState(seed)
    return rng.randint(-1024, 3000, size=shape).astype(np.int16)


def test_preprocess_matches_jax_chain():
    vol = _volume()
    out_shape = (19, 37, 27)  # down, up and identity axes in one case
    got = hostops.preprocess_ct_i16(vol, out_shape, LB, UB, MEAN, STD)
    assert got.dtype == np.uint16 and got.shape == (2, *out_shape)
    for c in range(2):
        x = jnp.clip(vol[c].astype(jnp.float32), LB[c], UB[c])
        x = (x - MEAN[c]) / STD[c]
        ref = np.asarray(jax.image.resize(
            x[None], (1, *out_shape), method="trilinear",
            antialias=False).astype(jnp.bfloat16))[0].astype(np.float32)
        g = _bf16(got[c])
        assert (g == ref).mean() > 0.999, f"channel {c}: {(g == ref).mean()}"
        assert np.abs(g - ref).max() <= 2 ** -7 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("box", [(0, 19, 0, 37, 0, 27), (3, 11, 5, 30, 7, 20),
                                 (18, 19, 36, 37, 26, 27),
                                 (0, 1, 0, 37, 1, 27), (5, 19, 0, 2, 13, 14)])
def test_box_bit_equals_whole_grid_region(box):
    """A box of the grid, i0 > 0 included (the row pointer stays inside the
    output), is the same region of the whole grid bit for bit; ``out``
    takes a caller's buffer."""
    vol = _volume(1)
    out_shape = (19, 37, 27)
    whole = hostops.preprocess_ct_i16(vol, out_shape, LB, UB, MEAN, STD)
    k0, k1, j0, j1, i0, i1 = box
    buf = np.full((2, k1 - k0, j1 - j0, i1 - i0), 0xABCD, np.uint16)
    got = hostops.preprocess_ct_i16_box(vol, out_shape, box, LB, UB, MEAN,
                                        STD, out=buf)
    assert got is buf
    np.testing.assert_array_equal(got, whole[:, k0:k1, j0:j1, i0:i1])


def test_row_pointer_stays_inside_the_output():
    """The port's copy indexes each output row from its first voxel
    (orow[i - i0]); it never forms the pointer out - i0."""
    with open(_build.HOST_SOURCE) as f:
        src = f.read()
    assert "orow[i - i0] = f32_to_bf16" in src
    assert "* BW - i0" not in src


@pytest.mark.parametrize("box", [(0, 0, 0, 37, 0, 27), (5, 3, 0, 37, 0, 27),
                                 (0, 19, 0, 38, 0, 27), (-1, 19, 0, 37, 0, 27),
                                 (0, 19, 0, 37, 27, 27), (0, 19, 0, 37, 0)])
def test_rejected_box_returns_none_before_allocating(box, monkeypatch):
    vol = _volume(2)

    def no_alloc(*a, **k):
        raise AssertionError("allocated for a rejected box")
    monkeypatch.setattr(hostops, "_out_array", no_alloc)
    monkeypatch.setattr(hostops, "library", no_alloc)
    assert hostops.preprocess_ct_i16_box(vol, (19, 37, 27), box, LB, UB,
                                         MEAN, STD) is None


@pytest.mark.parametrize("case", ["body", "corner", "air", "one_channel"])
def test_nonair_bbox_matches_numpy(case):
    vol = np.full((2, 20, 17, 23), -1024, np.int16)
    lb = [-1000.0, -60.5]
    if case == "body":
        vol[0, 4:9, 2:15, 7:8] = -999
        vol[1, 11:14, 5:6, 3:20] = -60
    elif case == "corner":
        vol[1, 19, 16, 22] = 100
    elif case == "one_channel":
        vol[0, 2:5, 3:4, 9:11] = 500
    lo, hi = hostops.nonair_bbox_i16(vol, lb)
    body = np.zeros(vol.shape[1:], bool)
    for c in range(2):
        body |= vol[c] > lb[c]
    if not body.any():
        assert (lo, hi) == ([0] * 3, [0] * 3)
        return
    for ax in range(3):
        nz = np.flatnonzero(body.any(axis=tuple(a for a in range(3)
                                                if a != ax)))
        assert (lo[ax], hi[ax]) == (nz[0], nz[-1] + 1)


def test_nearest_revert_matches_jax():
    seg = np.random.RandomState(1).randint(0, 61, (13, 19, 17)).astype(
        np.uint8)
    for out_shape in [(20, 31, 17), (13, 19, 17), (9, 40, 23)]:
        got = hostops.nearest_revert_u8(seg, out_shape)
        ref = np.asarray(jax.image.resize(jnp.asarray(seg), out_shape,
                                          method="nearest"))
        np.testing.assert_array_equal(got, ref)


def test_inputs_are_checked():
    with pytest.raises(ValueError):
        hostops.preprocess_ct_i16(np.zeros((1, 4, 4, 4), np.float32),
                                  (4, 4, 4), -1, 1, 0, 1)
    with pytest.raises(ValueError):
        hostops.nearest_revert_u8(np.zeros((4, 4), np.uint8), (4, 4))
    with pytest.raises(ValueError):
        hostops.nearest_revert_u8(np.zeros((4, 4, 4), np.uint8), (8, 8, 8),
                                  out=np.zeros((8, 8, 7), np.uint8))


def test_failed_build_raises_with_compiler_stderr(tmp_path, monkeypatch):
    bad = tmp_path / "host_ops.cpp"
    bad.write_text("int fnn_nearest_revert_u8( { this is not C++\n")
    monkeypatch.setattr(_build, "HOST_SOURCE", str(bad))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError) as err:
        _build.host_library.__wrapped__()
    assert "host_ops.cpp" in str(err.value) and "error" in str(err.value)
    assert not any(n.startswith("host-")
                   for n in os.listdir(tmp_path / "_build"))


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-fnn")
    with pytest.raises(RuntimeError, match="no-such-compiler-fnn"):
        _build.host_library.__wrapped__()


def test_crop_to_fill_bbox_reconstructs_exactly():
    """Padding the slab with the fill at its box gives the input back bit
    for bit, for off-bucket extents (the JAX test's cases)."""
    fill = 0xC067
    rng = np.random.RandomState(5)
    cases = [((1, 70, 40, 40), (31, 63), (5, 20), (0, 40)),
             ((1, 40, 40, 40), (3, 19), (3, 19), (3, 19)),
             ((2, 33, 65, 37), (32, 33), (1, 65), (36, 37))]
    for shape, *ranges in cases:
        arr = np.full(shape, fill, np.uint16)
        sl = (slice(None),) + tuple(slice(a, b) for a, b in ranges)
        arr[sl] = rng.randint(0, 0xFFFF, arr[sl].shape).astype(np.uint16)
        box, slab = _crop_to_fill_bbox(arr, [fill] * shape[0], bucket=32)
        if box is None:
            np.testing.assert_array_equal(slab, arr)
            continue
        rec = np.full(shape, fill, np.uint16)
        rec[(slice(None),) + tuple(slice(a, b) for a, b in zip(*box))] = slab
        np.testing.assert_array_equal(rec, arr)
        assert all(b - a <= s for a, b, s in zip(*box, shape[1:]))


@pytest.mark.parametrize("n_in,n_out", [(40, 17), (17, 40), (33, 33),
                                        (512, 419)])
def test_source_range_to_target_is_conservative(n_in, n_out):
    """Every target voxel outside the mapped range interpolates two
    clip-floor samples only."""
    rng = np.random.RandomState(n_in)
    for _ in range(20):
        slo = int(rng.randint(0, n_in))
        shi = int(rng.randint(slo + 1, n_in + 1))
        lo, hi = _source_range_to_target(n_in, n_out, slo, shi)
        x = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * \
            (np.float32(n_in) / np.float32(n_out)) - np.float32(0.5)
        a = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
        b = np.clip(np.floor(x).astype(np.int64) + 1, 0, n_in - 1)
        touches = (b >= slo) & (a <= shi - 1)
        outside = np.ones(n_out, bool)
        outside[lo:hi] = False
        assert not (touches & outside).any()


def test_bucket_extent_covers():
    for l, h, s in [(3, 19, 40), (31, 63, 70), (0, 1, 5), (36, 37, 37)]:
        a, b = _bucket_extent(l, h, s, 32)
        assert a <= l and b >= h and b <= s and a % 32 == 0
